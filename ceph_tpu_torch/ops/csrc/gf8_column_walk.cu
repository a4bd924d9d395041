// GF(2^8) matrix apply for Hopper (sm_90a) as a sparse column walk:
// out[b][i] = XOR_j M[i][j] * in[b][j] over GF(2^8) (poly 0x11D), each
// input column's doubling chain run once and folded into every output row
// that column feeds.
//
// Replaces the TPU-specific MXU path of the JAX package,
// ceph_tpu/ops/xla_ops.py::apply_matrix_mxu (an XLA einsum of the (8r, 8s)
// GF(2) bitmatrix against the input's bit-planes), which
// ceph_tpu/ops/pallas_gf.py::select_matrix_engine picks for w=8 matrices
// with MXU_MATRIX_MIN (2048) nonzeros or more and no preferred XOR
// schedule: clay's composites (the k=8 m=4 d=11 encode is (256, 512) with
// 6272 nonzero coefficients, 1.8 % of its bitmatrix).  The function is
// the same; the form is not a GEMM: a dense GF(2) product multiplies every
// zero of the bitmatrix, and the tensor-core form of the encode needs
// 1.11 ms at the int8 peak, 23x this function's floor.
//
// Kernel data (built once per matrix by the wrapper, ops/torch_ops.py ::
// column_walk_data, so one build serves every matrix): the matrix in
// column-compressed form per row tile.  For each nonzero column j of a
// tile a record (j | top << 24, first entry), top the column's highest
// coefficient bit (its chain length); for each nonzero coefficient an
// entry (row in tile << 8 | coefficient).  Each tile's records end with a
// sentinel record whose first entry is the tile's end.
//
// Design:
//   - A block owns CW_WORDS consecutive 32-bit word positions of one
//     stripe (grid x; 64-bit index math) and one row tile (grid y).  Its
//     shared memory holds the accumulators of the tile's rows for those
//     words (rows x CW_WORDS x 4 bytes), zeroed at start.  Lane l of a warp
//     holds words l and l + 32 (CW_LANE_WORDS = 2): every load, every
//     shared-memory access and every store of a warp covers 128
//     consecutive bytes, free of bank conflicts.
//   - The block's CW_WARPS warps split the tile's nonzero columns
//     (interleaved).  For each column a warp loads its 64 words of chunk
//     j (the next column's words are loaded before this one is folded, so
//     the load overlaps the fold), runs the SWAR xtime chain up to the
//     column's top bit (at most 8 planes in registers), and for each entry
//     (i, c) XORs the planes selected by c's bits into acc[i] with a
//     shared-memory atomic XOR (the warps share the accumulators); the
//     selection is one LOP3 per plane, (plane & mask) ^ acc, with c's bits
//     as word masks from a 256 x 8 table in shared memory.  The entry list
//     is the same for every lane, so control flow is uniform across the
//     warp; a zero column is never read.  Each chain is run
//     once per row tile, as the floor (ops/gf_kernels.py::sm90_op_count)
//     counts it.
//   - Epilogue: the block stores its rows' words; a tail that is not a
//     whole word is stored byte by byte (loads likewise).
//   - Filling the card at small batches: when the blocks fill less than
//     one wave (CW_WAVES) of the card, the columns are split across grid z
//     (at most one split per CW_WARPS * CW_MIN_COLS_PER_WARP nonzero
//     columns); each split XORs its partial rows into the output with
//     global atomic XORs (red.global.xor), after gf8_column_walk_zero has
//     zeroed the output in the same call.  Needs word-aligned output rows;
//     otherwise the call does not split.
//   - Capacity: any r.  A row tile holds at most CW_SMEM_BUDGET / (4 *
//     CW_WORDS) rows (256: clay's encode is one tile); a further tile
//     re-walks its own columns.  The shared memory above 48 KB is
//     requested with cudaFuncSetAttribute (once per device, as the
//     occupancy behind the split is read once per device and tile
//     height), and a refused launch returns its error to the wrapper,
//     which raises.
//
// What bounds it (H100 SXM): the clay encode at (64, 512, 2048) -> (64,
// 256, 2048) moves 100.7 MB (0.030 ms at 3.35 TB/s); its least INT32 work
// is 24426 instructions per word position (sm90_op_count) x 32768 word
// positions, 0.048 ms at 16.7 Tops/s: operations bound it.  This kernel
// spends more: 5 instructions per xtime, 8 masked XORs per coefficient
// (two 16-byte table reads) instead of the floor's LOP3 folds of its set
// bits, and one shared-memory atomic per coefficient (6272 per word
// position).

#include <cstdint>
#include <cuda_runtime.h>

#include "on_device.cuh"

#define CW_WARPS 16
#define CW_THREADS (32 * CW_WARPS)
#define CW_LANE_WORDS 2
#define CW_WORDS (32 * CW_LANE_WORDS)     // word positions per block
#define CW_SMEM_BUDGET (64 * 1024)        // accumulator bytes per block
#define CW_MIN_COLS_PER_WARP 4            // least columns per warp per split
#define CW_WAVES 1                        // waves the column split fills
#define CW_MAX_SPLITS 64
#define CW_ROWS_MAX (CW_SMEM_BUDGET / (4 * CW_WORDS))   // rows of a tile

// Multiply 4 packed field bytes by x (as csrc/gf8_matrix.cu).
__device__ __forceinline__ uint32_t cw_xtime(uint32_t v) {
  const uint32_t hi = v & 0x80808080u;
  return ((v ^ hi) << 1) ^ ((hi >> 7) * 0x1du);
}

// The word at p, of which `avail` bytes lie in the row (none when avail
// <= 0; a tail is zero-padded: zero bytes map to zero bytes).
__device__ __forceinline__ uint32_t cw_load(const unsigned char* p,
                                            long long avail, bool aligned) {
  if (aligned && avail >= 4) {
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  }
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (b < avail) w |= static_cast<uint32_t>(__ldg(p + b)) << (8 * b);
  }
  return w;
}

__global__ void __launch_bounds__(CW_THREADS)
gf8_column_walk_kernel(const unsigned char* __restrict__ in,
                       unsigned char* __restrict__ out,
                       const int* __restrict__ data, long long nbytes,
                       long long in_bstride, long long in_cstride,
                       long long out_bstride, long long out_cstride, int r,
                       int rows_per_tile, int tile_base, int rec_base,
                       int ent_base, long long wtiles, int aligned_in,
                       int aligned_out) {
  extern __shared__ uint32_t acc[];   // [rows][CW_WORDS]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = static_cast<long long>(blockIdx.x) / wtiles;
  const long long w0 =
      (static_cast<long long>(blockIdx.x) - b * wtiles) * CW_WORDS;
  const int tile = blockIdx.y;
  const int row0 = tile * rows_per_tile;
  const int rows = min(rows_per_tile, r - row0);
  const int splits = gridDim.z;

  // masks[8 c + t]: all ones where bit t of coefficient c is set
  __shared__ __align__(16) uint32_t masks[256 * 8];
  for (int idx = threadIdx.x; idx < rows * CW_WORDS; idx += CW_THREADS) {
    acc[idx] = 0u;
  }
  for (int idx = threadIdx.x; idx < 256 * 8; idx += CW_THREADS) {
    masks[idx] = 0u - (((idx >> 3) >> (idx & 7)) & 1u);
  }
  __syncthreads();

  const int2* recs = reinterpret_cast<const int2*>(data + rec_base);
  const uint32_t* ents = reinterpret_cast<const uint32_t*>(data + ent_base);
  const int k_end = data[tile_base + tile + 1] - 1;   // the sentinel
  const unsigned char* src = in + b * in_bstride;
  long long off[CW_LANE_WORDS];
  long long avail[CW_LANE_WORDS];
#pragma unroll
  for (int v = 0; v < CW_LANE_WORDS; ++v) {
    off[v] = (w0 + lane + 32 * v) * 4;
    avail[v] = nbytes - off[v];
  }
  const bool al = aligned_in != 0;
  const int step = CW_WARPS * splits;
  int k = data[tile_base + tile] + blockIdx.z * CW_WARPS + warp;
  uint32_t nx[CW_LANE_WORDS];
  if (k < k_end) {
    const unsigned char* p =
        src + static_cast<long long>(recs[k].x & 0xFFFFFF) * in_cstride;
#pragma unroll
    for (int v = 0; v < CW_LANE_WORDS; ++v)
      nx[v] = cw_load(p + off[v], avail[v], al);
  }
  for (; k < k_end; k += step) {
    const int2 rec = recs[k];
    const int top = rec.x >> 24;
    const int e_end = recs[k + 1].y;
    uint32_t pl[CW_LANE_WORDS][8];
#pragma unroll
    for (int v = 0; v < CW_LANE_WORDS; ++v) pl[v][0] = nx[v];
    if (k + step < k_end) {     // the next column's words, in flight now
      const unsigned char* p =
          src +
          static_cast<long long>(recs[k + step].x & 0xFFFFFF) * in_cstride;
#pragma unroll
      for (int v = 0; v < CW_LANE_WORDS; ++v)
        nx[v] = cw_load(p + off[v], avail[v], al);
    }
#pragma unroll
    for (int t = 1; t < 8; ++t) {
      if (t < top) {
#pragma unroll
        for (int v = 0; v < CW_LANE_WORDS; ++v)
          pl[v][t] = cw_xtime(pl[v][t - 1]);
      } else {                  // no coefficient of the column reaches t
#pragma unroll
        for (int v = 0; v < CW_LANE_WORDS; ++v) pl[v][t] = 0u;
      }
    }
    for (int e = rec.y; e < e_end; ++e) {
      const uint32_t ent = __ldg(ents + e);
      const uint32_t c = ent & 0xFFu;
      // bit t of c as a word mask, from the block's table: one LOP3 per
      // plane and word, no per-bit test
      const uint4 m0 = *reinterpret_cast<const uint4*>(masks + c * 8);
      const uint4 m1 = *reinterpret_cast<const uint4*>(masks + c * 8 + 4);
      const uint32_t mk[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
      uint32_t val[CW_LANE_WORDS];
#pragma unroll
      for (int v = 0; v < CW_LANE_WORDS; ++v) val[v] = 0u;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int v = 0; v < CW_LANE_WORDS; ++v) val[v] ^= pl[v][t] & mk[t];
      }
      uint32_t* a = acc + (ent >> 8) * CW_WORDS + lane;
#pragma unroll
      for (int v = 0; v < CW_LANE_WORDS; ++v) atomicXor(a + 32 * v, val[v]);
    }
  }
  __syncthreads();

  unsigned char* dst =
      out + b * out_bstride + static_cast<long long>(row0) * out_cstride;
  for (int idx = threadIdx.x; idx < rows * CW_WORDS; idx += CW_THREADS) {
    const int i = idx / CW_WORDS;
    const long long o = (w0 + (idx - i * CW_WORDS)) * 4;
    const long long av = nbytes - o;
    if (av <= 0) continue;
    const uint32_t val = acc[idx];
    unsigned char* q = dst + i * out_cstride + o;
    if (splits > 1) {
      // word-aligned rows of whole words (the launch checked)
      atomicXor(reinterpret_cast<unsigned int*>(q), val);
    } else if (aligned_out && av >= 4) {
      *reinterpret_cast<uint32_t*>(q) = val;
    } else {
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        if (bb < av) q[bb] = static_cast<unsigned char>(val >> (8 * bb));
      }
    }
  }
}

// Zero `batch` x `r` output rows of `nwords` words (word-aligned rows):
// the column split's partials are XORed into zeros.
__global__ void __launch_bounds__(CW_THREADS)
gf8_column_walk_zero(unsigned char* __restrict__ out, long long batch,
                     int r, long long nwords, long long out_bstride,
                     long long out_cstride) {
  const long long per_stripe = static_cast<long long>(r) * nwords;
  const long long n = batch * per_stripe;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       idx < n; idx += step) {
    const long long bb = idx / per_stripe;
    const long long rest = idx - bb * per_stripe;
    const long long i = rest / nwords;
    const long long w = rest - i * nwords;
    *reinterpret_cast<uint32_t*>(out + bb * out_bstride + i * out_cstride +
                                 w * 4) = 0u;
  }
}

// The column splits a launch takes, into *splits: one unless the blocks
// of `batch` stripes of `nbytes` bytes in `tiles` row tiles fill less than
// CW_WAVES waves of the card, and never more than the sparsest tile's
// `min_cols` nonzero columns give each warp CW_MIN_COLS_PER_WARP of; none
// unless `can_split` (word-aligned output rows of whole words).  Raises
// the kernel's dynamic shared memory to the budget first (once per
// device), since the wave is read at that size.  Runs with `device`
// current.
static cudaError_t cw_plan(long long batch, long long nbytes,
                           int rows_per_tile, int tiles, int min_cols,
                           bool can_split, int device, int* splits) {
  static std::atomic<bool> raised[ON_DEVICE_MAX];
  const bool cached = device >= 0 && device < ON_DEVICE_MAX;
  if (!cached || !raised[device].load(std::memory_order_relaxed)) {
    const cudaError_t err = cudaFuncSetAttribute(
        gf8_column_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        CW_SMEM_BUDGET);
    if (err != cudaSuccess) return err;
    if (cached) raised[device].store(true, std::memory_order_relaxed);
  }
  int cap = min_cols / (CW_WARPS * CW_MIN_COLS_PER_WARP);
  cap = cap < 1 ? 1 : (cap > CW_MAX_SPLITS ? CW_MAX_SPLITS : cap);
  if (!can_split || cap == 1) {
    *splits = 1;
    return cudaSuccess;
  }
  // one wave per row count a tile can hold, per device
  static std::atomic<int> waves[CW_ROWS_MAX + 1][ON_DEVICE_MAX];
  long long wave = 0;
  const size_t smem =
      static_cast<size_t>(rows_per_tile) * CW_WORDS * sizeof(uint32_t);
  const cudaError_t err = wave_of(gf8_column_walk_kernel, CW_THREADS, smem,
                                  device, waves[rows_per_tile], &wave);
  if (err != cudaSuccess) return err;
  const long long wtiles = ((nbytes + 3) / 4 + CW_WORDS - 1) / CW_WORDS;
  const long long blocks = batch * wtiles * tiles;
  const long long slots = wave * CW_WAVES;
  const long long z = blocks >= slots ? 1 : (slots + blocks - 1) / blocks;
  *splits = static_cast<int>(z > cap ? cap : z);
  return cudaSuccess;
}

static bool cw_args_ok(long long batch, long long nbytes, int r,
                       int rows_per_tile, int tiles) {
  const long long wtiles = ((nbytes + 3) / 4 + CW_WORDS - 1) / CW_WORDS;
  return r >= 1 && batch >= 1 && nbytes >= 1 && rows_per_tile >= 1 &&
         rows_per_tile <= CW_ROWS_MAX && tiles >= 1 && tiles <= 65535 &&
         static_cast<long long>(tiles) * rows_per_tile >= r &&
         batch * wtiles <= 0x7FFFFFFFLL;
}

extern "C" {

int gf8cw_words(void) { return CW_WORDS; }

int gf8cw_warps(void) { return CW_WARPS; }

int gf8cw_smem_budget(void) { return CW_SMEM_BUDGET; }

const char* gf8cw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The column splits gf8cw_apply takes for these arguments and a
// word-aligned output of (batch, r, nbytes) rows (cw_plan), into *splits.
// Returns the first CUDA error.
int gf8cw_splits(long long batch, long long nbytes, int r, int rows_per_tile,
                 int tiles, int min_cols, int device, int* splits) {
  if (!cw_args_ok(batch, nbytes, r, rows_per_tile, tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return on_device(device, [&]() -> cudaError_t {
    return cw_plan(batch, nbytes, rows_per_tile, tiles, min_cols,
                   nbytes % 4 == 0, device, splits);
  });
}

// Apply the GF(2^8) matrix whose column-walk data `data` (device memory,
// int32: the tile pointers at tile_base, the records at rec_base, the
// entries at ent_base; `tiles` row tiles of `rows_per_tile` rows of an r-row
// matrix, `min_cols` nonzero columns in the sparsest tile) describes to
// `batch` stripes of input chunks of `nbytes` bytes; strides in bytes.
// Output row i of stripe b lands at out + b * out_bstride + i *
// out_cstride.  Launches on `stream`, which belongs to `device`: the
// zeroing kernel when cw_plan splits the columns, then the walk.  Returns
// the first CUDA error (0 when every launch was accepted).
int gf8cw_apply(const void* in, void* out, const void* data,
                long long batch, long long nbytes, long long in_bstride,
                long long in_cstride, long long out_bstride,
                long long out_cstride, int r, int rows_per_tile, int tiles,
                int tile_base, int rec_base, int ent_base, int min_cols,
                int device, void* stream) {
  if (!cw_args_ok(batch, nbytes, r, rows_per_tile, tiles) ||
      (reinterpret_cast<uintptr_t>(data) % 8) != 0 || rec_base % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nwords = (nbytes + 3) / 4;
  const long long wtiles = (nwords + CW_WORDS - 1) / CW_WORDS;
  const int aligned_in = (reinterpret_cast<uintptr_t>(in) % 4 == 0) &&
                         in_bstride % 4 == 0 && in_cstride % 4 == 0;
  const int aligned_out = (reinterpret_cast<uintptr_t>(out) % 4 == 0) &&
                          out_bstride % 4 == 0 && out_cstride % 4 == 0;
  const size_t smem =
      static_cast<size_t>(rows_per_tile) * CW_WORDS * sizeof(uint32_t);
  return on_device(device, [&]() -> cudaError_t {
    int z = 1;
    cudaError_t err =
        cw_plan(batch, nbytes, rows_per_tile, tiles, min_cols,
                aligned_out && nbytes % 4 == 0, device, &z);
    if (err != cudaSuccess) return err;
    auto st = static_cast<cudaStream_t>(stream);
    auto* dst = static_cast<unsigned char*>(out);
    if (z > 1) {
      const long long n = batch * r * nwords;
      long long zb = (n + CW_THREADS - 1) / CW_THREADS;
      zb = zb < 4096 ? zb : 4096;
      gf8_column_walk_zero<<<static_cast<unsigned>(zb), CW_THREADS, 0, st>>>(
          dst, batch, r, nwords, out_bstride, out_cstride);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    dim3 grid(static_cast<unsigned>(batch * wtiles),
              static_cast<unsigned>(tiles), static_cast<unsigned>(z));
    gf8_column_walk_kernel<<<grid, CW_THREADS, smem, st>>>(
        static_cast<const unsigned char*>(in), dst,
        static_cast<const int*>(data), nbytes, in_bstride, in_cstride,
        out_bstride, out_cstride, r, rows_per_tile, tile_base, rec_base,
        ent_base, wtiles, aligned_in, aligned_out);
    return cudaGetLastError();
  });
}

}  // extern "C"
