// GF(2^w) matrix apply for Hopper (sm_90a): out[i] = XOR_j M[i][j] * in[j]
// over regions of w-bit field elements, w in {8, 16, 32} (polys 0x11D,
// 0x1100B, 0x100400007, as jerasure / gf-complete).
//
// Replaces five TPU kernels of the JAX package (ceph_tpu/ops/pallas_gf.py):
//   - apply_matrix_pallas         (w=8, bytes layout, (..., s, C) uint8)
//   - apply_matrix_pallas_packed  (w=8, packed layout, (..., s, R, 128) u32)
//     (both share the body _matrix_kernel)
//   - apply_matrix_pallas_words   (w=16/32, (..., s, Ce) uint16/uint32 word
//     views; body _gfw_matrix_kernel)
//   - apply_matrix_pallas_ragged and apply_matrix_pallas_packed_ragged (w=8
//     over a page pool (P, s, page) under a (P,) activity mask; body
//     _gf8_ragged_kernel, the dense body under a pl.when on the page's mask
//     word)
// A uint8 buffer read as little-endian uint32 already IS the packed layout,
// and GF(2^w) region math is local to each w-bit element, so one kernel
// over 32-bit SWAR words (4 field bytes, 2 halfwords or 1 word per u32)
// computes all of them; the field width is a template parameter, and the
// Python wrappers in ops/gf_kernels.py only describe the buffers.
//
// Design: the doubling chain per output row (Horner), not per input column:
//   out_i = (...(y_i,T * x ^ y_i,T-1) * x ...) ^ y_i,0, y_i,t the XOR of the
//   inputs j whose coefficient c_ij has bit t set, T + 1 the row's highest
//   bit.  A row costs T xtimes and one XOR per set coefficient bit (two per
//   LOP3); the RS k=8 m=3 encode needs 14 xtimes where the chain per input
//   column needs 48.
//   - Kernel data, not code: each matrix's row program (ops/gf_kernels.py
//     ::dense_program, built once per matrix, cached per device) is data,
//     so one build serves every matrix.  Up to GF_PROG_MAX int32 words it
//     is a by-value __grid_constant__ argument (gf_matrix_kernel), else a
//     device buffer (gf_matrix_table_kernel: clay's (64, 704) repairs); the
//     body is the same.  Layout, all int32:
//       [0] length, [1] row blocks NRB, [2] rows per block RR,
//       [3 .. 3+NRB)       each row block's tile stream offset,
//       [3+NRB .. 3+NRB+r) each row's program stream offset;
//       tile stream of a row block: ntiles, then per tile ncols and its
//         input columns (the block's nonzero columns, at most GF_TILE_COLS
//         a tile, in order);
//       program stream of a row: per tile of its block, top (0: no
//         coefficient of the row in the tile), then for t = top-1 down to
//         0 the count of pairs and the pairs, two words each: the byte
//         offsets of two set bits' slots in the staged tile, an odd one
//         paired with a zero slot.
//   - A block is GF_UNITS threads, each thread one 16-byte unit of the
//     chunks (grid x), and takes the rows of one row block (grid z: every
//     row of the matrix in ONE launch).  It walks the stripes blockIdx.y,
//     + gridDim.y, ...: for each (stripe, tile) step a thread stages its
//     unit of the tile's input columns into shared memory with cp.async,
//     every load of the step in flight at once and a zero column never
//     read, while it folds the step before (two buffers); then runs each of
//     its rows' programs over its unit: the tile's partial Horner, XORed
//     into the row's accumulator (a row whose columns fill one tile, as
//     every RS shape, runs exactly the row form above).  A thread reads
//     only what it staged, so no barrier is needed, and the program is
//     read at offsets the same for the whole block: a by-value program
//     comes from the constant bank through uniform registers.  Output
//     units are stored with streaming stores.
//   - Geometry, a pure function of the shape (mirrored by gf_kernels
//     .dense_geometry and checked when the library loads): rows in
//     balanced blocks of at most GF_ROWS_MAX when the s columns fit one
//     tile (a block stages its inputs once for all its rows), one row per
//     block when they do not (a block stages only its row's nonzero
//     columns: clay's repair reads 24 of 704).
//   - Filling the card (the one-launch rule): the stripes spread evenly
//     over as many blocks as one wave of the card holds beside the grid's
//     unit tiles and row blocks (on_device.cuh::wave_of, read once per
//     device and tile width), so a block pipelines several stripes where
//     the batch allows.  At small batches the blocks are what the stripes
//     give: narrower units (4 bytes) and a row per block were measured
//     slower at the 4-stripe RS decode (PERF.md).
//   - Any C: a unit that is not whole, or a buffer or stride off 16 bytes,
//     is staged and stored byte by byte (masked); a w-bit element never
//     straddles a unit, so a zero-padded tail element maps to zero and is
//     never stored.  Batch and chunk strides are arguments, so the decode's
//     survivor slice chunks[..., :ns, :] needs no copy.
//   - Ragged: a device pointer to a (batch,) uint8 page mask (null on the
//     dense path).  A page whose mask byte is 0 reads no input and stores
//     zeros (its fold runs on stale shared memory and is dropped).
//
// What bounds it (H100 SXM, RS k=8 m=3 encode, 64 stripes x (8 in + 3 out)
// x 128 KiB): 92.3 MB moved is 0.0276 ms at 3.35 TB/s.  The least integer
// work is 89 instructions per word position (gf_kernels.sm90_op_floor, the
// row form: 4 per xtime, two set bits per LOP3) x 2.1e6 word positions,
// 0.011 ms at 16.7 Tops/s: the bytes bound it.  This kernel's program
// spends 93 (gf_kernels.program_op_count: an odd set bit pairs with zero,
// and a tile's partial row is one more XOR).  The compiled w=8 by-value
// kernel (cuobjdump -sass) spends 11 issue slots per pair of set bits per
// 16-byte unit (two ULDC, two LDS.128 [R+UR], UISETP, PLOP3, four LOP3,
// BRA) and about 24 per level (the xtime's IMAD, PRMT and two LOP3 per
// word, loop control): about 196 issue slots per word position on the RS
// encode, 90 of them on the integer pipes.  57 registers and 36 KB of
// staging let 6 blocks of 128 threads share an SM; the encode's grid is
// one wave, each block walking 5-6 stripes.

#include <cstdint>
#include <cuda_runtime.h>

#include "on_device.cuh"

// int32 program words taken by value (under 4 KB of kernel parameters)
#define GF_PROG_MAX 960
#define GF_ROWS_MAX 8          // output rows of a row block (a thread's rows)
#define GF_UNITS 128           // threads of a block, one 16-byte unit each
#define GF_TILE_COLS 11        // input columns of a staged tile
#define GF_STAGES 2            // steps in flight per thread (cp.async)

struct GfProgram {
  int prog[GF_PROG_MAX];
};

struct GfGeometry {
  int nrb;        // row blocks (grid z)
  int rows;       // rows per block
};

// Rows go in balanced blocks of at most GF_ROWS_MAX when the matrix's
// columns fit one tile; a wider matrix takes one row per block.
static GfGeometry gf_geometry(int r, int s) {
  GfGeometry g;
  g.nrb = s > GF_TILE_COLS ? r : (r + GF_ROWS_MAX - 1) / GF_ROWS_MAX;
  g.rows = (r + g.nrb - 1) / g.nrb;
  return g;
}

// Multiply the w-bit elements of a word by x: the top bits shifted out,
// the reduction term where an element's top bit was set.  prmt's
// sign-replicating selectors turn each element's top bit into a mask of
// its bytes.  w=8 and w=16: IMAD (x2), PRMT and two LOP3; w=32: SHL, PRMT,
// LOP3.
template <int W>
__device__ __forceinline__ uint32_t xtime_swar(uint32_t v) {
  uint32_t m;
  if constexpr (W == 8) {
    asm("prmt.b32 %0, %1, %1, 0xBA98;" : "=r"(m) : "r"(v));
    return ((v & 0x7f7f7f7fu) * 2u) ^ (m & 0x1d1d1d1du);
  } else if constexpr (W == 16) {
    asm("prmt.b32 %0, %1, %1, 0xBB99;" : "=r"(m) : "r"(v));
    return ((v & 0x7fff7fffu) * 2u) ^ (m & 0x100b100bu);
  } else {
    asm("prmt.b32 %0, %1, %1, 0xBBBB;" : "=r"(m) : "r"(v));
    return (v << 1) ^ (m & 0x00400007u);
  }
}

// Stage one whole, aligned 16-byte unit into shared memory without passing
// through registers (bypassing L1).
__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const unsigned char* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// A unit that is not whole or not aligned: `avail` bytes of it, zero
// padded (zero bytes map to zero bytes).
__device__ __forceinline__ void stage_bytes(const unsigned char* p,
                                            long long avail, uint32_t* dst) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int idx = q * 4 + b;
      if (idx < avail) word |= static_cast<uint32_t>(p[idx]) << (8 * b);
    }
    dst[q] = word;
  }
}

__device__ __forceinline__ void store_unit(unsigned char* p, bool whole,
                                           long long avail,
                                           const uint32_t (&x)[4]) {
  if (whole) {
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(x[0], x[1], x[2], x[3]));
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int idx = q * 4 + b;
      if (idx < avail) p[idx] = static_cast<unsigned char>(x[q] >> (8 * b));
    }
  }
}

// One tile of a row's program over this thread's unit: the partial Horner
// of the tile's columns, XORed into acc; `at` (an offset into `prog`, the
// same for the whole block) advances past the tile.  `mine` is the unit's
// slot 0 in the staged buffer; a pair's words are byte offsets from it.
template <int W>
__device__ __forceinline__ void fold_tile(const int* __restrict__ prog,
                                          int& at, const unsigned char* mine,
                                          uint32_t (&acc)[4]) {
  const int top = prog[at++];
  uint32_t t[4] = {0u, 0u, 0u, 0u};
  for (int lev = 0; lev < top; ++lev) {
    if (lev > 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) t[q] = xtime_swar<W>(t[q]);
    }
    const int np = prog[at++];
    auto pair = [&](int p) {          // two set bits per three-input XOR
      const uint4 a = *reinterpret_cast<const uint4*>(mine + prog[at + 2 * p]);
      const uint4 b =
          *reinterpret_cast<const uint4*>(mine + prog[at + 2 * p + 1]);
      t[0] ^= a.x ^ b.x;
      t[1] ^= a.y ^ b.y;
      t[2] ^= a.z ^ b.z;
      t[3] ^= a.w ^ b.w;
    };
    // unrolled to the most pairs a level can hold: each pair's words are
    // read at constant offsets from `at` (a uniform register)
#pragma unroll
    for (int p = 0; p < (GF_TILE_COLS + 1) / 2; ++p) {
      if (p >= np) break;
      pair(p);
    }
    at += 2 * np;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] ^= t[q];
}

// The body both variants share; `prog` is the row program (parameter or
// device memory).  Control flow is uniform across the block but for the
// staging and stores of a unit past the region's end.
template <int W>
__device__ __forceinline__ void gf_body(
    const int* __restrict__ prog, const unsigned char* __restrict__ in,
    unsigned char* __restrict__ out, long long batch, long long nbytes,
    long long in_bstride, long long in_cstride, long long out_bstride,
    long long out_cstride, int aligned, int r, int cols,
    const unsigned char* __restrict__ mask) {
  extern __shared__ __align__(16) uint32_t stage[];  // [stage][slot][unit]
  const int nrb = prog[1];
  const int per = prog[2];
  const int row0 = blockIdx.z * per;
  const int nrows = r - row0 < per ? r - row0 : per;
  const int tiles = prog[3 + blockIdx.z];     // the block's tile stream
  const int ntiles = prog[tiles];
  const long long off =
      (static_cast<long long>(blockIdx.x) * GF_UNITS + threadIdx.x) * 16;
  const long long avail = nbytes - off;       // bytes of the unit in range
  const bool whole = aligned && avail >= 16;
  // a buffer holds the tile's columns and one zero slot (slot `cols`)
  const int bufwords = (cols + 1) * GF_UNITS * 4;
  uint32_t* const mine0 = stage + threadIdx.x * 4;
#pragma unroll
  for (int s = 0; s < GF_STAGES; ++s) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      mine0[s * bufwords + cols * GF_UNITS * 4 + q] = 0u;
    }
  }

  // stage step (stripe b, the tile header at offset tp) into buffer buf
  auto issue = [&](long long b, int tp, int buf) {
    if (avail <= 0 || (mask != nullptr && mask[b] == 0)) return;
    const unsigned char* src = in + b * in_bstride + off;
    uint32_t* dst = mine0 + buf * bufwords;
    const int ncols = prog[tp];
    for (int c = 0; c < ncols; ++c) {
      const unsigned char* p = src + prog[tp + 1 + c] * in_cstride;
      if (whole) cp_async16(dst + c * GF_UNITS * 4, p);
      else stage_bytes(p, avail, dst + c * GF_UNITS * 4);
    }
  };
  // the step after (stripe b, tile k at tile header tp)
  auto advance = [&](long long& b, int& k, int& tp) {
    if (k + 1 < ntiles) {
      ++k;
      tp += 1 + prog[tp];
    } else {
      b += gridDim.y;
      k = 0;
      tp = tiles + 1;
    }
  };

  // the issue cursor runs GF_STAGES - 1 steps ahead of the fold
  long long ib = blockIdx.y;
  int ik = 0, itp = tiles + 1, ibuf = 0;
#pragma unroll
  for (int s = 0; s < GF_STAGES - 1; ++s) {
    if (ib < batch && ntiles > 0) issue(ib, itp, ibuf);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    advance(ib, ik, itp);
    ibuf = ibuf + 1 == GF_STAGES ? 0 : ibuf + 1;
  }
  long long b = blockIdx.y;
  int k = 0, tp = tiles + 1, buf = 0;
  uint32_t acc[GF_ROWS_MAX][4];
  int at[GF_ROWS_MAX];
  while (b < batch) {
    if (ib < batch && ntiles > 0) issue(ib, itp, ibuf);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(GF_STAGES - 1)
                 : "memory");
    advance(ib, ik, itp);
    ibuf = ibuf + 1 == GF_STAGES ? 0 : ibuf + 1;
    if (k == 0) {
#pragma unroll
      for (int y = 0; y < GF_ROWS_MAX; ++y) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[y][q] = 0u;
        at[y] = prog[3 + nrb + row0 + (y < nrows ? y : 0)];
      }
    }
    if (ntiles > 0) {
      const auto* mine =
          reinterpret_cast<const unsigned char*>(mine0 + buf * bufwords);
#pragma unroll
      for (int y = 0; y < GF_ROWS_MAX; ++y) {
        if (y < nrows) fold_tile<W>(prog, at[y], mine, acc[y]);
      }
    }
    if (k + 1 >= ntiles && avail > 0) {   // the stripe's last step: store
      const bool live = mask == nullptr || mask[b] != 0;
      unsigned char* dst = out + b * out_bstride + off +
                           static_cast<long long>(row0) * out_cstride;
#pragma unroll
      for (int y = 0; y < GF_ROWS_MAX; ++y) {
        if (y < nrows) {
          if (!live) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[y][q] = 0u;
          }
          store_unit(dst + y * out_cstride, whole, avail, acc[y]);
        }
      }
    }
    advance(b, k, tp);
    buf = buf + 1 == GF_STAGES ? 0 : buf + 1;
  }
}

// The by-value variant: the row program is a kernel parameter.
template <int W>
__global__ void __launch_bounds__(GF_UNITS)
gf_matrix_kernel(const unsigned char* __restrict__ in,
                 unsigned char* __restrict__ out, long long batch,
                 long long nbytes, long long in_bstride,
                 long long in_cstride, long long out_bstride,
                 long long out_cstride, int aligned, int r, int cols,
                 const unsigned char* __restrict__ mask,
                 const __grid_constant__ GfProgram m) {
  gf_body<W>(m.prog, in, out, batch, nbytes, in_bstride, in_cstride,
             out_bstride, out_cstride, aligned, r, cols, mask);
}

// The table variant: the row program lies in device memory.
template <int W>
__global__ void __launch_bounds__(GF_UNITS)
gf_matrix_table_kernel(const unsigned char* __restrict__ in,
                       unsigned char* __restrict__ out, long long batch,
                       long long nbytes, long long in_bstride,
                       long long in_cstride, long long out_bstride,
                       long long out_cstride, int aligned, int r, int cols,
                       const unsigned char* __restrict__ mask,
                       const int* __restrict__ prog) {
  gf_body<W>(prog, in, out, batch, nbytes, in_bstride, in_cstride,
             out_bstride, out_cstride, aligned, r, cols, mask);
}

// The launch grid of an (r, s) matrix over `batch` stripes of `nbytes`
// (`table`: the device-program variant) on `device` (current): x the
// chunk's 16-byte units in blocks of GF_UNITS, z the row blocks, y the
// stripes spread evenly over the blocks one wave of the card holds beside
// x * z.  The wave is read once per device, variant and tile width.
template <int W>
static cudaError_t gf_plan(int r, int s, long long batch, long long nbytes,
                           bool table, int device, dim3* grid) {
  static std::atomic<int> waves[2][GF_TILE_COLS + 1][ON_DEVICE_MAX];
  const GfGeometry g = gf_geometry(r, s);
  const int cols = s < GF_TILE_COLS ? s : GF_TILE_COLS;
  const size_t smem =
      static_cast<size_t>(GF_STAGES) * (cols + 1) * GF_UNITS * 16;
  long long wave = 0;
  const cudaError_t err =
      table ? wave_of(gf_matrix_table_kernel<W>, GF_UNITS, smem, device,
                      waves[1][cols], &wave)
            : wave_of(gf_matrix_kernel<W>, GF_UNITS, smem, device,
                      waves[0][cols], &wave);
  if (err != cudaSuccess) return err;
  const long long xt = (nbytes + 16 * GF_UNITS - 1) / (16 * GF_UNITS);
  long long cap = wave / (xt * g.nrb);
  cap = cap < 1 ? 1 : (cap > 65535 ? 65535 : cap);
  const long long each = (batch + cap - 1) / cap;
  *grid = dim3(static_cast<unsigned>(xt),
               static_cast<unsigned>((batch + each - 1) / each),
               static_cast<unsigned>(g.nrb));
  return cudaSuccess;
}

// One launch for every row on `stream` on the current device (`device`);
// returns the first CUDA error.  `prog` (host) fills the by-value program
// when `table` (device) is null.
template <int W>
static cudaError_t apply_on_current(const void* in, void* out,
                                    long long batch, long long nbytes,
                                    long long in_bstride,
                                    long long in_cstride,
                                    long long out_bstride,
                                    long long out_cstride, int r, int s,
                                    const int* prog, const int* table,
                                    const void* mask, int device,
                                    void* stream) {
  const GfGeometry g = gf_geometry(r, s);
  GfProgram m;
  if (table == nullptr) {
    if (prog[0] > GF_PROG_MAX || prog[0] < 3 + g.nrb + r ||
        prog[1] != g.nrb || prog[2] != g.rows) {
      return cudaErrorInvalidValue;
    }
    for (int k = 0; k < prog[0]; ++k) m.prog[k] = prog[k];
  }
  dim3 grid;
  const cudaError_t err =
      gf_plan<W>(r, s, batch, nbytes, table != nullptr, device, &grid);
  if (err != cudaSuccess) return err;
  const auto a16 = [](long long v) { return v % 16 == 0; };
  const int aligned =
      a16(static_cast<long long>(reinterpret_cast<uintptr_t>(in))) &&
      a16(static_cast<long long>(reinterpret_cast<uintptr_t>(out))) &&
      a16(in_bstride) && a16(in_cstride) && a16(out_bstride) &&
      a16(out_cstride);
  const int cols = s < GF_TILE_COLS ? s : GF_TILE_COLS;
  const size_t smem =
      static_cast<size_t>(GF_STAGES) * (cols + 1) * GF_UNITS * 16;
  const auto* src = static_cast<const unsigned char*>(in);
  auto* dst = static_cast<unsigned char*>(out);
  const auto* mk = static_cast<const unsigned char*>(mask);
  auto st = static_cast<cudaStream_t>(stream);
  if (table == nullptr) {
    gf_matrix_kernel<W><<<grid, GF_UNITS, smem, st>>>(
        src, dst, batch, nbytes, in_bstride, in_cstride, out_bstride,
        out_cstride, aligned, r, cols, mk, m);
  } else {
    gf_matrix_table_kernel<W><<<grid, GF_UNITS, smem, st>>>(
        src, dst, batch, nbytes, in_bstride, in_cstride, out_bstride,
        out_cstride, aligned, r, cols, mk, table);
  }
  return cudaGetLastError();
}

static bool gf_args_ok(long long batch, long long nbytes, int r, int s) {
  return r >= 1 && s >= 1 && batch >= 1 && nbytes >= 1 &&
         gf_geometry(r, s).nrb <= 65535 &&
         (nbytes + 16 * GF_UNITS - 1) / (16 * GF_UNITS) <= 0x7FFFFFFFLL;
}

extern "C" {

int gf8_max_prog(void) { return GF_PROG_MAX; }

// The launch geometry of an (r, s) matrix, into out[0..3]: row blocks,
// rows per block, units (threads) per block, columns per staged tile.
void gf8_geometry(int r, int s, int* out) {
  const GfGeometry g = gf_geometry(r, s);
  out[0] = g.nrb;
  out[1] = g.rows;
  out[2] = GF_UNITS;
  out[3] = GF_TILE_COLS;
}

const char* gf8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The grid (x unit tiles, y stripe blocks, z row blocks) that
// gf8_matrix_apply launches for these arguments (gf_plan; the by-value
// variant when `table` is 0), into grid[0..2].  Returns the first CUDA
// error.
int gf8_matrix_plan(long long batch, long long nbytes, int r, int s,
                    int table, int device, int* grid) {
  if (!gf_args_ok(batch, nbytes, r, s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return on_device(device, [&]() -> cudaError_t {
    dim3 g;
    const cudaError_t err = gf_plan<8>(r, s, batch, nbytes, table != 0,
                                       device, &g);
    grid[0] = static_cast<int>(g.x);
    grid[1] = static_cast<int>(g.y);
    grid[2] = static_cast<int>(g.z);
    return err;
  });
}

// Apply the (r, s) GF(2^8) matrix whose row program (ops/gf_kernels.py
// ::dense_program) is `prog` (host memory, at most GF_PROG_MAX words) when
// `table` is null, else `table` (device memory, any size), to `batch`
// stripes of s input chunks of `nbytes` bytes each; strides are in bytes.
// Output row i of stripe b lands at out + b * out_bstride + i *
// out_cstride.  `mask` is null (dense) or a device pointer to `batch`
// uint8 page flags (ragged): a stripe whose flag is 0 reads nothing and
// gets zero rows.  One launch on `stream`, which belongs to `device`;
// returns the first CUDA error (0 when the launch was accepted).  The
// caller's current device is restored before returning.
int gf8_matrix_apply(const void* in, void* out, long long batch,
                     long long nbytes, long long in_bstride,
                     long long in_cstride, long long out_bstride,
                     long long out_cstride, int r, int s, const int* prog,
                     const void* table, const void* mask, int device,
                     void* stream) {
  if (!gf_args_ok(batch, nbytes, r, s) ||
      (table == nullptr && prog == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return on_device(device, [&]() -> cudaError_t {
    return apply_on_current<8>(
        in, out, batch, nbytes, in_bstride, in_cstride, out_bstride,
        out_cstride, r, s, prog, static_cast<const int*>(table), mask,
        device, stream);
  });
}

// The same for w = 16 or 32 (the program's levels run up to w bits);
// `nbytes` is a whole number of w-bit elements.
int gfw_matrix_apply(const void* in, void* out, long long batch,
                     long long nbytes, long long in_bstride,
                     long long in_cstride, long long out_bstride,
                     long long out_cstride, int r, int s, int w,
                     const int* prog, const void* table, int device,
                     void* stream) {
  if (!gf_args_ok(batch, nbytes, r, s) || (w != 16 && w != 32) ||
      nbytes % (w / 8) != 0 || (table == nullptr && prog == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* tab = static_cast<const int*>(table);
  return on_device(device, [&]() -> cudaError_t {
    if (w == 16) {
      return apply_on_current<16>(in, out, batch, nbytes, in_bstride,
                                  in_cstride, out_bstride, out_cstride, r,
                                  s, prog, tab, nullptr, device, stream);
    }
    return apply_on_current<32>(in, out, batch, nbytes, in_bstride,
                                in_cstride, out_bstride, out_cstride, r, s,
                                prog, tab, nullptr, device, stream);
  });
}

}  // extern "C"
