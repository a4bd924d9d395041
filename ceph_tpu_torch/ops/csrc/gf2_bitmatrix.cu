// GF(2) bitmatrix apply in jerasure's packet layout, for Hopper (sm_90a).
//
// A chunk of C bytes is nb = C / (w * packetsize) blocks of w packets of
// `packetsize` bytes.  Output packet (i, l) of a block is the XOR of the
// input packets (j, lb) of the same block whose bit is set in the
// (r*w, s*w) bitmatrix; blocks never mix.
//
// One kernel, gf2_packet_kernel, runs "rows": a row XORs a list of slots
// (input packets, or results of earlier rows), keeps the result in a slot
// and/or stores it as an output packet.  It replaces two TPU kernels of
// the JAX package (ceph_tpu/ops/pallas_gf.py), behind two wrappers in
// ops/gf_kernels.py that differ only in the rows they hand it:
//   - apply_bitmatrix_pallas (body _bitmatrix_kernel), the plain product:
//     one row per output packet, its leaves the input packets of its mask
//     (apply_bitmatrix_cuda);
//   - apply_bitmatrix_xor_pallas (body _bitmatrix_xor_kernel), the product
//     through a CSE schedule (ops/xor_schedule.py): one row per node the
//     schedule must make (a temp read twice, or an output), its leaves the
//     inputs and temps under it, so shared temps are XORed once
//     (apply_bitmatrix_xor_cuda; rows from xor_schedule.row_program).
//
// Design:
//   - The matrix is data, not code (as in gf8_matrix.cu): the rows sit in a
//     small device buffer that the wrapper builds once per matrix and
//     caches, so one binary serves the encode and every decode pattern.
//     Each block copies it into shared memory once; every thread then reads
//     the same header or index at the same time (a broadcast) and walks the
//     rows in the same order: no divergence.
//   - One thread owns one unit of V (8, 4 or 1 bytes, the widest that the
//     packet size, pointers and strides allow and the slots fit) at one
//     offset of one packet of one block.  Consecutive threads take
//     consecutive units of a packet, so every load and store coalesces.
//     Any packetsize works (liberation's default is 8 bytes).  No 16-byte
//     unit: for the same shared memory it gives half the threads, and the
//     walk needs warps more than wide reads.
//   - The thread copies the s*w input units at its offset from HBM once, by
//     cp.async (all in flight at once, no register held), into its own
//     slots of shared memory: thread-major with an odd pitch, so a warp's
//     accesses to one slot hit distinct banks and no thread reads another's
//     slots (no barrier).  Rows name slots at run time, which registers
//     cannot do.  A row accumulates in a register and reads its leaves
//     GROUP at a time (padded with a zero slot that is never read), with the
//     next group's indices fetched ahead; a kept result goes to a slot
//     freed by liveness (assigned in Python), the rest to a trash slot.
//     Offsets advance by addition and stores name (chunk, packet), so no
//     division is left.  The block shrinks (128 -> 32 threads), and the unit
//     narrows, until the slots fit the shared-memory budget.
//
// What bounds it (H100 SXM, cauchy_good k=8 m=3, 64 stripes x (8 in + 3
// out) x 128 KiB, packetsize 2048): 92.3 MB moved is ~27.5 us at 3.35 TB/s,
// while the XORs, folded three inputs at a time by LOP3, are ~6e7 INT32
// operations (~4 us).  So memory bounds both products.  On an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py) the kernel reached about 0.46 of that
// bound for the plain product and 0.24 for the scheduled encode: its slots
// fill shared memory, so an SM holds 6-12 warps, and the row walk is a
// chain of shared-memory reads that so few warps do not hide.  The scheduled rows
// read fewer leaves (349 + 78 saves for the encode, against 487 plain) but
// have more slots (119: 8-byte units in 64-thread blocks) and more rows
// (102 against 24).  Warp-specialised TMA staging and keeping hot slots in
// registers are left for later work.

#include <cstdint>
#include <initializer_list>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "on_device.cuh"

#define GF2_MAX_THREADS 128
#define GF2_MIN_THREADS 32
#define GF2_SMEM_BUDGET (100 * 1024)
#define LOAD_BATCH 16
#define GROUP 4
#define NO_STORE 0xFFFF

__device__ __forceinline__ uint2 vxor(uint2 a, uint2 b) {
  return make_uint2(a.x ^ b.x, a.y ^ b.y);
}
__device__ __forceinline__ uint32_t vxor(uint32_t a, uint32_t b) {
  return a ^ b;
}
__device__ __forceinline__ unsigned char vxor(unsigned char a,
                                              unsigned char b) {
  return a ^ b;
}

template <typename V>
__device__ __forceinline__ V vzero() {
  return V{};
}

// Where one thread's unit lives: the byte offset of its unit inside packet
// 0 of chunk 0 of its block, per batch entry.
struct PacketGeometry {
  long long batch;
  long long nb;          // blocks per chunk
  long long units;       // units of V per packet
  long long in_bstride;  // bytes
  long long in_cstride;
  long long out_bstride;
  long long out_cstride;
  int w;
  int packetsize;
};

// Thread -> (input base, output base) of its unit; false past the end.
// The launch keeps batch * nb * units below 2^32.
template <typename V>
__device__ __forceinline__ bool unit_of(const PacketGeometry& g,
                                        const unsigned char* in,
                                        unsigned char* out,
                                        const unsigned char** src,
                                        unsigned char** dst) {
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned units = static_cast<unsigned>(g.units);
  const unsigned nb = static_cast<unsigned>(g.nb);
  if (idx >= static_cast<unsigned>(g.batch) * nb * units) return false;
  const unsigned rest = idx / units;
  const long long off = static_cast<long long>(rest % nb) * g.w *
                            g.packetsize +
                        static_cast<long long>(idx - rest * units) *
                            sizeof(V);
  const long long b = rest / nb;
  *src = in + b * g.in_bstride + off;
  *dst = out + b * g.out_bstride + off;
  return true;
}

// Input packet c = j * w + lb of this unit -> slot c of this thread's
// slots.  Units of 4 bytes or more go by cp.async, all of them in flight
// at once and no register held; single bytes in batches of LOAD_BATCH
// loads.  The packet offsets advance by addition (a division per load
// would serialise the address math).
template <typename V>
__device__ __forceinline__ void load_inputs(const PacketGeometry& g,
                                            const unsigned char* src,
                                            V* mine, int n_in) {
  long long chunk = 0;
  int lb = 0;
  if constexpr (sizeof(V) >= 4) {
    for (int c = 0; c < n_in; ++c) {
      __pipeline_memcpy_async(mine + c, src + chunk + lb * g.packetsize,
                              sizeof(V));
      if (++lb == g.w) {
        lb = 0;
        chunk += g.in_cstride;
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else {
    for (int c0 = 0; c0 < n_in; c0 += LOAD_BATCH) {
      V tmp[LOAD_BATCH];
#pragma unroll
      for (int u = 0; u < LOAD_BATCH; ++u) {
        if (c0 + u < n_in) {
          tmp[u] = src[chunk + lb * g.packetsize];
          if (++lb == g.w) {
            lb = 0;
            chunk += g.in_cstride;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < LOAD_BATCH; ++u) {
        if (c0 + u < n_in) mine[c0 + u] = tmp[u];
      }
    }
  }
}

// Packet l of output chunk i of this unit.
template <typename V>
__device__ __forceinline__ void store_packet(const PacketGeometry& g,
                                             unsigned char* dst, int i, int l,
                                             V v) {
  *reinterpret_cast<V*>(dst + i * g.out_cstride + l * g.packetsize) = v;
}

// Copy the n16 16-byte words of kernel data (index lists or instructions)
// into the front of shared memory, every thread of the block taking part,
// then wait for all: each later fetch is a shared-memory broadcast, where
// a global one could miss L1 and wait on L2 once per step.
__device__ __forceinline__ void stage(const uint4* __restrict__ data,
                                      uint4* smem, int n16) {
  for (int i = threadIdx.x; i < n16; i += blockDim.x) smem[i] = data[i];
  __syncthreads();
}

// This thread's n_slots slots, after the n16 words of kernel data:
// thread-major, with an odd pitch so that the 16/8/4-byte accesses of a
// warp to one slot index hit distinct banks.
template <typename V>
__device__ __forceinline__ V* thread_slots(uint4* smem, int n16,
                                           int n_slots) {
  return reinterpret_cast<V*>(smem + n16) + threadIdx.x * (n_slots | 1);
}

// Leaf `idx` of this thread's slots; the zero slot reads as zeros without
// touching shared memory (rows are padded with it).
template <typename V>
__device__ __forceinline__ V leaf(const V* mine, unsigned idx,
                                  unsigned zero) {
  return idx == zero ? vzero<V>() : mine[idx];
}

// data (n16 words): n_rows headers (groups, dst, chunk, packet) of uint16,
// then the rows' leaves, GROUP slot ids per ushort4 (each row padded with
// the zero slot), then a pad group.  Row r XORs its leaves in a register,
// GROUP reads at a time with the next group fetched ahead, keeps the
// result in slot dst (the trash slot when no later row reads it), and
// stores it to packet `packet` of output chunk `chunk` unless chunk ==
// NO_STORE.  Slots 0..n_in-1 are the input packets; the last two are the
// zero and trash slots.
template <typename V>
__global__ void __launch_bounds__(GF2_MAX_THREADS)
gf2_packet_kernel(const unsigned char* __restrict__ in,
                  unsigned char* __restrict__ out, const PacketGeometry g,
                  const uint4* __restrict__ data, int n16, int n_rows,
                  int n_in, int n_slots) {
  extern __shared__ uint4 smem[];
  stage(data, smem, n16);
  const unsigned char* src;
  unsigned char* dst;
  if (!unit_of<V>(g, in, out, &src, &dst)) return;
  const ushort4* head = reinterpret_cast<const ushort4*>(smem);
  const ushort4* q = head + n_rows;
  V* mine = thread_slots<V>(smem, n16, n_slots);
  load_inputs<V>(g, src, mine, n_in);
  const unsigned zero = n_slots - 2;
  for (int r = 0; r < n_rows; ++r) {
    const ushort4 h = head[r];
    V acc = vzero<V>();
    ushort4 next = q[0];
    for (int k = 0; k < h.x; ++k) {
      const ushort4 c = next;
      next = q[k + 1];                 // the leaves end with a pad group
      acc = vxor(vxor(acc, vxor(leaf(mine, c.x, zero), leaf(mine, c.y, zero))),
                 vxor(leaf(mine, c.z, zero), leaf(mine, c.w, zero)));
    }
    q += h.x;
    mine[h.y] = acc;
    if (h.z != NO_STORE) store_packet<V>(g, dst, h.z, h.w, acc);
  }
}

// Threads per block for n_slots slots of `unit` bytes and `extra` bytes of
// kernel data: the most, up to GF2_MAX_THREADS and down to `least`, that
// fit the shared-memory budget; 0 when `least` threads do not fit it.
static int block_threads(int n_slots, int unit, int least, long long extra) {
  for (int nt = GF2_MAX_THREADS; nt >= least; nt /= 2) {
    if (extra + static_cast<long long>(n_slots | 1) * nt * unit <=
        GF2_SMEM_BUDGET) {
      return nt;
    }
  }
  return 0;
}

// The unit of one thread: 8 or 4 bytes, the wider that the packet size
// and every pointer and stride allow and whose slots still fit a block of
// two warps; else 1 byte.
static int unit_bytes(const void* in, const void* out,
                      const PacketGeometry& g, int n_slots,
                      long long extra) {
  const long long vals[] = {static_cast<long long>(
                                reinterpret_cast<uintptr_t>(in)),
                            static_cast<long long>(
                                reinterpret_cast<uintptr_t>(out)),
                            g.in_bstride, g.in_cstride, g.out_bstride,
                            g.out_cstride, g.packetsize};
  for (int u : {8, 4}) {
    bool ok = block_threads(n_slots, u, 2 * GF2_MIN_THREADS, extra) > 0;
    for (long long v : vals) ok = ok && v % u == 0;
    if (ok) return u;
  }
  return 1;
}

template <typename V, typename K, typename... Args>
static cudaError_t launch_units(K kernel, const PacketGeometry& g,
                                int n_slots, int n16, cudaStream_t stream,
                                Args... args) {
  const long long extra = 16LL * n16;
  const int nt = block_threads(n_slots, sizeof(V), GF2_MIN_THREADS, extra);
  if (nt == 0) return cudaErrorInvalidValue;
  const size_t smem =
      extra + static_cast<size_t>(n_slots | 1) * nt * sizeof(V);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long total = g.batch * g.nb * g.units;
  if (total + nt > 0xffffffffLL) return cudaErrorInvalidValue;
  const long long blocks = (total + nt - 1) / nt;
  kernel<<<static_cast<unsigned>(blocks), nt, smem, stream>>>(args...);
  return cudaGetLastError();
}

static bool geometry(PacketGeometry* g, long long batch, long long nbytes,
                     long long in_bstride, long long in_cstride,
                     long long out_bstride, long long out_cstride, int w,
                     int packetsize) {
  if (batch < 1 || w < 1 || packetsize < 1 || nbytes < 1 ||
      nbytes % (static_cast<long long>(w) * packetsize) != 0) {
    return false;
  }
  g->batch = batch;
  g->nb = nbytes / (static_cast<long long>(w) * packetsize);
  g->in_bstride = in_bstride;
  g->in_cstride = in_cstride;
  g->out_bstride = out_bstride;
  g->out_cstride = out_cstride;
  g->w = w;
  g->packetsize = packetsize;
  return true;
}

extern "C" {

const char* gf2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gf2_row_group(void) { return GROUP; }

int gf2_no_store(void) { return NO_STORE; }

// Run n_rows rows (device memory, n16 16-byte words laid out as
// gf2_packet_kernel reads them) over `batch` stripes of s input chunks of
// `nbytes` bytes, reading n_in <= s * w input packets per block into
// n_slots slots and storing rw = r * w output packets; strides in bytes.
// Output chunk i of stripe b starts at out + b * out_bstride + i *
// out_cstride.  One launch on `stream` (of `device`); returns the CUDA
// error, 0 when the launch was accepted.
int gf2_rows_apply(const void* in, void* out, long long batch,
                   long long nbytes, long long in_bstride,
                   long long in_cstride, long long out_bstride,
                   long long out_cstride, int s, int rw, int w,
                   int packetsize, const void* data, int n16, int n_rows,
                   int n_in, int n_slots, int device, void* stream) {
  PacketGeometry g;
  if (!geometry(&g, batch, nbytes, in_bstride, in_cstride, out_bstride,
                out_cstride, w, packetsize) ||
      s < 1 || rw < 1 || rw % w != 0 || n_rows < 1 || n_in < 1 ||
      n_in > s * w || n_slots < n_in + 2 || n_slots >= NO_STORE ||
      16LL * n16 < 8LL * (n_rows + 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* src = static_cast<const unsigned char*>(in);
  auto* dst = static_cast<unsigned char*>(out);
  const auto* dt = static_cast<const uint4*>(data);
  auto st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> cudaError_t {
    const int unit = unit_bytes(in, out, g, n_slots, 16LL * n16);
    g.units = packetsize / unit;
    if (unit == 8) {
      return launch_units<uint2>(gf2_packet_kernel<uint2>, g, n_slots, n16,
                                 st, src, dst, g, dt, n16, n_rows, n_in,
                                 n_slots);
    }
    if (unit == 4) {
      return launch_units<uint32_t>(gf2_packet_kernel<uint32_t>, g, n_slots,
                                    n16, st, src, dst, g, dt, n16, n_rows,
                                    n_in, n_slots);
    }
    return launch_units<unsigned char>(gf2_packet_kernel<unsigned char>, g,
                                       n_slots, n16, st, src, dst, g, dt,
                                       n16, n_rows, n_in, n_slots);
  });
}

}  // extern "C"
