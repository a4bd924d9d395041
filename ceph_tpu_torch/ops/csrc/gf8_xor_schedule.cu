// GF(2^8) matrix apply through an XOR schedule, for Hopper (sm_90a).
//
// out[i] = XOR_j M[i][j] * in[j] over GF(2^8) (poly 0x11D), computed by the
// straight-line program ops/xor_schedule.py makes of the matrix: full-width
// SWAR ops on 32-bit words of 4 field bytes — xtime, byte-local shifts and
// XORs (the greedy-CSE bit-matrix expansion, or the polynomial-ring
// transform with one feedback fold per row for monomial matrices).
//
// Replaces two TPU kernels of the JAX package (ceph_tpu/ops/pallas_gf.py),
// both with the body _xor_matrix_kernel, behind two wrappers in
// ops/gf_kernels.py:
//   - apply_matrix_xor_pallas  (bytes layout, (..., s, C) uint8, C % 4 == 0)
//     -> apply_matrix_xor_cuda;
//   - apply_matrix_xor_packed  (packed layout, (..., s, R, 128) uint32)
//     -> apply_matrix_xor_cuda_packed.
// A uint8 buffer read as little-endian uint32 already is the packed layout,
// so both wrappers hand this kernel the same bytes.  The TPU's (rt, 128) row
// tiles and sublane padding have no counterpart here.
//
// Design:
//   - The schedule is kernel data, not code: xor_schedule.word_program turns
//     it into instructions, which the wrapper packs into a device buffer
//     once per (schedule, device).  Each block stages them into shared
//     memory; every thread then reads the same word at the same time (a
//     broadcast) and walks the same instructions: no divergence.  One build
//     serves every lrc / shec pattern and the reed_sol_r6_op encode.
//   - A schedule names its nodes at run time, and registers cannot be
//     indexed.  So, as in gf2_bitmatrix.cu, an instruction accumulates one
//     node in a register from its leaves, and only nodes read twice (or read
//     by a shift or xtime) are kept, in per-thread slots of shared memory
//     (thread-major, odd pitch: a warp's accesses to one slot hit distinct
//     banks, and no thread reads another's slots, so no barrier).  A leaf
//     carries its own unary op (xtime, byte-local shl / shr), applied as it
//     is read: a plane read once — the ring schedule's shifted inputs, and
//     most xtime planes — is never stored.
//   - Only the inputs the schedule reads are loaded, each by the leaf that
//     reads it, straight from memory into the accumulation; an input read
//     by several leaves is read again from the cache (on an H100 that beat
//     copying it into a slot once: chip_smoke.py's r6 encode, PERF.md).
//     lrc's local repair reads 3 of its 7 survivors, so 3 of 7 chunks
//     move.
//   - A thread owns one unit of 16, 8 or 4 bytes at one offset of every
//     chunk of one stripe: the widest that the chunk size, the pointers and
//     the strides allow and whose slots fit the shared-memory budget with
//     64 threads (4 bytes: 32).  C % 4 == 0 is required, so there is no
//     masked tail.  Consecutive threads take consecutive units, so loads
//     and stores coalesce.  Grid: x spans the units of a chunk, y the
//     stripes (grid-stride); strides are arguments, so a survivor slice
//     with a strided chunk axis needs no copy.
//   - Capacity: the program and the slots of 32 threads of 4-byte units must
//     fit GX_SMEM_BUDGET.  ops/gf_kernels.py::xor_program_fits states the
//     same rule; the engine table routes a schedule that does not fit to the
//     dense kernel, and the wrapper raises before launching one.
//
// What bounds it (H100 SXM, 64 stripes of 1 MiB): reed_sol_r6_op k=8 m=2
// encode moves 64 x (8 + 2) x 128 KiB = 83.9 MB, 0.025041 ms at 3.35 TB/s;
// lrc k=4 m=2 l=3's local repair reads 3 chunks of 256 KiB and writes 1,
// 67.1 MB, 0.020033 ms.  Their integer work (gf_kernels.
// xor_schedule_op_count: LOP3-folded XORs, 2 instructions per shift, 4 per
// xtime) is well under 0.01 ms at the INT32 peak, so memory bounds both.

#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

#include "on_device.cuh"

#define GX_MAX_THREADS 128
#define GX_MIN_THREADS 32
#define GX_SMEM_BUDGET (96 * 1024)

// a leaf: bits 0-19 index (slot, or input chunk), 20-22 shift, 24-25 op,
// bit 28 set: read input chunk `index` from memory instead of a slot
#define GX_INDEX_MASK 0xFFFFFu
#define GX_FROM_MEMORY (1u << 28)
#define GX_OP_ID 0u
#define GX_OP_XT 1u
#define GX_OP_SHL 2u
#define GX_OP_SHR 3u
#define GX_ZERO 0xFFFFFFFFu      // a padding leaf that reads as zero
#define GX_NONE 0xFFFFFFFFu      // no slot kept / no row stored

template <int N>
struct alignas(4 * N) Unit {
  uint32_t w[N];
};

template <int N>
__device__ __forceinline__ Unit<N> unit_zero() {
  Unit<N> u;
#pragma unroll
  for (int q = 0; q < N; ++q) u.w[q] = 0u;
  return u;
}

template <int N>
__device__ __forceinline__ Unit<N> unit_xor(Unit<N> a, const Unit<N>& b) {
#pragma unroll
  for (int q = 0; q < N; ++q) a.w[q] ^= b.w[q];
  return a;
}

template <int N>
__device__ __forceinline__ Unit<N> load_unit(const unsigned char* p) {
  return *reinterpret_cast<const Unit<N>*>(p);
}

template <int N>
__device__ __forceinline__ void store_unit(unsigned char* p,
                                           const Unit<N>& u) {
  *reinterpret_cast<Unit<N>*>(p) = u;
}

// Multiply 4 packed field bytes by x: AND, SHR, IMAD, SHL and one LOP3
// (the same bytes as the schedule's mul-free tap form).
__device__ __forceinline__ uint32_t xtime_word(uint32_t v) {
  const uint32_t hi = v & 0x80808080u;
  return ((v ^ hi) << 1) ^ ((hi >> 7) * 0x1du);
}

// The value leaf `code` names for this thread's unit, before its op: a slot,
// or an input chunk read from memory.  Nothing here depends on a loaded
// value, so a step issues the loads of its 4 leaves back to back.
template <int N>
__device__ __forceinline__ Unit<N> leaf_value(uint32_t code,
                                              const Unit<N>* mine,
                                              const unsigned char* src,
                                              long long in_cstride) {
  if (code == GX_ZERO) return unit_zero<N>();
  const uint32_t idx = code & GX_INDEX_MASK;
  if (code & GX_FROM_MEMORY) {
    return load_unit<N>(src + static_cast<long long>(idx) * in_cstride);
  }
  return mine[idx];
}

// The leaf's unary op on its value.  The op and the shift are the same for
// every thread of the block, so the branches do not diverge.  The zero leaf
// carries op shr by 7 of a zero value: zero.
template <int N>
__device__ __forceinline__ Unit<N> leaf_op(uint32_t code, Unit<N> v) {
  const uint32_t op = (code >> 24) & 3u;
  const uint32_t sh = (code >> 20) & 7u;
  if (op == GX_OP_XT) {
#pragma unroll
    for (int q = 0; q < N; ++q) v.w[q] = xtime_word(v.w[q]);
  } else if (op == GX_OP_SHL) {
    const uint32_t m = 0x01010101u * ((0xFFu << sh) & 0xFFu);
#pragma unroll
    for (int q = 0; q < N; ++q) v.w[q] = (v.w[q] << sh) & m;
  } else if (op == GX_OP_SHR) {
    const uint32_t m = 0x01010101u * (0xFFu >> sh);
#pragma unroll
    for (int q = 0; q < N; ++q) v.w[q] = (v.w[q] >> sh) & m;
  }
  return v;
}

struct XorGeometry {
  long long batch;
  long long nbytes;       // bytes per chunk, a multiple of 4 * N
  long long in_bstride;   // bytes
  long long in_cstride;
  long long out_bstride;
  long long out_cstride;
};

// prog (n16 16-byte words): n_instr instructions, each a header (groups,
// dst slot or GX_NONE, output row or GX_NONE, 0) followed by `groups`
// words of 4 leaves (padded with GX_ZERO); then a pad word.  An
// instruction XORs its leaves in a register, 4 per step (their 4 loads
// first, then their ops) with the next 4 leaf codes fetched ahead, keeps
// the result in slot dst and stores it to output row `row`.
template <int N>
__global__ void __launch_bounds__(GX_MAX_THREADS)
gf8_xor_kernel(const unsigned char* __restrict__ in,
               unsigned char* __restrict__ out, const XorGeometry g,
               const uint4* __restrict__ prog, int n16, int n_instr,
               int n_slots) {
  extern __shared__ uint4 smem[];
  for (int i = threadIdx.x; i < n16; i += blockDim.x) smem[i] = prog[i];
  __syncthreads();
  const long long off =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
      (4 * N);
  if (off >= g.nbytes) return;
  Unit<N>* mine = reinterpret_cast<Unit<N>*>(smem + n16) +
                  threadIdx.x * (n_slots | 1);
  for (long long b = blockIdx.y; b < g.batch; b += gridDim.y) {
    const unsigned char* src = in + b * g.in_bstride + off;
    unsigned char* dst = out + b * g.out_bstride + off;
    const uint4* q = smem;
    for (int r = 0; r < n_instr; ++r) {
      const uint4 h = *q++;
      Unit<N> acc = unit_zero<N>();
      uint4 next = q[0];
      for (uint32_t k = 0; k < h.x; ++k) {
        const uint4 c = next;
        next = q[k + 1];            // the program ends with a pad word
        const Unit<N> v0 = leaf_value<N>(c.x, mine, src, g.in_cstride);
        const Unit<N> v1 = leaf_value<N>(c.y, mine, src, g.in_cstride);
        const Unit<N> v2 = leaf_value<N>(c.z, mine, src, g.in_cstride);
        const Unit<N> v3 = leaf_value<N>(c.w, mine, src, g.in_cstride);
        const Unit<N> a = unit_xor(leaf_op<N>(c.x, v0), leaf_op<N>(c.y, v1));
        const Unit<N> d = unit_xor(leaf_op<N>(c.z, v2), leaf_op<N>(c.w, v3));
        acc = unit_xor(acc, unit_xor(a, d));
      }
      q += h.x;
      if (h.y != GX_NONE) mine[h.y] = acc;
      if (h.z != GX_NONE) store_unit<N>(dst + h.z * g.out_cstride, acc);
    }
  }
}

// Threads per block for n_slots slots of `unit` bytes and `extra` bytes of
// program: the most, up to GX_MAX_THREADS and down to `least`, that fit
// the shared-memory budget; 0 when `least` threads do not fit it.
static int block_threads(int n_slots, int unit, int least, long long extra) {
  for (int nt = GX_MAX_THREADS; nt >= least; nt /= 2) {
    if (extra + static_cast<long long>(n_slots | 1) * nt * unit <=
        GX_SMEM_BUDGET) {
      return nt;
    }
  }
  return 0;
}

// The unit of one thread: 16 or 8 bytes, the wider that the chunk size and
// every pointer and stride allow and whose slots fit a block of two warps;
// else 4 bytes (the caller requires 4 | everything).
static int unit_bytes(const void* in, const void* out, const XorGeometry& g,
                      int n_slots, long long extra) {
  const long long vals[] = {
      static_cast<long long>(reinterpret_cast<uintptr_t>(in)),
      static_cast<long long>(reinterpret_cast<uintptr_t>(out)),
      g.nbytes, g.in_bstride, g.in_cstride, g.out_bstride, g.out_cstride};
  for (int u : {16, 8}) {
    bool ok = block_threads(n_slots, u, 2 * GX_MIN_THREADS, extra) > 0;
    for (long long v : vals) ok = ok && v % u == 0;
    if (ok) return u;
  }
  return 4;
}

template <int N>
static cudaError_t launch_units(const unsigned char* in, unsigned char* out,
                                const XorGeometry& g, const uint4* prog,
                                int n16, int n_instr, int n_slots,
                                cudaStream_t stream) {
  const long long extra = 16LL * n16;
  const int unit = 4 * N;
  const int nt = block_threads(n_slots, unit, GX_MIN_THREADS, extra);
  if (nt == 0) return cudaErrorInvalidValue;
  const size_t smem =
      extra + static_cast<size_t>(n_slots | 1) * nt * unit;
  cudaError_t err = cudaFuncSetAttribute(
      gf8_xor_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long units = g.nbytes / unit;
  const long long blocks = (units + nt - 1) / nt;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(g.batch < 65535 ? g.batch : 65535));
  gf8_xor_kernel<N><<<grid, nt, smem, stream>>>(in, out, g, prog, n16,
                                                n_instr, n_slots);
  return cudaGetLastError();
}

extern "C" {

const char* gf8x_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gf8x_smem_budget(void) { return GX_SMEM_BUDGET; }

// Run a schedule's program (device memory, n16 16-byte words laid out as
// gf8_xor_kernel reads them: n_instr instructions, n_slots slots per
// thread) over `batch` stripes of input chunks of
// `nbytes` bytes (a multiple of 4); strides in bytes.  Output row i of
// stripe b starts at out + b * out_bstride + i * out_cstride.  One launch
// on `stream` (of `device`); returns the CUDA error, 0 when the launch was
// accepted.
int gf8x_schedule_apply(const void* in, void* out, long long batch,
                        long long nbytes, long long in_bstride,
                        long long in_cstride, long long out_bstride,
                        long long out_cstride, const void* prog, int n16,
                        int n_instr, int n_slots, int device, void* stream) {
  if (batch < 1 || nbytes < 4 || nbytes % 4 != 0 || n16 < 1 ||
      n_instr < 1 || n_slots < 0 ||
      n_slots > static_cast<int>(GX_INDEX_MASK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  XorGeometry g;
  g.batch = batch;
  g.nbytes = nbytes;
  g.in_bstride = in_bstride;
  g.in_cstride = in_cstride;
  g.out_bstride = out_bstride;
  g.out_cstride = out_cstride;
  const auto* src = static_cast<const unsigned char*>(in);
  auto* dst = static_cast<unsigned char*>(out);
  const auto* pg = static_cast<const uint4*>(prog);
  auto st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> cudaError_t {
    const int unit = unit_bytes(in, out, g, n_slots, 16LL * n16);
    if (unit == 16) {
      return launch_units<4>(src, dst, g, pg, n16, n_instr, n_slots, st);
    }
    if (unit == 8) {
      return launch_units<2>(src, dst, g, pg, n16, n_instr, n_slots, st);
    }
    return launch_units<1>(src, dst, g, pg, n16, n_instr, n_slots, st);
  });
}

}  // extern "C"
