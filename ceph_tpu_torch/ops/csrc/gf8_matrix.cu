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
// On the TPU the bytes kernel repacks u8 tiles into u32 words in registers.
// Here a uint8 buffer read as little-endian uint32 already IS the packed
// layout, and GF(2^w) region math is local to each w-bit element, so one
// kernel over 32-bit SWAR words (4 field bytes, 2 halfwords or 1 word per
// u32) computes all three; the field width is a template parameter, and the
// Python wrappers in ops/gf_kernels.py only describe the buffers.
//
// Design:
//   - The coefficients are data, not code: the (r, s) matrix travels as a
//     by-value __grid_constant__ struct (uint8 coefficients for w=8, uint32
//     for w=16/32), so one binary serves every matrix (encode, and every one
//     of the C(k+m, m) decode patterns).  Pallas specialises a program per
//     static matrix; on CUDA a per-matrix build would cost seconds.  Each
//     column's bits are walked up to its highest set bit (uniform across the
//     warp: no divergence).
//   - Each thread owns one 16-byte vector (4 SWAR words) of the region.  It
//     reads the s input chunks in turn, runs the xtime doubling chain on
//     each, and folds plane t into the accumulators of the rows whose
//     coefficient has bit t set (a predicated AND/XOR pair, one LOP3).
//     Output rows go in groups of at most GF_ROW_GROUP held in registers;
//     a further group re-reads the inputs, so any r is correct.
//   - Grid: x spans the 16-byte vectors of a chunk, y the stripe batch
//     (grid-stride).  Batch and chunk strides are arguments, so the decode's
//     survivor slice chunks[..., :ns, :] needs no copy.  Vector loads need
//     16-byte aligned pointers and strides; otherwise, and for a tail that is
//     not a whole vector, the thread loads and stores bytes (masked).  A
//     w-bit element never straddles a vector (16 % (w/8) == 0), so a
//     zero-padded tail element maps to zero and is never stored.
//   - Ragged: the same kernel with a device pointer to a (batch,) uint8
//     page mask (null on the dense path).  The batch index is the page; a
//     page whose mask byte is 0 reads no input and stores zeros to this row
//     group's rows, so its cost is the zero store.  The mask is an argument,
//     not code: one build serves every occupancy, and a fire moves nothing
//     but the pool and its mask.  Its bound counts the reads of live pages,
//     the writes of every page, and the integer work of live pages.
//
// What bounds it (H100 SXM, 64 stripes x (8 in + 3 out) x 128 KiB, RS k=8
// m=3, w=8): 92.3 MB moved is ~27.5 us at 3.35 TB/s.  The integer work is at
// least 225 instructions per word position (4 per xtime, see xtime_swar8,
// and each output row's planes folded three at a time by LOP3) x 2.1e6
// word positions = 4.7e8, ~28.2 us at 132 SMs x 64 INT32 lanes x 1.98
// GHz (ops/gf_kernels.py::sm90_op_count).  So the ALU, just ahead of
// memory, is the bound; this kernel spends more than the least (5
// instructions per xtime, a predicated AND/XOR per row per plane).  For
// w=16/32 the doubling chains run up to 15 / 31 xtimes per column, so the
// ALU bounds those by a wider margin.  wgmma/TMA and split-nibble tables
// are left for later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "on_device.cuh"

#define GF8_MAX_COEF 2048
#define GFW_MAX_COEF 512
#define GF_ROW_GROUP 8

// by-value kernel argument: the (r, s) matrix, row-major; under 4 KB of
// kernel parameters for every width
template <typename C, int MAX>
struct GfMatrix {
  int r;
  int s;
  C coef[MAX];
};
using Gf8Matrix = GfMatrix<unsigned char, GF8_MAX_COEF>;
using GfwMatrix = GfMatrix<uint32_t, GFW_MAX_COEF>;

// Multiply 4 packed field bytes by x: AND, SHR, IMAD, SHL and one LOP3.
// (The high word of hi * (0x1D << 25) gives the same reduction term in
// one IMAD.HI, 4 instructions in all, which is what the bound counts; it
// measured slower on an H100.)
__device__ __forceinline__ uint32_t xtime_swar8(uint32_t v) {
  const uint32_t hi = v & 0x80808080u;
  return ((v ^ hi) << 1) ^ ((hi >> 7) * 0x1du);
}

// 2 little-endian GF(2^16) halfwords per word, feedback 0x100b
__device__ __forceinline__ uint32_t xtime_swar16(uint32_t v) {
  const uint32_t hi = v & 0x80008000u;
  return ((v ^ hi) << 1) ^ ((hi >> 15) * 0x100bu);
}

// one GF(2^32) element per word, feedback 0x400007
__device__ __forceinline__ uint32_t xtime_swar32(uint32_t v) {
  const uint32_t hi = v & 0x80000000u;
  return ((v ^ hi) << 1) ^ ((hi >> 31) * 0x400007u);
}

template <int W>
__device__ __forceinline__ uint32_t xtime_swar(uint32_t v) {
  if constexpr (W == 8) return xtime_swar8(v);
  else if constexpr (W == 16) return xtime_swar16(v);
  else return xtime_swar32(v);
}

__device__ __forceinline__ void load16(const unsigned char* p, bool vec,
                                       long long avail, uint32_t x[4]) {
  if (vec) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int idx = q * 4 + b;
      if (idx < avail) word |= static_cast<uint32_t>(p[idx]) << (8 * b);
    }
    x[q] = word;
  }
}

__device__ __forceinline__ void store16(unsigned char* p, bool vec,
                                        long long avail, const uint32_t x[4]) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(x[0], x[1], x[2], x[3]);
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

template <int W, int RG, typename M>
__global__ void __launch_bounds__(256)
gf_matrix_kernel(const unsigned char* __restrict__ in,
                 unsigned char* __restrict__ out, long long batch,
                 long long nbytes, long long in_bstride,
                 long long in_cstride, long long out_bstride,
                 long long out_cstride, int aligned, int row0,
                 const unsigned char* __restrict__ mask,
                 const __grid_constant__ M m) {
  const long long nvec = (nbytes + 15) / 16;
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (v >= nvec) return;
  const long long off = v * 16;
  const long long avail = nbytes - off;  // bytes of this vector in range
  const bool vec = aligned && avail >= 16;
  const int s = m.s;
  const auto* rows = m.coef + row0 * s;

  for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
    unsigned char* dst = out + b * out_bstride + off;
    if (mask != nullptr && mask[b] == 0) {
      // a dead page: no input read, zeros out (GF linearity: the masked
      // pool's page is zero, so its product is zero)
      const uint32_t zero[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < RG; ++i) store16(dst + i * out_cstride, vec, avail,
                                           zero);
      continue;
    }
    const unsigned char* src = in + b * in_bstride + off;
    uint32_t acc[RG][4];
#pragma unroll
    for (int i = 0; i < RG; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0u;
    }
    for (int j = 0; j < s; ++j) {
      uint32_t c[RG];
      uint32_t any = 0;
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        c[i] = rows[i * s + j];
        any |= c[i];
      }
      if (!any) continue;
      uint32_t x[4];
      load16(src + j * in_cstride, vec, avail, x);
      while (true) {
#pragma unroll
        for (int i = 0; i < RG; ++i) {
          const uint32_t sel = 0u - (c[i] & 1u);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] ^= x[q] & sel;
          c[i] >>= 1;
        }
        any >>= 1;
        if (!any) break;
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = xtime_swar<W>(x[q]);
      }
    }
#pragma unroll
    for (int i = 0; i < RG; ++i) store16(dst + i * out_cstride, vec, avail,
                                         acc[i]);
  }
}

template <int W, int RG, typename M>
static void launch(dim3 grid, cudaStream_t stream, const unsigned char* in,
                   unsigned char* out, long long batch, long long nbytes,
                   long long in_bstride, long long in_cstride,
                   long long out_bstride, long long out_cstride, int aligned,
                   int row0, const unsigned char* mask, const M& m) {
  gf_matrix_kernel<W, RG, M><<<grid, 256, 0, stream>>>(
      in, out, batch, nbytes, in_bstride, in_cstride, out_bstride,
      out_cstride, aligned, row0, mask, m);
}

// Launches ceil(r / GF_ROW_GROUP) kernels on `stream` on the current
// device and returns the first CUDA error.
template <int W, typename M, typename C>
static cudaError_t apply_on_current(const void* in, void* out,
                                    long long batch, long long nbytes,
                                    long long in_bstride,
                                    long long in_cstride,
                                    long long out_bstride,
                                    long long out_cstride, int r, int s,
                                    const C* coef, const void* mask,
                                    void* stream) {
  M m;
  m.r = r;
  m.s = s;
  for (int i = 0; i < r * s; ++i) m.coef[i] = coef[i];
  const auto* src = static_cast<const unsigned char*>(in);
  auto* dst = static_cast<unsigned char*>(out);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
      (reinterpret_cast<uintptr_t>(out) % 16 == 0) && in_bstride % 16 == 0 &&
      in_cstride % 16 == 0 && out_bstride % 16 == 0 && out_cstride % 16 == 0;
  const long long nvec = (nbytes + 15) / 16;
  dim3 grid(static_cast<unsigned>((nvec + 255) / 256),
            static_cast<unsigned>(batch < 65535 ? batch : 65535));
  auto st = static_cast<cudaStream_t>(stream);
  const auto* mk = static_cast<const unsigned char*>(mask);
  for (int row0 = 0; row0 < r; row0 += GF_ROW_GROUP) {
    const int rg = (r - row0 < GF_ROW_GROUP) ? r - row0 : GF_ROW_GROUP;
    const unsigned char* s_in = src;
    unsigned char* d_out = dst + row0 * out_cstride;
    switch (rg) {
      case 1: launch<W, 1>(grid, st, s_in, d_out, batch, nbytes, in_bstride, in_cstride, out_bstride, out_cstride, aligned, row0, mk, m); break;
      case 2: launch<W, 2>(grid, st, s_in, d_out, batch, nbytes, in_bstride, in_cstride, out_bstride, out_cstride, aligned, row0, mk, m); break;
      case 3: launch<W, 3>(grid, st, s_in, d_out, batch, nbytes, in_bstride, in_cstride, out_bstride, out_cstride, aligned, row0, mk, m); break;
      case 4: launch<W, 4>(grid, st, s_in, d_out, batch, nbytes, in_bstride, in_cstride, out_bstride, out_cstride, aligned, row0, mk, m); break;
      case 5: launch<W, 5>(grid, st, s_in, d_out, batch, nbytes, in_bstride, in_cstride, out_bstride, out_cstride, aligned, row0, mk, m); break;
      case 6: launch<W, 6>(grid, st, s_in, d_out, batch, nbytes, in_bstride, in_cstride, out_bstride, out_cstride, aligned, row0, mk, m); break;
      case 7: launch<W, 7>(grid, st, s_in, d_out, batch, nbytes, in_bstride, in_cstride, out_bstride, out_cstride, aligned, row0, mk, m); break;
      default: launch<W, 8>(grid, st, s_in, d_out, batch, nbytes, in_bstride, in_cstride, out_bstride, out_cstride, aligned, row0, mk, m); break;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

extern "C" {

int gf8_max_coef(void) { return GF8_MAX_COEF; }

int gfw_max_coef(void) { return GFW_MAX_COEF; }

int gf8_row_group(void) { return GF_ROW_GROUP; }

const char* gf8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Apply the (r, s) GF(2^8) matrix `coef` (host memory, row-major) to
// `batch` stripes of s input chunks of `nbytes` bytes each; strides are in
// bytes.  Output row i of stripe b lands at out + b * out_bstride + i *
// out_cstride.  `mask` is null (dense) or a device pointer to `batch`
// uint8 page flags (ragged): a stripe whose flag is 0 reads nothing and
// gets zero rows.  Launches ceil(r / GF_ROW_GROUP) kernels on `stream`, which
// belongs to `device`, and returns the first CUDA error (0 when every
// launch was accepted).  The caller's current device is restored before
// returning.
int gf8_matrix_apply(const void* in, void* out, long long batch,
                     long long nbytes, long long in_bstride,
                     long long in_cstride, long long out_bstride,
                     long long out_cstride, int r, int s,
                     const unsigned char* coef, const void* mask, int device,
                     void* stream) {
  if (r < 1 || s < 1 || static_cast<long long>(r) * s > GF8_MAX_COEF ||
      batch < 1 || nbytes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return on_device(device, [&] {
    return apply_on_current<8, Gf8Matrix>(in, out, batch, nbytes,
                                          in_bstride, in_cstride,
                                          out_bstride, out_cstride, r, s,
                                          coef, mask, stream);
  });
}

// The same for w = 16 or 32: `coef` holds uint32 coefficients below 2^w,
// `nbytes` is a whole number of w-bit elements.
int gfw_matrix_apply(const void* in, void* out, long long batch,
                     long long nbytes, long long in_bstride,
                     long long in_cstride, long long out_bstride,
                     long long out_cstride, int r, int s, int w,
                     const uint32_t* coef, int device, void* stream) {
  if (r < 1 || s < 1 || static_cast<long long>(r) * s > GFW_MAX_COEF ||
      batch < 1 || nbytes < 1 || (w != 16 && w != 32) ||
      nbytes % (w / 8) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return on_device(device, [&] {
    if (w == 16) {
      return apply_on_current<16, GfwMatrix>(in, out, batch, nbytes,
                                             in_bstride, in_cstride,
                                             out_bstride, out_cstride, r,
                                             s, coef, nullptr, stream);
    }
    return apply_on_current<32, GfwMatrix>(in, out, batch, nbytes,
                                           in_bstride, in_cstride,
                                           out_bstride, out_cstride, r, s,
                                           coef, nullptr, stream);
  });
}

}  // extern "C"
