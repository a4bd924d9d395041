// GF(2^8) matrix apply as a GF(2) bit-plane product on the tensor cores
// (sm_90a): out = pack(parity(B @ planes(in))).
//
// Replaces the TPU-specific MXU path of the JAX package,
// ceph_tpu/ops/xla_ops.py::apply_matrix_mxu: there an XLA einsum of the
// (8r, 8s) GF(2) bitmatrix B (gf/bitmatrix.py::matrix_to_bitmatrix; block
// (i, j) column x = the bits of M[i][j] * 2^x) against the LSB-first
// bit-planes of the input (row 8j + x = bit x of chunk j), accumulated in
// f32, then & 1 and the bit repack.  ceph_tpu/ops/pallas_gf.py::
// select_matrix_engine picks it for w=8 matrices with MXU_MATRIX_MIN (2048)
// nonzeros or more and no preferred XOR schedule: clay's composites (the
// k=8 m=4 d=11 encode is (256, 512) GF(2^8), a (2048, 4096) bitmatrix).
//
// Design:
//   - One block computes a BM x BN tile of output bit-rows x byte positions
//     of one stripe (grid z walks the stripes).  Per K step of 32 bit-planes
//     (4 input chunks) it stages the bitmatrix tile (BM x 32 int8 0/1, from
//     the wrapper's cached device copy, padded to whole tiles with zeros)
//     and expands the bit-planes of its 4 x BN input bytes into shared
//     memory (spread4: a nibble's 4 bits to 4 bytes in one multiply), never
//     into device memory.  Four warps (2 x 2) each run 2 x 8 mma.sync
//     m16n8k32 s8 x s8 -> s32 per step: exact, since a sum is at most 8s.
//   - Epilogue: & 1 of each accumulator into a BM x BN bit tile in shared
//     memory, then each thread packs 8 bit-rows into output bytes
//     (LSB-first) and stores them; rows past r and bytes past C are not
//     stored.
//   - The bitmatrix is kernel data (one device buffer per matrix, cached by
//     the wrapper), so one build serves every matrix.
//
// What bounds it (H100 SXM): the clay k=8 m=4 d=11 encode at (64, 512,
// 2048) -> (64, 256, 2048) moves 100.7 MB (0.030 ms at 3.35 TB/s), but as
// a dense GEMM it is 2 * 2048 * 4096 * 131072 = 2.20e12 int8 operations,
// 1.11 ms at the dense int8 peak of 1979 TOPS: the tensor-core form sits
// ~37x above the memory bound by construction, and this simple kernel
// (mma.sync, not wgmma; no TMA; no skipping of all-zero tiles, although
// ~95% of the encode composite's coefficients are zero and about three
// quarters of its 64 x 32 bitmatrix tiles) does not reach that peak either.
// The design choice is exactness and simplicity first; the redesign is
// later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "on_device.cuh"

#define MMA_BM 64        // output bit-rows per block (8 output chunks)
#define MMA_BN 128       // byte positions per block
#define MMA_BK 32        // bit-planes per K step (4 input chunks)
#define MMA_ROW 48       // shared-memory row stride in bytes (32 + 16 pad)
#define MMA_THREADS 128  // 4 warps, 2 x 2 over the tile

// Bits 0..3 of `nib` to bytes 0..3 (each 0 or 1): the four shifted copies
// of the nibble do not overlap, so the product is their OR.
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(MMA_THREADS)
gf2_bitplane_mma_kernel(const unsigned char* __restrict__ in,
                        unsigned char* __restrict__ out,
                        const signed char* __restrict__ bm, long long batch,
                        long long nbytes, long long in_bstride,
                        long long in_cstride, long long out_bstride,
                        long long out_cstride, int r, int s, int kpad,
                        int aligned) {
  __shared__ __align__(16) signed char as[MMA_BM * MMA_ROW];
  __shared__ __align__(16) signed char xs[MMA_BN * MMA_ROW];
  __shared__ unsigned char ps[MMA_BM * MMA_BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;     // the fragment's row (A) / column (B) group
  const int q = lane & 3;      // the thread's 4-byte K slice
  const int wm = warp >> 1;    // 32 bit-rows of the tile
  const int wn = warp & 1;     // 64 byte positions of the tile
  const long long n0 = static_cast<long long>(blockIdx.x) * MMA_BN;
  const int m0 = blockIdx.y * MMA_BM;
  const int ksteps = kpad / MMA_BK;

  for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
    const unsigned char* src = in + b * in_bstride;
    int acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[mi][ni][t] = 0;
      }
    }
    for (int kt = 0; kt < ksteps; ++kt) {
      {  // the bitmatrix tile: one 16-byte vector per thread
        const int row = tid >> 1;
        const int half = tid & 1;
        const uint4 v = *reinterpret_cast<const uint4*>(
            bm + static_cast<long long>(m0 + row) * kpad + kt * MMA_BK +
            half * 16);
        *reinterpret_cast<uint4*>(as + row * MMA_ROW + half * 16) = v;
      }
      {  // the bit-planes of 4 input chunks x BN bytes; 4 bytes a thread
        const int jj = tid >> 5;
        const int c = (tid & 31) * 4;
        const int j = kt * 4 + jj;
        const long long col = n0 + c;
        uint32_t word = 0;
        if (j < s && col < nbytes) {
          const unsigned char* p = src + j * in_cstride + col;
          if (aligned && col + 4 <= nbytes) {
            word = *reinterpret_cast<const uint32_t*>(p);
          } else {
            for (int t = 0; t < 4 && col + t < nbytes; ++t)
              word |= static_cast<uint32_t>(p[t]) << (8 * t);
          }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t v = (word >> (8 * t)) & 0xFFu;
          *reinterpret_cast<uint2*>(xs + (c + t) * MMA_ROW + jj * 8) =
              make_uint2(spread4(v & 0xFu), spread4(v >> 4));
        }
      }
      __syncthreads();
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const signed char* ar = as + (wm * 32 + mi * 16 + g) * MMA_ROW;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(ar + q * 4);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * MMA_ROW + q * 4);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(ar + 16 + q * 4);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * MMA_ROW + 16 +
                                                      q * 4);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const signed char* xc = xs + (wn * 64 + ni * 8 + g) * MMA_ROW;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xc + q * 4);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xc + 16 + q * 4);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
      }
      __syncthreads();
    }
    // parity bits: c0/c1 at (row g, cols 2q, 2q+1), c2/c3 at row g + 8
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int rr = wm * 32 + mi * 16 + g;
        const int cc = wn * 64 + ni * 8 + q * 2;
        ps[rr * MMA_BN + cc] = acc[mi][ni][0] & 1;
        ps[rr * MMA_BN + cc + 1] = acc[mi][ni][1] & 1;
        ps[(rr + 8) * MMA_BN + cc] = acc[mi][ni][2] & 1;
        ps[(rr + 8) * MMA_BN + cc + 1] = acc[mi][ni][3] & 1;
      }
    }
    __syncthreads();
    {  // pack: output row m0/8 + i, 8 byte positions a thread
      const int i = tid >> 4;
      const int c0 = (tid & 15) * 8;
      const int orow = m0 / 8 + i;
      if (orow < r) {
        unsigned char* dst = out + b * out_bstride + orow * out_cstride + n0;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int c = c0 + t;
          if (n0 + c < nbytes) {
            unsigned v = 0;
#pragma unroll
            for (int bit = 0; bit < 8; ++bit)
              v |= static_cast<unsigned>(ps[(i * 8 + bit) * MMA_BN + c])
                   << bit;
            dst[c] = static_cast<unsigned char>(v);
          }
        }
      }
    }
    __syncthreads();  // ps is rewritten for the next stripe
  }
}

extern "C" {

int gf2_mma_tile_m(void) { return MMA_BM; }

int gf2_mma_tile_k(void) { return MMA_BK; }

const char* gf2_mma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Apply the GF(2^8) matrix whose bitmatrix `bm` (device memory, int8 0/1,
// row-major (mpad, kpad): the (8r, 8s) bitmatrix zero-padded to whole
// MMA_BM x MMA_BK tiles) describes to `batch` stripes of s input chunks of
// `nbytes` bytes; strides in bytes.  Output row i of stripe b lands at out
// + b * out_bstride + i * out_cstride.  One launch on `stream`, which
// belongs to `device`; returns its CUDA error (0 when accepted).
int gf2_mma_apply(const void* in, void* out, const void* bm, long long batch,
                  long long nbytes, long long in_bstride,
                  long long in_cstride, long long out_bstride,
                  long long out_cstride, int r, int s, int mpad, int kpad,
                  int device, void* stream) {
  if (r < 1 || s < 1 || batch < 1 || nbytes < 1 || mpad < 8 * r ||
      mpad % MMA_BM != 0 || kpad < 8 * s || kpad % MMA_BK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int aligned = (reinterpret_cast<uintptr_t>(in) % 4 == 0) &&
                      in_bstride % 4 == 0 && in_cstride % 4 == 0;
  return on_device(device, [&] {
    dim3 grid(static_cast<unsigned>((nbytes + MMA_BN - 1) / MMA_BN),
              static_cast<unsigned>(mpad / MMA_BM),
              static_cast<unsigned>(batch < 65535 ? batch : 65535));
    gf2_bitplane_mma_kernel<<<grid, MMA_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned char*>(in),
        static_cast<unsigned char*>(out),
        static_cast<const signed char*>(bm), batch, nbytes, in_bstride,
        in_cstride, out_bstride, out_cstride, r, s, kpad, aligned);
    return cudaGetLastError();
  });
}

}  // extern "C"
