// The two roofline probe kernels (sm_90a): an identity copy and an s-way
// XOR fold of a (b, s, R, 128) uint32 slab.
//
// Replaces the two Pallas kernels of the JAX package's roofline tool
// (tools/roofline.py): _pallas_copy_fn (the 2-stream probe: read the slab,
// write it back) and _pallas_fold_fn (the pure-read probe: XOR-fold each
// stripe's s chunks into one, (b, s, R, 128) -> (b, 1, R, 128)).  There the
// block geometry mirrors the TPU GF(2^8) kernel's (_row_tile8); that is a
// fact of the TPU's tiling and is not copied: here each thread moves
// 16-byte vectors, neighbouring threads on neighbouring addresses, over a
// grid-stride loop, which is what a streaming kernel on this card needs.
//
// What bounds them: bytes.  The copy moves 2x the slab, the fold (1 + 1/s)x;
// each does at most one XOR per word read, far below the INT32 rate, so the
// time at HBM's 3.35 TB/s is their floor, and the copy's measured rate is
// the card's measured streaming ceiling (ceph_tpu_torch/tools/roofline.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "on_device.cuh"

#define PROBE_THREADS 256

__global__ void __launch_bounds__(PROBE_THREADS)
probe_copy_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                  long long nvec) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < nvec; v += step) {
    out[v] = in[v];
  }
}

// in: (b, s, lvec) 16-byte vectors, contiguous; out: (b, lvec)
__global__ void __launch_bounds__(PROBE_THREADS)
probe_fold_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                  long long b, int s, long long lvec) {
  const long long n = b * lvec;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       idx < n; idx += step) {
    const long long bb = idx / lvec;
    const long long v = idx - bb * lvec;
    const uint4* p = in + bb * s * lvec + v;
    uint4 acc = p[0];
    for (int j = 1; j < s; ++j) {
      const uint4 x = p[j * lvec];
      acc.x ^= x.x;
      acc.y ^= x.y;
      acc.z ^= x.z;
      acc.w ^= x.w;
    }
    out[idx] = acc;
  }
}

static unsigned probe_grid(long long work) {
  // enough blocks to cover the work, at most 8 per SM of a 132-SM card;
  // the grid-stride loop takes the rest
  const long long blocks = (work + PROBE_THREADS - 1) / PROBE_THREADS;
  return static_cast<unsigned>(blocks < 132 * 8 ? blocks : 132 * 8);
}

extern "C" {

const char* probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Copy `nvec` 16-byte vectors from `in` to `out` (device memory, 16-byte
// aligned).  One launch on `stream`; returns its CUDA error.
int probe_copy(const void* in, void* out, long long nvec, int device,
               void* stream) {
  if (nvec < 1) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    probe_copy_kernel<<<probe_grid(nvec), PROBE_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), nvec);
    return cudaGetLastError();
  });
}

// XOR-fold `b` stripes of `s` rows of `lvec` 16-byte vectors each (in:
// contiguous (b, s, lvec)) into out (b, lvec).  One launch; returns its
// CUDA error.
int probe_fold(const void* in, void* out, long long b, int s, long long lvec,
               int device, void* stream) {
  if (b < 1 || s < 1 || lvec < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return on_device(device, [&] {
    probe_fold_kernel<<<probe_grid(b * lvec), PROBE_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), b, s, lvec);
    return cudaGetLastError();
  });
}

}  // extern "C"
