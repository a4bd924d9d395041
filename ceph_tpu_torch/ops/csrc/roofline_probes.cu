// The two roofline probe kernels (sm_90a): an identity copy and an s-way
// XOR fold of a (b, s, R, 128) uint32 slab.
//
// Replaces the two Pallas kernels of the JAX package's roofline tool
// (tools/roofline.py): _pallas_copy_fn (the 2-stream probe: read the slab,
// write it back) and _pallas_fold_fn (the pure-read probe: XOR-fold each
// stripe's s chunks into one, (b, s, R, 128) -> (b, 1, R, 128)).  There the
// block geometry mirrors the TPU GF(2^8) kernel's (_row_tile8); that is a
// fact of the TPU's tiling and is not copied: here each thread moves one
// 16-byte vector of the output, neighbouring threads on neighbouring
// addresses, with streaming loads and stores (__ldcs / __stcs: read once,
// not kept in L1), and the grid has one block of PROBE_THREADS threads per
// PROBE_THREADS vectors (the last block masks the tail).  On an H100 a
// grid capped at 8 blocks per SM over a grid-stride loop, four loads in
// flight per thread, whole waves of contiguous block ranges, and a TMA
// bulk ring through shared memory all ran behind torch's copy_ on the same
// slab; this form keeps up with it.
//
// What bounds them: bytes.  The copy moves 2x the slab, the fold (1 + 1/s)x;
// each does at most one XOR per word read, far below the INT32 rate, so the
// time at HBM's 3.35 TB/s is their floor, and the copy's measured rate is
// the card's measured streaming ceiling (ceph_tpu_torch/tools/roofline.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "on_device.cuh"

#define PROBE_THREADS 512

__global__ void __launch_bounds__(PROBE_THREADS)
probe_copy_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                  long long nvec) {
  const long long v =
      static_cast<long long>(blockIdx.x) * PROBE_THREADS + threadIdx.x;
  if (v < nvec) __stcs(out + v, __ldcs(in + v));
}

// in: (b, s, lvec) 16-byte vectors, contiguous; out: (b, lvec)
__global__ void __launch_bounds__(PROBE_THREADS)
probe_fold_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                  long long b, int s, long long lvec) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * PROBE_THREADS + threadIdx.x;
  if (idx >= b * lvec) return;
  const long long bb = idx / lvec;
  const long long v = idx - bb * lvec;
  const uint4* p = in + bb * s * lvec + v;
  uint4 acc = __ldcs(p);
  for (int j = 1; j < s; ++j) {
    const uint4 x = __ldcs(p + j * lvec);
    acc.x ^= x.x;
    acc.y ^= x.y;
    acc.z ^= x.z;
    acc.w ^= x.w;
  }
  __stcs(out + idx, acc);
}

// One block per PROBE_THREADS of `n` output vectors; 0 when that exceeds
// a grid.
static unsigned probe_blocks(long long n) {
  const long long blocks = (n + PROBE_THREADS - 1) / PROBE_THREADS;
  return blocks <= 0x7FFFFFFFLL ? static_cast<unsigned>(blocks) : 0u;
}

extern "C" {

const char* probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Copy `nvec` 16-byte vectors from `in` to `out` (device memory, 16-byte
// aligned).  One launch on `stream`; returns its CUDA error.
int probe_copy(const void* in, void* out, long long nvec, int device,
               void* stream) {
  const unsigned blocks = probe_blocks(nvec);
  if (nvec < 1 || blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    probe_copy_kernel<<<blocks, PROBE_THREADS, 0,
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
  const unsigned blocks = probe_blocks(b * lvec);
  if (b < 1 || s < 1 || lvec < 1 || blocks == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return on_device(device, [&] {
    probe_fold_kernel<<<blocks, PROBE_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), b, s, lvec);
    return cudaGetLastError();
  });
}

}  // extern "C"
