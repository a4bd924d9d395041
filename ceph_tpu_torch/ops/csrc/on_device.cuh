// Shared by the kernel sources of this directory (ops/_build.py hashes
// every *.cuh here into each library's build key).
#pragma once

#include <atomic>

#include <cuda_runtime.h>

// Devices whose launch geometry the sources below cache per device.
#define ON_DEVICE_MAX 64

// Run `body` with `device` current, restoring the caller's current device
// afterwards; returns the first CUDA error.
template <typename F>
static int on_device(int device, F body) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = body();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

// One wave of `kernel` launched with `threads` threads and `smem` bytes of
// dynamic shared memory on `device` (the current device): the card's SMs
// times the kernel's resident blocks per SM, into *wave.  The answer is
// cached in cache[device] (0: not read yet), since the two queries cost a
// launch tens of microseconds of host time; a device past ON_DEVICE_MAX
// is asked every time.  Returns the first CUDA error.
template <typename K>
static cudaError_t wave_of(K kernel, int threads, size_t smem, int device,
                           std::atomic<int>* cache, long long* wave) {
  const bool cached = device >= 0 && device < ON_DEVICE_MAX;
  int known = cached ? cache[device].load(std::memory_order_relaxed) : 0;
  if (known == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    known = sms * per_sm;
    if (cached) cache[device].store(known, std::memory_order_relaxed);
  }
  *wave = known;
  return cudaSuccess;
}
