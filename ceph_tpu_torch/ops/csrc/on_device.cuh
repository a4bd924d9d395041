// Shared by the kernel sources of this directory (ops/_build.py hashes
// every *.cuh here into each library's build key).
#pragma once

#include <cuda_runtime.h>

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
