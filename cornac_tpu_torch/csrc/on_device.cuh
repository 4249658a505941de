// Runs the enclosing scope on a given device, restoring the caller's
// current device after: the wrappers pass the tensors' device index with
// every call, so the host sets no device context per launch.
#pragma once

#include <cuda_runtime.h>

struct OnDevice {
  int prev = -1;
  bool changed = false;
  cudaError_t err;
  explicit OnDevice(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
      changed = err == cudaSuccess;
    }
  }
  ~OnDevice() {
    if (changed) cudaSetDevice(prev);
  }
};
