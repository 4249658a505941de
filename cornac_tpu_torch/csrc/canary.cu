// The build canary: o[i] = 2 * x[i], for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarks/pallas_on_silicon.py::copy_kernel,
// the Mosaic compile probe that doubles one (128, 128) float32 block. Here
// it proves the route every kernel of the port takes: nvcc -> a shared
// library with a plain C interface -> ctypes -> a launch on PyTorch's
// current stream -> the launch error returned to the wrapper.
//
// What bounds it on an H100: at the probe's (128, 128) it reads and writes
// 64 KiB each, 39 ns of traffic at 3.35 TB/s, so a call costs what a
// launch costs. One thread per element, no shared memory: the answer is
// exact (a multiply by two only moves the exponent), so the wrapper holds
// it to x * 2 bit for bit.

#include <cuda_runtime.h>

#include "on_device.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void scale2_kernel(const float* __restrict__ x, float* __restrict__ o, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) o[i] = 2.0f * x[i];
}

}  // namespace

extern "C" {

// Launches on `stream` of `device`: o[i] = 2 * x[i] for 0 <= i < n, x and o
// float32 on that device. Returns the launch's cudaError_t (0 on success).
int cornac_scale2(int device, const float* x, float* o, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  scale2_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(x, o, n);
  return (int)cudaGetLastError();
}

const char* cornac_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
