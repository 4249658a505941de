// The build canary: o[i] = 2 * x[i], for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarks/pallas_on_silicon.py::copy_kernel,
// the Mosaic compile probe that doubles one (128, 128) float32 block. Here
// it proves the route every kernel of the port takes: nvcc -> a shared
// library with a plain C interface -> ctypes -> a launch on PyTorch's
// current stream -> the launch error returned to the wrapper.
//
// What bounds it on an H100: at the probe's (128, 128) it reads and writes
// 64 KiB each, 39 ns of traffic at 3.35 TB/s, so a call costs what a launch
// and the host's work around it cost. The design does the least the work
// needs: one 16-byte load and store a thread (float4) and a grid sized to
// the work, 16 blocks of 256 threads at (128, 128); the last n % 4 elements
// go to the threads after the vectors, one each. A pointer that is not
// 16-byte aligned (a view at an odd offset) takes the scalar kernel, one
// thread an element. No shared memory: the answer is exact (a multiply by
// two only moves the exponent), so the wrapper holds it to x * 2 bit for
// bit. The arguments come in one array (ops/native.py::PackedCall), so the
// host marshals one pointer, not five values.

#include <cuda_runtime.h>

#include <cstdint>

#include "on_device.cuh"

namespace {

constexpr int kThreads = 256;

// Threads [0, n4) take one float4 each; threads [n4, n4 + n % 4) one of
// the last elements.
__global__ void scale2_vec4_kernel(const float4* __restrict__ x, float4* __restrict__ o,
                                   long long n4, int tail) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n4) {
    const float4 v = x[i];
    o[i] = make_float4(2.0f * v.x, 2.0f * v.y, 2.0f * v.z, 2.0f * v.w);
  } else if (i < n4 + tail) {
    const long long j = 4 * n4 + (i - n4);
    reinterpret_cast<float*>(o)[j] = 2.0f * reinterpret_cast<const float*>(x)[j];
  }
}

__global__ void scale2_kernel(const float* __restrict__ x, float* __restrict__ o, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) o[i] = 2.0f * x[i];
}

}  // namespace

extern "C" {

// args: {device, x, o, n, stream}, each as an int64 (the pointers' and the
// stream's addresses). Launches on `stream` of `device`: o[i] = 2 * x[i]
// for 0 <= i < n, x and o float32 on that device. Returns the launch's
// cudaError_t (0 on success).
int cornac_scale2(const int64_t* args) {
  const int device = (int)args[0];
  const float* x = reinterpret_cast<const float*>(args[1]);
  float* o = reinterpret_cast<float*>(args[2]);
  const long long n = args[3];
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(args[4]);
  if (n <= 0) return 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  const long long threads = aligned ? n / 4 + n % 4 : n;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  if (aligned) {
    scale2_vec4_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(o), n / 4, (int)(n % 4));
  } else {
    scale2_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(x, o, n);
  }
  return (int)cudaGetLastError();
}

const char* cornac_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
