// Elementwise add for Hopper (sm_90a), bound through ctypes.
//
// Replaces benchmarks/kernels_bench.py::_pallas_add (Pallas): y = x + r in the
// inputs' dtype, the materialise-y pass of the unfused add-then-RMSNorm
// pipeline that the fused kernel is measured against.  Each element is summed
// in fp32 and rounded once to the dtype, as torch's and XLA's bf16 adds do.
//
// Design.  A grid-stride loop over 16-byte vectors (4 float32 or 8 bfloat16
// elements a thread a step), so each warp moves 512 contiguous bytes per
// load instruction; the elements past the last whole vector, or every element
// when a pointer is not 16-byte aligned, go through a scalar tail loop.
//
// Bound.  No reuse and one add per element: bound by bytes.  At 4096 x 960
// bf16 it reads x and r and writes y, 23.6 MB: about 7 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
add(const T* __restrict__ x, const T* __restrict__ r, T* __restrict__ y,
    long long n, long long n_vec) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte vector
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* rv = reinterpret_cast<const uint4*>(r);
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (long long i = first; i < n_vec; i += stride) {
    const uint4 a = xv[i], b = rv[i];
    uint4 c;
    const T* ae = reinterpret_cast<const T*>(&a);
    const T* be = reinterpret_cast<const T*>(&b);
    T* ce = reinterpret_cast<T*>(&c);
#pragma unroll
    for (int e = 0; e < kVec; ++e) ce[e] = from_f32<T>(to_f32(ae[e]) + to_f32(be[e]));
    yv[i] = c;
  }
  for (long long i = n_vec * kVec + first; i < n; i += stride)  // masked tail
    y[i] = from_f32<T>(to_f32(x[i]) + to_f32(r[i]));
}

template <typename T>
int launch(const void* x, const void* r, void* y, long long n, int sms,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(r) |
                         reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const long long n_vec = aligned ? n / kVec : 0;
  const long long work = n_vec > 0 ? n_vec : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;  // enough resident blocks to fill every SM
  if (blocks > cap) blocks = cap;
  add<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<T*>(y),
      n, n_vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code if the launch was refused, or -1
// for a dtype the kernel does not take (0 float32, 1 bfloat16).  n >= 1.
int repro_add(const void* x, const void* r, void* y, int dtype, int device,
              long long n, void* stream) {
  if (n < 1) return -2;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, r, y, n, sms, st);
    case 1: return launch<__nv_bfloat16>(x, r, y, n, sms, st);
    default: return -1;
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
