// RMSNorm for Hopper (sm_90a), bound through ctypes.
//
// Replaces repro/kernels/rmsnorm.py::_kernel (Pallas; its wrapper is
// ops.rmsnorm) and keeps its order of rounding:
//   out = (x * rsqrt(mean(x^2) + eps)) * fp32(scale)   from the fp32 x, cast once
// The scale multiplies in fp32 before the single cast (rmsnorm.py:39-42).
// The model's own layers.rms_norm casts first and scales after; that is a
// different function and this kernel does not follow it.
//
// Design.  The row-per-block structure of fused_add_rmsnorm.cu: a block
// normalises `rows_per_block` rows, one after another; each of its threads
// keeps up to kVals elements of the row's fp32 x in registers, so x is read
// once and out written once.  The sum of squares is reduced within warps by
// shuffles and across warps through shared memory.  The wrapper picks the
// block width so that kVals * threads covers d (d <= 8192).  Rows are
// independent and a ragged row count needs no second launch: the last block
// stops at `rows` (the reference splits its ragged tail into a second call so
// as not to normalise padding; here there is no padding to begin with).
//
// Bound.  There are no products and no reuse across rows: the kernel is
// bound by bytes.  At 4096 x 960 bf16 it reads x and writes out, 15.7 MB:
// about 4.7 us at 3.35 TB/s.  Vectorised 16-byte loads and several rows per
// warp are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVals = 8;  // row elements each thread holds

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

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red is free: every thread has read the previous row's
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < n_warps; ++i) t += red[i];  // same order in every thread
  return t;
}

template <typename T>
__global__ void rmsnorm(const T* __restrict__ x, const T* __restrict__ scale,
                        T* __restrict__ out, int rows, int d,
                        int rows_per_block, float eps) {
  __shared__ float red[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int first = blockIdx.x * rows_per_block;
  const int last = min(rows, first + rows_per_block);
  for (int row = first; row < last; ++row) {
    const long long base = (long long)row * d;
    float xv[kVals];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kVals; ++i) {
      const int c = tid + i * nt;
      xv[i] = 0.f;
      if (c < d) {
        xv[i] = to_f32(x[base + c]);
        ss += xv[i] * xv[i];
      }
    }
    const float inv = rsqrtf(block_sum(ss, red) / (float)d + eps);
#pragma unroll
    for (int i = 0; i < kVals; ++i) {
      const int c = tid + i * nt;
      if (c < d) out[base + c] = from_f32<T>((xv[i] * inv) * to_f32(scale[c]));
    }
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int rows, int d,
           int threads, int rows_per_block, float eps, cudaStream_t stream) {
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  rmsnorm<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(out), rows, d, rows_per_block, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code if the launch was refused, or a
// negative code for an argument the kernel does not take: -1 dtype,
// -2 block width (a multiple of 32, at most 1024, covering d).
// dtype: 0 float32, 1 bfloat16.
int repro_rmsnorm(const void* x, const void* scale, void* out, int dtype,
                  int device, int rows, int d, int threads,
                  int rows_per_block, float eps, void* stream) {
  if (threads % 32 != 0 || threads > 1024 || threads * kVals < d ||
      rows_per_block < 1)
    return -2;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, scale, out, rows, d, threads, rows_per_block, eps, st);
    case 1: return launch<__nv_bfloat16>(x, scale, out, rows, d, threads, rows_per_block, eps, st);
    default: return -1;
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
