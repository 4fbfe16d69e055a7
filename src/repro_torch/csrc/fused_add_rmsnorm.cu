// Fused residual-add + RMSNorm for Hopper (sm_90a), bound through ctypes.
//
// Replaces repro/kernels/fused.py::_kernel (Pallas; its wrapper is
// ops.fused_add_rmsnorm) and keeps its order of rounding:
//   y = fp32(x) + fp32(res)             stored once in the input dtype
//   h = (y * rsqrt(mean(y^2) + eps)) * fp32(scale)   from the fp32 y, cast once
// and returns both.  Rows are independent; a ragged row count needs no
// second call, the last block just stops at `rows`.
//
// Design.  One block handles `rows_per_block` rows, one row at a time;
// each of its threads keeps up to kVals elements of the row's fp32 y in
// registers, so x and res are read once and y and h written once.  The
// sum of squares is reduced within warps by shuffles and across warps
// through shared memory.  The wrapper picks the block width so that
// kVals * threads covers d (d <= 8192).
//
// Bound.  There are no products and no reuse across rows: the kernel is
// bound by bytes.  At the serving shape (8 x 512 rows, d = 960, bf16) it
// reads x and res and writes h and y, ~31.5 MB: 9.4 us at 3.35 TB/s.
// Vectorised 16-byte loads and several rows per warp are later work.

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
__global__ void fused_add_rmsnorm(const T* __restrict__ x,
                                  const T* __restrict__ res,
                                  const T* __restrict__ scale,
                                  T* __restrict__ h_out, T* __restrict__ y_out,
                                  int rows, int d, int rows_per_block,
                                  float eps) {
  __shared__ float red[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int first = blockIdx.x * rows_per_block;
  const int last = min(rows, first + rows_per_block);
  for (int row = first; row < last; ++row) {
    const long long base = (long long)row * d;
    float y[kVals];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kVals; ++i) {
      const int c = tid + i * nt;
      y[i] = 0.f;
      if (c < d) {
        y[i] = to_f32(x[base + c]) + to_f32(res[base + c]);
        y_out[base + c] = from_f32<T>(y[i]);
        ss += y[i] * y[i];
      }
    }
    const float inv = rsqrtf(block_sum(ss, red) / (float)d + eps);
#pragma unroll
    for (int i = 0; i < kVals; ++i) {
      const int c = tid + i * nt;
      if (c < d) h_out[base + c] = from_f32<T>((y[i] * inv) * to_f32(scale[c]));
    }
  }
}

template <typename T>
int launch(const void* x, const void* res, const void* scale, void* h,
           void* y, int rows, int d, int threads, int rows_per_block,
           float eps, cudaStream_t stream) {
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  fused_add_rmsnorm<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const T*>(scale), static_cast<T*>(h), static_cast<T*>(y),
      rows, d, rows_per_block, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code if the launch was refused, or a
// negative code for an argument the kernel does not take: -1 dtype,
// -2 block width (a multiple of 32, at most 1024, covering d).
// dtype: 0 float32, 1 bfloat16.
int repro_fused_add_rmsnorm(const void* x, const void* res, const void* scale,
                            void* h, void* y, int dtype, int device, int rows,
                            int d, int threads, int rows_per_block, float eps,
                            void* stream) {
  if (threads % 32 != 0 || threads > 1024 || threads * kVals < d ||
      rows_per_block < 1)
    return -2;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, res, scale, h, y, rows, d, threads, rows_per_block, eps, st);
    case 1: return launch<__nv_bfloat16>(x, res, scale, h, y, rows, d, threads, rows_per_block, eps, st);
    default: return -1;
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
