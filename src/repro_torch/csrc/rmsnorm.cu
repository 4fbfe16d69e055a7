// RMSNorm for Hopper (sm_90a), bound through ctypes.
//
// Replaces repro/kernels/rmsnorm.py::_kernel (Pallas; its wrapper is
// ops.rmsnorm) and keeps its order of rounding:
//   out = (x * rsqrt(mean(x^2) + eps)) * fp32(scale)   from the fp32 x, cast once
// The scale multiplies in fp32 before the single cast (rmsnorm.py:39-42).
// The model's own layers.rms_norm casts first and scales after; that is a
// different function and this kernel does not follow it.
//
// Design.  A warp owns a row: each lane holds VALS 16-byte values of it (8
// bf16 or 4 fp32 elements each) in registers, neighbouring lanes on
// neighbouring 16-byte addresses, so x is read once and out written once.
// The sum of squares is reduced by __shfl_xor_sync alone: no shared memory
// and no barrier.  A block of kWarps warps takes `rows_per_block` rows
// (default: one a warp) and its warps walk them, kWarps / wpr rows a step.
// Each warp loads the scale row into registers once, not once a row.
// VALS (1, 2, 4 or 8) is picked by the wrapper from d: at d = 960 bf16 a
// row is 120 values, 4 a lane with the last ones masked.  One warp holds a
// row of up to 4 values a lane (128 values: 1024 bf16, 512 fp32 elements);
// a wider row takes `wpr` = 2, 4 or 8 warps of the block, whose partial
// sums meet in one shared-memory step (double-buffered, so one barrier a
// row), and fp32 rows past 4096 take 8 values a lane in 8 warps.  The
// threshold is ptxas's: the 16-byte instantiations take 75 (bf16) and 62
// (fp32) registers at 4 values a lane, three blocks of 256 threads an SM,
// but 127 and 102 at 8, two blocks.  A row that cannot take 16-byte loads
// (d not a multiple of the vector, or a pointer off a 16-byte
// boundary) runs the VEC = false instantiation: the same registers and
// reductions, one element a load, lanes on neighbouring elements.
//
// Bound.  There are no products and no reuse across rows: the kernel is
// bound by bytes.  At 4096 x 960 bf16 it reads x and writes out, 15.7 MB:
// about 4.7 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;     // warps a block
constexpr int kMaxVals = 8;   // 16-byte values a lane holds

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

// Element e of value v of this lane: with VEC, value v is the 16-byte
// vector (g * VALS + v) * 32 + lane of the row; without, its elements are
// 32 apart so that a load instruction covers 32 neighbouring elements.
template <typename T, int VALS, bool VEC>
__device__ __forceinline__ int column(int g, int v, int e, int lane) {
  constexpr int E = 16 / sizeof(T);
  return VEC ? ((g * VALS + v) * 32 + lane) * E + e
             : ((g * VALS + v) * E + e) * 32 + lane;
}

template <typename T, int VALS, bool VEC>
__device__ __forceinline__ void load_row(uint4 (&dst)[VALS], const T* src,
                                         int d, int g, int lane) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll
  for (int v = 0; v < VALS; ++v) {
    if (VEC) {
      const int c = column<T, VALS, VEC>(g, v, 0, lane);
      dst[v] = c < d ? *reinterpret_cast<const uint4*>(src + c)
                     : make_uint4(0u, 0u, 0u, 0u);
    } else {
      T* de = reinterpret_cast<T*>(&dst[v]);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = column<T, VALS, VEC>(g, v, e, lane);
        de[e] = c < d ? src[c] : from_f32<T>(0.f);
      }
    }
  }
}

template <typename T, int VALS, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm(const T* __restrict__ x, const T* __restrict__ scale,
        T* __restrict__ out, int rows, int d, int wpr, int rows_per_block,
        float eps) {
  constexpr int E = 16 / sizeof(T);
  __shared__ float red[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = warp / wpr, g = warp - group * wpr;  // g: part of the row
  const int stride = kWarps / wpr;                       // rows a step
  uint4 sc[VALS];
  load_row<T, VALS, VEC>(sc, scale, d, g, lane);
  const int first = blockIdx.x * rows_per_block;
  const int last = min(rows, first + rows_per_block);
  int parity = 0;
  // every warp takes the same number of steps, so the barrier is uniform
  for (int r0 = first; r0 < last; r0 += stride, parity ^= 1) {
    const int row = r0 + group;
    const bool live = row < last;
    const T* xr = x + (long long)row * d;
    uint4 xv[VALS];
    float ss = 0.f;
    if (live) {
      load_row<T, VALS, VEC>(xv, xr, d, g, lane);
#pragma unroll
      for (int v = 0; v < VALS; ++v) {
        const T* xe = reinterpret_cast<const T*>(&xv[v]);
#pragma unroll
        for (int e = 0; e < E; ++e) ss = fmaf(to_f32(xe[e]), to_f32(xe[e]), ss);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (wpr > 1) {  // the row's warps meet once; same order in every thread
      if (lane == 0) red[parity][warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int k = 0; k < wpr; ++k) ss += red[parity][group * wpr + k];
    }
    if (!live) continue;
    const float inv = rsqrtf(ss / (float)d + eps);
    T* orow = out + (long long)row * d;
#pragma unroll
    for (int v = 0; v < VALS; ++v) {
      const T* xe = reinterpret_cast<const T*>(&xv[v]);
      const T* se = reinterpret_cast<const T*>(&sc[v]);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int e = 0; e < E; ++e)
        oe[e] = from_f32<T>((to_f32(xe[e]) * inv) * to_f32(se[e]));
      if (VEC) {
        const int c = column<T, VALS, VEC>(g, v, 0, lane);
        if (c < d) *reinterpret_cast<uint4*>(orow + c) = o;
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int c = column<T, VALS, VEC>(g, v, e, lane);
          if (c < d) orow[c] = oe[e];
        }
      }
    }
  }
}

template <typename T, int VALS, bool VEC>
int launch_as(const void* x, const void* scale, void* out, int rows, int d,
              int wpr, int rows_per_block, float eps, cudaStream_t stream) {
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  rmsnorm<T, VALS, VEC><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(out), rows, d, wpr, rows_per_block, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_vals(int vals, const void* x, const void* scale, void* out,
                int rows, int d, int wpr, int rpb, float eps, cudaStream_t st) {
  switch (vals) {
    case 1: return launch_as<T, 1, VEC>(x, scale, out, rows, d, wpr, rpb, eps, st);
    case 2: return launch_as<T, 2, VEC>(x, scale, out, rows, d, wpr, rpb, eps, st);
    case 4: return launch_as<T, 4, VEC>(x, scale, out, rows, d, wpr, rpb, eps, st);
    case 8: return launch_as<T, 8, VEC>(x, scale, out, rows, d, wpr, rpb, eps, st);
    default: return -2;
  }
}

template <typename T>
int launch(int vector, int vals, const void* x, const void* scale, void* out,
           int rows, int d, int wpr, int rpb, float eps, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  if ((long long)32 * vals * wpr * E < d) return -2;  // the plan must cover d
  if (vector) {
    const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                           reinterpret_cast<uintptr_t>(scale) |
                           reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    if (!aligned || d % E != 0) return -3;
    return launch_vals<T, true>(vals, x, scale, out, rows, d, wpr, rpb, eps, st);
  }
  return launch_vals<T, false>(vals, x, scale, out, rows, d, wpr, rpb, eps, st);
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code if the launch was refused, or a
// negative code for an argument the kernel does not take: -1 dtype, -2 plan
// (vals and wpr each 1, 2, 4 or 8 covering d; rows_per_block >= 1), -3
// 16-byte loads asked for on a row that cannot take them.
// dtype: 0 float32, 1 bfloat16.
int repro_rmsnorm(const void* x, const void* scale, void* out, int dtype,
                  int device, int rows, int d, int vector, int vals, int wpr,
                  int rows_per_block, float eps, void* stream) {
  if (wpr < 1 || wpr > kWarps || (wpr & (wpr - 1)) || vals < 1 ||
      vals > kMaxVals || rows_per_block < 1 || d < 1 || rows < 1)
    return -2;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(vector, vals, x, scale, out, rows, d, wpr, rows_per_block, eps, st);
    case 1: return launch<__nv_bfloat16>(vector, vals, x, scale, out, rows, d, wpr, rows_per_block, eps, st);
    default: return -1;
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
