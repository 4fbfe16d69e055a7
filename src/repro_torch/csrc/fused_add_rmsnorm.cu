// Fused residual-add + RMSNorm for Hopper (sm_90a), bound through ctypes.
//
// Replaces repro/kernels/fused.py::_kernel (Pallas; its wrapper is
// ops.fused_add_rmsnorm) and keeps its order of rounding:
//   y = fp32(x) + fp32(res)             stored once in the input dtype
//   h = (y * rsqrt(mean(y^2) + eps)) * fp32(scale)   from the fp32 y, cast once
// and returns both.  Rows are independent; a ragged row count needs no
// second call, the last block just stops at `rows`.
//
// Design (csrc/rmsnorm.cu's, with a second input and a second output).  A
// warp owns a row: each lane holds VALS 16-byte values of x and of res (8
// bf16 or 4 fp32 elements each) as raw registers, neighbouring lanes on
// neighbouring 16-byte addresses, so x and res are read once and y and h
// written once, each as one 16-byte access a value.  The lane adds each
// element in fp32, writes y back packed, and sums y^2; the sum is reduced
// by __shfl_xor_sync alone, with no shared memory and no barrier.  h is
// then taken from fp32(x) + fp32(res) recomputed from the raw registers: an
// fp32 add is deterministic, so this is the y the sum saw, and it holds
// two raw vectors where an fp32 copy of bf16 y would take as many.  In
// fp32 the stored y is that y exactly, so it replaces x and res dies early.
// A block of kWarps warps takes `rows_per_block` rows (default: one a warp)
// and its warps walk them; each warp loads the scale row into registers
// once, not once a row.  A row wider than one warp holds takes `wpr` = 2,
// 4 or 8 warps of the block, whose partial sums meet in one shared-memory
// step (double-buffered, so one barrier a row).  A row that cannot take
// 16-byte accesses (d not a multiple of the vector, or x, res or scale off
// a 16-byte boundary) runs the VEC = false instantiation: the same
// registers and reductions, one element an access, lanes on neighbouring
// elements.
//
// Registers.  x, res and the scale make three rows of raw values a lane
// where RMSNorm holds two, so one warp holds fewer values of a row here:
// the wrapper (kernels/fused.py, WARP_VALS) gives a warp at most 2 values
// a lane before a row takes more warps.  ptxas put the 16-byte bf16
// instantiation at 98 registers at 4 values a lane (two blocks of 256
// threads an SM) and 64 at 2 (four), and bench/fused_plans.py times the
// two level at d = 960, so the one that leaves the SM room wins.  The
// 8-values-a-lane bf16 instantiations (217 and 244 registers) are built
// but no bf16 row up to 8192 reaches them; fp32 rows past 4096 run 8
// values a lane at 100.  No instantiation spills; chip_smoke.py's [build]
// lists each one's registers and spills.
//
// Bound.  There are no products and no reuse across rows: the kernel is
// bound by bytes.  At 4096 x 960 bf16 it reads x and res and writes h and
// y, 31.5 MB: 9.4 us at 3.35 TB/s.

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
// 32 apart so that an access instruction covers 32 neighbouring elements.
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
__device__ __forceinline__ void store_value(T* dst, const uint4& val, int d,
                                            int g, int v, int lane) {
  constexpr int E = 16 / sizeof(T);
  if (VEC) {
    const int c = column<T, VALS, VEC>(g, v, 0, lane);
    if (c < d) *reinterpret_cast<uint4*>(dst + c) = val;
  } else {
    const T* ve = reinterpret_cast<const T*>(&val);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = column<T, VALS, VEC>(g, v, e, lane);
      if (c < d) dst[c] = ve[e];
    }
  }
}

template <typename T, int VALS, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
fused_add_rmsnorm(const T* __restrict__ x, const T* __restrict__ res,
                  const T* __restrict__ scale, T* __restrict__ h_out,
                  T* __restrict__ y_out, int rows, int d, int wpr,
                  int rows_per_block, float eps) {
  constexpr int E = 16 / sizeof(T);
  constexpr bool kKeepY = sizeof(T) == sizeof(float);  // stored y is exact
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
    const long long base = (long long)row * d;
    uint4 xv[VALS], rv[VALS];
    float ss = 0.f;
    if (live) {
      load_row<T, VALS, VEC>(xv, x + base, d, g, lane);
      load_row<T, VALS, VEC>(rv, res + base, d, g, lane);
#pragma unroll
      for (int v = 0; v < VALS; ++v) {
        const T* xe = reinterpret_cast<const T*>(&xv[v]);
        const T* re = reinterpret_cast<const T*>(&rv[v]);
        uint4 yo;
        T* ye = reinterpret_cast<T*>(&yo);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float yf = to_f32(xe[e]) + to_f32(re[e]);
          ye[e] = from_f32<T>(yf);
          ss = fmaf(yf, yf, ss);
        }
        store_value<T, VALS, VEC>(y_out + base, yo, d, g, v, lane);
        if (kKeepY) xv[v] = yo;
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
#pragma unroll
    for (int v = 0; v < VALS; ++v) {
      const T* xe = reinterpret_cast<const T*>(&xv[v]);
      const T* re = reinterpret_cast<const T*>(&rv[v]);
      const T* se = reinterpret_cast<const T*>(&sc[v]);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float yf = kKeepY ? to_f32(xe[e])
                                : to_f32(xe[e]) + to_f32(re[e]);
        oe[e] = from_f32<T>((yf * inv) * to_f32(se[e]));
      }
      store_value<T, VALS, VEC>(h_out + base, o, d, g, v, lane);
    }
  }
}

struct Args {
  const void *x, *res, *scale;
  void *h, *y;
  int rows, d, wpr, rows_per_block;
  float eps;
  cudaStream_t stream;
};

template <typename T, int VALS, bool VEC>
int launch_as(const Args& a) {
  const int blocks = (a.rows + a.rows_per_block - 1) / a.rows_per_block;
  fused_add_rmsnorm<T, VALS, VEC><<<blocks, kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.res),
      static_cast<const T*>(a.scale), static_cast<T*>(a.h),
      static_cast<T*>(a.y), a.rows, a.d, a.wpr, a.rows_per_block, a.eps);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_vals(int vals, const Args& a) {
  switch (vals) {
    case 1: return launch_as<T, 1, VEC>(a);
    case 2: return launch_as<T, 2, VEC>(a);
    case 4: return launch_as<T, 4, VEC>(a);
    case 8: return launch_as<T, 8, VEC>(a);
    default: return -2;
  }
}

template <typename T>
int launch(int vector, int vals, const Args& a) {
  constexpr int E = 16 / sizeof(T);
  if ((long long)32 * vals * a.wpr * E < a.d) return -2;  // plan covers d
  if (vector) {
    const bool aligned = ((reinterpret_cast<uintptr_t>(a.x) |
                           reinterpret_cast<uintptr_t>(a.res) |
                           reinterpret_cast<uintptr_t>(a.scale) |
                           reinterpret_cast<uintptr_t>(a.h) |
                           reinterpret_cast<uintptr_t>(a.y)) & 15) == 0;
    if (!aligned || a.d % E != 0) return -3;
    return launch_vals<T, true>(vals, a);
  }
  return launch_vals<T, false>(vals, a);
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code if the launch was refused, or a
// negative code for an argument the kernel does not take: -1 dtype, -2 plan
// (vals and wpr each 1, 2, 4 or 8 covering d; rows_per_block >= 1), -3
// 16-byte accesses asked for on a row that cannot take them.
// dtype: 0 float32, 1 bfloat16.
int repro_fused_add_rmsnorm(const void* x, const void* res, const void* scale,
                            void* h, void* y, int dtype, int device, int rows,
                            int d, int vector, int vals, int wpr,
                            int rows_per_block, float eps, void* stream) {
  if (wpr < 1 || wpr > kWarps || (wpr & (wpr - 1)) || vals < 1 ||
      vals > kMaxVals || rows_per_block < 1 || d < 1 || rows < 1)
    return -2;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{x, res, scale, h, y, rows, d, wpr, rows_per_block, eps,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch<float>(vector, vals, a);
    case 1: return launch<__nv_bfloat16>(vector, vals, a);
    default: return -1;
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
