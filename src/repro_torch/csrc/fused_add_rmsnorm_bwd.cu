// Fused residual-add + RMSNorm backward for Hopper (sm_90a), bound through
// ctypes.
//
// The backward of fused_add_rmsnorm.cu's forward, which replaces
// repro/kernels/fused.py::_kernel (pallas_call at :47); the reference has
// no backward for that kernel and differentiates its jnp seam instead.
// With the forward's fp32 sum recomputed and its output casts passed
// straight through:
//   y = fp32(x) + fp32(res),  rstd = rsqrt(mean(y^2) + eps),  n = y * rstd
//   dn = dh * scale
//   dsum = dy + rstd * (dn - n * mean(dn * n))    = dx = dres
//   dscale = sum over rows of dh * n
// rstd and mean(dn * n) come from one pass over the row: mean(dn * n) =
// rstd * sum(dn * y) / d, so both row sums are taken together.
//
// Design (the forward's).  A warp owns a row (2-8 warps past 512 bf16 /
// 256 fp32 elements, the forward's plan from kernels/fused.py): each lane
// holds VALS 16-byte values of x, res and dh and of the scale as raw
// registers, neighbouring lanes on neighbouring 16-byte addresses, so every
// input is read once and dsum written once; dy is read in the second loop,
// where it is used.  Both row sums reduce by __shfl_xor_sync (one
// double-buffered shared-memory step for a multi-warp row).  Rows that
// cannot take 16-byte accesses run the VEC = false instantiation.
//   dscale without atomics: a lane accumulates dh * n for its own columns
//   over the rows its warp walks, in fp32 registers; at the block's end the
//   warps that own the same columns add theirs into shared memory one after
//   another, and the block writes one fp32 partial row.  A second kernel,
//   dscale_reduce, sums the blocks' partial rows for each column in a fixed
//   order.  So two runs agree bit for bit.
// Bound: no products and no reuse across rows, so bytes.  At the train
// path's 4096 x 960 bf16 it reads dh, dy, x and res and writes dsum, 39 MB:
// 11.7 us at 3.35 TB/s (the partial rows, 1 MB, stay in the L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;     // warps a block
constexpr int kMaxVals = 8;   // 16-byte values a lane holds
constexpr int kSlices = 8;    // dscale_reduce: partial rows summed apart

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

// Element e of value v of this lane (the forward's mapping): with VEC,
// value v is the 16-byte vector (g * VALS + v) * 32 + lane of the row;
// without, its elements are 32 apart.
template <typename T, int VALS, bool VEC>
__device__ __forceinline__ int column(int g, int v, int e, int lane) {
  constexpr int E = 16 / sizeof(T);
  return VEC ? ((g * VALS + v) * 32 + lane) * E + e
             : ((g * VALS + v) * E + e) * 32 + lane;
}

template <typename T, int VALS, bool VEC>
__device__ __forceinline__ void load_value(uint4& dst, const T* src, int d,
                                           int g, int v, int lane) {
  constexpr int E = 16 / sizeof(T);
  if (VEC) {
    const int c = column<T, VALS, VEC>(g, v, 0, lane);
    dst = c < d ? *reinterpret_cast<const uint4*>(src + c)
                : make_uint4(0u, 0u, 0u, 0u);
  } else {
    T* de = reinterpret_cast<T*>(&dst);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = column<T, VALS, VEC>(g, v, e, lane);
      de[e] = c < d ? src[c] : from_f32<T>(0.f);
    }
  }
}

template <typename T, int VALS, bool VEC>
__device__ __forceinline__ void load_row(uint4 (&dst)[VALS], const T* src,
                                         int d, int g, int lane) {
#pragma unroll
  for (int v = 0; v < VALS; ++v) load_value<T, VALS, VEC>(dst[v], src, d, g, v, lane);
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
fused_add_rmsnorm_bwd(const T* __restrict__ dh, const T* __restrict__ dy,
                      const T* __restrict__ x, const T* __restrict__ res,
                      const T* __restrict__ scale, T* __restrict__ dsum,
                      float* __restrict__ partial, int rows, int d, int wpr,
                      int rows_per_block, float eps) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ float col_sum[];        // d floats: the block's dscale
  __shared__ float red[2][2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = warp / wpr, g = warp - group * wpr;  // g: part of the row
  const int stride = kWarps / wpr;                       // rows a step
  uint4 sc[VALS];
  load_row<T, VALS, VEC>(sc, scale, d, g, lane);
  float acc[VALS][E];
#pragma unroll
  for (int v = 0; v < VALS; ++v)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[v][e] = 0.f;

  const int first = blockIdx.x * rows_per_block;
  const int last = min(rows, first + rows_per_block);
  int parity = 0;
  // every warp takes the same number of steps, so the barrier is uniform
  for (int r0 = first; r0 < last; r0 += stride, parity ^= 1) {
    const int row = r0 + group;
    const bool live = row < last;
    const long long base = (long long)row * d;
    uint4 xv[VALS], rv[VALS], hv[VALS];
    float ss = 0.f, sd = 0.f;   // sum y^2, sum dn * y
    if (live) {
      load_row<T, VALS, VEC>(xv, x + base, d, g, lane);
      load_row<T, VALS, VEC>(rv, res + base, d, g, lane);
      load_row<T, VALS, VEC>(hv, dh + base, d, g, lane);
#pragma unroll
      for (int v = 0; v < VALS; ++v) {
        const T* xe = reinterpret_cast<const T*>(&xv[v]);
        const T* re = reinterpret_cast<const T*>(&rv[v]);
        const T* he = reinterpret_cast<const T*>(&hv[v]);
        const T* se = reinterpret_cast<const T*>(&sc[v]);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float yf = to_f32(xe[e]) + to_f32(re[e]);
          ss = fmaf(yf, yf, ss);
          sd = fmaf(to_f32(he[e]) * to_f32(se[e]), yf, sd);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sd += __shfl_xor_sync(0xffffffffu, sd, o);
    }
    if (wpr > 1) {  // the row's warps meet once; same order in every thread
      if (lane == 0) {
        red[parity][0][warp] = ss;
        red[parity][1][warp] = sd;
      }
      __syncthreads();
      ss = sd = 0.f;
      for (int k = 0; k < wpr; ++k) {
        ss += red[parity][0][group * wpr + k];
        sd += red[parity][1][group * wpr + k];
      }
    }
    if (!live) continue;
    const float rstd = rsqrtf(ss / (float)d + eps);
    const float c = sd * rstd / (float)d;  // mean(dn * n)
#pragma unroll
    for (int v = 0; v < VALS; ++v) {
      uint4 dyv, out;
      load_value<T, VALS, VEC>(dyv, dy + base, d, g, v, lane);
      const T* xe = reinterpret_cast<const T*>(&xv[v]);
      const T* re = reinterpret_cast<const T*>(&rv[v]);
      const T* he = reinterpret_cast<const T*>(&hv[v]);
      const T* se = reinterpret_cast<const T*>(&sc[v]);
      const T* ye = reinterpret_cast<const T*>(&dyv);
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float n = (to_f32(xe[e]) + to_f32(re[e])) * rstd;
        const float hf = to_f32(he[e]);
        const float dn = hf * to_f32(se[e]);
        oe[e] = from_f32<T>(to_f32(ye[e]) + rstd * (dn - n * c));
        acc[v][e] = fmaf(hf, n, acc[v][e]);
      }
      store_value<T, VALS, VEC>(dsum + base, out, d, g, v, lane);
    }
  }

  // the block's dscale: the row groups add their columns in turn
  const int groups = kWarps / wpr;
  for (int grp = 0; grp < groups; ++grp) {
    if (group == grp) {
#pragma unroll
      for (int v = 0; v < VALS; ++v)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int col = column<T, VALS, VEC>(g, v, e, lane);
          if (col < d) col_sum[col] = (grp ? col_sum[col] : 0.f) + acc[v][e];
        }
    }
    __syncthreads();
  }
  float* prow = partial + (long long)blockIdx.x * d;
  for (int col = threadIdx.x; col < d; col += kWarps * 32) prow[col] = col_sum[col];
}

// dscale[c] = sum over blocks of partial[block][c]: 32 columns a block, the
// partial rows split into kSlices interleaved runs summed by one warp each,
// then the runs added in order.
template <typename T>
__global__ void __launch_bounds__(kSlices * 32)
dscale_reduce(const float* __restrict__ partial, T* __restrict__ dscale,
              int blocks, int d) {
  __shared__ float run[kSlices][32];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < d)
    for (int b = slice; b < blocks; b += kSlices)
      s += partial[(long long)b * d + col];
  run[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kSlices; ++k) t += run[k][lane];
    dscale[col] = from_f32<T>(t);
  }
}

struct Args {
  const void *dh, *dy, *x, *res, *scale;
  void *dsum, *dscale;
  float* partial;
  int rows, d, wpr, rows_per_block, blocks;
  float eps;
  cudaStream_t stream;
};

template <typename T, int VALS, bool VEC>
int launch_as(const Args& a) {
  const size_t smem = sizeof(float) * (size_t)a.d;
  auto kern = fused_add_rmsnorm_bwd<T, VALS, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<a.blocks, kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.dh), static_cast<const T*>(a.dy),
      static_cast<const T*>(a.x), static_cast<const T*>(a.res),
      static_cast<const T*>(a.scale), static_cast<T*>(a.dsum), a.partial,
      a.rows, a.d, a.wpr, a.rows_per_block, a.eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dscale_reduce<T><<<(a.d + 31) / 32, kSlices * 32, 0, a.stream>>>(
      a.partial, static_cast<T*>(a.dscale), a.blocks, a.d);
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
    const bool aligned = ((reinterpret_cast<uintptr_t>(a.dh) |
                           reinterpret_cast<uintptr_t>(a.dy) |
                           reinterpret_cast<uintptr_t>(a.x) |
                           reinterpret_cast<uintptr_t>(a.res) |
                           reinterpret_cast<uintptr_t>(a.scale) |
                           reinterpret_cast<uintptr_t>(a.dsum)) & 15) == 0;
    if (!aligned || a.d % E != 0) return -3;
    return launch_vals<T, true>(vals, a);
  }
  return launch_vals<T, false>(vals, a);
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code if a launch was refused, or a
// negative code for an argument the kernels do not take: -1 dtype, -2 plan
// (vals and wpr each 1, 2, 4 or 8 covering d; rows_per_block a whole number
// of row steps; blocks * rows_per_block covering rows), -3 16-byte accesses
// asked for on a row that cannot take them.  dtype: 0 float32, 1 bfloat16.
// partial: fp32 (blocks, d) scratch.  Launches the row kernel, then
// dscale_reduce, on `stream`.
int repro_fused_add_rmsnorm_bwd(const void* dh, const void* dy, const void* x,
                                const void* res, const void* scale,
                                void* dsum, void* dscale, void* partial,
                                int dtype, int device, int rows, int d,
                                int vector, int vals, int wpr,
                                int rows_per_block, int blocks, float eps,
                                void* stream) {
  if (wpr < 1 || wpr > kWarps || (wpr & (wpr - 1)) || vals < 1 ||
      vals > kMaxVals || d < 1 || rows < 1 || rows_per_block < 1 ||
      rows_per_block % (kWarps / wpr) != 0 || blocks < 1 ||
      (long long)blocks * rows_per_block < rows)
    return -2;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{dh, dy, x, res, scale, dsum, dscale,
               static_cast<float*>(partial), rows, d, wpr, rows_per_block,
               blocks, eps, static_cast<cudaStream_t>(stream)};
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
