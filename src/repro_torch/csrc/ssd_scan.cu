// Mamba-2 SSD chunked scan for Hopper (sm_90a), bound through ctypes.
//
// Replaces repro/kernels/ssd.py::_kernel (Pallas; its wrapper is ssd_scan,
// reached through ops.ssd_scan).  Per chunk of Q steps, with the fp32 (P, N)
// state carried from chunk to chunk, the same arithmetic in fp32:
//   cum   = cumsum(dt * a)                                  (within the chunk)
//   W     = (C B^T) * exp(cum_i - cum_j) * dt_j             for i >= j, else 0
//   y     = W x + (C * exp(cum)) state^T                    cast once to x's dtype
//   state = exp(cum_last) * state + (x * exp(cum_last - cum) * dt)^T B
// The decay exp(cum_i - cum_j) is evaluated only for i >= j: the reference
// takes exp over the whole square and discards the upper half, where
// cum_i - cum_j > 0 can overflow; here no inf is ever produced.
//
// Grid.  The TPU grid (batch, head, chunk) runs its chunk axis in order and
// keeps the state in VMEM scratch between steps.  Hopper blocks run in no
// order, so the chunk axis becomes a loop inside each block and the state
// stays in shared memory for the whole sequence.  The grid is (P tile, head,
// batch): state row p depends only on column p of x, so splitting P into
// tiles of 16 is exact, and turns mamba2-130m's 24 (batch, head) pairs at
// batch 1 into 96 blocks.  Each P tile recomputes C B^T and the decay for its
// (batch, head); that redundancy costs no time while the blocks fit on the
// 132 SMs at once.
//
// Ragged tail.  A chunk shorter than Q (the sequence tail, or any chunk when
// the wrapper's chunk is below 128) is zero-filled inside the kernel up to 128
// rows: dt = 0 there, so those steps are exact no-ops on the recurrence, as
// the reference's zero pad is (ssd.py:89-92); their y rows are not written.
//
// Bound.  At mamba2-130m's geometry (B=1, S=2048, H=24, P=64, N=128, bf16)
// the function reads x, dt, B, C and writes y and the state, ~14.6 MB: about
// 4.4 us at 3.35 TB/s, just above the 4.1 us its ~4 GFLOP take at the bf16
// tensor-core rate.  So the function is bound by bytes.
// The ceiling of this design is lower.  Its products (C B^T, W x, the state
// terms) run in fp32 on CUDA cores, at most 67 TFLOP/s, and each of the 4
// P tiles of a (batch, head) recomputes C B^T (2 * 128^2 * 128 FLOP per
// chunk), so the design is bound by those operations, at over 20x the
// function's bound.  Register tiles of 8 x 8 (lower triangle only: C B^T is
// needed for i >= j) keep 16 shared-memory reads per 36 FMAs; the 128-row B
// and C chunks are padded by one float a row so the column reads of 16 lanes
// hit distinct banks.  Tensor-core products (wgmma) and one C B^T per (batch, chunk)
// shared by every head are later work.
//
// Shared memory: 2 x 128 x (N + 1) fp32 for B and C, 128 x 129 for W, the
// x tile, the state tile, cum and dt: 215,616 bytes at N = 128, within the
// 227 KB a block may have (set with cudaFuncSetAttribute).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 128;      // rows of the chunk buffers (the chunk, zero-padded)
constexpr int kPT = 16;      // state rows (head-dim columns) per block
constexpr int kMaxN = 128;   // state width the shared-memory plan admits

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

size_t smem_floats(int n) {
  const int ldn = n + 1;
  return 2 * (size_t)kQ * ldn + (size_t)kQ * (kQ + 1) + kQ * kPT +
         (size_t)kPT * ldn + 2 * kQ;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan(const T* __restrict__ x, const float* __restrict__ dt,
         const float* __restrict__ a, const T* __restrict__ bm,
         const T* __restrict__ cm, T* __restrict__ y,
         float* __restrict__ state, int s, int h, int p, int n, int chunk) {
  const int ldn = n + 1, ldq = kQ + 1;
  extern __shared__ float smem[];
  float* b_s = smem;                  // kQ x ldn
  float* c_s = b_s + kQ * ldn;        // kQ x ldn
  float* w_s = c_s + kQ * ldn;        // kQ x ldq, lower triangle
  float* x_s = w_s + kQ * ldq;        // kQ x kPT (x, then x * decay-to-end * dt)
  float* st_s = x_s + kQ * kPT;       // kPT x ldn
  float* cum_s = st_s + kPT * ldn;    // kQ
  float* dt_s = cum_s + kQ;           // kQ

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * kPT, head = blockIdx.y, batch = blockIdx.z;
  const float a_h = a[head];
  for (int i = tid; i < kPT * ldn; i += kThreads) st_s[i] = 0.f;

  for (int c0 = 0; c0 < s; c0 += chunk) {
    const int len = min(chunk, s - c0);
    __syncthreads();  // the previous chunk is consumed (and the state is zeroed)
    for (int i = tid; i < kQ; i += kThreads)
      dt_s[i] = i < len ? dt[((long long)batch * s + c0 + i) * h + head] : 0.f;
    for (int i = tid; i < kQ * n; i += kThreads) {
      const int j = i / n, c = i - j * n;
      float bv = 0.f, cv = 0.f;
      if (j < len) {
        const long long g = ((long long)batch * s + c0 + j) * n + c;
        bv = to_f32(bm[g]);
        cv = to_f32(cm[g]);
      }
      b_s[j * ldn + c] = bv;
      c_s[j * ldn + c] = cv;
    }
    for (int i = tid; i < kQ * kPT; i += kThreads) {
      const int j = i / kPT, pp = p0 + (i - j * kPT);
      x_s[i] = (j < len && pp < p)
          ? to_f32(x[(((long long)batch * s + c0 + j) * h + head) * p + pp])
          : 0.f;
    }
    __syncthreads();

    if (warp == 0) {  // cum = cumsum(dt * a): 4 steps a lane, then a warp scan
      float v[kQ / 32];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < kQ / 32; ++e) {
        run += dt_s[lane * (kQ / 32) + e] * a_h;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const float base = incl - run;  // sum over the lanes before this one
#pragma unroll
      for (int e = 0; e < kQ / 32; ++e) cum_s[lane * (kQ / 32) + e] = base + v[e];
    }
    __syncthreads();

    {  // W = (C B^T) * exp(cum_i - cum_j) * dt_j, rows ti + 16 r, cols tj + 16 c
      const int ti = tid >> 4, tj = tid & 15;
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
      for (int k = 0; k < n; ++k) {
        float cr[8], bc[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) cr[r] = c_s[(ti + 16 * r) * ldn + k];
#pragma unroll
        for (int c = 0; c < 8; ++c) bc[c] = b_s[(tj + 16 * c) * ldn + k];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c <= r; ++c) acc[r][c] = fmaf(cr[r], bc[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c <= r; ++c) {
          const int i = ti + 16 * r, j = tj + 16 * c;
          w_s[i * ldq + j] = i >= j
              ? acc[r][c] * expf(cum_s[i] - cum_s[j]) * dt_s[j] : 0.f;
        }
    }
    __syncthreads();

    {  // y rows: i = tid / 2, columns ph .. ph + 7 of the tile
      const int i = tid >> 1, ph = (tid & 1) * 8;
      if (i < len) {
        float yd[8], yo[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) yd[e] = yo[e] = 0.f;
        for (int j = 0; j <= i; ++j) {
          const float w = w_s[i * ldq + j];
#pragma unroll
          for (int e = 0; e < 8; ++e) yd[e] = fmaf(w, x_s[j * kPT + ph + e], yd[e]);
        }
        const float dec = expf(cum_s[i]);
        for (int k = 0; k < n; ++k) {
          const float cd = c_s[i * ldn + k] * dec;
#pragma unroll
          for (int e = 0; e < 8; ++e) yo[e] = fmaf(cd, st_s[(ph + e) * ldn + k], yo[e]);
        }
        T* yr = y + (((long long)batch * s + c0 + i) * h + head) * p;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int pp = p0 + ph + e;
          if (pp < p) yr[pp] = from_f32<T>(yd[e] + yo[e]);
        }
      }
    }
    __syncthreads();

    const float cum_last = cum_s[len - 1];
    for (int i = tid; i < kQ * kPT; i += kThreads) {
      const int j = i / kPT;
      x_s[i] *= expf(cum_last - cum_s[j]) * dt_s[j];
    }
    __syncthreads();

    {  // state = exp(cum_last) * state + xw^T B; row pr, columns nl + 16 k
      const int pr = tid >> 4, nl = tid & 15;
      float upd[kMaxN / 16];
#pragma unroll
      for (int k = 0; k < kMaxN / 16; ++k) upd[k] = 0.f;
      for (int j = 0; j < len; ++j) {
        const float xw = x_s[j * kPT + pr];
#pragma unroll
        for (int k = 0; k < kMaxN / 16; ++k) {
          const int c = nl + 16 * k;
          if (c < n) upd[k] = fmaf(xw, b_s[j * ldn + c], upd[k]);
        }
      }
      const float dec = expf(cum_last);
#pragma unroll
      for (int k = 0; k < kMaxN / 16; ++k) {
        const int c = nl + 16 * k;
        if (c < n) st_s[pr * ldn + c] = dec * st_s[pr * ldn + c] + upd[k];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kPT * n; i += kThreads) {
    const int pr = i / n, c = i - pr * n, pp = p0 + pr;
    if (pp < p)
      state[(((long long)batch * h + head) * p + pp) * n + c] = st_s[pr * ldn + c];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, void* y, void* state, int bs, int s, int h, int p,
           int n, int chunk, cudaStream_t stream) {
  const size_t smem = smem_floats(n) * sizeof(float);
  auto kern = ssd_scan<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p + kPT - 1) / kPT, h, bs);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y),
      static_cast<float*>(state), s, h, p, n, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code if the launch was refused, or a
// negative code for an argument the kernel does not take: -1 dtype,
// -2 chunk (1..128), -3 state width (1..128), -5 shape.
// dtype: 0 float32, 1 bfloat16 (x, B, C, y); dt, a and the state are fp32.
int repro_ssd_scan(const void* x, const void* dt, const void* a,
                   const void* b, const void* c, void* y, void* state,
                   int dtype, int device, int bs, int s, int h, int p, int n,
                   int chunk, void* stream) {
  if (chunk < 1 || chunk > kQ) return -2;
  if (n < 1 || n > kMaxN) return -3;
  if (bs < 1 || s < 1 || h < 1 || p < 1 || h > 65535 || bs > 65535) return -5;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, dt, a, b, c, y, state, bs, s, h, p, n, chunk, st);
    case 1: return launch<__nv_bfloat16>(x, dt, a, b, c, y, state, bs, s, h, p, n, chunk, st);
    default: return -1;
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
