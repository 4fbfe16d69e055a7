// Flash-attention decode for Hopper (sm_90a), bound through ctypes.
//
// Replaces repro/kernels/flash_attention.py::_decode_kernel (Pallas; its
// wrapper is flash_attention_decode, reached through ops.flash_attention_decode
// and layers.attn_decode(impl="pallas")): one query row per (batch, head)
// against a KV cache with a dynamic valid length.  Same numerics:
//   q is divided by sqrt(d) in fp32 and rounded to q's dtype before the
//     product (flash_attention.py:223), so no score is rescaled;
//   scores q.k in fp32; positions >= cache_len masked with -1e30;
//   fp32 running max, sum and accumulator over 64-key tiles; tiles wholly
//     past cache_len are never visited (the reference's pl.when skip), so
//     cache_len == 0 leaves acc = 0 and l = 0 and the output is
//     0 / max(0, 1e-30) = 0;
//   the output is cast once to q's dtype.
//
// Layout.  q: (B, 1, H, D), k/v: (B, S, KH, D), o: (B, 1, H, D), read through
// their (batch, seq, head) strides with a contiguous last dim, so a view of a
// wider cache buffer is read in place.  The valid length comes either as an
// int argument or from a device int32 scalar the kernel reads itself, so a
// length that lives on the card needs no host sync.  A length above S is
// clamped to S.
//
// Work split.  One block of 4 warps per (batch row, KV head, group of up to 8
// query heads).  Every query head of a GQA group shares its block's K/V tiles,
// so for groups of up to 8 heads (every config but granite's MQA) each cached
// K/V element is read from device memory once: the reference's jnp.repeat copy
// does not come back.  Warp w owns query heads w and w + 4 of the group; its
// lanes own keys lane and lane + 32 of a tile for the scores, and output dims
// lane + 32 * c for the P V product, as in flash_attention.cu.
//
// Bound.  There is one query row per head: the kernel is bound by the bytes
// of the cache it streams.  At the serve decode shape (B=8, S=549, H=15,
// KH=5, D=64, bf16) K+V are 5.6 MB, about 1.7 us at 3.35 TB/s.  Its grid is
// 8 x 5 = 40 blocks, under a third of the 132 SMs, so it cannot reach that
// rate; splitting the keys of one (row, KV head) across blocks with a second
// merge pass (flash-decoding) is the redesign that would fill the card, and
// is later work.  Tiles are staged in shared memory as fp32, padded by 4
// floats a row so float4 reads of 8 lanes hit distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 64;
constexpr int kRows = 2;                       // query heads per warp
constexpr int kHeads = kWarps * kRows;         // query heads per block
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, s, h;  // elements; the last dim is contiguous
};

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
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kHeads * D                 // q rows
                                  + 2 * kBlockK * (D + 4)    // K and V tiles
                                  + kHeads * kBlockK);       // probabilities
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             const int* __restrict__ len_ptr, int len_arg, int s_cache,
             int group, Strides qs, Strides ks, Strides vs, Strides os,
             float sqrt_d) {
  constexpr int LD = D + 4;            // padded row stride of the K/V tiles
  constexpr int DPL = (D + 31) / 32;   // output dims per lane
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // kHeads x D
  float* k_s = q_s + kHeads * D;                 // kBlockK x LD
  float* v_s = k_s + kBlockK * LD;               // kBlockK x LD
  float* p_s = v_s + kBlockK * LD;               // kHeads x kBlockK

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int batch = blockIdx.x, kv_head = blockIdx.y;
  const int g0 = blockIdx.z * kHeads;            // first head of the group
  const int n_heads = min(kHeads, group - g0);
  const int head0 = kv_head * group + g0;
  int len = len_ptr != nullptr ? *len_ptr : len_arg;
  len = min(max(len, 0), s_cache);

  for (int i = tid; i < kHeads * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    float x = 0.f;
    if (r < n_heads) {
      const float raw = to_f32(q[batch * qs.b + (head0 + r) * qs.h + c]);
      x = to_f32(from_f32<T>(raw / sqrt_d));   // scale, then round to T
    }
    q_s[i] = x;
  }

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  const bool active = warp < n_heads;  // warp-uniform: idle warps only load
  const T* kb = k + batch * ks.b + kv_head * ks.h;
  const T* vb = v + batch * vs.b + kv_head * vs.h;

  for (int k0 = 0; k0 < len; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i - r * D, kp = k0 + r;
      float kx = 0.f, vx = 0.f;  // zero-fill past len: 0 * garbage could be NaN
      if (kp < len) {
        kx = to_f32(kb[kp * ks.s + c]);
        vx = to_f32(vb[kp * vs.s + c]);
      }
      k_s[r * LD + c] = kx;
      v_s[r * LD + c] = vx;
    }
    __syncthreads();
    if (!active) continue;

    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(k_s + lane * LD + c);
      const float4 kc = *reinterpret_cast<const float4*>(k_s + (lane + 32) * LD + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (warp + kWarps * r) * D + c);
        s[r][0] = fmaf(qv.x, ka.x, fmaf(qv.y, ka.y, fmaf(qv.z, ka.z, fmaf(qv.w, ka.w, s[r][0]))));
        s[r][1] = fmaf(qv.x, kc.x, fmaf(qv.y, kc.y, fmaf(qv.z, kc.z, fmaf(qv.w, kc.w, s[r][1]))));
      }
    }

    const int key_a = k0 + lane, key_b = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float sa = key_a >= len ? kNegInf : s[r][0];
      const float sb = key_b >= len ? kNegInf : s[r][1];
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sa, sb)));
      const float corr = expf(m[r] - m_new);
      const float pa = expf(sa - m_new), pb = expf(sb - m_new);
      l[r] = l[r] * corr + warp_sum(pa + pb);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= corr;
      float* p_w = p_s + (warp + kWarps * r) * kBlockK;
      p_w[lane] = pa;
      p_w[lane + 32] = pb;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int dd = lane + 32 * c;
          vv[jj][c] = dd < D ? v_s[(j + jj) * LD + dd] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(
            p_s + (warp + kWarps * r) * kBlockK + j);
#pragma unroll
        for (int c = 0; c < DPL; ++c)
          acc[r][c] = fmaf(pv.x, vv[0][c], fmaf(pv.y, vv[1][c],
                      fmaf(pv.z, vv[2][c], fmaf(pv.w, vv[3][c], acc[r][c]))));
      }
    }
    __syncwarp();  // p_s is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int lh = warp + kWarps * r;
    if (lh >= n_heads) continue;
    T* ob = o + batch * os.b + (head0 + lh) * os.h;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int dd = lane + 32 * c;
      if (dd < D) ob[dd] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* len_ptr, int len_arg, int b, int s, int h, int kh,
           const Strides& qs, const Strides& ks, const Strides& vs,
           const Strides& os, float sqrt_d, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_decode<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int group = h / kh;
  dim3 grid(b, kh, (group + kHeads - 1) / kHeads);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), len_ptr, len_arg, s,
      group, qs, ks, vs, os, sqrt_d);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
               const int* len_ptr, int len_arg, int b, int s, int h, int kh,
               const Strides& qs, const Strides& ks, const Strides& vs,
               const Strides& os, float sqrt_d, cudaStream_t stream) {
  switch (d) {  // every multiple of 16 up to 128, each its own instantiation
#define REPRO_HEAD_DIM(D) \
    case D: return launch<T, D>(q, k, v, o, len_ptr, len_arg, b, s, h, kh, qs, ks, vs, os, sqrt_d, stream);
    REPRO_HEAD_DIM(16) REPRO_HEAD_DIM(32) REPRO_HEAD_DIM(48) REPRO_HEAD_DIM(64)
    REPRO_HEAD_DIM(80) REPRO_HEAD_DIM(96) REPRO_HEAD_DIM(112) REPRO_HEAD_DIM(128)
#undef REPRO_HEAD_DIM
    default: return -3;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code if the launch was refused, or a
// negative code for an argument the kernel does not take: -1 dtype,
// -3 head dim, -4 block_k, -5 shape.  dtype: 0 float32, 1 bfloat16.
// len_ptr: a device int32 scalar holding the valid length, or NULL to use
// len_arg.
int repro_flash_decode(const void* q, const void* k, const void* v, void* o,
                       const void* len_ptr, int len_arg, int dtype,
                       int device, int b, int s, int h, int kh, int d,
                       int block_k, long long q_sb, long long q_sh,
                       long long k_sb, long long k_ss, long long k_sh,
                       long long v_sb, long long v_ss, long long v_sh,
                       long long o_sb, long long o_sh, float sqrt_d,
                       void* stream) {
  if (block_k != kBlockK) return -4;
  if (b < 1 || s < 1 || kh < 1 || h % kh != 0 || kh > 65535 ||
      (h / kh + kHeads - 1) / kHeads > 65535)
    return -5;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{q_sb, 0, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, 0, o_sh};
  const int* lp = static_cast<const int*>(len_ptr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(d, q, k, v, o, lp, len_arg, b, s, h, kh, qs, ks, vs, os, sqrt_d, st);
    case 1: return dispatch_d<__nv_bfloat16>(d, q, k, v, o, lp, len_arg, b, s, h, kh, qs, ks, vs, os, sqrt_d, st);
    default: return -1;
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
