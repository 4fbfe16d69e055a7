// Flash attention forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces repro/kernels/flash_attention.py::_kernel (the Pallas
// FlashAttention-2 forward; its wrapper is ops.flash_attention).  Same
// semantics: q, k, v are read as fp32; S = (Q K^T) * 1/sqrt(d) in fp32;
// causal mask k_pos > q_pos, top-left aligned; keys past sk masked; fp32
// running max, sum and accumulator; the output is cast once to q's dtype.
//
// Layout.  q: (B, Sq, H, D), k/v: (B, Sk, KH, D), o: (B, Sq, H, D), each read
// through its (batch, seq, head) strides with a contiguous last dim, so the
// caller needs none of the reference's transposes.  GQA reads KV head
// h / (H / KH) in place of the reference's jnp.repeat copy.  Head dims: every
// multiple of 16 up to 128, each a template instantiation (D is a compile-time
// loop bound), which covers every config of the repository and its reduced
// test configs (head_dim 16).
//
// Design.  One block of 4 warps per (q tile of BQ = 4 * ROWS rows, head,
// batch); each warp owns ROWS query rows.  The block loops over 64-key K/V
// tiles staged in shared memory as fp32 and stops at the causal limit of its
// q tile; that loop takes the place of the TPU's sequential kv grid axis.  A
// lane owns keys lane and lane + 32 of a tile for the scores and output dims
// lane + 32 * c for the P V product.  Tile 0 always holds key 0, which is
// live for every row, so the running max is finite before a fully masked
// tile can add exp(0) garbage (the reference's "block 0 always live").
//
// Bound.  At the serving shape (B=8, S=512, H=15, KH=5, D=64, bf16) the
// kernel moves ~21 MB (6.3 us at 3.35 TB/s) and does ~4.0 GFLOP of causal
// products (4.1 us at the bf16 tensor-core rate): with tensor cores the
// work would be bound by bytes.  Both products run in fp32 on CUDA cores,
// as the Pallas kernel computes them, so this kernel is bound by operations
// at the 67 TFLOP/s fp32 rate (60 us).  The design attacks the shared-memory
// traffic that bounds such a loop: K rows are read as float4 and reused by
// all ROWS rows of a warp, q rows and probabilities are read as float4
// broadcasts, and the K/V tiles are padded by 4 floats per row so the
// float4 reads of 8 lanes hit distinct banks.  bf16 tensor-core products
// (wgmma), TMA loads and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 64;
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

template <int D, int ROWS>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(ROWS * kWarps * D        // q tile
                                  + 2 * kBlockK * (D + 4)  // K and V tiles
                                  + kWarps * ROWS * kBlockK);  // probabilities
}

template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
          int group, Strides qs, Strides ks, Strides vs, Strides os,
          float scale, int causal) {
  constexpr int BQ = ROWS * kWarps;
  constexpr int LD = D + 4;            // padded row stride of the K/V tiles
  constexpr int DPL = (D + 31) / 32;   // output dims per lane
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // BQ x D
  float* k_s = q_s + BQ * D;                     // kBlockK x LD
  float* v_s = k_s + kBlockK * LD;               // kBlockK x LD
  float* p_s = v_s + kBlockK * LD;               // kWarps x ROWS x kBlockK

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, batch = blockIdx.z;
  const int kv_head = head / group;
  const T* qb = q + batch * qs.b + head * qs.h;
  const T* kb = k + batch * ks.b + kv_head * ks.h;
  const T* vb = v + batch * vs.b + kv_head * vs.h;

  for (int i = tid; i < BQ * D; i += kThreads) {  // rows past sq stay zero
    const int r = i / D, c = i - r * D, qp = q0 + r;
    q_s[i] = qp < sq ? to_f32(qb[qp * qs.s + c]) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  const float* q_w = q_s + warp * ROWS * D;
  float* p_w = p_s + warp * ROWS * kBlockK;
  const int row0 = q0 + warp * ROWS;

  // last key any row of this tile may see: the causal limit stops the loop
  const int k_end = causal ? min(sk, q0 + BQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i - r * D, kp = k0 + r;
      float kx = 0.f, vx = 0.f;  // zero-fill the tail: 0 * garbage could be NaN
      if (kp < sk) {
        kx = to_f32(kb[kp * ks.s + c]);
        vx = to_f32(vb[kp * vs.s + c]);
      }
      k_s[r * LD + c] = kx;
      v_s[r * LD + c] = vx;
    }
    __syncthreads();

    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(k_s + lane * LD + c);
      const float4 kc = *reinterpret_cast<const float4*>(k_s + (lane + 32) * LD + c);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_w + r * D + c);
        s[r][0] = fmaf(qv.x, ka.x, fmaf(qv.y, ka.y, fmaf(qv.z, ka.z, fmaf(qv.w, ka.w, s[r][0]))));
        s[r][1] = fmaf(qv.x, kc.x, fmaf(qv.y, kc.y, fmaf(qv.z, kc.z, fmaf(qv.w, kc.w, s[r][1]))));
      }
    }

    const int key_a = k0 + lane, key_b = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qp = row0 + r;
      float sa = s[r][0] * scale, sb = s[r][1] * scale;
      if (key_a >= sk || (causal && key_a > qp)) sa = kNegInf;
      if (key_b >= sk || (causal && key_b > qp)) sb = kNegInf;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sa, sb)));
      const float corr = expf(m[r] - m_new);
      const float pa = expf(sa - m_new), pb = expf(sb - m_new);
      l[r] = l[r] * corr + warp_sum(pa + pb);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= corr;
      p_w[r * kBlockK + lane] = pa;
      p_w[r * kBlockK + lane + 32] = pb;
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
      for (int r = 0; r < ROWS; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(p_w + r * kBlockK + j);
#pragma unroll
        for (int c = 0; c < DPL; ++c)
          acc[r][c] = fmaf(pv.x, vv[0][c], fmaf(pv.y, vv[1][c],
                      fmaf(pv.z, vv[2][c], fmaf(pv.w, vv[3][c], acc[r][c]))));
      }
    }
    __syncwarp();  // p_w is rewritten by the next tile
  }

  T* ob = o + batch * os.b + head * os.h;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qp = row0 + r;
    if (qp >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int dd = lane + 32 * c;
      if (dd < D) ob[qp * os.s + dd] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int D, int ROWS>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int h, int kh, const Strides& qs, const Strides& ks,
           const Strides& vs, const Strides& os, float scale, int causal,
           cudaStream_t stream) {
  constexpr int BQ = ROWS * kWarps;
  constexpr size_t smem = smem_bytes<D, ROWS>();
  auto kern = flash_fwd<T, D, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h / kh, qs, ks,
      vs, os, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_rows(int block_q, const void* q, const void* k, const void* v,
                  void* o, int b, int sq, int sk, int h, int kh,
                  const Strides& qs, const Strides& ks, const Strides& vs,
                  const Strides& os, float scale, int causal,
                  cudaStream_t stream) {
  switch (block_q) {
    case 16: return launch<T, D, 4>(q, k, v, o, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, stream);
    case 32: return launch<T, D, 8>(q, k, v, o, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, stream);
    default: return -2;
  }
}

template <typename T>
int dispatch_d(int d, int block_q, const void* q, const void* k,
               const void* v, void* o, int b, int sq, int sk, int h, int kh,
               const Strides& qs, const Strides& ks, const Strides& vs,
               const Strides& os, float scale, int causal,
               cudaStream_t stream) {
  switch (d) {  // every multiple of 16 up to 128, each its own instantiation
#define REPRO_HEAD_DIM(D) \
    case D: return dispatch_rows<T, D>(block_q, q, k, v, o, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, stream);
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
// -2 block_q, -3 head dim, -4 block_k.  dtype: 0 float32, 1 bfloat16.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, int dtype, int device, int b, int sq,
                              int sk, int h, int kh, int d, int block_q,
                              int block_k, long long q_sb, long long q_ss,
                              long long q_sh, long long k_sb, long long k_ss,
                              long long k_sh, long long v_sb, long long v_ss,
                              long long v_sh, long long o_sb, long long o_ss,
                              long long o_sh, int causal, float scale,
                              void* stream) {
  if (block_k != kBlockK) return -4;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(d, block_q, q, k, v, o, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, st);
    case 1: return dispatch_d<__nv_bfloat16>(d, block_q, q, k, v, o, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, st);
    default: return -1;
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
