// Flash attention backward for Hopper (sm_90a), bound to Python through ctypes.
//
// The backward of flash_attention.cu's forward, which replaces
// repro/kernels/flash_attention.py::_kernel (pallas_call at :146).  The
// reference has no backward for that kernel (no custom_vjp): its training
// differentiates the jnp attention, and this is the FlashAttention-2
// backward of the same function.  From the forward's fp32 row log-sum-exp
// (LSE), with scale = 1/sqrt(d):
//   P = exp(S * scale - LSE), S = Q K^T, 0 where masked;  dP = dO V^T
//   delta = rowsum(P * dP)                                   bwd_dq, pass 1
//   dQ = dS K * scale, dS = P * (dP - delta)                 bwd_dq, pass 2
//   dV = sum over the GQA group and q rows of P^T dO         bwd_dkdv
//   dK = sum of dS^T Q * scale                               bwd_dkdv
// Masks are the forward's: causal k_pos > q_pos (top-left aligned), keys at
// or past sk.  Every sum is fp32 from the inputs' values; dQ, dK, dV are cast
// once to the input dtype.  Each output element is written by exactly one
// block, and every sum runs in a fixed order: no atomics, so two runs agree
// bit for bit.
//
// delta.  rowsum(P * dP) equals FlashAttention-2's rowsum(dO * O) in exact
// arithmetic (sum_j P_ij dO_i . V_j = dO_i . O_i), but it is taken from the
// same fp32 P and dP that dS subtracts it from, so each row of dS sums to
// zero as the softmax gradient must.  From the bf16-rounded O it does not:
// where V rows share a large common part, dP - delta cancels it, and O's
// rounding (2^-9 of |O|) becomes a bias on every dS of the row.  Measured
// on smollm-360M after 12 training steps (bench/attention_bwd_precision.py),
// that bias left dQ of the top layers at a cosine of 0.29 to float64.  The
// price is one more pass of the dQ kernel over its KV tiles (two products).
//
// Layout.  q, dO, dQ: (B, Sq, H, D); k, v, dK, dV: (B, Sk, KH, D), all
// contiguous; lse, delta: fp32 (B, H, Sq).  GQA reads KV head h / (H / KH).
// Head dims: every multiple of 16 up to 128, each an instantiation.
//
// Design (simple first: the products run on the CUDA cores in fp32).  A
// block of 256 threads works on 64 x 64 tiles staged in shared memory as
// fp32, rows padded by one float so a column walk hits distinct banks.
// Every product is C (+)= A B over shared-memory operands read through
// strides, so the transposes cost nothing: thread (tx, ty) = (t % 16,
// t / 16) owns rows ty + 16 i and columns tx + 16 j of C in registers.
//   bwd_dq (first): grid (q tiles, H, B), a causal head's heaviest q tile
//   first.  Q, dO and LSE stay staged; the block walks the KV tiles up to
//   its causal limit twice: once for its rows' delta (written out for
//   bwd_dkdv), then recomputing P and dS and accumulating dQ in registers.
//   bwd_dkdv (second): grid (KV tiles, KH, B), the heaviest (first) KV
//   tile first.  K and V stay staged; the block walks the q heads of its
//   GQA group and, for each, the q tiles that can see its keys (a causal
//   block starts at the diagonal), recomputing S and P, staging P and dS,
//   and accumulating dV and dK in registers.
// Bound on the H100: at the train path's (4, 1024, 15/5, 64) causal bf16,
// 5 products of 2 * d * (causal pairs) each a head, 20.2 GFLOP (20 us at
// 989 TFLOP/s bf16), against 18 MB of inputs and outputs (5 us): bound by
// operations.  These fp32 CUDA-core products (67 TFLOP/s; with the delta
// pass and the recomputation 9 products run) sit far from that bound;
// tensor-core products (wgmma, as the forward) are the later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // q rows and keys a tile
constexpr int kLDP = kTile + 1;      // row stride of the staged P and dS

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

struct Dims {
  int b, sq, sk, h, kh, group;
};

// 64 rows [row0, row0 + 64) of a (.., S, heads, D) tensor at `base` (its
// (batch, head) offset applied; rows `stride` elements apart) into shared
// memory as fp32 with row stride D + 1; rows at or past `limit` are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long stride, int row0,
                                          int limit, int tid) {
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i - r * D, row = row0 + r;
    dst[r * (D + 1) + c] = row < limit ? to_f32(base[row * stride + c]) : 0.f;
  }
}

// c[i][j] += sum_k A(ty + 16 i, k) B(k, tx + 16 j) over k < K, with
// A(m, k) = a[m * am + k * ak] and B(k, n) = b[k * bk + n * bn].
template <int TM, int TN, int K>
__device__ __forceinline__ void mm(float (&c)[TM][TN], const float* a, int am,
                                   int ak, const float* b, int bk, int bn,
                                   int tx, int ty) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a[(ty + 16 * i) * am + k * ak];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b[k * bk + (tx + 16 * j) * bn];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&c)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) c[i][j] = 0.f;
}

// The 64 x 64 tile's P = exp(S * scale - LSE) and dS = P * (dP - delta) in
// the (ty + 16 i, tx + 16 j) fragment, S and dP given there; masked
// entries (causal, keys past sk, rows past sq) are 0.  Stages dS in ds_s
// and, when p_s is not null, P in p_s (both row stride kLDP).
__device__ __forceinline__ void softmax_grad(const float (&s)[4][4],
                                             const float (&dp)[4][4],
                                             float* p_s, float* ds_s,
                                             const float* lse_s,
                                             const float* dl_s, int q0, int k0,
                                             int sq, int sk, int causal,
                                             float scale, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, key = k0 + c;
      const bool live = row < sq && key < sk && !(causal && key > row);
      const float pv = live ? expf(fmaf(s[i][j], scale, -lse_s[r])) : 0.f;
      if (p_s != nullptr) p_s[r * kLDP + c] = pv;
      ds_s[r * kLDP + c] = pv * (dp[i][j] - dl_s[r]);
    }
  }
}

template <int D>
constexpr size_t smem_bytes() {  // four D-wide tiles, P and dS, LSE and delta
  return sizeof(float) * (size_t)(4 * kTile * (D + 1) + 2 * kTile * kLDP
                                  + 2 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         T* __restrict__ dk, T* __restrict__ dv, Dims dm, float scale,
         int causal) {
  constexpr int LD = D + 1, TN = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                    // keys x D
  float* v_s = k_s + kTile * LD;
  float* q_s = v_s + kTile * LD;        // q rows x D
  float* do_s = q_s + kTile * LD;
  float* p_s = do_s + kTile * LD;       // q rows x keys
  float* ds_s = p_s + kTile * kLDP;
  float* lse_s = ds_s + kTile * kLDP;
  float* dl_s = lse_s + kTile;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kTile, kvh = blockIdx.y, bi = blockIdx.z;
  const long long kv_stride = (long long)dm.kh * D, q_stride = (long long)dm.h * D;
  const long long kv_off = ((long long)bi * dm.sk * dm.kh + kvh) * D;
  load_tile<T, D>(k_s, k + kv_off, kv_stride, k0, dm.sk, tid);
  load_tile<T, D>(v_s, v + kv_off, kv_stride, k0, dm.sk, tid);

  float dk_acc[4][TN], dv_acc[4][TN];
  zero(dk_acc);
  zero(dv_acc);
  // a causal q tile that ends before k0 sees none of these keys
  const int q_first = causal ? k0 : 0;
  for (int hh = 0; hh < dm.group; ++hh) {
    const int head = kvh * dm.group + hh;
    const long long q_off = ((long long)bi * dm.sq * dm.h + head) * D;
    const float* lse_row = lse + ((long long)bi * dm.h + head) * dm.sq;
    const float* dl_row = delta + ((long long)bi * dm.h + head) * dm.sq;
    for (int q0 = q_first; q0 < dm.sq; q0 += kTile) {
      __syncthreads();                  // the last tile's reads are done
      load_tile<T, D>(q_s, q + q_off, q_stride, q0, dm.sq, tid);
      load_tile<T, D>(do_s, dout + q_off, q_stride, q0, dm.sq, tid);
      if (tid < kTile) {
        const bool ok = q0 + tid < dm.sq;
        lse_s[tid] = ok ? lse_row[q0 + tid] : 0.f;
        dl_s[tid] = ok ? dl_row[q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      zero(s);
      zero(dp);
      mm<4, 4, D>(s, q_s, LD, 1, k_s, 1, LD, tx, ty);     // S = Q K^T
      mm<4, 4, D>(dp, do_s, LD, 1, v_s, 1, LD, tx, ty);   // dP = dO V^T
      softmax_grad(s, dp, p_s, ds_s, lse_s, dl_s, q0, k0, dm.sq, dm.sk,
                   causal, scale, tx, ty);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q: C rows are keys, k runs over q rows
      mm<4, TN, kTile>(dv_acc, p_s, 1, kLDP, do_s, LD, 1, tx, ty);
      mm<4, TN, kTile>(dk_acc, ds_s, 1, kLDP, q_s, LD, 1, tx, ty);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= dm.sk) continue;
    T* dkr = dk + kv_off + key * kv_stride;
    T* dvr = dv + kv_off + key * kv_stride;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      dkr[tx + 16 * j] = from_f32<T>(dk_acc[i][j] * scale);
      dvr[tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, float* __restrict__ delta,
       T* __restrict__ dq, Dims dm, float scale, int causal) {
  constexpr int LD = D + 1, TN = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * LD;
  float* k_s = do_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* ds_s = v_s + kTile * LD;       // q rows x keys
  float* lse_s = ds_s + kTile * kLDP;
  float* dl_s = lse_s + kTile;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // a causal head's last q tiles walk the most KV tiles: start them first
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kTile, head = blockIdx.y, bi = blockIdx.z;
  const int kvh = head / dm.group;
  const long long kv_stride = (long long)dm.kh * D, q_stride = (long long)dm.h * D;
  const long long kv_off = ((long long)bi * dm.sk * dm.kh + kvh) * D;
  const long long q_off = ((long long)bi * dm.sq * dm.h + head) * D;
  const long long row_at = ((long long)bi * dm.h + head) * dm.sq + q0;
  load_tile<T, D>(q_s, q + q_off, q_stride, q0, dm.sq, tid);
  load_tile<T, D>(do_s, dout + q_off, q_stride, q0, dm.sq, tid);
  if (tid < kTile) {
    lse_s[tid] = q0 + tid < dm.sq ? lse[row_at + tid] : 0.f;
    dl_s[tid] = 0.f;                    // pass 1 does not read it
  }
  const int k_end = causal ? min(dm.sk, q0 + kTile) : dm.sk;

  // pass 1: delta = rowsum(P * dP), each thread over its 4 columns of the
  // tile, then over the 16 threads of a row (a fixed butterfly)
  float rs[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();                    // the last tile's reads are done
    load_tile<T, D>(k_s, k + kv_off, kv_stride, k0, dm.sk, tid);
    load_tile<T, D>(v_s, v + kv_off, kv_stride, k0, dm.sk, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mm<4, 4, D>(s, q_s, LD, 1, k_s, 1, LD, tx, ty);
    mm<4, 4, D>(dp, do_s, LD, 1, v_s, 1, LD, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        if (row < dm.sq && key < dm.sk && !(causal && key > row))
          rs[i] = fmaf(expf(fmaf(s[i][j], scale, -lse_s[r])), dp[i][j], rs[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)   // lanes of one row: one half-warp
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], off);
    const int r = ty + 16 * i;
    if (tx == 0) {
      dl_s[r] = rs[i];
      if (q0 + r < dm.sq) delta[row_at + r] = rs[i];
    }
  }

  // pass 2: dQ = dS K * scale
  float dq_acc[4][TN];
  zero(dq_acc);
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();                    // the last tile's reads are done
    load_tile<T, D>(k_s, k + kv_off, kv_stride, k0, dm.sk, tid);
    load_tile<T, D>(v_s, v + kv_off, kv_stride, k0, dm.sk, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mm<4, 4, D>(s, q_s, LD, 1, k_s, 1, LD, tx, ty);
    mm<4, 4, D>(dp, do_s, LD, 1, v_s, 1, LD, tx, ty);
    softmax_grad(s, dp, nullptr, ds_s, lse_s, dl_s, q0, k0, dm.sq, dm.sk,
                 causal, scale, tx, ty);
    __syncthreads();
    mm<4, TN, kTile>(dq_acc, ds_s, kLDP, 1, k_s, LD, 1, tx, ty);  // dS K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= dm.sq) continue;
    T* dqr = dq + q_off + row * q_stride;
#pragma unroll
    for (int j = 0; j < TN; ++j)
      dqr[tx + 16 * j] = from_f32<T>(dq_acc[i][j] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  Dims dm;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
int launch(const Args& a) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);

  auto dqk = bwd_dq<T, D>;            // first: it writes delta
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 g1((a.dm.sq + kTile - 1) / kTile, a.dm.h, a.dm.b);
  dqk<<<g1, kThreads, smem, a.stream>>>(q, k, v, dout, lse, delta,
                                        static_cast<T*>(a.dq), a.dm, a.scale,
                                        a.causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  auto dkdv = bwd_dkdv<T, D>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 g2((a.dm.sk + kTile - 1) / kTile, a.dm.kh, a.dm.b);
  dkdv<<<g2, kThreads, smem, a.stream>>>(q, k, v, dout, lse, delta,
                                         static_cast<T*>(a.dk),
                                         static_cast<T*>(a.dv), a.dm, a.scale,
                                         a.causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const Args& a) {
  switch (d) {  // every multiple of 16 up to 128, each its own instantiation
#define REPRO_HEAD_DIM(D) \
    case D: return launch<T, D>(a);
    REPRO_HEAD_DIM(16) REPRO_HEAD_DIM(32) REPRO_HEAD_DIM(48) REPRO_HEAD_DIM(64)
    REPRO_HEAD_DIM(80) REPRO_HEAD_DIM(96) REPRO_HEAD_DIM(112) REPRO_HEAD_DIM(128)
#undef REPRO_HEAD_DIM
    default: return -3;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code if a launch was refused, or a
// negative code for an argument the kernels do not take: -1 dtype, -3 head
// dim, -5 shape.  dtype: 0 float32, 1 bfloat16.  delta: fp32 (B, H, Sq)
// scratch the first kernel fills.  Launches two kernels in order on
// `stream`: bwd_dq, then bwd_dkdv.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, void* delta,
                              void* dq,
                              void* dk, void* dv, int dtype, int device,
                              int b, int sq, int sk, int h, int kh, int d,
                              int causal, float scale, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || kh < 1 || h % kh != 0) return -5;
  if (dtype != 0 && dtype != 1) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{q, k, v, dout, lse, delta, dq, dk, dv,
               Dims{b, sq, sk, h, kh, h / kh}, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return dtype == 0 ? dispatch_d<float>(d, a) : dispatch_d<__nv_bfloat16>(d, a);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
