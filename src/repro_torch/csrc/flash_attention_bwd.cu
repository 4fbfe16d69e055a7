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
// Two pairs of kernels, chosen by dtype in repro_flash_attention_bwd (an
// explicit dispatch, not a fallback), as the forward chooses:
//   bfloat16 -> bwd_dq_wgmma, bwd_dkdv_wgmma: the products on the tensor
//               cores (wgmma), tiles fed by cp.async rings;
//   float32  -> bwd_dq, bwd_dkdv: fp32 FMAs on the CUDA cores, which keep
//               the 2e-5 fp32 tolerance that bf16 products would not.
// impl = 1 sends bf16 to bwd_dq / bwd_dkdv too, so a run can time the two
// on one card.
//
// bwd_dq, bwd_dkdv (CUDA cores).  A block of 256 threads works on 64 x 64
// tiles staged in shared memory as fp32, rows padded by one float so a
// column walk hits distinct banks.  Every product is C (+)= A B over
// shared-memory operands read through strides, so the transposes cost
// nothing: thread (tx, ty) = (t % 16, t / 16) owns rows ty + 16 i and
// columns tx + 16 j of C in registers.
//   bwd_dq (first): grid (q tiles, H, B), a causal head's heaviest q tile
//   first.  Q, dO and LSE stay staged; the block walks the KV tiles up to
//   its causal limit twice: once for its rows' delta (written out for
//   bwd_dkdv), then recomputing P and dS and accumulating dQ in registers.
//   bwd_dkdv (second): grid (KV tiles, KH, B), the heaviest (first) KV
//   tile first.  K and V stay staged; the block walks the q heads of its
//   GQA group and, for each, the q tiles that can see its keys (a causal
//   block starts at the diagonal), recomputing S and P, staging P and dS,
//   and accumulating dV and dK in registers.
//
// bwd_dq_wgmma, bwd_dkdv_wgmma (tensor cores).  The same two passes and
// the same blocks, a warpgroup (128 threads) owning 64 rows, wgmma's M: a
// block takes one or two warpgroups (block_q, block_k 64 or 128).  Every
// product is one of the forward's two forms (wgmma.cuh), so no operand is
// transposed through shared memory:
//   shared x shared, both K-major (mma_ss_n64): S = Q K^T and dP = dO V^T
//   in the dQ kernel; S^T = K Q^T and dP^T = V dO^T in the dK/dV kernel,
//   whose fragment rows are then keys;
//   registers x shared, B MN-major (MmaRS<D>): dQ += dS K, dV += P^T dO,
//   dK += dS^T Q, the A operand the bf16 packing of the score fragment
//   and B a tile stored (row, d), as V is in the forward's P V.
// P and dS are formed in fp32 on the accumulator fragment (ex2 with
// scale * log2(e) folded in, as the forward) and enter their products in
// bf16: as one rounding, or as hi + lo where a trained model's inputs
// showed the one rounding losing accuracy (kSplit*, below).  The dQ and
// dK/dV accumulators stay in registers for the whole block; K/V (dQ) or
// Q, dO and their LSE and delta rows (dK/dV) stream through a ring of
// kStages stages of 16-byte (rows) and 4-byte (LSE, delta: rows Sq floats
// apart) cp.async copies, which runs on across the GQA group's heads and
// from the dQ kernel's first pass into its second without draining.  Only
// the diagonal or ragged tile is masked.  The outputs are staged in the
// freed shared memory and written once as 16-byte pieces of rows.
//
// Bound on the H100: at the train path's (4, 1024, 15/5, 64) causal bf16,
// 5 products of 2 * d * (causal pairs) each a head, 20.2 GFLOP (20 us at
// 989 TFLOP/s bf16), against 18 MB of inputs and outputs (5 us): bound by
// operations.  The CUDA-core kernels run 9 products (with the delta pass
// and the recomputation) at the 67 TFLOP/s fp32 rate; the tensor-core
// kernels run the same 9, plus one for dS's lo part in dQ, at the bf16
// tensor-core rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

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


// --- bwd_dq_wgmma, bwd_dkdv_wgmma: bf16 on the tensor cores ----------------------

namespace wg {

using namespace hopper;
using hopper::load_tile;           // not the fp32 staging load_tile above
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;          // wgmma's M: a warpgroup's q rows or keys
constexpr int kAhead = 2;          // tiles copying while one computes
constexpr int kStages = kAhead + 1;
constexpr float kLog2e = 1.4426950408889634f;

// Whether each bf16 A operand enters its product as hi + lo (two products)
// or as one bf16 rounding; the plain version repeats the choice
// (flash_attention.py, WGMMA_BWD_SPLIT).  Chosen per product on a trained
// model's inputs (bench/attention_bwd_precision.py, PERF.md): one rounding
// of P or dS costs dV and dK about as much error as their own bf16 cast,
// but dS's rows sum to zero, so dQ = dS K cancels K's common part and
// keeps every term's rounding: there one rounding doubled dQ's error.
constexpr bool kSplitPdV = false;   // P^T in dV += P^T dO
constexpr bool kSplitDsDk = false;  // dS^T in dK += dS^T Q
constexpr bool kSplitDsDq = true;   // dS in dQ += dS K

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// Stage a warpgroup's 64 x D fp32 fragment times `mul` as bf16 rows of
// out_s (row stride LDO = D + 8: the 4 lanes of 8 rows hit 32 banks).
template <int D>
__device__ __forceinline__ void stage_rows(bf16* out_s, const float (&acc)[D / 2],
                                           float mul, int r0, int lane) {
  constexpr int LDO = D + 8;
  const int ra = r0 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(out_s + ra * LDO + col) =
        __floats2bfloat162_rn(acc[4 * i] * mul, acc[4 * i + 1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(out_s + (ra + 8) * LDO + col) =
        __floats2bfloat162_rn(acc[4 * i + 2] * mul, acc[4 * i + 3] * mul);
  }
}

// Write ROWS staged rows [row0, row0 + ROWS) of out_s to dst (row stride
// `stride` elements) as whole 16-byte pieces; rows at or past `limit` are
// not written.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void store_rows(bf16* dst, const bf16* out_s,
                                           long long stride, int row0,
                                           int limit, int tid) {
  constexpr int LDO = D + 8, PIECES = D / 8;
#pragma unroll
  for (int i = tid; i < ROWS * PIECES; i += NT) {
    const int r = i / PIECES, c = i % PIECES;
    if (row0 + r < limit)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * stride + 8 * c) =
          *reinterpret_cast<const uint4*>(out_s + r * LDO + 8 * c);
  }
}

// Dynamic shared memory of a block of wg warpgroups.  dQ (which 0): Q and
// dO, then the ring of (K, V) tiles; dK/dV (which 1): K and V, then the
// ring of (Q, dO) tiles and of the (LSE, delta) rows.
constexpr size_t smem_bytes(int which, int d, int wg) {
  return sizeof(bf16) * (size_t)(2 * kRows * wg * d + kStages * 2 * kRows * d)
         + (which == 1 ? sizeof(float) * (size_t)(kStages * 2 * kRows) : 0);
}

// One block a (KV tile of 64 * WG keys, KV head, batch); a warpgroup owns
// 64 keys, the M of every product.  The block walks (head of the GQA group,
// q tile of 64 rows) in that order through the ring; per q tile:
//   S^T = K Q^T, dP^T = V dO^T           (wgmma, both operands in shared)
//   P^T = exp(S^T scale - LSE), dS^T = P^T (dP^T - delta)   (fragment)
//   dV += P^T dO, dK += dS^T Q           (wgmma, A from registers)
// In these transposed fragments a thread's columns are q rows: LSE and
// delta are read per column from the staged rows, and the causal mask
// compares a column's q row with the fragment row's key.
template <int D, int WG>
__global__ void __launch_bounds__(WG * 128)
bwd_dkdv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, Dims dm,
               float scale, float scale_log2, int causal) {
  constexpr int BK = kRows * WG, NT = 128 * WG, QT = kRows * D;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + BK * D;
  bf16* ring = v_s + BK * D;                       // stage s: Q, then dO
  float* rows_s = reinterpret_cast<float*>(ring + kStages * 2 * QT);

  const int tid = threadIdx.x, wgi = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, bi = blockIdx.z;
  const int kw = k0 + kRows * wgi;                 // this warpgroup's keys
  const long long kv_stride = (long long)dm.kh * D;
  const long long q_stride = (long long)dm.h * D;
  const long long kv_off = ((long long)bi * dm.sk * dm.kh + kvh) * D;
  // a causal block starts at its diagonal q tile
  const int q_first = causal ? k0 : 0;
  const int n_q = q_first < dm.sq ? (dm.sq - q_first + kRows - 1) / kRows : 0;
  const int n_it = dm.group * n_q;

  // Q, dO and the LSE and delta rows of iteration `it` into its stage; the
  // rows are Sq floats apart, so not 16-byte aligned: 4-byte copies
  auto load_stage = [&](int it) {
    const int hh = it / n_q, q0 = q_first + (it - hh * n_q) * kRows;
    const int head = kvh * dm.group + hh;
    const long long q_off = ((long long)bi * dm.sq * dm.h + head) * D;
    bf16* st = ring + (it % kStages) * 2 * QT;
    load_tile<D, kRows, NT>(st, q + q_off, q_stride, q0, dm.sq, tid);
    load_tile<D, kRows, NT>(st + QT, dout + q_off, q_stride, q0, dm.sq, tid);
    const long long row_at = ((long long)bi * dm.h + head) * dm.sq;
    const uint32_t rs = smem_addr(rows_s + (it % kStages) * 2 * kRows);
    for (int i = tid; i < 2 * kRows; i += NT) {
      const int row = q0 + (i & (kRows - 1));
      const bool ok = row < dm.sq;
      cp_async_4(rs + 4 * i, (i < kRows ? lse : delta) + row_at + (ok ? row : 0),
                 ok);
    }
  };

  load_tile<D, BK, NT>(k_s, k + kv_off, kv_stride, k0, dm.sk, tid);
  load_tile<D, BK, NT>(v_s, v + kv_off, kv_stride, k0, dm.sk, tid);
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {   // one group a stage, maybe empty
    if (j < n_it) load_stage(j);
    cp_async_commit();
  }

  float dk_acc[D / 2], dv_acc[D / 2];
  zero(dk_acc);
  zero(dv_acc);
  const uint32_t k_addr = smem_addr(k_s) + kRows * wgi * D * 2;
  const uint32_t v_addr = smem_addr(v_s) + kRows * wgi * D * 2;
  const int key_a = kw + 16 * warp + (lane >> 2), key_b = key_a + 8;
  const int col0 = 2 * (lane & 3);
  const bool ragged = kw + kRows > dm.sk;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kAhead - 1>();                  // stage it has landed
    fence_proxy_async();
    __syncthreads();                              // every warpgroup is past it - 1
    if (it + kAhead < n_it) load_stage(it + kAhead);  // into it - 1's stage
    cp_async_commit();
    const int q0 = q_first + (it % n_q) * kRows;
    // a causal q tile wholly before these keys sees none of them
    if (causal && q0 + kRows - 1 < kw) continue;  // uniform in the warpgroup

    const int stage = it % kStages;
    const uint32_t q_addr = smem_addr(ring + stage * 2 * QT);
    const uint32_t do_addr = q_addr + QT * 2;
    const float* lse_s = rows_s + stage * 2 * kRows;
    const float* dl_s = lse_s + kRows;
    float s[32], dp[32];
    zero(s);
    zero(dp);
    pin(s);
    pin(dp);
    wgmma_fence();
    mma_scores<D>(s, k_addr, q_addr);             // S^T = K Q^T
    mma_scores<D>(dp, v_addr, do_addr);           // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(dp);

    if (ragged || (causal && kw + kRows - 1 > q0)) {   // diagonal or past sk
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = (i & 2) ? key_b : key_a;
        const int qp = q0 + 8 * (i >> 2) + col0 + (i & 1);
        if (key >= dm.sk || (causal && key > qp)) s[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {                 // columns 8 j + col0, + 1
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + col0);
      const float2 d2 = *reinterpret_cast<const float2*>(dl_s + 8 * j + col0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float p = ex2(fmaf(s[i], scale_log2,
                                 -((e & 1) ? l2.y : l2.x) * kLog2e));
        s[i] = p;
        dp[i] = p * (dp[i] - ((e & 1) ? d2.y : d2.x));
      }
    }
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
    to_a<kSplitPdV>(s, p_hi, p_lo);
    to_a<kSplitDsDk>(dp, ds_hi, ds_lo);
    pin(dk_acc);
    pin(dv_acc);
    pin_a<kSplitPdV>(p_hi, p_lo);
    pin_a<kSplitDsDk>(ds_hi, ds_lo);
    wgmma_fence();
    mma_rs_tile<D, kSplitPdV>(dv_acc, p_hi, p_lo, do_addr);     // dV += P^T dO
    mma_rs_tile<D, kSplitDsDk>(dk_acc, ds_hi, ds_lo, q_addr);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait_all();
    pin(dk_acc);
    pin(dv_acc);
  }

  // dK * scale and dV, staged in the freed shared memory, written once as
  // whole 16-byte pieces of rows
  cp_async_wait<0>();                             // with no q tile, K and V
  __syncthreads();                                // every wgmma is done
  bf16* dk_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* dv_s = dk_s + BK * (D + 8);
  stage_rows<D>(dk_s, dk_acc, scale, kRows * wgi + 16 * warp, lane);
  stage_rows<D>(dv_s, dv_acc, 1.f, kRows * wgi + 16 * warp, lane);
  __syncthreads();
  store_rows<D, BK, NT>(dk + kv_off, dk_s, kv_stride, k0, dm.sk, tid);
  store_rows<D, BK, NT>(dv + kv_off, dv_s, kv_stride, k0, dm.sk, tid);
}

// One block a (q tile of 64 * WG rows, head, batch); a warpgroup owns 64 q
// rows.  Q and dO are staged once; K/V tiles of 64 keys stream through the
// ring twice without draining it:
//   pass 1: S = Q K^T, dP = dO V^T, delta = rowsum(P dP), written out
//   pass 2: S, dP again, dS = P (dP - delta), dQ += dS K (A from registers)
// A causal head runs its heaviest q tile first, and a causal warpgroup
// skips the tiles wholly past its rows.
template <int D, int WG>
__global__ void __launch_bounds__(WG * 128)
bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ delta,
             bf16* __restrict__ dq, Dims dm, float scale, float scale_log2,
             int causal) {
  constexpr int BQ = kRows * WG, NT = 128 * WG, KT = kRows * D;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + BQ * D;
  bf16* ring = do_s + BQ * D;                      // stage s: K, then V

  const int tid = threadIdx.x, wgi = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int head = blockIdx.y, bi = blockIdx.z, kvh = head / dm.group;
  const int q0 = tile * BQ, qw = q0 + kRows * wgi;
  const long long kv_stride = (long long)dm.kh * D;
  const long long q_stride = (long long)dm.h * D;
  const long long kv_off = ((long long)bi * dm.sk * dm.kh + kvh) * D;
  const long long q_off = ((long long)bi * dm.sq * dm.h + head) * D;
  const long long row_at = ((long long)bi * dm.h + head) * dm.sq;
  const int k_end = causal ? min(dm.sk, q0 + BQ) : dm.sk;
  const int n_tiles = (k_end + kRows - 1) / kRows;
  // a causal warpgroup stops at the tile that holds its last row's key
  const int my_tiles = causal ? min(n_tiles, qw / kRows + 1) : n_tiles;
  const int n_it = 2 * n_tiles;                    // pass 1, then pass 2

  auto load_stage = [&](int it) {
    const int j = it < n_tiles ? it : it - n_tiles;
    bf16* st = ring + (it % kStages) * 2 * KT;
    load_tile<D, kRows, NT>(st, k + kv_off, kv_stride, j * kRows, dm.sk, tid);
    load_tile<D, kRows, NT>(st + KT, v + kv_off, kv_stride, j * kRows, dm.sk,
                            tid);
  };
  load_tile<D, BQ, NT>(q_s, q + q_off, q_stride, q0, dm.sq, tid);
  load_tile<D, BQ, NT>(do_s, dout + q_off, q_stride, q0, dm.sq, tid);
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < n_it) load_stage(j);
    cp_async_commit();
  }

  const int row_a = qw + 16 * warp + (lane >> 2), row_b = row_a + 8;
  const int col0 = 2 * (lane & 3);
  // rows past sq: Q and dO are zeros, so any finite LSE gives finite terms
  const float lse_a = row_a < dm.sq ? lse[row_at + row_a] * kLog2e : 0.f;
  const float lse_b = row_b < dm.sq ? lse[row_at + row_b] * kLog2e : 0.f;
  const uint32_t q_addr = smem_addr(q_s) + kRows * wgi * D * 2;
  const uint32_t do_addr = smem_addr(do_s) + kRows * wgi * D * 2;
  float rs_a = 0.f, rs_b = 0.f;                    // pass 1: this thread's columns
  float dl_a = 0.f, dl_b = 0.f;                    // pass 2: the rows' delta
  float dq_acc[D / 2];
  zero(dq_acc);

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    if (it + kAhead < n_it) load_stage(it + kAhead);
    cp_async_commit();
    if (it == n_tiles) {                           // pass 1 is done
      dl_a = quad_sum(rs_a);                       // the 4 lanes of a row
      dl_b = quad_sum(rs_b);
      if ((lane & 3) == 0) {
        if (row_a < dm.sq) delta[row_at + row_a] = dl_a;
        if (row_b < dm.sq) delta[row_at + row_b] = dl_b;
      }
    }
    const int j = it < n_tiles ? it : it - n_tiles;
    if (j >= my_tiles) continue;                   // uniform in the warpgroup

    const uint32_t k_addr = smem_addr(ring + (it % kStages) * 2 * KT);
    const uint32_t v_addr = k_addr + KT * 2;
    float s[32], dp[32];
    zero(s);
    zero(dp);
    pin(s);
    pin(dp);
    wgmma_fence();
    mma_scores<D>(s, q_addr, k_addr);              // S = Q K^T
    mma_scores<D>(dp, do_addr, v_addr);            // dP = dO V^T
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(dp);

    const int k0 = j * kRows;
    if (k0 + kRows > dm.sk || (causal && k0 + kRows - 1 > qw)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {               // the diagonal or ragged tile
        const int key = k0 + 8 * (i >> 2) + col0 + (i & 1);
        const int row = (i & 2) ? row_b : row_a;
        if (key >= dm.sk || (causal && key > row)) s[i] = -INFINITY;
      }
    }
    if (it < n_tiles) {                            // pass 1
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool b = i & 2;
        const float p = ex2(fmaf(s[i], scale_log2, -(b ? lse_b : lse_a)));
        if (b) rs_b = fmaf(p, dp[i], rs_b);
        else rs_a = fmaf(p, dp[i], rs_a);
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {                 // pass 2: dS in place of dP
      const bool b = i & 2;
      const float p = ex2(fmaf(s[i], scale_log2, -(b ? lse_b : lse_a)));
      dp[i] = p * (dp[i] - (b ? dl_b : dl_a));
    }
    uint32_t ds_hi[4][4], ds_lo[4][4];
    to_a<kSplitDsDq>(dp, ds_hi, ds_lo);
    pin(dq_acc);
    pin_a<kSplitDsDq>(ds_hi, ds_lo);
    wgmma_fence();
    mma_rs_tile<D, kSplitDsDq>(dq_acc, ds_hi, ds_lo, k_addr);    // dQ += dS K
    wgmma_commit();
    wgmma_wait_all();
    pin(dq_acc);
  }

  cp_async_wait<0>();
  __syncthreads();                                 // every wgmma is done
  bf16* dq_s = reinterpret_cast<bf16*>(smem_raw);
  stage_rows<D>(dq_s, dq_acc, scale, kRows * wgi + 16 * warp, lane);
  __syncthreads();
  store_rows<D, BQ, NT>(dq + q_off, dq_s, q_stride, q0, dm.sq, tid);
}

template <int D, int WG>
int launch_dq(const Args& a) {
  constexpr size_t smem = smem_bytes(0, D, WG);
  auto kern = bwd_dq_wgmma<D, WG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.dm.sq + kRows * WG - 1) / (kRows * WG), a.dm.h, a.dm.b);
  kern<<<grid, WG * 128, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<float*>(a.delta),
      static_cast<bf16*>(a.dq), a.dm, a.scale, a.scale * kLog2e, a.causal);
  return (int)cudaGetLastError();
}

template <int D, int WG>
int launch_dkdv(const Args& a) {
  constexpr size_t smem = smem_bytes(1, D, WG);
  auto kern = bwd_dkdv_wgmma<D, WG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.dm.sk + kRows * WG - 1) / (kRows * WG), a.dm.kh, a.dm.b);
  kern<<<grid, WG * 128, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.dm, a.scale,
      a.scale * kLog2e, a.causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Args& a, int block_q, int block_k) {
  // bwd_dq_wgmma first: it writes delta
  const int rc = block_q == 64 ? launch_dq<D, 1>(a) : launch_dq<D, 2>(a);
  if (rc != 0) return rc;
  return block_k == 64 ? launch_dkdv<D, 1>(a) : launch_dkdv<D, 2>(a);
}

int dispatch_d(int d, const Args& a, int block_q, int block_k) {
  switch (d) {
#define REPRO_HEAD_DIM(D) \
    case D: return launch<D>(a, block_q, block_k);
    REPRO_HEAD_DIM(16) REPRO_HEAD_DIM(32) REPRO_HEAD_DIM(48) REPRO_HEAD_DIM(64)
    REPRO_HEAD_DIM(80) REPRO_HEAD_DIM(96) REPRO_HEAD_DIM(112) REPRO_HEAD_DIM(128)
#undef REPRO_HEAD_DIM
    default: return -3;
  }
}

size_t smem_of(int which, int d, int block) {
  if (d % 16 || d < 16 || d > 128 || (block != 64 && block != 128)
      || (which != 0 && which != 1))
    return 0;
  return smem_bytes(which, d, block / kRows);
}

}  // namespace wg
}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code if a launch was refused, or a
// negative code for an argument the kernels do not take: -1 dtype, -2
// block_q, -3 head dim, -4 block_k, -5 shape, -6 impl.  dtype: 0 float32,
// 1 bfloat16.  impl: 0 by dtype (bfloat16 -> bwd_dq_wgmma and
// bwd_dkdv_wgmma, block_q and block_k 64 or 128; float32 -> bwd_dq and
// bwd_dkdv, both 64), 1 bwd_dq and bwd_dkdv for either dtype (both 64).
// delta: fp32 (B, H, Sq) scratch the first kernel fills.  Launches two
// kernels in order on `stream`: the dQ kernel, then the dK/dV kernel.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, void* delta,
                              void* dq, void* dk, void* dv, int dtype,
                              int impl, int device, int b, int sq, int sk,
                              int h, int kh, int d, int block_q, int block_k,
                              int causal, float scale, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || kh < 1 || h % kh != 0) return -5;
  if (dtype != 0 && dtype != 1) return -1;
  if (impl != 0 && impl != 1) return -6;
  const bool tensor_cores = dtype == 1 && impl == 0;
  if (tensor_cores ? block_q != 64 && block_q != 128 : block_q != kTile)
    return -2;
  if (tensor_cores ? block_k != 64 && block_k != 128 : block_k != kTile)
    return -4;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{q, k, v, dout, lse, delta, dq, dk, dv,
               Dims{b, sq, sk, h, kh, h / kh}, scale, causal,
               static_cast<cudaStream_t>(stream)};
  if (tensor_cores) return wg::dispatch_d(d, a, block_q, block_k);
  return dtype == 0 ? dispatch_d<float>(d, a) : dispatch_d<__nv_bfloat16>(d, a);
}

// Dynamic shared memory of one tensor-core block (which: 0 bwd_dq_wgmma
// with block = block_q, 1 bwd_dkdv_wgmma with block = block_k; 0 for a
// shape they do not take).
long long repro_flash_attention_bwd_wgmma_smem(int which, int d, int block) {
  return (long long)wg::smem_of(which, d, block);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
