// Flash attention forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces repro/kernels/flash_attention.py::_kernel (the Pallas
// FlashAttention-2 forward; its wrapper flash_attention, pallas_call at
// :146).  Same function: S = (Q K^T) * 1/sqrt(d) with an fp32 sum; a causal
// mask k_pos > q_pos, top-left aligned; keys at or past sk masked; fp32
// running max, sum and accumulator; the output cast once to q's dtype.
//
// Layout.  q: (B, Sq, H, D), k/v: (B, Sk, KH, D), o: (B, Sq, H, D), each read
// through its (batch, seq, head) strides with a contiguous last dim, so the
// caller needs none of the reference's transposes.  GQA reads KV head
// h / (H / KH) in place of the reference's jnp.repeat copy.  Head dims: every
// multiple of 16 up to 128, each a template instantiation.
//
// Two kernels, chosen by dtype in repro_flash_attention_fwd (an explicit
// dispatch, not a fallback):
//   bfloat16 -> flash_fwd_wgmma, the products on the tensor cores (wgmma);
//   float32  -> flash_fwd, the products as fp32 FMAs on the CUDA cores.  The
//               Pallas kernel's fp32 products meet the reference tolerance of
//               2e-5; TF32 or bf16 tensor-core products would not.
// impl = 1 sends bf16 to flash_fwd too, so a run can time the two on one card.
//
// Row LSE.  With a non-null `lse` (fp32, (B, H, Sq)) both kernels also write
// each row's log-sum-exp of its scaled, masked scores from the epilogue,
// m + log(l) from the running max and sum they already hold: what the
// backward (flash_attention_bwd.cu) needs to recompute P.  A null pointer
// skips those stores and nothing else, so O is bit for bit what it is
// without them.
//
// Bounds on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   serve shape (8, 512, 15/5, 64) causal bf16: 21 MB of q, k, v, o (6.3 us)
//   against 4.0 GFLOP of causal products (4.1 us): bound by bytes.
//   calibrate shape (1, 2048, 120/120, 64) causal bf16: 64.4 GFLOP (65 us)
//   against 126 MB (38 us): bound by operations.
//
// flash_fwd_wgmma.  One consumer warpgroup (128 threads) owns 64 query rows,
// wgmma's M; a block holds one or two (block_q 64 or 128).  Grid (q tiles, H,
// B) with the q tile fastest, so the tiles of one (head, batch) run together
// and share its K/V in the L2; a causal head starts with its heaviest tile.
// Q is staged once in shared memory.  K and V arrive by 16-byte cp.async
// copies (a warp reads whole rows; rows past sk are zero-filled by a source
// size of 0) into a ring of kAhead + 1 stages: tiles j + 1 .. j + kAhead
// copying while tile j is read.
//   S = Q K^T: wgmma m64n64k16, both operands from shared memory, D / 16
//   k-steps; K stored (key, d) is already the K-major B operand.
//   Online softmax on the accumulator fragment in registers: a row's 16
//   values a thread are reduced over the 4 lanes that share the row by
//   shuffles; only the diagonal tile and a tile past sk take the mask.  One
//   FFMA and one ex2.approx a score: the max is taken on the raw scores
//   (the scale is positive) and scale * log2(e) is folded into the exponent;
//   the plain version keeps exp, and the two agree to fp32 rounding.  Tile 0,
//   which holds key 0, comes first, so the running max is finite before any
//   masked key.  A warpgroup skips the tiles wholly past its causal limit.
//   O += P V: P is the register A operand (the S fragment is the A
//   fragment), V stored (key, d) the MN-major B operand (transpose bit,
//   allowed for 16-bit types), n = D.  The A operand is bf16, so P goes in
//   as two parts: hi, its bf16 rounding, and lo, the bf16 rounding of
//   p - hi (exact in fp32); hi + lo is within 2^-17 p of p.  A single bf16
//   P (one product instead of two) moved the bf16 model's k cache past the
//   reference's 2e-2 beside the Pallas kernel, which keeps P in fp32.  The
//   plain version repeats the split.
//   The output is staged in the freed ring and written as whole 16-byte
//   pieces of rows.
//   The wgmma, cp.async and tile-copy helpers are in wgmma.cuh, shared
//   with the backward.
//   Shared memory layout: the no-swizzle ("interleave") core-matrix layout
//   for every head dim.  A core matrix is 8 rows x 16 bytes, stored as 128
//   contiguous bytes; the 8-row groups of a tile follow each other, D * 16
//   bytes apart, and inside a group the D / 8 core matrices along d are 128
//   bytes apart.  A row of D = 16..112 is not a multiple of 128 bytes, so
//   the 128-byte swizzle could not take those head dims; this layout takes
//   all eight with one descriptor rule.  (Grouping the 8-row groups of one
//   d-piece together instead timed the same.)
//   Against the bounds: both products run on the tensor cores instead of
//   the 67 TFLOP/s fp32 units, which is what the operation-bound calibrate
//   shape needed; at the byte-bound serve shape the 6.3 us is below a
//   block's latency, so what counts is the length of a block's tile loop.
//   Measured (bench/attention_ablations.py), the tile loop's own path sets
//   the time, not the bytes or the operations: the loop that only copies
//   K/V and meets at the block barrier takes most of it, while deeper
//   prefetch (1 to 4 tiles), other copy mappings, removing the waits, the
//   exponentials, and overlapping one tile's P V with the next one's
//   softmax changed little or nothing.  A TMA producer warp with setmaxnreg,
//   ping-pong between warpgroups and a persistent grid are the next stages.
//
// flash_fwd (fp32).  One block of 4 warps per (q tile of BQ = 4 * ROWS rows,
// head, batch); each warp owns ROWS query rows.  The block loops over 64-key
// K/V tiles staged in shared memory as fp32 and stops at the causal limit of
// its q tile.  A lane owns keys lane and lane + 32 of a tile for the scores
// and output dims lane + 32 * c for the P V product.  K rows are read as
// float4 and reused by all ROWS rows of a warp; the K/V tiles are padded by
// 4 floats a row so the float4 reads of 8 lanes hit distinct banks.  It is
// bound by operations at the 67 TFLOP/s fp32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

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
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int sq, int sk,
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
    if (lse != nullptr && lane == 0)  // m is in the scaled units here
      lse[((long long)batch * gridDim.y + head) * sq + qp] = m[r] + logf(l[r]);
  }
}

template <typename T, int D, int ROWS>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int sk, int h, int kh, const Strides& qs,
           const Strides& ks, const Strides& vs, const Strides& os,
           float scale, int causal, cudaStream_t stream) {
  constexpr int BQ = ROWS * kWarps;
  constexpr size_t smem = smem_bytes<D, ROWS>();
  auto kern = flash_fwd<T, D, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, h / kh, qs,
      ks, vs, os, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_rows(int block_q, const void* q, const void* k, const void* v,
                  void* o, float* lse, int b, int sq, int sk, int h, int kh,
                  const Strides& qs, const Strides& ks, const Strides& vs,
                  const Strides& os, float scale, int causal,
                  cudaStream_t stream) {
  switch (block_q) {
    case 16: return launch<T, D, 4>(q, k, v, o, lse, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, stream);
    case 32: return launch<T, D, 8>(q, k, v, o, lse, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, stream);
    default: return -2;
  }
}

template <typename T>
int dispatch_d(int d, int block_q, const void* q, const void* k,
               const void* v, void* o, float* lse, int b, int sq, int sk,
               int h, int kh, const Strides& qs, const Strides& ks,
               const Strides& vs, const Strides& os, float scale, int causal,
               cudaStream_t stream) {
  switch (d) {  // every multiple of 16 up to 128, each its own instantiation
#define REPRO_HEAD_DIM(D) \
    case D: return dispatch_rows<T, D>(block_q, q, k, v, o, lse, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, stream);
    REPRO_HEAD_DIM(16) REPRO_HEAD_DIM(32) REPRO_HEAD_DIM(48) REPRO_HEAD_DIM(64)
    REPRO_HEAD_DIM(80) REPRO_HEAD_DIM(96) REPRO_HEAD_DIM(112) REPRO_HEAD_DIM(128)
#undef REPRO_HEAD_DIM
    default: return -3;
  }
}


// --- flash_fwd_wgmma: bf16 on the tensor cores ---------------------------------

namespace wg {

using namespace hopper;

constexpr int kAhead = 2;                  // K/V tiles copying while one computes
constexpr int kStages = kAhead + 1;        // ring: tile j and the copies
constexpr float kLog2e = 1.4426950408889634f;

// dynamic shared memory of a block: the Q tile and the K/V ring
constexpr size_t smem_bytes(int d, int block_q) {
  return sizeof(__nv_bfloat16) * (size_t)d * (block_q + kStages * 2 * kBlockK);
}

// Keys 16 kk .. 16 kk + 15 of S, registers 8 kk .. 8 kk + 7 of its
// accumulator fragment (wgmma.cuh), are the A fragment of P V's k-step kk.
template <int D, int WG>
__global__ void __launch_bounds__(WG * 128)
flash_fwd_wgmma(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int sq, int sk, int group,
                Strides qs, Strides ks, Strides vs, Strides os,
                float scale_log2, int causal) {
  constexpr int BQ = 64 * WG, NT = 128 * WG;
  constexpr int KV_TILE = kBlockK * D;          // elements of one K or V tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv_s = q_s + BQ * D;           // stage s: K, then V

  // x is the fastest index, so the q tiles of one (head, batch) run together
  // and share its K/V in the L2; a causal head runs its heaviest tile first
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int tid = threadIdx.x, wgi = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  const int q0 = tile * BQ, kv_head = head / group;
  const __nv_bfloat16* qb = q + batch * qs.b + head * qs.h;
  const __nv_bfloat16* kb = k + batch * ks.b + kv_head * ks.h;
  const __nv_bfloat16* vb = v + batch * vs.b + kv_head * vs.h;

  const int k_end = causal ? min(sk, q0 + BQ) : sk;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;
  const int qw = q0 + 64 * wgi;                 // this warpgroup's first row
  // a causal warpgroup stops at the tile that holds its last row's key
  const int my_tiles =
      causal ? min(n_tiles, (qw + 63) / kBlockK + 1) : n_tiles;
  const int row_a = qw + 16 * warp + (lane >> 2), row_b = row_a + 8;
  const uint32_t q_addr = smem_addr(q_s) + 64 * wgi * D * 2;
  load_tile<D, BQ, NT>(q_s, qb, qs.s, q0, sq, tid);
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {            // one group a tile, maybe empty
    if (j < n_tiles) {
      load_tile<D, kBlockK, NT>(kv_s + 2 * j * KV_TILE, kb, ks.s, j * kBlockK,
                                sk, tid);
      load_tile<D, kBlockK, NT>(kv_s + (2 * j + 1) * KV_TILE, vb, vs.s,
                                j * kBlockK, sk, tid);
    }
    cp_async_commit();
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kAhead - 1>();                // tile j (and Q) has landed
    fence_proxy_async();
    __syncthreads();                            // every warpgroup is past j - 1
    if (j + kAhead < n_tiles) {                 // into tile j - 1's stage
      const int ahead = j + kAhead;
      __nv_bfloat16* nxt = kv_s + (ahead % kStages) * 2 * KV_TILE;
      load_tile<D, kBlockK, NT>(nxt, kb, ks.s, ahead * kBlockK, sk, tid);
      load_tile<D, kBlockK, NT>(nxt + KV_TILE, vb, vs.s, ahead * kBlockK, sk,
                                tid);
    }
    cp_async_commit();
    if (j >= my_tiles) continue;                // uniform in the warpgroup

    const uint32_t k_addr = smem_addr(kv_s + (j % kStages) * 2 * KV_TILE);
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    wgmma_fence();
    mma_scores<D>(s, q_addr, k_addr);           // S = Q K^T
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    const int k0 = j * kBlockK;
    if (k0 + kBlockK > sk || (causal && k0 + kBlockK - 1 > qw)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {            // the diagonal or ragged tile
        const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int row = (i & 2) ? row_b : row_a;
        if (key >= sk || (causal && key > row)) s[i] = -INFINITY;
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * n], s[4 * n + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    // the scale is positive, so the max of raw scores is the max of scaled
    mx_a = fmaxf(m_a, quad_max(mx_a) * scale_log2);
    mx_b = fmaxf(m_b, quad_max(mx_b) * scale_log2);
    const float corr_a = ex2(m_a - mx_a), corr_b = ex2(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[4 * n] = ex2(fmaf(s[4 * n], scale_log2, -mx_a));
      s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], scale_log2, -mx_a));
      s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], scale_log2, -mx_b));
      s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], scale_log2, -mx_b));
      sum_a += s[4 * n] + s[4 * n + 1];
      sum_b += s[4 * n + 2] + s[4 * n + 3];
    }
    l_a = l_a * corr_a + sum_a;                 // this thread's columns only
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[4 * i] *= corr_a;
      acc[4 * i + 1] *= corr_a;
      acc[4 * i + 2] *= corr_b;
      acc[4 * i + 3] *= corr_b;
    }
    // P = hi + lo, both bf16, so P V keeps P to about 16 bits
    uint32_t hi[4][4], lo[4][4];
    to_a<true>(s, hi, lo);
    pin(acc);
    pin_a<true>(hi, lo);
    wgmma_fence();
    mma_rs_tile<D, true>(acc, hi, lo,             // O += P V
                         smem_addr(kv_s + (j % kStages) * 2 * KV_TILE
                                   + KV_TILE));
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  if (lse != nullptr && (lane & 3) == 0) {  // m, log2(l) in base-2 units
    constexpr float kLn2 = 0.6931471805599453f;
    float* lrow = lse + ((long long)batch * gridDim.y + head) * sq;
    if (row_a < sq) lrow[row_a] = (m_a + log2f(l_a)) * kLn2;
    if (row_b < sq) lrow[row_b] = (m_b + log2f(l_b)) * kLn2;
  }
  // Stage O in the freed ring (one stage a warpgroup, rows padded by 16
  // bytes so the 4 lanes of 8 rows hit 32 banks), then write whole 16-byte
  // pieces of each row: a warp stores full lines instead of 4-byte pairs.
  __syncthreads();                              // every wgmma is done
  constexpr int LDO = D + 8;
  __nv_bfloat16* o_s = kv_s + wgi * 2 * KV_TILE;
  const int ra = 16 * warp + (lane >> 2);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(o_s + ra * LDO + col) =
        __floats2bfloat162_rn(acc[4 * i] * inv_a, acc[4 * i + 1] * inv_a);
    *reinterpret_cast<__nv_bfloat162*>(o_s + (ra + 8) * LDO + col) =
        __floats2bfloat162_rn(acc[4 * i + 2] * inv_b, acc[4 * i + 3] * inv_b);
  }
  __syncthreads();
  __nv_bfloat16* ob = o + batch * os.b + head * os.h;
#pragma unroll
  for (int i = t; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8), c = i % (D / 8);
    if (qw + r < sq)
      *reinterpret_cast<uint4*>(ob + (qw + r) * os.s + 8 * c) =
          *reinterpret_cast<const uint4*>(o_s + r * LDO + 8 * c);
  }
}

template <int D, int WG>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int sk, int h, int kh, const Strides& qs,
           const Strides& ks, const Strides& vs, const Strides& os,
           float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(D, 64 * WG);
  auto kern = flash_fwd_wgmma<D, WG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + 64 * WG - 1) / (64 * WG), h, b);
  kern<<<grid, WG * 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      sq, sk, h / kh, qs, ks, vs, os, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_rows(int block_q, const void* q, const void* k, const void* v,
                  void* o, float* lse, int b, int sq, int sk, int h, int kh,
                  const Strides& qs, const Strides& ks, const Strides& vs,
                  const Strides& os, float scale, int causal,
                  cudaStream_t stream) {
  switch (block_q) {
    case 64: return launch<D, 1>(q, k, v, o, lse, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, stream);
    case 128: return launch<D, 2>(q, k, v, o, lse, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, stream);
    default: return -2;
  }
}

int dispatch_d(int d, int block_q, const void* q, const void* k,
               const void* v, void* o, float* lse, int b, int sq, int sk,
               int h, int kh, const Strides& qs, const Strides& ks,
               const Strides& vs, const Strides& os, float scale, int causal,
               cudaStream_t stream) {
  switch (d) {
#define REPRO_HEAD_DIM(D) \
    case D: return dispatch_rows<D>(block_q, q, k, v, o, lse, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, stream);
    REPRO_HEAD_DIM(16) REPRO_HEAD_DIM(32) REPRO_HEAD_DIM(48) REPRO_HEAD_DIM(64)
    REPRO_HEAD_DIM(80) REPRO_HEAD_DIM(96) REPRO_HEAD_DIM(112) REPRO_HEAD_DIM(128)
#undef REPRO_HEAD_DIM
    default: return -3;
  }
}

size_t smem_of(int d, int block_q) {
  if (d % 16 || d < 16 || d > 128 || (block_q != 64 && block_q != 128))
    return 0;
  return smem_bytes(d, block_q);
}

}  // namespace wg
}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code if the launch was refused, or a
// negative code for an argument the kernel does not take: -1 dtype,
// -2 block_q, -3 head dim, -4 block_k, -5 impl.  dtype: 0 float32,
// 1 bfloat16.  impl: 0 by dtype (bfloat16 -> flash_fwd_wgmma with block_q
// 64 or 128, float32 -> flash_fwd with block_q 16 or 32), 1 flash_fwd for
// either dtype (block_q 16 or 32).  lse: null, or fp32 (B, H, Sq) that
// receives each row's log-sum-exp.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int dtype, int impl,
                              int device, int b,
                              int sq, int sk, int h, int kh, int d,
                              int block_q, int block_k, long long q_sb,
                              long long q_ss, long long q_sh, long long k_sb,
                              long long k_ss, long long k_sh, long long v_sb,
                              long long v_ss, long long v_sh, long long o_sb,
                              long long o_ss, long long o_sh, int causal,
                              float scale, void* stream) {
  if (block_k != kBlockK) return -4;
  if (impl != 0 && impl != 1) return -5;
  if (dtype != 0 && dtype != 1) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_d<float>(d, block_q, q, k, v, o, l, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, st);
  if (impl == 1)
    return dispatch_d<__nv_bfloat16>(d, block_q, q, k, v, o, l, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, st);
  return wg::dispatch_d(d, block_q, q, k, v, o, l, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, st);
}

// Dynamic shared memory of one flash_fwd_wgmma block (0 for a shape it does
// not take).
long long repro_flash_attention_wgmma_smem(int d, int block_q) {
  return (long long)wg::smem_of(d, block_q);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
