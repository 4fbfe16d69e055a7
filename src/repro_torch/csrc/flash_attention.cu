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
// flash_fwd (fp32 FMAs on the CUDA cores).  Bound by operations: 64.5 GFLOP
// at the calibrate shape is 0.962 ms at the 67 TFLOP/s fp32 rate, so the
// design keeps the FMA pipe fed from registers.
//   A block of 2 * BQ threads (BQ / 16 warps) owns a q tile of BQ = 64 or
//   128 rows; warp w owns rows 16 w .. 16 w + 15, and a thread (half h =
//   lane / 16, key group g = lane % 16) the 8 rows 16 w + 2 r + h in both
//   products, so m, l and the rescale of its O rows stay in its registers.
//   S: the thread holds 8 rows x 4 keys (g + 16 i).  Each 4-wide d step
//   reads 8 q float4s (a broadcast: 16 lanes share a row) and 4 K float4s
//   for 128 FMAs.  A row's max takes 4 shuffles inside the half-warp; l is
//   kept per thread and summed once, in the epilogue.
//   O += P V: the thread holds the same 8 rows x D / 16 dims (chunks of 4,
//   2 or 1 consecutive dims, 16 lanes side by side, so every V read is a
//   whole line); P goes through shared memory (rows private to the warp,
//   so __syncwarp suffices), and each 4-key step reads 8 broadcast P
//   float4s and 4 V rows for 8 x 4 x D / 16 FMAs.  Staged rows are padded
//   by 16 bytes, so the 16 distinct K rows a read touches, and the two q
//   or P rows of a warp, fall on distinct banks.
//   K and V arrive by 16-byte cp.async copies (wgmma.cuh's; rows past sk
//   zero-filled by a source size of 0), each thread copying the same piece
//   of every few rows.  One stage (kKvStages): at block_q 64 and D <= 64 a
//   block takes at most 71 KB and 170 registers a thread, so three blocks
//   share an SM and one block's copy overlaps the others' products.  Tile
//   j + 1 in flight inside the block (two stages, 105 KB at D 64, two
//   blocks an SM) and a thread tile of 8 x 8 (nearly every register a
//   thread may have) both timed slower.  bf16 under impl = 1 stages the
//   bf16 bytes and converts when it reads them.
//   Only the diagonal tiles and the tile holding sk take the mask; a
//   causal warp skips the tiles wholly past its last row.  One FFMA and
//   one ex2.approx a score, as in flash_fwd_wgmma (the max is taken on the
//   raw scores; tile 0, which holds key 0, comes first, so the running max
//   is finite); the LSE goes back to natural-log units in the epilogue.
//   Grid (q tiles, H, B), the q tile fastest, a causal head's heaviest tile
//   first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kBlockK = 64;
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, s, h;  // elements; the last dim is contiguous
};

// --- flash_fwd: fp32 FMAs on the CUDA cores ------------------------------------

namespace cc {

using namespace hopper;

constexpr int kRows = 8;             // query rows a thread owns
constexpr int kKvStages = 1;         // K/V tiles staged (see the header)
constexpr int kPLd = kBlockK + 16;   // P row stride: rows 2r, 2r + 1 16 banks apart
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// dynamic shared memory of a block: the Q tile and the K/V stages, rows
// padded by 16 bytes, then P (fp32)
template <typename T>
constexpr size_t smem_bytes(int d, int block_q) {
  return sizeof(T) * (size_t)(d + 16 / sizeof(T))
             * (block_q + kKvStages * 2 * kBlockK)
         + sizeof(float) * (size_t)block_q * kPLd;
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(2 * BQ, BQ == 64 && D <= 64 ? 3 : 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int sq, int sk, int group,
          Strides qs, Strides ks, Strides vs, Strides os,
          float scale_log2, int causal) {
  constexpr int NT = 2 * BQ;
  constexpr int LD = D + 16 / (int)sizeof(T);   // staged row stride (elements)
  constexpr int KV_TILE = kBlockK * LD;
  constexpr int N = D / 16;                     // O dims a thread owns
  constexpr int VW = N % 4 == 0 ? 4 : N % 2 == 0 ? 2 : 1;
  constexpr int NC = N / VW;                    // chunks of VW dims, 16 VW apart
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* kv_s = q_s + BQ * LD;                      // stage s: K, then V
  float* p_s = reinterpret_cast<float*>(kv_s + kKvStages * 2 * KV_TILE);

  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, kg = lane & 15;
  const int q0 = tile * BQ, kv_head = head / group;
  const T* qb = q + batch * qs.b + head * qs.h;
  const T* kb = k + batch * ks.b + kv_head * ks.h;
  const T* vb = v + batch * vs.b + kv_head * vs.h;

  const int k_end = causal ? min(sk, q0 + BQ) : sk;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;
  const int wrow = q0 + 16 * warp;              // this warp's first row
  // a causal warp stops at the tile that holds its last row's key
  const int my_tiles =
      causal ? min(n_tiles, (wrow + 15) / kBlockK + 1) : n_tiles;

  auto fetch = [&](int j) {                     // K/V tile j into its stage
    T* st_kv = kv_s + (j % kKvStages) * 2 * KV_TILE;
    copy_rows<T, D, LD, kBlockK, NT>(st_kv, kb, ks.s, j * kBlockK, sk, tid);
    copy_rows<T, D, LD, kBlockK, NT>(st_kv + KV_TILE, vb, vs.s, j * kBlockK,
                                     sk, tid);
    cp_async_commit();
  };
  copy_rows<T, D, LD, BQ, NT>(q_s, qb, qs.s, q0, sq, tid);  // rows past sq: 0
  fetch(0);

  float acc[kRows][N], m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) acc[r][n] = 0.f;
  }
  const T* q_t = q_s + (16 * warp + half) * LD;      // row r at + 2 r LD
  float* p_t = p_s + (16 * warp + half) * kPLd;      // the same rows of P

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();                         // tile j (and Q) has landed
    __syncthreads();                            // and every warp is past j - 1
    if (kKvStages > 1 && j + 1 < n_tiles) fetch(j + 1);  // into j - 1's stage
    if (j < my_tiles) {                         // uniform in the warp
      const T* k_t = kv_s + (j % kKvStages) * 2 * KV_TILE;
      const T* v_t = k_t + KV_TILE;

      float s[kRows][4];                        // keys kg + 16 i
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[r][i] = 0.f;
      const T* k_l = k_t + kg * LD;
#pragma unroll 4
      for (int c = 0; c < D; c += 4) {
        float kx[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ld<4>(k_l + 16 * i * LD + c, kx[i]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float qx[4];
          ld<4>(q_t + 2 * r * LD + c, qx);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            s[r][i] = fmaf(qx[3], kx[i][3], fmaf(qx[2], kx[i][2],
                      fmaf(qx[1], kx[i][1], fmaf(qx[0], kx[i][0], s[r][i]))));
        }
      }

      const int k0 = j * kBlockK;
      if (k0 + kBlockK > sk || (causal && k0 + kBlockK - 1 > wrow)) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)         // the diagonal or ragged tile
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + kg + 16 * i, row = wrow + 2 * r + half;
            if (key >= sk || (causal && key > row)) s[r][i] = -INFINITY;
          }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        // the scale is positive, so the max of raw scores is the max of scaled
        const float mx = half_max(fmaxf(fmaxf(s[r][0], s[r][1]),
                                        fmaxf(s[r][2], s[r][3])));
        const float m_new = fmaxf(m[r], mx * scale_log2);
        const float corr = ex2(m[r] - m_new);
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[r][i] = ex2(fmaf(s[r][i], scale_log2, -m_new));
          sum += s[r][i];
        }
        l[r] = l[r] * corr + sum;               // this thread's keys only
#pragma unroll
        for (int n = 0; n < N; ++n) acc[r][n] *= corr;
      }

#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) p_t[2 * r * kPLd + kg + 16 * i] = s[r][i];
      __syncwarp();
      const T* v_l = v_t + kg * VW;             // chunk c at + 16 VW c
#pragma unroll 2
      for (int jj = 0; jj < kBlockK; jj += 4) {
        float vx[4][N];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            ld<VW>(v_l + (jj + t) * LD + 16 * VW * c, &vx[t][c * VW]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float px[4];
          ld<4>(p_t + 2 * r * kPLd + jj, px);
#pragma unroll
          for (int n = 0; n < N; ++n)
            acc[r][n] = fmaf(px[3], vx[3][n], fmaf(px[2], vx[2][n],
                        fmaf(px[1], vx[1][n], fmaf(px[0], vx[0][n], acc[r][n]))));
        }
      }
      __syncwarp();                             // P is rewritten next
    }
    if (kKvStages == 1 && j + 1 < n_tiles) {    // one stage: refill it once
      // every warp is done with tile j
      __syncthreads();
      fetch(j + 1);
    }
  }

  T* ob = o + batch * os.b + head * os.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = wrow + 2 * r + half;
    const float lsum = half_sum(l[r]);
    if (row >= sq) continue;
    const float denom = fmaxf(lsum, 1e-30f);
    float out[N];
#pragma unroll
    for (int n = 0; n < N; ++n) out[n] = acc[r][n] / denom;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      st<VW>(ob + row * os.s + 16 * VW * c + kg * VW, &out[c * VW]);
    if (lse != nullptr && kg == 0)    // m, log2(l) in base-2 units
      lse[((long long)batch * gridDim.y + head) * sq + row] =
          (m[r] + log2f(lsum)) * kLn2;
  }
}

template <typename T, int D, int BQ>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int sk, int h, int kh, const Strides& qs,
           const Strides& ks, const Strides& vs, const Strides& os,
           float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T>(D, BQ);
  auto kern = flash_fwd<T, D, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, 2 * BQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, h / kh, qs,
      ks, vs, os, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_rows(int block_q, const void* q, const void* k, const void* v,
                  void* o, float* lse, int b, int sq, int sk, int h, int kh,
                  const Strides& qs, const Strides& ks, const Strides& vs,
                  const Strides& os, float scale, int causal,
                  cudaStream_t stream) {
  switch (block_q) {
    case 64: return launch<T, D, 64>(q, k, v, o, lse, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, stream);
    case 128: return launch<T, D, 128>(q, k, v, o, lse, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, stream);
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

size_t smem_of(int dtype, int d, int block_q) {
  if (d % 16 || d < 16 || d > 128 || (block_q != 64 && block_q != 128))
    return 0;
  return dtype == 0 ? smem_bytes<float>(d, block_q)
                    : smem_bytes<__nv_bfloat16>(d, block_q);
}

}  // namespace cc

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
// 64 or 128, float32 -> flash_fwd with block_q 64 or 128), 1 flash_fwd for
// either dtype (block_q 64 or 128).  lse: null, or fp32 (B, H, Sq) that
// receives each row's log-sum-exp.  q, k, v rows must start on 16-byte
// boundaries (both kernels copy 16 bytes at a time; the wrapper checks).
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
    return cc::dispatch_d<float>(d, block_q, q, k, v, o, l, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, st);
  if (impl == 1)
    return cc::dispatch_d<__nv_bfloat16>(d, block_q, q, k, v, o, l, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, st);
  return wg::dispatch_d(d, block_q, q, k, v, o, l, b, sq, sk, h, kh, qs, ks, vs, os, scale, causal, st);
}

// Dynamic shared memory of one flash_fwd_wgmma block (0 for a shape it does
// not take).
long long repro_flash_attention_wgmma_smem(int d, int block_q) {
  return (long long)wg::smem_of(d, block_q);
}

// Dynamic shared memory of one flash_fwd block (dtype 0 float32, 1
// bfloat16; 0 for a shape it does not take).
long long repro_flash_attention_cuda_core_smem(int dtype, int d, int block_q) {
  return (long long)cc::smem_of(dtype, d, block_q);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
