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
// once to the input dtype.  No float atomics: every sum runs in a fixed
// order, so two runs agree bit for bit.
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
// bwd_dq, bwd_dkdv (CUDA cores): bound by operations.  At the train path's
// (4, 1024, 15/5, 64) causal fp32 the function's 5 products (S, dP, dV, dK,
// dQ) are 20.2 GFLOP, 0.301 ms at the 67 TFLOP/s fp32 rate, against 68 MB
// of inputs and outputs (20 us at 3.35 TB/s).  The kernels run 9: the dQ
// kernel's delta pass recomputes S and dP, and the dK/dV kernel S and dP
// again, a floor of 0.542 ms.  So the design is flash_attention.cu's
// flash_fwd, which keeps the FMA pipe fed from registers, taken through
// the five things that would keep it far from that floor:
//   Staging (a block that loads a tile by scalar loads between two
//   barriers waits on memory once a tile).  16-byte cp.async copies
//   (wgmma.cuh's copy_rows) in the input type, converted when read, rows
//   past sq or sk zero-filled; 4-byte copies for the LSE and delta rows
//   (Sq floats apart).  Rows are padded by 16 bytes, so the float4 reads
//   of 16 distinct rows fall on distinct banks.  The block's own rows (Q
//   and dO; K and V) are staged once; the streamed tile (K and V; Q, dO,
//   LSE and delta) is copied while the other blocks on the SM compute:
//   kStages, below.
//   Register tiles (a product that reads both operands from shared memory
//   a scalar at a time issues a load for every two FMAs).  A block owns BR
//   = 32 or 64 rows (q rows in dQ, keys in dK/dV) and streams tiles of 64
//   columns (keys; q rows).  A warp owns 2 R rows; a thread (half h = lane
//   / 16, column group g = lane % 16) the R rows 2 r + h and the columns g
//   + 16 i, so S and dP (S^T and dP^T in dK/dV) are R x 4 in registers:
//   each 4-wide d step reads R broadcast float4s of the row operand and 4
//   float4s of column rows, 12 LDS.128 for 128 FMAs at R = 8.  P, dS and
//   delta's row sums stay in registers; a row's sum is reduced in its
//   half-warp by shuffles in a fixed order.  The products over the columns
//   (dQ += dS K; dV += P^T dO and dK += dS^T Q) take the thread's R rows x
//   D / 16 dims (chunks of 4, 2 or 1 consecutive dims, 16 lanes side by
//   side, so a B row is read as whole lines); the operand that changes
//   hands (dS; P^T and dS^T) goes through warp-private shared rows of kXLd
//   floats (16-byte aligned, the two halves' rows 16 banks apart) behind
//   __syncwarp, never a block barrier.  R = 8 in a 64-row block, except 4
//   in dK/dV past D 64, where two R x D / 16 accumulators and the S and dP
//   fragment would not fit 255 registers; R = 4 in a 32-row block, whose
//   four warps each carry half a 64-row block's warp's chain of work.  One
//   FFMA and one ex2.approx a score: scale * log2(e) folded in, the LSE
//   converted to base 2 once.
//   Masking (tested on every element of every tile, the mask costs more
//   than the exponent).  Only the diagonal tile and the tile that holds sk
//   or sq take it; a causal warp skips the tiles wholly past its rows (dQ)
//   or wholly before its keys (dK/dV).
//   Occupancy (a block's barriers stall its SM unless other blocks share
//   it).  At D 64 fp32 a 64-row dQ block takes 90 KB (two an SM), a 32-key
//   dK/dV block 73 KB and 128 registers a thread (three an SM).  Blocks of
//   32 rows (four warps of R = 4) or 64 (R = 8), each an instantiation:
//   the dK/dV kernel takes 32 keys, the dQ kernel 64 rows, or 32 while its
//   grid is under two 64-row blocks an SM (flash_attention.py,
//   bwd_block_pair), where a warp's own chain of work sets the time.
//   The dK/dV critical path (a block a KV head walks the GQA group's heads
//   in series: 48 tile steps at the train shape for the heaviest block, 40
//   blocks at (4, 128)).  One block a (key tile, query head): with a group
//   of G > 1 each writes its fp32 dK * scale and dV to scratch that the
//   wrapper allocates (partial, (2, B, H, Sk, D)), takes an int32 ticket
//   from its (batch, KV head, key tile) counter after a fence, and the
//   group's last block adds the G partials in head order, writes dK and
//   dV, and sets the counter back to zero for the next launch.  The
//   heaviest block walks 16 q tiles; (4, 128) has 240 blocks of 32 keys.
//   bwd_dq (first): grid (H x B, q tiles), every (head, batch) of a tile
//   before the next tile, a causal head's heaviest tile first.  The K/V
//   tiles stream twice, 0 .. n - 1 for delta, then n - 1 .. 0 for dQ: the
//   last tile of the first pass is the first of the second, loaded once,
//   its S and dP computed once.
//   bwd_dkdv (second): grid (H x B, key tiles), tile 0 (the heaviest when
//   causal) first; a causal block starts at its diagonal q rows.
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
// freed shared memory and written once as 16-byte pieces of rows.  Each
// output element is written by exactly one block.
//
// Bound on the H100: at the train path's (4, 1024, 15/5, 64) causal bf16,
// 5 products of 2 * d * (causal pairs) each a head, 20.2 GFLOP (20 us at
// 989 TFLOP/s bf16), against 34 MB of inputs and outputs (10 us): bound by
// operations.  The tensor-core kernels run the same 9 products as the
// CUDA-core ones, plus one for dS's lo part in dQ, at the bf16 tensor-core
// rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

struct Dims {
  int b, sq, sk, h, kh, group;
};

struct Args {
  const void *q, *k, *v, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  float* partial;     // CUDA-core dK/dV: the heads' shares, group > 1
  int* counter;       // and the groups' tickets, zero between launches
  Dims dm;
  float scale;
  int causal;
  cudaStream_t stream;
};

// --- bwd_dq, bwd_dkdv: fp32 FMAs on the CUDA cores ------------------------------

namespace cc {

using namespace hopper;

constexpr int kCols = 64;            // columns of a streamed tile: keys, q rows
// Streamed tiles staged.  One: at D 64 fp32 a 64-row dQ block takes 90 KB
// and a 32-key dK/dV block 73 KB, so two or three blocks share an SM and
// one block's copy overlaps the others' products.  Two stages (the next
// tile in flight in the block, fewer blocks an SM) timed 23% slower at the
// train shape and 2% faster at (4, 128, 15/5, 64) on an H100
// (bench/attention_ablations.py, bwd_f32_two_stages).
constexpr int kStages = 1;
// rows a block owns, q rows (bwd_dq) or keys (bwd_dkdv): each an
// instantiation (flash_attention.py, BWD_BLOCK_CHOICES["cuda_core"])
constexpr int kBlockSmall = 32, kBlockLarge = 64;
constexpr int kXLd = kCols + 16;     // exchange rows: rows 2 r, 2 r + 1 16 banks apart
constexpr float kLog2e = 1.4426950408889634f;

// rows a thread owns: 8 in a 64-row block, or 4 in the dK/dV kernel past
// D 64; 4 in a 32-row block (four warps, each half the chain of work)
template <bool DKDV, int D, int BR>
__host__ __device__ constexpr int thread_rows() {
  return BR == kBlockSmall || (DKDV && D > 64) ? 4 : 8;
}
template <typename T, int D>     // staged row stride
__host__ __device__ constexpr int row_ld() { return D + 16 / (int)sizeof(T); }
template <int D>          // consecutive dims a lane reads in a product over columns
__host__ __device__ constexpr int dims_vec() {
  return (D / 16) % 4 == 0 ? 4 : (D / 16) % 2 == 0 ? 2 : 1;
}
template <bool DKDV, int D, int BR>
__host__ __device__ constexpr int threads() {
  return 16 * BR / thread_rows<DKDV, D, BR>();
}

// dynamic shared memory of a block owning br rows: its two tiles, the
// streamed stages (two tiles; for dK/dV also the LSE and delta rows), and
// the warps' exchange rows (dS; for dK/dV P^T and dS^T)
template <typename T, int D, bool DKDV>
constexpr size_t smem_bytes(int br) {
  return sizeof(T) * (size_t)row_ld<T, D>() * (2 * br + kStages * 2 * kCols)
         + sizeof(float) * (size_t)((DKDV ? kStages * 2 * kCols : 0)
                                    + (DKDV ? 2 : 1) * br * kXLd);
}

// N consecutive fp32 values written by other blocks (through the L2)
template <int N>
__device__ __forceinline__ void ld_l2(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = __ldcg(reinterpret_cast<const float2*>(p));
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = __ldcg(p);
  }
}

// s[r][i] = sum over d of A(row 2 r) B(row 16 i): a_t is this thread's
// first row of the row operand (row r at + 2 r LD), b_l its first column
// row (row i at + 16 i LD)
template <typename T, int D, int R>
__device__ __forceinline__ void scores(float (&s)[R][4], const T* a_t,
                                       const T* b_l) {
  constexpr int LD = row_ld<T, D>();
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[r][i] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float bx[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ld<4>(b_l + 16 * i * LD + c, bx[i]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float ax[4];
      ld<4>(a_t + 2 * r * LD + c, ax);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[r][i] = fmaf(ax[3], bx[i][3], fmaf(ax[2], bx[i][2],
                  fmaf(ax[1], bx[i][1], fmaf(ax[0], bx[i][0], s[r][i]))));
    }
  }
}

// acc[r][n] += sum over the tile's columns j of X(row 2 r, j) B(j, dim n):
// x_t is this thread's first exchange row (row r at + 2 r kXLd), b_l its
// first dims of B's row 0 (row j at + j LD, chunk c at + 16 VW c)
template <typename T, int D, int R>
__device__ __forceinline__ void accumulate(float (&acc)[R][D / 16],
                                           const float* x_t, const T* b_l) {
  constexpr int LD = row_ld<T, D>(), N = D / 16, VW = dims_vec<D>();
#pragma unroll 2
  for (int j = 0; j < kCols; j += 4) {
    float bx[4][N];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < N / VW; ++c)
        ld<VW>(b_l + (j + t) * LD + 16 * VW * c, &bx[t][c * VW]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float xx[4];
      ld<4>(x_t + 2 * r * kXLd + j, xx);
#pragma unroll
      for (int n = 0; n < N; ++n)
        acc[r][n] = fmaf(xx[3], bx[3][n], fmaf(xx[2], bx[2][n],
                    fmaf(xx[1], bx[1][n], fmaf(xx[0], bx[0][n], acc[r][n]))));
    }
  }
}

// One block a (head, batch, q tile of BQ rows), 2 BQ threads.  Q, dO and
// the rows' base-2 LSE are staged once; K/V tiles of 64 keys stream in load
// order 0 .. n - 1 (pass 1: delta = rowsum(P dP), written out), then
// n - 2 .. 0, the last load of pass 1 also the first of pass 2 (dS = P (dP
// - delta), dQ += dS K).
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(threads<false, D, BQ>())
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, float* __restrict__ delta,
       T* __restrict__ dq, Dims dm, float scale, float scale_log2,
       int causal) {
  constexpr int R = thread_rows<false, D, BQ>(), NT = threads<false, D, BQ>();
  constexpr int LD = row_ld<T, D>(), CT = kCols * LD, N = D / 16;
  constexpr int VW = dims_vec<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + BQ * LD;
  T* kv_s = do_s + BQ * LD;                       // stage s: K, then V
  float* x_s = reinterpret_cast<float*>(kv_s + kStages * 2 * CT);   // dS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, kg = lane & 15;
  const int head = blockIdx.x % dm.h, bi = blockIdx.x / dm.h;
  // every (head, batch) of a tile before the next; a causal head's heaviest
  // tile first
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * BQ, kvh = head / dm.group;
  const long long q_stride = (long long)dm.h * D;
  const long long kv_stride = (long long)dm.kh * D;
  const long long kv_off = ((long long)bi * dm.sk * dm.kh + kvh) * D;
  const long long q_off = ((long long)bi * dm.sq * dm.h + head) * D;
  const long long row_at = ((long long)bi * dm.h + head) * dm.sq;
  const int k_end = causal ? min(dm.sk, q0 + BQ) : dm.sk;
  const int n = (k_end + kCols - 1) / kCols;
  const int loads = 2 * n - 1;
  const int wrow = q0 + 2 * R * warp;             // this warp's first row
  // a causal warp stops at the tile that holds its last row's key; a warp
  // wholly past sq computes nothing
  const int my_tiles = wrow >= dm.sq ? 0
      : causal ? min(n, (wrow + 2 * R - 1) / kCols + 1) : n;

  auto fetch = [&](int l) {                       // load l into its stage
    const int j = l < n ? l : 2 * n - 2 - l;
    T* st_kv = kv_s + (l % kStages) * 2 * CT;
    copy_rows<T, D, LD, kCols, NT>(st_kv, k + kv_off, kv_stride, j * kCols,
                                   dm.sk, tid);
    copy_rows<T, D, LD, kCols, NT>(st_kv + CT, v + kv_off, kv_stride,
                                   j * kCols, dm.sk, tid);
    cp_async_commit();
  };
  copy_rows<T, D, LD, BQ, NT>(q_s, q + q_off, q_stride, q0, dm.sq, tid);
  copy_rows<T, D, LD, BQ, NT>(do_s, dout + q_off, q_stride, q0, dm.sq, tid);
  fetch(0);                                       // with Q and dO

  float lse2[R], rs[R], dl[R], acc[R][N];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = wrow + 2 * r + half;
    // rows past sq: Q and dO are zeros, so any finite LSE gives finite terms
    lse2[r] = row < dm.sq ? lse[row_at + row] * kLog2e : 0.f;
    rs[r] = dl[r] = 0.f;
#pragma unroll
    for (int c = 0; c < N; ++c) acc[r][c] = 0.f;
  }
  const T* q_t = q_s + (2 * R * warp + half) * LD;
  const T* do_t = do_s + (2 * R * warp + half) * LD;
  float* x_t = x_s + (2 * R * warp + half) * kXLd;

  for (int l = 0; l < loads; ++l) {
    cp_async_wait<0>();                           // load l has landed
    __syncthreads();                              // and every warp is past l - 1
    if (kStages > 1 && l + 1 < loads) fetch(l + 1);
    const int j = l < n ? l : 2 * n - 2 - l;
    const bool live = j < my_tiles;               // uniform in the warp
    const T* k_t = kv_s + (l % kStages) * 2 * CT;
    float s[R][4], dp[R][4];
    if (live) {
      scores<T, D, R>(s, q_t, k_t + kg * LD);         // S = Q K^T
      scores<T, D, R>(dp, do_t, k_t + CT + kg * LD);  // dP = dO V^T
      const int k0 = j * kCols;
      if (k0 + kCols > dm.sk || (causal && k0 + kCols - 1 > wrow)) {
#pragma unroll
        for (int r = 0; r < R; ++r)               // the diagonal or ragged tile
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + kg + 16 * i, row = wrow + 2 * r + half;
            if (key >= dm.sk || (causal && key > row)) s[r][i] = -INFINITY;
          }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i)               // P
          s[r][i] = ex2(fmaf(s[r][i], scale_log2, -lse2[r]));
      if (l < n) {                                // pass 1: delta's terms
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) rs[r] = fmaf(s[r][i], dp[r][i], rs[r]);
      }
    }
    if (l == n - 1) {                             // pass 1 is done
#pragma unroll
      for (int r = 0; r < R; ++r) {
        dl[r] = half_sum(rs[r]);                  // one order in every lane
        const int row = wrow + 2 * r + half;
        if (kg == 0 && row < dm.sq) delta[row_at + row] = dl[r];
      }
    }
    if (live && l >= n - 1) {                     // pass 2: dQ += dS K
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x_t[2 * r * kXLd + kg + 16 * i] = s[r][i] * (dp[r][i] - dl[r]);
      __syncwarp();
      accumulate<T, D, R>(acc, x_t, k_t + kg * VW);
      __syncwarp();                               // dS is rewritten next
    }
    if (kStages == 1 && l + 1 < loads) {          // one stage: refill it
      __syncthreads();                            // every warp is done with l
      fetch(l + 1);
    }
  }

  T* dqb = dq + q_off;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = wrow + 2 * r + half;
    if (row >= dm.sq) continue;
    float out[N];
#pragma unroll
    for (int c = 0; c < N; ++c) out[c] = acc[r][c] * scale;
#pragma unroll
    for (int c = 0; c < N / VW; ++c)
      st<VW>(dqb + row * q_stride + 16 * VW * c + kg * VW, &out[c * VW]);
  }
}

// One block a (query head, batch, key tile of BK keys): K and V staged once;
// Q and dO tiles of 64 rows and their LSE and delta rows stream, from the
// diagonal when causal.  Per tile, in fragments whose rows are keys:
//   S^T = K Q^T, dP^T = V dO^T; P^T, dS^T = P^T (dP^T - delta)
//   dV += P^T dO, dK += dS^T Q
// With a GQA group of G > 1 the heads' shares meet in `partial` and the
// group's last block (by ticket) adds them in head order.
template <typename T, int D, int BK>
__global__ void __launch_bounds__(threads<true, D, BK>())
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ partial,
         int* __restrict__ counter, Dims dm, float scale, float scale_log2,
         int causal) {
  constexpr int R = thread_rows<true, D, BK>(), NT = threads<true, D, BK>();
  constexpr int LD = row_ld<T, D>(), CT = kCols * LD, N = D / 16;
  constexpr int VW = dims_vec<D>(), XT = 2 * R * kXLd;  // a warp's exchange rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + BK * LD;
  T* qd_s = v_s + BK * LD;                        // stage s: Q, then dO
  float* rows_s = reinterpret_cast<float*>(qd_s + kStages * 2 * CT);
  float* x_s = rows_s + kStages * 2 * kCols;      // warp w: P^T, then dS^T

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, kg = lane & 15;
  const int head = blockIdx.x % dm.h, bi = blockIdx.x / dm.h;
  const int tile = blockIdx.y, k0 = tile * BK, kvh = head / dm.group;
  const long long q_stride = (long long)dm.h * D;
  const long long kv_stride = (long long)dm.kh * D;
  const long long kv_off = ((long long)bi * dm.sk * dm.kh + kvh) * D;
  const long long q_off = ((long long)bi * dm.sq * dm.h + head) * D;
  const long long row_at = ((long long)bi * dm.h + head) * dm.sq;
  const int kw = k0 + 2 * R * warp;               // this warp's first key
  // a causal q row before k0 sees none of these keys
  const int q_first = causal ? k0 : 0;
  const int n = q_first < dm.sq ? (dm.sq - q_first + kCols - 1) / kCols : 0;

  // Q, dO and the LSE and delta rows of q tile `it` into its stage; the
  // rows are Sq floats apart, so not 16-byte aligned: 4-byte copies
  auto fetch = [&](int it) {
    const int q0 = q_first + it * kCols;
    T* st_q = qd_s + (it % kStages) * 2 * CT;
    copy_rows<T, D, LD, kCols, NT>(st_q, q + q_off, q_stride, q0, dm.sq, tid);
    copy_rows<T, D, LD, kCols, NT>(st_q + CT, dout + q_off, q_stride, q0,
                                   dm.sq, tid);
    const uint32_t rs = smem_addr(rows_s + (it % kStages) * 2 * kCols);
    for (int i = tid; i < 2 * kCols; i += NT) {
      const int row = q0 + (i & (kCols - 1));
      const bool ok = row < dm.sq;
      cp_async_4(rs + 4 * i, (i < kCols ? lse : delta) + row_at + (ok ? row : 0),
                 ok);
    }
    cp_async_commit();
  };
  if (n > 0) {
    copy_rows<T, D, LD, BK, NT>(k_s, k + kv_off, kv_stride, k0, dm.sk, tid);
    copy_rows<T, D, LD, BK, NT>(v_s, v + kv_off, kv_stride, k0, dm.sk, tid);
    fetch(0);                                     // with K and V
  }

  float dk_acc[R][N], dv_acc[R][N];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  const T* k_t = k_s + (2 * R * warp + half) * LD;
  const T* v_t = v_s + (2 * R * warp + half) * LD;
  float* xp_t = x_s + warp * 2 * XT + half * kXLd;
  float* xs_t = xp_t + XT;
  const bool keys = kw < dm.sk;                   // a warp wholly past sk: none

  for (int it = 0; it < n; ++it) {
    cp_async_wait<0>();                           // tile it has landed
    __syncthreads();                              // and every warp is past it - 1
    if (kStages > 1 && it + 1 < n) fetch(it + 1);
    const int q0 = q_first + it * kCols;
    // a causal q tile wholly before this warp's keys sees none of them
    if (keys && !(causal && q0 + kCols - 1 < kw)) {   // uniform in the warp
      const T* q_t = qd_s + (it % kStages) * 2 * CT;
      const T* do_t = q_t + CT;
      const float* lse_s = rows_s + (it % kStages) * 2 * kCols;
      float s[R][4], dp[R][4];
      scores<T, D, R>(s, k_t, q_t + kg * LD);     // S^T = K Q^T
      scores<T, D, R>(dp, v_t, do_t + kg * LD);   // dP^T = V dO^T
      if (q0 + kCols > dm.sq || kw + 2 * R > dm.sk
          || (causal && kw + 2 * R - 1 > q0)) {   // diagonal, ragged
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = kw + 2 * r + half, qp = q0 + kg + 16 * i;
            if (key >= dm.sk || qp >= dm.sq || (causal && key > qp))
              s[r][i] = -INFINITY;
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {               // column kg + 16 i: one q row
        const float l2 = lse_s[kg + 16 * i] * kLog2e;
        const float d = lse_s[kCols + kg + 16 * i];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = ex2(fmaf(s[r][i], scale_log2, -l2));
          xp_t[2 * r * kXLd + kg + 16 * i] = p;
          xs_t[2 * r * kXLd + kg + 16 * i] = p * (dp[r][i] - d);
        }
      }
      __syncwarp();
      accumulate<T, D, R>(dv_acc, xp_t, do_t + kg * VW);   // dV += P^T dO
      accumulate<T, D, R>(dk_acc, xs_t, q_t + kg * VW);    // dK += dS^T Q
      __syncwarp();                               // P^T, dS^T rewritten next
    }
    if (kStages == 1 && it + 1 < n) {             // one stage: refill it
      __syncthreads();                            // every warp is done with it
      fetch(it + 1);
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) dk_acc[r][c] *= scale;
  T* dkb = dk + kv_off;
  T* dvb = dv + kv_off;
  if (dm.group == 1) {                            // the one head's share is all
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int key = kw + 2 * r + half;
      if (key >= dm.sk) continue;
#pragma unroll
      for (int c = 0; c < N / VW; ++c) {
        const long long at = key * kv_stride + 16 * VW * c + kg * VW;
        st<VW>(dkb + at, &dk_acc[r][c * VW]);
        st<VW>(dvb + at, &dv_acc[r][c * VW]);
      }
    }
    return;
  }

  // this head's share into partial (dK's (B, H, Sk, D), then dV's)
  const long long part = (long long)dm.b * dm.h * dm.sk * D;
  const long long head_at = (long long)dm.sk * D;
  const float* grp = partial + ((long long)bi * dm.h + kvh * dm.group) * head_at;
  const int own = head - kvh * dm.group;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int key = kw + 2 * r + half;
    if (key >= dm.sk) continue;
#pragma unroll
    for (int c = 0; c < N / VW; ++c) {
      float* p = partial + ((long long)bi * dm.h + head) * head_at
                 + (long long)key * D + 16 * VW * c + kg * VW;
      st<VW>(p, &dk_acc[r][c * VW]);
      st<VW>(p + part, &dv_acc[r][c * VW]);
    }
  }
  __threadfence();                                // this thread's share is visible
  __syncthreads();                                // and every thread's
  if (tid == 0) {
    int* ticket = counter + ((long long)bi * dm.kh + kvh) * gridDim.y + tile;
    last = atomicAdd(ticket, 1) == dm.group - 1;
    if (last) *ticket = 0;                        // every block drew: re-armed
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the group's last block: the G shares in head order (its own from its
  // registers, the same values it wrote)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int key = kw + 2 * r + half;
    if (key >= dm.sk) continue;
#pragma unroll
    for (int c = 0; c < N / VW; ++c) {
      const long long at = (long long)key * D + 16 * VW * c + kg * VW;
      float sk4[VW], sv4[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) sk4[e] = sv4[e] = 0.f;
      for (int g = 0; g < dm.group; ++g) {
        float xk[VW], xv[VW];
        if (g == own) {
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            xk[e] = dk_acc[r][c * VW + e];
            xv[e] = dv_acc[r][c * VW + e];
          }
        } else {
          ld_l2<VW>(grp + g * head_at + at, xk);
          ld_l2<VW>(grp + part + g * head_at + at, xv);
        }
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          sk4[e] += xk[e];
          sv4[e] += xv[e];
        }
      }
      const long long out = key * kv_stride + 16 * VW * c + kg * VW;
      st<VW>(dkb + out, sk4);
      st<VW>(dvb + out, sv4);
    }
  }
}

template <typename T, int D, int BQ, int BK>
int launch(const Args& a) {
  constexpr size_t smem_dq = smem_bytes<T, D, false>(BQ);
  constexpr size_t smem_dkdv = smem_bytes<T, D, true>(BK);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);
  const float scale_log2 = a.scale * kLog2e;

  auto dqk = bwd_dq<T, D, BQ>;                    // first: it writes delta
  cudaError_t err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  dim3 g1(a.dm.h * a.dm.b, (a.dm.sq + BQ - 1) / BQ);
  dqk<<<g1, threads<false, D, BQ>(), smem_dq, a.stream>>>(
      q, k, v, dout, lse, delta, static_cast<T*>(a.dq), a.dm, a.scale,
      scale_log2, a.causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  auto dkdv = bwd_dkdv<T, D, BK>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  dim3 g2(a.dm.h * a.dm.b, (a.dm.sk + BK - 1) / BK);
  dkdv<<<g2, threads<true, D, BK>(), smem_dkdv, a.stream>>>(
      q, k, v, dout, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.partial, a.counter, a.dm, a.scale, scale_log2, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_blocks(const Args& a, int block_q, int block_k) {
  if (block_q == kBlockSmall)
    return block_k == kBlockSmall ? launch<T, D, kBlockSmall, kBlockSmall>(a)
                                  : launch<T, D, kBlockSmall, kBlockLarge>(a);
  return block_k == kBlockSmall ? launch<T, D, kBlockLarge, kBlockSmall>(a)
                                : launch<T, D, kBlockLarge, kBlockLarge>(a);
}

template <typename T>
int dispatch_d(int d, const Args& a, int block_q, int block_k) {
  switch (d) {  // every multiple of 16 up to 128, each its own instantiation
#define REPRO_HEAD_DIM(D) \
    case D: return dispatch_blocks<T, D>(a, block_q, block_k);
    REPRO_HEAD_DIM(16) REPRO_HEAD_DIM(32) REPRO_HEAD_DIM(48) REPRO_HEAD_DIM(64)
    REPRO_HEAD_DIM(80) REPRO_HEAD_DIM(96) REPRO_HEAD_DIM(112) REPRO_HEAD_DIM(128)
#undef REPRO_HEAD_DIM
    default: return -3;
  }
}

bool is_block(int block) { return block == kBlockSmall || block == kBlockLarge; }

template <typename T>
size_t smem_of(int which, int d, int block) {
  switch (d) {
#define REPRO_HEAD_DIM(D) \
    case D: return which == 0 ? smem_bytes<T, D, false>(block) \
                              : smem_bytes<T, D, true>(block);
    REPRO_HEAD_DIM(16) REPRO_HEAD_DIM(32) REPRO_HEAD_DIM(48) REPRO_HEAD_DIM(64)
    REPRO_HEAD_DIM(80) REPRO_HEAD_DIM(96) REPRO_HEAD_DIM(112) REPRO_HEAD_DIM(128)
#undef REPRO_HEAD_DIM
    default: return 0;
  }
}

}  // namespace cc

// --- bwd_dq_wgmma, bwd_dkdv_wgmma: bf16 on the tensor cores ----------------------

namespace wg {

using namespace hopper;
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
// block_q, -3 head dim, -4 block_k, -5 shape, -6 impl, -7 scratch.  dtype:
// 0 float32, 1 bfloat16.  impl: 0 by dtype (bfloat16 -> bwd_dq_wgmma and
// bwd_dkdv_wgmma, block_q and block_k 64 or 128; float32 -> bwd_dq and
// bwd_dkdv, block_q and block_k 32 or 64), 1 bwd_dq and bwd_dkdv for either
// dtype.  delta: fp32 (B, H, Sq) scratch the first kernel fills.  partial
// (fp32, 2 x B x H x Sk x D) and counter (int32, B x KH x ceil(Sk /
// block_k), all zero, left zero) are the CUDA-core dK/dV kernel's, needed
// when H > KH.  Launches two kernels in order on `stream`: the dQ kernel,
// then the dK/dV kernel.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, void* delta,
                              void* dq, void* dk, void* dv, void* partial,
                              void* counter, int dtype, int impl, int device,
                              int b, int sq, int sk, int h, int kh, int d,
                              int block_q, int block_k, int causal,
                              float scale, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || kh < 1 || h % kh != 0) return -5;
  if (dtype != 0 && dtype != 1) return -1;
  if (impl != 0 && impl != 1) return -6;
  const bool tensor_cores = dtype == 1 && impl == 0;
  if (tensor_cores ? block_q != 64 && block_q != 128 : !cc::is_block(block_q))
    return -2;
  if (tensor_cores ? block_k != 64 && block_k != 128 : !cc::is_block(block_k))
    return -4;
  if (!tensor_cores && h > kh && (partial == nullptr || counter == nullptr))
    return -7;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{q, k, v, dout, lse, delta, dq, dk, dv,
               static_cast<float*>(partial), static_cast<int*>(counter),
               Dims{b, sq, sk, h, kh, h / kh}, scale, causal,
               static_cast<cudaStream_t>(stream)};
  if (tensor_cores) return wg::dispatch_d(d, a, block_q, block_k);
  return dtype == 0
             ? cc::dispatch_d<float>(d, a, block_q, block_k)
             : cc::dispatch_d<__nv_bfloat16>(d, a, block_q, block_k);
}

// Dynamic shared memory of one tensor-core block (which: 0 bwd_dq_wgmma
// with block = block_q, 1 bwd_dkdv_wgmma with block = block_k; 0 for a
// shape they do not take).
long long repro_flash_attention_bwd_wgmma_smem(int which, int d, int block) {
  return (long long)wg::smem_of(which, d, block);
}

// The same of one CUDA-core block (which: 0 bwd_dq, 1 bwd_dkdv; dtype 0
// float32, 1 bfloat16).
long long repro_flash_attention_bwd_cuda_core_smem(int which, int dtype, int d,
                                                   int block) {
  if (!cc::is_block(block) || (which != 0 && which != 1)
      || (dtype != 0 && dtype != 1))
    return 0;
  return (long long)(dtype == 0 ? cc::smem_of<float>(which, d, block)
                                : cc::smem_of<__nv_bfloat16>(which, d, block));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
