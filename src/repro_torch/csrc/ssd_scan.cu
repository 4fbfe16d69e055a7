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
// keeps the state in VMEM between steps.  Hopper blocks run in no order, so
// the chunk axis is split as Mamba-2's own GPU kernels split it
// (arXiv:2405.21060 section 7): only the recurrence between chunks, which is
// elementwise, stays serial.  Four passes run in order on one stream:
//   1. ssd_cb           grid (chunk, batch): CB = C B^T, once per (batch,
//                       chunk), shared by every head: (B, nc, Qp, Qp) fp32,
//                       lower triangle.
//   2. ssd_chunk_state  grid (chunk x P tile, head, batch): cum to (B, H, nc,
//                       Qp), and the chunk's own state contribution
//                       (exp(cum_last - cum) dt * x)^T B to (B, H, nc, P, N).
//   3. ssd_state_pass   grid (P*N tile, head, batch): walks the chunks,
//                       run = exp(cum_last_c) run + local_c, overwriting slot
//                       c with the state entering chunk c; the last run is
//                       the final state.  Coalesced, bound by bytes.
//   4. ssd_chunk_scan   grid (chunk x P tile, head, batch):
//                       y = W x + exp(cum_i) * (C state_in^T), cast once.
// P is cut in tiles of kPT = 64 columns (one tile for mamba2's P = 64).
//
// Products.  bf16 inputs run every product on the tensor cores with
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), operands from shared memory
// by ldmatrix, tiles brought in by cp.async.  One operand of each product
// is a raw bf16 input (C and B in CB, B in the state product, x in W x, C
// in C state^T); the other, an fp32 value (the decayed x, W, the state),
// enters as hi + lo, two bf16 parts in two products (hi its rounding, lo
// the rounding of the rest), which keeps it to within 2^-17 of itself, so
// the products stay fp32-accurate.  In pass 2 the decay sits on x (a 128 x
// 64 tile) rather than on B (128 x 128): half the splitting, and 72,704
// bytes of shared memory, three blocks an SM where the decayed B took two.
// fp32 inputs run the same passes with fp32 FMAs on the CUDA cores, eight
// warps a block in passes 2 and 4.
//
// Ragged tail.  A chunk shorter than Q (the sequence tail), or a Q that is
// not a multiple of 16, is zero-filled to Qp = round_up(Q, 16) rows with
// dt = 0: those steps are exact no-ops on the recurrence, as the
// reference's zero pad is (ssd.py:89-92); their y rows are not written.
//
// Bound.  At (B, S, H, P, N) = (4, 2048, 24, 64, 128) bf16 the function
// reads x, dt, B, C and writes y and the state, 58.5 MB: 17.5 us at 3.35
// TB/s, above the 16.3 us its operations take at the bf16 tensor-core rate.
// The passes add the intermediate states: 50.3 MB written by pass 2, read
// and written by pass 3, read by pass 4, 201 MB in all, 60 us at 3.35 TB/s.
// Passes 2 and 4 run a block's phases in series (copies, decay, products,
// stores) at two or three blocks an SM, so latency, not bytes or
// operations, sets their time; a pipelined, persistent form is later work.
//
// Shared memory (dynamic; at Qp = N = 128, P tile 64):
//   pass 1  bf16: C, B as [Qp][N+8] bf16                          69,632 B
//           fp32: C, B as [128][132] fp32                         135,168 B
//   pass 2  bf16: w x hi and lo [Qp][72], B [Qp][N+8] bf16, cum, w 72,704 B
//                 (three blocks an SM)
//           fp32: x [Qp][68], w B [Qp][N+4] fp32, cum, w          103,424 B
//   pass 4  bf16: C [Qp][N+8], state hi and lo [64][N+8], x [Qp][72]
//                 bf16, cum, dt; eight warps                      89,088 B
//                 (two blocks an SM)
//           fp32: C [128][132] with state [128][68], reused for W
//                 [128][132]; x [128][68]; cum, dt                138,240 B

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kQ = 128;      // largest chunk
constexpr int kMaxN = 128;   // largest state width
constexpr int kPT = 64;      // P columns a block takes
constexpr int kThreads = 128;      // threads a block
constexpr int kScanThreads = 256;  // ssd_chunk_scan_mma's and the fp32 passes 2, 4
constexpr int kLdF = kQ + 4;        // fp32 rows of 128 columns
constexpr int kLdPF = kPT + 4;      // fp32 rows of a P tile
constexpr int kLdPB = kPT + 8;      // bf16 rows of a P tile

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) as hi + lo, two bf16 pairs (v0 in the low half)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

__device__ __forceinline__ void split_store(bf16* hi, bf16* lo, float v) {
  const bf16 h = __float2bfloat16(v);
  *hi = h;
  *lo = __float2bfloat16(v - __bfloat162float(h));
}

// Copy a rows x cols tile (cols a multiple of the 16-byte vector) from
// global memory (row r at src + r * ld_src) to shared memory (row stride
// ld_dst elements, a multiple of 16 bytes), zero outside rows_valid x
// cols_valid.  vec: 16-byte cp.async copies (cols_valid a multiple of the
// vector, src on a 16-byte boundary); else one element a load.  The caller
// waits (cp_async_wait_all) and meets at a barrier before reading.  All
// `threads` threads of the block take part.
template <typename T>
__device__ void load_tile(T* dst, int ld_dst, const T* src, long long ld_src,
                          int rows, int rows_valid, int cols, int cols_valid,
                          bool vec, int threads = kThreads) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    const int vpr = cols / E;
    for (int i = threadIdx.x; i < rows * vpr; i += threads) {
      const int r = i / vpr, c = (i - r * vpr) * E;
      const bool ok = r < rows_valid && c < cols_valid;
      cp_async16(dst + r * ld_dst + c, ok ? src + r * ld_src + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += threads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ld_dst + c] = (r < rows_valid && c < cols_valid)
                                ? src[r * ld_src + c] : from_f32<T>(0.f);
    }
  }
}

// Two neighbouring fp32 results (col, col + 1) of a row of `width`
__device__ __forceinline__ void store2(float* row, int col, int width,
                                       float v0, float v1) {
  if (col + 1 < width && (width & 1) == 0) {
    *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
  } else {
    if (col < width) row[col] = v0;
    if (col + 1 < width) row[col + 1] = v1;
  }
}
__device__ __forceinline__ void store2(bf16* row, int col, int width,
                                       float v0, float v1) {
  if (col + 1 < width && (reinterpret_cast<uintptr_t>(row + col) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < width) row[col] = __float2bfloat16(v0);
    if (col + 1 < width) row[col + 1] = __float2bfloat16(v1);
  }
}

// Row tiles (16 rows each, mt of them) of warp w: w and 7 - w, so that the
// four warps share the lower triangle evenly.
__device__ __forceinline__ int row_tile(int slot, int warp) {
  return slot == 0 ? warp : 7 - warp;
}

struct Dims {
  int bs, s, h, p, n, chunk;  // the call's shape and chunk
  int qp, np, nc, ptiles;     // padded chunk and width, chunks, P tiles
  bool vec;                   // 16-byte copies of x, B and C
};

// The state entering chunk ci, rows p0.. of its P tile (sp) and N
// columns, zero-filled to kPT x np: each thread loads 8 float4 before it
// stores any, so the loads are in flight together; put(r, k, v) stores
// columns k..k+3 of row r.
template <typename Put>
__device__ __forceinline__ void load_state_tile(const float* sp, int pv,
                                                const Dims& dm, Put put) {
  const int vpr = dm.np / 4, total = kPT * vpr;
  const bool vec = (dm.n & 3) == 0;
  for (int base = threadIdx.x; base < total; base += blockDim.x * 8) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = base + u * blockDim.x;
      const int r = i / vpr, k = (i - r * vpr) * 4;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < total && r < pv && k < dm.n) {
        const float* src = sp + (long long)r * dm.n + k;
        if (vec) {
          t = *reinterpret_cast<const float4*>(src);
        } else {
          t.x = src[0];
          if (k + 1 < dm.n) t.y = src[1];
          if (k + 2 < dm.n) t.z = src[2];
          if (k + 3 < dm.n) t.w = src[3];
        }
      }
      v[u] = t;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = base + u * blockDim.x;
      if (i < total) put(i / vpr, (i % vpr) * 4, v[u]);
    }
  }
}

// --- pass 1: CB = C B^T per (batch, chunk) -----------------------------------

__global__ void __launch_bounds__(kThreads)
ssd_cb_mma(const bf16* __restrict__ bm, const bf16* __restrict__ cm,
           float* __restrict__ cb, Dims dm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = dm.np + 8;
  bf16* c_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = c_s + dm.qp * ld;
  const int ci = blockIdx.x, batch = blockIdx.y;
  const int c0 = ci * dm.chunk, len = min(dm.chunk, dm.s - c0);
  const long long g0 = ((long long)batch * dm.s + c0) * dm.n;
  load_tile(c_s, ld, cm + g0, dm.n, dm.qp, len, dm.np, dm.n, dm.vec);
  load_tile(b_s, ld, bm + g0, dm.n, dm.qp, len, dm.np, dm.n, dm.vec);
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  float* out = cb + ((long long)batch * dm.nc + ci) * dm.qp * dm.qp;
#pragma unroll
  for (int slot = 0; slot < 2; ++slot) {
    const int r = row_tile(slot, warp);
    if (r >= dm.qp / 16) continue;
    float acc[8][2][4] = {};
    for (int kk = 0; kk < dm.np / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, c_s + (16 * r + (lane & 7) + ((lane >> 3) & 1) * 8) * ld
                     + 16 * kk + (lane >> 4) * 8);
#pragma unroll
      for (int ct = 0; ct < 8; ++ct) {
        if (ct > r) continue;  // the lower triangle of 16 x 16 tiles
        uint32_t b[4];
        ldsm_x4(b, b_s + (16 * ct + (lane & 7) + (lane >> 4) * 8) * ld
                       + 16 * kk + ((lane >> 3) & 1) * 8);
        mma(acc[ct][0], a, b[0], b[1]);
        mma(acc[ct][1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int ct = 0; ct < 8; ++ct) {
      if (ct > r) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = 16 * ct + 8 * nt + 2 * q, i = 16 * r + g;
        store2(out + (long long)i * dm.qp, col, dm.qp, acc[ct][nt][0],
               acc[ct][nt][1]);
        store2(out + (long long)(i + 8) * dm.qp, col, dm.qp, acc[ct][nt][2],
               acc[ct][nt][3]);
      }
    }
  }
}

// fp32: 256 threads, each an 8 x 8 register tile (rows ti + 16 r, columns
// tj + 16 c, c <= r), which covers every i >= j
__global__ void __launch_bounds__(256)
ssd_cb_fma(const float* __restrict__ bm, const float* __restrict__ cm,
           float* __restrict__ cb, Dims dm) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* c_s = reinterpret_cast<float*>(smem);
  float* b_s = c_s + kQ * kLdF;
  const int ci = blockIdx.x, batch = blockIdx.y;
  const int c0 = ci * dm.chunk, len = min(dm.chunk, dm.s - c0);
  const long long g0 = ((long long)batch * dm.s + c0) * dm.n;
  load_tile(c_s, kLdF, cm + g0, dm.n, kQ, len, dm.np, dm.n, dm.vec, 256);
  load_tile(b_s, kLdF, bm + g0, dm.n, kQ, len, dm.np, dm.n, dm.vec, 256);
  cp_async_wait_all();
  __syncthreads();
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  for (int k = 0; k < dm.n; ++k) {
    float cr[8], bc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) cr[r] = c_s[(ti + 16 * r) * kLdF + k];
#pragma unroll
    for (int c = 0; c < 8; ++c) bc[c] = b_s[(tj + 16 * c) * kLdF + k];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c <= r; ++c) acc[r][c] = fmaf(cr[r], bc[c], acc[r][c]);
  }
  float* out = cb + ((long long)batch * dm.nc + ci) * dm.qp * dm.qp;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c <= r; ++c) {
      const int i = ti + 16 * r, j = tj + 16 * c;
      if (i < dm.qp && j < dm.qp) out[(long long)i * dm.qp + j] = acc[r][c];
    }
}

// --- pass 2: cum and each chunk's own state contribution ------------------------

// dt of the chunk into w_s (zero past len, up to kQ), cum = cumsum(dt a)
// into cum_s (warp 0: 4 steps a lane, then a warp scan), then
// w_s = exp(cum_last - cum) dt, which is at most dt (a < 0).  cum_out, when
// given, receives cum.  Ends at a barrier.
__device__ void chunk_decay(const float* __restrict__ dt, float a_h,
                            float* cum_s, float* w_s, float* cum_out,
                            const Dims& dm, int batch, int head, int c0,
                            int len) {
  for (int i = threadIdx.x; i < kQ; i += blockDim.x)
    w_s[i] = i < len ? dt[((long long)batch * dm.s + c0 + i) * dm.h + head]
                     : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v[kQ / 32];
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < kQ / 32; ++e) {
      run += w_s[lane * (kQ / 32) + e] * a_h;
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
  const float last = cum_s[dm.qp - 1];
  for (int i = threadIdx.x; i < dm.qp; i += blockDim.x) {
    const float cu = cum_s[i];
    w_s[i] = expf(last - cu) * w_s[i];
    if (cum_out != nullptr) cum_out[i] = cu;
  }
  __syncthreads();
}

// local (P tile x N) = (w * x)^T B: M = P (16 rows a warp), N = state
// columns, K = the chunk.  The decay w sits on x, the smaller tile: x w is
// the fp32 operand (hi, lo) and B the raw one, both by transposing ldmatrix
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const bf16* __restrict__ bm,
                    float* __restrict__ cum, float* __restrict__ states,
                    Dims dm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = dm.np + 8;
  bf16* xh_s = reinterpret_cast<bf16*>(smem);  // [qp][kLdPB], w * x hi
  bf16* xl_s = xh_s + dm.qp * kLdPB;           // [qp][kLdPB], w * x lo
  bf16* b_s = xl_s + dm.qp * kLdPB;            // [qp][ld]
  float* cum_s = reinterpret_cast<float*>(b_s + dm.qp * ld);
  float* w_s = cum_s + kQ;
  const int ci = blockIdx.x / dm.ptiles, pt = blockIdx.x - ci * dm.ptiles;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int c0 = ci * dm.chunk, len = min(dm.chunk, dm.s - c0);
  const int p0 = pt * kPT, pv = min(kPT, dm.p - p0);
  const long long bh = (long long)batch * dm.h + head;
  load_tile(xh_s, kLdPB, x + (((long long)batch * dm.s + c0) * dm.h + head) * dm.p + p0,
            (long long)dm.h * dm.p, dm.qp, len, kPT, pv, dm.vec);
  load_tile(b_s, ld, bm + ((long long)batch * dm.s + c0) * dm.n, dm.n,
            dm.qp, len, dm.np, dm.n, dm.vec);
  chunk_decay(dt, a[head], cum_s, w_s,
              pt == 0 ? cum + (bh * dm.nc + ci) * dm.qp : nullptr, dm, batch,
              head, c0, len);
  cp_async_wait_all();
  __syncthreads();
  for (int e = threadIdx.x; e < dm.qp * (kPT / 8); e += kThreads) {
    const int j = e / (kPT / 8), k = (e - j * (kPT / 8)) * 8;
    const float w = w_s[j];
    uint4 raw = *reinterpret_cast<const uint4*>(xh_s + j * kLdPB + k), hi, lo;
    const bf16* re = reinterpret_cast<const bf16*>(&raw);
    bf16* he = reinterpret_cast<bf16*>(&hi);
    bf16* le = reinterpret_cast<bf16*>(&lo);
#pragma unroll
    for (int t = 0; t < 8; ++t) split_store(he + t, le + t, __bfloat162float(re[t]) * w);
    *reinterpret_cast<uint4*>(xh_s + j * kLdPB + k) = hi;
    *reinterpret_cast<uint4*>(xl_s + j * kLdPB + k) = lo;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, m0 = 16 * warp;
  if (m0 >= pv) return;
  float acc[16][4] = {};
  for (int kk = 0; kk < dm.qp / 16; ++kk) {
    uint32_t ah[4], al[4];
    const int mi = lane >> 3;
    const int xo = (16 * kk + (lane & 7) + (mi >> 1) * 8) * kLdPB + m0 + (mi & 1) * 8;
    ldsm_x4_t(ah, xh_s + xo);
    ldsm_x4_t(al, xl_s + xo);
    const int off = (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * ld
                    + (lane >> 4) * 8;
#pragma unroll
    for (int n16 = 0; n16 < kMaxN / 16; ++n16) {
      if (16 * n16 >= dm.np) continue;
      uint32_t bf[4];
      ldsm_x4_t(bf, b_s + off + 16 * n16);
      mma(acc[2 * n16], ah, bf[0], bf[1]);
      mma(acc[2 * n16], al, bf[0], bf[1]);
      mma(acc[2 * n16 + 1], ah, bf[2], bf[3]);
      mma(acc[2 * n16 + 1], al, bf[2], bf[3]);
    }
  }
  float* out = states + ((bh * dm.nc + ci) * dm.p + p0) * dm.n;
#pragma unroll
  for (int nt = 0; nt < kMaxN / 8; ++nt) {
    if (8 * nt >= dm.np) continue;
    const int col = 8 * nt + 2 * q, r = m0 + g;
    if (r < pv) store2(out + (long long)r * dm.n, col, dm.n, acc[nt][0], acc[nt][1]);
    if (r + 8 < pv)
      store2(out + (long long)(r + 8) * dm.n, col, dm.n, acc[nt][2], acc[nt][3]);
  }
}

// fp32, eight warps: thread (warp, lane) owns rows warp + 8 r (r < 8) of
// the P tile and state columns lane + 32 c (c < 4)
__global__ void __launch_bounds__(kScanThreads)
ssd_chunk_state_fma(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const float* __restrict__ bm,
                    float* __restrict__ cum, float* __restrict__ states,
                    Dims dm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = dm.np + 4;
  float* x_s = reinterpret_cast<float*>(smem);  // [qp][kLdPF]
  float* b_s = x_s + dm.qp * kLdPF;             // [qp][ld], w * B
  float* cum_s = b_s + dm.qp * ld;
  float* w_s = cum_s + kQ;
  const int ci = blockIdx.x / dm.ptiles, pt = blockIdx.x - ci * dm.ptiles;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int c0 = ci * dm.chunk, len = min(dm.chunk, dm.s - c0);
  const int p0 = pt * kPT, pv = min(kPT, dm.p - p0);
  const long long bh = (long long)batch * dm.h + head;
  load_tile(x_s, kLdPF, x + (((long long)batch * dm.s + c0) * dm.h + head) * dm.p + p0,
            (long long)dm.h * dm.p, dm.qp, len, kPT, pv, dm.vec, kScanThreads);
  load_tile(b_s, ld, bm + ((long long)batch * dm.s + c0) * dm.n, dm.n, dm.qp,
            len, dm.np, dm.n, dm.vec, kScanThreads);
  chunk_decay(dt, a[head], cum_s, w_s,
              pt == 0 ? cum + (bh * dm.nc + ci) * dm.qp : nullptr, dm, batch,
              head, c0, len);
  cp_async_wait_all();
  __syncthreads();
  for (int e = threadIdx.x; e < dm.qp * dm.np / 4; e += kScanThreads) {
    const int j = e / (dm.np / 4), k = (e - j * (dm.np / 4)) * 4;
    const float w = w_s[j];
    float4* v = reinterpret_cast<float4*>(b_s + j * ld + k);
    const float4 t = *v;
    *v = make_float4(t.x * w, t.y * w, t.z * w, t.w * w);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[8][4] = {};
  for (int j = 0; j < dm.qp; ++j) {
    float bv[4], xv[8];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int nn = lane + 32 * c;
      bv[c] = nn < dm.np ? b_s[j * ld + nn] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) xv[r] = x_s[j * kLdPF + warp + 8 * r];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xv[r], bv[c], acc[r][c]);
  }
  float* out = states + ((bh * dm.nc + ci) * dm.p + p0) * dm.n;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int pr = warp + 8 * r;
    if (pr >= pv) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int nn = lane + 32 * c;
      if (nn < dm.n) out[(long long)pr * dm.n + nn] = acc[r][c];
    }
  }
}

// --- pass 3: the recurrence between chunks ------------------------------------------

__device__ __forceinline__ void load4(float (&v)[4], const float* p, int cnt,
                                      bool vec) {
  if (vec) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = k < cnt ? p[k] : 0.f;
  }
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4], int cnt,
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < cnt) p[k] = v[k];
  }
}

// Each thread walks 4 neighbouring state elements of one (batch, head)
// through the chunks, a load ahead: slot c gets the state entering chunk c.
__global__ void __launch_bounds__(256)
ssd_state_pass(const float* __restrict__ cum, float* __restrict__ states,
               float* __restrict__ final_state, Dims dm) {
  const long long pn = (long long)dm.p * dm.n;
  const long long e0 = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (e0 >= pn) return;
  const long long bh = (long long)blockIdx.z * dm.h + blockIdx.y;
  const bool vec = (pn & 3) == 0;  // then e0 + 4 <= pn, 16-byte aligned
  const int cnt = (int)min(4LL, pn - e0);
  float* base = states + bh * dm.nc * pn + e0;
  const float* last = cum + bh * dm.nc * dm.qp + dm.qp - 1;
  float run[4] = {0.f, 0.f, 0.f, 0.f}, nxt[4];
  load4(nxt, base, cnt, vec);
  for (int c = 0; c < dm.nc; ++c) {
    float cur[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) cur[k] = nxt[k];
    if (c + 1 < dm.nc) load4(nxt, base + (c + 1) * pn, cnt, vec);
    store4(base + c * pn, run, cnt, vec);
    const float dec = expf(last[(long long)c * dm.qp]);
#pragma unroll
    for (int k = 0; k < 4; ++k) run[k] = fmaf(dec, run[k], cur[k]);
  }
  store4(final_state + bh * pn + e0, run, cnt, vec);
}

// --- pass 4: y = W x + exp(cum_i) (C state_in^T) ------------------------------------

// Eight warps: warp w takes row tiles w % 4 and 7 - w % 4 of the chunk and
// half w / 4 of the P tile (32 columns):
// first C state_in^T (K = N; state hi and lo), rows then scaled by
// exp(cum_i), then W x (K = the chunk up to the diagonal), whose A
// fragments are built in registers from CB (L2: one (Qp, Qp) block per
// (batch, chunk), read by every head), split into hi and lo.
__global__ void __launch_bounds__(kScanThreads)
ssd_chunk_scan_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const bf16* __restrict__ cm, const float* __restrict__ cb,
                   const float* __restrict__ cum,
                   const float* __restrict__ states, bf16* __restrict__ y,
                   Dims dm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = dm.np + 8;
  bf16* c_s = reinterpret_cast<bf16*>(smem);   // [qp][ld]
  bf16* sh_s = c_s + dm.qp * ld;               // [kPT][ld] state in, hi
  bf16* sl_s = sh_s + kPT * ld;                // [kPT][ld] state in, lo
  bf16* x_s = sl_s + kPT * ld;                 // [qp][kLdPB]
  float* cum_s = reinterpret_cast<float*>(x_s + dm.qp * kLdPB);
  float* dt_s = cum_s + kQ;
  const int ci = blockIdx.x / dm.ptiles, pt = blockIdx.x - ci * dm.ptiles;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int c0 = ci * dm.chunk, len = min(dm.chunk, dm.s - c0);
  const int p0 = pt * kPT, pv = min(kPT, dm.p - p0);
  const long long bh = (long long)batch * dm.h + head;
  load_tile(c_s, ld, cm + ((long long)batch * dm.s + c0) * dm.n, dm.n, dm.qp,
            len, dm.np, dm.n, dm.vec, kScanThreads);
  load_tile(x_s, kLdPB, x + (((long long)batch * dm.s + c0) * dm.h + head) * dm.p + p0,
            (long long)dm.h * dm.p, dm.qp, len, kPT, pv, dm.vec, kScanThreads);
  load_state_tile(states + ((bh * dm.nc + ci) * dm.p + p0) * dm.n, pv, dm,
                  [&](int r, int k, float4 v) {
    uint32_t h01, l01, h23, l23;
    split2(v.x, v.y, h01, l01);
    split2(v.z, v.w, h23, l23);
    *reinterpret_cast<uint2*>(sh_s + r * ld + k) = make_uint2(h01, h23);
    *reinterpret_cast<uint2*>(sl_s + r * ld + k) = make_uint2(l01, l23);
  });
  const float* cp = cum + (bh * dm.nc + ci) * dm.qp;
  for (int i = threadIdx.x; i < kQ; i += kScanThreads) {
    cum_s[i] = i < dm.qp ? cp[i] : 0.f;
    dt_s[i] = i < len ? dt[((long long)batch * dm.s + c0 + i) * dm.h + head] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = (threadIdx.x >> 5) & 3, half = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, mt = dm.qp / 16;
  float acc[2][4][4] = {};  // P columns 32 half + 8 nt + 2 q (+1)
  for (int kk = 0; kk < dm.np / 16; ++kk) {  // C state_in^T
    uint32_t af[2][4];
#pragma unroll
    for (int slot = 0; slot < 2; ++slot) {
      const int r = row_tile(slot, warp);
      if (r < mt)
        ldsm_x4(af[slot], c_s + (16 * r + (lane & 7) + ((lane >> 3) & 1) * 8) * ld
                              + 16 * kk + (lane >> 4) * 8);
    }
#pragma unroll
    for (int n16 = 0; n16 < 2; ++n16) {
      const int col = 32 * half + 16 * n16;
      if (col >= pv) continue;
      const int off = (col + (lane & 7) + (lane >> 4) * 8) * ld + 16 * kk
                      + ((lane >> 3) & 1) * 8;
      uint32_t hi[4], lo[4];
      ldsm_x4(hi, sh_s + off);
      ldsm_x4(lo, sl_s + off);
#pragma unroll
      for (int slot = 0; slot < 2; ++slot) {
        if (row_tile(slot, warp) >= mt) continue;
        mma(acc[slot][2 * n16], af[slot], hi[0], hi[1]);
        mma(acc[slot][2 * n16], af[slot], lo[0], lo[1]);
        mma(acc[slot][2 * n16 + 1], af[slot], hi[2], hi[3]);
        mma(acc[slot][2 * n16 + 1], af[slot], lo[2], lo[3]);
      }
    }
  }
  const float* cbp = cb + ((long long)batch * dm.nc + ci) * dm.qp * dm.qp;
#pragma unroll
  for (int slot = 0; slot < 2; ++slot) {
    const int r = row_tile(slot, warp);
    if (r >= mt) continue;
    const int i0 = 16 * r + g, i1 = i0 + 8;
    const float cu0 = cum_s[i0], cu1 = cum_s[i1];
    const float e0 = expf(cu0), e1 = expf(cu1);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[slot][nt][0] *= e0;
      acc[slot][nt][1] *= e0;
      acc[slot][nt][2] *= e1;
      acc[slot][nt][3] *= e1;
    }
    // CB at rows i0, i1, columns 16 kk + 8 hc + 2 q (+1): one tile ahead
    const float* row0 = cbp + (long long)i0 * dm.qp + 2 * q;
    const float* row1 = cbp + (long long)i1 * dm.qp + 2 * q;
    float2 next[2][2];
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      next[hc][0] = *reinterpret_cast<const float2*>(row0 + 8 * hc);
      next[hc][1] = *reinterpret_cast<const float2*>(row1 + 8 * hc);
    }
    for (int kk = 0; kk <= r; ++kk) {  // W x, up to the diagonal tile
      float2 cur[2][2];
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        cur[hc][0] = next[hc][0];
        cur[hc][1] = next[hc][1];
        if (kk < r) {
          next[hc][0] = *reinterpret_cast<const float2*>(row0 + 16 * (kk + 1) + 8 * hc);
          next[hc][1] = *reinterpret_cast<const float2*>(row1 + 16 * (kk + 1) + 8 * hc);
        }
      }
      uint32_t ah[4], al[4];
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {  // registers 2 hc (row i0), 2 hc + 1 (i1)
        const int j = 16 * kk + 8 * hc + 2 * q;
        const float cj0 = cum_s[j], cj1 = cum_s[j + 1];
        const float dj0 = dt_s[j], dj1 = dt_s[j + 1];
        const float2 v0 = cur[hc][0], v1 = cur[hc][1];
        split2(i0 >= j ? v0.x * expf(cu0 - cj0) * dj0 : 0.f,
               i0 >= j + 1 ? v0.y * expf(cu0 - cj1) * dj1 : 0.f, ah[2 * hc],
               al[2 * hc]);
        split2(i1 >= j ? v1.x * expf(cu1 - cj0) * dj0 : 0.f,
               i1 >= j + 1 ? v1.y * expf(cu1 - cj1) * dj1 : 0.f,
               ah[2 * hc + 1], al[2 * hc + 1]);
      }
#pragma unroll
      for (int n16 = 0; n16 < 2; ++n16) {
        const int col = 32 * half + 16 * n16;
        if (col >= pv) continue;
        uint32_t xb[4];
        ldsm_x4_t(xb, x_s + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdPB
                          + col + (lane >> 4) * 8);
        mma(acc[slot][2 * n16], ah, xb[0], xb[1]);
        mma(acc[slot][2 * n16], al, xb[0], xb[1]);
        mma(acc[slot][2 * n16 + 1], ah, xb[2], xb[3]);
        mma(acc[slot][2 * n16 + 1], al, xb[2], xb[3]);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = i0 + 8 * hr;
      if (i >= len) continue;
      bf16* yr = y + (((long long)batch * dm.s + c0 + i) * dm.h + head) * dm.p + p0;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        store2(yr, 32 * half + 8 * nt + 2 * q, pv, acc[slot][nt][2 * hr],
               acc[slot][nt][2 * hr + 1]);
    }
  }
}

// fp32, eight warps: thread (warp, lane) owns rows warp + 8 r (r < 16) and
// P columns lane, lane + 32; W is built in shared memory over C and the
// state once the first product is done with them
__global__ void __launch_bounds__(kScanThreads)
ssd_chunk_scan_fma(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ cm, const float* __restrict__ cb,
                   const float* __restrict__ cum,
                   const float* __restrict__ states, float* __restrict__ y,
                   Dims dm) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* c_s = reinterpret_cast<float*>(smem);  // [kQ][kLdF]
  float* st_s = c_s + kQ * kLdF;                // [kQ][kLdPF], state in by k
  float* w_s = c_s;                             // [kQ][kLdF], after C, st
  float* x_s = st_s + kQ * kLdPF;               // [kQ][kLdPF]
  float* cum_s = x_s + kQ * kLdPF;
  float* dt_s = cum_s + kQ;
  const int ci = blockIdx.x / dm.ptiles, pt = blockIdx.x - ci * dm.ptiles;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int c0 = ci * dm.chunk, len = min(dm.chunk, dm.s - c0);
  const int p0 = pt * kPT, pv = min(kPT, dm.p - p0);
  const long long bh = (long long)batch * dm.h + head;
  load_tile(c_s, kLdF, cm + ((long long)batch * dm.s + c0) * dm.n, dm.n, kQ,
            len, dm.np, dm.n, dm.vec, kScanThreads);
  load_tile(x_s, kLdPF, x + (((long long)batch * dm.s + c0) * dm.h + head) * dm.p + p0,
            (long long)dm.h * dm.p, kQ, len, kPT, pv, dm.vec, kScanThreads);
  load_state_tile(states + ((bh * dm.nc + ci) * dm.p + p0) * dm.n, pv, dm,
                  [&](int r, int k, float4 v) {
    st_s[k * kLdPF + r] = v.x;
    st_s[(k + 1) * kLdPF + r] = v.y;
    st_s[(k + 2) * kLdPF + r] = v.z;
    st_s[(k + 3) * kLdPF + r] = v.w;
  });
  const float* cp = cum + (bh * dm.nc + ci) * dm.qp;
  for (int i = threadIdx.x; i < kQ; i += kScanThreads) {
    cum_s[i] = i < dm.qp ? cp[i] : 0.f;
    dt_s[i] = i < len ? dt[((long long)batch * dm.s + c0 + i) * dm.h + head] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[16][2] = {};
  for (int k = 0; k < dm.np; k += 4) {  // C state_in^T
    float s0[4], s1[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      s0[t] = st_s[(k + t) * kLdPF + lane];
      s1[t] = st_s[(k + t) * kLdPF + lane + 32];
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float4 cv = *reinterpret_cast<const float4*>(c_s + (warp + 8 * r) * kLdF + k);
      acc[r][0] += cv.x * s0[0] + cv.y * s0[1] + cv.z * s0[2] + cv.w * s0[3];
      acc[r][1] += cv.x * s1[0] + cv.y * s1[1] + cv.z * s1[2] + cv.w * s1[3];
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float e = expf(cum_s[warp + 8 * r]);
    acc[r][0] *= e;
    acc[r][1] *= e;
  }
  __syncthreads();  // C and the state are consumed: W takes their place
  const float* cbp = cb + ((long long)batch * dm.nc + ci) * dm.qp * dm.qp;
  for (int e = threadIdx.x; e < kQ * kQ; e += kScanThreads) {
    const int i = e >> 7, j = e & (kQ - 1);
    w_s[i * kLdF + j] = (i >= j && i < dm.qp)
        ? cbp[(long long)i * dm.qp + j] * expf(cum_s[i] - cum_s[j]) * dt_s[j]
        : 0.f;
  }
  __syncthreads();
  for (int j = 0; j < dm.qp; j += 4) {  // W x
    float x0[4], x1[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      x0[t] = x_s[(j + t) * kLdPF + lane];
      x1[t] = x_s[(j + t) * kLdPF + lane + 32];
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float4 wv = *reinterpret_cast<const float4*>(w_s + (warp + 8 * r) * kLdF + j);
      acc[r][0] += wv.x * x0[0] + wv.y * x0[1] + wv.z * x0[2] + wv.w * x0[3];
      acc[r][1] += wv.x * x1[0] + wv.y * x1[1] + wv.z * x1[2] + wv.w * x1[3];
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int i = warp + 8 * r;
    if (i >= len) continue;
    float* yr = y + (((long long)batch * dm.s + c0 + i) * dm.h + head) * dm.p + p0;
    if (lane < pv) yr[lane] = acc[r][0];
    if (lane + 32 < pv) yr[lane + 32] = acc[r][1];
  }
}

// --- host --------------------------------------------------------------------------

size_t smem_bytes(int pass, bool bf, int qp, int np) {
  switch (pass) {
    case 1: return bf ? (size_t)2 * qp * (np + 8) * 2 : (size_t)2 * kQ * kLdF * 4;
    case 2: return bf ? (size_t)2 * qp * kLdPB * 2 + (size_t)qp * (np + 8) * 2 + 2 * kQ * 4
                      : (size_t)qp * kLdPF * 4 + (size_t)qp * (np + 4) * 4 + 2 * kQ * 4;
    case 4: return bf ? (size_t)qp * (np + 8) * 2 + (size_t)2 * kPT * (np + 8) * 2 +
                            (size_t)qp * kLdPB * 2 + 2 * kQ * 4
                      : (size_t)(kQ * kLdF + 2 * kQ * kLdPF) * 4 + 2 * kQ * 4;
    default: return 0;
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Runs pass `which` (1-4), or all four in order (0), on `st`.
template <typename T>
int run(int which, const T* x, const float* dt, const float* a, const T* b,
        const T* c, T* y, float* state, float* cb, float* cum, float* states,
        const Dims& dm, cudaStream_t st) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  const dim3 tiles(dm.nc * dm.ptiles, dm.h, dm.bs);
  cudaError_t err = cudaSuccess;
  if (which == 0 || which == 1) {
    const size_t sm = smem_bytes(1, kBf, dm.qp, dm.np);
    const dim3 grid(dm.nc, dm.bs);
    if constexpr (kBf) {
      err = allow_smem(ssd_cb_mma, sm);
      if (err == cudaSuccess) ssd_cb_mma<<<grid, kThreads, sm, st>>>(b, c, cb, dm);
    } else {
      err = allow_smem(ssd_cb_fma, sm);
      if (err == cudaSuccess) ssd_cb_fma<<<grid, 256, sm, st>>>(b, c, cb, dm);
    }
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (which == 0 || which == 2) {
    const size_t sm = smem_bytes(2, kBf, dm.qp, dm.np);
    if constexpr (kBf) {
      err = allow_smem(ssd_chunk_state_mma, sm);
      if (err == cudaSuccess)
        ssd_chunk_state_mma<<<tiles, kThreads, sm, st>>>(x, dt, a, b, cum, states, dm);
    } else {
      err = allow_smem(ssd_chunk_state_fma, sm);
      if (err == cudaSuccess)
        ssd_chunk_state_fma<<<tiles, kScanThreads, sm, st>>>(x, dt, a, b, cum, states, dm);
    }
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (which == 0 || which == 3) {
    const long long pn = (long long)dm.p * dm.n;
    const dim3 grid((unsigned)((pn + 1023) / 1024), dm.h, dm.bs);
    ssd_state_pass<<<grid, 256, 0, st>>>(cum, states, state, dm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (which == 0 || which == 4) {
    const size_t sm = smem_bytes(4, kBf, dm.qp, dm.np);
    if constexpr (kBf) {
      err = allow_smem(ssd_chunk_scan_mma, sm);
      if (err == cudaSuccess)
        ssd_chunk_scan_mma<<<tiles, kScanThreads, sm, st>>>(x, dt, c, cb, cum, states, y, dm);
    } else {
      err = allow_smem(ssd_chunk_scan_fma, sm);
      if (err == cudaSuccess)
        ssd_chunk_scan_fma<<<tiles, kScanThreads, sm, st>>>(x, dt, c, cb, cum, states, y, dm);
    }
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Runs pass `which` of the scan (1 ssd_cb, 2 ssd_chunk_state, 3
// ssd_state_pass, 4 ssd_chunk_scan) or all four in order (0) on the given
// buffers: cb (B, nc, Qp, Qp), cum (B, H, nc, Qp), states (B, H, nc, P, N),
// all fp32, with Qp = round_up(chunk, 16) and nc = ceil(S / chunk).
// Returns 0 on success, a cudaError_t code if a launch was refused, or a
// negative code for an argument the kernel does not take: -1 dtype,
// -2 chunk (1..128), -3 state width (1..128), -4 pass, -5 shape.
// dtype: 0 float32, 1 bfloat16 (x, B, C, y); dt, a and the state are fp32.
int repro_ssd_scan(const void* x, const void* dt, const void* a,
                   const void* b, const void* c, void* y, void* state,
                   void* cb, void* cum, void* states, int dtype, int device,
                   int bs, int s, int h, int p, int n, int chunk, int which,
                   void* stream) {
  if (chunk < 1 || chunk > kQ) return -2;
  if (n < 1 || n > kMaxN) return -3;
  if (which < 0 || which > 4) return -4;
  if (bs < 1 || s < 1 || h < 1 || p < 1 || h > 65535 || bs > 65535) return -5;
  if (dtype != 0 && dtype != 1) return -1;
  Dims dm;
  dm.bs = bs; dm.s = s; dm.h = h; dm.p = p; dm.n = n; dm.chunk = chunk;
  dm.qp = (chunk + 15) / 16 * 16;
  dm.np = (n + 15) / 16 * 16;
  dm.nc = (s + chunk - 1) / chunk;
  dm.ptiles = (p + kPT - 1) / kPT;
  if ((long long)dm.nc * dm.ptiles > 2147483647LL) return -5;
  const int per = dtype == 1 ? 8 : 4;  // elements a 16-byte vector
  dm.vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(b) |
             reinterpret_cast<uintptr_t>(c)) & 15) == 0 &&
           p % per == 0 && n % per == 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* stf = static_cast<float*>(state);
  float* cbf = static_cast<float*>(cb);
  float* cumf = static_cast<float*>(cum);
  float* sts = static_cast<float*>(states);
  if (dtype == 1)
    return run<bf16>(which, static_cast<const bf16*>(x), dtf, af,
                     static_cast<const bf16*>(b), static_cast<const bf16*>(c),
                     static_cast<bf16*>(y), stf, cbf, cumf, sts, dm, st);
  return run<float>(which, static_cast<const float*>(x), dtf, af,
                    static_cast<const float*>(b), static_cast<const float*>(c),
                    static_cast<float*>(y), stf, cbf, cumf, sts, dm, st);
}

// Dynamic shared memory of a block of pass `which` (1, 2 or 4; 0 for 3).
long long repro_ssd_smem(int which, int dtype, int n, int chunk) {
  return (long long)smem_bytes(which, dtype == 1, (chunk + 15) / 16 * 16,
                               (n + 15) / 16 * 16);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
