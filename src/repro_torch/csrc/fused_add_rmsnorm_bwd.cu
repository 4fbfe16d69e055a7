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
// rstd * sum(dn * y) / d, so both row sums are taken together.  All
// arithmetic is fp32; each output is cast once.
//
// Bound: no products and no reuse across rows, so bytes.  At the train
// path's 4096 x 960 bf16 it reads dh, dy, x and res and writes dsum, 39 MB:
// 11.7 us at 3.35 TB/s.
//
// Design: one launch a call, a persistent grid, rows streamed through a
// shared-memory ring.
// - Grid.  The wrapper (kernels/fused.py, bwd_plan) sizes the grid to the
//   blocks that fit on the card at once (SMs x blocks an SM) or to the row
//   steps, whichever is fewer; each block walks one contiguous run of
//   rows, `rows_per_step` rows a step.
// - Ring (BULK, every 16-byte plan).  One producer warp, the block's ninth, keeps `stages`
//   steps in flight: per step one elected lane issues four 1-D bulk async
//   copies (cp.async.bulk ... mbarrier::complete_tx), the step's rows of
//   x, res, dh and dy, each one contiguous span of global memory, into one
//   stage of the ring, and the stage's `full` mbarrier counts their bytes.
//   dy arrives with the other three.  The eight consumer warps wait on
//   `full`, compute, and each arrives once on the stage's `empty` mbarrier;
//   the producer waits on `empty` before it refills the stage.  Inside a
//   step these barriers are the only ones (a row of 2-8 warps adds one
//   named barrier among the consumers).  Bulk copies need 16-byte
//   addresses and sizes, which the 16-byte plan guarantees; rows that
//   cannot take them (d not a multiple of the vector, views off a 16-byte
//   boundary) run the scalar plan, register loads in the same one-launch
//   kernel.  (kBulk = false, a source variant in bench/fused_bwd_plans.py,
//   gives the 16-byte plan register loads too, for the ablation.)
// - Rows.  A warp owns a row up to 1024 bf16 / 512 fp32 elements (2-8
//   warps past that), neighbouring lanes on neighbouring 16-byte vectors,
//   so a warp's shared-memory reads are conflict-free.  The first pass
//   reads x, res and dh and takes both sums (shuffles); the second reads
//   them again with dy and writes dsum with 16-byte stores.  The scale is
//   held in registers, in fp32, for the whole run.
// - dscale.  A lane accumulates dh * n for its columns, in fp32 registers,
//   over every row its warp walks; at the block's end the row groups'
//   sums are added in group order through shared memory (the ring's, free
//   by then) and the block writes one fp32 partial row.  The sum across
//   blocks is in the same launch: once its partial row is visible
//   (__threadfence), a block takes a ticket (one atomicAdd on a counter).
//   The last kReducers blocks to take one (all of them in a smaller grid)
//   wait for the count to reach the grid and each adds one slice of the
//   columns over every block's partial row: each group of kGroupBlocks
//   consecutive blocks in block order, then the groups in group order, and
//   writes that slice of dscale.  The tickets only choose which blocks add;
//   they order nothing that is added, so the sum is fixed and two runs
//   agree bit for bit (no atomics on data).  The last reducer to stop
//   waiting sets both counters back to 0: allocated and zeroed once per
//   (device, stream) by the wrapper, they are zero between calls, with no
//   memset a call.
// - No waiting block may keep a block still to come off the card.  Every
//   SM holds at least one block of a kernel that launches at all, so the
//   wait ends if the grid has no more blocks than SMs (all of them run at
//   once) or fewer reducers than SMs (an SM stays free for the rest).  The
//   C entry refuses any other grid (-4); the wrapper's planner never makes
//   one (kernels/fused.py, bwd_plan).
// - The tail after the last row is latency, not bytes, and it was most of
//   the distance to the bound (bench/fused_bwd_plans.py): one block adding
//   every column takes one SM through 0.5 MB of partial rows (128 x 960),
//   so the columns are split over kReducers = 16 blocks, and a thread keeps
//   the loads of kBatch = 8 partial rows of 4 columns in flight at once (8
//   measured a little faster than 16; 8-32 reducers and groups of 4-16
//   blocks within 1 us of each other).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;       // consumer warps a block
constexpr int kMaxVals = 8;     // 16-byte values a lane holds
constexpr int kMaxStages = 4;   // ring stages
constexpr int kSpans = 4;       // x, res, dh, dy: one bulk copy each a step
constexpr int kBatch = 8;       // partial rows a thread loads at once
constexpr int kReducers = 16;   // blocks that add dscale, a column slice each
constexpr int kGroupBlocks = 16;  // partial rows added in block order at once
constexpr bool kBulk = true;    // the 16-byte plan through the ring

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

// One value from a row in global or (BULK) shared memory.
template <typename T, int VALS, bool VEC>
__device__ __forceinline__ uint4 load_value(const T* src, int d, int g,
                                            int v, int lane) {
  constexpr int E = 16 / sizeof(T);
  uint4 dst = make_uint4(0u, 0u, 0u, 0u);
  if (VEC) {
    const int c = column<T, VALS, VEC>(g, v, 0, lane);
    if (c < d) dst = *reinterpret_cast<const uint4*>(src + c);
  } else {
    T* de = reinterpret_cast<T*>(&dst);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = column<T, VALS, VEC>(g, v, e, lane);
      de[e] = c < d ? src[c] : from_f32<T>(0.f);
    }
  }
  return dst;
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

// --- mbarriers and 1-D bulk copies (PTX ISA 8.0, sm_90) -----------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::
               "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::
               "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
               "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both
// 16-byte aligned); completion counts `bytes` on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::
      "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The consumer warps alone (the producer warp never joins).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kWarps * 32) : "memory");
}

// --- the sum across blocks ---------------------------------------------------------

// t = the sum over k < n, in k order, of W columns (from c) of the fp32
// rows src + k * d; the loads of kBatch rows are in flight together.
template <int W>
__device__ __forceinline__ void sum_rows(const float* src, int n, int d,
                                         int c, float (&t)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) t[w] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kBatch) {
    float v[kBatch][W];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (k0 + k >= n) continue;
      const float* at = src + (long long)(k0 + k) * d + c;
      if constexpr (W == 4) {
        const float4 q = __ldcg(reinterpret_cast<const float4*>(at));
        v[k][0] = q.x;
        v[k][1] = q.y;
        v[k][2] = q.z;
        v[k][3] = q.w;
      } else {
        v[k][0] = __ldcg(at);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (k0 + k < n)
#pragma unroll
        for (int w = 0; w < W; ++w) t[w] += v[k][w];
  }
}

// Slice `slot` of `reducers` of dscale's columns (W a unit), added over
// the blocks' partial rows: each group of kGroupBlocks consecutive rows in
// block order, one (group, unit) a thread, then the groups in group order.
// `sums` is shared memory for the group sums.
template <typename T, int W>
__device__ __forceinline__ void add_slice(const float* partial, T* dscale,
                                          int d, int slot, int reducers,
                                          float* sums) {
  const int units = d / W, per = (units + reducers - 1) / reducers;
  const int u0 = slot * per, nu = min(per, units - u0);
  if (nu <= 0) return;
  const int blocks = gridDim.x;
  const int n_groups = (blocks + kGroupBlocks - 1) / kGroupBlocks;
  for (int it = threadIdx.x; it < n_groups * nu; it += blockDim.x) {
    const int grp = it / nu, u = it - grp * nu, b0 = grp * kGroupBlocks;
    float t[W];
    sum_rows<W>(partial + (long long)b0 * d, min(kGroupBlocks, blocks - b0),
                d, (u0 + u) * W, t);
#pragma unroll
    for (int w = 0; w < W; ++w) sums[(grp * nu + u) * W + w] = t[w];
  }
  __syncthreads();
  for (int u = threadIdx.x; u < nu; u += blockDim.x) {
    float t[W];
#pragma unroll
    for (int w = 0; w < W; ++w) t[w] = 0.f;
#pragma unroll 8
    for (int grp = 0; grp < n_groups; ++grp)
#pragma unroll
      for (int w = 0; w < W; ++w) t[w] += sums[(grp * nu + u) * W + w];
#pragma unroll
    for (int w = 0; w < W; ++w) dscale[(u0 + u) * W + w] = from_f32<T>(t[w]);
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// --- the kernel ---------------------------------------------------------------------

// BULK (VEC && kBulk): rows through the shared-memory ring; else register
// loads from global memory, each row's x, res and dh held between passes.
template <typename T, int VALS, bool VEC, bool BULK>
__global__ void __launch_bounds__((kWarps + (BULK ? 1 : 0)) * 32)
fused_add_rmsnorm_bwd(const T* __restrict__ dh, const T* __restrict__ dy,
                      const T* __restrict__ x, const T* __restrict__ res,
                      const T* __restrict__ scale, T* __restrict__ dsum,
                      T* __restrict__ dscale, float* __restrict__ partial,
                      int* __restrict__ counter, int rows, int d, int wpr,
                      int rows_per_step, int rows_per_block, int stages,
                      float eps) {
  static_assert(VEC || !BULK, "bulk copies need the 16-byte plan");
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ float red[2][2][kWarps];
  __shared__ int slot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = kWarps / wpr;          // rows a pass of the warps
  const int first = blockIdx.x * rows_per_block;
  const int last = min(rows, first + rows_per_block);
  const int steps = (last - first + rows_per_step - 1) / rows_per_step;
  const long long span = (long long)rows_per_step * d;   // elements
  const int reducers = min(kReducers, (int)gridDim.x);
  T* ring = reinterpret_cast<T*>(smem);

  if (BULK) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  float acc[VALS][E];     // this lane's columns of dscale, over its rows
#pragma unroll
  for (int v = 0; v < VALS; ++v)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[v][e] = 0.f;
  const int group = warp / wpr, g = warp - group * wpr;  // g: part of the row

  if (BULK && warp == kWarps) {
    // the producer: keep `stages` steps in flight
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) - 1) & 1);
        const int r0 = first + i * rows_per_step;
        const uint32_t bytes =
            (uint32_t)(min(rows_per_step, last - r0) * d * (int)sizeof(T));
        const long long off = (long long)r0 * d;
        T* dst = ring + s * kSpans * span;
        mbar_arrive_expect_tx(&full[s], kSpans * bytes);
        bulk_load(dst, x + off, bytes, &full[s]);
        bulk_load(dst + span, res + off, bytes, &full[s]);
        bulk_load(dst + 2 * span, dh + off, bytes, &full[s]);
        bulk_load(dst + 3 * span, dy + off, bytes, &full[s]);
      }
    }
    __syncwarp();
  } else if (warp < kWarps) {
    float sc[VALS][E];   // the scale in fp32, for the whole run
#pragma unroll
    for (int v = 0; v < VALS; ++v) {
      const uint4 raw = load_value<T, VALS, VEC>(scale, d, g, v, lane);
      const T* se = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < E; ++e) sc[v][e] = to_f32(se[e]);
    }
    const int passes = (rows_per_step + groups - 1) / groups;
    int parity = 0;
    for (int i = 0; i < steps; ++i) {
      const int r0 = first + i * rows_per_step;
      const int n = min(rows_per_step, last - r0);
      const int s = BULK ? i % stages : 0;
      // the step's first row of each input: in the ring, or in global memory
      const T *xs, *rs, *hs, *ys;
      if (BULK) {
        mbar_wait(&full[s], (i / stages) & 1);
        xs = ring + s * kSpans * span;
        rs = xs + span;
        hs = xs + 2 * span;
        ys = xs + 3 * span;
      } else {
        const long long off = (long long)r0 * d;
        xs = x + off;
        rs = res + off;
        hs = dh + off;
        ys = dy + off;
      }
      // every consumer warp takes the same passes, so the barrier is uniform
      for (int p = 0; p < passes; ++p, parity ^= 1) {
        const int r = group + p * groups;
        const bool live = r < n;
        const long long o = (long long)r * d;
        uint4 xv[VALS], rv[VALS], hv[VALS];   // held on the register path
        float ss = 0.f, sd = 0.f;             // sum y^2, sum dn * y
        if (live) {
#pragma unroll
          for (int v = 0; v < VALS; ++v) {
            xv[v] = load_value<T, VALS, VEC>(xs + o, d, g, v, lane);
            rv[v] = load_value<T, VALS, VEC>(rs + o, d, g, v, lane);
            hv[v] = load_value<T, VALS, VEC>(hs + o, d, g, v, lane);
            const T* xe = reinterpret_cast<const T*>(&xv[v]);
            const T* re = reinterpret_cast<const T*>(&rv[v]);
            const T* he = reinterpret_cast<const T*>(&hv[v]);
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const float yf = to_f32(xe[e]) + to_f32(re[e]);
              ss = fmaf(yf, yf, ss);
              sd = fmaf(to_f32(he[e]) * sc[v][e], yf, sd);
            }
          }
        }
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) {
          ss += __shfl_xor_sync(0xffffffffu, ss, m);
          sd += __shfl_xor_sync(0xffffffffu, sd, m);
        }
        if (wpr > 1) {  // the row's warps meet once; same order in every thread
          if (lane == 0) {
            red[parity][0][warp] = ss;
            red[parity][1][warp] = sd;
          }
          consumers_sync();
          ss = sd = 0.f;
          for (int k = 0; k < wpr; ++k) {
            ss += red[parity][0][group * wpr + k];
            sd += red[parity][1][group * wpr + k];
          }
        }
        if (!live) continue;
        const float rstd = rsqrtf(ss / (float)d + eps);
        const float c = sd * rstd / (float)d;  // mean(dn * n)
        T* orow = dsum + (long long)(r0 + r) * d;
#pragma unroll
        for (int v = 0; v < VALS; ++v) {
          if (BULK) {   // read again from the ring: fewer live registers
            xv[v] = load_value<T, VALS, VEC>(xs + o, d, g, v, lane);
            rv[v] = load_value<T, VALS, VEC>(rs + o, d, g, v, lane);
            hv[v] = load_value<T, VALS, VEC>(hs + o, d, g, v, lane);
          }
          const uint4 yv = load_value<T, VALS, VEC>(ys + o, d, g, v, lane);
          const T* xe = reinterpret_cast<const T*>(&xv[v]);
          const T* re = reinterpret_cast<const T*>(&rv[v]);
          const T* he = reinterpret_cast<const T*>(&hv[v]);
          const T* ye = reinterpret_cast<const T*>(&yv);
          uint4 out;
          T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float nf = (to_f32(xe[e]) + to_f32(re[e])) * rstd;
            const float hf = to_f32(he[e]);
            const float dn = hf * sc[v][e];
            oe[e] = from_f32<T>(to_f32(ye[e]) + rstd * (dn - nf * c));
            acc[v][e] = fmaf(hf, nf, acc[v][e]);
          }
          store_value<T, VALS, VEC>(orow, out, d, g, v, lane);
        }
      }
      if (BULK) {   // this warp is done with the stage
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }
  }

  // the block's partial row of dscale: row groups added in group order
  __syncthreads();                       // every step consumed: the ring is free
  float* fold = reinterpret_cast<float*>(smem);    // (groups, d)
  if (warp < kWarps) {
#pragma unroll
    for (int v = 0; v < VALS; ++v) {
      if (VEC) {   // 16-byte stores: lanes 16 or 32 bytes apart, not E words
        const int col = column<T, VALS, VEC>(g, v, 0, lane);
        if (col < d)
#pragma unroll
          for (int e = 0; e < E; e += 4)
            *reinterpret_cast<float4*>(fold + group * d + col + e) =
                make_float4(acc[v][e], acc[v][e + 1], acc[v][e + 2],
                            acc[v][e + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int col = column<T, VALS, VEC>(g, v, e, lane);
          if (col < d) fold[group * d + col] = acc[v][e];
        }
      }
    }
  }
  __syncthreads();
  float* prow = partial + (long long)blockIdx.x * d;
  if (VEC) {   // d % 4 == 0: four columns a thread
    for (int col = 4 * threadIdx.x; col < d; col += 4 * blockDim.x) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < groups; ++k) {
        const float4 f = *reinterpret_cast<const float4*>(fold + k * d + col);
        t.x += f.x;
        t.y += f.y;
        t.z += f.z;
        t.w += f.w;
      }
      *reinterpret_cast<float4*>(prow + col) = t;
    }
  } else {
    for (int col = threadIdx.x; col < d; col += blockDim.x) {
      float t = 0.f;
      for (int k = 0; k < groups; ++k) t += fold[k * d + col];
      prow[col] = t;
    }
  }

  // the sum across blocks: every block takes a ticket once its partial row
  // is visible; the last `reducers` to take one wait for the rest (the C
  // entry's grid check keeps that wait finite), and each
  // adds one slice of the columns over every block's row.  The tickets pick
  // who adds, not the order of the adding.
  __syncthreads();                       // the block's partial row is written
  if (threadIdx.x == 0) {
    __threadfence();                     // ... and visible before its ticket
    slot = atomicAdd(&counter[0], 1) - ((int)gridDim.x - reducers);
    if (slot >= 0) {
      while (ld_acquire(counter) < (int)gridDim.x) {
      }
      if (atomicAdd(&counter[1], 1) == reducers - 1) {  // no one reads them now
        counter[0] = 0;                  // re-armed for the next call
        counter[1] = 0;
      }
    }
  }
  __syncthreads();
  if (slot < 0) return;
  float* sums = reinterpret_cast<float*>(smem);
  if (d % 4 == 0)
    add_slice<T, 4>(partial, dscale, d, slot, reducers, sums);
  else
    add_slice<T, 1>(partial, dscale, d, slot, reducers, sums);
}

struct Args {
  const void *dh, *dy, *x, *res, *scale;
  void *dsum, *dscale;
  float* partial;
  int* counter;
  int rows, d, wpr, rows_per_step, rows_per_block, blocks, stages;
  float eps;
  cudaStream_t stream;
};

// Dynamic shared memory: the largest of the ring (BULK), the dscale fold
// and a slice's group sums.
size_t smem_bytes(bool bulk, int elem, int d, int wpr, int rows_per_step,
                  int stages, int blocks) {
  const size_t ring = bulk ? (size_t)stages * kSpans * rows_per_step * d * elem
                           : 0;
  const size_t fold = sizeof(float) * (size_t)(kWarps / wpr) * d;
  const int reducers = blocks < kReducers ? blocks : kReducers;
  const int w = d % 4 == 0 ? 4 : 1, per = (d / w + reducers - 1) / reducers;
  const size_t red = sizeof(float) *
                     (size_t)((blocks + kGroupBlocks - 1) / kGroupBlocks) *
                     per * w;
  const size_t most = ring > fold ? ring : fold;
  return most > red ? most : red;
}

template <typename T, int VALS, bool VEC, bool BULK>
int launch_as(const Args& a) {
  const size_t smem = smem_bytes(BULK, sizeof(T), a.d, a.wpr,
                                 a.rows_per_step, a.stages, a.blocks);
  auto kern = fused_add_rmsnorm_bwd<T, VALS, VEC, BULK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (BULK) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<a.blocks, (kWarps + (BULK ? 1 : 0)) * 32, smem, a.stream>>>(
      static_cast<const T*>(a.dh), static_cast<const T*>(a.dy),
      static_cast<const T*>(a.x), static_cast<const T*>(a.res),
      static_cast<const T*>(a.scale), static_cast<T*>(a.dsum),
      static_cast<T*>(a.dscale), a.partial, a.counter, a.rows, a.d, a.wpr,
      a.rows_per_step, a.rows_per_block, a.stages, a.eps);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC, bool BULK>
int launch_vals(int vals, const Args& a) {
  switch (vals) {
    case 1: return launch_as<T, 1, VEC, BULK>(a);
    case 2: return launch_as<T, 2, VEC, BULK>(a);
    case 4: return launch_as<T, 4, VEC, BULK>(a);
    case 8:   // fp32 rows past 4096; no bf16 row up to 8192 needs 8
      if constexpr (sizeof(T) == 4) return launch_as<T, 8, VEC, BULK>(a);
      return -2;
    default: return -2;
  }
}

// The 16-byte plan streams rows through the ring (kBulk); the scalar plan
// loads them into registers.
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
    return launch_vals<T, true, kBulk>(vals, a);
  }
  return launch_vals<T, false, false>(vals, a);
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code if the launch was refused, or a
// negative code for an argument the kernel does not take: -1 dtype, -2 plan
// (vals and wpr each 1, 2, 4 or 8 covering d; rows_per_block a whole
// number of steps; every block given rows and the blocks covering them;
// stages 1..4 on the 16-byte plan), -3 16-byte accesses asked for on rows
// that cannot take them, -4 a grid whose waiting reducers could hold
// every SM while blocks still wait for one (more blocks than SMs and at
// least as many reducers as SMs).  dtype: 0 float32, 1 bfloat16.
// partial: fp32 (blocks, d) scratch.  counter: two int32, zero, left zero.
// One kernel on `stream`.
int repro_fused_add_rmsnorm_bwd(const void* dh, const void* dy, const void* x,
                                const void* res, const void* scale,
                                void* dsum, void* dscale, void* partial,
                                void* counter, int dtype, int device,
                                int rows, int d, int vector, int vals,
                                int wpr, int rows_per_step,
                                int rows_per_block, int blocks, int stages,
                                float eps, void* stream) {
  if (wpr < 1 || wpr > kWarps || (wpr & (wpr - 1)) || vals < 1 ||
      vals > kMaxVals || d < 1 || rows < 1 || rows_per_step < 1 ||
      rows_per_block < rows_per_step || rows_per_block % rows_per_step != 0 ||
      blocks < 1 || (long long)blocks * rows_per_block < rows ||
      (long long)(blocks - 1) * rows_per_block >= rows ||
      (vector && (stages < 1 || stages > kMaxStages)))
    return -2;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (blocks > sms && (blocks < kReducers ? blocks : kReducers) >= sms)
    return -4;
  const Args a{dh, dy, x, res, scale, dsum, dscale,
               static_cast<float*>(partial), static_cast<int*>(counter),
               rows, d, wpr, rows_per_step, rows_per_block, blocks,
               vector ? stages : 0, eps, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch<float>(vector, vals, a);
    case 1: return launch<__nv_bfloat16>(vector, vals, a);
    default: return -1;
  }
}

// The dynamic shared memory of a launch (the arguments as above; elem the
// element's bytes), for the report of the build.
long long repro_fused_add_rmsnorm_bwd_smem(int vector, int elem, int d,
                                           int wpr, int rows_per_step,
                                           int stages, int blocks) {
  return (long long)smem_bytes(vector && kBulk, elem, d, wpr, rows_per_step,
                               stages, blocks);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
