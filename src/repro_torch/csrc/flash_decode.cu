// Split-K flash-attention decode for Hopper (sm_90a), bound through ctypes.
//
// Replaces repro/kernels/flash_attention.py::_decode_kernel (Pallas; its
// wrapper is flash_attention_decode, reached through ops.flash_attention_decode
// and layers.attn_decode(impl="pallas")): one query row per (batch, head)
// against a KV cache with a dynamic valid length.  Same numerics:
//   q is divided by sqrt(d) in fp32 and rounded to q's dtype before the
//     product (flash_attention.py:223), so no score is rescaled;
//   scores q.k in fp32; positions >= cache_len are masked (they add
//     exp(-1e30 - m) = 0 in the reference, and exactly 0 here);
//   fp32 running max, sum and accumulator; no key at or past cache_len is
//     read, so cache_len == 0 leaves acc = 0 and l = 0 and the output is
//     0 / max(0, 1e-30) = 0;
//   the output is cast once to q's dtype.
//
// Layout.  q: (B, 1, H, D), k/v: (B, S, KH, D), o: (B, 1, H, D), read through
// their (batch, seq, head) strides with a contiguous last dim, so a view of a
// wider cache buffer is read in place.  K/V must start on a 16-byte boundary
// and have 16-byte multiples for strides (the wrapper checks and raises).
// The valid length comes either as an int argument or from a device int32
// scalar the kernel reads itself, so a length on the card needs no host
// sync.  A length above S is clamped to S.
//
// Bound.  One query row per head: the work is ~1 FLOP per cached byte
// (G FLOPs with a GQA group of G heads), far under the ~295 FLOP/byte where
// the tensor cores would limit, so the kernel is bound by the bytes it
// streams: 2 * B * S * KH * D * elt of K and V, plus q and o, at 3.35 TB/s.
// At (B 1, S 4096, H = KH = 120, D 64) bf16 that is 125.8 MB, 37.6 us.
// Reaching it takes megabytes in flight across all 132 SMs.
//
// Design (flash-decoding):
//   1. Split the keys across blocks.  The grid is (batch x KV head x head
//      group, split); each split is a run of whole 64-key tiles, and the
//      wrapper picks the count (flash_attention.decode_splits) so the grid
//      has about 4 blocks per SM.  A split at or past the length still
//      writes its partial (m = -1e30, l = 0, acc = 0): the scratch is not
//      initialised.
//   2. Warps share keys, not heads.  Each lane reads 16 bytes of a key row
//      (8 bf16 or 4 fp32), LPK lanes cover one row and a warp load covers
//      32 / LPK rows, so every warp streams and computes whatever G is.  The
//      next step's K and V are loaded into registers before the current
//      step is computed, so each warp keeps two steps of loads in flight.
//      A GQA group of up to 8 query heads shares its block's K/V loads
//      (no repeat copy); each lane keeps q and the accumulator for its own
//      dims of every head in registers.
//   3. Scores: a lane-local dot over the lane's slice, a shuffle reduction
//      within the lane group, an online softmax per head per lane group.
//      At the end of the split: a shuffle merge across lane groups, a merge
//      across warps in shared memory, one write of the partial.
//   4. decode_merge: one warp per (batch, query head) combines the splits:
//      M = max m_i, w_i = exp(m_i - M), out = sum w_i acc_i /
//      max(sum w_i l_i, 1e-30), cast once.  With every split empty M =
//      -1e30, w_i = 1 and l = 0, so the output is exactly 0.  With one split
//      the split kernel writes the output itself and no merge is launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 64;
constexpr int kMergeWarps = 4;
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

// 16 bytes of a row as fp32 values
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // bf16 -> fp32 is exact: the 16 bits become the top half of the float
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__host__ __device__ constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
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

// Keys base + u * KPW + slot, u < U, of K and V: 16 bytes each; zeros for a
// key at or past hi (never read) or a lane past the row's last dim.
template <typename T, int U, int KPW>
__device__ __forceinline__ void load_keys(const T* kb, const T* vb,
                                          long long k_ss, long long v_ss,
                                          int base, int slot, int hi,
                                          bool dims, uint4 (&kr)[U],
                                          uint4 (&vr)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int key = base + u * KPW + slot;
    if (dims && key < hi) {
      kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + key * k_ss));
      vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + key * v_ss));
    } else {
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// One block: NH query heads of one (batch, KV head) over one split of keys.
template <typename T, int D, int NH>
__global__ void __launch_bounds__(kThreads)
decode_split(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ part_acc, float* __restrict__ part_ml,
             const int* __restrict__ len_ptr, int len_arg, int s_cache,
             int kv_heads, int group, int head_groups, int split_keys,
             Strides qs, Strides ks, Strides vs, Strides os, float sqrt_d) {
  constexpr int VEC = Vec<T>::N;               // elements a lane loads
  constexpr int LPK = pow2_at_least(D / VEC);  // lanes a key row takes
  constexpr int KPW = 32 / LPK;                // key rows a warp load takes
  constexpr int U = NH <= 2 ? 4 : 2;           // warp loads a step
  constexpr int STEP = KPW * U;                // keys a warp takes a step
  constexpr int STRIDE = kWarps * STEP;        // keys the block takes a step
  __shared__ float red_m[kWarps][NH], red_l[kWarps][NH];
  __shared__ float red_acc[kWarps][NH][D];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane & (LPK - 1), slot = lane / LPK;
  const int d0 = sub * VEC;
  const bool dims = d0 < D;                    // D is a multiple of VEC
  int bx = blockIdx.x;
  const int hg = bx % head_groups;
  bx /= head_groups;
  const int kv_head = bx % kv_heads, batch = bx / kv_heads;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int g0 = hg * NH;
  const int n_heads = min(NH, group - g0);
  const int head0 = kv_head * group + g0;
  int len = len_ptr != nullptr ? *len_ptr : len_arg;
  len = min(max(len, 0), s_cache);
  const int lo = split * split_keys;
  const int hi = min(lo + split_keys, len);    // hi <= lo: an empty split

  float qr[NH][VEC], m[NH], l[NH], acc[NH][VEC];
#pragma unroll
  for (int r = 0; r < NH; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float x = 0.f;
      if (r < n_heads && dims) {
        const float raw = to_f32(q[batch * qs.b + (head0 + r) * qs.h + d0 + j]);
        x = to_f32(from_f32<T>(raw / sqrt_d));   // scale, then round to T
      }
      qr[r][j] = x;
      acc[r][j] = 0.f;
    }
  }

  const T* kb = k + batch * ks.b + kv_head * ks.h + d0;
  const T* vb = v + batch * vs.b + kv_head * vs.h + d0;
  uint4 kc[U], vc[U];
  int base = lo + warp * STEP;
  load_keys<T, U, KPW>(kb, vb, ks.s, vs.s, base, slot, hi, dims, kc, vc);
  for (; base < hi; base += STRIDE) {          // warp-uniform bounds
    uint4 kn[U], vn[U];                        // the next step, in flight
    load_keys<T, U, KPW>(kb, vb, ks.s, vs.s, base + STRIDE, slot, hi, dims,
                         kn, vn);
    float kf[U][VEC], vf[U][VEC];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      Vec<T>::unpack(kc[u], kf[u]);
      Vec<T>::unpack(vc[u], vf[u]);
      valid[u] = base + u * KPW + slot < hi;   // one key: one lane group
    }
#pragma unroll
    for (int r = 0; r < NH; ++r) {
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float x = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) x = fmaf(qr[r][j], kf[u][j], x);
#pragma unroll
        for (int off = 1; off < LPK; off <<= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        s[u] = x;
      }
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (valid[u]) mx = fmaxf(mx, s[u]);
      const float corr = expf(m[r] - mx);
      float p[U], psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = valid[u] ? expf(s[u] - mx) : 0.f;
        psum += p[u];
      }
      l[r] = l[r] * corr + psum;
      m[r] = mx;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float a = acc[r][j] * corr;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(p[u], vf[u][j], a);
        acc[r][j] = a;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kc[u] = kn[u];
      vc[u] = vn[u];
    }
  }

  // merge the warp's lane groups (each saw its own keys)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < NH; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo_r = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mx = fmaxf(m[r], mo);
      const float a = expf(m[r] - mx), b = expf(mo - mx);
      l[r] = l[r] * a + lo_r * b;
      m[r] = mx;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[r][j] = acc[r][j] * a
                    + __shfl_xor_sync(0xffffffffu, acc[r][j], off) * b;
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int r = 0; r < NH; ++r) {
      if (dims) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) red_acc[warp][r][d0 + j] = acc[r][j];
      }
      if (lane == 0) {
        red_m[warp][r] = m[r];
        red_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  // merge the warps; write the split's partial, or the output if it is the
  // only split
  for (int i = tid; i < NH * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    if (r >= n_heads) break;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w][r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(red_m[w][r] - mx);
      lsum += wt * red_l[w][r];
      a += wt * red_acc[w][r][d];
    }
    const int head = head0 + r;
    if (n_splits == 1) {
      o[batch * os.b + head * os.h + d] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
    } else {
      const long long row =
          ((long long)batch * kv_heads * group + head) * n_splits + split;
      part_acc[row * D + d] = a;
      if (d == 0) {
        part_ml[2 * row] = mx;
        part_ml[2 * row + 1] = lsum;
      }
    }
  }
}

// One warp per (batch, query head): combine its n_splits partials.
template <typename T>
__global__ void __launch_bounds__(kMergeWarps * 32)
decode_merge(const float* __restrict__ part_acc,
             const float* __restrict__ part_ml, T* __restrict__ o, int rows,
             int heads, int n_splits, int d, long long o_sb, long long o_sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeWarps + warp;
  if (row >= rows) return;                     // the whole warp
  const float* ml = part_ml + (long long)row * n_splits * 2;
  const float* ac = part_acc + (long long)row * n_splits * d;
  float mx = kNegInf;
  for (int i = lane; i < n_splits; i += 32) mx = fmaxf(mx, ml[2 * i]);
  mx = warp_max(mx);
  float lsum = 0.f;
  for (int i = lane; i < n_splits; i += 32)
    lsum += expf(ml[2 * i] - mx) * ml[2 * i + 1];
  const float denom = fmaxf(warp_sum(lsum), 1e-30f);
  const int batch = row / heads, head = row - batch * heads;
  T* ob = o + batch * o_sb + head * o_sh;
  for (int c = lane; c < d; c += 32) {
    float a = 0.f;
    for (int i = 0; i < n_splits; ++i)
      a += expf(ml[2 * i] - mx) * ac[(long long)i * d + c];
    ob[c] = from_f32<T>(a / denom);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float *part_acc, *part_ml;
  const int* len_ptr;
  int len_arg, b, s, h, kh, d, n_splits, split_keys;
  Strides qs, ks, vs, os;
  float sqrt_d;
  cudaStream_t stream;
};

template <typename T, int D, int NH>
int launch(const Args& a) {
  const int group = a.h / a.kh;
  const int head_groups = (group + NH - 1) / NH;
  dim3 grid((unsigned)(a.b * a.kh * head_groups), (unsigned)a.n_splits);
  decode_split<T, D, NH><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.part_acc,
      a.part_ml, a.len_ptr, a.len_arg, a.s, a.kh, group, head_groups,
      a.split_keys, a.qs, a.ks, a.vs, a.os, a.sqrt_d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return (int)err;
  const int rows = a.b * a.h;
  decode_merge<T><<<(rows + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32,
                    0, a.stream>>>(a.part_acc, a.part_ml, static_cast<T*>(a.o),
                                   rows, a.h, a.n_splits, a.d, a.os.b, a.os.h);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_heads(int nh, const Args& a) {
  switch (nh) {  // query heads a block takes: 1, 2, 4 or 8
    case 1: return launch<T, D, 1>(a);
    case 2: return launch<T, D, 2>(a);
    case 4: return launch<T, D, 4>(a);
    case 8: return launch<T, D, 8>(a);
    default: return -7;
  }
}

template <typename T>
int dispatch_d(int nh, const Args& a) {
  switch (a.d) {  // every multiple of 16 up to 128, each its own instantiation
#define REPRO_HEAD_DIM(D) \
    case D: return dispatch_heads<T, D>(nh, a);
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
// dim, -4 block_k, -5 shape, -6 split, -7 heads a block.  dtype: 0 float32,
// 1 bfloat16.  len_ptr: a device int32 scalar holding the valid length, or
// NULL to use len_arg.  n_splits splits of split_keys keys (a multiple of
// 64) cover the cache; with n_splits > 1, part_acc (B, H, n_splits, D) and
// part_ml (B, H, n_splits, 2) are fp32 scratch the split kernel fills and
// the merge kernel reads.  heads_per_block: query heads a block takes.
int repro_flash_decode(const void* q, const void* k, const void* v, void* o,
                       void* part_acc, void* part_ml, const void* len_ptr,
                       int len_arg, int dtype, int device, int b, int s,
                       int h, int kh, int d, int block_k, int n_splits,
                       int split_keys, int heads_per_block, long long q_sb,
                       long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh, long long o_sb, long long o_sh,
                       float sqrt_d, void* stream) {
  if (block_k != kBlockK) return -4;
  if (b < 1 || s < 1 || kh < 1 || h % kh != 0 || heads_per_block < 1 ||
      (long long)b * kh * ((h / kh + heads_per_block - 1) / heads_per_block)
          > 0x7fffffffLL)
    return -5;
  if (n_splits < 1 || n_splits > 65535 || split_keys < kBlockK ||
      split_keys % kBlockK != 0 || (long long)n_splits * split_keys < s ||
      (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return -6;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a{q, k, v, o, static_cast<float*>(part_acc),
         static_cast<float*>(part_ml), static_cast<const int*>(len_ptr),
         len_arg, b, s, h, kh, d, n_splits, split_keys,
         Strides{q_sb, 0, q_sh}, Strides{k_sb, k_ss, k_sh},
         Strides{v_sb, v_ss, v_sh}, Strides{o_sb, 0, o_sh}, sqrt_d,
         static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return dispatch_d<float>(heads_per_block, a);
    case 1: return dispatch_d<__nv_bfloat16>(heads_per_block, a);
    default: return -1;
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
