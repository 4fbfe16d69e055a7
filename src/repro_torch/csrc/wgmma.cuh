// wgmma and cp.async building blocks for Hopper (sm_90a), shared by the
// flash-attention kernels: the forward (flash_attention.cu) and the
// backward (flash_attention_bwd.cu).  Device functions only; each source
// that includes this file compiles into its own library.  The CUDA-core
// (fp32 FMA) kernels of both share the last section: rows staged by
// 16-byte cp.async copies at a padded stride (copy_rows), read back as fp32
// (ld) and written out in the output type (st).  The two products
// their wgmma kernels are built from: mma_scores (S = A B^T over
// d, both tiles in shared memory) and mma_rs_tile (C += A B over a tile's
// rows, A the bf16 packing of a score fragment in registers, to_a).
//
// Shared-memory tiles use the no-swizzle ("interleave") core-matrix layout:
// a core matrix is 8 rows x 16 bytes, stored as 128 contiguous bytes; the
// 8-row groups of a tile follow each other, D * 16 bytes apart, and inside a
// group the D / 8 core matrices along d are 128 bytes apart (load_tile).
// With that layout a tile of rows (row, d) is
//   - the K-major operand of a product over d (A of S = Q K^T, or B):
//     k-step kk at +256 kk, desc(addr, 128, D * 16);
//   - the MN-major B operand of a product over its rows (V in P V):
//     k-step kk (rows 16 kk ..) at +2 * D * 16 * kk, desc(addr, D * 16, 128).
//
// Accumulator fragment of a 64 x N wgmma: thread t of the warpgroup (warp
// w = t / 32, lane l) holds rows 16 w + l / 4 (registers 4 j, 4 j + 1) and
// that + 8 (4 j + 2, 4 j + 3), columns 8 j + 2 (l % 4) and + 1.  Columns
// 16 kk .. 16 kk + 15, registers 8 kk .. 8 kk + 7, packed in pairs, are the
// register A fragment of a following product's k-step kk.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; ok == false copies nothing and
// writes 16 zero bytes
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
// 4 bytes global -> shared, asynchronously (through L1: .cg takes only 16);
// ok == false writes 4 zero bytes
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>   // until at most N committed groups are pending
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// the copies were generic-proxy writes; wgmma reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins a register's value to this point of the program, so the compiler
// moves no read or write of an accumulator across a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// Shared-memory matrix descriptor, no-swizzle layout (type 0, base offset 0):
// start address, leading byte offset (between core matrices along K) and
// stride byte offset (between core matrices along M or N), each >> 4.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

#define REPRO_F8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S (64 x 64, fp32) (+)= A (64 x 16) B (16 x 64), both from shared memory,
// both K-major; accumulate == 0 overwrites S.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_F8(0), REPRO_F8(8), REPRO_F8(16), REPRO_F8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// O (64 x N, fp32) += A (64 x 16, bf16 in registers) B (16 x N), B from
// shared memory MN-major (transpose bit set).
template <int N>
struct MmaRS;

template <>
struct MmaRS<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : REPRO_F8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct MmaRS<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : REPRO_F8(0), REPRO_F8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct MmaRS<48> {
  static __device__ __forceinline__ void run(float (&d)[24], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : REPRO_F8(0), REPRO_F8(8), REPRO_F8(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct MmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : REPRO_F8(0), REPRO_F8(8), REPRO_F8(16), REPRO_F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct MmaRS<80> {
  static __device__ __forceinline__ void run(float (&d)[40], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : REPRO_F8(0), REPRO_F8(8), REPRO_F8(16), REPRO_F8(24), REPRO_F8(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct MmaRS<96> {
  static __device__ __forceinline__ void run(float (&d)[48], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : REPRO_F8(0), REPRO_F8(8), REPRO_F8(16), REPRO_F8(24), REPRO_F8(32), REPRO_F8(40)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct MmaRS<112> {
  static __device__ __forceinline__ void run(float (&d)[56], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
        : REPRO_F8(0), REPRO_F8(8), REPRO_F8(16), REPRO_F8(24), REPRO_F8(32), REPRO_F8(40), REPRO_F8(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct MmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : REPRO_F8(0), REPRO_F8(8), REPRO_F8(16), REPRO_F8(24), REPRO_F8(32), REPRO_F8(40), REPRO_F8(48), REPRO_F8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef REPRO_F8

// Copy ROWS x D bf16 rows [row0, row0 + ROWS) of src (row stride `stride`
// elements) into the interleaved layout at dst; rows at or past `limit`
// become zeros.  Copy i is 16-byte piece i % (D / 8) of row i / (D / 8), so
// the lanes of a warp read whole rows (one L2 request a 128-byte line); the
// piece lands in its core matrix, 128 bytes from its row's neighbours.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int limit, int tid) {
  constexpr int PIECES = D / 8;
  const uint32_t base = smem_addr(dst);
#pragma unroll
  for (int i = tid; i < ROWS * PIECES; i += NT) {
    const int r = i / PIECES, c = i % PIECES, row = row0 + r;
    const bool ok = row < limit;
    cp_async_16(base + (r >> 3) * D * 16 + c * 128 + (r & 7) * 16,
                ok ? src + row * stride + c * 8 : src, ok);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The 64 x 64 fp32 fragment x as the bf16 A fragments of 4 k-steps (of 16
// columns): hi, its rounding, and with SPLIT lo, the rounding of x - hi
// (exact in fp32), so hi + lo keeps x to about 16 bits.
template <bool SPLIT>
__device__ __forceinline__ void to_a(const float (&x)[32], uint32_t (&hi)[4][4],
                                     uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = x[8 * kk + 2 * e], x1 = x[8 * kk + 2 * e + 1];
      const uint32_t h = pack_bf16(x0, x1);
      hi[kk][e] = h;
      if constexpr (SPLIT)
        lo[kk][e] = pack_bf16(x0 - __uint_as_float(h << 16),
                              x1 - __uint_as_float(h & 0xffff0000u));
    }
}

template <bool SPLIT>
__device__ __forceinline__ void pin_a(uint32_t (&hi)[4][4],
                                      uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pin(hi[kk]);
    if constexpr (SPLIT) pin(lo[kk]);
  }
}

// acc (64 x D) += A B over 64 rows of B: 4 k-steps of 16 rows (2 row
// groups each), B the MN-major tile (row, d) at b_addr; A from registers,
// with SPLIT its hi and then its lo part.
template <int D, bool SPLIT>
__device__ __forceinline__ void mma_rs_tile(float (&acc)[D / 2],
                                           const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4],
                                           uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t b = desc(b_addr + 2 * D * 16 * kk, D * 16, 128);
    MmaRS<D>::run(acc, hi[kk], b);
    if constexpr (SPLIT) MmaRS<D>::run(acc, lo[kk], b);
  }
}

// s (64 x 64, fp32) = A B^T over d: A and B are 64-row tiles (row, d) at
// a_addr and b_addr, both K-major operands; D / 16 k-steps.
template <int D>
__device__ __forceinline__ void mma_scores(float (&s)[32], uint32_t a_addr,
                                           uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_ss_n64(s, desc(a_addr + 256 * kk, 128, D * 16),
               desc(b_addr + 256 * kk, 128, D * 16), kk > 0);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU op; -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// --- the CUDA-core (fp32 FMA) attention kernels' staged tiles ---------------

__device__ __forceinline__ float half_max(float x) {  // over the 16 lanes of a half-warp
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// N consecutive staged values as fp32 (one 4N- or 2N-byte shared load)
template <int N>
__device__ __forceinline__ void ld(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = *p;
  }
}
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
template <int N>
__device__ __forceinline__ void ld(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    out[0] = bf16_lo(x.x); out[1] = bf16_hi(x.x);
    out[2] = bf16_lo(x.y); out[3] = bf16_hi(x.y);
  } else if constexpr (N == 2) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
    out[0] = bf16_lo(x); out[1] = bf16_hi(x);
  } else {
    out[0] = __bfloat162float(*p);
  }
}

// N consecutive outputs, rounded to T (nearest even, as torch's cast)
template <int N>
__device__ __forceinline__ void st(float* p, const float* x) {
  if constexpr (N == 4) *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else if constexpr (N == 2) *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else *p = x[0];
}
template <int N>
__device__ __forceinline__ void st(__nv_bfloat16* p, const float* x) {
  if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(x[0], x[1]);
  } else {
    *p = __float2bfloat16(x[0]);
  }
}

// copy_rows with every piece's addresses computed afresh: copy i is piece
// i % (D / E) of row i / (D / E)
template <typename T, int D, int LD, int ROWS, int NT>
__device__ __forceinline__ void copy_rows_each(T* dst, const T* src,
                                               long long stride, int row0,
                                               int limit, int tid) {
  constexpr int E = 16 / sizeof(T), PIECES = D / E;
  const uint32_t base = smem_addr(dst);
#pragma unroll
  for (int i = tid; i < ROWS * PIECES; i += NT) {
    const int r = i / PIECES, c = i - r * PIECES, row = row0 + r;
    const bool ok = row < limit;
    cp_async_16(base + (uint32_t)((r * LD + c * E) * sizeof(T)),
                ok ? src + row * stride + c * E : src, ok);
  }
}

// Rows row0 .. row0 + ROWS - 1 of a (seq, D) slice with row stride
// `stride` into shared memory at a row stride of LD elements, by 16-byte
// cp.async copies; rows at or past `limit` are zero-filled.  Where the
// threads cover whole rows (NT a multiple of the pieces a row), a thread
// copies the same piece of every RP-th row, so its addresses step by a
// constant; otherwise copy_rows_each.
template <typename T, int D, int LD, int ROWS, int NT>
__device__ __forceinline__ void copy_rows(T* dst, const T* src,
                                          long long stride, int row0,
                                          int limit, int tid) {
  constexpr int E = 16 / sizeof(T), PIECES = D / E;
  const uint32_t base = smem_addr(dst);
  if constexpr (NT % PIECES == 0) {
    constexpr int RP = NT / PIECES;
    const int r0 = tid / PIECES, c = tid % PIECES;
    if (RP > ROWS && r0 >= ROWS) return;
    const T* s = src + (row0 + r0) * stride + c * E;
    const uint32_t d = base + (uint32_t)((r0 * LD + c * E) * sizeof(T));
#pragma unroll
    for (int n = 0; n < (ROWS + RP - 1) / RP; ++n) {
      const bool ok = row0 + r0 + n * RP < limit;
      cp_async_16(d + (uint32_t)(n * RP * LD * sizeof(T)),
                  ok ? s + n * RP * stride : src, ok);
    }
  } else {
    copy_rows_each<T, D, LD, ROWS, NT>(dst, src, stride, row0, limit, tid);
  }
}

}  // namespace hopper
