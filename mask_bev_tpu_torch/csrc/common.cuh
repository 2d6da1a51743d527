// Shared helpers of the port's CUDA kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define MB_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// round an f32 value to the storage type T and back (identity for f32)
template <typename T> __device__ __forceinline__ float rd(float v) {
  return to_f(from_f<T>(v));
}
__device__ __forceinline__ float rd_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// exact erf GELU, as the reference XLA path computes it
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752440f));
}

static inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ---- tensor-core fragments (mma.sync m16n8k16, bf16 in, f32 out) --------
// Lane (g, t) = (lane / 4, lane % 4). A (16 x 16, row-major): a0 = row g,
// columns 2t, 2t+1; a1 = row g+8; a2, a3 = the same rows at columns + 8.
// B (16 x 8, k x n): b0 = rows 2t, 2t+1 of column g; b1 = rows + 8.
// C (16 x 8): c0, c1 = row g, columns 2t, 2t+1; c2, c3 = row g+8.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 m16n8k8 (f32 accumulation), the k8 half of m16n8k16: a0 = row g,
// columns 2t, 2t+1; a1 = row g+8; b0 = rows 2t, 2t+1 of column g
__device__ __forceinline__ void mma_1688_bf16(float (&c)[4],
                                              const uint32_t (&a)[2],
                                              uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// TF32 (m16n8k8, f32 accumulation). Lane (g, t): A (16 x 8): a0 = (g, t),
// a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4); B (8 x 8, k x
// n): b0 = (t, g), b1 = (t + 4, g); C as for m16n8k16.
__device__ __forceinline__ void mma_1688_tf32(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo to within 2^-22 |x|, both TF32 values (the low 13 bits of
// the f32 word zero): hi = rna(x), lo = rna(x - hi), rounded to nearest,
// ties away from zero, as the tensor core would otherwise truncate. The
// three products hi.hi + hi.lo + lo.hi ("3xTF32") then carry an f32
// product to within a few f32 roundings. lo is 0 where hi is not finite,
// so infinities pass through (and NaN stays NaN in hi).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float h = __uint_as_float(hi);
  const float r = __fsub_rn(x, h);
  uint32_t l;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l) : "f"(r));
  lo = isfinite(h) ? l : 0u;
}

// split_tf32 for values known to be finite (no infinity check)
__device__ __forceinline__ void split_tf32_finite(float x, uint32_t& hi,
                                                  uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;"
      : "=r"(lo)
      : "f"(__fsub_rn(x, __uint_as_float(hi))));
}

// a 3xTF32 operand: the f32 words of a fragment split into TF32 halves
template <int N>
struct Tf32x2 {
  uint32_t hi[N], lo[N];
};

template <int N>
__device__ __forceinline__ Tf32x2<N> split_frag(const uint32_t (&v)[N]) {
  Tf32x2<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i)
    split_tf32_finite(__uint_as_float(v[i]), f.hi[i], f.lo[i]);
  return f;
}

// c += a . b in 3xTF32 (lo.hi + hi.lo, then hi.hi), both operands split
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Tf32x2<4>& a,
                                           const Tf32x2<2>& b) {
  mma_1688_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_1688_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_1688_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// the same with the f32 words of a (4) and b (2) split in registers
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  const uint32_t b[2] = {b0, b1};
  mma_3xtf32(c, split_frag(a), split_frag(b));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x1(uint32_t& r0, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];"
               : "=r"(r0)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// eight consecutive values of T (bf16 or f32) from / to one 16-byte word
// (bf16) or two (f32), as f32
__device__ __forceinline__ void ld8(const bf16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = __bfloat162float(e[q]);
}
__device__ __forceinline__ void ld8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void st8(bf16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ void st8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// ---- rows of any width, walked in 8-value words --------------------------
// Word wd of a row of C values holds values 8 wd .. 8 wd + 7, the last word
// only n = C - 8 wd of them when C % 8 != 0. A whole word whose row starts
// at a 16-byte aligned address (``vec``) is one 16-byte access in bf16 (two
// in f32); any other word goes value by value, values past C reading as 0.
__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
__device__ __forceinline__ void ld_word(const T* p, int n, bool vec,
                                        float (&v)[8]) {
  if (vec && n >= 8) {
    ld8(p, v);
    return;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = q < n ? to_f(p[q]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void st_word(T* p, int n, bool vec,
                                        const float (&v)[8]) {
  if (vec && n >= 8) {
    st8(p, v);
    return;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (q < n) p[q] = from_f<T>(v[q]);
}

// sum over the G lanes of an aligned group (G a power of two up to 32)
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The row walk: lane l of a group of G lanes visits words l, l + G, ... of
// the row at xr, calling f(wd, n, v) with each word's n values (as f32,
// zero past C). A row wider than a kernel's register tile is walked so,
// once for each pass over it (the later passes read it from L1 or L2).
template <typename T, typename F>
__device__ __forceinline__ void row_walk(const T* xr, int C, int l, int G,
                                         bool vec, F&& f) {
  const int words = (C + 7) / 8;
  for (int wd = l; wd < words; wd += G) {
    const int n = min(8, C - 8 * wd);
    float v[8];
    ld_word(xr + 8 * wd, n, vec, v);
    f(wd, n, v);
  }
}

// LayerNorm statistics of a row of any width C by row_walk: f32 mean and
// rstd = rsqrt(var + eps), the variance two-pass E[(x - mean)^2] (the Swin
// blocks' LayerNormP) or, FAST, flax's max(0, E[x^2] - mean^2) (kernel 9).
// Every lane of the group returns both.
template <bool FAST, typename T>
__device__ __forceinline__ void ln_row_stats(const T* xr, int C, int l, int G,
                                             bool vec, float eps, float& mean,
                                             float& rstd) {
  float s = 0.f, s2 = 0.f;
  row_walk(xr, C, l, G, vec, [&](int, int, const float (&v)[8]) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      s += v[q];
      if (FAST) s2 = fmaf(v[q], v[q], s2);
    }
  });
  mean = group_sum(s, G) / (float)C;
  float var;
  if (FAST) {
    var = fmaxf(group_sum(s2, G) / (float)C - mean * mean, 0.f);
  } else {
    float d2 = 0.f;
    row_walk(xr, C, l, G, vec, [&](int, int n, const float (&v)[8]) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float d = v[q] - mean;
        if (q < n) d2 += d * d;
      }
    });
    var = group_sum(d2, G) / (float)C;
  }
  rstd = rsqrtf(var + eps);
}

// ---- rows held in registers across S warps (C % 8 == 0) -------------------
// The redesign of the walk for rows over 2048 values: the row is read from
// device memory once, every 16-byte load of a lane issued before the first
// reduction, and kept packed in registers for the statistics, the output
// and (Swin) the int8 values. Lane l of warp s of the row's S warps holds
// words l + 32 (s W + i), i < W: row_walk's order at G = 32, cut into S
// runs of W words, so warp s continues the per-lane sums that warp s - 1
// left (chain_sums) and every sum is row_walk's, bit for bit.
// A lane holds at most 16 / S words of a row of 4096 values. Each kernel
// that holds rows so sets its S (LN_WIDE_WARPS, SWIN_LN_WIDE_WARPS).
template <typename T, int WMAX>
struct RowRegs {
  static constexpr int N = sizeof(T) / 2;  // 16-byte vectors a word
  uint4 u[WMAX][N];
};

// this lane's words w0 + 32 i (i < W, below ``words``) of the row at xr
template <typename T, int WMAX>
__device__ __forceinline__ void row_regs_load(RowRegs<T, WMAX>& r,
                                              const T* xr, int w0, int W,
                                              int words) {
  constexpr int N = RowRegs<T, WMAX>::N;
#pragma unroll
  for (int i = 0; i < WMAX; ++i) {
    const uint4* src = reinterpret_cast<const uint4*>(xr + 8 * (w0 + 32 * i));
    if (i < W && w0 + 32 * i < words) {
#pragma unroll
      for (int h = 0; h < N; ++h) r.u[i][h] = src[h];
    }
  }
}

// a held word as 8 f32 values, and 8 values (already of T) back into it
__device__ __forceinline__ void unpack_word(const uint4 (&u)[1], float* v) {
  const bf16* e = reinterpret_cast<const bf16*>(u);
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = __bfloat162float(e[q]);
}
__device__ __forceinline__ void unpack_word(const uint4 (&u)[2], float* v) {
  const float* e = reinterpret_cast<const float*>(u);
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = e[q];
}
__device__ __forceinline__ void pack_word(uint4 (&u)[1], const float* v) {
  u[0] = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ void pack_word(uint4 (&u)[2], const float* v) {
  u[0] = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
  u[1] = make_uint4(__float_as_uint(v[4]), __float_as_uint(v[5]),
                    __float_as_uint(v[6]), __float_as_uint(v[7]));
}

// K row sums in the walk's order: warp sw of the row's S warps runs
// add(acc) on its words after warp sw - 1's per-lane sums (handed over in
// ``part``, K x 32 floats of shared memory a row; one block barrier a
// warp), then the last warp sums its lanes (warp_sum, as group_sum at G =
// 32) and hands the totals to every warp of the row through ``tot`` (K
// floats). Every thread of the block calls it, rows past M included (the
// barriers are the block's). S = 1: no shared memory, no barrier.
template <int S, int K, typename F>
__device__ __forceinline__ void chain_sums(float (&acc)[K], float* part,
                                           float* tot, int sw, int lane,
                                           F&& add) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (sw == k) {
      if (k > 0) {
#pragma unroll
        for (int j = 0; j < K; ++j) acc[j] = part[32 * j + lane];
      }
      add(acc);
      if (k < S - 1) {
#pragma unroll
        for (int j = 0; j < K; ++j) part[32 * j + lane] = acc[j];
      }
    }
    if (S > 1) __syncthreads();
  }
  if (sw == S - 1) {
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] = warp_sum(acc[j]);
    if (S > 1 && lane == 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) tot[j] = acc[j];
    }
  }
  if (S > 1) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] = tot[j];
  }
}

// the largest value over the row's S warps (exact in any order); ``red``:
// S floats of shared memory a row, written once a block
template <int S>
__device__ __forceinline__ float chain_max(float v, float* red, int sw,
                                           int lane) {
  v = warp_max(v);
  if (S == 1) return v;
  if (lane == 0) red[sw] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int k = 1; k < S; ++k) m = fmaxf(m, red[k]);
  return m;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N committed groups of this thread are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// Return codes of the exported functions: 0 or a cudaError_t from the
// launch; MB_BAD_ARGS when the arguments fail the function's own checks;
// MB_ATTR_FAILED + e when cudaFuncSetAttribute refused with error e;
// MB_TMAP_FAILED + r when a TMA tensor map could not be encoded (r the
// CUresult, 0 when cuTensorMapEncodeTiled could not be looked up).
#define MB_BAD_ARGS 100000
#define MB_ATTR_FAILED 200000
#define MB_TMAP_FAILED 300000
