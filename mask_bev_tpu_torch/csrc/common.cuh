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
