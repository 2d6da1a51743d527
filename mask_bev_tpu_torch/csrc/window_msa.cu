// Kernel 7: window multi-head self-attention on partitioned windows.
//
// Replaces mask_bev_tpu/ops/pallas_window_msa.py::fused_window_msa
// (_msa_kernel). The chain (ops/window_msa.py):
//   gemm_bf16        qkv = x . Wqkv + b (f32 bias, rounded to bf16; gemm.cuh)
//   window_msa_attn  per (window, head, sample): S = q k^T (f32), scaled
//                    after the product, plus rel[h] + mask[w] (f32, summed
//                    first), f32 softmax rounded to bf16, O = P v (f32),
//                    rounded to bf16
//   gemm_bf16        out = O . Wproj + b (f32 bias, rounded to bf16)
// Windows arrive partitioned: window w of sample b is rows (b nW + w) n ..
// + n of the (B nW n, C) token matrix, so no index math on the grid.
//
// What bounds it on the H100: operations. Per token the two products are
// 2 (3C^2 + C^2) = 8 C^2 operations and attention 4 n C (n = 100): at the
// KITTI backbone (B 8, 200^2 tokens of 192 at stage 0) ~1.3 TFLOP per
// forward for the twelve blocks, ~1.3 ms at the bf16 tensor-core peak.
// Design: the products are the shared tensor-core GEMM; the weights of a
// stage-3 block (C 1536: 14 MB of Wqkv) never have to fit in shared memory.
// Attention keeps one (window, head)'s q, k, v (bf16) and f32 scores in
// shared memory, both of its products on the tensor cores (WMMA 16x16x16),
// and reads the (h, n, n) relative-position bias and the (nW, n, n) shift
// mask per score instead of a materialised (nW, h, n, n) bias. The f32
// instance (window_msa_attn_f32, for f32 windows) keeps q, k, v in f32 and
// takes both products as f32 FMAs, one warp per query row; its projections
// are the f32 GEMM of gemm.cuh. Nothing is rounded below f32 there.
#include <mma.h>

#include "common.cuh"

namespace wmw = nvcuda::wmma;

// grid (nW, heads, B), 256 threads (8 warps); qkv (B nW n, 3C) bf16 with
// channel order [q | k | v] x heads x hd; rel (heads, n, n) f32; mask
// (nW, n, n) f32 or null; out (B nW n, C) bf16. The window's n tokens are
// padded to NP = 16 ceil(n / 16) rows of zeros.
__global__ void __launch_bounds__(256) window_msa_attn_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ rel,
    const float* __restrict__ mask, bf16* __restrict__ out, int nW, int n,
    int C, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const int hd = C / heads;
  const int NP = (n + 15) / 16 * 16;
  const int ldh = hd + 8;  // bf16 rows of q, k, v
  const int lds = NP + 4;  // f32 score rows
  const int ldp = NP + 8;  // bf16 probability rows
  bf16* qs = reinterpret_cast<bf16*>(smraw);
  bf16* ks = qs + NP * ldh;
  bf16* vs = ks + NP * ldh;
  float* S = reinterpret_cast<float*>(vs + NP * ldh);  // NP x (max(NP,hd)+4)
  bf16* P = qs;  // q and k are dead once the scores exist
  float* O = S;  // the scores are dead once p is in P

  const int w = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = ((size_t)b * nW + w) * n;

  // q, k, v of this head: 8 channels (16 bytes) per load
  const int hd8 = hd / 8;
  for (int idx = tid; idx < NP * hd8; idx += blockDim.x) {
    const int t = idx / hd8, d = (idx % hd8) * 8;
    uint4 q = make_uint4(0, 0, 0, 0), k = q, v = q;
    if (t < n) {
      const bf16* r = qkv + (row0 + t) * 3 * C + h * hd + d;
      q = *reinterpret_cast<const uint4*>(r);
      k = *reinterpret_cast<const uint4*>(r + C);
      v = *reinterpret_cast<const uint4*>(r + 2 * C);
    }
    *reinterpret_cast<uint4*>(qs + t * ldh + d) = q;
    *reinterpret_cast<uint4*>(ks + t * ldh + d) = k;
    *reinterpret_cast<uint4*>(vs + t * ldh + d) = v;
  }
  __syncthreads();

  // S = q k^T: NP/16 x NP/16 tiles over the 8 warps
  const int nt = NP / 16;
  for (int tile = warp; tile < nt * nt; tile += 8) {
    const int ti = tile / nt, tj = tile % nt;
    wmw::fragment<wmw::accumulator, 16, 16, 16, float> acc;
    wmw::fill_fragment(acc, 0.f);
    for (int d0 = 0; d0 < hd; d0 += 16) {
      wmw::fragment<wmw::matrix_a, 16, 16, 16, bf16, wmw::row_major> fa;
      wmw::fragment<wmw::matrix_b, 16, 16, 16, bf16, wmw::col_major> fb;
      wmw::load_matrix_sync(fa, qs + ti * 16 * ldh + d0, ldh);
      wmw::load_matrix_sync(fb, ks + tj * 16 * ldh + d0, ldh);
      wmw::mma_sync(acc, fa, fb, acc);
    }
    wmw::store_matrix_sync(S + ti * 16 * lds + tj * 16, acc, lds,
                           wmw::mem_row_major);
  }
  __syncthreads();

  // scale, bias (+ mask), softmax over the n keys; p -> bf16 P, zeros on
  // the padding rows and columns
  const float* relh = rel + (size_t)h * n * n;
  const float* mw = mask ? mask + (size_t)w * n * n : nullptr;
  for (int i = warp; i < NP; i += 8) {
    float* sr = S + i * lds;
    if (i < n) {
      float m = -INFINITY;
      for (int j = lane; j < n; j += 32) {
        float bias = relh[i * n + j];
        if (mw) bias = __fadd_rn(bias, mw[i * n + j]);
        const float v = __fadd_rn(__fmul_rn(sr[j], scale), bias);
        sr[j] = v;
        m = fmaxf(m, v);
      }
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(sr[j] - m);
        sr[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      __syncwarp();
      for (int j = lane; j < NP; j += 32)
        P[i * ldp + j] = __float2bfloat16_rn(j < n ? sr[j] / sum : 0.f);
    } else {
      for (int j = lane; j < NP; j += 32)
        P[i * ldp + j] = __float2bfloat16_rn(0.f);
    }
  }
  __syncthreads();

  // O = P v: NP/16 x hd/16 tiles
  const int dt = hd / 16;
  for (int tile = warp; tile < nt * dt; tile += 8) {
    const int ti = tile / dt, td = tile % dt;
    wmw::fragment<wmw::accumulator, 16, 16, 16, float> acc;
    wmw::fill_fragment(acc, 0.f);
    for (int j0 = 0; j0 < NP; j0 += 16) {
      wmw::fragment<wmw::matrix_a, 16, 16, 16, bf16, wmw::row_major> fa;
      wmw::fragment<wmw::matrix_b, 16, 16, 16, bf16, wmw::row_major> fb;
      wmw::load_matrix_sync(fa, P + ti * 16 * ldp + j0, ldp);
      wmw::load_matrix_sync(fb, vs + j0 * ldh + td * 16, ldh);
      wmw::mma_sync(acc, fa, fb, acc);
    }
    wmw::store_matrix_sync(O + ti * 16 * (hd + 4) + td * 16, acc, hd + 4,
                           wmw::mem_row_major);
  }
  __syncthreads();
  for (int idx = tid; idx < n * hd; idx += blockDim.x) {
    const int i = idx / hd, d = idx % hd;
    out[(row0 + i) * C + h * hd + d] = __float2bfloat16_rn(O[i * (hd + 4) + d]);
  }
}

MB_EXPORT int window_msa_attn(const bf16* qkv, const float* rel,
                              const float* mask, bf16* out, int B, int nW,
                              int n, int C, int heads, float scale,
                              cudaStream_t stream) {
  const int hd = C / heads;
  const int NP = (n + 15) / 16 * 16;
  // P (NP x NP+8 bf16) reuses q and k, O (NP x hd+4 f32) the scores
  if (C % heads || hd % 16 || n > 128 || NP > 2 * hd + 8) return MB_BAD_ARGS;
  const size_t smem = sizeof(bf16) * 3 * NP * (hd + 8) +
                      sizeof(float) * NP * ((NP > hd ? NP : hd) + 4);
  cudaError_t e = cudaFuncSetAttribute(
      window_msa_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  dim3 grid(nW, heads, B);
  window_msa_attn_kernel<<<grid, 256, smem, stream>>>(qkv, rel, mask, out,
                                                      nW, n, C, heads, scale);
  return (int)cudaGetLastError();
}

// f32 instance: grid (nW, heads, B), 256 threads; qkv (B nW n, 3C), out
// (B nW n, C) f32. q, k, v of the (window, head) in shared memory (row
// stride hd + 1: conflict-free column reads); one warp per query row
// (common.cuh::f32_attn_row): its q in registers, lanes over keys for
// S = q k^T (f32 FMA over hd), scaled after the product, plus rel[h] +
// mask[w] (summed first), exact softmax, then lanes over the head's
// channels for P v.
#define WMSA32_THREADS 256
template <int HD>
__global__ void __launch_bounds__(WMSA32_THREADS) window_msa_attn_f32_kernel(
    const float* __restrict__ qkv, const float* __restrict__ rel,
    const float* __restrict__ mask, float* __restrict__ out, int nW, int n,
    int C, int heads, float scale) {
  extern __shared__ __align__(16) float wsm[];
  constexpr int ld = HD + 1;
  float* qs = wsm;
  float* ks = qs + n * ld;
  float* vs = ks + n * ld;
  float* ps = vs + n * ld;  // (WMSA32_THREADS / 32) x n probabilities
  const int w = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const size_t row0 = ((size_t)b * nW + w) * n;
  for (int i = tid; i < n * HD; i += WMSA32_THREADS) {
    const int t = i / HD, d = i % HD;
    const float* r = qkv + (row0 + t) * 3 * C + h * HD + d;
    qs[t * ld + d] = r[0];
    ks[t * ld + d] = r[C];
    vs[t * ld + d] = r[2 * C];
  }
  __syncthreads();
  const float* relh = rel + (size_t)h * n * n;
  const float* mw = mask ? mask + (size_t)w * n * n : nullptr;
  float* pw = ps + warp * n;
  for (int i = warp; i < n; i += WMSA32_THREADS / 32) {
    f32_attn_row<HD>(
        qs + i * ld, ks, vs, ld, n, pw,
        [&](float s, int j) {
          float bias = relh[i * n + j];
          if (mw) bias = __fadd_rn(bias, mw[i * n + j]);
          return __fadd_rn(__fmul_rn(s, scale), bias);
        },
        [&](int d, float o) { out[(row0 + i) * C + h * HD + d] = o; });
  }
}

template <int HD>
static int launch_wmsa_f32(const float* qkv, const float* rel,
                           const float* mask, float* out, int B, int nW,
                           int n, int C, int heads, float scale,
                           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (3 * n * (HD + 1) + (WMSA32_THREADS / 32) * n);
  cudaError_t e = cudaFuncSetAttribute(
      window_msa_attn_f32_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  dim3 grid(nW, heads, B);
  window_msa_attn_f32_kernel<HD><<<grid, WMSA32_THREADS, smem, stream>>>(
      qkv, rel, mask, out, nW, n, C, heads, scale);
  return (int)cudaGetLastError();
}

// head widths 16, 32 or 64, windows of at most 128 tokens
MB_EXPORT int window_msa_attn_f32(const float* qkv, const float* rel,
                                  const float* mask, float* out, int B,
                                  int nW, int n, int C, int heads,
                                  float scale, cudaStream_t stream) {
  if (C % heads || n > 128) return MB_BAD_ARGS;
  switch (C / heads) {
    case 16:
      return launch_wmsa_f32<16>(qkv, rel, mask, out, B, nW, n, C, heads,
                                 scale, stream);
    case 32:
      return launch_wmsa_f32<32>(qkv, rel, mask, out, B, nW, n, C, heads,
                                 scale, stream);
    case 64:
      return launch_wmsa_f32<64>(qkv, rel, mask, out, B, nW, n, C, heads,
                                 scale, stream);
  }
  return MB_BAD_ARGS;
}
