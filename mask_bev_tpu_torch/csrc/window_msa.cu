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
// mask per score instead of a materialised (nW, h, n, n) bias.
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
