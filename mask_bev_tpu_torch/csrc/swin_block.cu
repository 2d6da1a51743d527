// Kernel 3: one whole Swin block, as a chain of launches.
//
// Replaces mask_bev_tpu/ops/pallas_swin_block.py::fused_swin_block_col
// (_block_kernel_col, stages 0-1) and ::fused_swin_block (_block_kernel,
// stages 2-3): the band/col/wpair layouts were Mosaic workarounds; here one
// chain serves every stage on the unpadded (B, H*W, C) token grid:
//   swin_layernorm   LN1 (two-pass f32, eps 1e-6), bf16 out or int8 + scale
//   gemm_*           qkv = LN1 . Wqkv + b                    (gemm.cuh)
//   swin_window_attn (shifted) window attention by index math: windows,
//                    padding and the cyclic shift are address arithmetic on
//                    the padded grid; pad tokens are zero after LN1, so
//                    their k and v are the qkv bias; relative-position bias
//                    and the -100 shift-region mask added to f32 scores
//   swin_quant_rows  per-token int8 quantisation (int8 path)
//   gemm_*           x1 = x + proj(o)
//   swin_layernorm   LN2 (+ int8)
//   gemm_*           h = gelu(fc1) (exact erf GELU)
//   swin_quant_rows  (int8 path)
//   gemm_*           out = x1 + fc2(h)
// int8 follows int8_sim_dense bit for bit: scale max|x|/127 floored at
// 1e-6 (taken, as XLA takes it, as a product with the f32 reciprocal of
// 127), round half to even (rintf), clip to +-127.
//
// What bounds it on the H100: operations. A block does ~12 C^2 multiply-
// adds per token in the four products (int8 or bf16 tensor cores) plus
// 4 n hd multiply-adds per token and head in attention (n = 100). At the
// flagship the backbone's products total ~1.4 TOP per batch of 8 (0.7 ms
// at the int8 peak). Design: the products go through the tiled tensor-core
// GEMM with LN/quantise/bias/GELU/residual work fused into neighbouring
// launches; attention keeps one (window, head)'s q, k, v (bf16) and f32
// scores in shared memory, with both of its products on the tensor cores.
#include <mma.h>

#include "common.cuh"

__global__ void __launch_bounds__(256) swin_layernorm_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const bf16* __restrict__ b, bf16* __restrict__ out,
    signed char* __restrict__ q8, float* __restrict__ sx, int M, int C,
    float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += __bfloat162float(xr[c]);
  const float mean = warp_sum(s) / (float)C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = __bfloat162float(xr[c]) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / (float)C + eps);
  float amax = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float y = rd_bf16(__fadd_rn(
        __fmul_rn(__fmul_rn(__bfloat162float(xr[c]) - mean, rstd),
                  __bfloat162float(w[c])),
        __bfloat162float(b[c])));
    if (out) out[(size_t)row * C + c] = __float2bfloat16_rn(y);
    amax = fmaxf(amax, fabsf(y));
  }
  if (!q8) return;
  const float scale = __fmul_rn(fmaxf(warp_max(amax), 1e-6f), 1.f / 127.f);
  for (int c = lane; c < C; c += 32) {
    const float y = rd_bf16(__fadd_rn(
        __fmul_rn(__fmul_rn(__bfloat162float(xr[c]) - mean, rstd),
                  __bfloat162float(w[c])),
        __bfloat162float(b[c])));
    q8[(size_t)row * C + c] =
        (signed char)fminf(fmaxf(rintf(y / scale), -127.f), 127.f);
  }
  if (lane == 0) sx[row] = scale;
}

__global__ void __launch_bounds__(256) swin_quant_rows_kernel(
    const bf16* __restrict__ x, signed char* __restrict__ q8,
    float* __restrict__ sx, int M, int K) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * K;
  float amax = 0.f;
  for (int c = lane; c < K; c += 32)
    amax = fmaxf(amax, fabsf(__bfloat162float(xr[c])));
  const float scale = __fmul_rn(fmaxf(warp_max(amax), 1e-6f), 1.f / 127.f);
  for (int c = lane; c < K; c += 32)
    q8[(size_t)row * K + c] = (signed char)fminf(
        fmaxf(rintf(__bfloat162float(xr[c]) / scale), -127.f), 127.f);
  if (lane == 0) sx[row] = scale;
}

__device__ __forceinline__ int shift_region(int r, int size, int win,
                                            int shift) {
  return r < size - win ? 0 : (r < size - shift ? 1 : 2);
}

// grid (windows, heads, B), 256 threads (8 warps); qkv (B*H*W, 3C) bf16
// with channel order [q | k | v] x heads x hd; out (B*H*W, C) bf16. The
// window's n tokens are padded to NP = 16 ceil(n / 16) rows. q (pre-scaled
// and rounded to bf16, as the reference scales the bf16 q), k, v stay bf16
// in shared memory; q k^T and p v run on the tensor cores (WMMA 16x16x16,
// f32 accumulation); the scores, their bias and the softmax are f32, and the
// probabilities are rounded to bf16 like the reference's.
namespace wm = nvcuda::wmma;

__global__ void __launch_bounds__(256) swin_window_attn_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ qkv_bias,
    const float* __restrict__ rel, bf16* __restrict__ out, int H, int W,
    int C, int heads, int win, int shift, float scale) {
  extern __shared__ __align__(128) unsigned char smraw[];
  const int n = win * win, hd = C / heads;
  const int NP = (n + 15) / 16 * 16;
  const int ldh = hd + 8;    // bf16 rows of q, k, v
  const int lds = NP + 4;    // f32 score rows
  const int ldp = NP + 8;    // bf16 probability rows
  bf16* qs = reinterpret_cast<bf16*>(smraw);
  bf16* ks = qs + NP * ldh;
  bf16* vs = ks + NP * ldh;
  float* S = reinterpret_cast<float*>(vs + NP * ldh);  // NP x (max(NP, hd)+4)
  int* tok = reinterpret_cast<int*>(S + NP * (max(NP, hd) + 4));
  int* lab = tok + NP;
  bf16* P = qs;  // q and k are dead once the scores exist
  float* O = S;  // the scores are dead once p is in P

  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  const int nww = wp / win;
  const int wid = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int wy = wid / nww, wx = wid % nww;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int t = tid; t < NP; t += blockDim.x) {
    int tk = -1, lb = 0;
    if (t < n) {
      const int r = wy * win + t / win, c = wx * win + t % win;  // rolled
      const int ro = (r + shift) % hp, co = (c + shift) % wp;     // padded
      tk = (ro < H && co < W) ? (b * H + ro) * W + co : -2;
      lb = shift ? shift_region(r, hp, win, shift) * 3 +
                       shift_region(c, wp, win, shift)
                 : 0;
    }
    tok[t] = tk;  // >= 0 token, -2 pad token (zero after LN1), -1 no row
    lab[t] = lb;
  }
  __syncthreads();
  for (int idx = tid; idx < NP * hd; idx += blockDim.x) {
    const int t = idx / hd, d = idx % hd;
    const int tk = tok[t];
    float q = 0.f, k = 0.f, v = 0.f;
    if (tk >= 0) {
      const bf16* row = qkv + (size_t)tk * 3 * C + h * hd + d;
      q = __bfloat162float(row[0]);
      k = __bfloat162float(row[C]);
      v = __bfloat162float(row[2 * C]);
    } else if (tk == -2) {
      q = qkv_bias[h * hd + d];
      k = qkv_bias[C + h * hd + d];
      v = qkv_bias[2 * C + h * hd + d];
    }
    qs[t * ldh + d] = __float2bfloat16_rn(q * scale);
    ks[t * ldh + d] = __float2bfloat16_rn(k);
    vs[t * ldh + d] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  // S = q k^T: NP/16 x NP/16 tiles over the 8 warps
  const int nt = NP / 16;
  for (int tile = warp; tile < nt * nt; tile += 8) {
    const int ti = tile / nt, tj = tile % nt;
    wm::fragment<wm::accumulator, 16, 16, 16, float> acc;
    wm::fill_fragment(acc, 0.f);
    for (int d0 = 0; d0 < hd; d0 += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> fa;
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> fb;
      wm::load_matrix_sync(fa, qs + ti * 16 * ldh + d0, ldh);
      wm::load_matrix_sync(fb, ks + tj * 16 * ldh + d0, ldh);
      wm::mma_sync(acc, fa, fb, acc);
    }
    wm::store_matrix_sync(S + ti * 16 * lds + tj * 16, acc, lds,
                          wm::mem_row_major);
  }
  __syncthreads();

  // bias, shift mask, softmax over the n real keys; p -> bf16 P (zeros on
  // the padding rows and columns)
  const float* relh = rel + (size_t)h * n * n;
  for (int i = warp; i < NP; i += 8) {
    float* sr = S + i * lds;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      float bias = i < n ? relh[i * n + j] : 0.f;
      if (lab[i] != lab[j]) bias = __fadd_rn(bias, -100.f);
      const float v = __fadd_rn(sr[j], bias);
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
      P[i * ldp + j] = __float2bfloat16_rn(
          (i < n && j < n) ? sr[j] / sum : 0.f);
  }
  __syncthreads();

  // O = P v: NP/16 x hd/16 tiles
  const int dt = hd / 16;
  for (int tile = warp; tile < nt * dt; tile += 8) {
    const int ti = tile / dt, td = tile % dt;
    wm::fragment<wm::accumulator, 16, 16, 16, float> acc;
    wm::fill_fragment(acc, 0.f);
    for (int j0 = 0; j0 < NP; j0 += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> fa;
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> fb;
      wm::load_matrix_sync(fa, P + ti * 16 * ldp + j0, ldp);
      wm::load_matrix_sync(fb, vs + j0 * ldh + td * 16, ldh);
      wm::mma_sync(acc, fa, fb, acc);
    }
    wm::store_matrix_sync(O + ti * 16 * (hd + 4) + td * 16, acc, hd + 4,
                          wm::mem_row_major);
  }
  __syncthreads();
  for (int idx = tid; idx < n * hd; idx += blockDim.x) {
    const int i = idx / hd, d = idx % hd;
    const int tk = tok[i];
    if (tk >= 0)
      out[(size_t)tk * C + h * hd + d] =
          __float2bfloat16_rn(O[i * (hd + 4) + d]);
  }
}

MB_EXPORT int swin_layernorm(const bf16* x, const bf16* w, const bf16* b,
                             bf16* out, signed char* q8, float* sx, int M,
                             int C, float eps, cudaStream_t stream) {
  swin_layernorm_kernel<<<ceil_div(M, 8), 256, 0, stream>>>(x, w, b, out, q8,
                                                            sx, M, C, eps);
  return (int)cudaGetLastError();
}

MB_EXPORT int swin_quant_rows(const bf16* x, signed char* q8, float* sx,
                              int M, int K, cudaStream_t stream) {
  swin_quant_rows_kernel<<<ceil_div(M, 8), 256, 0, stream>>>(x, q8, sx, M, K);
  return (int)cudaGetLastError();
}

MB_EXPORT int swin_window_attn(const bf16* qkv, const float* qkv_bias,
                               const float* rel, bf16* out, int B, int H,
                               int W, int C, int heads, int win, int shift,
                               float scale, cudaStream_t stream) {
  const int n = win * win, hd = C / heads;
  const int NP = (n + 15) / 16 * 16;
  // P (NP x NP+8 bf16) reuses q and k, O (NP x hd+4 f32) the scores
  if (C % heads || hd % 16 || n > 128 || NP > 2 * hd + 8) return MB_BAD_ARGS;
  const size_t smem = sizeof(bf16) * 3 * NP * (hd + 8) +
                      sizeof(float) * NP * ((NP > hd ? NP : hd) + 4) +
                      sizeof(int) * 2 * NP;
  cudaError_t e = cudaFuncSetAttribute(
      swin_window_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  dim3 grid((hp / win) * (wp / win), heads, B);
  swin_window_attn_kernel<<<grid, 256, smem, stream>>>(
      qkv, qkv_bias, rel, out, H, W, C, heads, win, shift, scale);
  return (int)cudaGetLastError();
}
