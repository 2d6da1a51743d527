// Kernel 8: stride-p patch-embed conv + its token LayerNorm, one launch.
//
// Replaces mask_bev_tpu/ops/pallas_patch_embed.py::fused_patch_embed
// (_patch_embed_kernel). The TPU kernel reads a batch-minor flat canvas;
// this one reads the (B, H, W, C) bf16 canvas of kernel 2 directly:
//   y[m, :] = A[m, :] . Wm^T + bias     (bf16 products, f32 accumulation)
//   out[m]  = (y - mean) * rsqrt(var + eps) * ln_w + ln_b   (f32, to bf16)
// where token m = (b, gy, gx) and A[m, k], k = dh p C + dw C + c, is
// canvas[b, gy p + dh, gx p + dw, c]: p runs of p C contiguous channels,
// so the GEMM is implicit (no patch matrix in device memory). The LN
// statistics are the fast-variance form var = max(0, E[y^2] - mean^2).
//
// What bounds it on the H100: bytes. At the KITTI grid (B 8, 800^2 x 128
// bf16 canvas, p 4, E 192) the canvas is 1.31 GB, ~0.39 ms at 3.35 TB/s;
// the products are 2 x 320000 x 2048 x 192 = 0.25 TFLOP, ~0.25 ms at the
// bf16 peak. Design: one block owns BM = 128 tokens and all E outputs, so
// the LayerNorm runs in the epilogue without another pass: 8 warps of 32
// rows x E/2 columns of WMMA 16x16x16 tiles, 64-byte K slices staged through
// shared memory with the next slice's loads in flight (as gemm.cuh), then
// the f32 tile in shared memory, one warp per token row for bias + LN.
// The f32 instance (patch_embed_f32_kernel, for an f32 canvas) takes the
// same implicit GEMM as f32 FMAs on the CUDA cores (no operand rounded):
// a block owns 64 tokens and all E outputs, a thread 4 tokens x E/16
// columns, and the LayerNorm's row sums are reduced across the 16 threads
// of a row with shuffles.
#include <mma.h>

#include "common.cuh"

namespace wmp = nvcuda::wmma;

#define PE_BM 128
#define PE_BK 32  // bf16 per K slice (64 bytes)
#define PE_THREADS 256

// NF: 16-column WMMA tiles per warp (E = 32 NF)
template <int NF>
__global__ void __launch_bounds__(PE_THREADS) patch_embed_kernel(
    const bf16* __restrict__ canvas, const bf16* __restrict__ wm,
    const float* __restrict__ bias, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, bf16* __restrict__ out, int M, int H,
    int W, int C, int p, float eps) {
  constexpr int E = 32 * NF;
  constexpr int KS = PE_BK / 16;
  constexpr int BCH = (E * 4 + PE_THREADS - 1) / PE_THREADS;  // B chunks
  extern __shared__ __align__(128) unsigned char smraw[];
  // main loop: As [KS][BM][16], Bs [KS][E][16]; epilogue: Y [BM][E + 4]
  bf16* As = reinterpret_cast<bf16*>(smraw);
  bf16* Bs = As + KS * PE_BM * 16;
  float* Y = reinterpret_cast<float*>(smraw);
  const int ldy = E + 4;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * PE_BM;
  const int wmi = warp >> 1, wni = warp & 1;  // 4 x 2 warps of 32 x E/2
  const int pC = p * C, K = p * pC;
  const int gw = W / p, gpb = (H / p) * gw;  // tokens per sample
  const int nk = K / PE_BK;

  // the two token rows this thread loads, as canvas row pointers
  const bf16* arow[2];
  int k0a[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int q = tid + hh * PE_THREADS;
    const int row = q >> 2;
    k0a[hh] = (q & 3) * 8;
    const int m = m0 + row;
    if (m < M) {
      const int b = m / gpb, t = m % gpb, gy = t / gw, gx = t % gw;
      arow[hh] = canvas + (((size_t)b * H + (size_t)gy * p) * W +
                           (size_t)gx * p) * C;
    } else {
      arow[hh] = nullptr;
    }
  }

  uint4 ra[2], rb[BCH];
  auto gload = [&](int kt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gk = kt * PE_BK + k0a[hh];
      const int dh = gk / pC, r = gk - dh * pC;
      ra[hh] = arow[hh] ? *reinterpret_cast<const uint4*>(
                              arow[hh] + (size_t)dh * W * C + r)
                        : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < BCH; ++i) {
      const int q = tid + i * PE_THREADS;
      const int row = q >> 2, k0 = (q & 3) * 8;
      rb[i] = row < E ? *reinterpret_cast<const uint4*>(
                            wm + (size_t)row * K + kt * PE_BK + k0)
                      : make_uint4(0, 0, 0, 0);
    }
  };
  auto sstore = [&]() {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = tid + hh * PE_THREADS;
      const int row = q >> 2, k0 = (q & 3) * 8;
      *reinterpret_cast<uint4*>(As + ((k0 / 16) * PE_BM + row) * 16 +
                                k0 % 16) = ra[hh];
    }
#pragma unroll
    for (int i = 0; i < BCH; ++i) {
      const int q = tid + i * PE_THREADS;
      const int row = q >> 2, k0 = (q & 3) * 8;
      if (row < E)
        *reinterpret_cast<uint4*>(Bs + ((k0 / 16) * E + row) * 16 +
                                  k0 % 16) = rb[i];
    }
  };

  wmp::fragment<wmp::accumulator, 16, 16, 16, float> acc[2][NF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmp::fill_fragment(acc[i][j], 0.f);

  gload(0);
  sstore();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) gload(kt + 1);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      wmp::fragment<wmp::matrix_a, 16, 16, 16, bf16, wmp::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmp::load_matrix_sync(
            fa[i], As + (ks * PE_BM + wmi * 32 + i * 16) * 16, 16);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmp::fragment<wmp::matrix_b, 16, 16, 16, bf16, wmp::col_major> fb;
        wmp::load_matrix_sync(
            fb, Bs + (ks * E + wni * (E / 2) + j * 16) * 16, 16);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmp::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
    if (kt + 1 < nk) {
      sstore();
      __syncthreads();
    }
  }

  // the block's f32 (BM, E) product in shared memory (over As and Bs)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmp::store_matrix_sync(
          Y + (wmi * 32 + i * 16) * ldy + wni * (E / 2) + j * 16, acc[i][j],
          ldy, wmp::mem_row_major);
  __syncthreads();

  // bias + LayerNorm, one warp per token row; lane owns columns lane + 32 j
  for (int row = warp; row < PE_BM; row += PE_THREADS / 32) {
    const int m = m0 + row;
    if (m >= M) break;
    float v[NF];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int c = lane + 32 * j;
      v[j] = __fadd_rn(Y[row * ldy + c], bias[c]);
      s += v[j];
      s2 = fmaf(v[j], v[j], s2);
    }
    const float mean = warp_sum(s) / (float)E;
    const float var = fmaxf(warp_sum(s2) / (float)E - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    bf16* orow = out + (size_t)m * E;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int c = lane + 32 * j;
      orow[c] = __float2bfloat16_rn(__fadd_rn(
          __fmul_rn(__fmul_rn(v[j] - mean, rstd), ln_w[c]), ln_b[c]));
    }
  }
}

template <int NF>
static int launch_patch_embed(const bf16* canvas, const bf16* wm,
                              const float* bias, const float* ln_w,
                              const float* ln_b, bf16* out, int B, int H,
                              int W, int C, int p, float eps,
                              cudaStream_t stream) {
  constexpr int E = 32 * NF;
  const size_t main_bytes =
      sizeof(bf16) * (PE_BK / 16) * (PE_BM + E) * 16;
  const size_t epi_bytes = sizeof(float) * PE_BM * (E + 4);
  const size_t smem = main_bytes > epi_bytes ? main_bytes : epi_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      patch_embed_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  const int M = B * (H / p) * (W / p);
  patch_embed_kernel<NF><<<ceil_div(M, PE_BM), PE_THREADS, smem, stream>>>(
      canvas, wm, bias, ln_w, ln_b, out, M, H, W, C, p, eps);
  return (int)cudaGetLastError();
}

// canvas (B, H, W, C) bf16; wm (E, p p C) bf16; bias, ln_w, ln_b (E,) f32;
// out (B, H/p * W/p, E) bf16. E one of 64, 128, 192, 256.
MB_EXPORT int patch_embed_forward(const bf16* canvas, const bf16* wm,
                                  const float* bias, const float* ln_w,
                                  const float* ln_b, bf16* out, int B, int H,
                                  int W, int C, int E, int p, float eps,
                                  cudaStream_t stream) {
  if (C % 8 || H % p || W % p || (p * p * C) % PE_BK) return MB_BAD_ARGS;
  switch (E) {
    case 64:
      return launch_patch_embed<2>(canvas, wm, bias, ln_w, ln_b, out, B, H,
                                   W, C, p, eps, stream);
    case 128:
      return launch_patch_embed<4>(canvas, wm, bias, ln_w, ln_b, out, B, H,
                                   W, C, p, eps, stream);
    case 192:
      return launch_patch_embed<6>(canvas, wm, bias, ln_w, ln_b, out, B, H,
                                   W, C, p, eps, stream);
    case 256:
      return launch_patch_embed<8>(canvas, wm, bias, ln_w, ln_b, out, B, H,
                                   W, C, p, eps, stream);
    default:
      return MB_BAD_ARGS;
  }
}

// ---- the f32 instance -------------------------------------------------------
#define PE32_BM 64
#define PE32_BK 16

// NJ: columns a thread holds (E = 16 NJ); thread (tx, ty) = (tid % 16,
// tid / 16) owns tokens 4 ty.. and columns tx + 16 j
template <int NJ>
__global__ void __launch_bounds__(PE_THREADS) patch_embed_f32_kernel(
    const float* __restrict__ canvas, const float* __restrict__ wm,
    const float* __restrict__ bias, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, float* __restrict__ out, int M, int H,
    int W, int C, int p, float eps) {
  constexpr int E = 16 * NJ;
  __shared__ __align__(16) float As[PE32_BK][PE32_BM + 4];
  __shared__ __align__(16) float Bs[PE32_BK][E + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * PE32_BM;
  const int pC = p * C, K = p * pC;
  const int gw = W / p, gpb = (H / p) * gw;
  // the token row this thread loads (4 values of k a slice)
  const int lr = tid >> 2, lk = (tid & 3) * 4;
  const float* arow = nullptr;
  if (m0 + lr < M) {
    const int m = m0 + lr;
    const int b = m / gpb, t = m % gpb, gy = t / gw, gx = t % gw;
    arow = canvas + (((size_t)b * H + (size_t)gy * p) * W + (size_t)gx * p) * C;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += PE32_BK) {
    {
      const int gk = k0 + lk;
      const int dh = gk / pC, r = gk - dh * pC;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (arow)
        v = *reinterpret_cast<const float4*>(arow + (size_t)dh * W * C + r);
      As[lk][lr] = v.x; As[lk + 1][lr] = v.y;
      As[lk + 2][lr] = v.z; As[lk + 3][lr] = v.w;
    }
    for (int q = tid; q < E * (PE32_BK / 4); q += PE_THREADS) {
      const int e = q >> 2, kk = (q & 3) * 4;
      const float4 v =
          *reinterpret_cast<const float4*>(wm + (size_t)e * K + k0 + kk);
      Bs[kk][e] = v.x; Bs[kk + 1][e] = v.y;
      Bs[kk + 2][e] = v.z; Bs[kk + 3][e] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PE32_BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][4 * ty]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float bv = Bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], bv, acc[i][j]);
      }
    }
    __syncthreads();
  }
  // bias + LayerNorm: a row's 16 threads are one half-warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float v = __fadd_rn(acc[i][j], bias[tx + 16 * j]);
      acc[i][j] = v;
      s += v;
      s2 = fmaf(v, v, s2);
    }
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s / (float)E;
    const float var = fmaxf(s2 / (float)E - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    if (m < M) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        out[(size_t)m * E + c] = __fadd_rn(
            __fmul_rn(__fmul_rn(acc[i][j] - mean, rstd), ln_w[c]), ln_b[c]);
      }
    }
  }
}

template <int NJ>
static int launch_patch_embed_f32(const float* canvas, const float* wm,
                                  const float* bias, const float* ln_w,
                                  const float* ln_b, float* out, int B,
                                  int H, int W, int C, int p, float eps,
                                  cudaStream_t stream) {
  const int M = B * (H / p) * (W / p);
  patch_embed_f32_kernel<NJ><<<ceil_div(M, PE32_BM), PE_THREADS, 0,
                               stream>>>(canvas, wm, bias, ln_w, ln_b, out,
                                         M, H, W, C, p, eps);
  return (int)cudaGetLastError();
}

// The f32 instance: canvas (B, H, W, C), wm (E, p p C), out f32; E one of
// 64, 128, 192, 256; C % 4 == 0 and p p C % 16 == 0
MB_EXPORT int patch_embed_f32_forward(const float* canvas, const float* wm,
                                      const float* bias, const float* ln_w,
                                      const float* ln_b, float* out, int B,
                                      int H, int W, int C, int E, int p,
                                      float eps, cudaStream_t stream) {
  if (C % 4 || H % p || W % p || (p * C) % PE32_BK) return MB_BAD_ARGS;
  switch (E) {
    case 64:
      return launch_patch_embed_f32<4>(canvas, wm, bias, ln_w, ln_b, out, B,
                                       H, W, C, p, eps, stream);
    case 128:
      return launch_patch_embed_f32<8>(canvas, wm, bias, ln_w, ln_b, out, B,
                                       H, W, C, p, eps, stream);
    case 192:
      return launch_patch_embed_f32<12>(canvas, wm, bias, ln_w, ln_b, out, B,
                                        H, W, C, p, eps, stream);
    case 256:
      return launch_patch_embed_f32<16>(canvas, wm, bias, ln_w, ln_b, out, B,
                                        H, W, C, p, eps, stream);
    default:
      return MB_BAD_ARGS;
  }
}
