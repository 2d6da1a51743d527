// Kernel 9: token LayerNorm over the last axis, bf16 or f32 in and out.
//
// Replaces mask_bev_tpu/ops/pallas_layer_norm.py::fused_layer_norm
// (_ln_kernel): flax nn.LayerNorm's fast-variance form, f32 statistics
// mean = E[x], var = max(0, E[x^2] - mean^2), eps, then
// (x - mean) * (rsqrt(var + eps) * scale) + bias in f32 (the bf16 scale and
// bias widened to f32, as the TPU kernel casts them), rounded once to the
// input type. Two instances: bf16 and f32 tokens (with scale and bias of
// the same type).
//
// What bounds it on the H100: bytes. Each token row is read once and
// written once (C bf16 values each way): at the backbone's patch_norm
// (8 x 125^2 tokens of 192) that is 48 MB, ~0.014 ms at 3.35 TB/s. Design:
// one warp per token; each lane loads 16-byte words (8 channels) of the row
// into registers, so the row is read from device memory once, the two sums
// are warp reductions, and the normalised values leave as 16-byte stores.
// The words a lane holds are a template parameter, so a 192-channel row
// keeps 8 values a lane in registers (not the 64 of a 2048-channel one)
// and the SM holds enough warps to keep the memory busy.
#include "common.cuh"

#define LN_MAX_WORDS 8  // 16-byte words per lane in bf16: C <= 2048

// T: tokens, scale, bias and output (bf16 or f32); NW groups of 8 channels
// a lane
template <typename T, int NW>
__global__ void __launch_bounds__(256) token_layernorm_kernel(
    const T* __restrict__ x, const T* __restrict__ scale,
    const T* __restrict__ bias, T* __restrict__ out, int M, int C,
    float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int words = C / 8;
  const T* xr = x + (size_t)row * C;
  float v[NW][8];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int wd = lane + 32 * i;
    if (wd < words) {
      ld8(xr + 8 * wd, v[i]);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        s += v[i][q];
        s2 = fmaf(v[i][q], v[i][q], s2);
      }
    }
  }
  const float mean = warp_sum(s) / (float)C;
  const float var = fmaxf(warp_sum(s2) / (float)C - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  T* orow = out + (size_t)row * C;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int wd = lane + 32 * i;
    if (wd < words) {
      float o[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = wd * 8 + q;
        o[q] = __fadd_rn(__fmul_rn(v[i][q] - mean, rstd * to_f(scale[c])),
                         to_f(bias[c]));
      }
      st8(orow + 8 * wd, o);
    }
  }
}

template <typename T, int NW>
static void launch_ln(const void* x, const void* scale, const void* bias,
                      void* out, int M, int C, float eps,
                      cudaStream_t stream) {
  token_layernorm_kernel<T, NW><<<ceil_div(M, 8), 256, 0, stream>>>(
      (const T*)x, (const T*)scale, (const T*)bias, (T*)out, M, C, eps);
}

template <typename T>
static void launch_ln_t(const void* x, const void* scale, const void* bias,
                        void* out, int M, int C, float eps,
                        cudaStream_t stream) {
  const int nw = ceil_div(C / 8, 32);  // groups of 8 channels per lane
  if (nw == 1) launch_ln<T, 1>(x, scale, bias, out, M, C, eps, stream);
  else if (nw == 2) launch_ln<T, 2>(x, scale, bias, out, M, C, eps, stream);
  else if (nw <= 4) launch_ln<T, 4>(x, scale, bias, out, M, C, eps, stream);
  else launch_ln<T, LN_MAX_WORDS>(x, scale, bias, out, M, C, eps, stream);
}

// f32: nonzero for the f32 instance (tokens, scale, bias and output f32)
MB_EXPORT int token_layernorm(const void* x, const void* scale,
                              const void* bias, void* out, int M, int C,
                              float eps, int f32, cudaStream_t stream) {
  if (C % 8 || C > 8 * 32 * LN_MAX_WORDS) return MB_BAD_ARGS;
  if (f32)
    launch_ln_t<float>(x, scale, bias, out, M, C, eps, stream);
  else
    launch_ln_t<bf16>(x, scale, bias, out, M, C, eps, stream);
  return (int)cudaGetLastError();
}
