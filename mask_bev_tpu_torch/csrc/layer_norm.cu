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
// written once (C values each way): on path E's five calls (patch_norm and
// out_norm0-3 of 8 scans) 277 MB in bf16, ~0.083 ms at 3.35 TB/s.
//
// Design. A row is split into 8-channel words (one 16-byte load in bf16,
// two in f32). A group of G lanes takes a token, G a power of two sized to
// the row so that no lane idles (G = 8 at C = 192, 16 at 384, 32 at 768
// and 1536), each lane W words, and each group R tokens at a step
// (ops/layer_norm.py::plan: about 12 16-byte vectors a lane, R = 4 in bf16
// and 2 in f32 at C = 192). A lane issues every load of its R tokens before
// the first reduction and keeps them packed in registers, the two sums are
// shuffles within the group, and scale and bias are read once a step for
// all R tokens as 16-byte words. The grid is sized to the SMs (as many
// blocks as fit at once) and each warp walks its steps, so every SM keeps
// ~100 KB in flight to cover the memory's latency.
#include "common.cuh"

#define LN_THREADS 256
#define LN_MAX_WORDS 8  // 8-channel words a lane: C <= 32 * 8 * 8 = 2048

// an 8-channel word as it is loaded: one 16-byte vector in bf16, two in f32
template <typename T>
struct LnWord {
  static constexpr int N = sizeof(T) / 2;
  uint4 u[N];
};

__device__ __forceinline__ void unpack8(const LnWord<bf16>& w, float* v) {
  const bf16* e = reinterpret_cast<const bf16*>(w.u);
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = __bfloat162float(e[q]);
}
__device__ __forceinline__ void unpack8(const LnWord<float>& w, float* v) {
  const float* e = reinterpret_cast<const float*>(w.u);
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = e[q];
}

// tokens a group takes at a step for W words a lane (ops/layer_norm.py::
// plan): about 12 16-byte vectors in flight a lane, at least 2 tokens
// while that holds
template <typename T>
static constexpr int ln_tokens(int w) {
  return w * LnWord<T>::N > 12 ? 1
         : 12 / (w * LnWord<T>::N) > 2 ? 12 / (w * LnWord<T>::N) : 2;
}

// T: tokens, scale, bias and output (bf16 or f32); G lanes a token (a power
// of two up to 32, runtime), W words a lane, R tokens a group at a step
template <typename T, int W, int R>
__global__ void __launch_bounds__(LN_THREADS) token_layernorm_kernel(
    const T* __restrict__ x, const T* __restrict__ scale,
    const T* __restrict__ bias, T* __restrict__ out, int M, int C, int G,
    float eps) {
  const int lane = threadIdx.x & 31;
  const int q = lane / G, l = lane & (G - 1);  // group in the warp, lane in it
  const int gpw = 32 / G;                      // groups a warp
  const int words = C / 8;
  const int step = gpw * R;                    // tokens a warp takes a step
  const int warps = gridDim.x * (LN_THREADS / 32);
  for (int base = (blockIdx.x * (LN_THREADS / 32) + threadIdx.x / 32) * step;
       base < M; base += warps * step) {
    // ---- every load of the step before the first reduction -------------
    LnWord<T> raw[R][W];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = base + r * gpw + q;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int wd = l + G * i;
        const uint4* src = reinterpret_cast<const uint4*>(
            x + (size_t)row * C + 8 * wd);
#pragma unroll
        for (int h = 0; h < LnWord<T>::N; ++h)
          raw[r][i].u[h] =
              row < M && wd < words ? src[h] : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float mean[R], rstd[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        float v[8];
        unpack8(raw[r][i], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s += v[e];
          s2 = fmaf(v[e], v[e], s2);
        }
      }
      for (int o = G >> 1; o > 0; o >>= 1) {  // within the group of G lanes
        s += __shfl_xor_sync(0xffffffffu, s, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      mean[r] = s / (float)C;
      const float var = fmaxf(s2 / (float)C - mean[r] * mean[r], 0.f);
      rstd[r] = rsqrtf(var + eps);
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int wd = l + G * i;
      if (wd >= words) continue;
      float sc[8], bi[8];
      ld8(scale + 8 * wd, sc);
      ld8(bias + 8 * wd, bi);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = base + r * gpw + q;
        if (row >= M) continue;
        float v[8];
        unpack8(raw[r][i], v);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __fadd_rn(__fmul_rn(v[e] - mean[r], rstd[r] * sc[e]), bi[e]);
        st8(out + (size_t)row * C + 8 * wd, v);
      }
    }
  }
}

template <typename T, int W>
static int launch_ln(const void* x, const void* scale, const void* bias,
                     void* out, int M, int C, int G, int R, float eps,
                     cudaStream_t stream) {
  constexpr int RW = ln_tokens<T>(W);
  if (R != RW) return MB_BAD_ARGS;
  auto kern = token_layernorm_kernel<T, W, RW>;
  // blocks the card holds at once, asked once an instance (the wrapper's
  // time is most of a small call's)
  static int per_sm = 0, sms = 0;
  if (!sms) {
    int dev = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, LN_THREADS,
                                                  0);
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int per_block = (LN_THREADS / 32) * (32 / G) * RW;
  int grid = ceil_div(M, per_block);
  const int fill = (per_sm > 0 ? per_sm : 1) * sms;
  if (grid > fill) grid = fill;
  kern<<<grid, LN_THREADS, 0, stream>>>(
      (const T*)x, (const T*)scale, (const T*)bias, (T*)out, M, C, G, eps);
  return 0;
}

template <typename T>
static int launch_ln_t(const void* x, const void* scale, const void* bias,
                       void* out, int M, int C, int G, int W, int R,
                       float eps, cudaStream_t stream) {
  switch (W) {
    case 1: return launch_ln<T, 1>(x, scale, bias, out, M, C, G, R, eps, stream);
    case 2: return launch_ln<T, 2>(x, scale, bias, out, M, C, G, R, eps, stream);
    case 3: return launch_ln<T, 3>(x, scale, bias, out, M, C, G, R, eps, stream);
    case 4: return launch_ln<T, 4>(x, scale, bias, out, M, C, G, R, eps, stream);
    case 5: return launch_ln<T, 5>(x, scale, bias, out, M, C, G, R, eps, stream);
    case 6: return launch_ln<T, 6>(x, scale, bias, out, M, C, G, R, eps, stream);
    case 7: return launch_ln<T, 7>(x, scale, bias, out, M, C, G, R, eps, stream);
    case 8: return launch_ln<T, 8>(x, scale, bias, out, M, C, G, R, eps, stream);
    default: return MB_BAD_ARGS;
  }
}

// G lanes a token, W 8-channel words a lane, R tokens a group at a step, as
// ops/layer_norm.py::plan picks them for C (checked here: G a power of two
// up to 32, every lane holding at least one word, R the plan's for W).
// f32: nonzero for the f32 instance (tokens, scale, bias and output f32).
MB_EXPORT int token_layernorm(const void* x, const void* scale,
                              const void* bias, void* out, int M, int C,
                              int G, int W, int R, float eps, int f32,
                              cudaStream_t stream) {
  const int words = C / 8;
  if (C % 8 || C < 8 || M < 0 || G < 1 || G > 32 || (G & (G - 1)) ||
      G > words || W < 1 || W > LN_MAX_WORDS || G * W < words ||
      G * (W - 1) >= words)
    return MB_BAD_ARGS;
  if (M == 0) return 0;
  const int rc = f32 ? launch_ln_t<float>(x, scale, bias, out, M, C, G, W, R,
                                          eps, stream)
                     : launch_ln_t<bf16>(x, scale, bias, out, M, C, G, W, R,
                                         eps, stream);
  return rc ? rc : (int)cudaGetLastError();
}
