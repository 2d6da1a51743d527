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
// ~100 KB in flight to cover the memory's latency. Rows of 2048 < C <= 4096
// in whole words take token_layernorm_wide_kernel (LN_WIDE_WARPS warps a
// token, the row held in registers); rows of any other width (C % 8 != 0
// or C > 4096) token_layernorm_walk_kernel: the same arithmetic over the
// row walk of common.cuh, two passes over the row.
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

// Rows the register tiles above and the wide instance below do not take
// (C % 8 != 0, or C > 4096): a group of G lanes a token walks its row in
// 8-value words
// (common.cuh::row_walk; a partial last word, and every word of a row that
// does not start 16-byte aligned, value by value), one pass for the sums
// and one for the output, which reads the row again from L1/L2. Same
// arithmetic as token_layernorm_kernel.
template <typename T>
__global__ void __launch_bounds__(LN_THREADS) token_layernorm_walk_kernel(
    const T* __restrict__ x, const T* __restrict__ scale,
    const T* __restrict__ bias, T* __restrict__ out, int M, int C, int G,
    float eps) {
  const int lane = threadIdx.x & 31;
  const int l = lane & (G - 1);
  const int row = (blockIdx.x * LN_THREADS + threadIdx.x) / G;
  // whole groups only: a group's lanes take the same row (G divides 32)
  const T* xr = x + (size_t)min(row, M - 1) * C;
  T* outr = out + (size_t)min(row, M - 1) * C;
  const bool vec = aligned16(xr) && aligned16(outr) && aligned16(scale) &&
                   aligned16(bias);
  float mean, rstd;
  ln_row_stats<true>(xr, C, l, G, vec, eps, mean, rstd);
  if (row >= M) return;
  row_walk(xr, C, l, G, vec, [&](int wd, int n, float (&v)[8]) {
    float sc[8], bi[8];
    ld_word(scale + 8 * wd, n, vec, sc);
    ld_word(bias + 8 * wd, n, vec, bi);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = __fadd_rn(__fmul_rn(v[e] - mean, rstd * sc[e]), bi[e]);
    st_word(outr + 8 * wd, n, vec, v);
  });
}

// Rows of 2048 < C <= LN_WIDE_C values, C % 8 == 0 (the walk read them
// one 16-byte word at a time, about one load in flight a lane, and twice:
// 1.23x F.layer_norm's device time at C 4096 in bf16, 1.14x in f32): the
// row is read once and written once. The S warps of a token hold it in
// registers, a lane W <= 16 / S words (common.cuh::RowRegs; S =
// LN_WIDE_WARPS), every load issued before the first reduction. The sums
// run in the walk's order (chain_sums: the warps hand their per-lane sums
// over in shared memory) and the variance's product
// mean * mean is rounded before the subtraction, as the walk computes it
// (a fused multiply-add there changed the last bit of some outputs), so
// the outputs equal the walk's bit for bit. One step a block: LN_THREADS /
// 32 / S tokens (a plan's G = 32 S).
#define LN_WIDE_C 4096  // 32 lanes x 16 words x 8 values
// warps a token, bf16 and f32 (ops/layer_norm.py::WIDE_WARPS): a lane holds
// at most 4 words (16 registers of data in bf16, 32 in f32). Of one (two in
// f32), two and four, four was the fastest on the H100
// (scripts/row_walk_profile.py)
#define LN_WIDE_WARPS 4
// blocks an SM at least (launch bounds): without them the bf16 instance
// at one warp a token took 164 registers (the scale and bias words of the
// whole row loaded ahead) and one block an SM
#define LN_WIDE_BLOCKS 2

template <typename T>
__global__ void __launch_bounds__(LN_THREADS, LN_WIDE_BLOCKS)
    token_layernorm_wide_kernel(const T* __restrict__ x,
                                const T* __restrict__ scale,
                                const T* __restrict__ bias,
                                T* __restrict__ out, int M, int C, int W,
                                float eps) {
  constexpr int S = LN_WIDE_WARPS, WMAX = 16 / S;
  constexpr int ROWS = LN_THREADS / 32 / S;  // tokens a block
  __shared__ float part[ROWS][2 * 32], tot[ROWS][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp / S, sw = warp % S;
  const int row = blockIdx.x * ROWS + slot;
  const int words = C / 8, w0 = lane + 32 * sw * W;  // the lane's first word
  // rows past M load the last row, take part in the barriers, store nothing
  const T* xr = x + (size_t)min(row, M - 1) * C;
  RowRegs<T, WMAX> r;
  row_regs_load(r, xr, w0, W, words);
  float acc[2] = {0.f, 0.f};
  chain_sums<S>(acc, part[slot], tot[slot], sw, lane, [&](float (&a)[2]) {
#pragma unroll
    for (int i = 0; i < WMAX; ++i) {
      if (i < W && w0 + 32 * i < words) {
        float v[8];
        unpack_word(r.u[i], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          a[0] += v[e];
          a[1] = fmaf(v[e], v[e], a[1]);
        }
      }
    }
  });
  const float mean = acc[0] / (float)C;
  const float var =
      fmaxf(__fsub_rn(acc[1] / (float)C, __fmul_rn(mean, mean)), 0.f);
  const float rstd = rsqrtf(var + eps);
  if (row >= M) return;
  T* outr = out + (size_t)row * C;
#pragma unroll
  for (int i = 0; i < WMAX; ++i) {
    const int wd = w0 + 32 * i;
    if (i < W && wd < words) {
      float v[8], sc[8], bi[8];
      unpack_word(r.u[i], v);  // the held row (not read again)
      ld8(scale + 8 * wd, sc);
      ld8(bias + 8 * wd, bi);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = __fadd_rn(__fmul_rn(v[e] - mean, rstd * sc[e]), bi[e]);
      st8(outr + 8 * wd, v);
    }
  }
}

// the wide instance: G = 32 LN_WIDE_WARPS lanes a token, W the fewest
// words a lane that hold the row
template <typename T>
static int launch_ln_wide(const void* x, const void* scale, const void* bias,
                          void* out, int M, int C, int G, int W, int R,
                          float eps, cudaStream_t stream) {
  constexpr int S = LN_WIDE_WARPS, ROWS = LN_THREADS / 32 / S;
  if (C % 8 || C > LN_WIDE_C || G != 32 * S || R != 1 || W < 1 ||
      W > 16 / S || G * W < C / 8 || G * (W - 1) >= C / 8)
    return MB_BAD_ARGS;
  token_layernorm_wide_kernel<T><<<ceil_div(M, ROWS), LN_THREADS, 0,
                                   stream>>>(
      (const T*)x, (const T*)scale, (const T*)bias, (T*)out, M, C, W, eps);
  return 0;
}

// G lanes a token, W 8-channel words a lane, R tokens a group at a step, as
// ops/layer_norm.py::plan picks them for C (checked here: G a power of two
// up to 32, every lane holding at least one word, R the plan's for W); W =
// 0 (and R = 1): the walk above, for any C >= 1, G a power of two up to 32;
// C > 2048 with W > 0: the wide instance above (G = 32 lanes a warp times
// LN_WIDE_WARPS warps a token, W words a lane, R = 1). f32: nonzero for the f32
// instance (tokens, scale, bias and output f32).
MB_EXPORT int token_layernorm(const void* x, const void* scale,
                              const void* bias, void* out, int M, int C,
                              int G, int W, int R, float eps, int f32,
                              cudaStream_t stream) {
  if (W > 0 && C > 32 * 8 * LN_MAX_WORDS) {
    if (M < 0) return MB_BAD_ARGS;
    if (M == 0) return 0;
    const int rc = f32 ? launch_ln_wide<float>(x, scale, bias, out, M, C,
                                               G, W, R, eps, stream)
                       : launch_ln_wide<bf16>(x, scale, bias, out, M, C, G,
                                              W, R, eps, stream);
    return rc ? rc : (int)cudaGetLastError();
  }
  if (W == 0) {
    if (C < 1 || M < 0 || G < 1 || G > 32 || (G & (G - 1)) || R != 1)
      return MB_BAD_ARGS;
    if (M == 0) return 0;
    const int grid = ceil_div(M, LN_THREADS / G);
    if (f32)
      token_layernorm_walk_kernel<float><<<grid, LN_THREADS, 0, stream>>>(
          (const float*)x, (const float*)scale, (const float*)bias,
          (float*)out, M, C, G, eps);
    else
      token_layernorm_walk_kernel<bf16><<<grid, LN_THREADS, 0, stream>>>(
          (const bf16*)x, (const bf16*)scale, (const bf16*)bias, (bf16*)out,
          M, C, G, eps);
    return (int)cudaGetLastError();
  }
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
