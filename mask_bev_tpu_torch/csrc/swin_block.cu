// Kernel 3: one whole Swin block, as a chain of launches.
//
// Replaces mask_bev_tpu/ops/pallas_swin_block.py::fused_swin_block_col
// (_block_kernel_col, stages 0-1) and ::fused_swin_block (_block_kernel,
// stages 2-3): the band/col/wpair layouts were Mosaic workarounds; here one
// chain serves every stage on the unpadded (B, H*W, C) token grid:
//   swin_layernorm   LN1 (two-pass f32, eps 1e-6), bf16 out or int8 + scale
//   gemm_*           qkv = LN1 . Wqkv + b                    (gemm.cuh)
//   swin_window_attn (shifted) window attention by index math
//                    (window_attn.cuh, its Swin variant): pad tokens are
//                    zero after LN1, so their k and v are the qkv bias;
//                    relative-position bias and the -100 shift-region mask
//                    added to f32 scores
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
// What bounds it on the H100: bytes at stages 0-1, operations at stages
// 2-3. A block does ~12 C^2 multiply-adds per token in the four products
// (int8 or bf16 tensor cores) plus 4 n hd multiply-adds per token and head
// in attention (n = 100), and its launches move ~26 C bytes a token; at
// the flagship the backbone's products total ~1.4 TOP per batch of 8 (0.7
// ms at the int8 peak). Every launch has an f32 instance for the f32
// configurations (the 3xTF32 GEMM of gemm.cuh or the int8 GEMM with f32
// epilogues, f32 LN and quantise, the f32 attention on 3xTF32): no operand
// is rounded to bf16 there. Design: the products go through the
// persistent wgmma GEMM (gemm.cuh) with LN/quantise/bias/GELU/residual
// work fused into neighbouring launches. The attention keeps its scores in
// registers and reads the head's relative bias once for several windows
// (window_attn.cuh; the alternative, several heads of one window a block,
// measured 2.5x slower at stage 0: PERF.md section 6). The LN and
// quantisation launches read and write their rows in 16-byte words.
#include "common.cuh"
#include "window_attn.cuh"

// LN1/LN2 of a block, one warp per token row: each lane holds NW groups of
// 8 channels (16-byte words in bf16) of the row in registers, so the row is
// read once; two-pass f32 statistics, then T out or int8 + scale. T: the
// tokens' and the affine's type (bf16, or f32 for the f32 instance).
// Wider rows take swin_rows_wide_kernel up to SWIN_LN_WIDE_C channels,
// swin_rows_walk_kernel above it (and for int8 rows at a padded pitch).
#define SWIN_LN_MAX_WORDS 8  // C <= 8 * 8 * 32 = 2048
#define SWIN_LN_TILE_C (8 * 32 * SWIN_LN_MAX_WORDS)

template <typename T, int NW>
__global__ void __launch_bounds__(256) swin_layernorm_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ b, T* __restrict__ out,
    signed char* __restrict__ q8, float* __restrict__ sx, int M, int C,
    float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int words = C / 8;
  const T* xr = x + (size_t)row * C;
  float v[NW][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int wd = lane + 32 * i;
    if (wd < words) {
      ld8(xr + 8 * wd, v[i]);
#pragma unroll
      for (int q = 0; q < 8; ++q) s += v[i][q];
    }
  }
  const float mean = warp_sum(s) / (float)C;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if (lane + 32 * i < words) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float d = v[i][q] - mean;
        var += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(var) / (float)C + eps);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int wd = lane + 32 * i;
    if (wd < words) {
      float we[8], be[8];
      ld8(w + 8 * wd, we);
      ld8(b + 8 * wd, be);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        v[i][q] = rd<T>(__fadd_rn(
            __fmul_rn(__fmul_rn(v[i][q] - mean, rstd), we[q]), be[q]));
        amax = fmaxf(amax, fabsf(v[i][q]));
      }
      if (out) st8(out + (size_t)row * C + 8 * wd, v[i]);
    }
  }
  if (!q8) return;
  const float scale = __fmul_rn(fmaxf(warp_max(amax), 1e-6f), 1.f / 127.f);
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int wd = lane + 32 * i;
    if (wd < words) {
      uint2 pk;
      signed char* pq = reinterpret_cast<signed char*>(&pk);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        pq[q] = (signed char)fminf(fmaxf(rintf(v[i][q] / scale), -127.f),
                                   127.f);
      reinterpret_cast<uint2*>(q8 + (size_t)row * C)[wd] = pk;
    }
  }
  if (lane == 0) sx[row] = scale;
}

// per-token int8 quantisation of T rows, one warp per row of K: the row's
// max over groups of 8 values, then the same groups again (from L1)
// quantised, 8 bytes stored a group
template <typename T>
__global__ void __launch_bounds__(256) swin_quant_rows_kernel(
    const T* __restrict__ x, signed char* __restrict__ q8,
    float* __restrict__ sx, int M, int K) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int words = K / 8;
  const T* xr = x + (size_t)row * K;
  float amax = 0.f;
  for (int wd = lane; wd < words; wd += 32) {
    float e[8];
    ld8(xr + 8 * wd, e);
#pragma unroll
    for (int q = 0; q < 8; ++q) amax = fmaxf(amax, fabsf(e[q]));
  }
  const float scale = __fmul_rn(fmaxf(warp_max(amax), 1e-6f), 1.f / 127.f);
  uint2* qr = reinterpret_cast<uint2*>(q8 + (size_t)row * K);
  for (int wd = lane; wd < words; wd += 32) {
    float e[8];
    ld8(xr + 8 * wd, e);
    uint2 pk;
    signed char* pq = reinterpret_cast<signed char*>(&pk);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      pq[q] = (signed char)fminf(fmaxf(rintf(e[q] / scale), -127.f), 127.f);
    qr[wd] = pk;
  }
  if (lane == 0) sx[row] = scale;
}

// LN1/LN2 or the int8 quantisation of rows the register tile above and the
// wide kernel below do not take (LN rows over SWIN_LN_WIDE_C, LN rows
// quantised at a padded pitch, int8 rows of any K): one warp a row walks it
// in 8-value
// words (common.cuh::row_walk), once for each pass (two-pass statistics,
// then the output and the row's max, then the int8 values from the row
// again), so any C works. LN: the row is normalised as swin_layernorm_kernel
// does it (same operations in the same order); otherwise it is quantised as
// it is (swin_quant_rows_kernel's rounding). q8 rows are ldq bytes apart,
// ldq a multiple of 16 at least C, their columns C .. ldq - 1 zero, so the
// int8 GEMM's TMA can read them (ops/swin_block.py::pitched).
template <typename T, bool LN>
__global__ void __launch_bounds__(256) swin_rows_walk_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ b, T* __restrict__ out,
    signed char* __restrict__ q8, float* __restrict__ sx, int M, int C,
    int ldq, float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * C;
  T* outr = out ? out + (size_t)row * C : nullptr;
  const bool vec = aligned16(xr) && (!outr || aligned16(outr)) &&
                   aligned16(w) && aligned16(b);
  float mean = 0.f, rstd = 1.f;
  if (LN) ln_row_stats<false>(xr, C, lane, 32, vec, eps, mean, rstd);
  // the row's value at word wd, as LN (rounded to T) or as it is
  auto value = [&](int wd, int n, float (&v)[8]) {
    if (!LN) return;
    float we[8], be[8];
    ld_word(w + 8 * wd, n, vec, we);
    ld_word(b + 8 * wd, n, vec, be);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      v[q] = rd<T>(__fadd_rn(__fmul_rn(__fmul_rn(v[q] - mean, rstd), we[q]),
                             be[q]));
  };
  float amax = 0.f;
  row_walk(xr, C, lane, 32, vec, [&](int wd, int n, float (&v)[8]) {
    value(wd, n, v);
    if (outr) st_word(outr + 8 * wd, n, vec, v);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < n) amax = fmaxf(amax, fabsf(v[q]));
  });
  if (!q8) return;
  const float scale = __fmul_rn(fmaxf(warp_max(amax), 1e-6f), 1.f / 127.f);
  signed char* qr = q8 + (size_t)row * ldq;
  row_walk(xr, C, lane, 32, vec, [&](int wd, int n, float (&v)[8]) {
    value(wd, n, v);
    uint2 pk;
    signed char* pq = reinterpret_cast<signed char*>(&pk);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      pq[q] = q < n ? (signed char)fminf(fmaxf(rintf(v[q] / scale), -127.f),
                                         127.f)
                    : (signed char)0;
    // ldq is a multiple of 8 at least 8 ceil(C / 8): the word is in the row
    reinterpret_cast<uint2*>(qr)[wd] = pk;
  });
  // the padding past the last word (ldq >= 8 ceil(C / 8))
  for (int c = 8 * ((C + 7) / 8) + lane; c < ldq; c += 32) qr[c] = 0;
  if (lane == 0) sx[row] = scale;
}

// LN1/LN2 (+ int8) of rows of SWIN_LN_TILE_C < C <= SWIN_LN_WIDE_C values
// (the .e384 stage 3's 3072), the redesign of swin_rows_walk_kernel's LN
// for them: it walked the row three times, one 16-byte word at a time (the
// two-pass statistics, then the output and the max, then the int8 values),
// about one load in flight a lane. Here the row is read from device memory
// once: the S = SWIN_LN_WIDE_WARPS warps of a row hold it in registers
// (common.cuh::RowRegs, as kernel 9's wide instance), every load issued
// before the first reduction; the mean, the second pass of the two-pass
// variance, the output, the max and the int8 values all read the
// registers, the normalised values (rounded to T) written back into them.
// The sums run in the walk's order (chain_sums) and every operation is the
// walk's, so the outputs, the int8 values and the scales equal its bit for
// bit. q8 rows are ldq bytes apart, their padding zero, as the walk writes
// them. One block a step: 8 / S rows.
#define SWIN_LN_WIDE_C 4096  // 32 lanes x 16 words x 8 values
// warps a row, bf16 and f32: two, where kernel 9's wide instance takes four
// (LN_WIDE_WARPS). Here three sums are chained from warp to warp (the mean,
// the variance, the max), each waiting on the one before and costing a
// block barrier a warp, against kernel 9's one; of one (two in f32), two
// and four warps, two was the fastest on the H100 in bf16 and f32 out and
// in bf16 int8 rows, four in f32 int8 rows (scripts/row_walk_profile.py)
#define SWIN_LN_WIDE_WARPS 2
template <typename T>
__global__ void __launch_bounds__(256) swin_rows_wide_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ b, T* __restrict__ out,
    signed char* __restrict__ q8, float* __restrict__ sx, int M, int C,
    int ldq, int W, float eps) {
  constexpr int S = SWIN_LN_WIDE_WARPS, WMAX = 16 / S, ROWS = 8 / S;
  __shared__ float part[ROWS][32], tot[ROWS][1], red[ROWS][S];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp / S, sw = warp % S;
  const int row = blockIdx.x * ROWS + slot;
  const int words = C / 8, w0 = lane + 32 * sw * W;
  // rows past M load the last row, take part in the barriers, store nothing
  const T* xr = x + (size_t)min(row, M - 1) * C;
  RowRegs<T, WMAX> r;
  row_regs_load(r, xr, w0, W, words);
  auto held = [&](int i) { return i < W && w0 + 32 * i < words; };
  float acc[1] = {0.f};
  chain_sums<S>(acc, part[slot], tot[slot], sw, lane, [&](float (&a)[1]) {
#pragma unroll
    for (int i = 0; i < WMAX; ++i) {
      if (held(i)) {
        float v[8];
        unpack_word(r.u[i], v);
#pragma unroll
        for (int q = 0; q < 8; ++q) a[0] += v[q];
      }
    }
  });
  const float mean = acc[0] / (float)C;
  acc[0] = 0.f;
  chain_sums<S>(acc, part[slot], tot[slot], sw, lane, [&](float (&a)[1]) {
#pragma unroll
    for (int i = 0; i < WMAX; ++i) {
      if (held(i)) {
        float v[8];
        unpack_word(r.u[i], v);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float d = v[q] - mean;
          a[0] += d * d;
        }
      }
    }
  });
  const float rstd = rsqrtf(acc[0] / (float)C + eps);
  T* outr = out && row < M ? out + (size_t)row * C : nullptr;
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < WMAX; ++i) {
    const int wd = w0 + 32 * i;
    if (held(i)) {
      float v[8], we[8], be[8];
      unpack_word(r.u[i], v);
      ld8(w + 8 * wd, we);
      ld8(b + 8 * wd, be);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        v[q] = rd<T>(__fadd_rn(
            __fmul_rn(__fmul_rn(v[q] - mean, rstd), we[q]), be[q]));
        amax = fmaxf(amax, fabsf(v[q]));
      }
      if (outr) st8(outr + 8 * wd, v);
      pack_word(r.u[i], v);  // the values as T, for the int8 rows
    }
  }
  if (!q8) return;
  const float scale =
      __fmul_rn(fmaxf(chain_max<S>(amax, red[slot], sw, lane), 1e-6f),
                1.f / 127.f);
  if (row >= M) return;
  signed char* qr = q8 + (size_t)row * ldq;
#pragma unroll
  for (int i = 0; i < WMAX; ++i) {
    if (held(i)) {
      float v[8];
      unpack_word(r.u[i], v);
      uint2 pk;
      signed char* pq = reinterpret_cast<signed char*>(&pk);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        pq[q] = (signed char)fminf(fmaxf(rintf(v[q] / scale), -127.f),
                                   127.f);
      reinterpret_cast<uint2*>(qr)[w0 + 32 * i] = pk;
    }
  }
  if (sw == 0) {
    for (int c = C + lane; c < ldq; c += 32) qr[c] = 0;  // the padding
    if (lane == 0) sx[row] = scale;
  }
}

template <typename T, int NW>
static void launch_ln(const void* x, const void* w, const void* b, void* out,
                      signed char* q8, float* sx, int M, int C, float eps,
                      cudaStream_t stream) {
  swin_layernorm_kernel<T, NW><<<ceil_div(M, 8), 256, 0, stream>>>(
      (const T*)x, (const T*)w, (const T*)b, (T*)out, q8, sx, M, C, eps);
}

template <typename T, bool LN>
static void launch_walk(const void* x, const void* w, const void* b,
                        void* out, signed char* q8, float* sx, int M, int C,
                        int ldq, float eps, cudaStream_t stream) {
  swin_rows_walk_kernel<T, LN><<<ceil_div(M, 8), 256, 0, stream>>>(
      (const T*)x, (const T*)w, (const T*)b, (T*)out, q8, sx, M, C, ldq,
      eps);
}

template <typename T>
static void launch_ln_t(const void* x, const void* w, const void* b,
                        void* out, signed char* q8, float* sx, int M, int C,
                        int ldq, float eps, cudaStream_t stream) {
  const int nw = ceil_div(C / 8, 32);  // groups of 8 channels per lane
  if (C > SWIN_LN_TILE_C && C <= SWIN_LN_WIDE_C) {
    constexpr int S = SWIN_LN_WIDE_WARPS;
    swin_rows_wide_kernel<T><<<ceil_div(M, 8 / S), 256, 0, stream>>>(
        (const T*)x, (const T*)w, (const T*)b, (T*)out, q8, sx, M, C, ldq,
        ceil_div(C / 8, 32 * S), eps);
  } else if (C > SWIN_LN_TILE_C || (q8 && ldq != C))
    launch_walk<T, true>(x, w, b, out, q8, sx, M, C, ldq, eps, stream);
  else if (nw == 1) launch_ln<T, 1>(x, w, b, out, q8, sx, M, C, eps, stream);
  else if (nw == 2) launch_ln<T, 2>(x, w, b, out, q8, sx, M, C, eps, stream);
  else if (nw <= 4) launch_ln<T, 4>(x, w, b, out, q8, sx, M, C, eps, stream);
  else launch_ln<T, SWIN_LN_MAX_WORDS>(x, w, b, out, q8, sx, M, C, eps,
                                       stream);
}

// f32: nonzero for the f32 instance (f32 tokens, affine and output). Any C
// % 8 == 0: up to SWIN_LN_TILE_C channels with the unquantised or int8
// rows at pitch C, the register-tile kernel; up to SWIN_LN_WIDE_C, the
// wide kernel (int8 rows at pitch ldq); wider rows, or int8 rows of at
// most SWIN_LN_TILE_C channels at a padded pitch ldq (a multiple of 16, at
// least C), the walk.
MB_EXPORT int swin_layernorm(const void* x, const void* w, const void* b,
                             void* out, signed char* q8, float* sx, int M,
                             int C, int ldq, float eps, int f32,
                             cudaStream_t stream) {
  if (C < 8 || C % 8 || (q8 && (ldq < C || (ldq % 16 && ldq != C))))
    return MB_BAD_ARGS;
  if (f32)
    launch_ln_t<float>(x, w, b, out, q8, sx, M, C, ldq, eps, stream);
  else
    launch_ln_t<bf16>(x, w, b, out, q8, sx, M, C, ldq, eps, stream);
  return (int)cudaGetLastError();
}

// int8 rows of (M, K) T values: K % 8 == 0 at pitch K, the flagship
// kernel; any other K, or a padded pitch ldq (a multiple of 16, at least
// K), the walk.
MB_EXPORT int swin_quant_rows(const void* x, signed char* q8, float* sx,
                              int M, int K, int ldq, int f32,
                              cudaStream_t stream) {
  if (K < 1 || ldq < K || (ldq % 16 && ldq != K)) return MB_BAD_ARGS;
  if (K % 8 || ldq != K) {
    if (ldq % 16) return MB_BAD_ARGS;
    if (f32)
      launch_walk<float, false>(x, nullptr, nullptr, nullptr, q8, sx, M, K,
                                ldq, 0.f, stream);
    else
      launch_walk<bf16, false>(x, nullptr, nullptr, nullptr, q8, sx, M, K,
                               ldq, 0.f, stream);
  } else if (f32) {
    swin_quant_rows_kernel<float><<<ceil_div(M, 8), 256, 0, stream>>>(
        (const float*)x, q8, sx, M, K);
  } else {
    swin_quant_rows_kernel<bf16><<<ceil_div(M, 8), 256, 0, stream>>>(
        (const bf16*)x, q8, sx, M, K);
  }
  return (int)cudaGetLastError();
}

// the window attention of the block (window_attn.cuh, Swin variant): f32
// nonzero for f32 qkv and out, else bf16; head widths 16, 32, 64 (the
// others: attn_widths_swin.cu)
MB_EXPORT int swin_window_attn(const void* qkv, const float* qkv_bias,
                               const float* rel, void* out, int B, int H,
                               int W, int C, int heads, int win, int shift,
                               float scale, int f32, cudaStream_t stream) {
  return launch_window_attn<false, 16, 32, 64>(qkv, qkv_bias, rel, out, B, H,
                                               W, C, heads, win, shift,
                                               scale, f32, stream);
}
