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
// What bounds it on the H100: bytes at stages 0-1, operations at stages
// 2-3. A block does ~12 C^2 multiply-adds per token in the four products
// (int8 or bf16 tensor cores) plus 4 n hd multiply-adds per token and head
// in attention (n = 100), and its launches move ~26 C bytes a token; at
// the flagship the backbone's products total ~1.4 TOP per batch of 8 (0.7
// ms at the int8 peak). Every launch has an f32 instance for the f32
// configurations (the f32 GEMM of gemm.cuh or the int8 GEMM with f32
// epilogues, f32 LN and quantise, a plain f32 attention kernel below): no
// operand is rounded to bf16 there. Design: the products go through the
// persistent
// wgmma GEMM (gemm.cuh) with LN/quantise/bias/GELU/residual work fused into
// neighbouring launches. The first attention kernel gave each (window,
// head) a block of 256 threads with its f32 score tile in ~100 KB of shared
// memory and seven barrier phases; this one keeps the scores in registers
// (FlashAttention-2 style, one warp per 16 query rows), loads q, k, v rows
// with 16-byte cp.async, and holds the relative bias of the block's head in
// shared memory as bf16, read once for ATT_WPB windows (the alternative,
// several heads of one window a block, measured 2.5x slower at stage 0:
// PERF.md section 6). The LN and quantisation launches read and write their
// rows in 16-byte words (they used 2-byte loads).
#include "common.cuh"

// LN1/LN2 of a block, one warp per token row: each lane holds NW groups of
// 8 channels (16-byte words in bf16) of the row in registers, so the row is
// read once; two-pass f32 statistics, then T out or int8 + scale. T: the
// tokens' and the affine's type (bf16, or f32 for the f32 instance).
#define SWIN_LN_MAX_WORDS 8  // C <= 8 * 8 * 32 = 2048

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

__device__ __forceinline__ int shift_region(int r, int size, int win,
                                            int shift) {
  return r < size - win ? 0 : (r < size - shift ? 1 : 2);
}

// Window attention, FlashAttention-2 style: grid (ceil(nW / ATT_WPB),
// heads, B); a block takes ATT_WPB windows of one head of one sample,
// one warp per 16 query rows of the window padded to NP = 16 ceil(n / 16)
// rows (7 warps at win 10). qkv (B*H*W, 3C) bf16 with channel order
// [q | k | v] x heads x hd; out (B*H*W, C) bf16. Per (window, head): q, k, v
// rows arrive by 16-byte cp.async (pad tokens take the qkv bias, rows past
// the window are zero); each warp keeps its 16 x NP f32 scores in registers
// (mma.sync m16n8k16, bf16 operands, f32 accumulation), adds the relative
// bias (held in shared memory as bf16 for the block's head: the values
// come from the model's bf16 table, so that is exact) and the -100
// shift-region mask, takes the exact softmax over the row with quad
// shuffles, rounds P to bf16 in registers and feeds it to the P v products
// as the A operand. q is scaled and rounded to bf16 in registers, as the
// reference scales the bf16 q.
constexpr int ATT_MAX_NPT = 8;  // n <= 128: at most 8 warps of 16 rows
constexpr int ATT_WPB = 4;      // windows a block, so the bias is read once

// MAXNPT: the register arrays' size in 16-key steps (7 for win 10); two
// blocks share an SM
template <int HD, int MAXNPT>
__global__ void __launch_bounds__(32 * MAXNPT, 2) swin_window_attn_kernel(
    const bf16* __restrict__ qkv, const float* __restrict__ qkv_bias,
    const float* __restrict__ rel, bf16* __restrict__ out, int H, int W,
    int C, int heads, int win, int shift, float scale) {
  extern __shared__ __align__(16) unsigned char smraw[];
  constexpr int LD = HD + 8;  // bf16 row stride: conflict-free ldmatrix
  const int n = win * win, npt = (n + 15) / 16, NP = 16 * npt;
  const int ldb = NP + 8;
  bf16* qs = reinterpret_cast<bf16*>(smraw);
  bf16* ks = qs + NP * LD;
  bf16* vs = ks + NP * LD;
  bf16* bs = vs + NP * LD;  // NP x ldb relative bias of head h
  int* tok = reinterpret_cast<int*>(bs + NP * ldb);
  int* lab = tok + NP;

  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  const int nww = wp / win, nw = (hp / win) * nww;
  const int b = blockIdx.z, h = blockIdx.y, w0 = blockIdx.x * ATT_WPB;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  for (int e = tid; e < n * n; e += nthr)
    bs[(e / n) * ldb + e % n] =
        __float2bfloat16_rn(rel[(size_t)h * n * n + e]);
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = tid; i < (NP - n) * LD; i += nthr) {
    qs[n * LD + i] = zero;
    ks[n * LD + i] = zero;
    vs[n * LD + i] = zero;
  }

  const int wend = min(w0 + ATT_WPB, nw);
  for (int wi = w0; wi < wend; ++wi) {
    const int wy = wi / nww, wx = wi % nww;
    __syncthreads();  // the previous window's rows are read
    for (int r = tid; r < n; r += nthr) {
      const int gy = wy * win + r / win, gx = wx * win + r % win;  // rolled
      const int ro = (gy + shift) % hp, co = (gx + shift) % wp;    // padded
      tok[r] = (ro < H && co < W) ? (b * H + ro) * W + co : -1;
      lab[r] = shift ? shift_region(gy, hp, win, shift) * 3 +
                           shift_region(gx, wp, win, shift)
                     : 0;
    }
    __syncthreads();
    // ---- q, k, v rows of head h: 16 bytes per copy ----------------------
    constexpr int CH = HD / 8;
    for (int i = tid; i < n * 3 * CH; i += nthr) {
      const int r = i / (3 * CH), part = (i / CH) % 3, c8 = (i % CH) * 8;
      bf16* dst = (part == 0 ? qs : part == 1 ? ks : vs) + r * LD + c8;
      const int tk = tok[r];
      if (tk >= 0) {
        cp_async16(dst, qkv + (size_t)tk * 3 * C + part * C + h * HD + c8);
      } else {  // pad token: zero after LN1, so its qkv row is the bias
        const float* bsrc = qkv_bias + part * C + h * HD + c8;
        uint4 v;
        v.x = pack_bf16(bsrc[0], bsrc[1]);
        v.y = pack_bf16(bsrc[2], bsrc[3]);
        v.z = pack_bf16(bsrc[4], bsrc[5]);
        v.w = pack_bf16(bsrc[6], bsrc[7]);
        *reinterpret_cast<uint4*>(dst) = v;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (warp >= npt) continue;

    // ---- S = (scale q) k^T, 16 rows x NP keys in registers --------------
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      ldsm_x4(qa[kk], qs + (16 * warp + (lane & 15)) * LD + kk * 16 +
                          (lane >> 4) * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16(qa[kk][e]);
        qa[kk][e] = pack_bf16(f.x * scale, f.y * scale);
      }
    }
    float s[2 * MAXNPT][4];
#pragma unroll
    for (int j = 0; j < 2 * MAXNPT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if (j < 2 * npt) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t b0, b1;
          ldsm_x2(b0, b1, ks + (8 * j + (lane & 7)) * LD + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_16816(s[j], qa[kk], b0, b1);
        }
      }
    }

    // ---- bias, shift mask, exact softmax over the n real keys -----------
    const int r0 = 16 * warp + g, r1 = r0 + 8;
    const int l0 = r0 < n ? lab[r0] : 0, l1 = r1 < n ? lab[r1] : 0;
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * MAXNPT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r0 : r1, c = 8 * j + 2 * t + (e & 1);
        float v = -INFINITY;
        if (c < n) {
          float bias = r < n ? __bfloat162float(bs[r * ldb + c]) : 0.f;
          if (shift && (e < 2 ? l0 : l1) != lab[c])
            bias = __fadd_rn(bias, -100.f);
          v = __fadd_rn(s[j][e], bias);
        }
        s[j][e] = v;
        if (e < 2)
          m0 = fmaxf(m0, v);
        else
          m1 = fmaxf(m1, v);
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    float l0s = 0.f, l1s = 0.f;  // row sums, then their reciprocals
#pragma unroll
    for (int j = 0; j < 2 * MAXNPT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(s[j][e] - (e < 2 ? m0 : m1));
        s[j][e] = x;
        if (e < 2)
          l0s += x;
        else
          l1s += x;
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0s += __shfl_xor_sync(0xffffffffu, l0s, o);
      l1s += __shfl_xor_sync(0xffffffffu, l1s, o);
    }
    l0s = 1.f / l0s;
    l1s = 1.f / l1s;

    // ---- O = P v: P rounded to bf16 in registers is the A operand --------
    float acc[HD / 8][4];
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jd][e] = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < MAXNPT; ++s2) {
      if (s2 >= npt) continue;
      const uint32_t pa[4] = {
          pack_bf16(s[2 * s2][0] * l0s, s[2 * s2][1] * l0s),
          pack_bf16(s[2 * s2][2] * l1s, s[2 * s2][3] * l1s),
          pack_bf16(s[2 * s2 + 1][0] * l0s, s[2 * s2 + 1][1] * l0s),
          pack_bf16(s[2 * s2 + 1][2] * l1s, s[2 * s2 + 1][3] * l1s)};
#pragma unroll
      for (int jd = 0; jd < HD / 8; ++jd) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, vs + (16 * s2 + (lane & 15)) * LD + 8 * jd);
        mma_16816(acc[jd], pa, b0, b1);
      }
    }
    const int tk0 = r0 < n ? tok[r0] : -1, tk1 = r1 < n ? tok[r1] : -1;
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd) {
      const int col = h * HD + 8 * jd + 2 * t;
      if (tk0 >= 0)
        *reinterpret_cast<uint32_t*>(out + (size_t)tk0 * C + col) =
            pack_bf16(acc[jd][0], acc[jd][1]);
      if (tk1 >= 0)
        *reinterpret_cast<uint32_t*>(out + (size_t)tk1 * C + col) =
            pack_bf16(acc[jd][2], acc[jd][3]);
    }
  }
}

// The f32 instance of the window attention: grid (nW, heads, B), 256
// threads; one (window, head) a block. q (scaled), k and v rows of the
// window in shared memory as f32 (row stride hd + 1: conflict-free column
// reads), pad tokens taking the qkv bias; one warp per query row
// (common.cuh::f32_attn_row): its q in registers, lanes over keys for the
// f32 scores, bias and shift mask, exact softmax, then lanes over the
// head's channels for P v. Nothing is rounded below f32, as XLA computes
// the f32 block on the CPU.
#define ATT32_THREADS 256
template <int HD>
__global__ void __launch_bounds__(ATT32_THREADS) swin_window_attn_f32_kernel(
    const float* __restrict__ qkv, const float* __restrict__ qkv_bias,
    const float* __restrict__ rel, float* __restrict__ out, int H, int W,
    int C, int heads, int win, int shift, float scale) {
  extern __shared__ __align__(16) float sm32[];
  constexpr int ld = HD + 1;
  const int n = win * win;
  float* qs = sm32;
  float* ks = qs + n * ld;
  float* vs = ks + n * ld;
  float* ps = vs + n * ld;  // (ATT32_THREADS / 32) x n probabilities
  int* tok = reinterpret_cast<int*>(ps + (ATT32_THREADS / 32) * n);
  int* lab = tok + n;

  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  const int nww = wp / win;
  const int wi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int wy = wi / nww, wx = wi % nww;
  const int tid = threadIdx.x, warp = tid >> 5;
  for (int r = tid; r < n; r += ATT32_THREADS) {
    const int gy = wy * win + r / win, gx = wx * win + r % win;  // rolled
    const int ro = (gy + shift) % hp, co = (gx + shift) % wp;    // padded
    tok[r] = (ro < H && co < W) ? (b * H + ro) * W + co : -1;
    lab[r] = shift ? shift_region(gy, hp, win, shift) * 3 +
                         shift_region(gx, wp, win, shift)
                   : 0;
  }
  __syncthreads();
  for (int i = tid; i < n * HD; i += ATT32_THREADS) {
    const int r = i / HD, d = i % HD, tk = tok[r];
    const int c = h * HD + d;
    float q, k, v;
    if (tk >= 0) {
      const float* row = qkv + (size_t)tk * 3 * C;
      q = row[c]; k = row[C + c]; v = row[2 * C + c];
    } else {  // pad token: zero after LN1, so its qkv row is the bias
      q = qkv_bias[c]; k = qkv_bias[C + c]; v = qkv_bias[2 * C + c];
    }
    qs[r * ld + d] = q * scale;
    ks[r * ld + d] = k;
    vs[r * ld + d] = v;
  }
  __syncthreads();
  const float* relh = rel + (size_t)h * n * n;
  float* pw = ps + warp * n;
  for (int i = warp; i < n; i += ATT32_THREADS / 32) {
    const int li = lab[i], tk = tok[i];
    f32_attn_row<HD>(
        qs + i * ld, ks, vs, ld, n, pw,
        [&](float s, int j) {
          float bias = relh[i * n + j];
          if (shift && li != lab[j]) bias = __fadd_rn(bias, -100.f);
          return __fadd_rn(s, bias);
        },
        [&](int d, float o) {
          if (tk >= 0) out[(size_t)tk * C + h * HD + d] = o;
        });
  }
}

template <typename T, int NW>
static void launch_ln(const void* x, const void* w, const void* b, void* out,
                      signed char* q8, float* sx, int M, int C, float eps,
                      cudaStream_t stream) {
  swin_layernorm_kernel<T, NW><<<ceil_div(M, 8), 256, 0, stream>>>(
      (const T*)x, (const T*)w, (const T*)b, (T*)out, q8, sx, M, C, eps);
}

template <typename T>
static void launch_ln_t(const void* x, const void* w, const void* b,
                        void* out, signed char* q8, float* sx, int M, int C,
                        float eps, cudaStream_t stream) {
  const int nw = ceil_div(C / 8, 32);  // groups of 8 channels per lane
  if (nw == 1) launch_ln<T, 1>(x, w, b, out, q8, sx, M, C, eps, stream);
  else if (nw == 2) launch_ln<T, 2>(x, w, b, out, q8, sx, M, C, eps, stream);
  else if (nw <= 4) launch_ln<T, 4>(x, w, b, out, q8, sx, M, C, eps, stream);
  else launch_ln<T, SWIN_LN_MAX_WORDS>(x, w, b, out, q8, sx, M, C, eps,
                                       stream);
}

// f32: nonzero for the f32 instance (f32 tokens, affine and output)
MB_EXPORT int swin_layernorm(const void* x, const void* w, const void* b,
                             void* out, signed char* q8, float* sx, int M,
                             int C, float eps, int f32, cudaStream_t stream) {
  if (C % 8 || C > 8 * 32 * SWIN_LN_MAX_WORDS) return MB_BAD_ARGS;
  if (f32)
    launch_ln_t<float>(x, w, b, out, q8, sx, M, C, eps, stream);
  else
    launch_ln_t<bf16>(x, w, b, out, q8, sx, M, C, eps, stream);
  return (int)cudaGetLastError();
}

MB_EXPORT int swin_quant_rows(const void* x, signed char* q8, float* sx,
                              int M, int K, int f32, cudaStream_t stream) {
  if (K % 8) return MB_BAD_ARGS;
  if (f32)
    swin_quant_rows_kernel<float><<<ceil_div(M, 8), 256, 0, stream>>>(
        (const float*)x, q8, sx, M, K);
  else
    swin_quant_rows_kernel<bf16><<<ceil_div(M, 8), 256, 0, stream>>>(
        (const bf16*)x, q8, sx, M, K);
  return (int)cudaGetLastError();
}

template <int HD>
static int launch_attn(const bf16* qkv, const float* qkv_bias,
                       const float* rel, bf16* out, int B, int H, int W,
                       int C, int heads, int win, int shift, float scale,
                       cudaStream_t stream) {
  const int n = win * win, NP = (n + 15) / 16 * 16;
  const size_t smem = sizeof(bf16) * (3 * NP * (HD + 8) + NP * (NP + 8)) +
                      sizeof(int) * 2 * NP;
  auto kern = NP == 112 ? swin_window_attn_kernel<HD, 7>
                        : swin_window_attn_kernel<HD, ATT_MAX_NPT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  dim3 grid(ceil_div((hp / win) * (wp / win), ATT_WPB), heads, B);
  kern<<<grid, 32 * (NP / 16), smem, stream>>>(qkv, qkv_bias, rel, out, H, W,
                                                C, heads, win, shift, scale);
  return (int)cudaGetLastError();
}

MB_EXPORT int swin_window_attn(const bf16* qkv, const float* qkv_bias,
                               const float* rel, bf16* out, int B, int H,
                               int W, int C, int heads, int win, int shift,
                               float scale, cudaStream_t stream) {
  const int n = win * win;
  if (C % heads || n > 16 * ATT_MAX_NPT) return MB_BAD_ARGS;
  switch (C / heads) {
    case 16:
      return launch_attn<16>(qkv, qkv_bias, rel, out, B, H, W, C, heads, win,
                             shift, scale, stream);
    case 32:
      return launch_attn<32>(qkv, qkv_bias, rel, out, B, H, W, C, heads, win,
                             shift, scale, stream);
    case 64:
      return launch_attn<64>(qkv, qkv_bias, rel, out, B, H, W, C, heads, win,
                             shift, scale, stream);
  }
  return MB_BAD_ARGS;
}

template <int HD>
static int launch_attn_f32(const float* qkv, const float* qkv_bias,
                           const float* rel, float* out, int B, int H, int W,
                           int C, int heads, int win, int shift, float scale,
                           cudaStream_t stream) {
  const int n = win * win;
  const size_t smem = sizeof(float) * (3 * n * (HD + 1) +
                                       (ATT32_THREADS / 32) * n) +
                      sizeof(int) * 2 * n;
  cudaError_t e = cudaFuncSetAttribute(
      swin_window_attn_f32_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  dim3 grid((hp / win) * (wp / win), heads, B);
  swin_window_attn_f32_kernel<HD><<<grid, ATT32_THREADS, smem, stream>>>(
      qkv, qkv_bias, rel, out, H, W, C, heads, win, shift, scale);
  return (int)cudaGetLastError();
}

// The f32 instance: qkv (B*H*W, 3C), out (B*H*W, C) f32; head widths 16,
// 32 or 64 and windows of at most 128 tokens
MB_EXPORT int swin_window_attn_f32(const float* qkv, const float* qkv_bias,
                                   const float* rel, float* out, int B,
                                   int H, int W, int C, int heads, int win,
                                   int shift, float scale,
                                   cudaStream_t stream) {
  if (C % heads || win * win > 16 * ATT_MAX_NPT) return MB_BAD_ARGS;
  switch (C / heads) {
    case 16:
      return launch_attn_f32<16>(qkv, qkv_bias, rel, out, B, H, W, C, heads,
                                 win, shift, scale, stream);
    case 32:
      return launch_attn_f32<32>(qkv, qkv_bias, rel, out, B, H, W, C, heads,
                                 win, shift, scale, stream);
    case 64:
      return launch_attn_f32<64>(qkv, qkv_bias, rel, out, B, H, W, C, heads,
                                 win, shift, scale, stream);
  }
  return MB_BAD_ARGS;
}
