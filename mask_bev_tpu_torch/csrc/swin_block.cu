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
// ms at the int8 peak). Design: the products go through the persistent
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

// LN1/LN2 of a block, one warp per token row: each lane holds NW 16-byte
// words (8 channels each) of the row in registers, so the row is read once;
// two-pass f32 statistics, then bf16 out (16-byte stores) or int8 + scale
#define SWIN_LN_MAX_WORDS 8  // C <= 8 * 8 * 32 = 2048

template <int NW>
__global__ void __launch_bounds__(256) swin_layernorm_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const bf16* __restrict__ b, bf16* __restrict__ out,
    signed char* __restrict__ q8, float* __restrict__ sx, int M, int C,
    float eps) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int words = C / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * C);
  float v[NW][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int wd = lane + 32 * i;
    if (wd < words) {
      const uint4 u = xr[wd];
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        v[i][q] = __bfloat162float(e[q]);
        s += v[i][q];
      }
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
      const uint4 wu = reinterpret_cast<const uint4*>(w)[wd];
      const uint4 bu = reinterpret_cast<const uint4*>(b)[wd];
      const bf16* we = reinterpret_cast<const bf16*>(&wu);
      const bf16* be = reinterpret_cast<const bf16*>(&bu);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        v[i][q] = rd_bf16(__fadd_rn(
            __fmul_rn(__fmul_rn(v[i][q] - mean, rstd),
                      __bfloat162float(we[q])),
            __bfloat162float(be[q])));
        amax = fmaxf(amax, fabsf(v[i][q]));
      }
      if (out)
        reinterpret_cast<uint4*>(out + (size_t)row * C)[wd] = make_uint4(
            pack_bf16(v[i][0], v[i][1]), pack_bf16(v[i][2], v[i][3]),
            pack_bf16(v[i][4], v[i][5]), pack_bf16(v[i][6], v[i][7]));
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

// per-token int8 quantisation, one warp per row of K: the row's max over
// 16-byte words, then the same words again (from L1) quantised, 8 bytes
// stored a word
__global__ void __launch_bounds__(256) swin_quant_rows_kernel(
    const bf16* __restrict__ x, signed char* __restrict__ q8,
    float* __restrict__ sx, int M, int K) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int words = K / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  float amax = 0.f;
  for (int wd = lane; wd < words; wd += 32) {
    const uint4 u = xr[wd];
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      amax = fmaxf(amax, fabsf(__bfloat162float(e[q])));
  }
  const float scale = __fmul_rn(fmaxf(warp_max(amax), 1e-6f), 1.f / 127.f);
  uint2* qr = reinterpret_cast<uint2*>(q8 + (size_t)row * K);
  for (int wd = lane; wd < words; wd += 32) {
    const uint4 u = xr[wd];
    const bf16* e = reinterpret_cast<const bf16*>(&u);
    uint2 pk;
    signed char* pq = reinterpret_cast<signed char*>(&pk);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      pq[q] = (signed char)fminf(
          fmaxf(rintf(__bfloat162float(e[q]) / scale), -127.f), 127.f);
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

template <int NW>
static void launch_ln(const bf16* x, const bf16* w, const bf16* b, bf16* out,
                      signed char* q8, float* sx, int M, int C, float eps,
                      cudaStream_t stream) {
  swin_layernorm_kernel<NW><<<ceil_div(M, 8), 256, 0, stream>>>(
      x, w, b, out, q8, sx, M, C, eps);
}

MB_EXPORT int swin_layernorm(const bf16* x, const bf16* w, const bf16* b,
                             bf16* out, signed char* q8, float* sx, int M,
                             int C, float eps, cudaStream_t stream) {
  if (C % 8 || C > 8 * 32 * SWIN_LN_MAX_WORDS) return MB_BAD_ARGS;
  const int nw = ceil_div(C / 8, 32);  // 16-byte words per lane
  if (nw == 1) launch_ln<1>(x, w, b, out, q8, sx, M, C, eps, stream);
  else if (nw == 2) launch_ln<2>(x, w, b, out, q8, sx, M, C, eps, stream);
  else if (nw <= 4) launch_ln<4>(x, w, b, out, q8, sx, M, C, eps, stream);
  else launch_ln<SWIN_LN_MAX_WORDS>(x, w, b, out, q8, sx, M, C, eps, stream);
  return (int)cudaGetLastError();
}

MB_EXPORT int swin_quant_rows(const bf16* x, signed char* q8, float* sx,
                              int M, int K, cudaStream_t stream) {
  if (K % 8) return MB_BAD_ARGS;
  swin_quant_rows_kernel<<<ceil_div(M, 8), 256, 0, stream>>>(x, q8, sx, M, K);
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
