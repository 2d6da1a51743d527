// One window-attention kernel for kernel 3 (the Swin chain's attention,
// csrc/swin_block.cu) and kernel 7 (the window MSA's, csrc/window_msa.cu),
// in bf16 and in f32.
//
// Both TPU functions compute windowed multi-head self-attention with a
// relative-position bias and, shifted, the -100 shift-region mask:
// mask_bev_tpu/ops/pallas_swin_block.py::fused_swin_block(_col) and
// mask_bev_tpu/ops/pallas_window_msa.py::fused_window_msa. They order the
// arithmetic differently, and each instance keeps its function's order:
//   Swin (MSA = false): q scaled before the product, rounded to the
//     activation type; the bias held as bf16 in the bf16 instance (the
//     model's bf16 table, so exact);
//   MSA (MSA = true): the f32 score scaled after the product
//     (__fmul_rn(s, scale)); the bias held as f32.
// Both add rel and the mask summed first in f32.
//
// What bounds it on the H100: bytes. Per token and head it reads 3 hd
// values of qkv and writes hd, ~4 C values a token; the two products are
// 4 n hd multiply-adds a token and head (n = 100): ~25 operations a byte
// in bf16, under the ~295 that the bf16 tensor cores need, and ~75 TF32
// operations a byte as 3xTF32 in f32, under TF32's ~148.
//
// Design (FlashAttention-2 style, the scores never leave registers):
// grid (ceil(nW / ATT_WPB), heads, B); a block takes ATT_WPB windows of one
// head of one sample, so the head's relative bias is read into shared
// memory once for them; one warp per 16 query rows of the window padded to
// NP = 16 ceil(n / 16) rows (7 warps at win 10). Windows, padding and the
// cyclic shift are index math on the (hp, wp) padded grid: token rows come
// from the unpadded (B*H*W, 3C) qkv, pad tokens (zero before the qkv
// product) take the qkv bias, rows past the window are zero, and the
// shift-region labels are computed, not read.
//   bf16: q, k, v rows by 16-byte cp.async into shared memory; S = q k^T on
//     mma.sync m16n8k16 (bf16 operands, f32 accumulation); the exact
//     softmax over the row with quad shuffles; P rounded to bf16 in
//     registers is the A operand of P v.
//   f32: both products in 3xTF32 on mma.sync m16n8k8 (hi.hi + hi.lo +
//     lo.hi, f32 accumulation): nothing is rounded below f32 except inside
//     that split. k and v are f32 in shared memory (row stride hd + 4:
//     conflict-free fragment loads); each warp reads its q rows from
//     device memory straight into registers, split once a window; P is
//     split in registers and used as the A operand with the accumulator's
//     columns 2t, 2t + 1 as the logical k-slots t, t + 4 (v's rows read in
//     the same order). Inside each chunk of 32 channels (16 at hd 16) the
//     channel index is permuted alike in q and k, so a lane's fragment
//     values are contiguous and the sums are unchanged.
#pragma once

#include <type_traits>

#include "common.cuh"

constexpr int ATT_MAX_NPT = 8;  // n <= 128: at most 8 warps of 16 rows
constexpr int ATT_WPB = 4;      // windows a block, so the bias is read once

__device__ __forceinline__ int shift_region(int r, int size, int win,
                                            int shift) {
  return r < size - win ? 0 : (r < size - shift ? 1 : 2);
}

// shared memory of one block: q, k, v rows (bf16, stride hd + 8) or k, v
// rows (f32, stride hd + 4); the head's bias (stride NP + 8) as bf16 over
// NP rows (Swin bf16) or as f32 over n rows; the token and label rows
static inline size_t window_attn_smem(int n, int hd, bool f32, bool msa) {
  const size_t np = (n + 15) / 16 * 16, ldb = np + 8;
  const size_t rows = f32 ? 2 * np * (hd + 4) * 4 : 3 * np * (hd + 8) * 2;
  const size_t bias = (f32 || msa) ? n * ldb * 4 : np * ldb * 2;
  return rows + bias + 2 * np * 4;
}

// The rows of window wi (nww windows a row) of head h in shared memory,
// for both kernels: the token and shift-label rows (tok, lab), then q, k,
// v (f32: k and v) by 16-byte copies, a pad token's row the qkv bias (zero
// before the qkv product); f32: this warp's q rows into qv (chunk c of KC
// channels, PER contiguous channels from c KC + PER t), in flight with the
// copies. Returns with the rows in place for the whole block.
template <typename T, int HD, int LD, int NQ, int PQ>
__device__ __forceinline__ void stage_window(
    const T* __restrict__ qkv, const float* __restrict__ qkv_bias, T* qs,
    T* ks, T* vs, int* tok, int* lab, float (&qv)[NQ][2][PQ], int wi,
    int nww, int n, int b, int h, int H, int W, int C, int win, int shift,
    int hp, int wp) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int KC = HD < 32 ? HD : 32, PER = KC / 4;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
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
  // ---- rows of head h into shared memory: 16 bytes per copy -------------
  constexpr int EV = 16 / sizeof(T), CH = HD / EV;
  constexpr int P0 = F32 ? 1 : 0, NPART = 3 - P0;  // f32: k and v only
  for (int i = tid; i < n * NPART * CH; i += nthr) {
    const int r = i / (NPART * CH), part = P0 + (i / CH) % NPART;
    const int c = (i % CH) * EV;
    T* dst = (part == 0 ? qs : part == 1 ? ks : vs) + r * LD + c;
    const int tk = tok[r];
    if (tk >= 0) {
      cp_async16(dst, qkv + (size_t)tk * 3 * C + part * C + h * HD + c);
    } else {  // pad token: zero before the qkv product, so its row is
              // the bias
      const float* bsrc = qkv_bias + part * C + h * HD + c;
      if constexpr (F32) {
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(bsrc);
      } else {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(pack_bf16(bsrc[0], bsrc[1]),
                       pack_bf16(bsrc[2], bsrc[3]),
                       pack_bf16(bsrc[4], bsrc[5]),
                       pack_bf16(bsrc[6], bsrc[7]));
      }
    }
  }
  // f32: this warp's q rows into registers, in flight with the copies
  if constexpr (F32) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * warp + g + 8 * hh;
      const int tk = r < n ? tok[r] : -1;
      const float* src = tk >= 0 ? (const float*)qkv + (size_t)tk * 3 * C
                                 : qkv_bias;
#pragma unroll
      for (int c = 0; c < NQ; ++c)
#pragma unroll
        for (int p4 = 0; p4 < PER / 4; ++p4) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < n)
            v = __ldg(reinterpret_cast<const float4*>(
                src + h * HD + c * KC + PER * t + 4 * p4));
          qv[c][hh][4 * p4] = v.x;
          qv[c][hh][4 * p4 + 1] = v.y;
          qv[c][hh][4 * p4 + 2] = v.z;
          qv[c][hh][4 * p4 + 3] = v.w;
        }
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// MAXNPT: the register arrays' size in 16-key steps (7 for win 10); two
// blocks share an SM. qkv (B*H*W, 3C) of T with channel order [q | k | v]
// x heads x hd; qkv_bias (3C) f32; rel (heads, n, n) f32; out (B*H*W, C).
template <typename T, int HD, int MAXNPT, bool MSA>
__global__ void __launch_bounds__(32 * MAXNPT, 2) window_attn_kernel(
    const T* __restrict__ qkv, const float* __restrict__ qkv_bias,
    const float* __restrict__ rel, T* __restrict__ out, int H, int W, int C,
    int win, int shift, float scale) {
  constexpr bool F32 = sizeof(T) == 4;
  using RelT = typename std::conditional<F32 || MSA, float, bf16>::type;
  constexpr int LD = F32 ? HD + 4 : HD + 8;  // conflict-free row strides
  extern __shared__ __align__(16) unsigned char smraw[];
  const int n = win * win, npt = (n + 15) / 16, NP = 16 * npt;
  const int ldb = NP + 8;
  T* qs = reinterpret_cast<T*>(smraw);  // bf16 only: f32 q is in registers
  T* ks = qs + (F32 ? 0 : NP * LD);
  T* vs = ks + NP * LD;
  RelT* bs = reinterpret_cast<RelT*>(vs + NP * LD);
  int* tok = reinterpret_cast<int*>(bs + (F32 || MSA ? n : NP) * ldb);
  int* lab = tok + NP;

  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  const int nww = wp / win, nw = (hp / win) * nww;
  const int b = blockIdx.z, h = blockIdx.y, w0 = blockIdx.x * ATT_WPB;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  for (int e = tid; e < n * n; e += nthr) {
    const float v = rel[(size_t)h * n * n + e];
    if constexpr (F32 || MSA)
      bs[(e / n) * ldb + e % n] = v;
    else
      bs[(e / n) * ldb + e % n] = __float2bfloat16_rn(v);
  }
  for (int i = tid; i < (NP - n) * LD; i += nthr) {
    if constexpr (!F32) qs[n * LD + i] = from_f<T>(0.f);
    ks[n * LD + i] = from_f<T>(0.f);
    vs[n * LD + i] = from_f<T>(0.f);
  }

  // f32: the lane's q values of rows g, g + 8 (+ 16 warp): chunk c of KC
  // channels, PER contiguous channels from c KC + PER t; k-step st of the
  // chunk takes channel PER t + st as slot t and PER t + KS + st as t + 4
  constexpr int KC = HD < 32 ? HD : 32, PER = KC / 4, KS = KC / 8;
  constexpr int NCH = HD / KC;
  const int wend = min(w0 + ATT_WPB, nw);
  for (int wi = w0; wi < wend; ++wi) {
    float qv[F32 ? NCH : 1][2][F32 ? PER : 1];
    stage_window<T, HD, LD>(qkv, qkv_bias, qs, ks, vs, tok, lab, qv, wi,
                            nww, n, b, h, H, W, C, win, shift, hp, wp);
    if (warp >= npt) continue;

    // ---- S = q k^T, 16 rows x NP keys in registers ----------------------
    float s[2 * MAXNPT][4];
#pragma unroll
    for (int j = 0; j < 2 * MAXNPT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (F32) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        Tf32x2<4> qa[KS];
#pragma unroll
        for (int st = 0; st < KS; ++st) {
          float q4[4] = {qv[c][0][st], qv[c][1][st], qv[c][0][KS + st],
                         qv[c][1][KS + st]};
          uint32_t a[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a[e] = __float_as_uint(MSA ? q4[e] : q4[e] * scale);
          qa[st] = split_frag(a);
        }
#pragma unroll
        for (int j = 0; j < 2 * MAXNPT; ++j) {
          if (j < 2 * npt) {
            const float* kr = ks + (8 * j + g) * LD + c * KC + PER * t;
            float kv[PER];
#pragma unroll
            for (int p4 = 0; p4 < PER / 4; ++p4) {
              const float4 v = *reinterpret_cast<const float4*>(kr + 4 * p4);
              kv[4 * p4] = v.x;
              kv[4 * p4 + 1] = v.y;
              kv[4 * p4 + 2] = v.z;
              kv[4 * p4 + 3] = v.w;
            }
#pragma unroll
            for (int st = 0; st < KS; ++st) {
              const uint32_t bw[2] = {__float_as_uint(kv[st]),
                                      __float_as_uint(kv[KS + st])};
              mma_3xtf32(s[j], qa[st], split_frag(bw));
            }
          }
        }
      }
    } else {
      uint32_t qa[HD / 16][4];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        ldsm_x4(qa[kk], qs + (16 * warp + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
        if constexpr (!MSA) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = unpack_bf16(qa[kk][e]);
            qa[kk][e] = pack_bf16(f.x * scale, f.y * scale);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2 * MAXNPT; ++j) {
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
          float bias = r < n ? to_f(bs[r * ldb + c]) : 0.f;
          if (shift && (e < 2 ? l0 : l1) != lab[c])
            bias = __fadd_rn(bias, -100.f);
          v = __fadd_rn(MSA ? __fmul_rn(s[j][e], scale) : s[j][e], bias);
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

    // ---- O = P v: P in registers is the A operand ------------------------
    float acc[HD / 8][4];
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jd][e] = 0.f;
    if constexpr (F32) {
#pragma unroll
      for (int j = 0; j < 2 * MAXNPT; ++j) {
        if (j < 2 * npt) {
          // keys 8j + 2t, 8j + 2t + 1 as the logical slots t, t + 4
          const uint32_t a[4] = {__float_as_uint(s[j][0] * l0s),
                                 __float_as_uint(s[j][2] * l1s),
                                 __float_as_uint(s[j][1] * l0s),
                                 __float_as_uint(s[j][3] * l1s)};
          const Tf32x2<4> pa = split_frag(a);
          const T* v0 = vs + (8 * j + 2 * t) * LD + g;
#pragma unroll
          for (int jd = 0; jd < HD / 8; ++jd) {
            const uint32_t bw[2] = {__float_as_uint(v0[8 * jd]),
                                    __float_as_uint(v0[LD + 8 * jd])};
            mma_3xtf32(acc[jd], pa, split_frag(bw));
          }
        }
      }
    } else {
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
    }
    const int tk0 = r0 < n ? tok[r0] : -1, tk1 = r1 < n ? tok[r1] : -1;
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd) {
      const int col = h * HD + 8 * jd + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int tk = hh ? tk1 : tk0;
        if (tk < 0) continue;
        T* dst = out + (size_t)tk * C + col;
        if constexpr (F32)
          *reinterpret_cast<float2*>(dst) =
              make_float2(acc[jd][2 * hh], acc[jd][2 * hh + 1]);
        else
          *reinterpret_cast<uint32_t*>(dst) =
              pack_bf16(acc[jd][2 * hh], acc[jd][2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Windows of 129 to 256 tokens (window 12: Swin-B/L at 384 px; window 16:
// Swin V2): window_attn_long_kernel. A warp's whole score row no longer fits
// its registers (256 keys: 128 f32 a thread for S alone), so each warp walks
// the keys in chunks of ATT_KCH 16-key steps (64 keys) with a running row
// max and sum (FlashAttention-2): per chunk S = q k^T, bias and mask, the
// chunk's max m', the accumulator and the sum rescaled by exp(m - m'), P =
// exp(s - m') (unnormalized; bf16: rounded to bf16 as the A operand) and O
// += P v; at the end O / sum. Up to 16 warps of 16 query rows (512 threads,
// one block an SM). The relative bias of a head, (2w - 1)^2 distinct values
// but expanded to n x n (256 KB in f32 at n = 256), no longer fits shared
// memory beside the rows, so each lane reads its scores' bias from device
// memory (L2-resident: a head's table is read by every window); the shift
// labels and token rows stay in shared memory. Windows of at most 128
// tokens keep window_attn_kernel above (one pass over whole score rows), so
// their outputs are unchanged. Both stage a window with stage_window.
constexpr int ATT_LONG_MAX_NPT = 16;  // n <= 256: 16 warps of 16 rows
constexpr int ATT_KCH = 4;            // 16-key steps of a key chunk

// shared memory of one block of window_attn_long_kernel: q, k, v rows
// (bf16, stride hd + 8) or k, v rows (f32, stride hd + 4); the token and
// label rows
static inline size_t window_attn_long_smem(int n, int hd, bool f32) {
  const size_t np = (n + 15) / 16 * 16;
  const size_t rows = f32 ? 2 * np * (hd + 4) * 4 : 3 * np * (hd + 8) * 2;
  return rows + 2 * np * 4;
}

template <typename T, int HD, bool MSA>
__global__ void __launch_bounds__(32 * ATT_LONG_MAX_NPT, 1)
    window_attn_long_kernel(const T* __restrict__ qkv,
                            const float* __restrict__ qkv_bias,
                            const float* __restrict__ rel,
                            T* __restrict__ out, int H, int W, int C,
                            int win, int shift, float scale) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int LD = F32 ? HD + 4 : HD + 8;
  extern __shared__ __align__(16) unsigned char smraw[];
  const int n = win * win, npt = (n + 15) / 16, NP = 16 * npt;
  T* qs = reinterpret_cast<T*>(smraw);  // bf16 only: f32 q is in registers
  T* ks = qs + (F32 ? 0 : NP * LD);
  T* vs = ks + NP * LD;
  int* tok = reinterpret_cast<int*>(vs + NP * LD);
  int* lab = tok + NP;

  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  const int nww = wp / win, nw = (hp / win) * nww;
  const int b = blockIdx.z, h = blockIdx.y, w0 = blockIdx.x * ATT_WPB;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float* relh = rel + (size_t)h * n * n;

  for (int i = tid; i < (NP - n) * LD; i += nthr) {
    if constexpr (!F32) qs[n * LD + i] = from_f<T>(0.f);
    ks[n * LD + i] = from_f<T>(0.f);
    vs[n * LD + i] = from_f<T>(0.f);
  }
  constexpr int KC = HD < 32 ? HD : 32, PER = KC / 4, KS = KC / 8;
  constexpr int NCH = HD / KC;
  const int wend = min(w0 + ATT_WPB, nw);
  for (int wi = w0; wi < wend; ++wi) {
    float qv[F32 ? NCH : 1][2][F32 ? PER : 1];
    stage_window<T, HD, LD>(qkv, qkv_bias, qs, ks, vs, tok, lab, qv, wi,
                            nww, n, b, h, H, W, C, win, shift, hp, wp);

    uint32_t qa[F32 ? 1 : HD / 16][4];
    if constexpr (!F32) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        ldsm_x4(qa[kk], qs + (16 * warp + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
        if constexpr (!MSA) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = unpack_bf16(qa[kk][e]);
            qa[kk][e] = pack_bf16(f.x * scale, f.y * scale);
          }
        }
      }
    }
    const int r0 = 16 * warp + g, r1 = r0 + 8;
    const int l0 = r0 < n ? lab[r0] : 0, l1 = r1 < n ? lab[r1] : 0;
    float m0 = -INFINITY, m1 = -INFINITY;  // running row max (quad-uniform)
    float l0s = 0.f, l1s = 0.f;            // this lane's running row sums
    float acc[HD / 8][4];
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jd][e] = 0.f;

    for (int j0 = 0; j0 < 2 * npt; j0 += 2 * ATT_KCH) {
      // ---- S = q k^T over the chunk's 8-key tiles j0 + j -----------------
      float s[2 * ATT_KCH][4];
#pragma unroll
      for (int j = 0; j < 2 * ATT_KCH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if constexpr (F32) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          Tf32x2<4> qf[KS];
#pragma unroll
          for (int st = 0; st < KS; ++st) {
            float q4[4] = {qv[c][0][st], qv[c][1][st], qv[c][0][KS + st],
                           qv[c][1][KS + st]};
            uint32_t a[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              a[e] = __float_as_uint(MSA ? q4[e] : q4[e] * scale);
            qf[st] = split_frag(a);
          }
#pragma unroll
          for (int j = 0; j < 2 * ATT_KCH; ++j) {
            if (j0 + j < 2 * npt) {
              const float* kr =
                  ks + (8 * (j0 + j) + g) * LD + c * KC + PER * t;
              float kv[PER];
#pragma unroll
              for (int p4 = 0; p4 < PER / 4; ++p4) {
                const float4 v =
                    *reinterpret_cast<const float4*>(kr + 4 * p4);
                kv[4 * p4] = v.x;
                kv[4 * p4 + 1] = v.y;
                kv[4 * p4 + 2] = v.z;
                kv[4 * p4 + 3] = v.w;
              }
#pragma unroll
              for (int st = 0; st < KS; ++st) {
                const uint32_t bw[2] = {__float_as_uint(kv[st]),
                                        __float_as_uint(kv[KS + st])};
                mma_3xtf32(s[j], qf[st], split_frag(bw));
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2 * ATT_KCH; ++j) {
          if (j0 + j < 2 * npt) {
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
              uint32_t b0, b1;
              ldsm_x2(b0, b1, ks + (8 * (j0 + j) + (lane & 7)) * LD +
                                  kk * 16 + ((lane >> 3) & 1) * 8);
              mma_16816(s[j], qa[kk], b0, b1);
            }
          }
        }
      }

      // ---- bias (from device memory), shift mask, the chunk's max --------
      float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2 * ATT_KCH; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? r0 : r1, c = 8 * (j0 + j) + 2 * t + (e & 1);
          float v = -INFINITY;
          if (c < n) {
            float bias = 0.f;
            if (r < n) {
              bias = __ldg(relh + (size_t)r * n + c);
              if constexpr (!F32 && !MSA)  // the bf16 table's values
                bias = to_f(__float2bfloat16_rn(bias));
            }
            if (shift && (e < 2 ? l0 : l1) != lab[c])
              bias = __fadd_rn(bias, -100.f);
            v = __fadd_rn(MSA ? __fmul_rn(s[j][e], scale) : s[j][e], bias);
          }
          s[j][e] = v;
          if (e < 2)
            c0 = fmaxf(c0, v);
          else
            c1 = fmaxf(c1, v);
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        c0 = fmaxf(c0, __shfl_xor_sync(0xffffffffu, c0, o));
        c1 = fmaxf(c1, __shfl_xor_sync(0xffffffffu, c1, o));
      }
      // every chunk holds a real key (its first key is below n), so the new
      // max is finite; the old one's weight is 0 on the first chunk
      const float n0 = fmaxf(m0, c0), n1 = fmaxf(m1, c1);
      const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);
      m0 = n0;
      m1 = n1;
      l0s *= a0;
      l1s *= a1;
#pragma unroll
      for (int jd = 0; jd < HD / 8; ++jd) {
        acc[jd][0] *= a0;
        acc[jd][1] *= a0;
        acc[jd][2] *= a1;
        acc[jd][3] *= a1;
      }
#pragma unroll
      for (int j = 0; j < 2 * ATT_KCH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = expf(s[j][e] - (e < 2 ? m0 : m1));
          s[j][e] = x;
          if (e < 2)
            l0s += x;
          else
            l1s += x;
        }

      // ---- O += P v over the chunk: P in registers is the A operand -------
      if constexpr (F32) {
#pragma unroll
        for (int j = 0; j < 2 * ATT_KCH; ++j) {
          if (j0 + j < 2 * npt) {
            const uint32_t a[4] = {
                __float_as_uint(s[j][0]), __float_as_uint(s[j][2]),
                __float_as_uint(s[j][1]), __float_as_uint(s[j][3])};
            const Tf32x2<4> pa = split_frag(a);
            const T* v0 = vs + (8 * (j0 + j) + 2 * t) * LD + g;
#pragma unroll
            for (int jd = 0; jd < HD / 8; ++jd) {
              const uint32_t bw[2] = {__float_as_uint(v0[8 * jd]),
                                      __float_as_uint(v0[LD + 8 * jd])};
              mma_3xtf32(acc[jd], pa, split_frag(bw));
            }
          }
        }
      } else {
#pragma unroll
        for (int s2 = 0; s2 < ATT_KCH; ++s2) {
          const int k16 = j0 / 2 + s2;  // the chunk's 16-key step
          if (k16 >= npt) break;
          const uint32_t pa[4] = {pack_bf16(s[2 * s2][0], s[2 * s2][1]),
                                  pack_bf16(s[2 * s2][2], s[2 * s2][3]),
                                  pack_bf16(s[2 * s2 + 1][0],
                                            s[2 * s2 + 1][1]),
                                  pack_bf16(s[2 * s2 + 1][2],
                                            s[2 * s2 + 1][3])};
#pragma unroll
          for (int jd = 0; jd < HD / 8; ++jd) {
            uint32_t b0, b1;
            ldsm_x2_trans(b0, b1,
                          vs + (16 * k16 + (lane & 15)) * LD + 8 * jd);
            mma_16816(acc[jd], pa, b0, b1);
          }
        }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0s += __shfl_xor_sync(0xffffffffu, l0s, o);
      l1s += __shfl_xor_sync(0xffffffffu, l1s, o);
    }
    l0s = 1.f / l0s;
    l1s = 1.f / l1s;
    const int tk0 = r0 < n ? tok[r0] : -1, tk1 = r1 < n ? tok[r1] : -1;
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd) {
      const int col = h * HD + 8 * jd + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int tk = hh ? tk1 : tk0;
        if (tk < 0) continue;
        const float inv = hh ? l1s : l0s;
        const float o0 = acc[jd][2 * hh] * inv, o1 = acc[jd][2 * hh + 1] * inv;
        T* dst = out + (size_t)tk * C + col;
        if constexpr (F32)
          *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
        else
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o0, o1);
      }
    }
  }
}

template <typename T, bool MSA, int HD>
static int launch_window_attn_hd(const void* qkv, const float* qkv_bias,
                                 const float* rel, void* out, int B, int H,
                                 int W, int C, int heads, int win, int shift,
                                 float scale, cudaStream_t stream) {
  const int n = win * win, NP = (n + 15) / 16 * 16;
  const bool long_win = NP > 16 * ATT_MAX_NPT;
  const size_t smem = long_win ? window_attn_long_smem(n, HD, sizeof(T) == 4)
                               : window_attn_smem(n, HD, sizeof(T) == 4, MSA);
  auto kern = long_win    ? window_attn_long_kernel<T, HD, MSA>
              : NP == 112 ? window_attn_kernel<T, HD, 7, MSA>
                          : window_attn_kernel<T, HD, ATT_MAX_NPT, MSA>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  dim3 grid(ceil_div((hp / win) * (wp / win), ATT_WPB), heads, B);
  kern<<<grid, 32 * (NP / 16), smem, stream>>>(
      (const T*)qkv, qkv_bias, rel, (T*)out, H, W, C, win, shift, scale);
  return (int)cudaGetLastError();
}

// The launch of either variant: f32 nonzero for f32 qkv and out, else
// bf16; head widths 16, 32 or 64 and windows of at most 256 tokens (above
// 128 the long-window kernel)
template <bool MSA>
static int launch_window_attn(const void* qkv, const float* qkv_bias,
                              const float* rel, void* out, int B, int H,
                              int W, int C, int heads, int win, int shift,
                              float scale, int f32, cudaStream_t stream) {
  if (C % heads || win * win > 16 * ATT_LONG_MAX_NPT) return MB_BAD_ARGS;
#define MB_ATTN_HD(HD)                                                    \
  case HD:                                                                \
    return f32 ? launch_window_attn_hd<float, MSA, HD>(                   \
                     qkv, qkv_bias, rel, out, B, H, W, C, heads, win,     \
                     shift, scale, stream)                                \
               : launch_window_attn_hd<bf16, MSA, HD>(                    \
                     qkv, qkv_bias, rel, out, B, H, W, C, heads, win,     \
                     shift, scale, stream);
  switch (C / heads) {
    MB_ATTN_HD(16)
    MB_ATTN_HD(32)
    MB_ATTN_HD(64)
  }
#undef MB_ATTN_HD
  return MB_BAD_ARGS;
}
