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
// Design (FlashAttention-2 style, the scores never leave registers): one
// warp per 16 query rows of the window padded to NP = 16 ceil(n / 16) rows
// (7 warps at win 10). Windows, padding and the cyclic shift are index math
// on the (hp, wp) padded grid: token rows come from the unpadded (B*H*W,
// 3C) qkv, pad tokens (zero before the qkv product) take the qkv bias, rows
// past the window are zero, and the shift-region labels are computed, not
// read. Every kernel reads the head's bias as the compact (2 win - 1)^2
// table of relative offsets, gathered from rel into shared memory.
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
// Kernels, up to 128 tokens a window: the flagship widths 16, 32 and 64 in
// bf16 run window_attn_ring_kernel (a persistent grid walking (head,
// sample, window) items, a ring of two window buffers); every other width
// (8, 24, 40, 48, 56; 72-128), and the flagship widths in f32, run
// window_attn_width_kernel (a grid of (windows / 4, heads, B) blocks; the
// other widths built in their own sources, attn_widths_*.cu and
// attn_wide_*.cu, in parallel with these). From 129 to 256 tokens every
// width up to 64 runs window_attn_long_kernel, which stages a head's rows at
// HS = staged_dim(HD), the least flagship width that holds it, the columns
// HD .. HS - 1 zero (zero columns add nothing to the scores; the scale is
// the caller's, HD^-0.5); P v and the stores cover the HD real columns.
// Longer windows (to 576 tokens), and windows over 128 tokens at widths
// over 64, run window_attn_stream_kernel (attn_stream_*.cu).
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"

constexpr int ATT_MAX_NPT = 8;  // n <= 128: at most 8 warps of 16 rows
constexpr int ATT_WPB = 4;      // windows a block (the long-window kernel)

// the width a head of HD channels is staged at
__host__ __device__ constexpr int staged_dim(int hd) {
  return hd <= 16 ? 16 : hd <= 32 ? 32 : 64;
}

__device__ __forceinline__ int shift_region(int r, int size, int win,
                                            int shift) {
  return r < size - win ? 0 : (r < size - shift ? 1 : 2);
}

// The rows of window wi (nww windows a row) of head h in shared memory,
// for both kernels: the token and shift-label rows (tok, lab), then q, k,
// v (f32: k and v) by 16-byte copies, a pad token's row the qkv bias (zero
// before the qkv product); f32: this warp's q rows into qv (chunk c of KC
// channels, PER contiguous channels from c KC + PER t; zero past HD), in
// flight with the copies. Returns with the rows in place for the whole
// block. The HD real columns are copied; columns HD .. HS - 1 of the staged
// rows are zeroed once by the kernel (zero_staged_tail).
template <typename T, int HD, int HS, int LD, int NQ, int PQ>
__device__ __forceinline__ void stage_window(
    const T* __restrict__ qkv, const float* __restrict__ qkv_bias, T* qs,
    T* ks, T* vs, int* tok, int* lab, float (&qv)[NQ][2][PQ], int wi,
    int nww, int n, int b, int h, int H, int W, int C, int win, int shift,
    int hp, int wp) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int KC = HS < 32 ? HS : 32, PER = KC / 4;
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
          // (HS == HD: a constant true, the flagship instances' code)
          if (r < n && (HS == HD || c * KC + PER * t + 4 * p4 < HD))
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

// zero columns HD .. HS - 1 of the n staged rows of q (bf16 only), k and
// v: the copies never write them, so once a kernel
template <typename T, int HD, int HS, int LD>
__device__ __forceinline__ void zero_staged_tail(T* qs, T* ks, T* vs, int n) {
  if constexpr (HS != HD) {
    constexpr int TAIL = HS - HD;
    for (int i = threadIdx.x; i < n * TAIL; i += blockDim.x) {
      const int o = (i / TAIL) * LD + HD + i % TAIL;
      if constexpr (sizeof(T) != 4) qs[o] = from_f<T>(0.f);
      ks[o] = from_f<T>(0.f);
      vs[o] = from_f<T>(0.f);
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
// += P v; at the end O / sum. Up to 16 warps of 16 query rows. Windows of at
// most 128 tokens keep one pass over whole score rows (the width and ring
// kernels below), so their outputs are unchanged. It stages a window with
// stage_window.
//
// The Hopper redesign (the first version read every score's bias from the
// expanded (heads, n, n) table in L2 and ran one block of 128 registers a
// thread an SM: 9 warps an SM at window 12):
//   * the head's bias is staged in shared memory once a block as the
//     compact table of the (2 win - 1)^2 relative offsets (2.1 KB at window
//     12, 3.8 KB at 16, f32; the bf16 Swin variant's values rounded to bf16
//     once, as the model's table holds them). Entry (dy, dx) is gathered
//     from rel at a pair of tokens (dy, dx) apart; a score's bias is then
//     tab[ro(i) - co(j)], ro and co the offsets of the tokens' window
//     coordinates (ops/swin_block.py::rel_offsets mirrors the index math).
//     It is the f32 value the expanded table holds, so the outputs are
//     unchanged; rel must be a relative-position bias, as every caller
//     gathers it (ops/swin_block.py::rel_bias_from_table);
//   * window 12 (9 warps) is an instance of its own, built for two blocks
//     an SM in bf16 (long_blocks): one block's staging, barriers and
//     softmax overlap the other's products. f32 and windows 13-16 stay at
//     one block an SM (f32 keeps q in registers; 16 warps hold an SM's
//     registers at 128 a thread; splitting a window's query rows over two
//     blocks of 8 warps, k and v staged by both, gained nothing at window
//     16 on the H100).
// One pass over whole score rows at window 12 (18 tiles of 8 keys: 72 f32 a
// thread for S) would not fit two blocks' registers (113 a thread), so the
// 64-key chunks stay.
constexpr int ATT_LONG_MAX_NPT = 16;  // n <= 256: 16 warps of 16 rows
constexpr int ATT_W12_NPT = 9;        // window 12: 144 tokens, 9 warps
constexpr int ATT_KCH = 4;            // 16-key steps of a key chunk

// blocks an SM an instance is built for: two at window 12 in bf16
template <typename T, int NPT>
__host__ __device__ constexpr int long_blocks() {
  return sizeof(T) == 2 && NPT <= ATT_W12_NPT ? 2 : 1;
}

// floats of the compact relative-offset table, padded to 16 bytes
__host__ __device__ constexpr int rel_table_floats(int win) {
  return ((2 * win - 1) * (2 * win - 1) + 3) / 4 * 4;
}

// shared memory of one block of window_attn_long_kernel: q, k, v rows
// (bf16, stride hd + 8) or k, v rows (f32, stride hd + 4); the token,
// label and column-offset rows; the compact bias table
static inline size_t window_attn_long_smem(int win, int hd, bool f32) {
  const size_t np = (win * win + 15) / 16 * 16;
  const size_t rows = f32 ? 2 * np * (hd + 4) * 4 : 3 * np * (hd + 8) * 2;
  return rows + 3 * np * 4 + rel_table_floats(win) * 4;
}

template <typename T, int HD, bool MSA, int NPT>
__global__ void __launch_bounds__(32 * NPT, long_blocks<T, NPT>())
    window_attn_long_kernel(const T* __restrict__ qkv,
                            const float* __restrict__ qkv_bias,
                            const float* __restrict__ rel,
                            T* __restrict__ out, int H, int W, int C,
                            int win, int shift, float scale) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int HS = staged_dim(HD);
  constexpr int LD = F32 ? HS + 4 : HS + 8;
  extern __shared__ __align__(16) unsigned char smraw[];
  const int n = win * win, npt = (n + 15) / 16, NP = 16 * npt;
  T* qs = reinterpret_cast<T*>(smraw);  // bf16 only: f32 q is in registers
  T* ks = qs + (F32 ? 0 : NP * LD);
  T* vs = ks + NP * LD;
  int* tok = reinterpret_cast<int*>(vs + NP * LD);
  int* lab = tok + NP;
  int* co = lab + NP;  // column offsets (j / win) tw + j % win
  float* tab = reinterpret_cast<float*>(co + NP);

  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  const int nww = wp / win, nw = (hp / win) * nww;
  const int b = blockIdx.z, h = blockIdx.y, w0 = blockIdx.x * ATT_WPB;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int tw = 2 * win - 1;

  // the head's compact table (stage_window's first barrier publishes it):
  // offset (dy, dx) from the tokens (max(dy, 0), max(dx, 0)) and
  // (max(dy, 0) - dy, max(dx, 0) - dx) of the window
  const float* relh = rel + (size_t)h * n * n;
  for (int i = tid; i < tw * tw; i += nthr) {
    const int dy = i / tw - (win - 1), dx = i % tw - (win - 1);
    const int ry = max(dy, 0), rx = max(dx, 0);
    float v = __ldg(relh + (size_t)(ry * win + rx) * n + (ry - dy) * win +
                    (rx - dx));
    if constexpr (!F32 && !MSA) v = to_f(__float2bfloat16_rn(v));
    tab[i] = v;
  }
  for (int j = tid; j < NP; j += nthr)
    co[j] = j < n ? (j / win) * tw + j % win : 0;
  for (int i = tid; i < (NP - n) * LD; i += nthr) {
    if constexpr (!F32) qs[n * LD + i] = from_f<T>(0.f);
    ks[n * LD + i] = from_f<T>(0.f);
    vs[n * LD + i] = from_f<T>(0.f);
  }
  zero_staged_tail<T, HD, HS, LD>(qs, ks, vs, n);
  constexpr int KC = HS < 32 ? HS : 32, PER = KC / 4, KS = KC / 8;
  constexpr int NCH = HS / KC;
  const int wend = min(w0 + ATT_WPB, nw);
  for (int wi = w0; wi < wend; ++wi) {
    float qv[F32 ? NCH : 1][2][F32 ? PER : 1];
    stage_window<T, HD, HS, LD>(qkv, qkv_bias, qs, ks, vs, tok, lab, qv, wi,
                                nww, n, b, h, H, W, C, win, shift, hp, wp);

    uint32_t qa[F32 ? 1 : HS / 16][4];
    if constexpr (!F32) {
#pragma unroll
      for (int kk = 0; kk < HS / 16; ++kk) {
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
    // the rows' table offsets: ro(i) - co(j) indexes tab
    const int ro0 = (r0 / win) * tw + r0 % win + (win - 1) * (tw + 1);
    const int ro1 = (r1 / win) * tw + r1 % win + (win - 1) * (tw + 1);
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
            for (int kk = 0; kk < HS / 16; ++kk) {
              uint32_t b0, b1;
              ldsm_x2(b0, b1, ks + (8 * (j0 + j) + (lane & 7)) * LD +
                                  kk * 16 + ((lane >> 3) & 1) * 8);
              mma_16816(s[j], qa[kk], b0, b1);
            }
          }
        }
      }

      // ---- bias (the staged table), shift mask, the chunk's max ----------
      float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2 * ATT_KCH; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? r0 : r1, c = 8 * (j0 + j) + 2 * t + (e & 1);
          float v = -INFINITY;
          if (c < n) {
            float bias = r < n ? tab[(e < 2 ? ro0 : ro1) - co[c]] : 0.f;
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

// ---------------------------------------------------------------------------
// The head-width instances (HD 8, 24, 40, 48, 56; 72-128; and 16, 32, 64 in
// f32) at windows of at most 128 tokens: window_attn_width_kernel. It
// computes what the flagship widths' first kernel (window_attn_kernel, the
// head's (n, n) bias staged a block) computed, in each variant's order of
// arithmetic. The first version ran that kernel with the rows staged at
// the next flagship width, and lost 1.1-1.5x to SDPA at 3-25x its byte
// bound: every block staged its head's expanded (n, n) bias (40 KB of f32
// read from L2 at window 10, more than its 4 windows of bf16 qkv at HD 8),
// the products ran at the staged width (2x the work at HD 8, 1.6x at 40),
// and two blocks shared an SM whatever the width. The Hopper redesign:
//   * the head's compact (2 win - 1)^2 bias table in shared memory once a
//     block, a score's bias tab[ro(i) - co(j)], as window_attn_long_kernel
//     stages and reads it (the bf16 Swin variant's values rounded to bf16
//     once): the values the expanded table holds, so no output changes;
//   * the rows at the exact width, with no zero tail: bf16 rows at a stride
//     of an odd number of 16-byte words (width_ld: HD where HD / 8 is odd,
//     HD + 8 where it is even), so each ldmatrix reads 8 distinct bank
//     groups; q k^T as HD / 16 m16n8k16 steps plus one m16n8k8 step where
//     HD % 16 == 8 (only the zero terms of the staged product leave the
//     sums); f32 rows at HD + 4, q k^T as 3xTF32 m16n8k8 over HD / 8 steps,
//     the channels in chunks of 32, 16 and 8 (a lane holds KC / 4
//     contiguous channels of each chunk of KC);
//   * blocks an SM sized to the instance (width_blocks): the bf16 instances
//     pack P to bf16 before P v, so the scores' registers die before the
//     accumulators live, and run four blocks of 7 warps an SM at window 10
//     (72 registers a thread, 32-136 bytes spilled: on the H100 faster
//     than three blocks at 80 registers or two at 128) and three of 8
//     warps (faster than two or four); f32 keeps two (128 registers).
//     Latency sets the pace (blocks an SM moved the time most); copying
//     the next window's rows into a second buffer while the current one
//     computes, and one barrier a window fewer, gained nothing and were
//     taken out.
constexpr int ATT_WIDTH_WPB = 4;  // windows a block
// blocks an SM the instances are built for (their launch bounds): bf16 at
// 7 warps (windows of 97-112 tokens: window 10), bf16 at 8 warps (every
// other window up to 128 tokens), f32; the head widths over 64 (72-128,
// one instance of 8 warps for every window up to 11) in bf16 and
// f32, whose scores, q and accumulators hold 2-4x the registers;
// ops/swin_block.py mirrors these
#define ATT_WIDTH_BLOCKS_BF16_NPT7 4
#define ATT_WIDTH_BLOCKS_BF16_NPT8 3
#define ATT_WIDTH_BLOCKS_F32 2
#define ATT_WIDTH_BLOCKS_WIDE_BF16 2
#define ATT_WIDTH_BLOCKS_WIDE_F32 1

// row stride of the staged q, k, v rows (values)
__host__ __device__ constexpr int width_ld(int hd, bool f32) {
  return f32 ? hd + 4 : ((hd / 8) % 2 ? hd : hd + 8);
}

__host__ __device__ constexpr int width_blocks(bool f32, int maxnpt,
                                               int hd) {
  return hd > 64 ? (f32 ? ATT_WIDTH_BLOCKS_WIDE_F32
                        : ATT_WIDTH_BLOCKS_WIDE_BF16)
         : f32   ? ATT_WIDTH_BLOCKS_F32
         : maxnpt <= 7 ? ATT_WIDTH_BLOCKS_BF16_NPT7
                       : ATT_WIDTH_BLOCKS_BF16_NPT8;
}

// shared memory of one block: the q, k, v rows (bf16) or k, v rows (f32);
// the token, label and column-offset rows; the compact bias table
static inline size_t window_attn_width_smem(int win, int hd, bool f32) {
  const size_t np = (win * win + 15) / 16 * 16, ld = width_ld(hd, f32);
  const size_t rows = f32 ? 2 * np * ld * 4 : 3 * np * ld * 2;
  return rows + 3 * np * 4 + rel_table_floats(win) * 4;
}

// the token and shift-label rows of window wi (nww windows a row)
__device__ __forceinline__ void window_tokens(int* tok, int* lab, int wi,
                                              int nww, int n, int b, int H,
                                              int W, int win, int shift,
                                              int hp, int wp) {
  const int wy = wi / nww, wx = wi % nww;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const int gy = wy * win + r / win, gx = wx * win + r % win;  // rolled
    const int ro = (gy + shift) % hp, co = (gx + shift) % wp;    // padded
    tok[r] = (ro < H && co < W) ? (b * H + ro) * W + co : -1;
    lab[r] = shift ? shift_region(gy, hp, win, shift) * 3 +
                         shift_region(gx, wp, win, shift)
                   : 0;
  }
}

// the n rows of head h (bf16: q, k, v; f32: k, v) of the tokens tok into
// shared memory by 16-byte cp.async (a pad token's row the qkv bias, zero
// before the qkv product, stored directly); the caller waits. (The same
// steps as stage_window's, kept apart so that the flagship instances
// compile as they did: routing stage_window through these changed the
// registers and spills of 54 of its instances.)
template <typename T, int HD, int LD>
__device__ __forceinline__ void window_rows(const T* __restrict__ qkv,
                                            const float* __restrict__ qkv_bias,
                                            T* qs, T* ks, T* vs,
                                            const int* tok, int n, int h,
                                            int C) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int EV = 16 / sizeof(T), CH = HD / EV;
  constexpr int P0 = F32 ? 1 : 0, NPART = 3 - P0;
  for (int i = threadIdx.x; i < n * NPART * CH; i += blockDim.x) {
    const int r = i / (NPART * CH), part = P0 + (i / CH) % NPART;
    const int c = (i % CH) * EV;
    T* dst = (part == 0 ? qs : part == 1 ? ks : vs) + r * LD + c;
    const int tk = tok[r];
    if (tk >= 0) {
      cp_async16(dst, qkv + (size_t)tk * 3 * C + part * C + h * HD + c);
    } else {
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
}

// PER consecutive f32 values from p (8, 4 or 2: 16- or 8-byte loads)
template <int PER, bool GLOBAL>
__device__ __forceinline__ void ld_per(float* v, const float* p) {
  if constexpr (PER == 2) {
    const float2 a = GLOBAL ? __ldg(reinterpret_cast<const float2*>(p))
                            : *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int p4 = 0; p4 < PER / 4; ++p4) {
      const float4 a =
          GLOBAL ? __ldg(reinterpret_cast<const float4*>(p + 4 * p4))
                 : *reinterpret_cast<const float4*>(p + 4 * p4);
      v[4 * p4] = a.x;
      v[4 * p4 + 1] = a.y;
      v[4 * p4 + 2] = a.z;
      v[4 * p4 + 3] = a.w;
    }
  }
}

// f32 q k^T over one chunk of KC channels at offset off (8, 16 or 32): the
// lane's q values (rows g, g + 8) are qa0, qa1 (KC / 4 contiguous channels
// from off + (KC / 4) t); k-step st takes channel PER t + st as slot t and
// PER t + KS + st as slot t + 4, in q and k alike
template <int KC, int LD, int MAXNPT, bool MSA>
__device__ __forceinline__ void qk_chunk_f32(float (&s)[2 * MAXNPT][4],
                                             const float* qa0,
                                             const float* qa1,
                                             const float* ks, int off,
                                             int npt, float scale, int g,
                                             int t) {
  constexpr int PER = KC / 4, KS = KC / 8;
  Tf32x2<4> qf[KS];
#pragma unroll
  for (int st = 0; st < KS; ++st) {
    const float q4[4] = {qa0[st], qa1[st], qa0[KS + st], qa1[KS + st]};
    uint32_t a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[e] = __float_as_uint(MSA ? q4[e] : q4[e] * scale);
    qf[st] = split_frag(a);
  }
#pragma unroll
  for (int j = 0; j < 2 * MAXNPT; ++j) {
    if (j < 2 * npt) {
      float kv[PER];
      ld_per<PER, false>(kv, ks + (8 * j + g) * LD + off + PER * t);
#pragma unroll
      for (int st = 0; st < KS; ++st) {
        const uint32_t bw[2] = {__float_as_uint(kv[st]),
                                __float_as_uint(kv[KS + st])};
        mma_3xtf32(s[j], qf[st], split_frag(bw));
      }
    }
  }
}

// f32: this warp's q rows (16 warp + g, + 8) of the tokens tok into
// registers, chunk by chunk as qk_chunk_f32 reads them (zero past n)
template <int HD>
__device__ __forceinline__ void load_q_f32(float (&qv)[2][HD / 4],
                                           const float* __restrict__ qkv,
                                           const float* __restrict__ qkv_bias,
                                           const int* tok, int n, int h,
                                           int C) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    const int tk = r < n ? tok[r] : -1;
    const float* src =
        (tk >= 0 ? qkv + (size_t)tk * 3 * C : qkv_bias) + h * HD;
    if (r < n) {
#pragma unroll
      for (int c = 0; c < HD / 32; ++c)
        ld_per<8, true>(&qv[hh][8 * c], src + 32 * c + 8 * t);
      if constexpr (HD % 32 >= 16)
        ld_per<4, true>(&qv[hh][HD / 32 * 8], src + HD / 32 * 32 + 4 * t);
      if constexpr (HD % 16 == 8)
        ld_per<2, true>(&qv[hh][HD / 4 - 2], src + HD - 8 + 2 * t);
    } else {
#pragma unroll
      for (int i = 0; i < HD / 4; ++i) qv[hh][i] = 0.f;
    }
  }
}

// MAXNPT: the register arrays' size in 16-key steps (7 for win 10); qkv
// (B*H*W, 3C) of T with channel order [q | k | v] x heads x HD; qkv_bias
// (3C) f32; rel (heads, n, n) f32, a relative-position bias; out (B*H*W,
// C). Grid (ceil(nW / ATT_WIDTH_WPB), heads, B).
template <typename T, int HD, int MAXNPT, bool MSA>
__global__ void __launch_bounds__(32 * MAXNPT,
                                  width_blocks(sizeof(T) == 4, MAXNPT, HD))
    window_attn_width_kernel(const T* __restrict__ qkv,
                             const float* __restrict__ qkv_bias,
                             const float* __restrict__ rel,
                             T* __restrict__ out, int H, int W, int C,
                             int win, int shift, float scale) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int LD = width_ld(HD, F32);
  extern __shared__ __align__(16) unsigned char smraw[];
  const int n = win * win, npt = (n + 15) / 16, NP = 16 * npt;
  T* qs = reinterpret_cast<T*>(smraw);  // bf16 only: f32 q is in registers
  T* ks = qs + (F32 ? 0 : NP * LD);
  T* vs = ks + NP * LD;
  int* tok = reinterpret_cast<int*>(vs + NP * LD);
  int* lab = tok + NP;
  int* co = lab + NP;  // column offsets (j / win) tw + j % win
  float* tab = reinterpret_cast<float*>(co + NP);

  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  const int nww = wp / win, nw = (hp / win) * nww;
  const int b = blockIdx.z, h = blockIdx.y, w0 = blockIdx.x * ATT_WIDTH_WPB;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int tw = 2 * win - 1;

  // the head's compact table, as window_attn_long_kernel gathers it
  const float* relh = rel + (size_t)h * n * n;
  for (int i = tid; i < tw * tw; i += nthr) {
    const int dy = i / tw - (win - 1), dx = i % tw - (win - 1);
    const int ry = max(dy, 0), rx = max(dx, 0);
    float v = __ldg(relh + (size_t)(ry * win + rx) * n + (ry - dy) * win +
                    (rx - dx));
    if constexpr (!F32 && !MSA) v = to_f(__float2bfloat16_rn(v));
    tab[i] = v;
  }
  for (int j = tid; j < NP; j += nthr)
    co[j] = j < n ? (j / win) * tw + j % win : 0;
  // rows n .. NP - 1 are zero (v's must be finite: their probabilities
  // are 0)
  for (int i = tid; i < (NP - n) * LD; i += nthr) {
    if constexpr (!F32) qs[n * LD + i] = from_f<T>(0.f);
    ks[n * LD + i] = from_f<T>(0.f);
    vs[n * LD + i] = from_f<T>(0.f);
  }

  const int wend = min(w0 + ATT_WIDTH_WPB, nw);
  for (int wi = w0; wi < wend; ++wi) {
    __syncthreads();  // the previous window's rows are read
    window_tokens(tok, lab, wi, nww, n, b, H, W, win, shift, hp, wp);
    __syncthreads();
    window_rows<T, HD, LD>(qkv, qkv_bias, qs, ks, vs, tok, n, h, C);
    float qv[2][F32 ? HD / 4 : 1];  // f32: in flight with the copies
    if constexpr (F32)
      load_q_f32<HD>(qv, (const float*)qkv, qkv_bias, tok, n, h, C);
    cp_async_wait_all();
    __syncthreads();

    // ---- S = q k^T at the exact width, 16 rows x NP keys in registers ----
    float s[2 * MAXNPT][4];
#pragma unroll
    for (int j = 0; j < 2 * MAXNPT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (F32) {
#pragma unroll
      for (int c = 0; c < HD / 32; ++c)
        qk_chunk_f32<32, LD, MAXNPT, MSA>(s, &qv[0][8 * c], &qv[1][8 * c],
                                          ks, 32 * c, npt, scale, g, t);
      if constexpr (HD % 32 >= 16)
        qk_chunk_f32<16, LD, MAXNPT, MSA>(s, &qv[0][HD / 32 * 8],
                                          &qv[1][HD / 32 * 8], ks,
                                          HD / 32 * 32, npt, scale, g, t);
      if constexpr (HD % 16 == 8)
        qk_chunk_f32<8, LD, MAXNPT, MSA>(s, &qv[0][HD / 4 - 2],
                                         &qv[1][HD / 4 - 2], ks, HD - 8, npt,
                                         scale, g, t);
    } else {
      constexpr int K16 = HD / 16;
      uint32_t qa[K16 ? K16 : 1][4], q8[2];
      const T* qrow = qs + (16 * warp + (lane & 15)) * LD;
#pragma unroll
      for (int kk = 0; kk < K16; ++kk)
        ldsm_x4(qa[kk], qrow + kk * 16 + (lane >> 4) * 8);
      if constexpr (HD % 16 == 8) ldsm_x2(q8[0], q8[1], qrow + HD - 8);
      if constexpr (!MSA) {
#pragma unroll
        for (int kk = 0; kk < K16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = unpack_bf16(qa[kk][e]);
            qa[kk][e] = pack_bf16(f.x * scale, f.y * scale);
          }
        if constexpr (HD % 16 == 8) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float2 f = unpack_bf16(q8[e]);
            q8[e] = pack_bf16(f.x * scale, f.y * scale);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2 * MAXNPT; ++j) {
        if (j < 2 * npt) {
#pragma unroll
          for (int kk = 0; kk < K16; ++kk) {
            uint32_t b0, b1;
            ldsm_x2(b0, b1, ks + (8 * j + (lane & 7)) * LD + kk * 16 +
                                ((lane >> 3) & 1) * 8);
            mma_16816(s[j], qa[kk], b0, b1);
          }
          if constexpr (HD % 16 == 8) {
            uint32_t b0;
            ldsm_x1(b0, ks + (8 * j + (lane & 7)) * LD + HD - 8);
            mma_1688_bf16(s[j], q8, b0);
          }
        }
      }
    }

    // ---- bias (the staged table), shift mask, exact softmax -------------
    const int r0 = 16 * warp + g, r1 = r0 + 8;
    const int l0 = r0 < n ? lab[r0] : 0, l1 = r1 < n ? lab[r1] : 0;
    const int ro0 = (r0 / win) * tw + r0 % win + (win - 1) * (tw + 1);
    const int ro1 = (r1 / win) * tw + r1 % win + (win - 1) * (tw + 1);
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * MAXNPT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r0 : r1, c = 8 * j + 2 * t + (e & 1);
        float v = -INFINITY;
        if (c < n) {
          float bias = r < n ? tab[(e < 2 ? ro0 : ro1) - co[c]] : 0.f;
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
    if constexpr (F32) {
#pragma unroll
      for (int jd = 0; jd < HD / 8; ++jd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jd][e] = 0.f;
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
      // P packed to bf16 first: the f32 scores die before acc lives
      uint32_t pa[MAXNPT][4];
#pragma unroll
      for (int s2 = 0; s2 < MAXNPT; ++s2) {
        pa[s2][0] = pack_bf16(s[2 * s2][0] * l0s, s[2 * s2][1] * l0s);
        pa[s2][1] = pack_bf16(s[2 * s2][2] * l1s, s[2 * s2][3] * l1s);
        pa[s2][2] = pack_bf16(s[2 * s2 + 1][0] * l0s, s[2 * s2 + 1][1] * l0s);
        pa[s2][3] = pack_bf16(s[2 * s2 + 1][2] * l1s, s[2 * s2 + 1][3] * l1s);
      }
#pragma unroll
      for (int jd = 0; jd < HD / 8; ++jd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jd][e] = 0.f;
#pragma unroll
      for (int s2 = 0; s2 < MAXNPT; ++s2) {
        if (s2 >= npt) continue;
#pragma unroll
        for (int jd = 0; jd < HD / 8; ++jd) {
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, vs + (16 * s2 + (lane & 15)) * LD + 8 * jd);
          mma_16816(acc[jd], pa[s2], b0, b1);
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
// The flagship head widths (16, 32, 64) in bf16 at windows of at most 128
// tokens, both variants: window_attn_ring_kernel, the main path's attention
// (kernel 3's at head width 64, window 10, 12 launches a forward) and kernel
// 7's (path K; the refinement at 32). It computes what the first version,
// window_attn_kernel, computed, in the same order of every sum (the key
// steps of S, the row max and sum, P rounded to bf16 before P v), so its
// outputs are that kernel's bit for bit. The first version lost 1.9x to
// SDPA's device time at ~5.3x its byte bound (1.49 device ms a forward
// against 0.28): a grid of (windows / 4, heads, B) blocks, two of 128
// registers a thread an SM, each staging its head's expanded (n, n) bias
// from L2 and then, a window at a time, copying the window's rows and
// waiting for all of them before any warp computed; the last wave partly
// empty (stage 2: 1.45 waves; stage 3: 192 blocks for 264 slots, each
// walking its 4 windows in turn). Ablations of the redesign on the H100
// (scripts/flagship_attn_profile.py, PERF.md) showed the work bound by
// instructions and their latency, not by bytes: taking out the row copies
// saved 5 % of the main path's attention, the first redesign's per-score
// gather from the compact table 21 %, the exp 8 %, the S products 14 %,
// the P v products 4 %. The Hopper redesign:
//   * a persistent grid of whole waves: as many blocks as fit the SMs at
//     once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), each walking a
//     contiguous range of the (head, sample, window) items, head-major, so
//     no wave runs partly empty and a block's head changes once or twice;
//   * the head's bias gathered as the compact (2 win - 1)^2 table of
//     relative offsets (one rel entry an offset, as the width, long and
//     stream kernels read it; the Swin variant rounded to bf16, as the
//     model's table holds it) and expanded in shared memory to the n rows
//     of NP keys a score reads with one load a pair of keys, when the block's
//     head changes: the keys past the window hold -inf, so no score tests
//     its column; rows past the window read the last row (never stored);
//   * the shift mask's label compare only in the windows whose tokens
//     carry different labels (the last row and column of windows of a
//     shifted block): a branch uniform over the block picks the loop;
//   * ldmatrix.x4 for k (two k-steps) and v (two column tiles): half the
//     shared-memory load instructions of the x2 form;
//   * one window buffer (q, k, v rows at stride width_ld, an odd number of
//     16-byte words: conflict-free ldmatrix) whose parts are refilled in
//     turn by cp.async commit groups: item k + 1's q and k while the warps
//     run item k's P v, item k's v while they run its S and softmax; the
//     block waits with cp.async.wait_group 0 at its two barriers an item.
//     A ring of two whole buffers (measured first) halved the blocks an SM
//     and was slower; pad tokens take the qkv bias by plain stores, the
//     cyclic shift and the padding are index math (TMA would need a window
//     unwrapped inside the grid);
//   * mma.sync m16n8k16 with the scores and P in registers (FlashAttention-2
//     style): at ~25 operations a byte the products are not the limit, and
//     wgmma's 64-row tiles (128 rows for 100 tokens) would buy nothing; P is
//     packed to bf16 before the accumulators live (fewer registers).
// The token rows of an item (tok: the token or -1 for a pad token) and its
// shift labels sit in a ring of ATT_RING_SLOTS slots, written two items
// ahead of the item's copies.
constexpr int ATT_RING_SLOTS = 3;  // token and label slots
// blocks an SM the instances are built for (their launch bounds: 128
// registers a thread at 7 or 8 warps, no spill at any width; three blocks
// at head width 64, 80 registers, spilled and were slower on the H100);
// the launch sizes the grid by the occupancy the card reports.
// ops/swin_block.py mirrors it
constexpr int ATT_RING_BLOCKS = 2;

// shared memory of one block: the q, k, v rows (bf16, stride width_ld),
// ATT_RING_SLOTS slots of token and label rows, the column offsets, the
// compact table, and the (n, NP + 8) bias (bf16 in the Swin variant, f32 in
// the MSA variant)
static inline size_t window_attn_ring_smem(int win, int hd, bool msa) {
  const size_t n = win * win, np = (n + 15) / 16 * 16;
  const size_t ld = width_ld(hd, false);
  return 3 * np * ld * 2 + ATT_RING_SLOTS * 2 * np * 4 + np * 4 +
         rel_table_floats(win) * 4 + n * (np + 8) * (msa ? 4 : 2);
}

// the work item `it` of a grid walking (head, sample, window) head-major
__device__ __forceinline__ void ring_item(int it, int B, int nw, int& h,
                                          int& b, int& wi) {
  const int hb = it / nw;
  wi = it - hb * nw;
  h = hb / B;
  b = hb - h * B;
}

// the bias of keys c, c + 1 (c even) of a bias row
__device__ __forceinline__ float2 bias_pair(const bf16* row, int c) {
  return unpack_bf16(*reinterpret_cast<const uint32_t*>(row + c));
}
__device__ __forceinline__ float2 bias_pair(const float* row, int c) {
  return *reinterpret_cast<const float2*>(row + c);
}

// MAXNPT: the register arrays' size in 16-key steps (7 for win 10); qkv
// (B*H*W, 3C) bf16 with channel order [q | k | v] x heads x HD; qkv_bias
// (3C) f32; rel (heads, n, n) f32, a relative-position bias (its compact
// table is gathered from it); out (B*H*W, C) bf16. Any grid: block k walks
// items [k items / grid, (k + 1) items / grid).
template <int HD, int MAXNPT, bool MSA>
__global__ void __launch_bounds__(32 * MAXNPT, ATT_RING_BLOCKS)
    window_attn_ring_kernel(const bf16* __restrict__ qkv,
                            const float* __restrict__ qkv_bias,
                            const float* __restrict__ rel,
                            bf16* __restrict__ out, int B, int H, int W,
                            int C, int heads, int win, int shift,
                            float scale) {
  using BiasT = typename std::conditional<MSA, float, bf16>::type;
  constexpr int LD = width_ld(HD, false);
  constexpr int CH = HD / 8;  // 16-byte words of a head's row
  constexpr int NS = ATT_RING_SLOTS;
  extern __shared__ __align__(16) unsigned char smraw[];
  const int n = win * win, npt = (n + 15) / 16, NP = 16 * npt;
  const int LDB = NP + 8;  // bias row stride: conflict-free pair loads
  const int TF = rel_table_floats(win);
  bf16* qs = reinterpret_cast<bf16*>(smraw);  // q, k, v rows [NP][LD] each
  bf16* ks = qs + NP * LD;
  bf16* vs = ks + NP * LD;
  int* tok = reinterpret_cast<int*>(vs + NP * LD);  // [NS][NP]
  int* lab = tok + NS * NP;                         // [NS][NP]
  int* co = lab + NS * NP;                          // [NP]
  float* tab = reinterpret_cast<float*>(co + NP);   // [TF]
  BiasT* bias = reinterpret_cast<BiasT*>(tab + TF);  // [n][LDB]

  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  const int nww = wp / win, nwh = hp / win, nw = nwh * nww;
  const int tw = 2 * win - 1;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // (items < 2^31, the launch's check)
  const long long items = (long long)heads * B * nw;
  const int lo = (int)(items * blockIdx.x / gridDim.x);
  const int cnt = (int)(items * (blockIdx.x + 1) / gridDim.x) - lo;

  // the token and label rows of item k into slot k % NS
  auto stage_tokens = [&](int k) {
    int h, b, wi;
    ring_item(lo + k, B, nw, h, b, wi);
    int* tk = tok + (k % NS) * NP;
    int* lb = lab + (k % NS) * NP;
    const int wy = wi / nww, wx = wi % nww;
    for (int r = tid; r < n; r += nthr) {
      const int gy = wy * win + r / win, gx = wx * win + r % win;  // rolled
      const int ro = (gy + shift) % hp, cq = (gx + shift) % wp;    // padded
      tk[r] = (ro < H && cq < W) ? (b * H + ro) * W + cq : -1;
      lb[r] = shift ? shift_region(gy, hp, win, shift) * 3 +
                          shift_region(gx, wp, win, shift)
                    : 0;
    }
  };
  // parts p0 .. p0 + np - 1 (0 q, 1 k, 2 v) of item k's rows by cp.async
  // (a pad token's row the qkv bias, stored directly), one commit group
  auto stage_rows = [&](int k, int p0, int np) {
    int h, b, wi;
    ring_item(lo + k, B, nw, h, b, wi);
    const int* tk = tok + (k % NS) * NP;
    for (int i = tid; i < n * np * CH; i += nthr) {
      const int r = i / (np * CH), part = p0 + (i / CH) % np;
      const int c = (i % CH) * 8;
      bf16* dst = qs + (part * NP + r) * LD + c;
      const int tr = tk[r];
      if (tr >= 0) {
        cp_async16(dst, qkv + (size_t)tr * 3 * C + part * C + h * HD + c);
      } else {
        const float* bsrc = qkv_bias + part * C + h * HD + c;
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(pack_bf16(bsrc[0], bsrc[1]),
                       pack_bf16(bsrc[2], bsrc[3]),
                       pack_bf16(bsrc[4], bsrc[5]),
                       pack_bf16(bsrc[6], bsrc[7]));
      }
    }
    cp_async_commit();
  };
  // the head's bias: its compact table, offset (dy, dx) from the tokens
  // (max(dy, 0), max(dx, 0)) and (max(dy, 0) - dy, max(dx, 0) - dx), then
  // expanded: row r, key c the entry ro(r) - co(c); -inf past the keys
  auto stage_bias = [&](int h) {
    const float* relh = rel + (size_t)h * n * n;
    for (int i = tid; i < tw * tw; i += nthr) {
      const int dy = i / tw - (win - 1), dx = i % tw - (win - 1);
      const int ry = max(dy, 0), rx = max(dx, 0);
      float v = __ldg(relh + (size_t)(ry * win + rx) * n + (ry - dy) * win +
                      (rx - dx));
      if constexpr (!MSA) v = to_f(__float2bfloat16_rn(v));
      tab[i] = v;
    }
    __syncthreads();
    for (int r = warp; r < n; r += nthr / 32) {
      const int ro = co[r] + (win - 1) * (tw + 1);
      for (int c = lane; c < NP; c += 32) {
        const float v = c < n ? tab[ro - co[c]] : -INFINITY;
        if constexpr (MSA)
          bias[r * LDB + c] = v;
        else
          bias[r * LDB + c] = __float2bfloat16_rn(v);
      }
    }
  };

  // rows n .. NP - 1 are zero (v's must be finite: their probabilities are
  // 0); the copies never write them
  for (int i = tid; i < 3 * (NP - n) * LD; i += nthr) {
    const int per = (NP - n) * LD, part = i / per;
    qs[(size_t)part * NP * LD + n * LD + i % per] = __float2bfloat16_rn(0.f);
  }
  for (int j = tid; j < NP; j += nthr)
    co[j] = j < n ? (j / win) * tw + j % win : 0;
  for (int k = 0; k < 2 && k < cnt; ++k) stage_tokens(k);
  __syncthreads();
  int head = -1;  // the head whose bias the block holds
  if (cnt > 0) {
    stage_rows(0, 0, 2);  // item 0's q and k
    int h, b, wi;
    ring_item(lo, B, nw, h, b, wi);
    stage_bias(h);
    head = h;
  }

  // Item k: its q and k rows were copied while item k - 1's P v ran; its v
  // rows are copied while its S and softmax run; item k + 1's q and k while
  // its P v runs. Two barriers an item, as one buffer's parts are refilled.
  for (int k = 0; k < cnt; ++k) {
    cp_async_wait<0>();
    __syncthreads();  // q, k, tokens and bias of item k in place; v free
    stage_rows(k, 2, 1);
    if (k + 2 < cnt) stage_tokens(k + 2);  // slot (k - 1) % NS: read
    int h, b, wi;
    ring_item(lo + k, B, nw, h, b, wi);
    const int* tk = tok + (k % NS) * NP;
    const int* lb = lab + (k % NS) * NP;
    // labels differ only in the last row and column of windows
    const bool mixed = shift && (wi / nww == nwh - 1 || wi % nww == nww - 1);

    // ---- S = q k^T, 16 rows x NP keys in registers ----------------------
    float s[2 * MAXNPT][4];
#pragma unroll
    for (int j = 0; j < 2 * MAXNPT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    {
      uint32_t qa[HD / 16][4];
      const bf16* qrow = qs + (16 * warp + (lane & 15)) * LD;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        ldsm_x4(qa[kk], qrow + kk * 16 + (lane >> 4) * 8);
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
          const bf16* kr = ks + (8 * j + (lane & 7)) * LD;
          if constexpr (HD == 16) {
            uint32_t b0, b1;
            ldsm_x2(b0, b1, kr + ((lane >> 3) & 1) * 8);
            mma_16816(s[j], qa[0], b0, b1);
          } else {
#pragma unroll
            for (int kk = 0; kk < HD / 16; kk += 2) {
              uint32_t kb[4];  // k-steps kk and kk + 1
              ldsm_x4(kb, kr + kk * 16 + (lane >> 3) * 8);
              mma_16816(s[j], qa[kk], kb[0], kb[1]);
              mma_16816(s[j], qa[kk + 1], kb[2], kb[3]);
            }
          }
        }
      }
    }

    // ---- bias (the expanded table), shift mask, exact softmax -----------
    const int r0 = 16 * warp + g, r1 = r0 + 8;
    const BiasT* b0r = bias + min(r0, n - 1) * LDB + 2 * t;
    const BiasT* b1r = bias + min(r1, n - 1) * LDB + 2 * t;
    float m0 = -INFINITY, m1 = -INFINITY;
    auto scores = [&](auto masked) {
      const int l0 = r0 < n ? lb[r0] : 0, l1 = r1 < n ? lb[r1] : 0;
#pragma unroll
      for (int j = 0; j < 2 * MAXNPT; ++j) {
        if (j >= 2 * npt) {  // past the padded window: no key
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = -INFINITY;
          continue;
        }
        const float2 p0 = bias_pair(b0r, 8 * j), p1 = bias_pair(b1r, 8 * j);
        float bb[4] = {p0.x, p0.y, p1.x, p1.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (decltype(masked)::value) {
            const int c = 8 * j + 2 * t + (e & 1);
            if ((e < 2 ? l0 : l1) != (c < n ? lb[c] : 0))
              bb[e] = __fadd_rn(bb[e], -100.f);
          }
          const float v =
              __fadd_rn(MSA ? __fmul_rn(s[j][e], scale) : s[j][e], bb[e]);
          s[j][e] = v;
          if (e < 2)
            m0 = fmaxf(m0, v);
          else
            m1 = fmaxf(m1, v);
        }
      }
    };
    if (mixed)
      scores(std::true_type());
    else
      scores(std::false_type());
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

    // ---- O = P v: P packed to bf16 first (the f32 scores die before acc
    // lives), the A operand in registers --------------------------------
    cp_async_wait<0>();
    __syncthreads();  // item k's v in place; its q, k and bias read
    if (k + 1 < cnt) {
      stage_rows(k + 1, 0, 2);
      int h1, b1, w1;
      ring_item(lo + k + 1, B, nw, h1, b1, w1);
      if (h1 != head) {
        stage_bias(h1);
        head = h1;
      }
    }
    uint32_t pa[MAXNPT][4];
#pragma unroll
    for (int s2 = 0; s2 < MAXNPT; ++s2) {
      pa[s2][0] = pack_bf16(s[2 * s2][0] * l0s, s[2 * s2][1] * l0s);
      pa[s2][1] = pack_bf16(s[2 * s2][2] * l1s, s[2 * s2][3] * l1s);
      pa[s2][2] = pack_bf16(s[2 * s2 + 1][0] * l0s, s[2 * s2 + 1][1] * l0s);
      pa[s2][3] = pack_bf16(s[2 * s2 + 1][2] * l1s, s[2 * s2 + 1][3] * l1s);
    }
    float acc[HD / 8][4];
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jd][e] = 0.f;
#pragma unroll
    for (int s2 = 0; s2 < MAXNPT; ++s2) {
      if (s2 >= npt) continue;
      const bf16* vr = vs + (16 * s2 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int jd = 0; jd < HD / 8; jd += 2) {
        uint32_t vb[4];  // column tiles jd and jd + 1
        ldsm_x4_trans(vb, vr + 8 * jd);
        mma_16816(acc[jd], pa[s2], vb[0], vb[1]);
        mma_16816(acc[jd + 1], pa[s2], vb[2], vb[3]);
      }
    }
    const int tk0 = r0 < n ? tk[r0] : -1, tk1 = r1 < n ? tk[r1] : -1;
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd) {
      const int cc = h * HD + 8 * jd + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int tr = hh ? tk1 : tk0;
        if (tr < 0) continue;
        *reinterpret_cast<uint32_t*>(out + (size_t)tr * C + cc) =
            pack_bf16(acc[jd][2 * hh], acc[jd][2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Windows of 257 to 576 tokens (windows 17-24: Swin V2's 24 at 384 px), and
// windows of 129 to 256 tokens at head widths over 64:
// window_attn_stream_kernel. There the whole window's staged rows
// no longer fit a block's shared memory (window 24 at head width 64: 249
// KB of bf16 q, k, v; 608 KB of f32 k, v at width 128), so the keys and
// values stream through it in chunks of ATT_KCH 16-key steps (64 keys),
// with the running row max and sum of window_attn_long_kernel, and the
// queries go in rounds: one block a window, 8 warps of 16 query rows a
// round (bf16: the round's q rows staged once, ldmatrix; f32: the warp's q
// rows into registers), each round walking every chunk (the window's k and
// v are read once a round, from L2 after the first). The head's compact
// (2 win - 1)^2 bias table, the token, label and column-offset rows stay in
// shared memory for the window. Rows are staged at HS = stream_dim(hd)
// (16, 32, 64 or 128; hd runtime), the columns hd .. HS - 1 zero (zero
// terms add nothing to the scores; the scale is the caller's hd^-0.5), so
// one instance serves every width up to HS; P v and the stores cover the
// hd real columns. Everything per score (bias, shift mask, exp, the
// rescaling) is the long kernel's, in each variant's order.
constexpr int ATT_STREAM_WARPS = 8;      // 16 query rows each a round
constexpr int ATT_STREAM_TOKENS = 576;   // window 24

// the width a head of hd channels is staged at in the streaming kernel
__host__ __device__ constexpr int stream_dim(int hd) {
  return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : 128;
}

// blocks an SM the streaming instances are built for: two bf16 blocks up to
// HS 64, else one
template <typename T, int HS>
__host__ __device__ constexpr int stream_blocks() {
  return sizeof(T) == 2 && HS <= 64 ? 2 : 1;
}

// shared memory of one block of window_attn_stream_kernel: a round's q rows
// (bf16), a chunk's k and v rows; the token, label and column-offset rows;
// the compact bias table
static inline size_t window_attn_stream_smem(int win, int hd, bool f32) {
  const size_t np = (win * win + 15) / 16 * 16, hs = stream_dim(hd);
  const size_t ld = f32 ? hs + 4 : hs + 8, esz = f32 ? 4 : 2;
  const size_t q = f32 ? 0 : 16 * ATT_STREAM_WARPS * ld * esz;
  return q + 2 * 16 * ATT_KCH * ld * esz + 3 * np * 4 +
         rel_table_floats(win) * 4;
}

// rows [r0, r0 + cnt) of part (0 q, 1 k, 2 v) of head h of the window's
// tokens tok (n of them) into dst (stride LD) by 16-byte cp.async: the hd
// real columns; a pad token's row the qkv bias, a row past n zero. The
// caller waits.
template <typename T, int LD>
__device__ __forceinline__ void stream_rows(
    const T* __restrict__ qkv, const float* __restrict__ qkv_bias, T* dst,
    const int* tok, int part, int r0, int cnt, int n, int h, int hd,
    int C) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int EV = 16 / sizeof(T);
  const int ch = hd / EV;
  for (int i = threadIdx.x; i < cnt * ch; i += blockDim.x) {
    const int r = i / ch, c = (i % ch) * EV, rr = r0 + r;
    T* d = dst + r * LD + c;
    const int tk = rr < n ? tok[rr] : -1;
    if (tk >= 0) {
      cp_async16(d, qkv + (size_t)tk * 3 * C + part * C + h * hd + c);
    } else if (rr >= n) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else {  // pad token: zero before the qkv product, its row the bias
      const float* bsrc = qkv_bias + part * C + h * hd + c;
      if constexpr (F32) {
        *reinterpret_cast<float4*>(d) =
            *reinterpret_cast<const float4*>(bsrc);
      } else {
        *reinterpret_cast<uint4*>(d) =
            make_uint4(pack_bf16(bsrc[0], bsrc[1]),
                       pack_bf16(bsrc[2], bsrc[3]),
                       pack_bf16(bsrc[4], bsrc[5]),
                       pack_bf16(bsrc[6], bsrc[7]));
      }
    }
  }
}

// qkv (B*H*W, 3C) of T, channel order [q | k | v] x heads x hd; qkv_bias
// (3C) f32; rel (heads, n, n) f32, a relative-position bias (its compact
// table is gathered from it); out (B*H*W, C). Grid (windows, heads, B).
template <typename T, int HS, bool MSA>
__global__ void __launch_bounds__(32 * ATT_STREAM_WARPS,
                                  stream_blocks<T, HS>())
    window_attn_stream_kernel(const T* __restrict__ qkv,
                              const float* __restrict__ qkv_bias,
                              const float* __restrict__ rel,
                              T* __restrict__ out, int H, int W, int C,
                              int hd, int win, int shift, float scale) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int LD = F32 ? HS + 4 : HS + 8;
  constexpr int QR = 16 * ATT_STREAM_WARPS, KR = 16 * ATT_KCH;
  constexpr int KC = HS < 32 ? HS : 32, PER = KC / 4, NCH = HS / KC;
  extern __shared__ __align__(16) unsigned char smraw[];
  const int n = win * win, npt = (n + 15) / 16, NP = 16 * npt;
  T* qs = reinterpret_cast<T*>(smraw);  // bf16: a round's q rows
  T* ks = qs + (F32 ? 0 : QR * LD);      // a chunk's k rows
  T* vs = ks + KR * LD;                  // and v rows
  int* tok = reinterpret_cast<int*>(vs + KR * LD);
  int* lab = tok + NP;
  int* co = lab + NP;
  float* tab = reinterpret_cast<float*>(co + NP);

  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  const int nww = wp / win;
  const int b = blockIdx.z, h = blockIdx.y, wi = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int tw = 2 * win - 1;

  // the head's compact table, as window_attn_long_kernel gathers it
  const float* relh = rel + (size_t)h * n * n;
  for (int i = tid; i < tw * tw; i += nthr) {
    const int dy = i / tw - (win - 1), dx = i % tw - (win - 1);
    const int ry = max(dy, 0), rx = max(dx, 0);
    float v = __ldg(relh + (size_t)(ry * win + rx) * n + (ry - dy) * win +
                    (rx - dx));
    if constexpr (!F32 && !MSA) v = to_f(__float2bfloat16_rn(v));
    tab[i] = v;
  }
  for (int j = tid; j < NP; j += nthr)
    co[j] = j < n ? (j / win) * tw + j % win : 0;
  // the staged columns past hd stay zero (the copies never write them)
  for (int i = tid; i < (F32 ? 0 : QR) * (HS - hd); i += nthr)
    qs[(i / (HS - hd)) * LD + hd + i % (HS - hd)] = from_f<T>(0.f);
  for (int i = tid; i < KR * (HS - hd); i += nthr) {
    const int o = (i / (HS - hd)) * LD + hd + i % (HS - hd);
    ks[o] = from_f<T>(0.f);
    vs[o] = from_f<T>(0.f);
  }
  window_tokens(tok, lab, wi, nww, n, b, H, W, win, shift, hp, wp);
  __syncthreads();

  for (int q0 = 0; q0 < npt; q0 += ATT_STREAM_WARPS) {
    const int qt = q0 + warp;  // this warp's 16 query rows
    const int r0 = 16 * qt + g, r1 = r0 + 8;
    __syncthreads();  // the previous round is done with q, k and v
    float qv[2][F32 ? HS / 4 : 1];
    if constexpr (F32) {
      // chunk c of KC channels: the lane's PER contiguous channels from
      // c KC + PER t (qk_chunk_f32's layout), zero past hd and n
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 8 * hh;
        const int tk = r < n ? tok[r] : -1;
        const float* src = (tk >= 0 ? (const float*)qkv + (size_t)tk * 3 * C
                                    : qkv_bias) + h * hd;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int p = 0; p < PER; ++p) {
            const int chn = c * KC + PER * t + p;
            qv[hh][c * PER + p] = r < n && chn < hd ? __ldg(src + chn) : 0.f;
          }
      }
    } else {
      stream_rows<T, LD>(qkv, qkv_bias, qs, tok, 0, 16 * q0, QR, n, h, hd,
                         C);
      cp_async_wait_all();
      __syncthreads();
    }
    uint32_t qa[F32 ? 1 : HS / 16][4];
    if constexpr (!F32) {
#pragma unroll
      for (int kk = 0; kk < HS / 16; ++kk) {
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
    const int l0 = r0 < n ? lab[r0] : 0, l1 = r1 < n ? lab[r1] : 0;
    const int ro0 = (r0 / win) * tw + r0 % win + (win - 1) * (tw + 1);
    const int ro1 = (r1 / win) * tw + r1 % win + (win - 1) * (tw + 1);
    float m0 = -INFINITY, m1 = -INFINITY;  // running row max (quad-uniform)
    float l0s = 0.f, l1s = 0.f;            // this lane's running row sums
    float acc[HS / 8][4];
#pragma unroll
    for (int jd = 0; jd < HS / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jd][e] = 0.f;

    for (int j0 = 0; j0 < NP; j0 += KR) {  // key chunks: every one holds a
                                           // real key (NP - 16 < n)
      __syncthreads();  // the previous chunk's k and v are read
      stream_rows<T, LD>(qkv, qkv_bias, ks, tok, 1, j0, KR, n, h, hd, C);
      stream_rows<T, LD>(qkv, qkv_bias, vs, tok, 2, j0, KR, n, h, hd, C);
      cp_async_wait_all();
      __syncthreads();
      if (qt >= npt) continue;
      const int cnpt = min(ATT_KCH, npt - j0 / 16);  // 16-key steps here
      // ---- S = q k^T over the chunk's 8-key tiles ------------------------
      float s[2 * ATT_KCH][4];
#pragma unroll
      for (int j = 0; j < 2 * ATT_KCH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if constexpr (F32) {
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          qk_chunk_f32<KC, LD, ATT_KCH, MSA>(s, &qv[0][c * PER],
                                             &qv[1][c * PER], ks, c * KC,
                                             cnpt, scale, g, t);
      } else {
#pragma unroll
        for (int j = 0; j < 2 * ATT_KCH; ++j) {
          if (j < 2 * cnpt) {
#pragma unroll
            for (int kk = 0; kk < HS / 16; ++kk) {
              uint32_t b0, b1;
              ldsm_x2(b0, b1, ks + (8 * j + (lane & 7)) * LD + kk * 16 +
                                  ((lane >> 3) & 1) * 8);
              mma_16816(s[j], qa[kk], b0, b1);
            }
          }
        }
      }

      // ---- bias (the staged table), shift mask, the chunk's max ----------
      float c0 = -INFINITY, c1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2 * ATT_KCH; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? r0 : r1, c = j0 + 8 * j + 2 * t + (e & 1);
          float v = -INFINITY;
          if (c < n) {
            float bias = r < n ? tab[(e < 2 ? ro0 : ro1) - co[c]] : 0.f;
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
      const float n0 = fmaxf(m0, c0), n1 = fmaxf(m1, c1);
      const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);
      m0 = n0;
      m1 = n1;
      l0s *= a0;
      l1s *= a1;
#pragma unroll
      for (int jd = 0; jd < HS / 8; ++jd) {
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
          if (j < 2 * cnpt) {
            const uint32_t a[4] = {
                __float_as_uint(s[j][0]), __float_as_uint(s[j][2]),
                __float_as_uint(s[j][1]), __float_as_uint(s[j][3])};
            const Tf32x2<4> pa = split_frag(a);
            const T* v0 = vs + (8 * j + 2 * t) * LD + g;
#pragma unroll
            for (int jd = 0; jd < HS / 8; ++jd) {
              const uint32_t bw[2] = {__float_as_uint(v0[8 * jd]),
                                      __float_as_uint(v0[LD + 8 * jd])};
              mma_3xtf32(acc[jd], pa, split_frag(bw));
            }
          }
        }
      } else {
#pragma unroll
        for (int s2 = 0; s2 < ATT_KCH; ++s2) {
          if (s2 >= cnpt) break;
          const uint32_t pa[4] = {pack_bf16(s[2 * s2][0], s[2 * s2][1]),
                                  pack_bf16(s[2 * s2][2], s[2 * s2][3]),
                                  pack_bf16(s[2 * s2 + 1][0],
                                            s[2 * s2 + 1][1]),
                                  pack_bf16(s[2 * s2 + 1][2],
                                            s[2 * s2 + 1][3])};
#pragma unroll
          for (int jd = 0; jd < HS / 8; ++jd) {
            uint32_t b0, b1;
            ldsm_x2_trans(b0, b1, vs + (16 * s2 + (lane & 15)) * LD + 8 * jd);
            mma_16816(acc[jd], pa, b0, b1);
          }
        }
      }
    }
    if (qt >= npt) continue;
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0s += __shfl_xor_sync(0xffffffffu, l0s, o);
      l1s += __shfl_xor_sync(0xffffffffu, l1s, o);
    }
    l0s = 1.f / l0s;
    l1s = 1.f / l1s;
    const int tk0 = r0 < n ? tok[r0] : -1, tk1 = r1 < n ? tok[r1] : -1;
#pragma unroll
    for (int jd = 0; jd < HS / 8; ++jd) {
      if (8 * jd >= hd) break;
      const int col = h * hd + 8 * jd + 2 * t;
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

template <typename T, bool MSA, int HS>
static int launch_window_attn_stream(const void* qkv, const float* qkv_bias,
                                     const float* rel, void* out, int B,
                                     int H, int W, int C, int heads, int hd,
                                     int win, int shift, float scale,
                                     cudaStream_t stream) {
  const size_t smem = window_attn_stream_smem(win, hd, sizeof(T) == 4);
  auto kern = window_attn_stream_kernel<T, HS, MSA>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  dim3 grid((hp / win) * (wp / win), heads, B);
  kern<<<grid, 32 * ATT_STREAM_WARPS, smem, stream>>>(
      (const T*)qkv, qkv_bias, rel, (T*)out, H, W, C, hd, win, shift, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool MSA, int HD>
static int launch_window_attn_width(const void* qkv, const float* qkv_bias,
                                    const float* rel, void* out, int B,
                                    int H, int W, int C, int heads, int win,
                                    int shift, float scale,
                                    cudaStream_t stream) {
  const int NP = (win * win + 15) / 16 * 16;
  const size_t smem = window_attn_width_smem(win, HD, sizeof(T) == 4);
  auto kern = window_attn_width_kernel<T, HD, ATT_MAX_NPT, MSA>;
  if constexpr (HD <= 64)  // the wide heads: one instance of 8 warps
    if (NP == 112) kern = window_attn_width_kernel<T, HD, 7, MSA>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  dim3 grid(ceil_div((hp / win) * (wp / win), ATT_WIDTH_WPB), heads, B);
  kern<<<grid, 32 * (NP / 16), smem, stream>>>(
      (const T*)qkv, qkv_bias, rel, (T*)out, H, W, C, win, shift, scale);
  return (int)cudaGetLastError();
}

// the flagship widths' bf16 kernel up to 128 tokens: a persistent grid of
// as many blocks as fit the SMs at once, walking the items
template <bool MSA, int HD>
static int launch_window_attn_ring(const void* qkv, const float* qkv_bias,
                                   const float* rel, void* out, int B, int H,
                                   int W, int C, int heads, int win,
                                   int shift, float scale,
                                   cudaStream_t stream) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int NP = (win * win + 15) / 16 * 16;
  const size_t smem = window_attn_ring_smem(win, HD, MSA);
  auto kern = NP == 112 ? window_attn_ring_kernel<HD, 7, MSA>
                        : window_attn_ring_kernel<HD, ATT_MAX_NPT, MSA>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      32 * (NP / 16), smem);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  if (per_sm < 1) return MB_BAD_ARGS;
  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  const long long items = (long long)(hp / win) * (wp / win) * heads * B;
  if (items >= (1ll << 31)) return MB_BAD_ARGS;
  const int grid = (int)std::min<long long>(items, (long long)per_sm * sms);
  kern<<<grid, 32 * (NP / 16), smem, stream>>>(
      (const bf16*)qkv, qkv_bias, rel, (bf16*)out, B, H, W, C, heads, win,
      shift, scale);
  return (int)cudaGetLastError();
}

// windows of 129 to 256 tokens: the long-window kernel (every width up to
// 64, staged at staged_dim(HD))
template <typename T, bool MSA, int HD>
static int launch_window_attn_long(const void* qkv, const float* qkv_bias,
                                   const float* rel, void* out, int B, int H,
                                   int W, int C, int heads, int win,
                                   int shift, float scale,
                                   cudaStream_t stream) {
  const int NP = (win * win + 15) / 16 * 16;
  constexpr int HS = staged_dim(HD);
  const size_t smem = window_attn_long_smem(win, HS, sizeof(T) == 4);
  auto kern = NP <= 16 * ATT_W12_NPT
                  ? window_attn_long_kernel<T, HD, MSA, ATT_W12_NPT>
                  : window_attn_long_kernel<T, HD, MSA, ATT_LONG_MAX_NPT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  dim3 grid(ceil_div((hp / win) * (wp / win), ATT_WPB), heads, B);
  kern<<<grid, 32 * (NP / 16), smem, stream>>>(
      (const T*)qkv, qkv_bias, rel, (T*)out, H, W, C, win, shift, scale);
  return (int)cudaGetLastError();
}

// up to 128 tokens: the flagship widths' ring kernel in bf16, the
// head-width kernel otherwise (the flagship widths in f32 too); above, the
// long-window kernel
template <typename T, bool MSA, int HD>
static int launch_window_attn_hd(const void* qkv, const float* qkv_bias,
                                 const float* rel, void* out, int B, int H,
                                 int W, int C, int heads, int win, int shift,
                                 float scale, cudaStream_t stream) {
  const int n = win * win, NP = (n + 15) / 16 * 16;
  const bool long_win = NP > 16 * ATT_MAX_NPT;
  // windows over 256 tokens, or over 128 at head widths over 64: the
  // streaming kernel's entry (launch_window_attn_streamed), not this one
  if (NP > 16 * ATT_LONG_MAX_NPT || (HD > 64 && long_win)) return MB_BAD_ARGS;
  if (!long_win) {
    if constexpr (sizeof(T) == 2 && staged_dim(HD) == HD)
      return launch_window_attn_ring<MSA, HD>(qkv, qkv_bias, rel, out, B, H,
                                              W, C, heads, win, shift, scale,
                                              stream);
    else
      return launch_window_attn_width<T, MSA, HD>(qkv, qkv_bias, rel, out,
                                                  B, H, W, C, heads, win,
                                                  shift, scale, stream);
  }
  if constexpr (HD <= 64)
    return launch_window_attn_long<T, MSA, HD>(qkv, qkv_bias, rel, out, B, H,
                                               W, C, heads, win, shift, scale,
                                               stream);
  return MB_BAD_ARGS;
}

// The launch of either variant: f32 nonzero for f32 qkv and out, else
// bf16; a head width of HDS (16, 32, 64 in the flagship sources; 8-56 in
// attn_widths_*.cu, 72-128 in attn_wide_*.cu) and windows of at most 256
// tokens (above 128 the long-window kernel, up to head width 64); the
// streaming kernel's windows go to launch_window_attn_streamed
template <bool MSA, int... HDS>
static int launch_window_attn(const void* qkv, const float* qkv_bias,
                              const float* rel, void* out, int B, int H,
                              int W, int C, int heads, int win, int shift,
                              float scale, int f32, cudaStream_t stream) {
  if (C % heads || win * win > 16 * ATT_LONG_MAX_NPT) return MB_BAD_ARGS;
  const int hd = C / heads;
  int rc = MB_BAD_ARGS;
  (void)((hd == HDS &&
          ((rc = f32 ? launch_window_attn_hd<float, MSA, HDS>(
                           qkv, qkv_bias, rel, out, B, H, W, C, heads, win,
                           shift, scale, stream)
                     : launch_window_attn_hd<bf16, MSA, HDS>(
                           qkv, qkv_bias, rel, out, B, H, W, C, heads, win,
                           shift, scale, stream)),
           true)) ||
         ...);
  return rc;
}

// The streaming kernel's launch (attn_stream_*.cu): windows of 129 to 576
// tokens at any head width hd % 8 == 0 up to 128, staged at stream_dim(hd)
// (windows up to 256 tokens at head widths up to 64 take the long-window
// kernel above; ops/swin_block.py::attn_route chooses). f32 nonzero for f32
// qkv and out, else bf16.
template <bool MSA>
static int launch_window_attn_streamed(const void* qkv,
                                       const float* qkv_bias,
                                       const float* rel, void* out, int B,
                                       int H, int W, int C, int heads,
                                       int win, int shift, float scale,
                                       int f32, cudaStream_t stream) {
  const int NP = (win * win + 15) / 16 * 16;
  if (C % heads || win * win > ATT_STREAM_TOKENS || NP <= 16 * ATT_MAX_NPT)
    return MB_BAD_ARGS;
  const int hd = C / heads;
  if (hd % 8 || hd > 128 || (hd <= 64 && NP <= 16 * ATT_LONG_MAX_NPT))
    return MB_BAD_ARGS;
  const int hs = stream_dim(hd);
  auto go = [&](auto tag, auto hs_tag) {
    using T = decltype(tag);
    return launch_window_attn_stream<T, MSA, decltype(hs_tag)::value>(
        qkv, qkv_bias, rel, out, B, H, W, C, heads, hd, win, shift, scale,
        stream);
  };
  using I16 = std::integral_constant<int, 16>;
  using I32 = std::integral_constant<int, 32>;
  using I64 = std::integral_constant<int, 64>;
  using I128 = std::integral_constant<int, 128>;
  if (f32)
    return hs == 16 ? go(float(), I16()) : hs == 32 ? go(float(), I32())
         : hs == 64 ? go(float(), I64()) : go(float(), I128());
  return hs == 16 ? go(bf16(), I16()) : hs == 32 ? go(bf16(), I32())
       : hs == 64 ? go(bf16(), I64()) : go(bf16(), I128());
}
