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
// Kernels, up to 128 tokens a window: in bf16 the flagship widths 16, 32
// and 64 and the widths over 64 (72-128) run window_attn_ring_kernel (a
// persistent grid walking (head, sample, window) items, one window buffer
// whose parts are refilled in turn; over 64 q is read from device memory
// where staging it would leave one block an SM); the widths 8, 24, 40, 48,
// 56, and every width in f32, run window_attn_width_kernel (a grid of
// (windows / 4, heads, B) blocks). The widths outside the
// flagship's are built in their own sources, attn_widths_*.cu and
// attn_wide_*.cu, in parallel with these. From 129 to 256 tokens every
// width up to 64 runs window_attn_long_kernel, which stages a head's rows at
// HS = staged_dim(HD), the least flagship width that holds it, the columns
// HD .. HS - 1 zero (zero columns add nothing to the scores; the scale is
// the caller's, HD^-0.5); P v and the stores cover the HD real columns.
// Longer windows (to 576 tokens), and windows over 128 tokens at widths
// over 64, run window_attn_stream_kernel (attn_stream_*.cu: a persistent
// grid pulling query tiles of the windows' real tokens, k and v chunks in
// a ring of two buffers; wgmma in bf16 at staged widths 64 and 128).
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
// other window up to 128 tokens), f32; f32 at the head widths over 64
// (72-128, one instance of 8 warps for every window up to 11), whose q and
// accumulators hold 2-4x the registers (bf16 there runs the ring kernel);
// ops/swin_block.py mirrors these
#define ATT_WIDTH_BLOCKS_BF16_NPT7 4
#define ATT_WIDTH_BLOCKS_BF16_NPT8 3
#define ATT_WIDTH_BLOCKS_F32 2
#define ATT_WIDTH_BLOCKS_WIDE_F32 1

// row stride of the staged q, k, v rows (values)
__host__ __device__ constexpr int width_ld(int hd, bool f32) {
  return f32 ? hd + 4 : ((hd / 8) % 2 ? hd : hd + 8);
}

__host__ __device__ constexpr int width_blocks(bool f32, int maxnpt,
                                               int hd) {
  return hd > 64 ? ATT_WIDTH_BLOCKS_WIDE_F32
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
//
// It also serves the head widths over 64 (72-128) in bf16, which the
// head-width kernel ran before (1.33-1.71x SDPA's device time at window 10
// on the H100, its old walk: copy, wait, compute; 40-56 bytes spilled at
// 96-128). The walk is generalised over HD with the width kernel's exact
// k-steps (HD / 16 m16n8k16 steps, one m16n8k8 step where HD % 16 == 8,
// each score's sum in that order, so its outputs are the width kernel's bit
// for bit); and, over 64:
//   * q is not staged (ring_q_in_registers): each warp reads its rows'
//     fragments from device memory two k-steps at a time, the next two in
//     flight while these multiply, the k-steps outermost, so that only four
//     k-steps of q are live beside the 16 x NP scores (held whole, they
//     spilled). Staged q measured 5-15 % slower at 72-120 and would leave
//     one block an SM at 128 (Swin) and from 96 (MSA) at window 10, where
//     one block is ~35 % slower;
//   * P v in two passes of half the column tiles each, so that P and one
//     pass's accumulators fit the launch bounds (one pass spilled and was
//     slower from 96);
//   * the 8-warp instances (windows up to 11 but 10) built for one block an
//     SM: at two their registers spilled.
constexpr int ATT_RING_SLOTS = 3;  // token and label slots
// blocks an SM the instances are built for (their launch bounds: 128
// registers a thread at 7 or 8 warps, no spill at any width; three blocks
// at head width 64, 80 registers, spilled and were slower on the H100);
// the launch sizes the grid by the occupancy the card reports.
// ops/swin_block.py mirrors it
constexpr int ATT_RING_BLOCKS = 2;

// the head widths whose q rows go from device memory straight into the
// warps' registers (their fragments, two k-steps ahead of the products),
// not through shared memory: over 64 (on the H100 5-15 % faster than
// staged q at 72-120 at window 10, and staged q would leave one block an
// SM there at 128 in Swin and from 96 in MSA)
__host__ __device__ constexpr bool ring_q_in_registers(int hd) {
  return hd > 64;
}

// the row parts (q, k, v or k, v) a block stages in shared memory
__host__ __device__ constexpr int ring_parts(int hd) {
  return ring_q_in_registers(hd) ? 2 : 3;
}

// blocks an SM an instance is built for (its launch bounds):
// ATT_RING_BLOCKS, but one for the 8-warp instances over 64 (every window
// up to 11 but 10), whose registers spilled at two; the launch sizes its
// grid by the occupancy the card reports
__host__ __device__ constexpr int ring_blocks(int hd, int maxnpt) {
  return ring_q_in_registers(hd) && maxnpt == ATT_MAX_NPT ? 1
                                                          : ATT_RING_BLOCKS;
}

// shared memory of one block: the q (up to head width 64), k, v rows (bf16,
// stride width_ld), ATT_RING_SLOTS slots of token and label rows, the
// column offsets, the compact table, the (n, NP + 8) bias (bf16 in the
// Swin variant, f32 in the MSA variant), and where q goes to registers a
// zero row and the head's q bias row (bf16)
static inline size_t window_attn_ring_smem(int win, int hd, bool msa) {
  const size_t n = win * win, np = (n + 15) / 16 * 16;
  const size_t ld = width_ld(hd, false);
  return ring_parts(hd) * np * ld * 2 + ATT_RING_SLOTS * 2 * np * 4 +
         np * 4 + rel_table_floats(win) * 4 + n * (np + 8) * (msa ? 4 : 2) +
         (ring_q_in_registers(hd) ? 4 * hd : 0);
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
__global__ void __launch_bounds__(32 * MAXNPT, ring_blocks(HD, MAXNPT))
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
  // q k^T: K16 k16 steps, then one k8 step where HD % 16 == 8 (the head
  // width kernel's steps, so each score's sum is its order)
  constexpr int K16 = HD / 16;
  constexpr bool K8 = HD % 16 == 8;
  constexpr bool QREG = ring_q_in_registers(HD);
  constexpr int P0 = QREG ? 1 : 0;  // the first part staged: q or k
  // P v in passes of JT column tiles, so that P and one pass's
  // accumulators fit the launch bounds
  constexpr int NPASS = HD > 64 ? 2 : 1;
  constexpr int JT = (CH + NPASS - 1) / NPASS;
  extern __shared__ __align__(16) unsigned char smraw[];
  const int n = win * win, npt = (n + 15) / 16, NP = 16 * npt;
  const int LDB = NP + 8;  // bias row stride: conflict-free pair loads
  const int TF = rel_table_floats(win);
  // the staged parts' rows [NP][LD] each: q (up to 64), k, v
  bf16* rows = reinterpret_cast<bf16*>(smraw);
  bf16* qs = rows;  // (unused where QREG)
  bf16* ks = rows + (1 - P0) * NP * LD;
  bf16* vs = ks + NP * LD;
  int* tok = reinterpret_cast<int*>(vs + NP * LD);  // [NS][NP]
  int* lab = tok + NS * NP;                         // [NS][NP]
  int* co = lab + NS * NP;                          // [NP]
  float* tab = reinterpret_cast<float*>(co + NP);   // [TF]
  BiasT* bias = reinterpret_cast<BiasT*>(tab + TF);  // [n][LDB]
  // QREG: a zero row, then the head's q bias row (a pad token's q)
  bf16* qrow0 = reinterpret_cast<bf16*>(bias + n * LDB);  // [2][HD]

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
      bf16* dst = rows + ((part - P0) * NP + r) * LD + c;
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
    if constexpr (QREG)
      for (int c = tid; c < 2 * HD; c += nthr)
        qrow0[c] = __float2bfloat16_rn(c < HD ? 0.f
                                              : qkv_bias[h * HD + c - HD]);
  };

  // rows n .. NP - 1 are zero (v's must be finite: their probabilities are
  // 0); the copies never write them
  for (int i = tid; i < (3 - P0) * (NP - n) * LD; i += nthr) {
    const int per = (NP - n) * LD, part = i / per;
    rows[(size_t)part * NP * LD + n * LD + i % per] =
        __float2bfloat16_rn(0.f);
  }
  for (int j = tid; j < NP; j += nthr)
    co[j] = j < n ? (j / win) * tw + j % win : 0;
  for (int k = 0; k < 2 && k < cnt; ++k) stage_tokens(k);
  __syncthreads();
  int head = -1;  // the head whose bias the block holds
  if (cnt > 0) {
    stage_rows(0, P0, 2 - P0);  // item 0's q and k (QREG: k)
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
    if constexpr (HD > 64) {
      // The k-steps outermost: q's fragments two k-steps at a time from
      // device memory, so that only four k-steps of q are live beside the
      // 16 x NP scores; each score still sums its k-steps in order; the
      // next two in flight while these multiply. Rows 16 warp + g, + 8:
      // qf[u] = (row g, channels 16 kk + 2t, + 1), (g + 8, same), (g, 16 kk
      // + 8 + 2t, + 1), (g + 8, same), as ldmatrix gives them from staged
      // rows; a pad token's row the qkv bias and a row past n zero, from
      // shared memory, as staged rows hold them.
      const int ra = 16 * warp + g, rb = ra + 8;
      const int ta = ra < n ? tk[ra] : -2, tb = rb < n ? tk[rb] : -2;
      const bf16* qp0 = ta >= 0 ? qkv + (size_t)ta * 3 * C + h * HD
                                : qrow0 + (ta == -1 ? HD : 0);
      const bf16* qp1 = tb >= 0 ? qkv + (size_t)tb * 3 * C + h * HD
                                : qrow0 + (tb == -1 ? HD : 0);
      auto word = [&](const bf16* q, int c) -> uint32_t {
        return *reinterpret_cast<const uint32_t*>(q + c);
      };
      auto load = [&](uint32_t (&f)[2][4], int kk) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (kk + u >= K16) break;
          const int c = 16 * (kk + u) + 2 * t;
          f[u][0] = word(qp0, c);
          f[u][1] = word(qp1, c);
          f[u][2] = word(qp0, c + 8);
          f[u][3] = word(qp1, c + 8);
        }
      };
      auto scaled = [&](uint32_t v) -> uint32_t {
        if constexpr (MSA) return v;
        const float2 f = unpack_bf16(v);
        return pack_bf16(f.x * scale, f.y * scale);
      };
      uint32_t qc[2][4], qx[2][4], q8[2];
      load(qc, 0);
#pragma unroll
      for (int kk = 0; kk < K16; kk += 2) {
        if (kk + 2 < K16) load(qx, kk + 2);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) qc[u][e] = scaled(qc[u][e]);
#pragma unroll
        for (int j = 0; j < 2 * MAXNPT; ++j) {
          if (j < 2 * npt) {
            const bf16* kr = ks + (8 * j + (lane & 7)) * LD;
            if (kk + 1 < K16) {
              uint32_t kb[4];  // k-steps kk and kk + 1
              ldsm_x4(kb, kr + kk * 16 + (lane >> 3) * 8);
              mma_16816(s[j], qc[0], kb[0], kb[1]);
              mma_16816(s[j], qc[1], kb[2], kb[3]);
            } else {
              uint32_t b0, b1;
              ldsm_x2(b0, b1, kr + kk * 16 + ((lane >> 3) & 1) * 8);
              mma_16816(s[j], qc[0], b0, b1);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) qc[u][e] = qx[u][e];
      }
      if constexpr (K8) {
        q8[0] = word(qp0, HD - 8 + 2 * t);
        q8[1] = word(qp1, HD - 8 + 2 * t);
        q8[0] = scaled(q8[0]);
        q8[1] = scaled(q8[1]);
#pragma unroll
        for (int j = 0; j < 2 * MAXNPT; ++j) {
          if (j < 2 * npt) {
            uint32_t b0;
            ldsm_x1(b0, ks + (8 * j + (lane & 7)) * LD + HD - 8);
            mma_1688_bf16(s[j], q8, b0);
          }
        }
      }
    } else {  // the flagship widths: q whole in registers
      uint32_t qa[K16][4];
      const bf16* qrow = qs + (16 * warp + (lane & 15)) * LD;
#pragma unroll
      for (int kk = 0; kk < K16; ++kk) {
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
            for (int kk = 0; kk < K16; kk += 2) {
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
      stage_rows(k + 1, P0, 2 - P0);
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
#pragma unroll
    for (int ps = 0; ps < NPASS; ++ps) {
      const int jd0 = ps * JT;  // (the last pass may hold fewer tiles)
      float acc[JT][4];
#pragma unroll
      for (int jj = 0; jj < JT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
#pragma unroll
      for (int s2 = 0; s2 < MAXNPT; ++s2) {
        if (s2 >= npt) continue;
        const bf16* vr = vs + (16 * s2 + (lane & 15)) * LD;
#pragma unroll
        for (int jj = 0; jj < JT; jj += 2) {
          const int jd = jd0 + jj;
          if (jd >= CH) break;
          if (jd + 1 < CH && jj + 1 < JT) {
            uint32_t vb[4];  // column tiles jd and jd + 1
            ldsm_x4_trans(vb, vr + 8 * jd + (lane >> 4) * 8);
            mma_16816(acc[jj], pa[s2], vb[0], vb[1]);
            mma_16816(acc[jj + 1], pa[s2], vb[2], vb[3]);
          } else {
            uint32_t b0, b1;
            ldsm_x2_trans(b0, b1, vr + 8 * jd);
            mma_16816(acc[jj], pa[s2], b0, b1);
          }
        }
      }
      const int tk0 = r0 < n ? tk[r0] : -1, tk1 = r1 < n ? tk[r1] : -1;
#pragma unroll
      for (int jj = 0; jj < JT; ++jj) {
        const int jd = jd0 + jj;
        if (jd >= CH) break;
        const int cc = h * HD + 8 * jd + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int tr = hh ? tk1 : tk0;
          if (tr < 0) continue;
          *reinterpret_cast<uint32_t*>(out + (size_t)tr * C + cc) =
              pack_bf16(acc[jj][2 * hh], acc[jj][2 * hh + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Windows of 257 to 576 tokens (windows 17-24: Swin V2's 24 at 384 px), and
// windows of 129 to 256 tokens at head widths over 64:
// window_attn_stream_kernel. There the whole window's staged rows no longer
// fit a block's shared memory (window 24 at head width 64: 249 KB of bf16
// q, k, v; 608 KB of f32 k, v at width 128), so the keys and values stream
// through it in chunks of ATT_KCH 16-key steps (64 keys), with the running
// row max and sum of window_attn_long_kernel. Rows are staged at HS =
// stream_dim(hd) (16, 32, 64 or 128; hd runtime), the columns hd .. HS - 1
// zero (zero terms add nothing to the scores; the scale is the caller's
// hd^-0.5), so one instance serves every width up to HS; the k-steps, P v
// and the stores skip the column tiles past hd. Everything per score (bias,
// shift mask, exp, the rescaling) is the long kernel's, in each variant's
// order, and the chunks go in the window's key order, so every stored row's
// sums are those of the first version of this kernel, bit for bit.
//
// The first version ran one block a (window, head, sample): 8 warps walked
// the window's rounds of 128 query rows in turn, each round copying every
// chunk, waiting for it, then computing. On the H100 it lost 2.1x to SDPA
// on .w24 and 4.1-4.8x on the stage-1 grid at widths 72-128, whose 144
// blocks of one a SM made two waves, the second of 12 blocks; nothing was
// in flight while the warps computed, and the query rows of pad tokens
// were computed and dropped (40 % of .w24's query rows). The Hopper
// redesign:
//   * a persistent grid of whole waves (the resident blocks the occupancy
//     API reports, times the SMs) pulling (head, sample, window, query
//     tile) items, head-major, from a counter in device memory (atomicAdd,
//     so blocks whose items hold fewer real rows take more items), two
//     items ahead of their work;
//   * a query tile is 128 rows of the window's query list, its real tokens
//     first, then its pad tokens, each in the window's order: a tile past
//     the window's real tokens is skipped when it is pulled, and a warp whose
//     16 rows are pad tokens only idles through the item (pad tokens stay
//     in as keys: they take the qkv bias);
//   * k and v chunks in a ring of ATT_STREAM_STAGES buffers filled by
//     cp.async groups: chunk j + 1 (after the last chunk, the next item's q
//     rows and first chunk) lands while chunk j computes; one barrier a
//     chunk;
//   * the shift mask's label compare only in the windows whose labels
//     differ (the last row and column of windows), as the ring kernel;
//   * bf16 at staged widths 64 and 128: wgmma, a warpgroup a 64-row half
//     of the tile (below, ATT_STREAM_WGMMA); at .w24 it took the attention
//     from 4.51 to 3.41 device ms on the H100, outputs unchanged bit for
//     bit (PERF.md). At staged widths 16 and 32, and in f32, mma.sync
//     with the scores and P in registers (bf16 m16n8k16, ldmatrix.x4 for
//     two k-steps or two column tiles; f32 3xTF32 m16n8k8). The bf16 q
//     rows stay in shared memory (two tile buffers: the item's, and the
//     next item's landing) and are read each chunk (mma.sync: the k-steps
//     outermost, so that they hold no registers beside the scores and
//     accumulators).
// k and v stay streamed: holding a window's k and v for all its tiles (147
// KB at staged width 64) leaves one block an SM, and even with its copies
// skipped outright that ran 1.36x slower than two streaming blocks.
// An item slot (ATT_STREAM_SLOTS of them) holds an item's token, label and
// query rows and its head's compact bias table, gathered again only when
// the slot's head changes.
// Head widths of 136 to 256 run at a staged width of 256 (HS 256: any
// window, the items' chunks in a schedule of one q buffer and one k / v
// stage, stream_single): two stages of k and v and two q tiles at 256
// columns pass a block's shared memory, and the accumulators of P v at N
// 256 (128 registers a thread) leave no room for q's f32 values in
// registers, so the f32 instance reads q's 32-channel slices from device
// memory each chunk. A window of up to 32 x 32 tokens (ATT_STREAM_TOKENS)
// fits: window_masks' ballots hold 32 rows and columns, and the slots and
// the compact table are sized by the window at run time.
constexpr int ATT_STREAM_WARPS = 8;      // 16 query rows each: a tile of 128
constexpr int ATT_STREAM_TOKENS = 1024;  // window 32
constexpr int ATT_STREAM_STAGES = 2;     // k and v chunk buffers
constexpr int ATT_STREAM_SLOTS = 2;      // item slots

// the width a head of hd channels is staged at in the streaming kernel
__host__ __device__ constexpr int stream_dim(int hd) {
  return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128
                                                                   : 256;
}

// the HS 256 instances' schedule: one q tile buffer and one k / v stage,
// each chunk's copies issued after the previous chunk is read (no overlap)
__host__ __device__ constexpr bool stream_single(int hs) { return hs > 128; }

// blocks an SM the streaming instances are built for: two bf16 blocks up to
// HS 64, else one
template <typename T, int HS>
__host__ __device__ constexpr int stream_blocks() {
  return sizeof(T) == 2 && HS <= 64 ? 2 : 1;
}

// The bf16 instances at staged widths 64 and 128 take both products with
// wgmma (ATT_STREAM_WGMMA; false: mma.sync, as at 16 and 32): each
// warpgroup of 4 warps takes its 64 rows of the query tile, S = q k^T
// (m64n64k16, q and k from shared memory) and O += P v (m64nHSk16, P
// packed to bf16 in registers as A, v from shared memory through the
// descriptor's transpose), the q, k and v rows staged in wgmma's 128-byte
// swizzle. The scores and accumulators keep mma.sync's fragment layout, so
// the softmax between is the same code, and the k-steps and 16-key steps
// go in the same order: on the H100 the outputs are mma.sync's, bit for bit
// (the digests of tests/test_torch_port_attn_stream.py).
constexpr bool ATT_STREAM_WGMMA = true;

__host__ __device__ constexpr bool stream_wgmma(bool f32, int hs) {
  return ATT_STREAM_WGMMA && !f32 && hs >= 64 && hs <= 128;
}

// element (r, c) of a bf16 buffer of R rows staged at a width of 64 or 128
// in the 128-byte swizzle: panels of 64 columns (R x 128 bytes each, 1024
// bytes aligned), 16-byte chunk c / 8 of row r at chunk (c / 8) ^ (r % 8)
// of the row's 128 bytes
__device__ __forceinline__ int sw128_at(int r, int c, int R) {
  return (c >> 6) * R * 64 + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) +
         (c & 7);
}

// wgmma descriptor of a 128-byte swizzled operand: K-major (rows of 128
// bytes, 8-row groups 1024 bytes apart); MN-major with its 64-column panels
// `panel` bytes apart
__device__ __forceinline__ uint64_t wg_desc_k(const void* p) {
  return ((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}
__device__ __forceinline__ uint64_t wg_desc_mn(const void* p,
                                               uint32_t panel) {
  return ((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(panel >> 4) << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
  asm volatile(
      "wgmma.commit_group.sync.aligned;\n"
      "wgmma.wait_group.sync.aligned 0;" ::
          : "memory");
}
// the registers a wgmma wrote (or read) are ready (free) from here on
template <int N>
__device__ __forceinline__ void wg_hold(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[i][e])::"memory");
}
template <int N>
__device__ __forceinline__ void wg_hold(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(x[i][e])::"memory");
}

#define WG_F4(x, j) \
  "+f"(x[j][0]), "+f"(x[j][1]), "+f"(x[j][2]), "+f"(x[j][3])
#define WG_F32(x, b)                                                    \
  WG_F4(x, b + 0), WG_F4(x, b + 1), WG_F4(x, b + 2), WG_F4(x, b + 3),   \
      WG_F4(x, b + 4), WG_F4(x, b + 5), WG_F4(x, b + 6), WG_F4(x, b + 7)
#define WG_R32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"
#define WG_R64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// s (+)= q[64 x 16] . k[64 x 16]^T, both K-major; acc 0 overwrites s
__device__ __forceinline__ void wg_qk(float (&s)[8][4], uint64_t da,
                                      uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : WG_F32(s, 0)
      : "l"(da), "l"(db), "r"(acc));
}

// o += P[64 x 16] . v[16 x HS]: P this warp's m16n8k16 A fragment, v
// MN-major
template <int HS>
__device__ __forceinline__ void wg_pv(float (&o)[HS / 8][4],
                                      const uint32_t (&a)[4], uint64_t db) {
  static_assert(HS == 64 || HS == 128, "wgmma P v: staged width 64 or 128");
  if constexpr (HS == 64) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
        : WG_F32(o, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
        : WG_F32(o, 0), WG_F32(o, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}
#undef WG_F4
#undef WG_F32
#undef WG_R32
#undef WG_R64

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// shared memory of one block of window_attn_stream_kernel: two tiles' q
// rows (bf16: the item's and the next one's), ATT_STREAM_STAGES chunks of k
// and v rows; the column offsets;
// ATT_STREAM_SLOTS slots of token, label and query rows and a compact bias
// table; the ring of pulled items (wgmma: rows unpadded, and 1024 bytes to
// align the swizzled buffers)
static inline size_t window_attn_stream_smem(int win, int hd, bool f32) {
  const size_t np = (win * win + 15) / 16 * 16, hs = stream_dim(hd);
  const bool wg = stream_wgmma(f32, hs), one = stream_single(hs);
  const size_t ld = wg ? hs : f32 ? hs + 4 : hs + 8, esz = f32 ? 4 : 2;
  const size_t q =
      f32 ? 0 : (one ? 1 : 2) * 16 * ATT_STREAM_WARPS * ld * esz;
  return q + (one ? 1 : ATT_STREAM_STAGES) * 2 * 16 * ATT_KCH * ld * esz +
         np * 4 +
         ATT_STREAM_SLOTS * (3 * np + rel_table_floats(win)) * 4 + 16 +
         (wg ? 1024 : 0);
}

// rows [r0, r0 + cnt) of part (0 q, 1 k, 2 v) of head h into dst (stride
// LD; SWR > 0: the 128-byte swizzle of SWR rows, sw128_at) by 16-byte
// cp.async: row r is the window's row map[r] (map null: r), its token
// tok[map[r]]; the hd real columns; a pad token's row the qkv bias, a row
// past n zero. The caller commits and waits.
template <typename T, int LD, int SWR = 0>
__device__ __forceinline__ void stream_rows(
    const T* __restrict__ qkv, const float* __restrict__ qkv_bias, T* dst,
    const int* tok, const int* map, int part, int r0, int cnt, int n,
    int h, int hd, int C) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int EV = 16 / sizeof(T);
  const int ch = hd / EV;
  for (int i = threadIdx.x; i < cnt * ch; i += blockDim.x) {
    const int r = i / ch, c = (i % ch) * EV, rr = r0 + r;
    T* d = dst + (SWR ? sw128_at(r, c, SWR) : r * LD + c);
    const int tk = rr < n ? tok[map ? map[rr] : rr] : -2;
    if (tk >= 0) {
      cp_async16(d, qkv + (size_t)tk * 3 * C + part * C + h * hd + c);
    } else if (tk == -2) {
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

// the rows and columns of window (wy, wx) that hold tokens of the grid
// (win <= 32): bit i of my (mx) set where row (column) i does; every lane
// of the calling warp gets both
__device__ __forceinline__ void window_masks(int wy, int wx, int win,
                                             int shift, int H, int W, int hp,
                                             int wp, unsigned& my,
                                             unsigned& mx) {
  const int lane = threadIdx.x & 31;
  my = __ballot_sync(0xffffffffu,
                     lane < win && (wy * win + lane + shift) % hp < H);
  mx = __ballot_sync(0xffffffffu,
                     lane < win && (wx * win + lane + shift) % wp < W);
}

// qkv (B*H*W, 3C) of T, channel order [q | k | v] x heads x hd; qkv_bias
// (3C) f32; rel (heads, n, n) f32, a relative-position bias (its compact
// table is gathered from it); out (B*H*W, C); next, an int that is 0 at
// the launch (the item counter). Any grid.
template <typename T, int HS, bool MSA>
__global__ void __launch_bounds__(32 * ATT_STREAM_WARPS,
                                  stream_blocks<T, HS>())
    window_attn_stream_kernel(const T* __restrict__ qkv,
                              const float* __restrict__ qkv_bias,
                              const float* __restrict__ rel,
                              T* __restrict__ out, int* __restrict__ next,
                              int B, int H, int W, int C, int heads, int hd,
                              int win, int shift, float scale) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr bool WG = stream_wgmma(F32, HS);
  constexpr int LD = WG ? HS : F32 ? HS + 4 : HS + 8;
  constexpr int QR = 16 * ATT_STREAM_WARPS, KR = 16 * ATT_KCH;
  // wgmma: the q, k and v buffers in the 128-byte swizzle of QR / KR rows
  constexpr int QSW = WG ? QR : 0, KSW = WG ? KR : 0;
  constexpr bool ONE = stream_single(HS);  // one q buffer, one stage
  constexpr int NST = ONE ? 1 : ATT_STREAM_STAGES, NQB = ONE ? 1 : 2;
  constexpr int KC = HS < 32 ? HS : 32, PER = KC / 4, NCH = HS / KC;
  extern __shared__ __align__(16) unsigned char smraw[];
  unsigned char* sm = smraw;
  if constexpr (WG) sm += (1024u - (smem_addr(smraw) & 1023u)) & 1023u;
  const int n = win * win, npt = (n + 15) / 16, NP = 16 * npt;
  const int TF = rel_table_floats(win);
  T* qs = reinterpret_cast<T*>(sm);  // bf16: slot p's tile's q rows
  T* kvs = qs + (F32 ? 0 : NQB * QR * LD);  // stage s: k rows, then v rows
  int* co = reinterpret_cast<int*>(kvs + NST * 2 * KR * LD);
  int* slots = co + NP;  // slot p: tok, lab, query rows [NP] each, tab
  int* ring = slots + ATT_STREAM_SLOTS * (3 * NP + TF);  // [4]: items

  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  const int nww = wp / win, nwh = hp / win, nw = nwh * nww;
  const int tpw = (n + QR - 1) / QR;  // query tiles a window
  // (items < 2^31, the launch's check)
  const int total = heads * B * nw * tpw;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int tw = 2 * win - 1;

  // item it: head h, sample b, window wi, query tile qt
  auto decode = [&](int it, int& h, int& b, int& wi, int& qt) {
    qt = it % tpw;
    const int w = it / tpw;
    wi = w % nw;
    const int hb = w / nw;
    b = hb % B;
    h = hb / B;
  };
  // warp 0: the next item holding a real query row, or -1 (every lane)
  auto pull = [&]() -> int {
    for (;;) {
      int it = 0;
      if (lane == 0) it = atomicAdd(next, 1);
      it = __shfl_sync(0xffffffffu, it, 0);
      if (it >= total) return -1;
      int h, b, wi, qt;
      decode(it, h, b, wi, qt);
      unsigned my, mx;
      window_masks(wi / nww, wi % nww, win, shift, H, W, hp, wp, my, mx);
      if (qt * QR < __popc(my) * __popc(mx)) return it;
    }
  };
  int* const tok0 = slots;
  auto slot_tok = [&](int p) { return tok0 + p * (3 * NP + TF); };
  // item it's token, label and query rows into slot p, and its head's
  // compact table unless the slot holds it already (gather false)
  auto stage_slot = [&](int p, int it, bool gather) {
    int h, b, wi, qt;
    decode(it, h, b, wi, qt);
    const int wy = wi / nww, wx = wi % nww;
    unsigned my, mx;
    window_masks(wy, wx, win, shift, H, W, hp, wp, my, mx);
    const int cx = __popc(mx), real = __popc(my) * cx;
    int* tk = slot_tok(p);
    int* lb = tk + NP;
    int* qr = lb + NP;
    for (int r = tid; r < n; r += nthr) {
      const int i = r / win, j = r % win;
      const int gy = wy * win + i, gx = wx * win + j;           // rolled
      const int ro = (gy + shift) % hp, cq = (gx + shift) % wp;  // padded
      const bool yr = (my >> i) & 1u, xr = (mx >> j) & 1u;
      tk[r] = yr && xr ? (b * H + ro) * W + cq : -1;
      lb[r] = shift ? shift_region(gy, hp, win, shift) * 3 +
                          shift_region(gx, wp, win, shift)
                    : 0;
      // the real rows before r in the window's order
      const int before = __popc(my & ((1u << i) - 1u)) * cx +
                         (yr ? __popc(mx & ((1u << j) - 1u)) : 0);
      qr[yr && xr ? before : real + r - before] = r;
    }
    if (gather) {
      float* tab = reinterpret_cast<float*>(qr + NP);
      const float* relh = rel + (size_t)h * n * n;
      for (int i = tid; i < tw * tw; i += nthr) {
        const int dy = i / tw - (win - 1), dx = i % tw - (win - 1);
        const int ry = max(dy, 0), rx = max(dx, 0);
        float v = __ldg(relh + (size_t)(ry * win + rx) * n +
                        (ry - dy) * win + (rx - dx));
        if constexpr (!F32 && !MSA) v = to_f(__float2bfloat16_rn(v));
        tab[i] = v;
      }
    }
  };
  // the copies of item it (slot p) that precede its chunk j0's compute:
  // its chunk j0 of k and v into stage st, and where j0 is 0 its tile's q
  // rows (bf16); one commit group
  auto copy_step = [&](int it, int p, int j0, int st) {
    int h, b, wi, qt;
    decode(it, h, b, wi, qt);
    const int* tk = slot_tok(p);
    T* ks = kvs + st * 2 * KR * LD;
    if (!F32 && j0 == 0)
      stream_rows<T, LD, QSW>(qkv, qkv_bias, qs + (ONE ? 0 : p) * QR * LD,
                              tk, tk + 2 * NP, 0, qt * QR, QR, n, h, hd, C);
    stream_rows<T, LD, KSW>(qkv, qkv_bias, ks, tk, nullptr, 1, j0, KR, n, h,
                            hd, C);
    stream_rows<T, LD, KSW>(qkv, qkv_bias, ks + KR * LD, tk, nullptr, 2, j0,
                            KR, n, h, hd, C);
    cp_async_commit();
  };

  for (int j = tid; j < NP; j += nthr)
    co[j] = j < n ? (j / win) * tw + j % win : 0;
  // the staged columns past hd stay zero (the copies never write them)
  if constexpr (WG) {
    uint4* z = reinterpret_cast<uint4*>(qs);
    for (int i = tid; i < (2 * QR + NST * 2 * KR) * HS / 8; i += nthr)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (int i = tid; i < (F32 ? 0 : NQB * QR) * (HS - hd); i += nthr)
      qs[(i / (HS - hd)) * LD + hd + i % (HS - hd)] = from_f<T>(0.f);
    for (int i = tid; i < NST * 2 * KR * (HS - hd); i += nthr)
      kvs[(i / (HS - hd)) * LD + hd + i % (HS - hd)] = from_f<T>(0.f);
  }
  // ring[k % 4]: the block's item k (-1: none), pulled two items ahead
  if (warp == 0) {
    const int a = pull();
    const int a2 = a >= 0 ? pull() : -1;
    if (lane == 0) {
      ring[0] = a;
      ring[1] = a2;
    }
  }
  __syncthreads();
  if (ring[0] < 0) return;
  stage_slot(0, ring[0], true);
  __syncthreads();
  if constexpr (!ONE) copy_step(ring[0], 0, 0, 0);

  // chunks an item (3 at least, but in the HS 256 schedule)
  const int nch = (NP + KR - 1) / KR;
  auto head_of = [&](int it) { return it / (tpw * nw * B); };
  for (int k = 0; ring[k & 3] >= 0; ++k) {
    const int p = k & 1, qb = ONE ? 0 : p;  // the slot; the q buffer
    const int* tk = slot_tok(p);
    const int* lb = tk + NP;
    const int* qr = lb + NP;
    const float* tab = reinterpret_cast<const float*>(qr + NP);
    bool mixed, live;
    {
      int h, b, wi, qt;
      decode(ring[k & 3], h, b, wi, qt);
      unsigned my, mx;
      window_masks(wi / nww, wi % nww, win, shift, H, W, hp, wp, my, mx);
      // labels differ only in the last row and column of windows
      mixed = shift && (wi / nww == nwh - 1 || wi % nww == nww - 1);
      // a real row among this warp's 16 (wgmma: its warpgroup's 64)
      live = qt * QR + (WG ? 64 * (warp >> 2) : 16 * warp) <
             __popc(my) * __popc(mx);
    }

    float qv[2][F32 && !ONE ? HS / 4 : 1];
    const float* qsrc[2] = {nullptr, nullptr};  // ONE, f32: q's rows
    int l0 = 0, l1 = 0, ro0 = 0, ro1 = 0;
    float m0 = -INFINITY, m1 = -INFINITY;  // running row max (quad-uniform)
    float l0s = 0.f, l1s = 0.f;            // this lane's running row sums
    float acc[HS / 8][4];
#pragma unroll
    for (int jd = 0; jd < HS / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jd][e] = 0.f;

    for (int j0 = 0; j0 < NP; j0 += KR) {
      if constexpr (ONE) {
        __syncthreads();  // the last chunk (and item) is read
        copy_step(ring[k & 3], p, j0, 0);
      }
      cp_async_wait<0>();
      if constexpr (WG) fence_proxy_async();  // for wgmma's reads
      __syncthreads();  // chunk j0 (and the tile's q) in place; the other
                        // buffer read
      const int st = ONE ? 0 : (k * nch + j0 / KR) % NST;
      const bool last = j0 + KR >= NP;
      if (j0 == 0) {
        int h, b, wi, qt;
        decode(ring[k & 3], h, b, wi, qt);
        // this warp's rows g, g + 8: their positions in the query list,
        // their window rows (a row past n reads row 0's offset and label;
        // it is never stored)
        const int p0 = qt * QR + 16 * warp + g, p1 = p0 + 8;
        const int o0 = p0 < n ? qr[p0] : -1, o1 = p1 < n ? qr[p1] : -1;
        l0 = lb[max(o0, 0)];
        l1 = lb[max(o1, 0)];
        // the rows' table offsets: ro(i) - co(j) indexes tab
        ro0 = co[max(o0, 0)] + (win - 1) * (tw + 1);
        ro1 = co[max(o1, 0)] + (win - 1) * (tw + 1);
        if constexpr (F32 && ONE) {
          // q's rows, read a chunk of channels at a time below (null: zero)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int o = hh ? o1 : o0;
            const int tr = o >= 0 ? tk[o] : -1;
            qsrc[hh] = o < 0 ? nullptr
                             : (tr >= 0 ? (const float*)qkv + (size_t)tr * 3 * C
                                        : qkv_bias) + h * hd;
          }
        } else if constexpr (F32) {
          // chunk c of KC channels: the lane's PER contiguous channels from
          // c KC + PER t (qk_chunk_f32's layout), zero past hd and n
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int o = hh ? o1 : o0;
            const int tr = o >= 0 ? tk[o] : -1;
            const float* src = (tr >= 0 ? (const float*)qkv +
                                              (size_t)tr * 3 * C
                                        : qkv_bias) + h * hd;
#pragma unroll
            for (int c = 0; c < NCH; ++c)
#pragma unroll
              for (int pp = 0; pp < PER; ++pp) {
                const int chn = c * KC + PER * t + pp;
                qv[hh][c * PER + pp] =
                    o >= 0 && chn < hd ? __ldg(src + chn) : 0.f;
              }
          }
        } else if constexpr (!MSA) {
          // the Swin variant scales q before the product, rounded to bf16:
          // each warp scales its own 16 staged rows in place, once an item
          T* qw = qs + (qb * QR + (WG ? 0 : 16 * warp)) * LD;
          for (int i = lane; i < 16 * (hd / 8); i += 32) {
            const int r = i / (hd / 8), c = (i % (hd / 8)) * 8;
            uint4* w = reinterpret_cast<uint4*>(
                qw + (WG ? sw128_at(16 * warp + r, c, QR) : r * LD + c));
            uint4 v = *w;
            uint32_t* e4 = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = unpack_bf16(e4[e]);
              e4[e] = pack_bf16(f.x * scale, f.y * scale);
            }
            *w = v;
          }
          __syncwarp();
        }
        // the next item's slot: its table gathered unless the slot's last
        // item (k - 1) had its head
        const int nx = ring[(k + 1) & 3];
        if (nx >= 0)
          stage_slot(p ^ 1, nx,
                     k == 0 || head_of(ring[(k - 1) & 3]) != head_of(nx));
        if (warp == 0) {
          const int f = pull();
          if (lane == 0) ring[(k + 2) & 3] = f;
        }
        if constexpr (WG && !MSA) {  // the scaled q rows, for wgmma
          fence_proxy_async();
          __syncthreads();
        }
      }
      // the next step's copies into the other buffer (after the last chunk
      // the next item's q rows, into the other q buffer; ONE: at the next
      // chunk's start)
      if constexpr (!ONE) {
        if (!last)
          copy_step(ring[k & 3], p, j0 + KR, st ^ 1);
        else if (ring[(k + 1) & 3] >= 0)
          copy_step(ring[(k + 1) & 3], p ^ 1, 0, st ^ 1);
      }
      if (!live) continue;
      const T* ks = kvs + st * 2 * KR * LD;
      const T* vs = ks + KR * LD;
      const int cnpt = min(ATT_KCH, npt - j0 / 16);  // 16-key steps here
      // ---- S = q k^T over the chunk's 8-key tiles ------------------------
      float s[2 * ATT_KCH][4];
#pragma unroll
      for (int j = 0; j < 2 * ATT_KCH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if constexpr (WG) {
        // the warpgroup's 64 q rows against the chunk's 64 keys, the
        // k-steps in order, each 16 columns of one 64-column panel
        const T* qw = qs + p * QR * LD + 64 * (warp >> 2) * 64;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < HS / 16; ++kk) {
          if (16 * kk >= hd) break;
          const int c0 = (kk & 3) * 16;
          wg_qk(s, wg_desc_k(qw + (kk >> 2) * QR * 64 + c0),
                wg_desc_k(ks + (kk >> 2) * KR * 64 + c0), kk > 0);
        }
        wg_commit_wait();
        wg_hold(s);
      } else if constexpr (F32) {
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          if (c * KC < hd) {
            if constexpr (ONE) {
              // the lane's PER channels of the chunk (all real or all past
              // hd: hd % 8 == 0), from device memory
              float qa[2][PER];
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                if (qsrc[hh] && c * KC + PER * t < hd) {
                  ld_per<PER, true>(qa[hh], qsrc[hh] + c * KC + PER * t);
                } else {
#pragma unroll
                  for (int pp = 0; pp < PER; ++pp) qa[hh][pp] = 0.f;
                }
              }
              qk_chunk_f32<KC, LD, ATT_KCH, MSA>(s, qa[0], qa[1], ks, c * KC,
                                                 cnpt, scale, g, t);
            } else {
              qk_chunk_f32<KC, LD, ATT_KCH, MSA>(s, &qv[0][c * PER],
                                                 &qv[1][c * PER], ks, c * KC,
                                                 cnpt, scale, g, t);
            }
          }
      } else {
        // The k-steps outermost, q's fragments two k-steps at a time from
        // the tile's staged rows each chunk, so that the q rows hold no
        // registers between chunks (held, they spilled at two blocks an
        // SM). Each score still sums its k-steps in order (the Swin
        // variant's q scaled in place at chunk 0).
        const T* qrow = qs + (qb * QR + 16 * warp + (lane & 15)) * LD;
#pragma unroll
        for (int kk = 0; kk < HS / 16; kk += 2) {
          if (16 * kk >= hd) break;
          uint32_t qc[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (kk + u >= HS / 16) break;
            ldsm_x4(qc[u], qrow + (kk + u) * 16 + (lane >> 4) * 8);
          }
#pragma unroll
          for (int j = 0; j < 2 * ATT_KCH; ++j) {
            if (j < 2 * cnpt) {
              const T* kr = ks + (8 * j + (lane & 7)) * LD;
              if (kk + 1 < HS / 16 && 16 * (kk + 1) < hd) {
                uint32_t kb[4];  // k-steps kk and kk + 1
                ldsm_x4(kb, kr + kk * 16 + (lane >> 3) * 8);
                mma_16816(s[j], qc[0], kb[0], kb[1]);
                mma_16816(s[j], qc[1], kb[2], kb[3]);
              } else {
                uint32_t b0, b1;
                ldsm_x2(b0, b1, kr + kk * 16 + ((lane >> 3) & 1) * 8);
                mma_16816(s[j], qc[0], b0, b1);
              }
            }
          }
        }
      }

      // ---- bias (the slot's table), shift mask, the chunk's max ----------
      float c0 = -INFINITY, c1 = -INFINITY;
      auto scores = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < 2 * ATT_KCH; ++j) {
          const int cj = j0 + 8 * j + 2 * t;
          const int2 cc = *reinterpret_cast<const int2*>(co + min(cj, NP - 2));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = cj + (e & 1);
            float v = -INFINITY;
            if (c < n) {
              float bias = tab[(e < 2 ? ro0 : ro1) - ((e & 1) ? cc.y : cc.x)];
              if constexpr (decltype(masked)::value)
                if ((e < 2 ? l0 : l1) != lb[c]) bias = __fadd_rn(bias, -100.f);
              v = __fadd_rn(MSA ? __fmul_rn(s[j][e], scale) : s[j][e], bias);
            }
            s[j][e] = v;
            if (e < 2)
              c0 = fmaxf(c0, v);
            else
              c1 = fmaxf(c1, v);
          }
        }
      };
      if (mixed)
        scores(std::true_type());
      else
        scores(std::false_type());
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
      if constexpr (WG) {
        // 16 keys a step, in order; v's 64-column panels KR rows apart
        uint32_t pa[ATT_KCH][4];
#pragma unroll
        for (int s2 = 0; s2 < ATT_KCH; ++s2) {
          pa[s2][0] = pack_bf16(s[2 * s2][0], s[2 * s2][1]);
          pa[s2][1] = pack_bf16(s[2 * s2][2], s[2 * s2][3]);
          pa[s2][2] = pack_bf16(s[2 * s2 + 1][0], s[2 * s2 + 1][1]);
          pa[s2][3] = pack_bf16(s[2 * s2 + 1][2], s[2 * s2 + 1][3]);
        }
        wg_fence();
#pragma unroll
        for (int s2 = 0; s2 < ATT_KCH; ++s2) {
          if (s2 >= cnpt) break;
          wg_pv<HS>(acc, pa[s2],
                    wg_desc_mn(vs + 16 * s2 * 64, KR * 64 * sizeof(T)));
        }
        wg_commit_wait();
        wg_hold(acc);
        wg_hold(pa);
      } else if constexpr (F32) {
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
              if (8 * jd >= hd) break;
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
          const T* vr = vs + (16 * s2 + (lane & 15)) * LD;
#pragma unroll
          for (int jd = 0; jd < HS / 8; jd += 2) {
            if (8 * jd >= hd) break;
            if (jd + 1 < HS / 8 && 8 * (jd + 1) < hd) {
              uint32_t vb[4];  // column tiles jd and jd + 1
              ldsm_x4_trans(vb, vr + 8 * jd + (lane >> 4) * 8);
              mma_16816(acc[jd], pa, vb[0], vb[1]);
              mma_16816(acc[jd + 1], pa, vb[2], vb[3]);
            } else {
              uint32_t b0, b1;
              ldsm_x2_trans(b0, b1, vr + 8 * jd);
              mma_16816(acc[jd], pa, b0, b1);
            }
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        l0s += __shfl_xor_sync(0xffffffffu, l0s, o);
        l1s += __shfl_xor_sync(0xffffffffu, l1s, o);
      }
      l0s = 1.f / l0s;
      l1s = 1.f / l1s;
      int h, b, wi, qt;
      decode(ring[k & 3], h, b, wi, qt);
      // the stored rows: real tokens (a pad token's is -1, as a row past n)
      const int p0 = qt * QR + 16 * warp + g, p1 = p0 + 8;
      const int tk0 = p0 < n ? tk[qr[p0]] : -1;
      const int tk1 = p1 < n ? tk[qr[p1]] : -1;
#pragma unroll
      for (int jd = 0; jd < HS / 8; ++jd) {
        if (8 * jd >= hd) break;
        const int col = h * hd + 8 * jd + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int tr = hh ? tk1 : tk0;
          if (tr < 0) continue;
          const float inv = hh ? l1s : l0s;
          const float v0 = acc[jd][2 * hh] * inv,
                      v1 = acc[jd][2 * hh + 1] * inv;
          T* dst = out + (size_t)tr * C + col;
          if constexpr (F32)
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          else
            *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
        }
      }
    }
  }
}

// the streaming kernel's launch: a persistent grid of as many blocks as fit
// the SMs at once, pulling items from the counter `next` (zeroed here, on
// the stream, before the kernel)
template <typename T, bool MSA, int HS>
static int launch_window_attn_stream(const void* qkv, const float* qkv_bias,
                                     const float* rel, void* out, int* next,
                                     int B, int H, int W, int C, int heads,
                                     int hd, int win, int shift, float scale,
                                     cudaStream_t stream) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const size_t smem = window_attn_stream_smem(win, hd, sizeof(T) == 4);
  auto kern = window_attn_stream_kernel<T, HS, MSA>;
  constexpr int threads = 32 * ATT_STREAM_WARPS;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  if (per_sm < 1) return MB_BAD_ARGS;
  const int hp = (H + win - 1) / win * win, wp = (W + win - 1) / win * win;
  const int tpw = (win * win + 16 * ATT_STREAM_WARPS - 1) /
                  (16 * ATT_STREAM_WARPS);
  const long long items =
      (long long)(hp / win) * (wp / win) * heads * B * tpw;
  if (items >= (1ll << 30)) return MB_BAD_ARGS;
  const int grid =
      (int)std::min<long long>(items, (long long)per_sm * sms);  // whole waves
  e = cudaMemsetAsync(next, 0, sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, threads, smem, stream>>>((const T*)qkv, qkv_bias, rel,
                                        (T*)out, next, B, H, W, C, heads, hd,
                                        win, shift, scale);
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
  if constexpr (HD <= 64)  // the wide heads (f32): one instance of 8 warps
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

// the bf16 ring kernel up to 128 tokens (the flagship widths and those
// over 64): a persistent grid of as many blocks as fit the SMs at once,
// walking the items
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

// up to 128 tokens: the ring kernel in bf16 at the flagship widths and at
// those over 64, the head-width kernel otherwise (and every width in f32);
// above, the long-window kernel
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
    if constexpr (sizeof(T) == 2 && (staged_dim(HD) == HD || HD > 64))
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

// The streaming kernel's launch (attn_stream_*.cu): windows of 129 to 1024
// tokens at any head width hd % 8 == 0 up to 128, and any window up to
// 1024 tokens at head widths 136-256, staged at stream_dim(hd)
// (windows up to 256 tokens at head widths up to 64 take the long-window
// kernel above; ops/swin_block.py::attn_route chooses). f32 nonzero for f32
// qkv and out, else bf16.
template <bool MSA>
static int launch_window_attn_streamed(const void* qkv,
                                       const float* qkv_bias,
                                       const float* rel, void* out,
                                       int* next, int B, int H, int W, int C,
                                       int heads, int win, int shift,
                                       float scale, int f32,
                                       cudaStream_t stream) {
  const int NP = (win * win + 15) / 16 * 16;
  if (!next || C % heads || win < 1 || win * win > ATT_STREAM_TOKENS)
    return MB_BAD_ARGS;
  const int hd = C / heads;
  // up to head width 128 over 128 tokens: at least three chunks, which the
  // two-buffer schedule of its q rows needs (HS 256's schedule takes any)
  if (hd % 8 || hd > 256 || (hd <= 128 && NP <= 16 * ATT_MAX_NPT) ||
      (hd <= 64 && NP <= 16 * ATT_LONG_MAX_NPT))
    return MB_BAD_ARGS;
  const int hs = stream_dim(hd);
  auto go = [&](auto tag, auto hs_tag) {
    using T = decltype(tag);
    return launch_window_attn_stream<T, MSA, decltype(hs_tag)::value>(
        qkv, qkv_bias, rel, out, next, B, H, W, C, heads, hd, win, shift,
        scale, stream);
  };
  using I16 = std::integral_constant<int, 16>;
  using I32 = std::integral_constant<int, 32>;
  using I64 = std::integral_constant<int, 64>;
  using I128 = std::integral_constant<int, 128>;
  using I256 = std::integral_constant<int, 256>;
  if (f32)
    return hs == 16 ? go(float(), I16()) : hs == 32 ? go(float(), I32())
         : hs == 64 ? go(float(), I64()) : hs == 128 ? go(float(), I128())
         : go(float(), I256());
  return hs == 16 ? go(bf16(), I16()) : hs == 32 ? go(bf16(), I32())
       : hs == 64 ? go(bf16(), I64()) : hs == 128 ? go(bf16(), I128())
       : go(bf16(), I256());
}
