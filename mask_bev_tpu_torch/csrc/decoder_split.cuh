// Kernel 5's split-query instance: every Mask2Former decoder layer of the
// final_only path for the shapes the flagship instance (csrc/decoder_stack.cu)
// does not take: f32, more than 48 queries (up to 1024), any head count up
// to head width 256 (one head up to C 512), a mask embedding of any width.
//
// Replaces mask_bev_tpu/ops/pallas_decoder_stack.py::fused_decoder_stack
// (_stack_kernel), as the flagship instance does. One body, two kernels:
// decoder_split_tc_kernel keeps a block's rows in shared memory (at most 32
// rows, the embedding at C, one head up to C 256 or head widths 8-64);
// decoder_split_gen_kernel takes the rest (GEN: rows in a device-memory
// workspace, a wider embedding, head widths 128 and 256 over any heads, one
// head of C 512), so that the first compiles as it did before the second
// existed. The instances compile in six sources, three a type
// (decoder_split_<t>.cu: decoder_split_tc_kernel; decoder_split_<t>_gen.cu
// and decoder_split_<t>_gen_slices.cu: decoder_split_gen_kernel at head
// widths 8-64 and with column slices), beside the C entry
// (decoder_split.cu), so that the build runs them in parallel.
#pragma once

#include "decoder_common.cuh"

// The flagship instance keeps a replica of the (Q, C) state in every block
// of the cluster, which caps Q at 48 and the operands at bf16. Here block r
// of a cluster of cs blocks owns query rows [r R, (r + 1) R), R = ceil(Q /
// cs), of the state X and of the intermediates XA, QB, OB (f32, row stride
// C + 16). A block owns at most DS2_RG = 32 rows (the cross-attention's two
// 16-row tiles): cs = 8 up to Q = 256, then cs = 16 (a non-portable cluster
// size the H100 schedules) up to Q = 512 (Deformable DETR's 300 queries).
// The GEN kernel takes up to DS2_MAXR = 64 rows a block (Q = 1024): its
// products, mask bits and cross-attention take them in groups of DS2_RG
// rows (a group streams the weights and keys again); where four buffers of
// R rows pass a block's shared memory (over 32 rows a block, or a wide C),
// they and the self-attention's own k rows live in a device-memory
// workspace, a region a block (Ds2LayoutG::glob; the other blocks read its
// k and v there, after a fence and the cluster's barrier). T is the
// operand type: every product takes T-rounded operands with f32
// accumulation (bf16: as the flagship; f32: nothing rounded), as the TPU
// kernel's _dot does.
//
// What bounds it on the H100: at Q = 45 (R = 6) and Q = 170 (R = 22) a
// block's rows are few, so every product is a stream of weights (or keys)
// past a handful of rows: ~1.6 M weights of the layer per block, every key
// of the level (up to 3969 x 256) three times, read by each of the 8 blocks
// of a cluster from L2; the 3xTF32 operations of batch 8 take ~0.3 ms (Q =
// 45) and ~0.65 ms (Q = 170) at 495 TFLOP/s. The first version ran every
// product as f32 FMAs with one thread per output column (R FMAs per weight
// load) or per (row, head) (48 of 256 threads busy in cross-attention at Q
// = 45, each walking all keys twice), so latency and idle lanes ruled it.
// This design puts the products on the tensor cores with mma.sync:
//   * f32: 3xTF32 m16n8k8, both operands split in registers into TF32
//     halves (common.cuh::split_tf32: lo.hi + hi.lo + hi.hi; a single TF32
//     pass would move the m < 0 decisions); bf16: m16n8k16;
//   * dense products, the FFN (in chunks of C hidden units) and the mask
//     MLP as W^T . A^T: the weight's output columns on the MMA's 16-row
//     side, the block's rows on its 8-wide side (R = 6 pads to 8, R = 22 to
//     24); one warp per 16 output columns, the weights (packed (N, K),
//     K-contiguous) loaded straight into fragments, 16 bytes a lane, four
//     32-deep chunks in flight;
//   * inside each 32-deep chunk k is permuted alike in both operands (lane
//     t holds k0 + 4t.. and k0 + 16 + 4t.. in f32, k0 + 8t.. in bf16), so
//     every fragment is one 16-byte load and the sums are unchanged;
//   * mask bits emb . feat^T < 0 the same way, 32 keys a warp task (two
//     16-key tiles against the rows), 3xTF32 in both instances (the f32
//     features; the embedding holds T values), the bits gathered by three
//     shuffles;
//   * cross-attention split across warps by (head, key slice): the rows on
//     the MMA's 16-row side, 32-key tiles of k and v staged by cp.async
//     (pass 1's k tiles double-buffered, pass 2's k and v where the shared
//     memory holds two buffers: Q = 45, not Q = 170), S = q k^T in
//     registers with the mask bits applied there; pass 1 the exact row max
//     and sum, combined across a head's warps in shared memory; pass 2 P =
//     rd_T(exp(s - M) / L) from the S registers as the A operand of P v
//     (exp and 1 / L on the special-function unit), the slices' partial
//     outputs summed in order; the hi.hi and small 3xTF32 terms go to two
//     accumulators, so each output tile has two chains of MMAs;
//   * heads: 2, 4 and 8 split the 8 warps into (head, key slice); 16 or 32
//     run as rounds of 8 heads, one a warp, each round streaming the keys
//     again; one head (head width C, up to 512) and (GEN) head widths 128
//     and 256 split a head's output columns over the 8 warps (NCS = 8
//     column slices: each warp computes the whole score tile, and P v for
//     its HD / 8 columns), GEN a round a head with the key tiles staged at
//     the head's columns only, so no warp holds HD accumulators;
//   * the mask embedding: where its width D is C it lives in OB; a wider
//     one (De, a multiple of 32; GEN) in a device-memory buffer E of (B, Q,
//     De) f32 (generic loads and stores: the GEN products read and write
//     either memory), the mask MLP's last layer (De, C) and the features at
//     De; a narrower one is zero-padded to C by the caller, which changes no
//     bit;
//   * self-attention (22 x 170 scores a head at Q = 170) stays on FMAs, one
//     head at a time over every block's k, then v, through distributed
//     shared memory (16-byte remote loads, 8 in flight a thread); where the
//     (R, Q) scores and a head's (Q, hd) keys do not fit beside the rest
//     (Q = 512), over chunks of QC keys: a first sweep takes each row's max
//     and sum (rescaled chunk by chunk), a second the probabilities and P v
//     (the keys' chunk gathered again);
//   * the dense products, the mask bits and cross-attention are functions
//     that are not inlined, so each gets the registers to itself (inlined
//     into one kernel body they spilled);
//   * every other width runs padded (ops/decoder_stack.py::split_padding):
//     a head's width to the next instance, the heads to a count the warps
//     split, the FFN to whole chunks of C, with zero weights, biases and LN
//     affine on the padded columns, so that they stay exact zeros through
//     every product, softmax and residual; the LNs walk only the nh x ht
//     true columns (the centred variance would count the padded zeros), a
//     column c being true where c / HD < nh and c % HD < ht.
// Measured: with its arithmetic skipped, cross-attention runs ~5x faster;
// with its key loads skipped, ~1.2x. Its instructions and their latency,
// not its bytes, set its pace, and it is half the kernel's time (PERF.md).
#define DS2_THREADS 256
#define DS2_WARPS (DS2_THREADS / 32)
#define DS2_RG 32    // rows a block (group) owns at most (Q <= 8 x 32, 16 x 32)
#define DS2_MAXR 64  // rows a GEN block owns at most (Q <= 16 x 64)
#define DS2_TK 32    // keys a tile
#define DS2_PF 4     // 32-deep weight chunks in flight per warp (dense)
// parts of a layer timed by ``prof`` (ns of %globaltimer, summed over the
// layers, per block): mask bits, q projection, cross-attention, out
// projection + LN1, self-attention (projections, attention, LN2), FFN +
// LN3, decoder norm + mask MLP
#define DS2_PARTS 7

__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

#define DS2_SMEM_LIMIT (227 * 1024)  // shared memory a block may use

// blocks of a cluster: 8 while a block's rows fit DS2_RG, else 16
__host__ __device__ inline int ds2_cluster(int Q) {
  return (Q + 7) / 8 <= DS2_RG ? 8 : 16;
}

// whether the cross-attention splits a head's output columns over the 8
// warps (NCS = 8, one head a round) rather than the warps over the heads:
// one head, or head widths over 64
__host__ __device__ inline bool ds2_column_slices(int heads, int hd) {
  return heads == 1 || hd > 64;
}

struct Ds2Layout {
  int cs, R, ld, wl, Q, C, heads, hd;
  // offsets in floats from the start of shared memory
  int X, XA, QB, OB, MK, FL, U;
  // in the union U: the cross-attention's key-tile slots (SL floats each:
  // k or v of 32 keys), the bf16 q copy QT and the (max, sum) exchange ST;
  // nb1: the buffers of pass 1 (k and v), 2 where they fit, else 1 (pass 0
  // always double-buffers its k tiles)
  int SL, nb1, QT, ST;
  // the self-attention's keys a chunk: Q (one sweep) where its (R, Q)
  // scores and a head's (Q, hd + 1) k or v fit, else a multiple of 32
  int QC;
  int total;
};

__host__ __device__ inline int ds2_al(int n) { return (n + 3) / 4 * 4; }

// ld = C + 16: 64 bytes mod 128, so that 16-byte fragment loads (lane (g,
// t) at row g, column 4t) hit 32 distinct banks. The f32 k tile has the
// same stride; the f32 v tile C + 4 (its fragments read rows 2t, 2t + 1 at
// column g); the bf16 tiles C + 8 (ldmatrix rows 16 bytes apart mod 128).
__host__ __device__ inline Ds2Layout ds2_layout(int Q, int C, int heads,
                                                int tmax, bool f32) {
  Ds2Layout L;
  L.Q = Q; L.C = C; L.heads = heads; L.hd = C / heads;
  L.cs = ds2_cluster(Q);
  L.R = (Q + L.cs - 1) / L.cs;
  L.ld = C + 16;
  L.wl = (tmax + 31) / 32;
  const int rx = L.R * L.ld;
  const int rp = 16 * ((L.R + 15) / 16);  // rows padded to 16-row tiles
  L.X = 0; L.XA = rx; L.QB = 2 * rx; L.OB = 3 * rx;
  L.MK = 4 * rx;
  L.FL = L.MK + ds2_al(L.R * L.wl);
  L.U = L.FL + ds2_al(L.R);
  L.SL = f32 ? DS2_TK * (C + 16) : DS2_TK * (C + 8) / 2;
  const int qt = f32 ? 0 : rp * (C + 8) / 2;
  L.QC = Q;
  int self = rx + Q * (L.hd + 1) + L.R * Q, cross = 0;
  for (L.nb1 = 2; L.nb1 >= 1; --L.nb1) {
    L.QT = L.U + 2 * L.nb1 * L.SL;
    L.ST = L.QT + qt;
    cross = L.ST + 2 * DS2_WARPS * rp - L.U;
    L.total = L.U + ds2_al(cross > self ? cross : self);
    if (L.total * 4 <= DS2_SMEM_LIMIT) break;
  }
  if (L.nb1 == 0) L.nb1 = 1;
  if (L.total * 4 > DS2_SMEM_LIMIT) {
    // the self-attention's keys in chunks of QC, the most that fit
    const int room = DS2_SMEM_LIMIT / 4 - L.U - rx;
    const int qc = room / (L.hd + 1 + L.R) / 32 * 32;
    if (qc >= 32 && qc < Q) {
      L.QC = qc;
      self = rx + qc * (L.hd + 1) + L.R * qc;
      L.total = L.U + ds2_al(cross > self ? cross : self);
    }
  }
  return L;
}

// The GEN kernel's layout: ds2_layout's where a block's rows fit it (at
// most DS2_RG rows, in shared memory), else (glob) the four row buffers and
// the own k rows in the block's region of a device-memory workspace (5 R ld
// floats a block, at offsets X, XA, QB, OB, KO) and in shared memory the
// mask bits, the row flags and the union; and wherever ds2_column_slices,
// the key tiles staged at a head's columns (SW = hd).
struct Ds2LayoutG : Ds2Layout {
  int glob, KO;  // KO: the own k rows (U where they are in shared memory)
};

__host__ __device__ inline Ds2LayoutG ds2_layout_gen(int Q, int C, int heads,
                                                     int tmax, bool f32) {
  Ds2LayoutG L;
  L.Q = Q; L.C = C; L.heads = heads; L.hd = C / heads;
  L.cs = ds2_cluster(Q);
  L.R = (Q + L.cs - 1) / L.cs;
  L.ld = C + 16;
  L.wl = (tmax + 31) / 32;
  const int sw = ds2_column_slices(heads, L.hd) ? L.hd : C;
  const int rx = L.R * L.ld;
  const int rg = L.R < DS2_RG ? L.R : DS2_RG;
  const int rp = 16 * ((rg + 15) / 16);  // a group's rows padded to 16
  L.SL = f32 ? DS2_TK * (sw + 16) : DS2_TK * (sw + 8) / 2;
  const int qt = f32 ? 0 : rp * (C + 8) / 2;
  for (L.glob = L.R > DS2_RG; L.glob <= 1; ++L.glob) {
    const int kown = L.glob ? 0 : rx;  // own k rows in shared memory
    L.X = 0; L.XA = rx; L.QB = 2 * rx; L.OB = 3 * rx;
    L.MK = L.glob ? 0 : 4 * rx;
    L.FL = L.MK + ds2_al(L.R * L.wl);
    L.U = L.FL + ds2_al(L.R);
    L.KO = L.glob ? 4 * rx : L.U;
    L.QC = Q;
    int self = kown + Q * (L.hd + 1) + L.R * Q, cross = 0;
    for (L.nb1 = 2; L.nb1 >= 1; --L.nb1) {
      L.QT = L.U + 2 * L.nb1 * L.SL;
      L.ST = L.QT + qt;
      cross = L.ST + 2 * DS2_WARPS * rp - L.U;
      L.total = L.U + ds2_al(cross > self ? cross : self);
      if (L.total * 4 <= DS2_SMEM_LIMIT) break;
    }
    if (L.nb1 == 0) L.nb1 = 1;
    if (L.total * 4 > DS2_SMEM_LIMIT) {
      const int room = DS2_SMEM_LIMIT / 4 - L.U - kown;
      const int qc = room / (L.hd + 1 + L.R) / 32 * 32;
      if (qc >= 32 && qc < Q) {
        L.QC = qc;
        self = kown + qc * (L.hd + 1) + L.R * qc;
        L.total = L.U + ds2_al(cross > self ? cross : self);
      }
    }
    if (L.total * 4 <= DS2_SMEM_LIMIT) break;
  }
  if (L.glob > 1) L.glob = 1;
  return L;
}

// whether decoder_split_tc_kernel takes these shapes (else the GEN kernel):
// at most DS2_RG rows a block in its shared memory, the embedding at C, and
// one head up to C 256 or head widths 8-64 over heads the warps split
__host__ __device__ inline bool ds2_shared_takes(const Ds2Layout& L,
                                                 bool wide_emb) {
  return !wide_emb && L.R <= DS2_RG && L.total * 4 <= DS2_SMEM_LIMIT &&
         (L.heads == 1 ? L.C <= 256 : L.hd <= 64);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint4 lds16(const float* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// acc[mt][nt] += W[m-tile mt] . B[n-tile nt]^T over k < K (K % 32 == 0):
// MT tiles of 16 rows of W (rows w0 + 16 mt.., K-contiguous in device
// memory with row stride ldw; rows >= wrows read as 0), NT <= 4 tiles of 8
// rows of B (f32 in shared memory holding values of T, row stride ldb; rows
// >= nb read as 0). f32: 3xTF32 m16n8k8 (W's fragment words split like
// B's); bf16: m16n8k16. Inside each 32-deep chunk, k is permuted alike in
// both operands: f32 lane t holds k0 + 4t.. and k0 + 16 + 4t.. of rows g
// and g + 8 (four 16-byte loads), bf16 k0 + 8t.. (two); D chunks of W are
// in flight.
template <typename T, int MT, int D>
__device__ __forceinline__ void tc_core(float (&acc)[MT][4][4],
                                        const T* __restrict__ W, int ldw,
                                        int w0, int wrows, const float* B,
                                        int ldb, int nb, int NT, int K) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int WV = F32 ? 4 : 2;  // 16-byte words a lane, a chunk, a tile
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* wr[MT][2];
  bool win[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = w0 + 16 * mt + g + 8 * hh;
      win[mt][hh] = r < wrows;
      wr[mt][hh] = W + (size_t)(win[mt][hh] ? r : 0) * ldw + (F32 ? 4 : 8) * t;
    }
  uint4 w[D][MT][WV];
  auto load = [&](uint4 (&x)[MT][WV], int k0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint4 z = make_uint4(0u, 0u, 0u, 0u);
        if constexpr (F32) {
          x[mt][2 * hh] = win[mt][hh] ? ldg16(wr[mt][hh] + k0) : z;
          x[mt][2 * hh + 1] = win[mt][hh] ? ldg16(wr[mt][hh] + k0 + 16) : z;
        } else {
          x[mt][hh] = win[mt][hh] ? ldg16(wr[mt][hh] + k0) : z;
        }
      }
  };
  auto step = [&](const uint4 (&x)[MT][WV], int k0) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt >= NT) break;
      const int br = 8 * nt + g;
      const float* bp = B + br * ldb + k0 + (F32 ? 4 : 8) * t;
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      const uint4 b0 = br < nb ? lds16(bp) : z;
      const uint4 b1 = br < nb ? lds16(bp + (F32 ? 16 : 4)) : z;
      if constexpr (F32) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const uint4& bv = hf ? b1 : b0;
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const uint32_t a[4] = {
                  word(x[mt][hf], 2 * s), word(x[mt][2 + hf], 2 * s),
                  word(x[mt][hf], 2 * s + 1), word(x[mt][2 + hf], 2 * s + 1)};
              mma_3xtf32(acc[mt][nt], a, word(bv, 2 * s), word(bv, 2 * s + 1));
            }
        }
      } else {
        const uint32_t p[4] = {
            pack_bf16(__uint_as_float(b0.x), __uint_as_float(b0.y)),
            pack_bf16(__uint_as_float(b0.z), __uint_as_float(b0.w)),
            pack_bf16(__uint_as_float(b1.x), __uint_as_float(b1.y)),
            pack_bf16(__uint_as_float(b1.z), __uint_as_float(b1.w))};
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint32_t a[4] = {word(x[mt][0], 2 * s), word(x[mt][1], 2 * s),
                                   word(x[mt][0], 2 * s + 1),
                                   word(x[mt][1], 2 * s + 1)};
            mma_16816(acc[mt][nt], a, p[2 * s], p[2 * s + 1]);
          }
      }
    }
  };
  const int nc = K / 32;
#pragma unroll
  for (int i = 0; i < D; ++i)
    if (i < nc) load(w[i], 32 * i);
  for (int c0 = 0; c0 < nc; c0 += D) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int c = c0 + i;
      if (c < nc) {
        step(w[i], 32 * c);
        if (c + D < nc) load(w[i], 32 * (c + D));
      }
    }
  }
}

// dst[r][n] = epi(sum_k A[r][k] Wt[n][k] (+ bias[n]) (+ dst[r][n] when
// accum)) for r < nr <= DS2_RG, n < N (N % 16 == 0): one warp per 16 output
// columns. A (row stride ld) and dst (row stride ldd), Wt (N, K) row
// stride ldw.
template <typename T>
__device__ __forceinline__ void tc_dense_body(const float* A, int ld, int nr,
                                              int K, const T* __restrict__ Wt,
                                              int ldw, int N,
                                              const float* __restrict__ bias,
                                              float* dst, int ldd, int mode,
                                              bool accum) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int NT = (nr + 7) / 8;
  if (nr > 0) {
    for (int m0 = 16 * warp; m0 < N; m0 += 16 * DS2_WARPS) {
      float acc[1][4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][nt][e] = 0.f;
      tc_core<T, 1, DS2_PF>(acc, Wt, ldw, m0, N, A, ld, nr, NT, K);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt >= NT) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * nt + 2 * t + (e & 1);
          const int n = m0 + g + 8 * (e >> 1);
          if (r >= nr) continue;
          float* o = dst + r * ldd + n;
          float v = acc[0][nt][e];
          if (accum) v = __fadd_rn(*o, v);
          if (bias) v = __fadd_rn(v, bias[n]);
          if (mode == EPI_RELU_RD) v = rd<T>(fmaxf(v, 0.f));
          else if (mode == EPI_RD) v = rd<T>(v);
          *o = v;
        }
      }
    }
  }
  __syncthreads();
}

// tc_dense_body with dst at A's row stride (A and dst in shared memory)
template <typename T>
__device__ __noinline__ void tc_dense(const float* A, int ld, int nr, int K,
                         const T* __restrict__ Wt, int ldw, int N,
                         const float* __restrict__ bias, float* dst, int mode,
                         bool accum) {
  tc_dense_body<T>(A, ld, nr, K, Wt, ldw, N, bias, dst, ld, mode, accum);
}

// tc_dense_body for the GEN kernel (A and dst in shared or device memory)
template <typename T>
__device__ __noinline__ void tc_dense_ld(const float* A, int ld, int nr,
                                         int K, const T* __restrict__ Wt,
                                         int ldw, int N,
                                         const float* __restrict__ bias,
                                         float* dst, int ldd, int mode,
                                         bool accum) {
  tc_dense_body<T>(A, ld, nr, K, Wt, ldw, N, bias, dst, ldd, mode, accum);
}

// a block's nr rows through tc_dense (nr <= DS2_RG), or (GEN) tc_dense_ld
// in groups of DS2_RG rows (each group streams the weights again)
template <typename T, bool GEN>
__device__ __forceinline__ void ds2_dense(const float* A, int ld, int nr,
                                          int K, const T* __restrict__ Wt,
                                          int ldw, int N,
                                          const float* __restrict__ bias,
                                          float* dst, int ldd, int mode,
                                          bool accum) {
  if constexpr (!GEN) {
    tc_dense<T>(A, ld, nr, K, Wt, ldw, N, bias, dst, mode, accum);
  } else {
    int r0 = 0;
    do {
      tc_dense_ld<T>(A + r0 * ld, ld, min(DS2_RG, nr - r0), K, Wt, ldw, N,
                     bias, dst + r0 * ldd, ldd, mode, accum);
      r0 += DS2_RG;
    } while (r0 < nr);
  }
}

// Mask bits emb . feat^T < 0 of nr <= DS2_RG rows (OB, row stride ld; in
// the GEN kernel a group's rows of the embedding, C or De columns, in
// shared or device memory) against the T_ keys (feat (T_, C), f32) into MK
// (row stride wl words): a warp task is one 32-key word, two 16-key tiles
// against the row tiles.
// Not inlined: it gets the kernel's registers to itself.
// (static: the header is compiled in seven sources)
static __device__ __noinline__ void ds2_mask_bits(
    const float* __restrict__ feat, int T_, int C, const float* OB, int ld,
    int nr, unsigned* MK, int wl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int NT = (nr + 7) / 8;
  if (nr > 0) {
    const int nw = (T_ + 31) / 32;
    for (int w = warp; w < nw; w += DS2_WARPS) {
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      tc_core<float, 2, 2>(acc, feat, C, 32 * w, T_, OB, ld, nr, NT, C);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt >= NT) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          unsigned v = 0u;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int kb = 16 * mt + 8 * hh + g;
              if (32 * w + kb < T_ && acc[mt][nt][2 * hh + e] < 0.f)
                v |= 1u << kb;
            }
          v |= __shfl_xor_sync(0xffffffffu, v, 4);
          v |= __shfl_xor_sync(0xffffffffu, v, 8);
          v |= __shfl_xor_sync(0xffffffffu, v, 16);
          const int r = 8 * nt + 2 * t4 + e;
          if (g == 0 && r < nr) MK[r * wl + w] = v;
        }
      }
    }
  }
}

// Masked cross-attention of nr <= DS2_RG rows over the T_ keys of a level
// (k and v rows of stride ldkv), from q in QB into OB (row stride ld; XA,
// the f32 q copy, alike), with the rows' mask bits MK (row stride wl words)
// and row flags: the block's rows in shared memory, or (GEN) a group's
// rows in shared or device memory. q scaled and
//    rounded to T: f32 into XA, bf16 into the copy QT (16-row tiles,
//    rows past nr zero). Warp (h, sl) takes column tiles j0.. of each
//    32-key tile; pass 0 the row max and sum (k tiles double-buffered),
//    pass 1 the weighted v (k and v tiles in nb1 buffers). More than 8
//    heads run in rounds of 8 (a warp a head); NCS = 8 (ds2_column_slices:
//    one head, or head widths over 64): warp w takes every column tile and
//    the output columns [w OD, (w + 1) OD) of the head, OD = HD / NCS; GEN
//    a round a head, the key tiles staged at the head's HD columns only.
template <typename T, int HD, int NCS, bool GEN>
__device__ __forceinline__ void ds2_cross_attn_body(
    float* sm, const Ds2Layout Ly, int nr, int T_, const T* __restrict__ Kb,
    const T* __restrict__ Vb, int ldkv, float scale, float* XA_,
    const float* QB_, float* OB_, const unsigned* MK_, const int* flag_) {
  constexpr bool F32 = sizeof(T) == 4;
  const int C = Ly.C, heads = Ly.heads, ld = Ly.ld, wl = Ly.wl;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int MTQ = (nr + 15) / 16,
            rp = 16 * (((GEN && Ly.R > DS2_RG ? DS2_RG : Ly.R) + 15) / 16);
  // GEN: the group's rows given; else the block's, in shared memory
  float* XA = GEN ? XA_ : sm + Ly.XA;
  const float* QB = GEN ? QB_ : sm + Ly.QB;
  float* OB = GEN ? OB_ : sm + Ly.OB;
  const unsigned* MK =
      GEN ? MK_ : reinterpret_cast<const unsigned*>(sm + Ly.MK);
  const int* flag = GEN ? flag_ : reinterpret_cast<const int*>(sm + Ly.FL);
  float* ST = sm + Ly.ST;  // (max, sum) per warp and padded row
  // warp = (head h, key slice sl); a slice takes njw of a tile's four
  // 8-key column tiles. hw heads a round; NCS = 8: one head a round, one
  // slice, warp w its output columns' slice cw
  constexpr int OD = HD / NCS;
  const int hw = NCS > 1 ? DS2_WARPS : (heads < DS2_WARPS ? heads : DS2_WARPS);
  const int nsl = DS2_WARPS / hw, sl = warp / hw;
  const int rounds = NCS > 1 ? (GEN ? heads : 1) : heads / hw;
  const int cw = NCS > 1 ? warp : 0;
  const int njw = 4 / nsl, j0 = sl * njw;
  bf16* qt = reinterpret_cast<bf16*>(sm + Ly.QT);
  const int ldq = C + 8;
  for (int i = tid; i < (F32 ? nr : rp) * C; i += DS2_THREADS) {
    const int m = i / C, c = i % C;
    const float v = m < nr ? rd<T>(QB[m * ld + c] * scale) : 0.f;
    if constexpr (F32)
      XA[m * ld + c] = v;
    else
      qt[m * ldq + c] = __float2bfloat16_rn(v);
  }
  // row strides of the tiles: f32 k SW + 16, v SW + 4; bf16 both SW + 8
  // (SW: the staged width, C, or GEN with NCS = 8 a head's HD)
  const int SW = GEN && NCS > 1 ? HD : C;
  const int ldk = F32 ? SW + 16 : SW + 8, ldv = F32 ? SW + 4 : SW + 8;
  // staging: a key row is cv 16-byte chunks of the columns from kh (GEN:
  // the round's head where NCS = 8; else 0); thread tid takes chunk tid %
  // cv of rows tid / cv + rs i (GEN over 256 chunks a row: chunks tid +
  // 256 j of every row)
  const int cv = F32 ? SW / 4 : SW / 8;
  const bool wide = GEN && cv > DS2_THREADS;
  const int rs = wide ? 1 : DS2_THREADS / cv, sr0 = wide ? 0 : tid / cv;
  const int cc0 = wide ? tid : tid % cv, cstep = wide ? DS2_THREADS : cv;
  const int sc = cc0 * (F32 ? 4 : 8);
  int kh = 0;
  auto slot = [&](int i) { return sm + Ly.U + i * Ly.SL; };
  auto stage = [&](int t0, float* kd, float* vd) {
    if constexpr (GEN) {
      for (int tt = sr0; tt < DS2_TK; tt += rs)
        for (int cc = cc0; cc < cv; cc += cstep) {
          const int sg = cc * (F32 ? 4 : 8);
          const bool in = t0 + tt < T_;
          const size_t gr = (size_t)(t0 + tt) * ldkv + kh + sg;
          T* kp = reinterpret_cast<T*>(kd) + tt * ldk + sg;
          T* vp = vd ? reinterpret_cast<T*>(vd) + tt * ldv + sg : nullptr;
          if (in) {
            cp_async16(kp, Kb + gr);
            if (vp) cp_async16(vp, Vb + gr);
          } else {
            *reinterpret_cast<uint4*>(kp) = make_uint4(0u, 0u, 0u, 0u);
            if (vp)
              *reinterpret_cast<uint4*>(vp) = make_uint4(0u, 0u, 0u, 0u);
          }
        }
    } else {
      for (int tt = sr0; tt < DS2_TK; tt += rs) {
        const bool in = t0 + tt < T_;
        const size_t gr = (size_t)(t0 + tt) * ldkv + sc;
        T* kp = reinterpret_cast<T*>(kd) + tt * ldk + sc;
        T* vp = vd ? reinterpret_cast<T*>(vd) + tt * ldv + sc : nullptr;
        if (in) {
          cp_async16(kp, Kb + gr);
          if (vp) cp_async16(vp, Vb + gr);
        } else {
          *reinterpret_cast<uint4*>(kp) = make_uint4(0u, 0u, 0u, 0u);
          if (vp) *reinterpret_cast<uint4*>(vp) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    cp_async_commit();
  };
  for (int round = 0; round < rounds; ++round) {
    const int h = NCS > 1 ? (GEN ? round : 0) : round * hw + warp % hw;
    // the head's first column in q and the output, and in the key tiles
    const int qo = h * HD, ko = GEN && NCS > 1 ? 0 : qo;
    if constexpr (GEN && NCS > 1)
      kh = h * HD;  // (the last round's tiles are read: the slices' sum
                    // below ends in a barrier)
    // the warp publishing slice s of this warp's head in ST
    auto slice_warp = [&](int s) {
      return NCS > 1 ? warp : s * hw + warp % hw;
    };
    // f32: P v's hi.hi products in o, its small terms in ox (two chains of
    // dependent MMAs per output tile instead of one)
    float o[2][OD / 8][4], ox[F32 ? 2 : 1][OD / 8][4];
    float mx[2][2], ls[2][2];
    bool clr[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * mt + g + 8 * hh;
        mx[mt][hh] = -INFINITY;
        ls[mt][hh] = 0.f;
        clr[mt][hh] = r < nr && flag[r] != 0;
      }
#pragma unroll
      for (int jd = 0; jd < OD / 8; ++jd)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[mt][jd][e] = 0.f;
          if constexpr (F32) ox[mt][jd][e] = 0.f;
        }
    }
    for (int pass = 0; pass < 2; ++pass) {
      if (pass == 1 && MTQ > 0) {
        // combine the slices' row max and sum (every warp of the head
        // combines them alike, in slice order)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 16 * mt + g + 8 * hh;
            if (mt >= MTQ) continue;
            float M = -INFINITY, Ls = 0.f;
            for (int s = 0; s < nsl; ++s)
              M = fmaxf(M, ST[(2 * slice_warp(s)) * rp + r]);
            for (int s = 0; s < nsl; ++s) {
              const float ms = ST[(2 * slice_warp(s)) * rp + r];
              if (ms > -INFINITY)
                Ls += ST[(2 * slice_warp(s) + 1) * rp + r] * expf(ms - M);
            }
            mx[mt][hh] = M;
            ls[mt][hh] = Ls;
          }
      }
      // pass 0: buffer b is slot b (k); pass 1: slots 2b, 2b + 1 (k, v)
      const int nbuf = pass == 0 ? 2 : Ly.nb1;
      auto kslot = [&](int b) { return slot(pass == 0 ? b : 2 * b); };
      auto vslot = [&](int b) { return pass == 0 ? nullptr : slot(2 * b + 1); };
      stage(0, kslot(0), vslot(0));
      for (int it = 0; DS2_TK * it < T_; ++it) {
        const int t0 = DS2_TK * it, cur = nbuf == 2 ? (it & 1) : 0;
        const bool more = t0 + DS2_TK < T_;
        if (more && nbuf == 2) {
          stage(t0 + DS2_TK, kslot(cur ^ 1), vslot(cur ^ 1));
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // the tile (and q) are in place
        const float* Kf = kslot(cur);
        const float* Vf = vslot(cur);
        const bf16* Kh = reinterpret_cast<const bf16*>(Kf);
        const bf16* Vh = reinterpret_cast<const bf16*>(Vf);
        if (MTQ > 0) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt >= MTQ) break;
            float s[4][4], sx[4][4];  // f32: hi.hi and the small terms
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[j][e] = sx[j][e] = 0.f;
            if constexpr (F32 && HD == 8) {
              // one 8-deep step: lane t4 holds k 2 t4 and 2 t4 + 1 (logical
              // t4 and t4 + 4) of q and k alike
              const int k0 = qo + 2 * t4, kt = ko + 2 * t4;
              const int r0 = 16 * mt + g;
              const float2 z = make_float2(0.f, 0.f);
              const float2 q0 =
                  r0 < nr ? *reinterpret_cast<const float2*>(XA + r0 * ld + k0)
                          : z;
              const float2 q8 =
                  r0 + 8 < nr
                      ? *reinterpret_cast<const float2*>(XA + (r0 + 8) * ld + k0)
                      : z;
              const uint32_t a[4] = {__float_as_uint(q0.x), __float_as_uint(q8.x),
                                     __float_as_uint(q0.y), __float_as_uint(q8.y)};
              const Tf32x2<4> as = split_frag(a);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (j >= njw) break;
                const float2 kv = *reinterpret_cast<const float2*>(
                    Kf + (8 * (j0 + j) + g) * ldk + kt);
                const uint32_t b[2] = {__float_as_uint(kv.x),
                                       __float_as_uint(kv.y)};
                const Tf32x2<2> bs = split_frag(b);
                mma_1688_tf32(sx[j], as.lo, bs.hi[0], bs.hi[1]);
                mma_1688_tf32(sx[j], as.hi, bs.lo[0], bs.lo[1]);
                mma_1688_tf32(s[j], as.hi, bs.hi[0], bs.hi[1]);
              }
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  s[j][e] = __fadd_rn(s[j][e], sx[j][e]);
            } else if constexpr (F32) {
#pragma unroll
              for (int kc = 0; kc < HD / 16; ++kc) {
                const int k0 = qo + 16 * kc + 4 * t4;
                const int kt = ko + 16 * kc + 4 * t4;
                const int r0 = 16 * mt + g;
                const uint4 z = make_uint4(0u, 0u, 0u, 0u);
                const uint4 q0 = r0 < nr ? lds16(XA + r0 * ld + k0) : z;
                const uint4 q8 =
                    r0 + 8 < nr ? lds16(XA + (r0 + 8) * ld + k0) : z;
                uint4 kv[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  if (j < njw)
                    kv[j] = lds16(Kf + (8 * (j0 + j) + g) * ldk + kt);
#pragma unroll
                for (int s2 = 0; s2 < 2; ++s2) {
                  const uint32_t a[4] = {word(q0, 2 * s2), word(q8, 2 * s2),
                                         word(q0, 2 * s2 + 1),
                                         word(q8, 2 * s2 + 1)};
                  const Tf32x2<4> as = split_frag(a);
#pragma unroll
                  for (int j = 0; j < 4; ++j) {
                    if (j >= njw) break;
                    const uint32_t b[2] = {word(kv[j], 2 * s2),
                                           word(kv[j], 2 * s2 + 1)};
                    const Tf32x2<2> bs = split_frag(b);
                    mma_1688_tf32(sx[j], as.lo, bs.hi[0], bs.hi[1]);
                    mma_1688_tf32(sx[j], as.hi, bs.lo[0], bs.lo[1]);
                    mma_1688_tf32(s[j], as.hi, bs.hi[0], bs.hi[1]);
                  }
                }
              }
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  s[j][e] = __fadd_rn(s[j][e], sx[j][e]);
            } else if constexpr (HD == 8) {
              // one m16n8k16 step with k 8..15 zero: lane t4 holds k 2 t4 and
              // 2 t4 + 1 of q's rows g, g + 8 and of key g
              const uint32_t* q32 = reinterpret_cast<const uint32_t*>(
                  qt + (16 * mt + g) * ldq + qo + 2 * t4);
              const uint32_t qa[4] = {q32[0], q32[4 * ldq], 0u, 0u};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (j >= njw) break;
                const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
                    Kh + (8 * (j0 + j) + g) * ldk + ko + 2 * t4);
                mma_16816(s[j], qa, b0, 0u);
              }
            } else {
#pragma unroll
              for (int kk = 0; kk < HD / 16; ++kk) {
                uint32_t qa[4];
                ldsm_x4(qa, qt + (16 * mt + (lane & 15)) * ldq + qo +
                                kk * 16 + (lane >> 4) * 8);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  if (j >= njw) break;
                  uint32_t b0, b1;
                  ldsm_x2(b0, b1, Kh + (8 * (j0 + j) + (lane & 7)) * ldk +
                                      ko + kk * 16 + ((lane >> 3) & 1) * 8);
                  mma_16816(s[j], qa, b0, b1);
                }
              }
            }
            // the mask bits of the tile's word, in registers
            unsigned mw[2];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = 16 * mt + g + 8 * hh;
              mw[hh] = (r < nr && !clr[mt][hh]) ? MK[r * wl + (t0 >> 5)] : 0u;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (j >= njw) break;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int kk = 8 * (j0 + j) + 2 * t4 + (e & 1);
                if (t0 + kk >= T_)
                  s[j][e] = -INFINITY;
                else if ((mw[e >> 1] >> kk) & 1u)
                  s[j][e] = __fadd_rn(s[j][e], -1e9f);
              }
            }
            if (pass == 0) {
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                float tm = -INFINITY;
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  if (j < njw)
                    tm = fmaxf(tm, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
                const float nm = fmaxf(mx[mt][hh], tm);
                if (nm == -INFINITY) continue;
                float add = 0.f;
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  if (j < njw)
                    add += __expf(s[j][2 * hh] - nm) +
                           __expf(s[j][2 * hh + 1] - nm);
                ls[mt][hh] = ls[mt][hh] * expf(mx[mt][hh] - nm) + add;
                mx[mt][hh] = nm;
              }
            } else {
              // P = rd_T(exp(s - M) / L), the A operand of P v (exp and 1 / L
              // by the special-function unit, within 2 f32 ulps)
              const float rl[2] = {__frcp_rn(ls[mt][0]), __frcp_rn(ls[mt][1])};
              float pv[4][4];
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  pv[j][e] = j < njw ? rd<T>(__expf(s[j][e] - mx[mt][e >> 1]) *
                                             rl[e >> 1])
                                     : 0.f;
              if constexpr (F32) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  if (j >= njw) break;
                  // k = the tile's 8 keys, key 2t (+1) as logical t (+4)
                  const uint32_t a[4] = {
                      __float_as_uint(pv[j][0]), __float_as_uint(pv[j][2]),
                      __float_as_uint(pv[j][1]), __float_as_uint(pv[j][3])};
                  const Tf32x2<4> as = split_frag(a);
                  const float* v0 =
                      Vf + (8 * (j0 + j) + 2 * t4) * ldv + ko + cw * OD + g;
#pragma unroll
                  for (int jd = 0; jd < OD / 8; ++jd) {
                    const uint32_t b[2] = {__float_as_uint(v0[8 * jd]),
                                           __float_as_uint(v0[ldv + 8 * jd])};
                    const Tf32x2<2> bs = split_frag(b);
                    mma_1688_tf32(ox[mt][jd], as.lo, bs.hi[0], bs.hi[1]);
                    mma_1688_tf32(ox[mt][jd], as.hi, bs.lo[0], bs.lo[1]);
                    mma_1688_tf32(o[mt][jd], as.hi, bs.hi[0], bs.hi[1]);
                  }
                }
              } else {
                // 16 keys a step: column tiles 2u, 2u + 1 (a tile outside
                // this warp's slice weighs 0)
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                  const int ja = 2 * u - j0, jb = ja + 1;
                  if (jb < 0 || ja >= njw) continue;
                  uint32_t pa[4];
#pragma unroll
                  for (int hf = 0; hf < 2; ++hf) {
                    const int jj = ja + hf;
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                      float p0 = 0.f, p1 = 0.f;
#pragma unroll
                      for (int j = 0; j < 4; ++j)
                        if (j == jj && j < njw) {
                          p0 = pv[j][2 * hh];
                          p1 = pv[j][2 * hh + 1];
                        }
                      pa[2 * hf + hh] = pack_bf16(p0, p1);
                    }
                  }
#pragma unroll
                  for (int jd = 0; jd < OD / 8; ++jd) {
                    uint32_t b0, b1;
                    ldsm_x2_trans(b0, b1, Vh + (16 * u + (lane & 15)) * ldv +
                                              ko + cw * OD + 8 * jd);
                    mma_16816(o[mt][jd], pa, b0, b1);
                  }
                }
              }
            }
          }
        }
        __syncthreads();  // the tile is read: its buffer may be refilled
        if (more && nbuf == 1) stage(t0 + DS2_TK, kslot(0), vslot(0));
      }
      if (pass == 0) {
        // this warp's row max and sum: merge the quad, then publish
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float m = mx[mt][hh], l = ls[mt][hh];
#pragma unroll
            for (int of = 1; of <= 2; of <<= 1) {
              const float m2 = __shfl_xor_sync(0xffffffffu, m, of);
              const float l2 = __shfl_xor_sync(0xffffffffu, l, of);
              const float nm = fmaxf(m, m2);
              if (nm > -INFINITY)
                l = (m > -INFINITY ? l * expf(m - nm) : 0.f) +
                    (m2 > -INFINITY ? l2 * expf(m2 - nm) : 0.f);
              m = nm;
            }
            const int r = 16 * mt + g + 8 * hh;
            if (t4 == 0 && mt < MTQ) {
              ST[(2 * warp) * rp + r] = m;
              ST[(2 * warp + 1) * rp + r] = l;
            }
          }
        __syncthreads();
      }
    }
    // the slices' partial outputs, summed in slice order, rounded to T
    for (int s = 0; s < nsl; ++s) {
      if (sl == s) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt >= MTQ) break;
#pragma unroll
          for (int jd = 0; jd < OD / 8; ++jd)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 16 * mt + g + 8 * (e >> 1);
              if (r >= nr) continue;
              float* op =
                  OB + r * ld + qo + cw * OD + 8 * jd + 2 * t4 + (e & 1);
              float v = o[mt][jd][e];
              if constexpr (F32) v = __fadd_rn(v, ox[mt][jd][e]);
              if (s > 0) v = __fadd_rn(*op, v);
              *op = s == nsl - 1 ? rd<T>(v) : v;
            }
        }
      }
      __syncthreads();
    }
  }  // round
}

// the cross-attention of the block's rows in shared memory. Not inlined:
// it gets the kernel's registers to itself.
template <typename T, int HD, int NCS>
__device__ __noinline__ void ds2_cross_attn(float* sm, const Ds2Layout Ly,
                                            int nr, int T_,
                                            const T* __restrict__ Kb,
                                            const T* __restrict__ Vb,
                                            int ldkv, float scale) {
  ds2_cross_attn_body<T, HD, NCS, false>(sm, Ly, nr, T_, Kb, Vb, ldkv,
                                         scale, nullptr, nullptr, nullptr,
                                         nullptr, nullptr);
}

// the GEN kernel's cross-attention of a group's rows. Not inlined.
template <typename T, int HD, int NCS>
__device__ __noinline__ void ds2_cross_attn_rows(
    float* sm, const Ds2Layout Ly, int nr, int T_, const T* __restrict__ Kb,
    const T* __restrict__ Vb, int ldkv, float scale, float* XA,
    const float* QB, float* OB, const unsigned* MK, const int* flag) {
  ds2_cross_attn_body<T, HD, NCS, true>(sm, Ly, nr, T_, Kb, Vb, ldkv, scale,
                                        XA, QB, OB, MK, flag);
}

// LN of own rows of (X [+ Y]) -> dst (rounded to T when round_t), eps 1e-6,
// over the true columns (c / HD < nh, c % HD < ht; a padded column's w and
// b are 0, so it stays 0)
template <typename T, int HD>
__device__ void ds2_layer_norm(float* X, const float* Y, float* dst, int nr,
                               int C, int ld, const float* w, const float* b,
                               bool round_t, int ht, int nh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float n = (float)(nh * ht);
  for (int m = warp; m < nr; m += DS2_WARPS) {
    float* xr = X + m * ld;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) {
      float v = xr[c];
      if (Y) {
        v = __fadd_rn(v, Y[m * ld + c]);
        xr[c] = v;
      }
      s += v;
    }
    const float mean = warp_sum(s) / n;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      if (c / HD >= nh || c % HD >= ht) continue;
      const float d = xr[c] - mean;
      q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / n + 1e-6f);
    for (int c = lane; c < C; c += 32) {
      const float v = __fadd_rn(
          __fmul_rn(__fmul_rn(xr[c] - mean, rstd), w[c]), b[c]);
      dst[m * ld + c] = round_t ? rd<T>(v) : v;
    }
  }
  __syncthreads();
}

// The kernels' body. NCS: column slices of the cross-attention's head (8
// where ds2_column_slices, else 1). GEN (decoder_split_gen_kernel): the
// layout ds2_layout_gen, ws the rows' workspace where it is glob (5 R ld
// floats a block), else null; E null where the mask embedding has the
// width C (it lives in OB), else the (B, Q, De) f32 embedding, De > C (a
// multiple of 32), holding emb0 at the launch (the kernel overwrites it),
// with the mask MLP's last layer (De, C) and the features (T_l, De).
// Without GEN (decoder_split_tc_kernel): ds2_layout, ws and E null.
template <typename T, int HD, int NCS, bool GEN>
__device__ __forceinline__ void ds2_kernel_body(
    const float* __restrict__ x0, const float* __restrict__ emb0,
    const float* __restrict__ qpos, DecPtrs p, int nl, int G,
    const T* __restrict__ wd, const float* __restrict__ wf,
    T* __restrict__ out, unsigned* __restrict__ dbg,
    unsigned long long* __restrict__ prof, float* __restrict__ ws,
    float* __restrict__ E, int De, int Q, int C, int F, int heads,
    int words, int tmax, float scale, int ht, int nh) {
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const auto Ly = [&] {
    if constexpr (GEN)
      return ds2_layout_gen(Q, C, heads, tmax, F32);
    else
      return ds2_layout(Q, C, heads, tmax, F32);
  }();
  const int R = Ly.R, ld = Ly.ld, wl = Ly.wl;
  // the row buffers: GEN the block's region of ws where glob, else shared
  // memory
  const size_t region = (size_t)5 * R * ld;
  float* rows = sm;
  if constexpr (GEN)
    if (Ly.glob) rows = ws + (size_t)blockIdx.x * region;
  float* X = rows + Ly.X;
  float* XA = rows + Ly.XA;
  float* QB = rows + Ly.QB;
  float* OB = rows + Ly.OB;
  unsigned* MK = reinterpret_cast<unsigned*>(sm + Ly.MK);  // R x wl
  int* flag = reinterpret_cast<int*>(sm + Ly.FL);
  float* U = sm + Ly.U;
  float* Kown = U;  // the own k rows (GEN: at KO, of ws where glob)
  if constexpr (GEN) Kown = (Ly.glob ? rows : sm) + Ly.KO;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / Ly.cs;
  const int row0 = rank * R;
  const int nr = max(0, min(R, Q - row0));
  // the mask embedding of the block's rows: OB, or (GEN) its rows of E
  float* emb = OB;
  int lde = ld;
  if constexpr (GEN)
    if (E) {
      emb = E + ((size_t)b * Q + row0) * De;
      lde = De;
    }
  const int L = nl * G;
  const size_t CC = (size_t)C * C;
  const size_t WL = 6 * CC + 2 * (size_t)C * F;
  const size_t FLN = 13 * (size_t)C + F;
  const T* wh = wd + L * WL;
  const float* fh = wf + L * FLN;
  const int ldkv = G * C;
  unsigned long long t_prev = 0;
#define DS2_PART(i)                                                     \
  if (prof && threadIdx.x == 0) {                                       \
    const unsigned long long t_ = gtimer();                             \
    prof[blockIdx.x * DS2_PARTS + (i)] += t_ - t_prev;                  \
    t_prev = t_;                                                        \
  }

  for (int i = tid; i < nr * C; i += DS2_THREADS) {
    const int m = i / C, c = i % C;
    const size_t gi = ((size_t)b * Q + row0 + m) * C + c;
    X[m * ld + c] = x0[gi];
    if (!GEN || !E) OB[m * ld + c] = emb0[gi];
  }
  cl.sync();  // every block of the cluster runs before any remote access
  if (prof && tid == 0) t_prev = gtimer();

  for (int li = 0; li < L; ++li) {
    const int lvl = li % nl, grp = li / nl;
    const int T_ = p.T[lvl];
    const int Fw = GEN && E ? De : C;  // the features' width
    const float* feat = p.F[lvl] + (size_t)b * T_ * Fw;
    const T* Kb = reinterpret_cast<const T*>(p.K[lvl]) +
                  (size_t)b * T_ * ldkv + grp * C;
    const T* Vb = reinterpret_cast<const T*>(p.V[lvl]) +
                  (size_t)b * T_ * ldkv + grp * C;
    const T* wl_ = wd + li * WL;
    const float* fl = wf + li * FLN;

    // 1. mask bits m = emb . feat^T < 0 of own rows against all keys
    if constexpr (GEN) {
      for (int r0 = 0; r0 < nr; r0 += DS2_RG)
        ds2_mask_bits(feat, T_, Fw, emb + r0 * lde, lde,
                      min(DS2_RG, nr - r0), MK + r0 * wl, wl);
    } else {
      ds2_mask_bits(feat, T_, C, OB, ld, nr, MK, wl);
    }
    __syncthreads();
    // rows that block every key are cleared
    for (int m = tid; m < nr; m += DS2_THREADS) {
      int all = 1;
      for (int w = 0; w * 32 < T_; ++w) {
        const int valid = min(32, T_ - 32 * w);
        const unsigned need =
            valid == 32 ? 0xffffffffu : ((1u << valid) - 1u);
        if ((MK[m * wl + w] & need) != need) all = 0;
      }
      flag[m] = all;
    }
    __syncthreads();
    if (dbg) {
      const int nw = (T_ + 31) / 32;
      for (int i = tid; i < nr * nw; i += DS2_THREADS) {
        const int m = i / nw, w = i % nw;
        dbg[(((size_t)b * L + li) * Q + row0 + m) * words + w] =
            flag[m] ? 0u : MK[m * wl + w];
      }
    }
    DS2_PART(0);

    // 2. q projection of x + qpos
    for (int i = tid; i < nr * C; i += DS2_THREADS) {
      const int m = i / C, c = i % C;
      XA[m * ld + c] =
          rd<T>(__fadd_rn(X[m * ld + c], qpos[(size_t)(row0 + m) * C + c]));
    }
    __syncthreads();
    ds2_dense<T, GEN>(XA, ld, nr, C, wl_, C, C, fl, QB, ld, EPI_RAW, false);
    DS2_PART(1);

    // 3. masked cross-attention of own rows over all keys (GEN: in row
    //    groups)
    if constexpr (GEN) {
      int r0 = 0;
      do {
        ds2_cross_attn_rows<T, HD, NCS>(
            sm, Ly, min(DS2_RG, nr - r0), T_, Kb, Vb, ldkv, scale,
            XA + r0 * ld, QB + r0 * ld, OB + r0 * ld, MK + r0 * wl,
            flag + r0);
        r0 += DS2_RG;
      } while (r0 < nr);
    } else {
      ds2_cross_attn<T, HD, NCS>(sm, Ly, nr, T_, Kb, Vb, ldkv, scale);
    }
    DS2_PART(2);
    ds2_dense<T, GEN>(OB, ld, nr, C, wl_ + CC, C, C, fl + C, QB, ld, EPI_RAW,
                      false);
    ds2_layer_norm<T, HD>(X, QB, X, nr, C, ld, fl + 6 * C, fl + 7 * C,
                          false, ht, nh);
    DS2_PART(3);

    // 4. self-attention: v from x (into OB), q and k from x + qpos (q into
    //    QB, k into Kown), then one head at a time over every block's k and
    //    v (in chunks of QC keys where (R, Q) scores do not fit, Ly.QC < Q)
    const int QC = Ly.QC;
    float* KVh = U + R * ld;  // QC x (hd + 1): k, then v
    if constexpr (GEN)
      if (Ly.glob) KVh = U;
    float* S = KVh + QC * (HD + 1);           // R x QC
    for (int i = tid; i < nr * C; i += DS2_THREADS) {
      const int m = i / C, c = i % C;
      XA[m * ld + c] = rd<T>(X[m * ld + c]);
    }
    __syncthreads();
    ds2_dense<T, GEN>(XA, ld, nr, C, wl_ + 4 * CC, C, C, fl + 4 * C, OB, ld,
                      EPI_RD, false);
    for (int i = tid; i < nr * C; i += DS2_THREADS) {
      const int m = i / C, c = i % C;
      XA[m * ld + c] =
          rd<T>(__fadd_rn(X[m * ld + c], qpos[(size_t)(row0 + m) * C + c]));
    }
    __syncthreads();
    ds2_dense<T, GEN>(XA, ld, nr, C, wl_ + 2 * CC, C, C, fl + 2 * C, QB, ld,
                      EPI_RAW, false);
    ds2_dense<T, GEN>(XA, ld, nr, C, wl_ + 3 * CC, C, C, fl + 3 * C, Kown, ld,
                      EPI_RD, false);
    if constexpr (GEN)
      if (Ly.glob) __threadfence();  // the k and v rows in device memory
    cl.sync();  // every block's k and v are complete
    // one head's rows c0 .. c0 + nq - 1 of src (Kown or OB) from every
    // block into KVh: 16-byte remote loads (distributed shared memory, or
    // the owner's workspace region), 8 in flight a thread
    auto remote = [&](float* src, int r) -> const float* {
      if constexpr (GEN)
        if (Ly.glob) return src + ((long long)r - rank) * (long long)region;
      return cl.map_shared_rank(src, r);
    };
    auto gather = [&](float* src, int hs, int c0, int nq) {
      constexpr int C4 = HD / 4;
      for (int i0 = tid; i0 < nq * C4; i0 += 8 * DS2_THREADS) {
        float4 buf[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * DS2_THREADS;
          if (i < nq * C4) {
            const int j = c0 + i / C4, d = 4 * (i % C4);
            buf[u] = *reinterpret_cast<const float4*>(
                remote(src, j / R) + (j % R) * ld + hs * HD + d);
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * DS2_THREADS;
          if (i < nq * C4) {
            float* o = KVh + (i / C4) * (HD + 1) + 4 * (i % C4);
            o[0] = buf[u].x; o[1] = buf[u].y; o[2] = buf[u].z; o[3] = buf[u].w;
          }
        }
      }
    };
    for (int i = tid; i < nr * C; i += DS2_THREADS) {  // q scaled once
      const int m = i / C, c = i % C;
      QB[m * ld + c] = rd<T>(QB[m * ld + c] * scale);
    }
    // the scores of the own rows against the nq keys in KVh into S (row
    // stride QC)
    auto scores = [&](int hs, int nq) {
      for (int i = tid; i < nr * nq; i += DS2_THREADS) {
        const int m = i / nq, j = i % nq;
        const float* qr = QB + m * ld + hs * HD;
        const float* kr = KVh + j * (HD + 1);
        float s0 = 0.f, s1 = 0.f;  // two chains of FMAs
#pragma unroll
        for (int d = 0; d < HD; d += 2) {
          s0 = fmaf(qr[d], kr[d], s0);
          s1 = fmaf(qr[d + 1], kr[d + 1], s1);
        }
        S[m * QC + j] = __fadd_rn(s0, s1);
      }
    };
    for (int hs = 0; hs < heads && QC < Q; ++hs) {
      // chunks of QC keys: the rows' max and sum (rescaled a chunk at a
      // time) in registers, rows warp + 8 i, then the probabilities and
      // P v, summed in XA over the chunks (f32) and rounded at the last
      constexpr int RW = (GEN ? DS2_MAXR : DS2_RG) / DS2_WARPS;
      float rm[RW], rl[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        rm[i] = -INFINITY;
        rl[i] = 0.f;
      }
      for (int c0 = 0; c0 < Q; c0 += QC) {
        const int nq = min(QC, Q - c0);
        gather(Kown, hs, c0, nq);
        __syncthreads();
        scores(hs, nq);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const int m = warp + DS2_WARPS * i;
          if (m >= nr) break;
          const float* sr = S + m * QC;
          float cm = -INFINITY;
          for (int j = lane; j < nq; j += 32) cm = fmaxf(cm, sr[j]);
          const float nm = fmaxf(rm[i], warp_max(cm));
          float l2 = 0.f;
          for (int j = lane; j < nq; j += 32) l2 += expf(sr[j] - nm);
          rl[i] = rl[i] * expf(rm[i] - nm) + warp_sum(l2);
          rm[i] = nm;
        }
        __syncthreads();  // S and KVh are read: the next chunk may land
      }
      for (int c0 = 0; c0 < Q; c0 += QC) {
        const int nq = min(QC, Q - c0);
        const bool last = c0 + QC >= Q;
        gather(Kown, hs, c0, nq);
        __syncthreads();
        scores(hs, nq);
        __syncthreads();
        gather(OB, hs, c0, nq);
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const int m = warp + DS2_WARPS * i;
          if (m >= nr) break;
          float* sr = S + m * QC;
          for (int j = lane; j < nq; j += 32)
            sr[j] = rd<T>(expf(sr[j] - rm[i]) / rl[i]);
        }
        __syncthreads();
        for (int i = tid; i < nr * HD; i += DS2_THREADS) {
          const int m = i / HD, d = i % HD;
          const float* sr = S + m * QC;
          float o4[4] = {0.f, 0.f, 0.f, 0.f};  // four chains of FMAs
          int j = 0;
          for (; j + 4 <= nq; j += 4)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              o4[u] = fmaf(sr[j + u], KVh[(j + u) * (HD + 1) + d], o4[u]);
          for (; j < nq; ++j)
            o4[0] = fmaf(sr[j], KVh[j * (HD + 1) + d], o4[0]);
          float v = __fadd_rn(__fadd_rn(o4[0], o4[1]),
                              __fadd_rn(o4[2], o4[3]));
          float* xo = XA + m * ld + hs * HD + d;
          if (c0 > 0) v = __fadd_rn(*xo, v);
          *xo = last ? rd<T>(v) : v;
        }
        __syncthreads();
      }
    }
    for (int hs = 0; hs < heads && QC >= Q; ++hs) {
      // k of the head from every block, the scores, then v in k's place
      gather(Kown, hs, 0, Q);
      __syncthreads();
      scores(hs, Q);
      __syncthreads();
      gather(OB, hs, 0, Q);
      for (int m = warp; m < nr; m += DS2_WARPS) {
        float* sr = S + m * Q;
        float m2 = -INFINITY;
        for (int j = lane; j < Q; j += 32) m2 = fmaxf(m2, sr[j]);
        m2 = warp_max(m2);
        float l2 = 0.f;
        for (int j = lane; j < Q; j += 32) l2 += expf(sr[j] - m2);
        l2 = warp_sum(l2);
        for (int j = lane; j < Q; j += 32) sr[j] = rd<T>(expf(sr[j] - m2) / l2);
      }
      __syncthreads();
      for (int i = tid; i < nr * HD; i += DS2_THREADS) {
        const int m = i / HD, d = i % HD;
        const float* sr = S + m * Q;
        float o4[4] = {0.f, 0.f, 0.f, 0.f};  // four chains of FMAs
        int j = 0;
        for (; j + 4 <= Q; j += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            o4[u] = fmaf(sr[j + u], KVh[(j + u) * (HD + 1) + d], o4[u]);
        for (; j < Q; ++j) o4[0] = fmaf(sr[j], KVh[j * (HD + 1) + d], o4[0]);
        XA[m * ld + hs * HD + d] =
            rd<T>(__fadd_rn(__fadd_rn(o4[0], o4[1]), __fadd_rn(o4[2], o4[3])));
      }
      __syncthreads();
    }
    cl.sync();  // no block reads another's k or v any more
    ds2_dense<T, GEN>(XA, ld, nr, C, wl_ + 5 * CC, C, C, fl + 5 * C, QB, ld,
                      EPI_RAW, false);
    ds2_layer_norm<T, HD>(X, QB, X, nr, C, ld, fl + 8 * C, fl + 9 * C,
                          false, ht, nh);
    DS2_PART(4);

    // 5. ReLU FFN in chunks of C hidden units: QB the chunk, OB the sum;
    //    f1 is stored (F, C), f2 (C, F)
    for (int i = tid; i < nr * C; i += DS2_THREADS) {
      const int m = i / C, c = i % C;
      XA[m * ld + c] = rd<T>(X[m * ld + c]);
    }
    __syncthreads();
    {
      const T* f1 = wl_ + 6 * CC;
      const T* f2 = f1 + (size_t)C * F;
      const float* fb1 = fl + 12 * C;
      const float* fb2 = fb1 + F;
      for (int h0 = 0; h0 < F; h0 += C) {
        ds2_dense<T, GEN>(XA, ld, nr, C, f1 + (size_t)h0 * C, C, C,
                          fb1 + h0, QB, ld, EPI_RELU_RD, false);
        ds2_dense<T, GEN>(QB, ld, nr, C, f2 + h0, F, C,
                          h0 + C >= F ? fb2 : nullptr, OB, ld, EPI_RAW, h0 > 0);
      }
    }
    ds2_layer_norm<T, HD>(X, OB, X, nr, C, ld, fl + 10 * C, fl + 11 * C,
                          false, ht, nh);
    DS2_PART(5);

    // 6. next mask embedding: decoder norm + 3-layer MLP -> emb (OB, or
    //    the block's rows of E at De columns)
    if (li + 1 < L) {
      ds2_layer_norm<T, HD>(X, nullptr, XA, nr, C, ld, fh, fh + C, true,
                            ht, nh);
      ds2_dense<T, GEN>(XA, ld, nr, C, wh, C, C, fh + 2 * C, QB, ld,
                        EPI_RELU_RD, false);
      ds2_dense<T, GEN>(QB, ld, nr, C, wh + CC, C, C, fh + 3 * C, XA, ld,
                        EPI_RELU_RD, false);
      ds2_dense<T, GEN>(XA, ld, nr, C, wh + 2 * CC, C, GEN && E ? De : C,
                        fh + 4 * C, emb, lde, EPI_RD, false);
    }
    DS2_PART(6);
  }
#undef DS2_PART
  for (int i = tid; i < nr * C; i += DS2_THREADS) {
    const int m = i / C, c = i % C;
    out[((size_t)b * Q + row0 + m) * C + c] = from_f<T>(X[m * ld + c]);
  }
  cl.sync();  // no block leaves while another may still access its memory
}

// the block's rows in shared memory (ds2_shared_takes)
template <typename T, int HD, int NCS>
__global__ void __launch_bounds__(DS2_THREADS, 1) decoder_split_tc_kernel(
    const float* __restrict__ x0, const float* __restrict__ emb0,
    const float* __restrict__ qpos, DecPtrs p, int nl, int G,
    const T* __restrict__ wd, const float* __restrict__ wf,
    T* __restrict__ out, unsigned* __restrict__ dbg,
    unsigned long long* __restrict__ prof, int Q, int C, int F, int heads,
    int words, int tmax, float scale, int ht, int nh) {
  ds2_kernel_body<T, HD, NCS, false>(x0, emb0, qpos, p, nl, G, wd, wf, out,
                                     dbg, prof, nullptr, nullptr, C, Q, C, F,
                                     heads, words, tmax, scale, ht, nh);
}

// the rest (GEN): rows in the workspace ws where ds2_layout_gen(...).glob,
// a wider embedding E, head widths 128 and 256 over any heads
template <typename T, int HD, int NCS>
__global__ void __launch_bounds__(DS2_THREADS, 1) decoder_split_gen_kernel(
    const float* __restrict__ x0, const float* __restrict__ emb0,
    const float* __restrict__ qpos, DecPtrs p, int nl, int G,
    const T* __restrict__ wd, const float* __restrict__ wf,
    T* __restrict__ out, unsigned* __restrict__ dbg,
    unsigned long long* __restrict__ prof, float* __restrict__ ws,
    float* __restrict__ E, int De, int Q, int C, int F, int heads,
    int words, int tmax, float scale, int ht, int nh) {
  ds2_kernel_body<T, HD, NCS, true>(x0, emb0, qpos, p, nl, G, wd, wf, out,
                                    dbg, prof, ws, E, De, Q, C, F, heads,
                                    words, tmax, scale, ht, nh);
}

template <typename T, int HD, int NCS, bool GEN>
static int launch_split(const float* x0, const float* emb0,
                        const float* qpos, const DecPtrs& p, int nl, int G,
                        const void* wd, const float* wf, void* out,
                        unsigned* dbg, unsigned long long* prof, float* ws,
                        float* E, int De, int B, int Q, int C, int F,
                        int heads, int words, int tmax, int smem,
                        float scale, int ht, int nh, cudaStream_t stream) {
  auto go = [&](auto kern, auto... args) {
    const int cs = ds2_cluster(Q);
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess && cs > 8)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    cfg.gridDim = dim3(B * cs);
    cfg.blockDim = dim3(DS2_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kern, args...);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  };
  if constexpr (GEN)
    return go(decoder_split_gen_kernel<T, HD, NCS>, x0, emb0, qpos, p, nl, G,
              (const T*)wd, wf, (T*)out, dbg, prof, ws, E, De, Q, C, F,
              heads, words, tmax, scale, ht, nh);
  else
    return go(decoder_split_tc_kernel<T, HD, NCS>, x0, emb0, qpos, p, nl, G,
              (const T*)wd, wf, (T*)out, dbg, prof, Q, C, F, heads, words,
              tmax, scale, ht, nh);
}

// the instance of type T for these heads and head width (one source a
// type and kernel): MB_BAD_ARGS where none is built
#define DS2_DISPATCH_ARGS                                                   \
  const float *x0, const float *emb0, const float *qpos, const DecPtrs &p,  \
      int nl, int G, const void *wd, const float *wf, void *out,            \
      unsigned *dbg, unsigned long long *prof, float *ws, float *E, int De, \
      int B, int Q, int C, int F, int heads, int words, int tmax, int smem, \
      float scale, int ht, int nh, cudaStream_t stream
int ds2_dispatch_f32(DS2_DISPATCH_ARGS);
int ds2_dispatch_bf16(DS2_DISPATCH_ARGS);
int ds2_dispatch_f32_gen(DS2_DISPATCH_ARGS);
int ds2_dispatch_bf16_gen(DS2_DISPATCH_ARGS);
int ds2_dispatch_f32_gen_slices(DS2_DISPATCH_ARGS);
int ds2_dispatch_bf16_gen_slices(DS2_DISPATCH_ARGS);

// the dispatchers' bodies for type TT (one source each, built in
// parallel). decoder_split_<t>.cu: decoder_split_tc_kernel, one head as 8
// column slices (HD = C 64-256), else HD = C / heads 8-64.
// decoder_split_<t>_gen.cu: decoder_split_gen_kernel at HD 8-64 over 2, 4,
// 8 or rounds of 8 heads; decoder_split_<t>_gen_slices.cu: with 8 column
// slices of a head where ds2_column_slices (one head of C 64-512, or head
// widths 128 and 256 over any heads).
#define DS2_DISPATCH_BODY(TT)                                               \
  const int hd = C / heads;                                                 \
  if (heads == 1) {                                                         \
    if (hd == 64) DS2_LAUNCH(TT, 64, 8, false);                             \
    if (hd == 128) DS2_LAUNCH(TT, 128, 8, false);                           \
    if (hd == 256) DS2_LAUNCH(TT, 256, 8, false);                           \
    return MB_BAD_ARGS;                                                     \
  }                                                                         \
  if (hd == 8) DS2_LAUNCH(TT, 8, 1, false);                                 \
  if (hd == 16) DS2_LAUNCH(TT, 16, 1, false);                               \
  if (hd == 32) DS2_LAUNCH(TT, 32, 1, false);                               \
  if (hd == 64) DS2_LAUNCH(TT, 64, 1, false);                               \
  return MB_BAD_ARGS;
#define DS2_DISPATCH_GEN(TT)                                                \
  const int hd = C / heads;                                                 \
  if (hd == 8) DS2_LAUNCH(TT, 8, 1, true);                                  \
  if (hd == 16) DS2_LAUNCH(TT, 16, 1, true);                                \
  if (hd == 32) DS2_LAUNCH(TT, 32, 1, true);                                \
  if (hd == 64) DS2_LAUNCH(TT, 64, 1, true);                                \
  return MB_BAD_ARGS;
#define DS2_DISPATCH_GEN_SLICES(TT)                                         \
  const int hd = C / heads;                                                 \
  if (hd == 64 && heads == 1) DS2_LAUNCH(TT, 64, 8, true);                  \
  if (hd == 128) DS2_LAUNCH(TT, 128, 8, true);                              \
  if (hd == 256) DS2_LAUNCH(TT, 256, 8, true);                              \
  if (hd == 512 && heads == 1) DS2_LAUNCH(TT, 512, 8, true);                \
  return MB_BAD_ARGS;
#define DS2_LAUNCH(TT, H, N, GEN)                                           \
  return launch_split<TT, H, N, GEN>(x0, emb0, qpos, p, nl, G, wd, wf, out, \
                                     dbg, prof, ws, E, De, B, Q, C, F,      \
                                     heads, words, tmax, smem, scale, ht,   \
                                     nh, stream)
