// Kernel 4: every Mask2Former decoder layer of the final_only path.
//
// Replaces mask_bev_tpu/ops/pallas_decoder_stack.py::fused_decoder_stack
// (_stack_kernel). One thread-block cluster of CS = 8 blocks per batch
// element runs all layers. Each block holds a replica of the (Q, C) f32
// query state and of every (Q, C) intermediate in its shared memory; the
// blocks split the work and exchange results through distributed shared
// memory, so nothing returns to device memory between layers:
//   * dense products: block r computes output columns [r C/8, (r+1) C/8)
//     for all queries and writes them into every block's buffer;
//   * the FFN: block r takes hidden units [r F/8, (r+1) F/8); the second
//     product's partial sums are reduced column slice by column slice;
//   * cross-attention: block r takes a 32-aligned slice of the keys; the
//     row max and sum are combined across the cluster before the exact
//     probabilities (rounded to bf16 like the reference's softmax output)
//     weight v, and the partial outputs are reduced like the FFN's;
//   * self-attention over the Q queries: block r takes heads h = r mod 8;
//   * LayerNorms run redundantly on every replica.
// The k and v projections of the level memories do not depend on the
// queries, so the chain computes them beforehand with the tensor-core GEMM
// (gemm.cuh), one launch per level and projection.
//
// Per layer li = 3g + lvl: attention-mask bits m = emb . feat^T < 0 (f32,
// rows that block every position cleared); q projection; masked
// cross-attention; out projection, LN1; self-attention, LN2; ReLU FFN,
// LN3; the next mask embedding (decoder norm, 3-layer MLP). Every product
// takes bf16-rounded operands with f32 accumulation and an f32 bias, as the
// TPU kernel's _dot does.
//
// What bounds it on the H100: operations, and parallelism. The query-side
// work is ~1.5 GFLOP per batch element at the flagship (45 queries, 9
// layers, FFN 2048, up to 3969 keys), serial from layer to layer; a cluster
// spreads each element over 8 SMs (64 SMs at batch 8), on CUDA-core FMAs.
// Threads own output columns and read shared-memory operand rows as
// broadcasts; weights stream from L2/HBM once per block and layer, coalesced.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define DS_THREADS 512
#define DS_CS 8     // blocks per cluster (one cluster per batch element)
#define DS_TK 16    // keys per shared-memory chunk
#define DS_RPT 24   // rows per thread when 256 threads share a column

struct DecPtrs {
  const bf16* K[3];
  const bf16* V[3];
  const float* F[3];
  int T[3];
};

enum { EPI_RAW = 0, EPI_RD = 1, EPI_RELU_RD = 2 };

__device__ __forceinline__ float epi(float v, int mode) {
  if (mode == EPI_RELU_RD) return rd_bf16(fmaxf(v, 0.f));
  if (mode == EPI_RD) return rd_bf16(v);
  return v;
}

// acc[i] += sum_k A[m][k] w[k * ldw] for rows m = rg + 2i (A in shared
// memory, row stride lda; K a multiple of 4; w points at the column)
__device__ __forceinline__ void mm_rows(float (&acc)[DS_RPT],
                                        const float* A, int lda, int Q,
                                        int K, const bf16* __restrict__ w,
                                        int ldw, int rg) {
  for (int k = 0; k < K; k += 4) {
    const float w0 = __bfloat162float(w[(size_t)k * ldw]);
    const float w1 = __bfloat162float(w[(size_t)(k + 1) * ldw]);
    const float w2 = __bfloat162float(w[(size_t)(k + 2) * ldw]);
    const float w3 = __bfloat162float(w[(size_t)(k + 3) * ldw]);
#pragma unroll
    for (int i = 0; i < DS_RPT; ++i) {
      const int m = rg + 2 * i;
      if (m < Q) {
        const float4 a = *reinterpret_cast<const float4*>(A + m * lda + k);
        float s = acc[i];
        s = fmaf(a.x, w0, s);
        s = fmaf(a.y, w1, s);
        s = fmaf(a.z, w2, s);
        s = fmaf(a.w, w3, s);
        acc[i] = s;
      }
    }
  }
}

// dst[m][c0 + n] = epi(A . W[:, c0 + n] + bias) for this block's column
// slice c0 = rank C/CS, written into every block of the cluster. A (Q x K,
// row stride C) and dst (Q x C) live in shared memory; dst may alias A.
__device__ void dense_slice(cg::cluster_group& cl, const float* A, int Q,
                            int K, int C, const bf16* __restrict__ W,
                            int ldw, const float* __restrict__ bias,
                            float* dst, int mode) {
  const int ncol = C / DS_CS;
  const int c0 = (int)cl.block_rank() * ncol;
  const int n = threadIdx.x % ncol, rg = threadIdx.x / ncol;
  const int groups = DS_THREADS / ncol;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const bf16* wc = W + c0 + n;
  for (int k = 0; k < K; k += 4) {
    const float w0 = __bfloat162float(wc[(size_t)k * ldw]);
    const float w1 = __bfloat162float(wc[(size_t)(k + 1) * ldw]);
    const float w2 = __bfloat162float(wc[(size_t)(k + 2) * ldw]);
    const float w3 = __bfloat162float(wc[(size_t)(k + 3) * ldw]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = rg + groups * i;
      if (m < Q) {
        const float4 a = *reinterpret_cast<const float4*>(A + m * C + k);
        float s = acc[i];
        s = fmaf(a.x, w0, s);
        s = fmaf(a.y, w1, s);
        s = fmaf(a.z, w2, s);
        s = fmaf(a.w, w3, s);
        acc[i] = s;
      }
    }
  }
  cl.sync();  // every block has read its A before any block writes dst
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = rg + groups * i;
    if (m < Q) {
      const float v = epi(__fadd_rn(acc[i], bias[c0 + n]), mode);
      for (int r = 0; r < DS_CS; ++r)
        cl.map_shared_rank(dst, r)[m * C + c0 + n] = v;
    }
  }
  cl.sync();
}

// dst[m][c] (every block) = epi(sum over the cluster of part[m][c] [+ bias])
// for this block's column slice
__device__ void reduce_slice(cg::cluster_group& cl, float* part, int Q,
                             int C, const float* __restrict__ bias,
                             float* dst, int mode) {
  const int ncol = C / DS_CS;
  const int c0 = (int)cl.block_rank() * ncol;
  cl.sync();  // every partial is complete
  for (int i = threadIdx.x; i < Q * ncol; i += DS_THREADS) {
    const int m = i / ncol, c = c0 + i % ncol;
    float s = 0.f;
    for (int r = 0; r < DS_CS; ++r)
      s += cl.map_shared_rank(part, r)[m * C + c];
    if (bias) s = __fadd_rn(s, bias[c]);
    s = epi(s, mode);
    for (int r = 0; r < DS_CS; ++r) cl.map_shared_rank(dst, r)[m * C + c] = s;
  }
  cl.sync();
}

// LN over rows of (X [+ Y]) -> dst (rounded to bf16 when rd), eps 1e-6;
// local to the block (every replica computes the same values)
__device__ void layer_norm_rows(float* X, const float* Y, float* dst, int Q,
                                int C, const float* w, const float* b,
                                bool rd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < Q; m += DS_THREADS / 32) {
    float* xr = X + m * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) {
      float v = xr[c];
      if (Y) {
        v = __fadd_rn(v, Y[m * C + c]);
        xr[c] = v;
      }
      s += v;
    }
    const float mean = warp_sum(s) / (float)C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = xr[c] - mean;
      q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / (float)C + 1e-6f);
    for (int c = lane; c < C; c += 32) {
      const float v = __fadd_rn(
          __fmul_rn(__fmul_rn(xr[c] - mean, rstd), w[c]), b[c]);
      dst[m * C + c] = rd ? rd_bf16(v) : v;
    }
  }
  __syncthreads();
}

template <int HD>
__global__ void __launch_bounds__(DS_THREADS, 1) decoder_stack_kernel(
    const float* __restrict__ x0, const float* __restrict__ emb0,
    const float* __restrict__ qpos, DecPtrs p, int nl, int G,
    const bf16* __restrict__ wd, const float* __restrict__ wf,
    bf16* __restrict__ out, unsigned* __restrict__ dbg, int Q, int C, int F,
    int heads, int words, int words_loc, float scale) {
  extern __shared__ float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int QC = Q * C;
  float* X = sm;
  float* XA = X + QC;
  float* QB = XA + QC;
  float* OB = QB + QC;
  unsigned* MK = reinterpret_cast<unsigned*>(OB + QC);      // Q x words_loc
  int* flags = reinterpret_cast<int*>(MK + Q * words_loc);   // CS x Q
  bf16* Ks = reinterpret_cast<bf16*>(flags + DS_CS * Q);
  bf16* Vs = Ks + DS_TK * C;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / DS_CS;
  const int L = nl * G;
  const size_t WL = 6 * (size_t)C * C + 2 * (size_t)C * F;
  const size_t FL = 13 * (size_t)C + F;
  const size_t CC = (size_t)C * C;
  const bf16* wh = wd + L * WL;
  const float* fh = wf + L * FL;
  const int ldkv = G * C;
  const int pairs = heads * Q;
  const bool active = tid < pairs;
  const int ah = active ? tid / Q : 0, aq = active ? tid % Q : 0;
  const int Fr = F / DS_CS;  // hidden units of this block

  for (int i = tid; i < QC; i += DS_THREADS) {
    X[i] = x0[(size_t)b * QC + i];
    OB[i] = emb0[(size_t)b * QC + i];
  }
  cl.sync();  // every block of the cluster runs before any remote access

  for (int li = 0; li < L; ++li) {
    const int lvl = li % nl, g = li / nl;
    const int T = p.T[lvl];
    // this block's keys: a 32-aligned slice, so mask words never straddle
    const int chunk = ((T + DS_CS - 1) / DS_CS + 31) / 32 * 32;
    const int kt0 = min(T, rank * chunk), kt1 = min(T, kt0 + chunk);
    const int nkeys = kt1 - kt0;
    const float* feat = p.F[lvl] + (size_t)b * T * C;
    const bf16* Kb = p.K[lvl] + (size_t)b * T * ldkv + g * C;
    const bf16* Vb = p.V[lvl] + (size_t)b * T * ldkv + g * C;
    const bf16* wl = wd + li * WL;
    const float* fl = wf + li * FL;

    // 1. attention-mask bits of this block's keys (emb in OB)
    for (int i = tid; i < Q * words_loc; i += DS_THREADS) MK[i] = 0u;
    __syncthreads();
    for (int tl = warp; tl < nkeys; tl += DS_THREADS / 32) {
      const float* frow = feat + (size_t)(kt0 + tl) * C;
      for (int q0 = 0; q0 < Q; q0 += 16) {
        float part[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) part[j] = 0.f;
        for (int c = lane; c < C; c += 32) {
          const float f = frow[c];
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (q0 + j < Q) part[j] = fmaf(OB[(q0 + j) * C + c], f, part[j]);
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (q0 + j < Q) {
            const float s = warp_sum(part[j]);
            if (lane == 0 && s < 0.f)
              atomicOr(&MK[(q0 + j) * words_loc + (tl >> 5)],
                       1u << (tl & 31));
          }
        }
      }
    }
    __syncthreads();
    // rows that block every position, combined over the cluster
    for (int q = tid; q < Q; q += DS_THREADS) {
      int all = 1;
      for (int w = 0; w * 32 < nkeys; ++w) {
        const int valid = min(32, nkeys - 32 * w);
        const unsigned need =
            valid == 32 ? 0xffffffffu : ((1u << valid) - 1u);
        if ((MK[q * words_loc + w] & need) != need) all = 0;
      }
      for (int r = 0; r < DS_CS; ++r)
        cl.map_shared_rank(flags, r)[rank * Q + q] = all;
    }
    cl.sync();
    if (dbg) {  // effective blocked bits, for checking against the plain one
      const int nw = (nkeys + 31) / 32;
      unsigned* db = dbg + ((size_t)b * L + li) * Q * words + kt0 / 32;
      for (int i = tid; i < Q * nw; i += DS_THREADS) {
        const int q = i / nw, w = i % nw;
        int all = 1;
        for (int r = 0; r < DS_CS; ++r) all &= flags[r * Q + q];
        db[q * words + w] = all ? 0u : MK[q * words_loc + w];
      }
    }
    int clear = 1;
    for (int r = 0; r < DS_CS; ++r) clear &= flags[r * Q + aq];

    // 2. q projection of x + qpos
    for (int i = tid; i < QC; i += DS_THREADS)
      XA[i] = rd_bf16(__fadd_rn(X[i], qpos[i]));
    __syncthreads();
    dense_slice(cl, XA, Q, C, C, wl, C, fl, QB, EPI_RAW);

    // 3. masked cross-attention over this block's keys
    // q (pre-scaled, bf16 like the reference's operand) as bf16 pairs:
    // half the registers of f32, and the keys are read in pairs too
    __nv_bfloat162 qreg[HD / 2];
    float o[HD];
    float mx = -INFINITY, l = 0.f;
#pragma unroll
    for (int d = 0; d < HD / 2; ++d) {
      const float* qv = QB + aq * C + ah * HD + 2 * d;
      qreg[d] = active ? __floats2bfloat162_rn(qv[0] * scale, qv[1] * scale)
                       : __floats2bfloat162_rn(0.f, 0.f);
      o[2 * d] = 0.f;
      o[2 * d + 1] = 0.f;
    }
    const unsigned* mrow = MK + aq * words_loc;
    cl.sync();  // QB now serves as the (max, sum) exchange area
    for (int pass = 0; pass < 2; ++pass) {
      if (pass == 1 && active) {
        // combine the row max and sum of every block's keys
        float M = -INFINITY;
        for (int r = 0; r < DS_CS; ++r)
          M = fmaxf(M, QB[(r * pairs + tid) * 2]);
        float Ls = 0.f;
        for (int r = 0; r < DS_CS; ++r) {
          const float mr = QB[(r * pairs + tid) * 2];
          if (mr > -INFINITY) Ls += QB[(r * pairs + tid) * 2 + 1] * expf(mr - M);
        }
        mx = M;
        l = Ls;
      }
      for (int t0 = 0; t0 < nkeys; t0 += DS_TK) {
        __syncthreads();
        for (int i = tid; i < DS_TK * C; i += DS_THREADS) {
          const int tt = i / C, c = i % C;
          const bool in = t0 + tt < nkeys;
          const size_t row = (size_t)(kt0 + t0 + tt) * ldkv + c;
          Ks[i] = in ? Kb[row] : __float2bfloat16(0.f);
          if (pass == 1) Vs[i] = in ? Vb[row] : __float2bfloat16(0.f);
        }
        __syncthreads();
        if (!active) continue;
        const int nt = min(DS_TK, nkeys - t0);
        for (int tt = 0; tt < nt; ++tt) {
          const __nv_bfloat162* kr =
              reinterpret_cast<const __nv_bfloat162*>(Ks + tt * C + ah * HD);
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < HD / 2; ++d) {
            const float2 a = __bfloat1622float2(qreg[d]);
            const float2 k = __bfloat1622float2(kr[d]);
            s = fmaf(a.x, k.x, s);
            s = fmaf(a.y, k.y, s);
          }
          const int tl = t0 + tt;
          if (!clear && ((mrow[tl >> 5] >> (tl & 31)) & 1u))
            s = __fadd_rn(s, -1e9f);
          if (pass == 0) {
            if (s > mx) {
              l = l * expf(mx - s) + 1.f;
              mx = s;
            } else {
              l += expf(s - mx);
            }
          } else {
            const float pr = rd_bf16(expf(s - mx) / l);
            const __nv_bfloat162* vr = reinterpret_cast<const __nv_bfloat162*>(
                Vs + tt * C + ah * HD);
#pragma unroll
            for (int d = 0; d < HD / 2; ++d) {
              const float2 v = __bfloat1622float2(vr[d]);
              o[2 * d] = fmaf(pr, v.x, o[2 * d]);
              o[2 * d + 1] = fmaf(pr, v.y, o[2 * d + 1]);
            }
          }
        }
      }
      if (pass == 0) {
        if (active)
          for (int r = 0; r < DS_CS; ++r) {
            float* ex = cl.map_shared_rank(QB, r);
            ex[(rank * pairs + tid) * 2] = mx;
            ex[(rank * pairs + tid) * 2 + 1] = l;
          }
        cl.sync();
      }
    }
    if (active) {
#pragma unroll
      for (int d = 0; d < HD; ++d) OB[aq * C + ah * HD + d] = o[d];
    }
    reduce_slice(cl, OB, Q, C, nullptr, XA, EPI_RD);
    dense_slice(cl, XA, Q, C, C, wl + CC, C, fl + C, QB, EPI_RAW);
    layer_norm_rows(X, QB, X, Q, C, fl + 6 * C, fl + 7 * C, false);

    // 4. self-attention: v from x, q and k from x + qpos; block r takes
    //    heads h = r mod CS
    for (int i = tid; i < QC; i += DS_THREADS) XA[i] = rd_bf16(X[i]);
    __syncthreads();
    dense_slice(cl, XA, Q, C, C, wl + 4 * CC, C, fl + 4 * C, OB, EPI_RD);
    for (int i = tid; i < QC; i += DS_THREADS)
      XA[i] = rd_bf16(__fadd_rn(X[i], qpos[i]));
    __syncthreads();
    dense_slice(cl, XA, Q, C, C, wl + 2 * CC, C, fl + 2 * C, QB, EPI_RAW);
    dense_slice(cl, XA, Q, C, C, wl + 3 * CC, C, fl + 3 * C, XA, EPI_RD);
    {
      // block r takes heads h = r mod CS; scores for every (head, query,
      // key) in the bf16 chunk area (free here), one thread each
      float* S = reinterpret_cast<float*>(Ks);
      const int my_heads = (heads - rank + DS_CS - 1) / DS_CS;
      for (int e = tid; e < my_heads * Q * Q; e += DS_THREADS) {
        const int hi = e / (Q * Q), q = (e / Q) % Q, j = e % Q;
        const int h = rank + DS_CS * hi;
        const float* qv = QB + q * C + h * HD;
        const float* kv = XA + j * C + h * HD;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) s = fmaf(rd_bf16(qv[d] * scale), kv[d], s);
        S[e] = s;
      }
      __syncthreads();
      for (int row = warp; row < my_heads * Q; row += DS_THREADS / 32) {
        float* sr = S + row * Q;
        float m2 = -INFINITY;
        for (int j = lane; j < Q; j += 32) m2 = fmaxf(m2, sr[j]);
        m2 = warp_max(m2);
        float l2 = 0.f;
        for (int j = lane; j < Q; j += 32) l2 += expf(sr[j] - m2);
        l2 = warp_sum(l2);
        for (int j = lane; j < Q; j += 32) sr[j] = rd_bf16(expf(sr[j] - m2) / l2);
      }
      __syncthreads();
      // head h's q columns are read only above, so every replica's QB
      // takes the output in their place
      for (int e = tid; e < my_heads * Q * HD; e += DS_THREADS) {
        const int hi = e / (Q * HD), q = (e / HD) % Q, d = e % HD;
        const int h = rank + DS_CS * hi;
        const float* sr = S + (hi * Q + q) * Q;
        float o2 = 0.f;
        for (int j = 0; j < Q; ++j) o2 = fmaf(sr[j], OB[j * C + h * HD + d], o2);
        o2 = rd_bf16(o2);
        for (int r = 0; r < DS_CS; ++r)
          cl.map_shared_rank(QB, r)[q * C + h * HD + d] = o2;
      }
    }
    cl.sync();
    dense_slice(cl, QB, Q, C, C, wl + 5 * CC, C, fl + 5 * C, QB, EPI_RAW);
    layer_norm_rows(X, QB, X, Q, C, fl + 8 * C, fl + 9 * C, false);

    // 5. ReLU FFN: block r's hidden units [r Fr, (r+1) Fr) into QB, its
    //    partial second product into OB, reduced over the cluster
    for (int i = tid; i < QC; i += DS_THREADS) XA[i] = rd_bf16(X[i]);
    __syncthreads();
    {
      const bf16* f1 = wl + 6 * CC;
      const bf16* f2 = f1 + (size_t)C * F;
      const float* fb1 = fl + 12 * C;
      const float* fb2 = fb1 + F;
      const int n = tid & 255, rg = tid >> 8;
      const int h0 = rank * Fr;
      float acc[DS_RPT];
#pragma unroll
      for (int i = 0; i < DS_RPT; ++i) acc[i] = 0.f;
      if (n < Fr) mm_rows(acc, XA, C, Q, C, f1 + h0 + n, F, rg);
      if (n < Fr) {
#pragma unroll
        for (int i = 0; i < DS_RPT; ++i) {
          const int m = rg + 2 * i;
          if (m < Q)
            QB[m * C + n] =
                rd_bf16(fmaxf(__fadd_rn(acc[i], fb1[h0 + n]), 0.f));
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < DS_RPT; ++i) acc[i] = 0.f;
      if (n < C) {
        mm_rows(acc, QB, C, Q, Fr, f2 + (size_t)h0 * C + n, C, rg);
#pragma unroll
        for (int i = 0; i < DS_RPT; ++i) {
          const int m = rg + 2 * i;
          if (m < Q) OB[m * C + n] = acc[i];
        }
      }
      reduce_slice(cl, OB, Q, C, fb2, QB, EPI_RAW);
    }
    layer_norm_rows(X, QB, X, Q, C, fl + 10 * C, fl + 11 * C, false);

    // 6. next mask embedding: decoder norm + 3-layer MLP -> OB
    if (li + 1 < L) {
      layer_norm_rows(X, nullptr, XA, Q, C, fh, fh + C, true);
      dense_slice(cl, XA, Q, C, C, wh, C, fh + 2 * C, QB, EPI_RELU_RD);
      dense_slice(cl, QB, Q, C, C, wh + CC, C, fh + 3 * C, XA, EPI_RELU_RD);
      dense_slice(cl, XA, Q, C, C, wh + 2 * CC, C, fh + 4 * C, OB, EPI_RD);
    }
  }
  const int ncol = C / DS_CS;
  for (int i = tid; i < Q * ncol; i += DS_THREADS) {
    const int m = i / ncol, c = rank * ncol + i % ncol;
    out[(size_t)b * QC + m * C + c] = __float2bfloat16_rn(X[m * C + c]);
  }
  cl.sync();  // no block leaves while another may still access its memory
}

template <int HD>
static int launch_stack(const float* x0, const float* emb0,
                        const float* qpos, const DecPtrs& p, int nl, int G,
                        const bf16* wd, const float* wf, bf16* out,
                        unsigned* dbg, int B, int Q, int C, int F, int heads,
                        int words, int words_loc, int smem, float scale,
                        cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      decoder_stack_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * DS_CS);
  cfg.blockDim = dim3(DS_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DS_CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decoder_stack_kernel<HD>, x0, emb0, qpos, p,
                         nl, G, wd, wf, out, dbg, Q, C, F, heads, words,
                         words_loc, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ptrs: host array of 9 device pointers (k, v, resized features per
// level); T: 3 ints; scale: hd^-0.5; dbg: null, or (B, L, Q, words) words
// that receive each layer's effective blocked bits; smem: bytes per block
MB_EXPORT int decoder_stack_forward(const float* x0, const float* emb0,
                                    const float* qpos, void* const* ptrs,
                                    const int* T, int nl, int G,
                                    const bf16* wd, const float* wf,
                                    bf16* out, unsigned* dbg, int B, int Q,
                                    int C, int F, int heads, int smem,
                                    float scale, cudaStream_t stream) {
  const int ncol = C / DS_CS;
  if (nl < 1 || nl > 3 || C % DS_CS || C > 256 || ncol % 4 || F % DS_CS ||
      F / DS_CS > C || Q > 48 || Q > 4 * (DS_THREADS / ncol) || C % heads ||
      heads * Q > DS_THREADS || C < 16 * heads ||
      (heads + DS_CS - 1) / DS_CS * Q * Q > DS_TK * C)
    return MB_BAD_ARGS;
  DecPtrs p;
  int tmax = 0;
  for (int l = 0; l < 3; ++l) {
    p.K[l] = (const bf16*)ptrs[l];
    p.V[l] = (const bf16*)ptrs[3 + l];
    p.F[l] = (const float*)ptrs[6 + l];
    p.T[l] = T[l];
    if (l < nl && T[l] > tmax) tmax = T[l];
  }
  const int words = (tmax + 31) / 32;
  const int words_loc = ((tmax + DS_CS - 1) / DS_CS + 31) / 32;
  const int hd = C / heads;
  if (hd == 32)
    return launch_stack<32>(x0, emb0, qpos, p, nl, G, wd, wf, out, dbg, B, Q,
                            C, F, heads, words, words_loc, smem, scale,
                            stream);
  if (hd == 64)
    return launch_stack<64>(x0, emb0, qpos, p, nl, G, wd, wf, out, dbg, B, Q,
                            C, F, heads, words, words_loc, smem, scale,
                            stream);
  return MB_BAD_ARGS;
}
