// Kernel 5: every Mask2Former decoder layer of the final_only path.
//
// Replaces mask_bev_tpu/ops/pallas_decoder_stack.py::fused_decoder_stack
// (_stack_kernel). One thread-block cluster of DS_CS = 8 blocks per batch
// element runs all layers: at the flagship's 220 KB of shared memory a
// block, 15 clusters of 8 fit the H100 at once and only 7 of 12 or 16
// (chip_smoke.py prints cudaOccupancyMaxActiveClusters), so 8 runs a batch
// of 8 in one wave where 16 needs two. Each block
// holds a replica of the (Q, C) f32 query state and of every (Q, C)
// intermediate in its shared memory; the blocks split the work and exchange
// results through distributed shared memory, so nothing returns to device
// memory between layers:
//   * dense products: block r computes output columns [r C/8, (r+1) C/8)
//     for all queries and writes them into every block's buffer;
//   * the FFN: block r takes hidden units [r F/8, (r+1) F/8); the second
//     product's partial sums are reduced column slice by column slice;
//   * mask logits and cross-attention: block r takes a 32-aligned slice of
//     the keys; the row max and sum are combined across the cluster before
//     the exact probabilities (rounded to bf16 like the reference's softmax
//     output) weight v, and the partial outputs are reduced like the FFN's;
//   * self-attention over the Q queries: block r takes heads h = r mod 8;
//   * LayerNorms run redundantly on every replica.
// The k and v projections of the level memories do not depend on the
// queries, so the chain computes them beforehand with the GEMM (gemm.cuh),
// one launch per level and projection.
//
// Per layer li = 3g + lvl: attention-mask bits m = emb . feat^T < 0 (f32,
// rows that block every position cleared); q projection; masked
// cross-attention; out projection, LN1; self-attention, LN2; ReLU FFN,
// LN3; the next mask embedding (decoder norm, 3-layer MLP). Every product
// takes bf16-rounded operands with f32 accumulation and an f32 bias, as the
// TPU kernel's _dot does.
//
// What bounds it on the H100: the serial chain of small products. The
// query-side work is ~1.5 GFLOP per batch element at the flagship (45
// queries, 9 layers, FFN 2048, up to 3969 keys): 0.05 ms at the bf16 peak
// for batch 8, so latency and synchronisation decide. The first version ran
// every product as CUDA-core FMAs (one thread per (head, query) walking its
// keys one at a time in cross-attention, one warp per key for the mask
// logits) on 64 SMs. This design:
//   * every query-side product runs on the tensor cores (mma.sync m16n8k16,
//     bf16 operands, f32 accumulation, Q padded to 48): one warp per 16 x 8
//     output tile; A fragments come from the f32 replicas (row stride C + 4,
//     so the fragment loads are free of bank conflicts), B fragments from
//     weights that the host packs in fragment order (ops/decoder_stack.py::
//     pack_fragments), one 8-byte load per lane and k-step, eight k-steps
//     of loads in flight before the first product;
//   * cross-attention on tensor-core tiles: keys arrive 32 at a time by
//     16-byte cp.async, each warp takes (head, 16-query) tasks, S = q k^T in
//     registers with the mask bits applied there; pass 1 the exact row max
//     and sum, pass 2 P = rd_bf16(exp(s - M) / L) in registers as the A
//     operand of P v;
//   * the mask logits keep the f32 product's sign within its rounding: the
//     mask embedding holds bf16 values and each f32 feature is split into
//     three bf16 terms (hi, mid, lo: 24 bits), so three bf16 products with
//     f32 accumulation give the f32 product to within f32 rounding.
#include "decoder_common.cuh"

#define DS_THREADS 384
#define DS_WARPS (DS_THREADS / 32)
#define DS_TK 32  // keys per cross-attention tile
#define DS_SLOTS 2  // cross-attention tasks a warp holds (heads * Q/16 <= 24)
#define DS_CS 8     // blocks per cluster (one cluster per batch element)

__device__ __forceinline__ float epi(float v, int mode) {
  if (mode == EPI_RELU_RD) return rd_bf16(fmaxf(v, 0.f));
  if (mode == EPI_RD) return rd_bf16(v);
  return v;
}

// A fragment of rows 16 mt.. and columns k0.. of an f32 shared matrix that
// holds bf16 values (row stride lda); rows >= Q read as 0
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const float* A,
                                       int lda, int Q, int mt, int k0,
                                       int lane) {
  const int r0 = 16 * mt + (lane >> 2), r1 = r0 + 8;
  const float* p0 = A + r0 * lda + k0 + 2 * (lane & 3);
  const float* p1 = p0 + 8 * lda;
  const float2 z = make_float2(0.f, 0.f);
  const float2 x0 = r0 < Q ? *reinterpret_cast<const float2*>(p0) : z;
  const float2 x1 = r1 < Q ? *reinterpret_cast<const float2*>(p1) : z;
  const float2 x2 = r0 < Q ? *reinterpret_cast<const float2*>(p0 + 8) : z;
  const float2 x3 = r1 < Q ? *reinterpret_cast<const float2*>(p1 + 8) : z;
  a[0] = pack_bf16(x0.x, x0.y);
  a[1] = pack_bf16(x1.x, x1.y);
  a[2] = pack_bf16(x2.x, x2.y);
  a[3] = pack_bf16(x3.x, x3.y);
}

// c += A[16 mt.., 16 s] . W[16 (ks0 + s), 8 j..] for s < nks: one 16 x 8
// output tile. A as in frag_a (its columns from 0), Wp the (K, N) weight
// in fragment order: uint2 ((j K/16 + ks) 32 + lane)
__device__ __forceinline__ void mm_tile(float (&c)[4], const float* A,
                                        int lda, int Q, int mt,
                                        const bf16* __restrict__ Wp, int K,
                                        int j, int ks0, int nks, int lane) {
  const uint2* wb = reinterpret_cast<const uint2*>(Wp) +
                    ((size_t)j * (K / 16) + ks0) * 32 + lane;
  for (int s0 = 0; s0 < nks; s0 += 8) {
    uint2 b[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (s0 + u < nks) b[u] = __ldg(wb + (size_t)(s0 + u) * 32);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (s0 + u < nks) {
        uint32_t a[4];
        frag_a(a, A, lda, Q, mt, 16 * (s0 + u), lane);
        mma_16816(c, a, b[u].x, b[u].y);
      }
    }
  }
}

// dst[m][c0 + n] (every block) = epi(A . W[:, c0 + n] + bias) for this
// block's column slice c0 = rank C/DS_CS; one warp per 16 x 8 tile. A and
// dst (Q x C, row stride ldx) live in shared memory; dst may alias A.
__device__ void dense_slice(cg::cluster_group& cl, const float* A, int Q,
                            int C, int ldx, const bf16* __restrict__ Wp,
                            const float* __restrict__ bias, float* dst,
                            int mode) {
  const int nj = C / DS_CS / 8, c0 = (int)cl.block_rank() * (C / DS_CS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp / nj, j = warp % nj;
  const bool on = mt * 16 < Q;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  if (on) mm_tile(c, A, ldx, Q, mt, Wp, C, c0 / 8 + j, 0, C / 16, lane);
  cl.sync();  // every block has read its A before any block writes dst
  if (on) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 16 * mt + (lane >> 2) + 8 * (e >> 1);
      const int n = c0 + 8 * j + 2 * (lane & 3) + (e & 1);
      if (m < Q) {
        const float v = epi(__fadd_rn(c[e], bias[n]), mode);
        for (int r = 0; r < DS_CS; ++r) cl.map_shared_rank(dst, r)[m * ldx + n] = v;
      }
    }
  }
  cl.sync();
}

// dst[m][c] (every block) = epi(sum over the cluster of part[m][c] [+ bias])
// for this block's column slice
__device__ void reduce_slice(cg::cluster_group& cl, float* part, int Q,
                             int C, int ldx, const float* __restrict__ bias,
                             float* dst, int mode) {
  const int ncol = C / DS_CS;
  const int c0 = (int)cl.block_rank() * ncol;
  cl.sync();  // every partial is complete
  for (int i = threadIdx.x; i < Q * ncol; i += DS_THREADS) {
    const int m = i / ncol, c = c0 + i % ncol;
    float s = 0.f;
    for (int r = 0; r < DS_CS; ++r) s += cl.map_shared_rank(part, r)[m * ldx + c];
    if (bias) s = __fadd_rn(s, bias[c]);
    s = epi(s, mode);
    for (int r = 0; r < DS_CS; ++r) cl.map_shared_rank(dst, r)[m * ldx + c] = s;
  }
  cl.sync();
}

// LN over rows of (X [+ Y]) -> dst (rounded to bf16 when rd), eps 1e-6;
// local to the block (every replica computes the same values)
__device__ void layer_norm_rows(float* X, const float* Y, float* dst, int Q,
                                int C, int ldx, const float* w,
                                const float* b, bool rd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < Q; m += DS_WARPS) {
    float* xr = X + m * ldx;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) {
      float v = xr[c];
      if (Y) {
        v = __fadd_rn(v, Y[m * ldx + c]);
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
      dst[m * ldx + c] = rd ? rd_bf16(v) : v;
    }
  }
  __syncthreads();
}

// three bf16 terms of an f32 pair: x = hi + mid + lo to within 2^-24 |x|
__device__ __forceinline__ void split3(float2 x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const float hx = rd_bf16(x.x), hy = rd_bf16(x.y);
  const float rx = x.x - hx, ry = x.y - hy;
  const float mx = rd_bf16(rx), my = rd_bf16(ry);
  hi = pack_bf16(hx, hy);
  mid = pack_bf16(mx, my);
  lo = pack_bf16(rx - mx, ry - my);
}

// CT: the width C when it is known at compile time (the flagship's 256),
// so that shared-memory offsets fold into immediates; 0 reads it from C_in
template <int HD, int CT>
__global__ void __launch_bounds__(DS_THREADS, 1) decoder_stack_kernel(
    const float* __restrict__ x0, const float* __restrict__ emb0,
    const float* __restrict__ qpos, DecPtrs p, int nl, int G,
    const bf16* __restrict__ wd, const float* __restrict__ wf,
    bf16* __restrict__ out, unsigned* __restrict__ dbg, int Q, int C_in,
    int F, int heads, int words, int words_loc, float scale) {
  const int C = CT > 0 ? CT : C_in;
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int ldx = C + 4;   // f32 row stride: conflict-free fragment loads
  const int ldk = C + 8;   // bf16 row stride of the key tiles and q
  const int mtq = (Q + 15) / 16;
  // shared memory in 4-byte words, every part 16-byte aligned (the host's
  // ops/decoder_stack.py::smem_bytes mirrors this layout)
  const int QX = Q * ldx;
  const int XAW = max(QX, 16 * mtq * ldk / 2);  // XA, or the bf16 q copy
  float* X = sm;
  float* XA = X + QX;
  float* QB = XA + XAW;
  float* OB = QB + QX;
  unsigned* MK = reinterpret_cast<unsigned*>(OB + QX);  // Q x words_loc
  int* flags = reinterpret_cast<int*>(MK + (Q * words_loc + 3) / 4 * 4);
  bf16* Kt = reinterpret_cast<bf16*>(flags + (DS_CS * Q + 3) / 4 * 4);
  bf16* Vt = Kt + DS_TK * ldk;  // both DS_TK x ldk
  bf16* qb = reinterpret_cast<bf16*>(XA);  // scaled bf16 q, 16 mtq x ldk

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / DS_CS;
  const int L = nl * G;
  const size_t WL = 6 * (size_t)C * C + 2 * (size_t)C * F;
  const size_t FL = 13 * (size_t)C + F;
  const size_t CC = (size_t)C * C;
  const bf16* wh = wd + L * WL;
  const float* fh = wf + L * FL;
  const int ldkv = G * C;
  const int pairs = heads * Q;
  const int Fr = F / DS_CS;  // hidden units of this block

  for (int i = tid; i < Q * C; i += DS_THREADS) {
    const int m = i / C, c = i % C;
    X[m * ldx + c] = x0[(size_t)b * Q * C + i];
    OB[m * ldx + c] = emb0[(size_t)b * Q * C + i];
  }
  cl.sync();  // every block of the cluster runs before any remote access

  for (int li = 0; li < L; ++li) {
    const int lvl = li % nl, grp = li / nl;
    const int T = p.T[lvl];
    // this block's keys: a 32-aligned slice, so mask words never straddle
    const int chunk = ((T + DS_CS - 1) / DS_CS + 31) / 32 * 32;
    const int kt0 = min(T, rank * chunk), kt1 = min(T, kt0 + chunk);
    const int nkeys = kt1 - kt0;
    const float* feat = p.F[lvl] + ((size_t)b * T + kt0) * C;
    const bf16* Kb = p.K[lvl] + ((size_t)b * T + kt0) * ldkv + grp * C;
    const bf16* Vb = p.V[lvl] + ((size_t)b * T + kt0) * ldkv + grp * C;
    const bf16* wl = wd + li * WL;
    const float* fl = wf + li * FL;

    // 1. attention-mask bits of this block's keys (emb in OB): one warp per
    //    16 keys and all query tiles, three bf16 products per f32 feature
    for (int i = tid; i < Q * words_loc; i += DS_THREADS) MK[i] = 0u;
    __syncthreads();
    for (int kg = warp; kg * 16 < nkeys; kg += DS_WARPS) {
      float c[3][2][4];
#pragma unroll
      for (int mt = 0; mt < 3; ++mt)
#pragma unroll
        for (int jn = 0; jn < 2; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[mt][jn][e] = 0.f;
      // the next k-step's features are in flight during this one's products
      float2 fn[2][2];
      auto load_feat = [&](int k0) {
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          const int key = 16 * kg + 8 * jn + g;
          const float* fr = feat + (size_t)key * C + k0 + 2 * t4;
          const float2 z = make_float2(0.f, 0.f);
          fn[jn][0] = key < nkeys ? *reinterpret_cast<const float2*>(fr) : z;
          fn[jn][1] =
              key < nkeys ? *reinterpret_cast<const float2*>(fr + 8) : z;
        }
      };
      load_feat(0);
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t bh[2][2], bm[2][2], bl[2][2];
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          split3(fn[jn][0], bh[jn][0], bm[jn][0], bl[jn][0]);
          split3(fn[jn][1], bh[jn][1], bm[jn][1], bl[jn][1]);
        }
        if (k0 + 16 < C) load_feat(k0 + 16);
#pragma unroll
        for (int mt = 0; mt < 3; ++mt) {
          if (mt >= mtq) break;
          uint32_t a[4];
          frag_a(a, OB, ldx, Q, mt, k0, lane);
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
            mma_16816(c[mt][jn], a, bl[jn][0], bl[jn][1]);
            mma_16816(c[mt][jn], a, bm[jn][0], bm[jn][1]);
            mma_16816(c[mt][jn], a, bh[jn][0], bh[jn][1]);
          }
        }
      }
      const int word = kg >> 1, sh = 16 * (kg & 1);
#pragma unroll
      for (int mt = 0; mt < 3; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          unsigned bits = 0u;
#pragma unroll
          for (int jn = 0; jn < 2; ++jn)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int tl = 16 * kg + 8 * jn + 2 * t4 + e;
              if (tl < nkeys && c[mt][jn][2 * hh + e] < 0.f)
                bits |= 1u << (sh + 8 * jn + 2 * t4 + e);
            }
          bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
          bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
          const int q = 16 * mt + g + 8 * hh;
          if (t4 == 0 && q < Q && bits) atomicOr(&MK[q * words_loc + word], bits);
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

    // 2. q projection of x + qpos
    for (int i = tid; i < Q * C; i += DS_THREADS) {
      const int m = i / C, c = i % C;
      XA[m * ldx + c] = rd_bf16(__fadd_rn(X[m * ldx + c], qpos[i]));
    }
    __syncthreads();
    dense_slice(cl, XA, Q, C, ldx, wl, fl, QB, EPI_RAW);

    // 3. masked cross-attention over this block's keys. q, pre-scaled and
    //    rounded to bf16 like the reference's operand, goes to qb (XA's
    //    space); tasks (head, 16 queries) over the warps
    for (int i = tid; i < 16 * mtq * C; i += DS_THREADS) {
      const int m = i / C, c = i % C;
      qb[m * ldk + c] = __float2bfloat16_rn(m < Q ? QB[m * ldx + c] * scale : 0.f);
    }
    __syncthreads();
    cl.sync();  // QB now serves as the (max, sum) exchange area
    const int ntask = heads * mtq;
    float o[DS_SLOTS][HD / 8][4];
    float mx[DS_SLOTS][2], ls[DS_SLOTS][2];
    bool clr[DS_SLOTS][2];
#pragma unroll
    for (int sl = 0; sl < DS_SLOTS; ++sl) {
      const int mt = (warp + DS_WARPS * sl) % mtq;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[sl][hh] = -INFINITY;
        ls[sl][hh] = 0.f;
        const int q = 16 * mt + g + 8 * hh;
        int all = q < Q;
        if (all)
          for (int r = 0; r < DS_CS; ++r) all &= flags[r * Q + q];
        clr[sl][hh] = all;
      }
#pragma unroll
      for (int jd = 0; jd < HD / 8; ++jd)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[sl][jd][e] = 0.f;
    }
    for (int pass = 0; pass < 2; ++pass) {
      if (pass == 1) {
        // combine the row max and sum of every block's keys
#pragma unroll
        for (int sl = 0; sl < DS_SLOTS; ++sl) {
          const int task = warp + DS_WARPS * sl;
          if (task >= ntask) continue;
          const int h = task / mtq, mt = task % mtq;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int q = 16 * mt + g + 8 * hh;
            float M = 0.f, Ls = 1.f;
            if (q < Q) {
              const int pi = h * Q + q;
              M = -INFINITY;
              for (int r = 0; r < DS_CS; ++r) M = fmaxf(M, QB[(r * pairs + pi) * 2]);
              Ls = 0.f;
              for (int r = 0; r < DS_CS; ++r) {
                const float mr = QB[(r * pairs + pi) * 2];
                if (mr > -INFINITY) Ls += QB[(r * pairs + pi) * 2 + 1] * expf(mr - M);
              }
            }
            mx[sl][hh] = M;
            ls[sl][hh] = Ls;
          }
        }
      }
      for (int t0 = 0; t0 < nkeys; t0 += DS_TK) {
        __syncthreads();  // the previous tile is read
        const int c8n = C / 8;
        for (int i = tid; i < DS_TK * c8n; i += DS_THREADS) {
          const int tt = i / c8n, c8 = (i % c8n) * 8;
          const bool in = t0 + tt < nkeys;
          const size_t row = (size_t)(t0 + tt) * ldkv + c8;
          if (in) {
            cp_async16(Kt + tt * ldk + c8, Kb + row);
            if (pass == 1) cp_async16(Vt + tt * ldk + c8, Vb + row);
          } else {
            *reinterpret_cast<uint4*>(Kt + tt * ldk + c8) = make_uint4(0, 0, 0, 0);
            *reinterpret_cast<uint4*>(Vt + tt * ldk + c8) = make_uint4(0, 0, 0, 0);
          }
        }
        cp_async_wait_all();
        __syncthreads();
#pragma unroll
        for (int sl = 0; sl < DS_SLOTS; ++sl) {
          const int task = warp + DS_WARPS * sl;
          if (task >= ntask) continue;
          const int h = task / mtq, mt = task % mtq;
          float s[4][4];
#pragma unroll
          for (int jn = 0; jn < 4; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[jn][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            uint32_t qa[4];
            ldsm_x4(qa, qb + (16 * mt + (lane & 15)) * ldk + h * HD + kk * 16 +
                            (lane >> 4) * 8);
#pragma unroll
            for (int jn = 0; jn < 4; ++jn) {
              uint32_t b0, b1;
              ldsm_x2(b0, b1, Kt + (8 * jn + (lane & 7)) * ldk + h * HD +
                                  kk * 16 + ((lane >> 3) & 1) * 8);
              mma_16816(s[jn], qa, b0, b1);
            }
          }
#pragma unroll
          for (int jn = 0; jn < 4; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hh = e >> 1;
              const int q = 16 * mt + g + 8 * hh;
              const int tl = t0 + 8 * jn + 2 * t4 + (e & 1);
              if (tl >= nkeys) {
                s[jn][e] = -INFINITY;
              } else if (q < Q && !clr[sl][hh] &&
                         ((MK[q * words_loc + (tl >> 5)] >> (tl & 31)) & 1u)) {
                s[jn][e] = __fadd_rn(s[jn][e], -1e9f);
              }
            }
          if (pass == 0) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float tm = -INFINITY;
#pragma unroll
              for (int jn = 0; jn < 4; ++jn)
                tm = fmaxf(tm, fmaxf(s[jn][2 * hh], s[jn][2 * hh + 1]));
              const float nm = fmaxf(mx[sl][hh], tm);
              if (nm == -INFINITY) continue;
              float add = 0.f;
#pragma unroll
              for (int jn = 0; jn < 4; ++jn)
                add += expf(s[jn][2 * hh] - nm) + expf(s[jn][2 * hh + 1] - nm);
              ls[sl][hh] = ls[sl][hh] * expf(mx[sl][hh] - nm) + add;
              mx[sl][hh] = nm;
            }
          } else {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              uint32_t pa[4];
#pragma unroll
              for (int hf = 0; hf < 2; ++hf)
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                  const float* sv = s[2 * u + hf];
                  const float M = mx[sl][hh], Ls = ls[sl][hh];
                  pa[2 * hf + hh] =
                      pack_bf16(expf(sv[2 * hh] - M) / Ls,
                                expf(sv[2 * hh + 1] - M) / Ls);
                }
#pragma unroll
              for (int jd = 0; jd < HD / 8; ++jd) {
                uint32_t b0, b1;
                ldsm_x2_trans(b0, b1, Vt + (16 * u + (lane & 15)) * ldk +
                                          h * HD + 8 * jd);
                mma_16816(o[sl][jd], pa, b0, b1);
              }
            }
          }
        }
      }
      if (pass == 0) {
        // this block's row max and sum: merge the quad, then send them
#pragma unroll
        for (int sl = 0; sl < DS_SLOTS; ++sl) {
          const int task = warp + DS_WARPS * sl;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float m = mx[sl][hh], l = ls[sl][hh];
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
            if (task >= ntask) continue;
            const int h = task / mtq, q = 16 * (task % mtq) + g + 8 * hh;
            if (t4 == 0 && q < Q)
              for (int r = 0; r < DS_CS; ++r) {
                float* ex = cl.map_shared_rank(QB, r);
                ex[(rank * pairs + h * Q + q) * 2] = m;
                ex[(rank * pairs + h * Q + q) * 2 + 1] = l;
              }
          }
        }
        cl.sync();
      }
    }
#pragma unroll
    for (int sl = 0; sl < DS_SLOTS; ++sl) {
      const int task = warp + DS_WARPS * sl;
      if (task >= ntask) continue;
      const int h = task / mtq, mt = task % mtq;
#pragma unroll
      for (int jd = 0; jd < HD / 8; ++jd)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = 16 * mt + g + 8 * (e >> 1);
          if (q < Q) OB[q * ldx + h * HD + 8 * jd + 2 * t4 + (e & 1)] = o[sl][jd][e];
        }
    }
    reduce_slice(cl, OB, Q, C, ldx, nullptr, XA, EPI_RD);
    dense_slice(cl, XA, Q, C, ldx, wl + CC, fl + C, QB, EPI_RAW);
    layer_norm_rows(X, QB, X, Q, C, ldx, fl + 6 * C, fl + 7 * C, false);

    // 4. self-attention: v from x, q and k from x + qpos; block r takes
    //    heads h = r mod DS_CS
    for (int i = tid; i < Q * C; i += DS_THREADS) {
      const int m = i / C, c = i % C;
      XA[m * ldx + c] = rd_bf16(X[m * ldx + c]);
    }
    __syncthreads();
    dense_slice(cl, XA, Q, C, ldx, wl + 4 * CC, fl + 4 * C, OB, EPI_RD);
    for (int i = tid; i < Q * C; i += DS_THREADS) {
      const int m = i / C, c = i % C;
      XA[m * ldx + c] = rd_bf16(__fadd_rn(X[m * ldx + c], qpos[i]));
    }
    __syncthreads();
    dense_slice(cl, XA, Q, C, ldx, wl + 2 * CC, fl + 2 * C, QB, EPI_RAW);
    dense_slice(cl, XA, Q, C, ldx, wl + 3 * CC, fl + 3 * C, XA, EPI_RD);
    {
      // block r takes heads h = r mod DS_CS; scores for every (head, query,
      // key) in the key-tile area (free here), one thread each
      float* S = reinterpret_cast<float*>(Kt);
      const int my_heads = (heads - rank + DS_CS - 1) / DS_CS;
      for (int e = tid; e < my_heads * Q * Q; e += DS_THREADS) {
        const int hi = e / (Q * Q), q = (e / Q) % Q, j = e % Q;
        const int h = rank + DS_CS * hi;
        const float* qv = QB + q * ldx + h * HD;
        const float* kv = XA + j * ldx + h * HD;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) s = fmaf(rd_bf16(qv[d] * scale), kv[d], s);
        S[e] = s;
      }
      __syncthreads();
      for (int row = warp; row < my_heads * Q; row += DS_WARPS) {
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
        for (int j = 0; j < Q; ++j) o2 = fmaf(sr[j], OB[j * ldx + h * HD + d], o2);
        o2 = rd_bf16(o2);
        for (int r = 0; r < DS_CS; ++r)
          cl.map_shared_rank(QB, r)[q * ldx + h * HD + d] = o2;
      }
    }
    cl.sync();
    dense_slice(cl, QB, Q, C, ldx, wl + 5 * CC, fl + 5 * C, QB, EPI_RAW);
    layer_norm_rows(X, QB, X, Q, C, ldx, fl + 8 * C, fl + 9 * C, false);

    // 5. ReLU FFN: block r's hidden units [r Fr, (r+1) Fr) into QB, its
    //    partial second product into OB, reduced over the cluster
    for (int i = tid; i < Q * C; i += DS_THREADS) {
      const int m = i / C, c = i % C;
      XA[m * ldx + c] = rd_bf16(X[m * ldx + c]);
    }
    __syncthreads();
    {
      const bf16* f1 = wl + 6 * CC;
      const bf16* f2 = f1 + (size_t)C * F;
      const float* fb1 = fl + 12 * C;
      const float* fb2 = fb1 + F;
      const int h0 = rank * Fr;
      for (int task = warp; task < mtq * (Fr / 8); task += DS_WARPS) {
        const int mt = task / (Fr / 8), j = task % (Fr / 8);
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mm_tile(c, XA, ldx, Q, mt, f1, C, h0 / 8 + j, 0, C / 16, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 16 * mt + g + 8 * (e >> 1), n = 8 * j + 2 * t4 + (e & 1);
          if (m < Q) QB[m * ldx + n] = rd_bf16(fmaxf(__fadd_rn(c[e], fb1[h0 + n]), 0.f));
        }
      }
      __syncthreads();
      for (int task = warp; task < mtq * (C / 8); task += DS_WARPS) {
        const int mt = task / (C / 8), j = task % (C / 8);
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mm_tile(c, QB, ldx, Q, mt, f2, F, j, h0 / 16, Fr / 16, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 16 * mt + g + 8 * (e >> 1), n = 8 * j + 2 * t4 + (e & 1);
          if (m < Q) OB[m * ldx + n] = c[e];
        }
      }
      reduce_slice(cl, OB, Q, C, ldx, fb2, QB, EPI_RAW);
    }
    layer_norm_rows(X, QB, X, Q, C, ldx, fl + 10 * C, fl + 11 * C, false);

    // 6. next mask embedding: decoder norm + 3-layer MLP -> OB
    if (li + 1 < L) {
      layer_norm_rows(X, nullptr, XA, Q, C, ldx, fh, fh + C, true);
      dense_slice(cl, XA, Q, C, ldx, wh, fh + 2 * C, QB, EPI_RELU_RD);
      dense_slice(cl, QB, Q, C, ldx, wh + CC, fh + 3 * C, XA, EPI_RELU_RD);
      dense_slice(cl, XA, Q, C, ldx, wh + 2 * CC, fh + 4 * C, OB, EPI_RD);
    }
  }
  const int ncol = C / DS_CS;
  for (int i = tid; i < Q * ncol; i += DS_THREADS) {
    const int m = i / ncol, c = rank * ncol + i % ncol;
    out[(size_t)b * Q * C + m * C + c] = __float2bfloat16_rn(X[m * ldx + c]);
  }
  cl.sync();  // no block leaves while another may still access its memory
}

template <int HD, int CT>
static cudaError_t stack_config(cudaLaunchConfig_t& cfg,
                                cudaLaunchAttribute* attr, int B, int smem,
                                cudaStream_t stream) {
  auto kern = decoder_stack_kernel<HD, CT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(B * DS_CS);
  cfg.blockDim = dim3(DS_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DS_CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return e;
}

template <int HD, int CT>
static int launch_stack(const float* x0, const float* emb0,
                        const float* qpos, const DecPtrs& p, int nl, int G,
                        const bf16* wd, const float* wf, bf16* out,
                        unsigned* dbg, int B, int Q, int C, int F, int heads,
                        int words, int words_loc, int smem, float scale,
                        cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = stack_config<HD, CT>(cfg, attr, B, smem, stream);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  e = cudaLaunchKernelEx(&cfg, decoder_stack_kernel<HD, CT>, x0, emb0, qpos,
                         p, nl, G, wd, wf, out, dbg, Q, C, F, heads, words,
                         words_loc, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of ``cs`` blocks (8, 12 or 16) of the kernel with
// ``smem`` bytes of shared memory can be resident at once: the size that
// runs all batch elements of a request in one wave is the one to build.
MB_EXPORT int decoder_stack_max_clusters(int cs, int smem, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = stack_config<32, 256>(cfg, attr, 1, smem, 0);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(decoder_stack_kernel<32, 256>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  cfg.gridDim = dim3(cs * 8);
  attr[0].val.clusterDim.x = cs;
  return (int)cudaOccupancyMaxActiveClusters(
      out, (void*)decoder_stack_kernel<32, 256>, &cfg);
}

// ptrs: host array of 9 device pointers (k, v, resized features per
// level); T: 3 ints; scale: hd^-0.5; dbg: null, or (B, L, Q, words) words
// that receive each layer's effective blocked bits; smem: bytes per block;
// wd: the bf16 weights in fragment order
MB_EXPORT int decoder_stack_forward(const float* x0, const float* emb0,
                                    const float* qpos, void* const* ptrs,
                                    const int* T, int nl, int G,
                                    const bf16* wd, const float* wf,
                                    bf16* out, unsigned* dbg, int B, int Q,
                                    int C, int F, int heads, int smem,
                                    float scale, cudaStream_t stream) {
  const int mtq = (Q + 15) / 16, cs = DS_CS;
  if (nl < 1 || nl > 3 || C % (8 * cs) ||
      F % (16 * cs) || F / cs > C || Q > 48 || C % heads ||
      heads * mtq > DS_WARPS * DS_SLOTS || mtq * C / cs / 8 > DS_WARPS ||
      2 * cs * heads > C + 4 ||
      (heads + cs - 1) / cs * Q * Q * 4 > 2 * DS_TK * (C + 8) * 2)
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
  const int words_loc = ((tmax + cs - 1) / cs + 31) / 32;
  const int hd = C / heads;
  if (hd == 32 && C == 256)
    return launch_stack<32, 256>(x0, emb0, qpos, p, nl, G, wd, wf, out, dbg,
                                 B, Q, C, F, heads, words, words_loc, smem,
                                 scale, stream);
  if (hd == 32)
    return launch_stack<32, 0>(x0, emb0, qpos, p, nl, G, wd, wf, out, dbg, B,
                               Q, C, F, heads, words, words_loc, smem, scale,
                               stream);
  if (hd == 64)
    return launch_stack<64, 0>(x0, emb0, qpos, p, nl, G, wd, wf, out, dbg, B,
                               Q, C, F, heads, words, words_loc, smem, scale,
                               stream);
  return MB_BAD_ARGS;
}

// The split-query instance (any Q up to 512, bf16 or f32) is its own
// source: csrc/decoder_split.cu.
