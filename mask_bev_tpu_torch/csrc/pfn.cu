// Kernels 1 and 10: pillar feature net -> dense pillar table + norm
// statistics, on tiles of whole pillars.
//
// Kernel 1 (pfn_forward) replaces mask_bev_tpu/ops/pallas_pfn.py::
// fused_stream_pfn_slots (_pfn_slots_kernel). The stable sort and the
// pillar directory (run starts, kept counts, ascending cells) come from
// plain torch (ops/stream_pillars.py); this kernel decorates each pillar's
// kept points, runs the PFN layers (linear, folded BN, relu, max over the
// pillar, concat) and writes the pillar's last-layer feature as one row of
// the dense table, plus per-row [sum, sum of squares] partials of the
// written (rounded) values. A second launch (pfn_stats) reduces the
// partials per sample in a fixed order, so the statistics repeat bit for
// bit (no float atomics).
//
// Kernel 10 (stream_pfn_forward) replaces mask_bev_tpu/ops/pallas_pfn.py::
// fused_stream_pfn (_pfn_kernel), the v1 PFN on the capped stream of the
// eval path when the slot path is off: the TPU kernel writes pooled
// features for every stream row and the caller reads them at the pillar
// starts (gather_at_starts); this one writes the (B, P, C) pillar table
// those reads give with the same body (a slot's kept points are the rows
// [start, start + count), count from ops/stream_pillars.py::kept_counts),
// and zero rows on the slots at and beyond the occupied ones.
//
// What bounds it on the H100: operations. At the flagship (3 layers,
// 10->64, 128->64, 128->128) each kept point costs ~25k multiply-adds; the
// bf16 instance's products are bf16 (bf16 weights, layer inputs rounded to
// bf16) with f32 accumulation, so their floor is the bf16 tensor-core rate
// (989 TFLOP/s): ~0.05 ms for the ~940k kept points of 8 scans. Its bytes
// (4 input columns and 3 directory ints per point slot, 256 B per pillar
// row) are ~120 MB, ~0.035 ms at 3.35 TB/s.
//
// Design. The first version ran one warp per pillar with the products as
// f32 FMAs on CUDA cores: at ~2.5 kept points a pillar each weight read
// served at most two points, and half the lanes idled in 64-unit layers.
// This one works on tiles of whole pillars in compacted kept-point order
// (ops/stream_pillars.py::pfn_tiles): tile t of a sample owns the pillars
// whose first compacted row lies in [64 t, 64 t + 64), so it holds at most
// 64 + 31 = 95 rows (6 m16 tiles), gathered into shared memory (one thread
// a row, so every point load of the tile is in flight at once) and
// decorated there. A persistent grid walks the tiles; a block loads the
// weights once.
//   * bf16 instance: every layer's product is mma.sync m16n8k16 (bf16
//     operands, f32 accumulation). The weights stay in shared memory in
//     B-fragment order (packed on the host, ops/pfn.py::pack_weights: one
//     8-byte load a lane and k-step); warp w owns the output-column tiles
//     w, w + 8 across all of the tile's rows, and loads A fragments with
//     ldmatrix from the bf16 activations (row stride K + 8: conflict-free).
//   * f32 instance: the same tiles with f32 activations and f32 products
//     (FMA, no rounding of the operands); a thread owns one output column
//     and a set of rows, the f32 weights read through L1.
// The layer epilogue applies g and b and the ReLU, rounds to the storage
// type (as the reference rounds the next layer's input) and writes the rows
// in place; the max over each pillar's contiguous rows then runs one warp a
// pillar (the max of the rounded values is the rounded max), written back
// as the [z, pooled] half of the next layer's input, or as the table row.
// The pooled half is not split off as a separate per-pillar product: each
// row's product is the reference's W [z; pooled] with its rounding.
#include "common.cuh"

#define PFN_MAXL 4
#define PFN_ROWS 96   // rows of a tile: at most 64 + 31, in 6 m16 tiles
#define PFN_MT 6
#define PFN_PIL 64    // pillars of a tile at most (distinct first rows)
#define PFN_THREADS 256
#define PFN_WARPS (PFN_THREADS / 32)
// rows a thread of the f32 instance holds: 96 rows over 256 / u row groups
// of u <= 128 threads
#define PFN_F32_ROWS 48

struct PfnDims {
  int nl;
  int in[PFN_MAXL];
  int kp[PFN_MAXL];     // input width padded to a multiple of 16
  int units[PFN_MAXL];
  int woff[PFN_MAXL];   // element offset of W (kp x units) in the weights
  int gboff[PFN_MAXL];  // offset of g (then b) in the f32 g/b buffer
  int wsz;              // elements of all weights
  int gbsz;             // floats of g/b (multiple of 4)
  int lda;              // activation row stride, elements
};

// where the points come from: kernel 1's four sorted f32 columns, or
// kernel 10's (B, N, D) sorted points in the storage type
struct PfnPoints {
  const float* col[4];
  const void* pts;
  int D;
};

template <typename T>
__device__ __forceinline__ float load_pt(const PfnPoints& pp, size_t row,
                                         int q) {
  if (pp.pts) {
    if (q >= pp.D) return 0.f;
    return to_f(reinterpret_cast<const T*>(pp.pts)[row * pp.D + q]);
  }
  return pp.col[q][row];
}

// bf16 instance: acc[jj][mt] += Xs[16 mt.., :kp] . W[:, 8 (warp + 8 jj)..]
__device__ __forceinline__ void pfn_mma(float (&acc)[2][PFN_MT][4],
                                        const bf16* Xs, int lda, int nmt,
                                        const uint2* wfr, int kp, int u,
                                        int warp, int lane) {
  const int nnt = u / 8, nks = kp / 16;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int mt = 0; mt < PFN_MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][mt][e] = 0.f;
  for (int ks = 0; ks < nks; ++ks) {
    uint2 bfr[2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = warp + PFN_WARPS * jj;
      bfr[jj] = j < nnt ? wfr[((size_t)j * nks + ks) * 32 + lane]
                        : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int mt = 0; mt < PFN_MT; ++mt) {
      if (mt >= nmt) break;
      uint32_t a[4];
      ldsm_x4(a, Xs + (16 * mt + (lane & 15)) * lda + 16 * ks +
                     (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        if (warp + PFN_WARPS * jj < nnt)
          mma_16816(acc[jj][mt], a, bfr[jj].x, bfr[jj].y);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(PFN_THREADS) pfn_tile_kernel(
    PfnPoints pp, const int* __restrict__ starts,
    const int* __restrict__ counts, const int* __restrict__ cells,
    const int* __restrict__ num, const int* __restrict__ row0,
    const int* __restrict__ tile_first, const void* __restrict__ wbuf,
    const float* __restrict__ gb, PfnDims d, T* __restrict__ table,
    float* __restrict__ partials, int B, int N, int P, int ntiles,
    int point_dim, int with_distance, int grid_w, float vs, float cx0,
    float cy0, int zero_tail) {
  constexpr bool TC = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  float* gbs = smem;
  const uint2* wfr = reinterpret_cast<const uint2*>(smem + d.gbsz);
  T* Xs = reinterpret_cast<T*>(smem + d.gbsz +
                               (TC ? d.wsz / 2 : 0));  // PFN_ROWS x lda
  int* pil_row = reinterpret_cast<int*>(Xs + PFN_ROWS * d.lda);
  int* pil_cnt = pil_row + PFN_PIL;
  int* pil_start = pil_cnt + PFN_PIL;
  int* pil_cell = pil_start + PFN_PIL;
  int* rowpil = pil_cell + PFN_PIL;                       // PFN_ROWS
  float* raw = reinterpret_cast<float*>(rowpil + PFN_ROWS);  // PFN_ROWS x 4
  float* mean = raw + 4 * PFN_ROWS;                       // PFN_PIL x 4

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < d.gbsz; i += PFN_THREADS) gbs[i] = gb[i];
  if (TC) {
    const uint4* src = reinterpret_cast<const uint4*>(wbuf);
    uint4* dst = reinterpret_cast<uint4*>(smem + d.gbsz);
    for (int i = tid; i < d.wsz / 8; i += PFN_THREADS) dst[i] = src[i];
  }
  const float* wg = reinterpret_cast<const float*>(wbuf);
  const int c_out = d.units[d.nl - 1];

  for (int tile = blockIdx.x; tile < B * ntiles; tile += gridDim.x) {
    const int b = tile / ntiles, t = tile % ntiles;
    const int p0 = tile_first[(size_t)b * (ntiles + 1) + t];
    const int p1 = tile_first[(size_t)b * (ntiles + 1) + t + 1];
    if (p0 >= p1) continue;
    const int npil = p1 - p0;
    const size_t dir = (size_t)b * P;  // directory and table rows of b
    const int base = row0[dir + p0];
    __syncthreads();  // the previous tile is done with the shared memory
    for (int i = tid; i < npil; i += PFN_THREADS) {
      pil_row[i] = row0[dir + p0 + i] - base;
      pil_cnt[i] = counts[dir + p0 + i];
      pil_start[i] = starts[dir + p0 + i];
      pil_cell[i] = cells[dir + p0 + i];
    }
    __syncthreads();
    const int nrows = pil_row[npil - 1] + pil_cnt[npil - 1];
    const int nmt = (nrows + 15) / 16;

    // ---- gather and decorate: every row's point in flight at once -------
    for (int i = tid; i < npil; i += PFN_THREADS)
      for (int rr = 0; rr < pil_cnt[i]; ++rr) rowpil[pil_row[i] + rr] = i;
    __syncthreads();
    for (int r = tid; r < nrows; r += PFN_THREADS) {
      const int i = rowpil[r];
      const size_t prow = (size_t)b * N + pil_start[i] + r - pil_row[i];
#pragma unroll
      for (int q = 0; q < 4; ++q) raw[4 * r + q] = load_pt<T>(pp, prow, q);
    }
    __syncthreads();
    for (int i = tid; i < npil; i += PFN_THREADS) {
      const int r0 = pil_row[i], n = pil_cnt[i];
      float sx = 0.f, sy = 0.f, sz = 0.f;
      for (int rr = 0; rr < n; ++rr) {
        sx += raw[4 * (r0 + rr)];
        sy += raw[4 * (r0 + rr) + 1];
        sz += raw[4 * (r0 + rr) + 2];
      }
      const float cnt = fmaxf((float)n, 1.f);
      mean[4 * i] = sx / cnt;
      mean[4 * i + 1] = sy / cnt;
      mean[4 * i + 2] = sz / cnt;
    }
    __syncthreads();
    const int kp0 = d.kp[0];
    for (int r = tid; r < nrows; r += PFN_THREADS) {
      const int i = rowpil[r], cell = pil_cell[i];
      const float x = raw[4 * r], y = raw[4 * r + 1], z = raw[4 * r + 2];
      const float cx = __fadd_rn(__fmul_rn((float)(cell % grid_w), vs), cx0);
      const float cy = __fadd_rn(__fmul_rn((float)(cell / grid_w), vs), cy0);
      T* a = Xs + r * d.lda;
      int j = 0;
      for (int q = 0; q < point_dim; ++q) a[j++] = from_f<T>(raw[4 * r + q]);
      a[j++] = from_f<T>(x - mean[4 * i]);
      a[j++] = from_f<T>(y - mean[4 * i + 1]);
      a[j++] = from_f<T>(z - mean[4 * i + 2]);
      a[j++] = from_f<T>(x - cx);
      a[j++] = from_f<T>(y - cy);
      if (with_distance)
        a[j++] = from_f<T>(sqrtf(__fadd_rn(
            __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z))));
      for (; j < kp0; ++j) a[j] = from_f<T>(0.f);
    }
    // rows of the last m16 tile past the tile's rows: zero inputs
    for (int i = tid; i < (16 * nmt - nrows) * kp0; i += PFN_THREADS)
      Xs[(nrows + i / kp0) * d.lda + i % kp0] = from_f<T>(0.f);
    __syncthreads();

    for (int li = 0; li < d.nl; ++li) {
      const int kp = d.kp[li], u = d.units[li];
      const float* g = gbs + d.gboff[li];
      const float* bb = g + u;
      const bool last = li == d.nl - 1;
      // ---- products, then z = relu(acc * g + b) rounded, in place --------
      if (TC) {
        float acc[2][PFN_MT][4];
        pfn_mma(acc, reinterpret_cast<const bf16*>(Xs), d.lda, nmt,
                wfr + d.woff[li] / 4, kp, u, warp, lane);
        __syncthreads();  // every warp has read this layer's input
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = warp + PFN_WARPS * jj;
          if (j >= u / 8) continue;
#pragma unroll
          for (int mt = 0; mt < PFN_MT; ++mt) {
            if (mt >= nmt) break;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = 16 * mt + (lane >> 2) + 8 * (e >> 1);
              const int c = 8 * j + 2 * (lane & 3) + (e & 1);
              if (row < nrows)
                Xs[row * d.lda + c] = from_f<T>(fmaxf(
                    __fadd_rn(__fmul_rn(acc[jj][mt][e], g[c]), bb[c]), 0.f));
            }
          }
        }
      } else {
        // thread: column c, rows rg, rg + ng, ... (ng row groups)
        const int ng = PFN_THREADS / u;
        const int c = tid % u, rg = tid / u;
        const bool on = rg < ng;
        const float* W = wg + d.woff[li];
        const float* X = reinterpret_cast<const float*>(Xs);
        float acc[PFN_F32_ROWS];
#pragma unroll
        for (int i = 0; i < PFN_F32_ROWS; ++i) acc[i] = 0.f;
        if (on) {
          for (int k = 0; k < kp; k += 4) {
            const float w0 = __ldg(W + (size_t)k * u + c);
            const float w1 = __ldg(W + (size_t)(k + 1) * u + c);
            const float w2 = __ldg(W + (size_t)(k + 2) * u + c);
            const float w3 = __ldg(W + (size_t)(k + 3) * u + c);
#pragma unroll
            for (int i = 0; i < PFN_F32_ROWS; ++i) {
              const int row = rg + ng * i;
              if (row >= nrows) break;
              const float4 a =
                  *reinterpret_cast<const float4*>(X + row * d.lda + k);
              acc[i] = fmaf(a.w, w3, fmaf(a.z, w2, fmaf(a.y, w1,
                                                        fmaf(a.x, w0, acc[i]))));
            }
          }
        }
        __syncthreads();
        if (on) {
#pragma unroll
          for (int i = 0; i < PFN_F32_ROWS; ++i) {
            const int row = rg + ng * i;
            if (row >= nrows) break;
            Xs[row * d.lda + c] = from_f<T>(
                fmaxf(__fadd_rn(__fmul_rn(acc[i], g[c]), bb[c]), 0.f));
          }
        }
      }
      __syncthreads();
      // ---- max over each pillar's rows, one warp a pillar ----------------
      for (int i = warp; i < npil; i += PFN_WARPS) {
        const int r0 = pil_row[i], n = pil_cnt[i];
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < u; c += 32) {
          float m = 0.f;  // post-ReLU values are >= 0
          for (int rr = 0; rr < n; ++rr)
            m = fmaxf(m, to_f(Xs[(r0 + rr) * d.lda + c]));
          if (!last) {
            const T mv = from_f<T>(m);
            for (int rr = 0; rr < n; ++rr) Xs[(r0 + rr) * d.lda + u + c] = mv;
          } else {
            table[(dir + p0 + i) * (size_t)c_out + c] = from_f<T>(m);
            s1 += m;
            s2 += m * m;
          }
        }
        if (last) {
          s1 = warp_sum(s1);
          s2 = warp_sum(s2);
          if (lane == 0) {
            partials[(dir + p0 + i) * 2] = s1;
            partials[(dir + p0 + i) * 2 + 1] = s2;
          }
        }
      }
      __syncthreads();
    }
  }

  // kernel 10: the slots at and beyond the occupied ones are zero rows
  if (zero_tail) {
    for (size_t row = (size_t)blockIdx.x * PFN_WARPS + warp;
         row < (size_t)B * P; row += (size_t)gridDim.x * PFN_WARPS) {
      const int b = (int)(row / P), r = (int)(row % P);
      if (r < num[b]) continue;
      for (int c = lane; c < c_out; c += 32)
        table[row * c_out + c] = from_f<T>(0.f);
      if (lane == 0) partials[row * 2] = partials[row * 2 + 1] = 0.f;
    }
  }
}

__global__ void __launch_bounds__(1024) pfn_stats_kernel(
    const float* __restrict__ partials, const int* __restrict__ num,
    float* __restrict__ stats, int N) {
  __shared__ float r1[1024], r2[1024];
  const int b = blockIdx.x;
  const int P = num[b];
  float s1 = 0.f, s2 = 0.f;
  for (int r = threadIdx.x; r < P; r += blockDim.x) {
    s1 += partials[((size_t)b * N + r) * 2];
    s2 += partials[((size_t)b * N + r) * 2 + 1];
  }
  r1[threadIdx.x] = s1;
  r2[threadIdx.x] = s2;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      r1[threadIdx.x] += r1[threadIdx.x + s];
      r2[threadIdx.x] += r2[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    stats[b * 2] = r1[0];
    stats[b * 2 + 1] = r2[0];
  }
}

// dims: [n_layers, in_0, units_0, in_1, units_1, ...] (host memory);
// every width a multiple of 8 up to 128, the next layer's input 2 units
static int parse_dims(const int* dims, PfnDims* d) {
  d->nl = dims[0];
  if (d->nl < 1 || d->nl > PFN_MAXL) return MB_BAD_ARGS;
  int woff = 0, gboff = 0, kmax = 0;
  for (int l = 0; l < d->nl; ++l) {
    const int in = dims[1 + 2 * l], u = dims[2 + 2 * l];
    if (u < 8 || u > 128 || u % 8 || in < 1) return MB_BAD_ARGS;
    if (l > 0 && in != 2 * d->units[l - 1]) return MB_BAD_ARGS;
    d->in[l] = in;
    d->kp[l] = (in + 15) / 16 * 16;
    d->units[l] = u;
    d->woff[l] = woff;
    woff += d->kp[l] * u;
    d->gboff[l] = gboff;
    gboff += 2 * u;
    kmax = d->kp[l] > kmax ? d->kp[l] : kmax;
  }
  d->wsz = woff;
  d->gbsz = (gboff + 3) & ~3;
  d->lda = kmax;
  return 0;
}

// shared memory of a block of the instance T (bf16: + 8 elements a row so
// that ldmatrix is free of bank conflicts; f32: + 4, 16-byte rows)
template <typename T>
static size_t pfn_smem(PfnDims* d) {
  const bool tc = sizeof(T) == 2;
  d->lda += tc ? 8 : 4;
  return sizeof(float) * d->gbsz + (tc ? sizeof(bf16) * d->wsz : 0) +
         sizeof(T) * PFN_ROWS * d->lda +
         sizeof(int) * (4 * PFN_PIL + PFN_ROWS) +
         sizeof(float) * 4 * (PFN_ROWS + PFN_PIL);
}

template <typename T>
static int launch_tiles(const PfnPoints& pp, const int* starts,
                        const int* counts, const int* cells, const int* num,
                        const int* row0, const int* tile_first,
                        const void* wbuf, const float* gb, const int* dims,
                        T* table, float* partials, int B, int N, int P,
                        int ntiles, int point_dim, int with_distance,
                        int grid_w, float vs, float cx0, float cy0,
                        int zero_tail, cudaStream_t stream) {
  PfnDims d;
  if (parse_dims(dims, &d)) return MB_BAD_ARGS;
  const size_t smem = pfn_smem<T>(&d);
  if (smem > 232448) return MB_BAD_ARGS;
  auto kern = pfn_tile_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, PFN_THREADS,
                                                smem);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int grid = (per_sm > 0 ? per_sm : 1) * sms;
  if (!zero_tail && grid > B * ntiles) grid = B * ntiles;
  if (grid < 1) grid = 1;
  kern<<<grid, PFN_THREADS, smem, stream>>>(
      pp, starts, counts, cells, num, row0, tile_first, wbuf, gb, d, table,
      partials, B, N, P, ntiles, point_dim, with_distance, grid_w, vs, cx0,
      cy0, zero_tail);
  return (int)cudaGetLastError();
}

// Kernel 1. cols: four sorted (B, N) f32 columns; starts, counts, cells,
// row0: (B, N) int32 pillar directory; num: (B,) occupied rows; tile_first:
// (B, ntiles + 1) int32 (ops/stream_pillars.py::pfn_tiles); wbuf: the
// weights (bf16 in fragment order, or f32 (kp, units) row-major, each layer
// zero-padded to kp rows); gb: f32 g, b per layer; table (B, N, units of
// the last layer) and partials (B, N, 2): rows at and beyond num[b] are not
// written. f32: nonzero for the f32 instance (f32 weights and table).
MB_EXPORT int pfn_forward(const float* x, const float* y, const float* z,
                          const float* it, const int* starts,
                          const int* counts, const int* cells,
                          const int* num, const int* row0,
                          const int* tile_first, const void* wbuf,
                          const float* gb, const int* dims, void* table,
                          float* partials, int B, int N, int ntiles,
                          int point_dim, int with_distance, int grid_w,
                          float vs, float cx0, float cy0, int f32,
                          cudaStream_t stream) {
  if (point_dim < 1 || point_dim > 4) return MB_BAD_ARGS;
  PfnPoints pp = {{x, y, z, it}, nullptr, 0};
  if (f32)
    return launch_tiles<float>(pp, starts, counts, cells, num, row0,
                               tile_first, wbuf, gb, dims, (float*)table,
                               partials, B, N, N, ntiles, point_dim,
                               with_distance, grid_w, vs, cx0, cy0, 0, stream);
  return launch_tiles<bf16>(pp, starts, counts, cells, num, row0, tile_first,
                            wbuf, gb, dims, (bf16*)table, partials, B, N, N,
                            ntiles, point_dim, with_distance, grid_w, vs, cx0,
                            cy0, 0, stream);
}

// Kernel 10. pts (B, N, D) sorted points in the instance's type, D 3 or 4;
// starts, counts, cells, row0: (B, P) int32 slot directory; nvalid (B,);
// table (B, P, units of the last layer), partials (B, P, 2): every row
// written, zero at and beyond nvalid[b].
MB_EXPORT int stream_pfn_forward(const void* pts, int D, const int* starts,
                                 const int* counts, const int* cells,
                                 const int* nvalid, const int* row0,
                                 const int* tile_first, const void* wbuf,
                                 const float* gb, const int* dims,
                                 void* table, float* partials, int B, int N,
                                 int P, int ntiles, int with_distance,
                                 int grid_w, float vs, float cx0, float cy0,
                                 int f32, cudaStream_t stream) {
  if (D < 3 || D > 4) return MB_BAD_ARGS;
  PfnPoints pp = {{nullptr, nullptr, nullptr, nullptr}, pts, D};
  if (f32)
    return launch_tiles<float>(pp, starts, counts, cells, nvalid, row0,
                               tile_first, wbuf, gb, dims, (float*)table,
                               partials, B, N, P, ntiles, D, with_distance,
                               grid_w, vs, cx0, cy0, 1, stream);
  return launch_tiles<bf16>(pp, starts, counts, cells, nvalid, row0,
                            tile_first, wbuf, gb, dims, (bf16*)table,
                            partials, B, N, P, ntiles, D, with_distance,
                            grid_w, vs, cx0, cy0, 1, stream);
}

MB_EXPORT int pfn_stats(const float* partials, const int* num, float* stats,
                        int B, int N, cudaStream_t stream) {
  pfn_stats_kernel<<<B, 1024, 0, stream>>>(partials, num, stats, N);
  return (int)cudaGetLastError();
}
