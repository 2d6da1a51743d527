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
// (989 TFLOP/s): ~0.05 ms for the ~940k kept points of 8 scans. The f32
// instance's are 3xTF32, three TF32 products a multiply-add, at a
// third of the TF32 rate (495 TFLOP/s): ~0.29 ms. Its bytes (4 input
// columns and 3 directory ints per point slot, 256 B per pillar row in
// bf16) are ~120 MB, ~0.035 ms at 3.35 TB/s.
//
// Design. The first version ran one warp per pillar with the products as
// f32 FMAs on CUDA cores: at ~2.5 kept points a pillar each weight read
// served at most two points, and half the lanes idled in 64-unit layers.
// This one works on tiles of whole pillars in compacted kept-point order
// (ops/stream_pillars.py::pfn_tiles): tile t of a sample owns the pillars
// whose first compacted row lies in [64 t, 64 t + 64), so it holds at most
// 64 + K - 1 rows for K points a pillar: 95 rows (6 m16 tiles) at K <= 32,
// the instance MT = 6, and 191 (12 m16 tiles) at K <= 128, the instance MT =
// 12 (mmdet3d's 64 points a pillar, the PointPillars paper's 100). The rows
// are gathered into shared memory (one thread a row, so every point load of
// the tile is in flight at once) and decorated there; the products run over
// them 6 m16 tiles at a time (MT = 12: twice, each chunk's epilogue after
// its own products, so the register tiles are MT = 6's). A persistent grid walks the tiles; a block loads the
// weights once into shared memory, in B-fragment order (packed on the host,
// ops/pfn.py::pack_weights: one 8-byte load a lane and k-step).
//   * bf16 instance: every layer's product is mma.sync m16n8k16 (bf16
//     operands, f32 accumulation); warp w owns the output-column tiles w,
//     w + 8 across all of the tile's rows, A fragments by ldmatrix from the
//     bf16 activations (row stride K + 8: conflict-free). 256 threads a
//     block, two blocks an SM.
//   * f32 instance: every layer's product is 3xTF32 on mma.sync m16n8k8
//     (lo.hi + hi.lo + hi.hi into f32 accumulators, within a few f32
//     roundings of an f32 product): warp w owns four column tiles over
//     every other m16 tile (pfn_mma_tf32), the f32 weights split into TF32
//     halves a k-step in registers, each A fragment loaded by ldmatrix
//     from the f32 activations (row stride K + 4: rows 16 bytes apart mod
//     128, conflict-free) and split once for the warp's column tiles. The
//     f32 weights (100 KB at the flagship) leave room for one block an SM,
//     so a block of 512 threads runs two tile groups of 256 side by side,
//     each with its own rows and named barrier, over the one copy of the
//     weights: the walk, bound by latency, keeps 16 warps an SM, as the
//     bf16 instance's two blocks do.
// The layer epilogue applies g and b and the ReLU, rounds to the storage
// type (as the reference rounds the next layer's input) and writes the rows
// in place; the max over each pillar's contiguous rows then runs one warp a
// pillar (the max of the rounded values is the rounded max), written back
// as the [z, pooled] half of the next layer's input, or as the table row.
// The pooled half is not split off as a separate per-pillar product: each
// row's product is the reference's W [z; pooled] with its rounding.
//
// Widths. Layers of 1 to 256 units, up to PFN_MAXL layers: the
// wrapper pads each layer's units to a multiple of 8 (ops/pfn.py::
// kernel_dims: zero weight columns and a zero affine, so the padded z and
// pooled columns are exact zeros, and zero rows for them in the next
// layer's weight) and the table is written at its true width c_out. Layers
// of more than 128 units run the WIDE instances: the output-column tiles
// of a warp double (bf16: four over chunks of 3 m16 tiles, in place of
// two over 6; f32: eight over 4 m16 tiles, in place of four over 6, and
// one tile group a block), so the accumulators a thread holds stay as
// they are. The shared memory a block needs (ops/pfn.py::smem_bytes) is
// the rule for what no instance takes.
//
// The layered route (pfn_layered_forward) takes what the tiles cannot
// hold: pillars of more than 128 kept points (a tile spans 64 + K - 1 rows
// in shared memory) and layer stacks whose weights do not fit a block (two
// layers of 256 units: 512 x 256 bf16 weights alone are 256 KB). It runs
// the PFN one layer at a time over all of its pillars' kept rows, with the
// activations in device memory (rows in the compacted order of its own
// directory, ops/pfn.py::layered_directory): decorate the rows (one warp a
// pillar: the means by a warp sum, then the rows); then, a layer at a
// time, the product of each row's [z, pooled] with W by the tile kernel's
// own mma.sync code (pfn_layered_mma_kernel: 96 rows a block in bf16, 64
// in f32, the rows staged in shared memory, W read from L2 in the same
// B-fragment order), its epilogue into the rows in place, and the max over
// each pillar's contiguous rows (one warp a pillar; order-free, so
// deterministic), written back as the pooled half or, at the last layer,
// as the table row and its [sum, sum of squares] partials, which
// pfn_stats reduces as it does the tiles'. Each row's product is the
// reference's single W [z; pooled] with its rounding, as in the tiles.
#include "common.cuh"

#define PFN_MAXL 8
#define PFN_MAXU 256  // units a layer
#define PFN_MT 6      // m16 tiles of one product call (96 rows)
#define PFN_PIL 64    // pillars of a tile at most (distinct first rows)
#define PFN_THREADS 256  // threads of a tile group
#define PFN_WARPS (PFN_THREADS / 32)
#define PFN_SMEM_MAX 232448

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
  int groups;           // tile groups a block (f32: 2 where they fit)
  int group_bytes;      // shared memory of a tile group
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
// over NJ column tiles a warp and MC m16 tiles (2 and 6; WIDE: 4 and 3)
template <int NJ, int MC>
__device__ __forceinline__ void pfn_mma(float (&acc)[NJ][MC][4],
                                        const bf16* Xs, int lda, int nmt,
                                        const uint2* wfr, int kp, int u,
                                        int warp, int lane) {
  const int nnt = u / 8, nks = kp / 16;
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int mt = 0; mt < MC; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][mt][e] = 0.f;
  for (int ks = 0; ks < nks; ++ks) {
    uint2 bfr[NJ];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = warp + PFN_WARPS * jj;
      bfr[jj] = j < nnt ? wfr[((size_t)j * nks + ks) * 32 + lane]
                        : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int mt = 0; mt < MC; ++mt) {
      if (mt >= nmt) break;
      uint32_t a[4];
      ldsm_x4(a, Xs + (16 * mt + (lane & 15)) * lda + 16 * ks +
                     (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
        if (warp + PFN_WARPS * jj < nnt)
          mma_16816(acc[jj][mt], a, bfr[jj].x, bfr[jj].y);
    }
  }
}

// f32 instance: warp w owns the output-column tiles j = (w & 3) + 4 jj and
// the m16 tiles mt = (w >> 2) + 2 i of the tile's rows (each A fragment is
// split by four warps, not eight, and each B fragment by two):
// acc[jj][i] += Xs[16 mt.., :kp] . W[:, 8 j..] in 3xTF32 (lo.hi, hi.lo,
// then hi.hi into each accumulator). The weights' words (k = t, t + 4 of
// column g) are split a k-step; an A fragment comes from the f32 rows by
// one ldmatrix (an 8 x 4 f32 block is an 8 x 8 b16 matrix, lane (g, t)
// receiving element (g, t)) and is split once for the warp's column
// tiles, whose three products run pass by pass, so that no product waits
// on the one before it. NJ column tiles a warp over NI of its m16 tiles
// (4 and 3; WIDE: 8 and 2)
template <int NJ, int NI>
__device__ __forceinline__ void pfn_mma_tf32(float (&acc)[NJ][NI][4],
                                             const float* Xs, int lda,
                                             int nmt, const uint2* wfr,
                                             int kp, int u, int warp,
                                             int lane) {
  const int nnt = u / 8, nks = kp / 8, cg = warp & 3, rh = warp >> 2;
  bool has[NJ];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) has[jj] = cg + 4 * jj < nnt;
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][i][e] = 0.f;
  if (!has[0]) return;
  // lane l gives the address of row l & 7 of matrix l >> 3: rows + 8 for
  // matrices 1 and 3, columns + 4 for matrices 2 and 3 (a0 .. a3)
  const float* xa =
      Xs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * lda + 4 * (lane >> 4);
#pragma unroll 2  // kp is a multiple of 16: two k-steps of 8
  for (int ks = 0; ks < nks; ++ks) {
    Tf32x2<2> bfr[NJ];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const uint2 w = has[jj]
          ? wfr[((size_t)(cg + 4 * jj) * nks + ks) * 32 + lane]
          : make_uint2(0u, 0u);
      const uint32_t v[2] = {w.x, w.y};
      bfr[jj] = split_frag(v);
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int mt = rh + 2 * i;
      if (mt >= nmt) break;
      uint32_t a[4];
      ldsm_x4(a, xa + 16 * mt * lda + 8 * ks);
      const Tf32x2<4> af = split_frag(a);
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          if (!has[jj]) continue;
          const Tf32x2<2>& bf = bfr[jj];
          if (pass == 0)
            mma_1688_tf32(acc[jj][i], af.lo, bf.hi[0], bf.hi[1]);
          else if (pass == 1)
            mma_1688_tf32(acc[jj][i], af.hi, bf.lo[0], bf.lo[1]);
          else
            mma_1688_tf32(acc[jj][i], af.hi, bf.hi[0], bf.hi[1]);
        }
    }
  }
}

// z = relu(acc * g + b), rounded to T, into the rows in place: acc[jj][i]
// is the output-column tile j0 + js jj of the m16 tile m0 + ms i
template <typename T, int NJ, int NI>
__device__ __forceinline__ void pfn_epilogue(const float (&acc)[NJ][NI][4],
                                             T* Xs, int lda, const float* g,
                                             const float* bb, int u, int nmt,
                                             int nrows, int j0, int js,
                                             int m0, int ms, int lane) {
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int j = j0 + js * jj;
    if (j >= u / 8) continue;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int mt = m0 + ms * i;
      if (mt >= nmt) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + (lane >> 2) + 8 * (e >> 1);
        const int c = 8 * j + 2 * (lane & 3) + (e & 1);
        if (row < nrows)
          Xs[row * lda + c] = from_f<T>(fmaxf(
              __fadd_rn(__fmul_rn(acc[jj][i][e], g[c]), bb[c]), 0.f));
      }
    }
  }
}

// one decorated row into a (kp0 columns, rounded to T): the point's
// columns pt[:point_dim], xyz less the pillar's mean, x and y less the
// cell's centre, |xyz| with_distance, then zeros
template <typename T>
__device__ __forceinline__ void pfn_decorate(T* a, const float* pt,
                                             const float* mean, int cell,
                                             int point_dim, int with_distance,
                                             int grid_w, float vs, float cx0,
                                             float cy0, int kp0) {
  const float x = pt[0], y = pt[1], z = pt[2];
  const float cx = __fadd_rn(__fmul_rn((float)(cell % grid_w), vs), cx0);
  const float cy = __fadd_rn(__fmul_rn((float)(cell / grid_w), vs), cy0);
  int j = 0;
  for (int q = 0; q < point_dim; ++q) a[j++] = from_f<T>(pt[q]);
  a[j++] = from_f<T>(x - mean[0]);
  a[j++] = from_f<T>(y - mean[1]);
  a[j++] = from_f<T>(z - mean[2]);
  a[j++] = from_f<T>(x - cx);
  a[j++] = from_f<T>(y - cy);
  if (with_distance)
    a[j++] = from_f<T>(sqrtf(__fadd_rn(
        __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z))));
  for (; j < kp0; ++j) a[j] = from_f<T>(0.f);
}

// parts of the walk timed by ``prof`` (ns of %globaltimer read by each tile
// group's first thread after the part's closing barrier, summed over the
// tiles and groups): set-up (weights into shared memory), directory (the
// tile's pillars, empty tiles included), gather (row map, point loads),
// decorate (means, the decorated rows), products, epilogue and max (each
// over the layers), zero tail (kernel 10's unused slots); then the number
// of tile groups that ran
#define PFN_PARTS 8

__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// the barrier of a tile group: the block's, or named barrier 1 + grp of
// the group's PFN_THREADS threads
__device__ __forceinline__ void group_sync(int groups, int grp) {
  if (groups == 1)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "n"(PFN_THREADS)
                 : "memory");
}

// MT: m16 tiles of a tile's rows, 6 (K <= 32) or 12 (K <= 128); WIDE:
// layers of up to PFN_MAXU units (one tile group a block)
template <typename T, int MT, bool WIDE>
__global__ void __launch_bounds__(sizeof(T) == 2 || WIDE ? PFN_THREADS
                                                         : 2 * PFN_THREADS)
pfn_tile_kernel(
    PfnPoints pp, const int* __restrict__ starts,
    const int* __restrict__ counts, const int* __restrict__ cells,
    const int* __restrict__ num, const int* __restrict__ row0,
    const int* __restrict__ tile_first, const void* __restrict__ wbuf,
    const float* __restrict__ gb, PfnDims d, T* __restrict__ table,
    float* __restrict__ partials, unsigned long long* __restrict__ prof,
    int B, int N, int P, int ntiles, int point_dim, int with_distance,
    int grid_w, float vs, float cx0, float cy0, int zero_tail, int c_out) {
  constexpr bool TC = sizeof(T) == 2;
  // m16 tiles a chunk of the products: bf16 6 (WIDE 3), f32 6 (WIDE 4)
  constexpr int CH = WIDE ? (TC ? PFN_MT / 2 : 4) : PFN_MT;
  constexpr int ROWS = 16 * MT;  // rows of a tile: at most 64 + K - 1
  extern __shared__ __align__(16) float smem[];
  float* gbs = smem;
  const uint2* wfr = reinterpret_cast<const uint2*>(smem + d.gbsz);
  // the tile group's part: rows, directory, raw points, means
  const int grp = threadIdx.x / PFN_THREADS;
  T* Xs = reinterpret_cast<T*>(reinterpret_cast<char*>(smem + d.gbsz) +
                               sizeof(T) * d.wsz +
                               (size_t)grp * d.group_bytes);  // ROWS x lda
  int* pil_row = reinterpret_cast<int*>(Xs + ROWS * d.lda);
  int* pil_cnt = pil_row + PFN_PIL;
  int* pil_start = pil_cnt + PFN_PIL;
  int* pil_cell = pil_start + PFN_PIL;
  int* rowpil = pil_cell + PFN_PIL;                       // ROWS
  float* raw = reinterpret_cast<float*>(rowpil + ROWS);   // ROWS x 4
  float* mean = raw + 4 * ROWS;                           // PFN_PIL x 4

  const int tid = threadIdx.x % PFN_THREADS, warp = tid >> 5, lane = tid & 31;
  unsigned long long t_prev = prof && tid == 0 ? gtimer() : 0;
#define PFN_MARK(i)                                  \
  if (prof && tid == 0) {                            \
    const unsigned long long t_ = gtimer();          \
    atomicAdd(prof + (i), t_ - t_prev);              \
    t_prev = t_;                                     \
  }
  for (int i = threadIdx.x; i < d.gbsz; i += blockDim.x) gbs[i] = gb[i];
  {
    const uint4* src = reinterpret_cast<const uint4*>(wbuf);
    uint4* dst = reinterpret_cast<uint4*>(smem + d.gbsz);
    for (int i = threadIdx.x; i < (int)(d.wsz * sizeof(T) / 16);
         i += blockDim.x)
      dst[i] = src[i];
  }
  if (d.groups > 1) __syncthreads();  // both groups read every weight
  PFN_MARK(0)

  for (int tile = blockIdx.x * d.groups + grp; tile < B * ntiles;
       tile += gridDim.x * d.groups) {
    const int b = tile / ntiles, t = tile % ntiles;
    const int p0 = tile_first[(size_t)b * (ntiles + 1) + t];
    const int p1 = tile_first[(size_t)b * (ntiles + 1) + t + 1];
    if (p0 >= p1) continue;
    const int npil = p1 - p0;
    const size_t dir = (size_t)b * P;  // directory and table rows of b
    const int base = row0[dir + p0];
    group_sync(d.groups, grp);  // the previous tile is done with the rows
    for (int i = tid; i < npil; i += PFN_THREADS) {
      pil_row[i] = row0[dir + p0 + i] - base;
      pil_cnt[i] = counts[dir + p0 + i];
      pil_start[i] = starts[dir + p0 + i];
      pil_cell[i] = cells[dir + p0 + i];
    }
    group_sync(d.groups, grp);
    PFN_MARK(1)
    const int nrows = pil_row[npil - 1] + pil_cnt[npil - 1];
    const int nmt = (nrows + 15) / 16;

    // ---- gather and decorate: every row's point in flight at once -------
    for (int i = tid; i < npil; i += PFN_THREADS)
      for (int rr = 0; rr < pil_cnt[i]; ++rr) rowpil[pil_row[i] + rr] = i;
    group_sync(d.groups, grp);
    for (int r = tid; r < nrows; r += PFN_THREADS) {
      const int i = rowpil[r];
      const size_t prow = (size_t)b * N + pil_start[i] + r - pil_row[i];
#pragma unroll
      for (int q = 0; q < 4; ++q) raw[4 * r + q] = load_pt<T>(pp, prow, q);
    }
    group_sync(d.groups, grp);
    PFN_MARK(2)
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
    group_sync(d.groups, grp);
    const int kp0 = d.kp[0];
    for (int r = tid; r < nrows; r += PFN_THREADS) {
      const int i = rowpil[r];
      pfn_decorate(Xs + r * d.lda, raw + 4 * r, mean + 4 * i, pil_cell[i],
                   point_dim, with_distance, grid_w, vs, cx0, cy0, kp0);
    }
    // rows of the last m16 tile past the tile's rows: zero inputs
    for (int i = tid; i < (16 * nmt - nrows) * kp0; i += PFN_THREADS)
      Xs[(nrows + i / kp0) * d.lda + i % kp0] = from_f<T>(0.f);
    group_sync(d.groups, grp);
    PFN_MARK(3)

    for (int li = 0; li < d.nl; ++li) {
      const int kp = d.kp[li], u = d.units[li];
      const float* g = gbs + d.gboff[li];
      const float* bb = g + u;
      const bool last = li == d.nl - 1;
      // ---- products, then z = relu(acc * g + b) rounded, in place, over
      // chunks of CH m16 tiles (one at MT = 6 but WIDE): a chunk's
      // epilogue writes only its own rows, which no later chunk's products
      // read
#pragma unroll
      for (int m0 = 0; m0 < MT; m0 += CH) {
        if (m0 > 0 && m0 >= nmt) break;
        T* Xc = Xs + (size_t)16 * m0 * d.lda;
        if constexpr (TC) {
          float acc[WIDE ? 4 : 2][CH][4];
          pfn_mma(acc, reinterpret_cast<const bf16*>(Xc), d.lda, nmt - m0,
                  wfr + d.woff[li] / 4, kp, u, warp, lane);
          group_sync(d.groups, grp);  // every warp has read the chunk's input
          PFN_MARK(4)
          pfn_epilogue(acc, Xc, d.lda, g, bb, u, nmt - m0, nrows - 16 * m0,
                       warp, PFN_WARPS, 0, 1, lane);
        } else {
          float acc[WIDE ? 8 : 4][CH / 2][4];
          pfn_mma_tf32(acc, reinterpret_cast<const float*>(Xc), d.lda,
                       nmt - m0, wfr + d.woff[li] / 2, kp, u, warp, lane);
          group_sync(d.groups, grp);  // every warp has read the chunk's input
          PFN_MARK(4)
          pfn_epilogue(acc, Xc, d.lda, g, bb, u, nmt - m0, nrows - 16 * m0,
                       warp & 3, 4, warp >> 2, 2, lane);
        }
      }
      group_sync(d.groups, grp);
      PFN_MARK(5)
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
            // the padded columns (c >= c_out) are zeros: not stored, and
            // adding them leaves the sums as they are
            if (c < c_out) table[(dir + p0 + i) * (size_t)c_out + c] =
                from_f<T>(m);
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
      group_sync(d.groups, grp);
      PFN_MARK(6)
    }
  }

  // kernel 10: the slots at and beyond the occupied ones are zero rows
  if (zero_tail) {
    const int bwarps = blockDim.x / 32;
    for (size_t row = (size_t)blockIdx.x * bwarps + threadIdx.x / 32;
         row < (size_t)B * P; row += (size_t)gridDim.x * bwarps) {
      const int b = (int)(row / P), r = (int)(row % P);
      if (r < num[b]) continue;
      for (int c = lane; c < c_out; c += 32)
        table[row * c_out + c] = from_f<T>(0.f);
      if (lane == 0) partials[row * 2] = partials[row * 2 + 1] = 0.f;
    }
    PFN_MARK(7)
  }
  if (prof && tid == 0) atomicAdd(prof + PFN_PARTS, 1ull);
#undef PFN_MARK
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

// ---- the layered route ------------------------------------------------------

// rows of a block of the layered product: bf16 two chunks of 3 m16 tiles,
// f32 one of 4 (the wide register tiles of pfn_mma, pfn_mma_tf32: 256
// columns a chunk)
template <typename T>
__host__ __device__ constexpr int layered_mt() {
  return sizeof(T) == 2 ? 6 : 4;
}

// blocks an SM of the kernels that run one warp a pillar. The route's
// pillar pil = b P + r holds counts[pil] kept rows (0: not on this route),
// rows b N + lrow0[pil] .. of the workspace X
#define PFN_LAYERED_BLOCKS 8

// decorated rows of every pillar on the route into X (row stride lda):
// one warp a pillar, the means by a warp sum
template <typename T>
__global__ void __launch_bounds__(PFN_THREADS) pfn_layered_decorate_kernel(
    PfnPoints pp, const int* __restrict__ starts,
    const int* __restrict__ counts, const int* __restrict__ cells,
    const int* __restrict__ num, const int* __restrict__ lrow0,
    T* __restrict__ X, int lda, int kp0, int B, int N, int P, int point_dim,
    int with_distance, int grid_w, float vs, float cx0, float cy0) {
  const int lane = threadIdx.x & 31;
  const size_t warps = (size_t)gridDim.x * (blockDim.x / 32);
  for (size_t pil = (size_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
       pil < (size_t)B * P; pil += warps) {
    const int b = (int)(pil / P), r = (int)(pil % P);
    const int n = counts[pil];
    if (r >= num[b] || n == 0) continue;
    const size_t src = (size_t)b * N + starts[pil];
    float sx = 0.f, sy = 0.f, sz = 0.f;
    for (int i = lane; i < n; i += 32) {
      sx += load_pt<T>(pp, src + i, 0);
      sy += load_pt<T>(pp, src + i, 1);
      sz += load_pt<T>(pp, src + i, 2);
    }
    const float cnt = fmaxf((float)n, 1.f);
    const float mean[3] = {warp_sum(sx) / cnt, warp_sum(sy) / cnt,
                           warp_sum(sz) / cnt};
    T* rows = X + ((size_t)b * N + lrow0[pil]) * lda;
    for (int i = lane; i < n; i += 32) {
      float pt[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) pt[q] = load_pt<T>(pp, src + i, q);
      pfn_decorate(rows + (size_t)i * lda, pt, mean, cells[pil], point_dim,
                   with_distance, grid_w, vs, cx0, cy0, kp0);
    }
  }
}

// one layer's product and epilogue over the rows of sample blockIdx.y:
// block x takes rows [ROWS x, ROWS x + ROWS) of the tot[b] rows, stages
// them in shared memory (row stride kp + 8 bf16, + 4 f32) and writes z =
// relu(acc g + b), rounded to T, into the rows in place
template <typename T>
__global__ void __launch_bounds__(PFN_THREADS) pfn_layered_mma_kernel(
    T* __restrict__ X, int lda, const int* __restrict__ tot, int N,
    const uint2* __restrict__ wfr, const float* __restrict__ g,
    const float* __restrict__ bb, int kp, int u) {
  constexpr bool TC = sizeof(T) == 2;
  constexpr int MT = layered_mt<T>(), ROWS = 16 * MT;
  constexpr int CH = TC ? 3 : 4;  // m16 tiles a chunk
  extern __shared__ __align__(16) float smem[];
  T* Xs = reinterpret_cast<T*>(smem);
  const int b = blockIdx.y, r0 = ROWS * blockIdx.x;
  const int nrows = min(ROWS, tot[b] - r0);
  if (nrows <= 0) return;
  const int nmt = (nrows + 15) / 16;
  const int lds = kp + (TC ? 8 : 4);
  T* Xg = X + ((size_t)b * N + r0) * lda;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // 16-byte words of a row; rows past nrows (to the last m16 tile) zero
  const int wr = kp * (int)sizeof(T) / 16;
  for (int i = tid; i < 16 * nmt * wr; i += PFN_THREADS) {
    const int row = i / wr, c = i % wr;
    reinterpret_cast<uint4*>(Xs + row * lds)[c] =
        row < nrows ? reinterpret_cast<const uint4*>(Xg + (size_t)row * lda)[c]
                    : make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
#pragma unroll
  for (int m0 = 0; m0 < MT; m0 += CH) {
    if (m0 >= nmt) break;
    if constexpr (TC) {
      float acc[4][CH][4];
      pfn_mma(acc, reinterpret_cast<const bf16*>(Xs + 16 * m0 * lds), lds,
              nmt - m0, wfr, kp, u, warp, lane);
      pfn_epilogue(acc, Xg + (size_t)16 * m0 * lda, lda, g, bb, u, nmt - m0,
                   nrows - 16 * m0, warp, PFN_WARPS, 0, 1, lane);
    } else {
      float acc[8][CH / 2][4];
      pfn_mma_tf32(acc, reinterpret_cast<const float*>(Xs + 16 * m0 * lds),
                   lds, nmt - m0, wfr, kp, u, warp, lane);
      pfn_epilogue(acc, Xg + (size_t)16 * m0 * lda, lda, g, bb, u, nmt - m0,
                   nrows - 16 * m0, warp & 3, 4, warp >> 2, 2, lane);
    }
  }
}

// the max over each pillar's rows of z (u columns), one warp a pillar:
// written back as every row's pooled half, or at the last layer as the
// table row and its [sum, sum of squares] partials (the tile kernel's own
// order); zero_tail: the last layer also zeroes the rows at and beyond
// num[b] (kernel 10)
template <typename T>
__global__ void __launch_bounds__(PFN_THREADS) pfn_layered_max_kernel(
    T* __restrict__ X, int lda, const int* __restrict__ counts,
    const int* __restrict__ num, const int* __restrict__ lrow0, int B, int N,
    int P, int u, int last, T* __restrict__ table,
    float* __restrict__ partials, int c_out, int zero_tail) {
  const int lane = threadIdx.x & 31;
  const size_t warps = (size_t)gridDim.x * (blockDim.x / 32);
  for (size_t pil = (size_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
       pil < (size_t)B * P; pil += warps) {
    const int b = (int)(pil / P), r = (int)(pil % P);
    if (r >= num[b]) {
      if (last && zero_tail) {
        for (int c = lane; c < c_out; c += 32)
          table[pil * c_out + c] = from_f<T>(0.f);
        if (lane == 0) partials[pil * 2] = partials[pil * 2 + 1] = 0.f;
      }
      continue;
    }
    const int n = counts[pil];
    if (n == 0) continue;
    T* rows = X + ((size_t)b * N + lrow0[pil]) * lda;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < u; c += 32) {
      float m = 0.f;  // post-ReLU values are >= 0
      for (int rr = 0; rr < n; ++rr) m = fmaxf(m, to_f(rows[rr * lda + c]));
      if (!last) {
        const T mv = from_f<T>(m);
        for (int rr = 0; rr < n; ++rr) rows[rr * lda + u + c] = mv;
      } else {
        if (c < c_out) table[pil * c_out + c] = from_f<T>(m);
        s1 += m;
        s2 += m * m;
      }
    }
    if (last) {
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        partials[pil * 2] = s1;
        partials[pil * 2 + 1] = s2;
      }
    }
  }
}

// dims: [n_layers, in_0, units_0, in_1, units_1, ...] (host memory);
// every width a multiple of 8 up to PFN_MAXU, the next layer's input 2
// units. The row stride holds every layer's input and its z (a last layer
// may have more units than inputs).
static int parse_dims(const int* dims, PfnDims* d) {
  d->nl = dims[0];
  if (d->nl < 1 || d->nl > PFN_MAXL) return MB_BAD_ARGS;
  int woff = 0, gboff = 0, kmax = 0;
  for (int l = 0; l < d->nl; ++l) {
    const int in = dims[1 + 2 * l], u = dims[2 + 2 * l];
    if (u < 8 || u > PFN_MAXU || u % 8 || in < 1) return MB_BAD_ARGS;
    if (l > 0 && in != 2 * d->units[l - 1]) return MB_BAD_ARGS;
    d->in[l] = in;
    d->kp[l] = (in + 15) / 16 * 16;
    d->units[l] = u;
    d->woff[l] = woff;
    woff += d->kp[l] * u;
    d->gboff[l] = gboff;
    gboff += 2 * u;
    kmax = d->kp[l] > kmax ? d->kp[l] : kmax;
    kmax = u > kmax ? u : kmax;
  }
  d->wsz = woff;
  d->gbsz = (gboff + 3) & ~3;
  d->lda = kmax;
  return 0;
}

// shared memory of a block of the instance (T, mt): g/b and the weights,
// then a part for each tile group of 16 mt rows (+ 8 bf16 or + 4 f32
// elements a row: rows 16 bytes apart mod 128, so that ldmatrix is free of
// bank conflicts). The f32 instance runs two tile groups a block where
// they fit (ops/pfn.py::smem_bytes mirrors this).
template <typename T>
static size_t pfn_smem(PfnDims* d, int mt, bool wide) {
  const bool tc = sizeof(T) == 2;
  const int rows = 16 * mt;
  d->lda += tc ? 8 : 4;
  d->group_bytes = (int)(sizeof(T) * rows * d->lda +
                         sizeof(int) * (4 * PFN_PIL + rows) +
                         sizeof(float) * 4 * (rows + PFN_PIL));
  const size_t shared = sizeof(float) * d->gbsz + sizeof(T) * d->wsz;
  d->groups = !tc && !wide &&
                      shared + 2 * (size_t)d->group_bytes <= PFN_SMEM_MAX
                  ? 2 : 1;
  return shared + (size_t)d->groups * d->group_bytes;
}

template <typename T>
static int launch_tiles(const PfnPoints& pp, const int* starts,
                        const int* counts, const int* cells, const int* num,
                        const int* row0, const int* tile_first,
                        const void* wbuf, const float* gb, const int* dims,
                        T* table, float* partials, unsigned long long* prof,
                        int B, int N, int P, int ntiles, int point_dim,
                        int with_distance, int grid_w, float vs, float cx0,
                        float cy0, int zero_tail, int k, int c_out,
                        cudaStream_t stream) {
  PfnDims d;
  if (parse_dims(dims, &d) || k < 1 || k > 128) return MB_BAD_ARGS;
  const int u_last = d.units[d.nl - 1];
  if (c_out < 1 || c_out > u_last || u_last - c_out >= 8) return MB_BAD_ARGS;
  bool wide = false;
  for (int l = 0; l < d.nl; ++l) wide = wide || d.units[l] > 128;
  const int mt = k <= 32 ? 6 : 12;  // m16 tiles of 64 + k - 1 rows
  const size_t smem = pfn_smem<T>(&d, mt, wide);
  if (smem > PFN_SMEM_MAX) return MB_BAD_ARGS;
  const int threads = PFN_THREADS * d.groups;
  auto kern = wide ? (mt == 6 ? pfn_tile_kernel<T, 6, true>
                              : pfn_tile_kernel<T, 12, true>)
                   : (mt == 6 ? pfn_tile_kernel<T, 6, false>
                              : pfn_tile_kernel<T, 12, false>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                smem);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int grid = (per_sm > 0 ? per_sm : 1) * sms;
  if (!zero_tail && grid > ceil_div(B * ntiles, d.groups))
    grid = ceil_div(B * ntiles, d.groups);
  if (grid < 1) grid = 1;
  kern<<<grid, threads, smem, stream>>>(
      pp, starts, counts, cells, num, row0, tile_first, wbuf, gb, d, table,
      partials, prof, B, N, P, ntiles, point_dim, with_distance, grid_w, vs,
      cx0, cy0, zero_tail, c_out);
  return (int)cudaGetLastError();
}

// the layered route on X, a (B N, lda) workspace of the instance's type
// (lda: the widest padded layer input or units, ops/pfn.py::layered_lda)
template <typename T>
static int launch_layered(const PfnPoints& pp, const int* starts,
                          const int* counts, const int* cells, const int* num,
                          const int* lrow0, const int* tot, const void* wbuf,
                          const float* gb, const int* dims, T* X, int lda,
                          T* table, float* partials, int B, int N, int P,
                          int point_dim, int with_distance, int grid_w,
                          float vs, float cx0, float cy0, int zero_tail,
                          int c_out, cudaStream_t stream) {
  PfnDims d;
  if (parse_dims(dims, &d) || lda < d.lda || lda % 8) return MB_BAD_ARGS;
  const int u_last = d.units[d.nl - 1];
  if (c_out < 1 || c_out > u_last || u_last - c_out >= 8) return MB_BAD_ARGS;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int wgrid = sms * PFN_LAYERED_BLOCKS;
  constexpr int ROWS = 16 * layered_mt<T>();
  int kpmax = 0;
  for (int l = 0; l < d.nl; ++l) kpmax = d.kp[l] > kpmax ? d.kp[l] : kpmax;
  const int smem =
      ROWS * (kpmax + (sizeof(T) == 2 ? 8 : 4)) * (int)sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      pfn_layered_mma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  pfn_layered_decorate_kernel<T><<<wgrid, PFN_THREADS, 0, stream>>>(
      pp, starts, counts, cells, num, lrow0, X, lda, d.kp[0], B, N, P,
      point_dim, with_distance, grid_w, vs, cx0, cy0);
  const uint2* wfr = reinterpret_cast<const uint2*>(wbuf);
  const dim3 mgrid(ceil_div(N, ROWS), B);
  for (int li = 0; li < d.nl; ++li) {
    const float* g = gb + d.gboff[li];
    pfn_layered_mma_kernel<T><<<mgrid, PFN_THREADS, smem, stream>>>(
        X, lda, tot, N, wfr + d.woff[li] / (8 / (int)sizeof(T)), g,
        g + d.units[li], d.kp[li], d.units[li]);
    pfn_layered_max_kernel<T><<<wgrid, PFN_THREADS, 0, stream>>>(
        X, lda, counts, num, lrow0, B, N, P, d.units[li], li == d.nl - 1,
        table, partials, c_out, zero_tail);
  }
  return (int)cudaGetLastError();
}

// Kernel 1. cols: four sorted (B, N) f32 columns; starts, counts, cells,
// row0: (B, N) int32 pillar directory; num: (B,) occupied rows; tile_first:
// (B, ntiles + 1) int32 (ops/stream_pillars.py::pfn_tiles); wbuf: the
// weights in B-fragment order (bf16 for m16n8k16, f32 for m16n8k8), each
// layer zero-padded to kp rows and its units to a multiple of 8; gb: f32
// g, b per layer; table (B, N, c_out: the last layer's true units, its
// padded units less at most 7) and partials (B, N, 2): rows at and beyond
// num[b] are not written. prof: null, or PFN_PARTS + 1 zeroed int64 (the
// parts' ns summed over the tile groups, then the groups). k: the most
// kept points a pillar holds (1 .. 128; above 32 the instance of 12 m16
// tiles). f32: nonzero for the f32 instance (f32 weights and table).
MB_EXPORT int pfn_forward(const float* x, const float* y, const float* z,
                          const float* it, const int* starts,
                          const int* counts, const int* cells,
                          const int* num, const int* row0,
                          const int* tile_first, const void* wbuf,
                          const float* gb, const int* dims, void* table,
                          float* partials, unsigned long long* prof, int B,
                          int N, int ntiles, int point_dim, int with_distance,
                          int grid_w, float vs, float cx0, float cy0, int k,
                          int c_out, int f32, cudaStream_t stream) {
  if (point_dim < 1 || point_dim > 4) return MB_BAD_ARGS;
  PfnPoints pp = {{x, y, z, it}, nullptr, 0};
  if (f32)
    return launch_tiles<float>(pp, starts, counts, cells, num, row0,
                               tile_first, wbuf, gb, dims, (float*)table,
                               partials, prof, B, N, N, ntiles, point_dim,
                               with_distance, grid_w, vs, cx0, cy0, 0, k,
                               c_out, stream);
  return launch_tiles<bf16>(pp, starts, counts, cells, num, row0, tile_first,
                            wbuf, gb, dims, (bf16*)table, partials, prof, B,
                            N, N, ntiles, point_dim, with_distance, grid_w, vs,
                            cx0, cy0, 0, k, c_out, stream);
}

// Kernel 10. pts (B, N, D) sorted points in the instance's type, D 3 or 4;
// starts, counts, cells, row0: (B, P) int32 slot directory; nvalid (B,);
// table (B, P, c_out), partials (B, P, 2): every row written, zero at and
// beyond nvalid[b]; prof, k and c_out as for pfn_forward.
MB_EXPORT int stream_pfn_forward(const void* pts, int D, const int* starts,
                                 const int* counts, const int* cells,
                                 const int* nvalid, const int* row0,
                                 const int* tile_first, const void* wbuf,
                                 const float* gb, const int* dims,
                                 void* table, float* partials,
                                 unsigned long long* prof, int B, int N,
                                 int P, int ntiles, int with_distance,
                                 int grid_w, float vs, float cx0, float cy0,
                                 int k, int c_out, int f32,
                                 cudaStream_t stream) {
  if (D < 3 || D > 4) return MB_BAD_ARGS;
  PfnPoints pp = {{nullptr, nullptr, nullptr, nullptr}, pts, D};
  if (f32)
    return launch_tiles<float>(pp, starts, counts, cells, nvalid, row0,
                               tile_first, wbuf, gb, dims, (float*)table,
                               partials, prof, B, N, P, ntiles, D,
                               with_distance, grid_w, vs, cx0, cy0, 1, k,
                               c_out, stream);
  return launch_tiles<bf16>(pp, starts, counts, cells, nvalid, row0,
                            tile_first, wbuf, gb, dims, (bf16*)table,
                            partials, prof, B, N, P, ntiles, D, with_distance,
                            grid_w, vs, cx0, cy0, 1, k, c_out, stream);
}

// The layered route of kernels 1 and 10: cols (kernel 1: four sorted (B,
// N) f32 columns) or pts (kernel 10: (B, N, D) sorted points of the
// instance's type, cols null); starts, counts, cells, lrow0: (B, P) int32,
// the route's directory (counts 0: a pillar the tiles take), tot (B,) its
// rows a sample; X: a (B N, lda) workspace; table (B, P, c_out), partials
// (B, P, 2) at the route's pillars (zero_tail: also zero at and beyond
// num[b]); the rest as for pfn_forward.
MB_EXPORT int pfn_layered_forward(const float* x, const float* y,
                                  const float* z, const float* it,
                                  const void* pts, int D, const int* starts,
                                  const int* counts, const int* cells,
                                  const int* num, const int* lrow0,
                                  const int* tot, const void* wbuf,
                                  const float* gb, const int* dims, void* X,
                                  int lda, void* table, float* partials,
                                  int B, int N, int P, int point_dim,
                                  int with_distance, int grid_w, float vs,
                                  float cx0, float cy0, int zero_tail,
                                  int c_out, int f32, cudaStream_t stream) {
  if (point_dim < 1 || point_dim > 4 || (pts && (D < 3 || D > 4)))
    return MB_BAD_ARGS;
  PfnPoints pp = {{x, y, z, it}, pts, D};
  if (f32)
    return launch_layered<float>(pp, starts, counts, cells, num, lrow0, tot,
                                 wbuf, gb, dims, (float*)X, lda,
                                 (float*)table, partials, B, N, P, point_dim,
                                 with_distance, grid_w, vs, cx0, cy0,
                                 zero_tail, c_out, stream);
  return launch_layered<bf16>(pp, starts, counts, cells, num, lrow0, tot,
                              wbuf, gb, dims, (bf16*)X, lda, (bf16*)table,
                              partials, B, N, P, point_dim, with_distance,
                              grid_w, vs, cx0, cy0, zero_tail, c_out, stream);
}

MB_EXPORT int pfn_stats(const float* partials, const int* num, float* stats,
                        int B, int N, cudaStream_t stream) {
  pfn_stats_kernel<<<B, 1024, 0, stream>>>(partials, num, stats, N);
  return (int)cudaGetLastError();
}
