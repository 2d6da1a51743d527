// Kernels 1 and 10: pillar feature net -> dense pillar table + norm
// statistics.
//
// Kernel 10 (stream_pfn_forward) replaces
// mask_bev_tpu/ops/pallas_pfn.py::fused_stream_pfn (_pfn_kernel), the v1 PFN
// on the capped stream of the eval path when the slot path is off: the TPU
// kernel writes pooled features for every stream row and the caller reads
// them at the pillar starts (gather_at_starts); this one writes the
// (B, P, C) pillar table those reads give, one warp per pillar slot, with
// the same per-pillar body as kernel 1 (below) and the same statistics.
// The kept points of a slot are found from its start row, pid and kept
// flag; slots beyond the occupied ones are zero rows. Its bound is kernel
// 1's: the products, 2 x kept points x sum(in x out) at the bf16 rate.
//
// Kernel 1 replaces mask_bev_tpu/ops/pallas_pfn.py::fused_stream_pfn_slots
// (_pfn_slots_kernel). The stable sort and the pillar directory (run starts,
// kept counts, ascending cells) come from plain torch
// (ops/stream_pillars.py); this kernel decorates each pillar's kept points,
// runs the PFN layers (linear, folded BN, relu, max over the pillar, concat)
// and writes the pillar's last-layer feature as one row of the dense table,
// plus per-row [sum, sum of squares] partials of the written (rounded)
// values. A second launch (pfn_stats) reduces the partials per sample in a
// fixed order, so the statistics repeat bit for bit (no float atomics).
//
// What bounds it on the H100: operations. At the flagship (3 layers,
// 10->64, 128->64, 128->128) each kept point costs ~25k multiply-adds; the
// products are bf16 (bf16 weights, layer inputs rounded to bf16) with f32
// accumulation, so their floor is the bf16 tensor-core rate (989 TFLOP/s):
// ~0.05 ms for the ~940k kept points of 8 scans. Its bytes (4 input columns
// and 3 directory ints per point slot, 256 B per pillar row) are ~120 MB,
// ~0.035 ms at 3.35 TB/s. This first design runs the products as f32 FMAs
// on CUDA cores, so it sits far above that floor: one warp per pillar
// (K <= 32 points, lane = point for the decoration, lane = output channel
// for the layers), all layers' weights in shared memory (bf16) once per
// block (read by every warp of the block; each lane reads consecutive
// channels, so no bank conflicts), and each warp's point activations in
// shared memory (bf16: every layer input is rounded to bf16 before its
// product anyway), updated in place layer by layer. The max over the pillar
// is a running max in registers: no shuffles. Tensor-core tiles of pillars
// are the next step. Only bf16 weights and a bf16 table are built: the
// wrapper raises on other dtypes.
#include "common.cuh"

#define PFN_MAXL 4

struct PfnDims {
  int nl;
  int in[PFN_MAXL];
  int units[PFN_MAXL];
  int src_w[PFN_MAXL];  // offsets of W, g, b in the packed f32 weights
  int src_g[PFN_MAXL];
  int src_b[PFN_MAXL];
  int woff[PFN_MAXL];   // offset of W in the shared-memory weight region
  int goff[PFN_MAXL];   // offsets of g, b in the shared-memory f32 region
  int boff[PFN_MAXL];
  int gb;               // floats of the g/b region (multiple of 4)
  int wsz;              // elements of the W region (multiple of 8)
  int amax;             // widest activation row
};

// Weights and point activations live in shared memory as bf16: every layer
// input is rounded to bf16 before its product (as the TPU kernel casts to
// the weight dtype), so bf16 storage loses nothing and fits 16 warps.
__device__ __forceinline__ void pfn_load_weights(const float* __restrict__ wpack,
                                 const PfnDims d, float* gbs, bf16* wsm) {
  for (int l = 0; l < d.nl; ++l) {
    const int u = d.units[l];
    for (int i = threadIdx.x; i < d.in[l] * u; i += blockDim.x)
      wsm[d.woff[l] + i] = from_f<bf16>(wpack[d.src_w[l] + i]);
    for (int i = threadIdx.x; i < u; i += blockDim.x) {
      gbs[d.goff[l] + i] = wpack[d.src_g[l] + i];
      gbs[d.boff[l] + i] = wpack[d.src_b[l] + i];
    }
  }
  __syncthreads();
}

// One pillar, one warp: lane < n holds kept point ``lane`` (x, y, z, it);
// decorate, run the layers, write the last layer's max as ``row`` (bf16)
// and its [sum, sum of squares] as ``partial``.
__device__ __forceinline__ void pfn_pillar(float x, float y, float z, float it, int n,
                           int cell, const PfnDims d, const float* gbs,
                           const bf16* wsm, bf16* act, int point_dim,
                           int with_distance, int grid_w, float vs,
                           float cx0, float cy0, bf16* __restrict__ row,
                           float* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const bool mine = lane < n;
  const float cnt = fmaxf((float)n, 1.f);
  const float mx = warp_sum(x) / cnt;
  const float my = warp_sum(y) / cnt;
  const float mz = warp_sum(z) / cnt;
  const float cx = __fadd_rn(__fmul_rn((float)(cell % grid_w), vs), cx0);
  const float cy = __fadd_rn(__fmul_rn((float)(cell / grid_w), vs), cy0);
  if (mine) {
    bf16* a = act + lane * d.amax;
    const float raw[4] = {x, y, z, it};
    int j = 0;
    for (int q = 0; q < point_dim; ++q) a[j++] = from_f<bf16>(raw[q]);
    a[j++] = from_f<bf16>(x - mx);
    a[j++] = from_f<bf16>(y - my);
    a[j++] = from_f<bf16>(z - mz);
    a[j++] = from_f<bf16>(x - cx);
    a[j++] = from_f<bf16>(y - cy);
    if (with_distance)
      a[j++] = from_f<bf16>(sqrtf(__fadd_rn(
          __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z))));
  }
  __syncwarp();

  for (int li = 0; li < d.nl; ++li) {
    const int in = d.in[li], u = d.units[li];
    const bf16* W = wsm + d.woff[li];
    const float* g = gbs + d.goff[li];
    const float* bb = gbs + d.boff[li];
    const bool last = li == d.nl - 1;
    float pooled[4] = {0.f, 0.f, 0.f, 0.f};
    // two points per pass: each weight read from shared memory serves
    // both (the per-point arithmetic and its order are unchanged)
    for (int p = 0; p < n; p += 2) {
      const bool two = p + 1 < n;
      bf16* a0 = act + p * d.amax;
      bf16* a1 = a0 + d.amax;
      float acc0[4] = {0.f, 0.f, 0.f, 0.f};
      float acc1[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < in; ++k) {
        const float av0 = to_f(a0[k]);
        const float av1 = two ? to_f(a1[k]) : 0.f;
        const bf16* wr = W + k * u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = lane + 32 * j;
          if (c < u) {
            const float w = to_f(wr[c]);
            acc0[j] = fmaf(av0, w, acc0[j]);
            acc1[j] = fmaf(av1, w, acc1[j]);
          }
        }
      }
      __syncwarp();  // every lane has read rows p, p+1 before they change
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;
        if (c < u) {
          const float z0 =
              fmaxf(__fadd_rn(__fmul_rn(acc0[j], g[c]), bb[c]), 0.f);
          pooled[j] = fmaxf(pooled[j], z0);
          if (!last) a0[c] = from_f<bf16>(z0);
          if (two) {
            const float z1 =
                fmaxf(__fadd_rn(__fmul_rn(acc1[j], g[c]), bb[c]), 0.f);
            pooled[j] = fmaxf(pooled[j], z1);
            if (!last) a1[c] = from_f<bf16>(z1);
          }
        }
      }
      __syncwarp();
    }
    if (!last) {
      for (int p = 0; p < n; ++p) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = lane + 32 * j;
          if (c < u) act[p * d.amax + u + c] = from_f<bf16>(pooled[j]);
        }
      }
      __syncwarp();
    } else {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;
        if (c < u) {
          const bf16 v = from_f<bf16>(pooled[j]);
          row[c] = v;
          const float vf = to_f(v);
          s1 += vf;
          s2 += vf * vf;
        }
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        partial[0] = s1;
        partial[1] = s2;
      }
    }
  }
}

// Kernel 1: the pillar directory (starts, kept counts, cells) comes with
// the stream; one warp per occupied pillar.
__global__ void __launch_bounds__(512) pfn_kernel(
    const float* __restrict__ px_, const float* __restrict__ py_,
    const float* __restrict__ pz_, const float* __restrict__ pi_,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ cells, const int* __restrict__ num_pillars,
    const float* __restrict__ wpack, PfnDims d, bf16* __restrict__ table,
    float* __restrict__ partials, int N, int K, int point_dim,
    int with_distance, int grid_w, float vs, float cx0, float cy0) {
  extern __shared__ float smem[];
  float* gbs = smem;
  bf16* wsm = reinterpret_cast<bf16*>(smem + d.gb);
  pfn_load_weights(wpack, d, gbs, wsm);

  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* act = wsm + d.wsz + (size_t)warp * K * d.amax;
  const int b = blockIdx.y;
  const int P = num_pillars[b];
  const size_t base = (size_t)b * N;
  const int c_out = d.units[d.nl - 1];

  for (int r = blockIdx.x * warps + warp; r < P; r += gridDim.x * warps) {
    const int s0 = starts[base + r];
    const int n = counts[base + r];
    float x = 0.f, y = 0.f, z = 0.f, it = 0.f;
    if (lane < n) {
      const size_t i = base + s0 + lane;
      x = px_[i]; y = py_[i]; z = pz_[i]; it = pi_[i];
    }
    pfn_pillar(x, y, z, it, n, cells[base + r], d, gbs, wsm, act, point_dim,
               with_distance, grid_w, vs, cx0, cy0,
               table + (base + r) * (size_t)c_out, partials + (base + r) * 2);
  }
}

// Kernel 10: the capped stream of the eval path when the slot path is off.
// Slot r < nvalid[b] of sample b is the pillar whose run starts at
// starts[b, r] in cell cells[b, r]; its kept points are the rows from that
// start that carry the cell's pid and the kept flag (at most K, contiguous:
// the first K of the run). Slots at and beyond nvalid are written as zero
// rows, as gather_at_starts writes them.
__global__ void __launch_bounds__(512) stream_pfn_kernel(
    const bf16* __restrict__ pts, int D, const int* __restrict__ pid,
    const unsigned char* __restrict__ kept, const int* __restrict__ starts,
    const int* __restrict__ cells, const int* __restrict__ nvalid,
    const float* __restrict__ wpack, PfnDims d, bf16* __restrict__ table,
    float* __restrict__ partials, int N, int P, int K, int point_dim,
    int with_distance, int grid_w, float vs, float cx0, float cy0) {
  extern __shared__ float smem[];
  float* gbs = smem;
  bf16* wsm = reinterpret_cast<bf16*>(smem + d.gb);
  pfn_load_weights(wpack, d, gbs, wsm);

  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* act = wsm + d.wsz + (size_t)warp * K * d.amax;
  const int b = blockIdx.y;
  const int nv = nvalid[b];
  const size_t base = (size_t)b * N, sbase = (size_t)b * P;
  const int c_out = d.units[d.nl - 1];

  for (int r = blockIdx.x * warps + warp; r < P; r += gridDim.x * warps) {
    bf16* row = table + (sbase + r) * (size_t)c_out;
    float* partial = partials + (sbase + r) * 2;
    if (r >= nv) {
      for (int c = lane; c < c_out; c += 32) row[c] = from_f<bf16>(0.f);
      if (lane == 0) partial[0] = partial[1] = 0.f;
      continue;
    }
    const int s0 = starts[sbase + r];
    const int cell = cells[sbase + r];
    const int i = s0 + lane;
    const bool mine = lane < K && i < N && kept[base + i] &&
                      pid[base + i] == cell;
    const int n = __popc(__ballot_sync(0xffffffffu, mine));
    float x = 0.f, y = 0.f, z = 0.f, it = 0.f;
    if (mine) {
      const bf16* pt = pts + (base + i) * D;
      x = to_f(pt[0]); y = to_f(pt[1]); z = to_f(pt[2]);
      it = D > 3 ? to_f(pt[3]) : 0.f;
    }
    pfn_pillar(x, y, z, it, n, cell, d, gbs, wsm, act, point_dim,
               with_distance, grid_w, vs, cx0, cy0, row, partial);
  }
}

__global__ void __launch_bounds__(1024) pfn_stats_kernel(
    const float* __restrict__ partials, const int* __restrict__ num_pillars,
    float* __restrict__ stats, int N) {
  __shared__ float r1[1024], r2[1024];
  const int b = blockIdx.x;
  const int P = num_pillars[b];
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

// dims: [n_layers, in_0, units_0, in_1, units_1, ...] (host memory)
static int parse_dims(const int* dims, int K, int max_warps, PfnDims* d) {
  d->nl = dims[0];
  if (d->nl < 1 || d->nl > PFN_MAXL || K > 32 || max_warps < 1 ||
      max_warps > 16)
    return MB_BAD_ARGS;
  int src = 0, woff = 0, gboff = 0, amax = 0;
  for (int l = 0; l < d->nl; ++l) {
    const int in = dims[1 + 2 * l], u = dims[2 + 2 * l];
    if (u > 128) return MB_BAD_ARGS;
    d->in[l] = in;
    d->units[l] = u;
    d->src_w[l] = src;
    d->src_g[l] = src + in * u;
    d->src_b[l] = src + in * u + u;
    src += in * u + 2 * u;
    d->woff[l] = woff;
    woff += in * u;
    d->goff[l] = gboff;
    d->boff[l] = gboff + u;
    gboff += 2 * u;
    amax = in > amax ? in : amax;
    // a layer's row holds its input, and the concat [z, pooled] it builds
    // for the next layer (the last layer's output never enters the row)
    if (l + 1 < d->nl && 2 * u > amax) amax = 2 * u;
  }
  d->gb = (gboff + 3) & ~3;
  d->wsz = (woff + 7) & ~7;
  d->amax = (amax + 1) & ~1;
  return 0;
}

// Shared memory of a block: the weights, then K activation rows per warp.
// Returns the warps per block (0 if one warp does not fit).
static int pfn_block(const PfnDims& d, int K, int max_warps, size_t* smem) {
  const size_t fixed = sizeof(float) * d.gb + sizeof(bf16) * d.wsz;
  const size_t per_warp = sizeof(bf16) * (size_t)K * d.amax;
  const size_t budget = 232448;  // shared memory a block may opt in to
  if (fixed + per_warp > budget) return 0;
  int warps = (int)((budget - fixed) / per_warp);
  warps = warps < max_warps ? warps : max_warps;
  *smem = fixed + per_warp * warps;
  return warps;
}

// wpack: per layer W (in x units, row-major, bf16 values), g (units),
// b (units), f32; table: (B, N, units of the last layer) bf16;
// max_warps: pillars in flight per block (fewer if shared memory is short).
MB_EXPORT int pfn_forward(const float* x, const float* y, const float* z,
                          const float* it, const int* starts,
                          const int* counts, const int* cells,
                          const int* num_pillars, const float* wpack,
                          const int* dims, bf16* table, float* partials,
                          int B, int N, int K, int point_dim,
                          int with_distance, int grid_w,
                          float vs, float cx0, float cy0,
                          int blocks_per_sample, int max_warps,
                          cudaStream_t stream) {
  PfnDims d;
  if (parse_dims(dims, K, max_warps, &d)) return MB_BAD_ARGS;
  size_t smem = 0;
  const int warps = pfn_block(d, K, max_warps, &smem);
  if (!warps) return MB_BAD_ARGS;
  cudaError_t e = cudaFuncSetAttribute(
      pfn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  dim3 grid(blocks_per_sample, B);
  pfn_kernel<<<grid, warps * 32, smem, stream>>>(
      x, y, z, it, starts, counts, cells, num_pillars, wpack, d, table,
      partials, N, K, point_dim, with_distance, grid_w, vs, cx0, cy0);
  return (int)cudaGetLastError();
}

// Kernel 10. pts (B, N, D) bf16, D <= 4; pid (B, N) int32; kept (B, N)
// bool; starts, cells (B, P) int32; nvalid (B,) int32; table (B, P, units
// of the last layer) bf16; partials (B, P, 2) f32.
MB_EXPORT int stream_pfn_forward(const bf16* pts, int D, const int* pid,
                                 const unsigned char* kept, const int* starts,
                                 const int* cells, const int* nvalid,
                                 const float* wpack, const int* dims,
                                 bf16* table, float* partials, int B, int N,
                                 int P, int K, int point_dim,
                                 int with_distance, int grid_w, float vs,
                                 float cx0, float cy0, int blocks_per_sample,
                                 int max_warps, cudaStream_t stream) {
  PfnDims d;
  if (D < 3 || D > 4 || point_dim > D ||
      parse_dims(dims, K, max_warps, &d))
    return MB_BAD_ARGS;
  size_t smem = 0;
  const int warps = pfn_block(d, K, max_warps, &smem);
  if (!warps) return MB_BAD_ARGS;
  cudaError_t e = cudaFuncSetAttribute(
      stream_pfn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
  dim3 grid(blocks_per_sample, B);
  stream_pfn_kernel<<<grid, warps * 32, smem, stream>>>(
      pts, D, pid, kept, starts, cells, nvalid, wpack, d, table, partials, N,
      P, K, point_dim, with_distance, grid_w, vs, cx0, cy0);
  return (int)cudaGetLastError();
}

MB_EXPORT int pfn_stats(const float* partials, const int* num_pillars,
                        float* stats, int B, int N, cudaStream_t stream) {
  pfn_stats_kernel<<<B, 1024, 0, stream>>>(partials, num_pillars, stats, N);
  return (int)cudaGetLastError();
}
