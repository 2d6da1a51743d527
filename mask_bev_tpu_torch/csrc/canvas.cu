// Kernel 2: dense pillar table -> normalised (B, H, W, C) canvas.
//
// Replaces mask_bev_tpu/ops/pallas_canvas.py::canvas_from_table
// (_canvas_kernel) with its pseudo-image LayerNorm epilogue. Every cell is
// written: its pillar's row, or 0 for an empty cell, then
// ((v - mean) * rsqrt(var + eps)) * scale + bias in f32, rounded once to
// the table's type: table, affine and canvas are all bf16 or all f32 (two
// instances; the wrapper raises on other types).
//
// What bounds it on the H100: bytes. At the flagship (B 8, 500x500, C 128,
// bf16) it writes 512 MB of canvas and reads 128 MB of full-mode affine
// plus the occupied table rows (~96 MB for ~374k pillars): ~0.22 ms at
// 3.35 TB/s (twice that in f32). Design: one warp per cell, lanes over
// channels in 4-wide vectors (8 B accesses in bf16, 16 B in f32,
// coalesced per cell row); the cell's affine slice is
// read once and applied to all B samples (the affine is shared across the batch, so
// it crosses HBM once, not B times). The cell -> row lookup is a binary
// search over the sample's ascending cells (each cell holds at most one
// pillar, so no selection matmul is needed); its reads hit L2.
#include "common.cuh"

// four values of T <-> one 8-byte (bf16) or 16-byte (f32) word
__device__ __forceinline__ void load4(const bf16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  o[0] = __low2float(a); o[1] = __high2float(a);
  o[2] = __low2float(b); o[3] = __high2float(b);
}
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void store4(bf16* p, const float* o) {
  __nv_bfloat162 a = __floats2bfloat162_rn(o[0], o[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(o[2], o[3]);
  uint2 v;
  v.x = *reinterpret_cast<unsigned int*>(&a);
  v.y = *reinterpret_cast<unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = v;
}
__device__ __forceinline__ void store4(float* p, const float* o) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}

// first index in [0, n) with cells[i] >= key (n if none)
__device__ __forceinline__ int lower_bound(const int* __restrict__ cells,
                                           int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cells + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// T: the table's, the affine's and the canvas's type (bf16 or f32)
template <typename T>
__global__ void __launch_bounds__(256) canvas_norm_kernel(
    const T* __restrict__ table, const int* __restrict__ cells,
    const int* __restrict__ num_pillars, const float* __restrict__ mv,
    const T* __restrict__ scale, const T* __restrict__ bias,
    int full, T* __restrict__ out, int B, int N, int HW, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int warps_total = gridDim.x * (blockDim.x >> 5);
  for (int cell = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       cell < HW; cell += warps_total) {
    for (int c = lane * 4; c < C; c += 128) {
      float s[4], bi[4];
      const size_t aoff = full ? (size_t)cell * C + c : (size_t)c;
      load4(scale + aoff, s);
      load4(bias + aoff, bi);
      for (int b = 0; b < B; ++b) {
        const int* cb = cells + (size_t)b * N;
        const int P = num_pillars[b];
        const int r = lower_bound(cb, P, cell);
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (r < P && __ldg(cb + r) == cell)
          load4(table + ((size_t)b * N + r) * C + c, v);
        const float mean = mv[2 * b];
        const float rstd = rsqrtf(mv[2 * b + 1] + eps);
        float o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          o[q] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[q], mean), rstd),
                                     s[q]), bi[q]);
        store4(out + ((size_t)b * HW + cell) * C + c, o);
      }
    }
  }
}

// f32: nonzero for the f32 instance (f32 table, affine and canvas)
MB_EXPORT int canvas_norm_forward(const void* table, const int* cells,
                                  const int* num_pillars, const float* mv,
                                  const void* scale, const void* bias,
                                  int full, void* out, int B, int N, int HW,
                                  int C, float eps, int f32,
                                  cudaStream_t stream) {
  if (C % 4) return MB_BAD_ARGS;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (f32)
    canvas_norm_kernel<float><<<sms * 8, 256, 0, stream>>>(
        (const float*)table, cells, num_pillars, mv, (const float*)scale,
        (const float*)bias, full, (float*)out, B, N, HW, C, eps);
  else
    canvas_norm_kernel<bf16><<<sms * 8, 256, 0, stream>>>(
        (const bf16*)table, cells, num_pillars, mv, (const bf16*)scale,
        (const bf16*)bias, full, (bf16*)out, B, N, HW, C, eps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernels A and B: the training scatter and its gradient.
//
// Replace mask_bev_tpu/ops/pallas_canvas.py::canvas_scatter (forward
// through canvas_from_table without the norm epilogue; backward
// _canvas_scatter_bwd, a row gather). Both only move rows, so they work on 16-byte words of any
// element type (row bytes % 16 == 0) and are exact.
//
// A: table (B, P, row) + cells (B, P), ascending per sample, H*W on unused
// slots -> canvas (B, H*W, row): every cell is written, its pillar's row or
// 0. What bounds it on the H100: bytes. At the training envelope (B 4,
// 500x500, C 128 bf16, P 32768) it writes the 256 MB canvas and reads the
// 33.5 MB table: ~0.086 ms at 3.35 TB/s. Design: a block owns 256
// consecutive cells of one sample; two binary searches find the table rows
// of that range, the block marks each owned cell's row in shared memory
// (the TPU's 0/1 selection matmul becomes this index map, since a cell holds
// at most one pillar), then writes its cells' rows or zeros as 16-byte
// words, consecutive threads on consecutive words.
//
// B: d_table[b, p] = cells[b, p] < H*W ? d_canvas[b, cells[b, p]] : 0, one
// thread per 16-byte word. Bound: bytes, the 33.5 MB of gathered rows read
// and written (the canvas rows that no pillar owns are never read): ~0.02 ms.

#define SCATTER_CELLS 256

__global__ void __launch_bounds__(256) canvas_scatter_kernel(
    const uint4* __restrict__ table, const int* __restrict__ cells,
    uint4* __restrict__ out, int P, int HW, int V) {
  __shared__ int row_of[SCATTER_CELLS];
  __shared__ int range[2];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * SCATTER_CELLS;
  const int nc = min(SCATTER_CELLS, HW - c0);
  const int* cb = cells + (size_t)b * P;
  for (int i = threadIdx.x; i < nc; i += blockDim.x) row_of[i] = -1;
  if (threadIdx.x == 0) range[0] = lower_bound(cb, P, c0);
  if (threadIdx.x == 32) range[1] = lower_bound(cb, P, c0 + nc);
  __syncthreads();
  for (int r = range[0] + threadIdx.x; r < range[1]; r += blockDim.x)
    row_of[__ldg(cb + r) - c0] = r;
  __syncthreads();
  const size_t base_out = ((size_t)b * HW + c0) * V;
  const size_t base_tab = (size_t)b * P * V;
  const int words = nc * V;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int c = i / V, v = i - c * V;
    const int r = row_of[c];
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r >= 0) val = __ldg(table + base_tab + (size_t)r * V + v);
    out[base_out + i] = val;
  }
}

__global__ void __launch_bounds__(256) canvas_gather_kernel(
    const uint4* __restrict__ d_canvas, const int* __restrict__ cells,
    uint4* __restrict__ d_table, int B, int P, int HW, int V) {
  const size_t total = (size_t)B * P * V;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / V;
    const int v = (int)(i - row * V);
    const int b = (int)(row / P);
    const int cell = __ldg(cells + row);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (cell >= 0 && cell < HW)
      val = __ldg(d_canvas + ((size_t)b * HW + cell) * V + v);
    d_table[i] = val;
  }
}

MB_EXPORT int canvas_scatter_forward(const void* table, const int* cells,
                                     void* out, int B, int P, int HW,
                                     int row_bytes, cudaStream_t stream) {
  if (row_bytes % 16 || B < 1 || P < 1 || HW < 1) return MB_BAD_ARGS;
  dim3 grid(ceil_div(HW, SCATTER_CELLS), B);
  canvas_scatter_kernel<<<grid, 256, 0, stream>>>(
      (const uint4*)table, cells, (uint4*)out, P, HW, row_bytes / 16);
  return (int)cudaGetLastError();
}

MB_EXPORT int canvas_scatter_backward(const void* d_canvas, const int* cells,
                                      void* d_table, int B, int P, int HW,
                                      int row_bytes, cudaStream_t stream) {
  if (row_bytes % 16 || B < 1 || P < 1 || HW < 1) return MB_BAD_ARGS;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t words = (size_t)B * P * (row_bytes / 16);
  const size_t need = (words + 255) / 256, most = (size_t)sms * 16;
  const int blocks = (int)(need < most ? need : most);
  canvas_gather_kernel<<<blocks, 256, 0, stream>>>(
      (const uint4*)d_canvas, cells, (uint4*)d_table, B, P, HW,
      row_bytes / 16);
  return (int)cudaGetLastError();
}
