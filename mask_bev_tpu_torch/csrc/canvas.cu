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
// 3.35 TB/s (twice that in f32); at KITTI's 800x800 grid 1.31 GB of
// canvas and 328 MB of affine, ~0.5 ms. Design, as the TPU kernel's
// blocks: a block owns a run of CANVAS_RUN consecutive cells of all B
// samples. Each cell holds at most one pillar and a sample's cells are
// ascending, so one binary search a sample (thread b searches sample b)
// finds the run's first table row, and the next CANVAS_RUN rows at most
// hold the run's pillars: the block reads those cell ids once into a
// shared-memory map from cell to row (-1 for an empty cell; the TPU's 0/1
// selection matmul). It then streams the run's cells x C in 16-byte words,
// consecutive threads on consecutive words (so a warp stores 512
// contiguous bytes): a word reads its affine slice once and writes it
// for all B samples, each from its table row or, for an empty cell, from
// 0 with no load. The arithmetic is the same f32 operations in the same
// order as the first version's (one warp a cell, a binary search per cell
// and sample, ~17 dependent L2 loads before each store), so the output is
// the same bit for bit. Rows that are not whole 16-byte words (bf16 C % 8
// != 0, f32 C % 4 != 0), or a table at an address that is not 16-byte
// aligned, take canvas_norm_narrow_kernel: the same body moving words of
// the widest power of two bytes that divides the row and every address (8,
// 4 or 2 bytes: bf16 C = 100 moves 8-byte words, f32 C = 101 single
// values).
#include "common.cuh"

#define CANVAS_RUN 64
#define CANVAS_THREADS 256

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

// one 16-byte word <-> EPW values as f32
template <typename T> struct Word;
template <> struct Word<bf16> {
  static constexpr int EPW = 8;
  static __device__ __forceinline__ void load(const bf16* p, float* o) {
    ld8(p, o);
  }
  static __device__ __forceinline__ void store(bf16* p, const float* o) {
    st8(p, o);
  }
};
template <> struct Word<float> {
  static constexpr int EPW = 4;
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* o) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};

// a word of WB < 16 bytes (a divisor of the row's bytes) <-> WB / sizeof(T)
// values as f32, one load or store of a WB-byte integer
template <int WB> struct Bytes;
template <> struct Bytes<8> { using U = uint2; };
template <> struct Bytes<4> { using U = uint32_t; };
template <> struct Bytes<2> { using U = uint16_t; };
template <> struct Bytes<1> { using U = uint8_t; };

template <typename T, int WB>
struct NarrowWord {
  static constexpr int EPW = WB / (int)sizeof(T);
  using U = typename Bytes<WB>::U;
  static __device__ __forceinline__ void load(const T* p, float* o) {
    const U u = *reinterpret_cast<const U*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int q = 0; q < EPW; ++q) o[q] = to_f(e[q]);
  }
  static __device__ __forceinline__ void store(T* p, const float* o) {
    U u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int q = 0; q < EPW; ++q) e[q] = from_f<T>(o[q]);
    *reinterpret_cast<U*>(p) = u;
  }
};

// The kernel's body for words of type Wd (Word<T>, or NarrowWord<T, WB>).
// T: the table's, the affine's and the canvas's type (bf16 or f32).
// Dynamic shared memory: B (CANVAS_RUN + 3) ints.
template <typename T, typename Wd>
__device__ __forceinline__ void canvas_norm_body(
    const T* __restrict__ table, const int* __restrict__ cells,
    const int* __restrict__ num_pillars, const float* __restrict__ mv,
    const T* __restrict__ scale, const T* __restrict__ bias,
    int full, T* __restrict__ out, int B, int N, int HW, int C, float eps) {
  constexpr int EPW = Wd::EPW;
  extern __shared__ int smi[];
  int* row_of = smi;                    // [B][CANVAS_RUN]: table row or -1
  int* first = smi + B * CANVAS_RUN;    // [B]: the run's first table row
  float* mean_s = reinterpret_cast<float*>(first + B);  // [B]
  float* rstd_s = mean_s + B;                           // [B]
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * CANVAS_RUN;
  const int nc = min(CANVAS_RUN, HW - c0);

  for (int i = tid; i < B * CANVAS_RUN; i += CANVAS_THREADS) row_of[i] = -1;
  for (int b = tid; b < B; b += CANVAS_THREADS) {
    first[b] = lower_bound(cells + (size_t)b * N, num_pillars[b], c0);
    mean_s[b] = mv[2 * b];
    rstd_s[b] = rsqrtf(mv[2 * b + 1] + eps);
  }
  __syncthreads();
  // rows first[b] .. first[b] + CANVAS_RUN - 1 hold every pillar of the run
  for (int i = tid; i < B * CANVAS_RUN; i += CANVAS_THREADS) {
    const int b = i / CANVAS_RUN;
    const int r = first[b] + i % CANVAS_RUN;
    if (r < num_pillars[b]) {
      const int cell = __ldg(cells + (size_t)b * N + r) - c0;
      if (cell < nc) row_of[b * CANVAS_RUN + cell] = r;
    }
  }
  __syncthreads();

  const int V = C / EPW;  // words a cell
  for (int i = tid; i < nc * V; i += CANVAS_THREADS) {
    const int cell = i / V, c = (i - cell * V) * EPW;
    float s[EPW], bi[EPW];
    const size_t aoff = full ? (size_t)(c0 + cell) * C + c : (size_t)c;
    Wd::load(scale + aoff, s);
    Wd::load(bias + aoff, bi);
    for (int b = 0; b < B; ++b) {
      const int r = row_of[b * CANVAS_RUN + cell];
      float v[EPW];
      if (r >= 0) {
        Wd::load(table + ((size_t)b * N + r) * C + c, v);
      } else {
#pragma unroll
        for (int q = 0; q < EPW; ++q) v[q] = 0.f;
      }
      const float mean = mean_s[b], rstd = rstd_s[b];
      float o[EPW];
#pragma unroll
      for (int q = 0; q < EPW; ++q)
        o[q] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[q], mean), rstd),
                                   s[q]), bi[q]);
      Wd::store(out + ((size_t)b * HW + c0 + cell) * C + c, o);
    }
  }
}

// rows of whole 16-byte words
template <typename T>
__global__ void __launch_bounds__(CANVAS_THREADS) canvas_norm_kernel(
    const T* __restrict__ table, const int* __restrict__ cells,
    const int* __restrict__ num_pillars, const float* __restrict__ mv,
    const T* __restrict__ scale, const T* __restrict__ bias,
    int full, T* __restrict__ out, int B, int N, int HW, int C, float eps) {
  canvas_norm_body<T, Word<T>>(table, cells, num_pillars, mv, scale, bias,
                               full, out, B, N, HW, C, eps);
}

// rows (or addresses) of whole WB-byte words, WB < 16
template <typename T, int WB>
__global__ void __launch_bounds__(CANVAS_THREADS) canvas_norm_narrow_kernel(
    const T* __restrict__ table, const int* __restrict__ cells,
    const int* __restrict__ num_pillars, const float* __restrict__ mv,
    const T* __restrict__ scale, const T* __restrict__ bias,
    int full, T* __restrict__ out, int B, int N, int HW, int C, float eps) {
  canvas_norm_body<T, NarrowWord<T, WB>>(table, cells, num_pillars, mv,
                                         scale, bias, full, out, B, N, HW,
                                         C, eps);
}

// the widest power of two up to 16 that divides every value of v: the word
// bytes a row of ``row_bytes`` at these addresses moves in
static inline int word_bytes(int row_bytes, const void* a, const void* b,
                             const void* c = nullptr,
                             const void* d = nullptr) {
  const uintptr_t v = (uintptr_t)row_bytes | (uintptr_t)a | (uintptr_t)b |
                      (uintptr_t)c | (uintptr_t)d | 16;
  return (int)(v & (~v + 1));
}

template <typename T>
static int launch_canvas_norm(const void* table, const int* cells,
                              const int* num_pillars, const float* mv,
                              const void* scale, const void* bias, int full,
                              void* out, int B, int N, int HW, int C,
                              float eps, cudaStream_t stream) {
  const size_t smem = sizeof(int) * (size_t)B * (CANVAS_RUN + 3);
  if (C < 1 || smem > 48 * 1024) return MB_BAD_ARGS;
  const int wb = word_bytes(C * (int)sizeof(T), table, out, scale, bias);
  if (wb < (int)sizeof(T)) return MB_BAD_ARGS;
  const dim3 grid(ceil_div(HW, CANVAS_RUN));
#define MB_CANVAS_ARGS                                                   \
  (const T*)table, cells, num_pillars, mv, (const T*)scale,              \
      (const T*)bias, full, (T*)out, B, N, HW, C, eps
  if (wb == 16)
    canvas_norm_kernel<T><<<grid, CANVAS_THREADS, smem, stream>>>(
        MB_CANVAS_ARGS);
  else if (wb == 8)
    canvas_norm_narrow_kernel<T, 8><<<grid, CANVAS_THREADS, smem, stream>>>(
        MB_CANVAS_ARGS);
  else if (wb == 4)
    canvas_norm_narrow_kernel<T, 4><<<grid, CANVAS_THREADS, smem, stream>>>(
        MB_CANVAS_ARGS);
  else if constexpr (sizeof(T) == 2)
    canvas_norm_narrow_kernel<T, 2><<<grid, CANVAS_THREADS, smem, stream>>>(
        MB_CANVAS_ARGS);
#undef MB_CANVAS_ARGS
  return (int)cudaGetLastError();
}

// f32: nonzero for the f32 instance (f32 table, affine and canvas). Any C:
// rows of whole 16-byte words (C % 8 == 0 in bf16, C % 4 in f32) at
// 16-byte aligned addresses take canvas_norm_kernel, others the narrow
// instances; B <= 183 (the block's cell map in 48 KB of shared memory);
// each sample's cells strictly ascending over its num_pillars rows.
MB_EXPORT int canvas_norm_forward(const void* table, const int* cells,
                                  const int* num_pillars, const float* mv,
                                  const void* scale, const void* bias,
                                  int full, void* out, int B, int N, int HW,
                                  int C, float eps, int f32,
                                  cudaStream_t stream) {
  if (B < 1 || HW < 1) return MB_BAD_ARGS;
  if (f32)
    return launch_canvas_norm<float>(table, cells, num_pillars, mv, scale,
                                     bias, full, out, B, N, HW, C, eps,
                                     stream);
  return launch_canvas_norm<bf16>(table, cells, num_pillars, mv, scale, bias,
                                  full, out, B, N, HW, C, eps, stream);
}

// ---------------------------------------------------------------------------
// Kernels A and B: the training scatter and its gradient.
//
// Replace mask_bev_tpu/ops/pallas_canvas.py::canvas_scatter (forward
// through canvas_from_table without the norm epilogue; backward
// _canvas_scatter_bwd, a row gather). Both only move rows, so they work on
// words of any element type and are exact: 16-byte words where the row's
// bytes and the addresses allow, else the widest power of two bytes that
// divides them (the narrow instances; a bf16 row of 100 values moves as 25
// 8-byte words).
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

// The bodies, for words of type V: uint4 (rows of whole 16-byte words, the
// kernels below) or a narrower integer (canvas_*_narrow_kernel: rows of any
// width, moved in the widest words that divide the row and the addresses,
// word_bytes), V words a row.
template <typename V>
__device__ __forceinline__ void scatter_body(const V* __restrict__ table,
                                             const int* __restrict__ cells,
                                             V* __restrict__ out, int P,
                                             int HW, int Vw) {
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
  const size_t base_out = ((size_t)b * HW + c0) * Vw;
  const size_t base_tab = (size_t)b * P * Vw;
  const int words = nc * Vw;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int c = i / Vw, v = i - c * Vw;
    const int r = row_of[c];
    V val{};
    if (r >= 0) val = __ldg(table + base_tab + (size_t)r * Vw + v);
    out[base_out + i] = val;
  }
}

template <typename V>
__device__ __forceinline__ void gather_body(const V* __restrict__ d_canvas,
                                            const int* __restrict__ cells,
                                            V* __restrict__ d_table, int B,
                                            int P, int HW, int Vw) {
  const size_t total = (size_t)B * P * Vw;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / Vw;
    const int v = (int)(i - row * Vw);
    const int b = (int)(row / P);
    const int cell = __ldg(cells + row);
    V val{};
    if (cell >= 0 && cell < HW)
      val = __ldg(d_canvas + ((size_t)b * HW + cell) * Vw + v);
    d_table[i] = val;
  }
}

__global__ void __launch_bounds__(256) canvas_scatter_kernel(
    const uint4* __restrict__ table, const int* __restrict__ cells,
    uint4* __restrict__ out, int P, int HW, int V) {
  scatter_body(table, cells, out, P, HW, V);
}

__global__ void __launch_bounds__(256) canvas_gather_kernel(
    const uint4* __restrict__ d_canvas, const int* __restrict__ cells,
    uint4* __restrict__ d_table, int B, int P, int HW, int V) {
  gather_body(d_canvas, cells, d_table, B, P, HW, V);
}

template <typename V>
__global__ void __launch_bounds__(256) canvas_scatter_narrow_kernel(
    const V* __restrict__ table, const int* __restrict__ cells,
    V* __restrict__ out, int P, int HW, int Vw) {
  scatter_body(table, cells, out, P, HW, Vw);
}

template <typename V>
__global__ void __launch_bounds__(256) canvas_gather_narrow_kernel(
    const V* __restrict__ d_canvas, const int* __restrict__ cells,
    V* __restrict__ d_table, int B, int P, int HW, int Vw) {
  gather_body(d_canvas, cells, d_table, B, P, HW, Vw);
}

// Any row_bytes >= 1: rows of whole 16-byte words at 16-byte aligned
// addresses take the 16-byte kernels, the rest the narrow instances with
// word_bytes(row_bytes, table, out) bytes a word.
MB_EXPORT int canvas_scatter_forward(const void* table, const int* cells,
                                     void* out, int B, int P, int HW,
                                     int row_bytes, cudaStream_t stream) {
  if (row_bytes < 1 || B < 1 || P < 1 || HW < 1) return MB_BAD_ARGS;
  dim3 grid(ceil_div(HW, SCATTER_CELLS), B);
  const int wb = word_bytes(row_bytes, table, out);
  const int vw = row_bytes / wb;
#define MB_SCATTER(U)                                                  \
  canvas_scatter_narrow_kernel<U><<<grid, 256, 0, stream>>>(           \
      (const U*)table, cells, (U*)out, P, HW, vw)
  if (wb == 16)
    canvas_scatter_kernel<<<grid, 256, 0, stream>>>(
        (const uint4*)table, cells, (uint4*)out, P, HW, vw);
  else if (wb == 8) MB_SCATTER(uint2);
  else if (wb == 4) MB_SCATTER(uint32_t);
  else if (wb == 2) MB_SCATTER(uint16_t);
  else MB_SCATTER(uint8_t);
#undef MB_SCATTER
  return (int)cudaGetLastError();
}

MB_EXPORT int canvas_scatter_backward(const void* d_canvas, const int* cells,
                                      void* d_table, int B, int P, int HW,
                                      int row_bytes, cudaStream_t stream) {
  if (row_bytes < 1 || B < 1 || P < 1 || HW < 1) return MB_BAD_ARGS;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int wb = word_bytes(row_bytes, d_canvas, d_table);
  const int vw = row_bytes / wb;
  const size_t words = (size_t)B * P * vw;
  const size_t need = (words + 255) / 256, most = (size_t)sms * 16;
  const int blocks = (int)(need < most ? need : most);
#define MB_GATHER(U)                                                   \
  canvas_gather_narrow_kernel<U><<<blocks, 256, 0, stream>>>(          \
      (const U*)d_canvas, cells, (U*)d_table, B, P, HW, vw)
  if (wb == 16)
    canvas_gather_kernel<<<blocks, 256, 0, stream>>>(
        (const uint4*)d_canvas, cells, (uint4*)d_table, B, P, HW, vw);
  else if (wb == 8) MB_GATHER(uint2);
  else if (wb == 4) MB_GATHER(uint32_t);
  else if (wb == 2) MB_GATHER(uint16_t);
  else MB_GATHER(uint8_t);
#undef MB_GATHER
  return (int)cudaGetLastError();
}
