// Kernel 8: stride-p patch-embed conv + its token LayerNorm, one launch.
//
// Replaces mask_bev_tpu/ops/pallas_patch_embed.py::fused_patch_embed
// (_patch_embed_kernel). The TPU kernel reads a batch-minor flat canvas;
// this one reads kernel 2's (B, H, W, C) canvas as it is:
//   y[m, :] = A[m, :] . Wm^T + bias      (f32 accumulation)
//   out[m]  = (y - mean) * rsqrt(var + eps) * ln_w + ln_b   (f32, rounded
//             once to the canvas type)
// where token m = (b, gy, gx) and A[m, k], k = dh p C + dw C + c, is
// canvas[b, gy p + dh, gx p + dw, c]; the statistics are the fast-variance
// form var = max(0, E[y^2] - mean^2). Two instances: a bf16 canvas and
// weight (bf16 products), an f32 canvas with the weight's TF32 halves
// (3xTF32, as csrc/gemm.cuh's OP_TF32X3: lo.hi + hi.lo + hi.hi, each
// 32-deep stage's partial added into f32 sums with rounding to nearest).
//
// What bounds it on the H100: bytes in bf16, operations in f32. At the
// KITTI grid (B 8, 800^2 x 128 canvas, p 4, E 192, 320,000 tokens) the
// bf16 canvas is 1.31 GB, ~0.39 ms at 3.35 TB/s, and the products 0.25
// TFLOP, ~0.25 ms at the bf16 peak; in f32 the canvas is 2.62 GB (0.78 ms)
// and 3xTF32 makes 0.75 TFLOP of TF32 products (1.5 ms at 495 TFLOP/s).
//
// Design: an implicit GEMM on wgmma fed by TMA, the patch matrix never in
// device memory. The canvas is a 4-D tensor map over (B gh, p, gw, p C),
// dims innermost first (p C, gw, p, B gh): one box is a 128-byte K slice
// of one patch row dh for a tile of tokens, so a k-step (dh, then the p C
// slice) is embed_matrix's (dh, dw, c) order and the weight stays the
// K-major (E, p p C) matrix. A tile is 128 token rows in smem, tile_x
// tokens along gx times tile_y rows (b, gy) (ops/patch_embed.py::plan
// picks the shape that needs the fewest tiles): the box never crosses a
// row's end but where the map makes it exact (TMA fills zeros past gw and
// past B gh, and the stores skip those rows), and rows tile_x tile_y ..
// 127 stay zero. At 800^2 (gw 200, B gh 1600) tiles of 8 x 16 tokens fill
// all 128 rows; at 500^2 (gw 125) tiles of 125 x 1 leave 3 rows empty
// (2.3 % of the products wasted).
//
// Each block owns 128-row tiles and all E outputs of them: two consumer
// warpgroups of 64 rows each, so the LayerNorm runs on the accumulator
// registers. bf16: one wgmma m64nEk16 a 16-deep step (E = 48, 64, 96,
// 128, 192 or 256: each width its own instruction and instance),
// one group of four kept in flight. f32: the 3xTF32 partial sums of a
// stage and the f32 sums of all E columns do not fit one thread's
// registers for E = 192 and 256, so a stage runs in column passes of
// tf_cols<E>() (96 or 64; E itself up to 128) of m64n<cols>k8 .tf32, with A read from the
// swizzled f32 tile into registers and split there once a stage. A
// row's values sit in one lane quad: bias, sums, then two shfl_xor give
// the statistics, and each lane stores its own column pairs; no f32 tile
// goes through shared memory.
//
// The weight is read from L2 once a pair of tiles: blocks run in clusters
// of two whose tiles are neighbours, and each block loads half of a
// stage's weight rows with TMA multicast into both (E / 2 rows: a multiple
// of 8 for every E taken, so each half starts on a whole 1024-byte swizzle
// atom; E = 48, the narrowest, still fills a ring of 6 stages). At 800^2
// in bf16 that is 1250 pairs x 786 KB = 0.98 GB of L2 reads (1.97 GB if
// each 128-token tile read it alone), in f32 1250 x 3.1 MB (hi and lo) = 3.9 GB. Persistent
// grid: one block an SM walks tile pairs; one producer thread keeps a ring
// of stages in flight across tile boundaries, so one tile's epilogue
// overlaps the next tile's loads; a stage is free again when the
// consumers of both blocks have released it.
#include <type_traits>

#include "gemm.cuh"

namespace pe {
using namespace mbgemm;

constexpr int TILE = 128;           // token rows a tile (2 warpgroups x 64)
constexpr int SMEM_MAX = 232448;    // a block's shared memory on the H100
constexpr int CONSUMER_WARPS = 8;

// two consumer warpgroups and a producer warpgroup, whose registers
// setmaxnreg moves to the consumers (40 and 232 a thread): the f32 sums of
// E = 256 columns take 128 of them
constexpr int THREADS = 384;
// a stage: the A tile and the weight tile (two for 3xTF32: hi, lo)
template <bool TF, int E>
__host__ __device__ constexpr int stage_bytes() {
  return TILE * BKB + (TF ? 2 : 1) * E * BKB;
}
template <bool TF, int E>
__host__ __device__ constexpr int stages() {
  return (SMEM_MAX - 1024 - 256) / stage_bytes<TF, E>() < 6
             ? (SMEM_MAX - 1024 - 256) / stage_bytes<TF, E>()
             : 6;
}
// dynamic shared memory: the ring, 1024-byte alignment slack, barriers
template <bool TF, int E>
__host__ __device__ constexpr int smem_bytes() {
  return stages<TF, E>() * stage_bytes<TF, E>() + 1024 +
         2 * stages<TF, E>() * 8;
}
// f32: the columns of one 3xTF32 pass (its partial sums' registers)
template <int E>
__host__ __device__ constexpr int tf_cols() {
  return E == 192 ? 96 : E == 256 ? 64 : E;
}

// the launch's tiling (ops/patch_embed.py::plan)
struct Plan {
  int gw, rows;        // tokens a row (b, gy); rows B gh
  int tx, ty;          // a tile's tokens along gx and rows
  int tiles_x, tiles;  // tiles a row of tiles; all tiles
  int pairs;           // tile pairs: one a cluster at a time
  int nk, spd;         // k-steps; k-steps a patch row dh
  float eps;
};

// wgmma operand lists: accumulator registers d[i..] and their PTX names
#define PE_F4(i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define PE_F16(i) PE_F4(i), PE_F4(i + 4), PE_F4(i + 8), PE_F4(i + 12)
#define PE_F32(i) PE_F16(i), PE_F16(i + 16)
#define PE_R0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define PE_R1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define PE_R2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define PE_R3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define PE_R4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define PE_R5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define PE_R6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define PE_R7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define PE_R8 "%64, %65, %66, %67, %68, %69, %70, %71"
#define PE_R9 "%72, %73, %74, %75, %76, %77, %78, %79"
#define PE_R10 "%80, %81, %82, %83, %84, %85, %86, %87"
#define PE_R11 "%88, %89, %90, %91, %92, %93, %94, %95"
#define PE_R12 "%96, %97, %98, %99, %100, %101, %102, %103"
#define PE_R13 "%104, %105, %106, %107, %108, %109, %110, %111"
#define PE_R14 "%112, %113, %114, %115, %116, %117, %118, %119"
#define PE_R15 "%120, %121, %122, %123, %124, %125, %126, %127"
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      PE_R0 ", " PE_R1 ", " PE_R2 ", " PE_R3
      "}, %32, %33, p, 1, 1, 0, 0;\n}"
      : PE_F32(0)
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_bf16(float (&d)[24], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %26, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      PE_R0 ", " PE_R1 ", " PE_R2
      "}, %24, %25, p, 1, 1, 0, 0;\n}"
      : PE_F16(0), PE_F4(16), PE_F4(20)
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_bf16(float (&d)[48], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      PE_R0 ", " PE_R1 ", " PE_R2 ", " PE_R3 ", " PE_R4 ", " PE_R5
      "}, %48, %49, p, 1, 1, 0, 0;\n}"
      : PE_F32(0), PE_F16(32)
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      PE_R0 ", " PE_R1 ", " PE_R2 ", " PE_R3 ", " PE_R4 ", "
      PE_R5 ", " PE_R6 ", " PE_R7
      "}, %64, %65, p, 1, 1, 0, 0;\n}"
      : PE_F32(0), PE_F32(32)
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_bf16(float (&d)[96], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      PE_R0 ", " PE_R1 ", " PE_R2 ", " PE_R3 ", " PE_R4 ", "
      PE_R5 ", " PE_R6 ", " PE_R7 ", " PE_R8 ", " PE_R9 ", "
      PE_R10 ", " PE_R11
      "}, %96, %97, p, 1, 1, 0, 0;\n}"
      : PE_F32(0), PE_F32(32), PE_F32(64)
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      PE_R0 ", " PE_R1 ", " PE_R2 ", " PE_R3 ", " PE_R4 ", "
      PE_R5 ", " PE_R6 ", " PE_R7 ", " PE_R8 ", " PE_R9 ", "
      PE_R10 ", " PE_R11 ", " PE_R12 ", " PE_R13 ", " PE_R14 ", "
      PE_R15
      "}, %128, %129, p, 1, 1, 0, 0;\n}"
      : PE_F32(0), PE_F32(32), PE_F32(64), PE_F32(96)
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[24],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %29, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      PE_R0 ", " PE_R1 ", " PE_R2
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}"
      : PE_F16(0), PE_F4(16), PE_F4(20)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(acc));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      PE_R0 ", " PE_R1 ", " PE_R2 ", " PE_R3
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}"
      : PE_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(acc));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[48],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %53, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      PE_R0 ", " PE_R1 ", " PE_R2 ", " PE_R3 ", " PE_R4 ", " PE_R5
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}"
      : PE_F32(0), PE_F16(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(acc));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      PE_R0 ", " PE_R1 ", " PE_R2 ", " PE_R3 ", " PE_R4 ", "
      PE_R5 ", " PE_R6 ", " PE_R7
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}"
      : PE_F32(0), PE_F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(acc));
}
#undef PE_F4
#undef PE_F16
#undef PE_F32
#undef PE_R0
#undef PE_R1
#undef PE_R2
#undef PE_R3
#undef PE_R4
#undef PE_R5
#undef PE_R6
#undef PE_R7
#undef PE_R8
#undef PE_R9
#undef PE_R10
#undef PE_R11
#undef PE_R12
#undef PE_R13
#undef PE_R14
#undef PE_R15

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// lane 0 of each consumer warp frees the ring stage of barrier ``empty``
// in both blocks of the cluster
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) {
    mbar_arrive_cta(empty, 0);
    mbar_arrive_cta(empty, 1);
  }
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// grid: 2 min(pairs, SMs / 2) blocks in clusters of 2; warpgroups 0 and 1
// consume, warpgroup 2 produces. tmB2: the weight's lo half for 3xTF32
// (tmB its hi half), unused in bf16.
template <bool TF, int E>
__global__ void __cluster_dims__(2, 1, 1)
    __launch_bounds__(THREADS, 1) patch_embed_kernel(
        const __grid_constant__ CUtensorMap tmA,
        const __grid_constant__ CUtensorMap tmB,
        const __grid_constant__ CUtensorMap tmB2,
        const float* __restrict__ bias, const float* __restrict__ ln_w,
        const float* __restrict__ ln_b,
        typename std::conditional<TF, float, bf16>::type* __restrict__ out,
        const Plan pl) {
  constexpr int STAGES = stages<TF, E>(), STAGE = stage_bytes<TF, E>();
  constexpr int A_BYTES = TILE * BKB, B_BYTES = E * BKB;
  constexpr int BK = TF ? 32 : 64;  // K elements a stage
  extern __shared__ unsigned char smraw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smraw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const uint32_t rank = cluster_rank();
  const int wg = threadIdx.x >> 7;
  const int a_rows = pl.tx * pl.ty;
  const int cid = blockIdx.x >> 1, ncl = gridDim.x >> 1;

  // the tile rows the A box never writes stay zero
  const int tail = (TILE - a_rows) * (BKB / 16);
  for (int i = threadIdx.x; i < STAGES * tail; i += THREADS) {
    const int s = i / tail;
    reinterpret_cast<uint4*>(sm + s * STAGE + a_rows * BKB)[i - s * tail] =
        make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * CONSUMER_WARPS);  // both blocks' consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  cluster_sync();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int pair = cid; pair < pl.pairs; pair += ncl) {
        const int tile = min(2 * pair + (int)rank, pl.tiles - 1);
        const int gx0 = (tile % pl.tiles_x) * pl.tx;
        const int row0 = (tile / pl.tiles_x) * pl.ty;
        for (int kt = 0; kt < pl.nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage],
                         a_rows * BKB + (TF ? 2 : 1) * B_BYTES);
          unsigned char* st = sm + stage * STAGE;
          const int dh = kt / pl.spd;
          tma_load_4d(st, &tmA, &full[stage], (kt - dh * pl.spd) * BK, gx0,
                      dh, row0);
          // this block's half of the weight rows, into both blocks
          const int half = rank * (E / 2);
          tma_load_2d_multicast(st + A_BYTES + half * BKB, &tmB,
                                &full[stage], kt * BK, half, 3);
          if (TF)
            tma_load_2d_multicast(st + A_BYTES + B_BYTES + half * BKB,
                                  &tmB2, &full[stage], kt * BK, half, 3);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers ----------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, quad = lane & 3;
    float acc[E / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int pair = cid; pair < pl.pairs; pair += ncl) {
      const int mine = 2 * pair + (int)rank;  // >= tiles: a copy, not stored
      const int tile = min(mine, pl.tiles - 1);
      const int gx0 = (tile % pl.tiles_x) * pl.tx;
      const int row0 = (tile / pl.tiles_x) * pl.ty;
      if constexpr (TF) {
        constexpr int NP = tf_cols<E>();
        float d[NP / 2];
#pragma unroll
        for (int i = 0; i < E / 2; ++i) acc[i] = 0.f;
        const int r0 = warp * 16 + g;
        for (int kt = 0; kt < pl.nk; ++kt) {
          mbar_wait(&full[stage], phase);
          const unsigned char* st = sm + stage * STAGE;
          // this warp's A fragments of the stage, split into TF32 halves:
          // chunk c of row r sits at chunk c ^ (r & 7) (128-byte swizzle)
          const float* at =
              reinterpret_cast<const float*>(st + wg * 64 * BKB);
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const int c0 = (((2 * ks) ^ g) << 2) + quad;
            const int c1 = (((2 * ks + 1) ^ g) << 2) + quad;
            split_tf32(at[r0 * 32 + c0], ah[ks][0], al[ks][0]);
            split_tf32(at[(r0 + 8) * 32 + c0], ah[ks][1], al[ks][1]);
            split_tf32(at[r0 * 32 + c1], ah[ks][2], al[ks][2]);
            split_tf32(at[(r0 + 8) * 32 + c1], ah[ks][3], al[ks][3]);
          }
#pragma unroll
          for (int h = 0; h < E / NP; ++h) {
            const uint64_t dh_ = sw128_desc(st + A_BYTES + h * NP * BKB);
            const uint64_t dl_ =
                sw128_desc(st + A_BYTES + B_BYTES + h * NP * BKB);
            fence_regs(d);
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                asm volatile("" : "+r"(ah[ks][q]), "+r"(al[ks][q])::"memory");
            asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
              // the small terms first, then hi.hi; d restarts each pass
              wgmma_tf32(d, al[ks], dh_ + 2 * ks, ks);
              wgmma_tf32(d, ah[ks], dl_ + 2 * ks, 1);
              wgmma_tf32(d, ah[ks], dh_ + 2 * ks, 1);
            }
            asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
            fence_regs(d);
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                asm volatile("" : "+r"(ah[ks][q]), "+r"(al[ks][q])::"memory");
#pragma unroll
            for (int i = 0; i < NP / 2; ++i)
              acc[h * (NP / 2) + i] = __fadd_rn(acc[h * (NP / 2) + i], d[i]);
          }
          release(&empty[stage], lane);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      } else {
        // one wgmma group in flight: a stage is released when the group
        // after it has been issued
        int prev = -1;
        for (int kt = 0; kt < pl.nk; ++kt) {
          mbar_wait(&full[stage], phase);
          const unsigned char* st = sm + stage * STAGE;
          const uint64_t da = sw128_desc(st + wg * 64 * BKB);
          const uint64_t db = sw128_desc(st + A_BYTES);
          fence_regs(acc);
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_bf16(acc, da + 2 * ks, db + 2 * ks, (kt | ks) != 0);
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
          fence_regs(acc);
          if (prev >= 0) release(&empty[prev], lane);
          prev = stage;
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_regs(acc);
        release(&empty[prev], lane);
      }

      // ---- bias + LayerNorm from the registers: lane (g, quad) of warp w
      // holds rows 16 w + g and + 8 of its warpgroup's 64, columns 8 j + 2
      // quad and + 1 of every 8-column group j
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * 64 + warp * 16 + g + 8 * h;
        const int ty = r / pl.tx, tx = r - ty * pl.tx;
        const int gy = row0 + ty, gx = gx0 + tx;
        float s = 0.f, s2 = 0.f;
#pragma unroll
        for (int j = 0; j < E / 8; ++j) {
          const float2 bb =
              __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * quad));
          const float v0 = __fadd_rn(acc[4 * j + 2 * h], bb.x);
          const float v1 = __fadd_rn(acc[4 * j + 2 * h + 1], bb.y);
          acc[4 * j + 2 * h] = v0;
          acc[4 * j + 2 * h + 1] = v1;
          s += v0;
          s += v1;
          s2 = fmaf(v0, v0, s2);
          s2 = fmaf(v1, v1, s2);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
        s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
        const float mean = s / (float)E;
        const float var = fmaxf(s2 / (float)E - mean * mean, 0.f);
        const float rstd = rsqrtf(var + pl.eps);
        if (mine < pl.tiles && r < a_rows && gx < pl.gw && gy < pl.rows) {
          auto* o = out + ((size_t)gy * pl.gw + gx) * E + 2 * quad;
#pragma unroll
          for (int j = 0; j < E / 8; ++j) {
            const float2 w2 = __ldg(
                reinterpret_cast<const float2*>(ln_w + 8 * j + 2 * quad));
            const float2 b2 = __ldg(
                reinterpret_cast<const float2*>(ln_b + 8 * j + 2 * quad));
            store2(o + 8 * j,
                   __fadd_rn(__fmul_rn(__fmul_rn(acc[4 * j + 2 * h] - mean,
                                                 rstd), w2.x), b2.x),
                   __fadd_rn(__fmul_rn(__fmul_rn(acc[4 * j + 2 * h + 1] -
                                                     mean, rstd), w2.y),
                             b2.y));
          }
        }
      }
    }
  }
  __syncwarp();
  cluster_sync();  // no block leaves while its peer may still signal it
}

template <bool TF, int E>
static int launch(const void* canvas, const void* wm, const void* wm_lo,
                  const float* bias, const float* ln_w, const float* ln_b,
                  void* out, int B, int H, int W, int C, int p, int tx,
                  int ty, float eps, cudaStream_t stream) {
  using OT = typename std::conditional<TF, float, bf16>::type;
  const int esz = TF ? 4 : 2, bk = BKB / esz;
  const int pC = p * C, gw = W / p, rows = B * (H / p);
  if (pC % bk || tx < 1 || ty < 1 || tx * ty > TILE || tx > gw ||
      ty > rows || (TF && wm_lo == nullptr))
    return MB_BAD_ARGS;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        patch_embed_kernel<TF, E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<TF, E>());
    if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
    attr_set = true;
  }
  // the canvas as (B gh, p, gw, p C), innermost first
  const cuuint64_t adims[4] = {(cuuint64_t)pC, (cuuint64_t)gw,
                               (cuuint64_t)p, (cuuint64_t)rows};
  const cuuint64_t astr[3] = {(cuuint64_t)pC * esz, (cuuint64_t)gw * pC * esz,
                              (cuuint64_t)p * gw * pC * esz};
  const cuuint32_t abox[4] = {(cuuint32_t)bk, (cuuint32_t)tx, 1u,
                              (cuuint32_t)ty};
  const cuuint64_t bdims[2] = {(cuuint64_t)(p * pC), (cuuint64_t)E};
  const cuuint64_t bstr[1] = {(cuuint64_t)p * pC * esz};
  const cuuint32_t bbox[2] = {(cuuint32_t)bk, (cuuint32_t)(E / 2)};
  CUtensorMap ta, tb, tb2;
  int rc = encode_map(&ta, canvas, esz, 4, adims, astr, abox);
  if (!rc) rc = encode_map(&tb, wm, esz, 2, bdims, bstr, bbox);
  tb2 = tb;
  if (!rc && TF) rc = encode_map(&tb2, wm_lo, esz, 2, bdims, bstr, bbox);
  if (rc) return rc;
  Plan pl;
  pl.gw = gw;
  pl.rows = rows;
  pl.tx = tx;
  pl.ty = ty;
  pl.tiles_x = ceil_div(gw, tx);
  pl.tiles = pl.tiles_x * ceil_div(rows, ty);
  pl.pairs = ceil_div(pl.tiles, 2);
  pl.spd = pC / bk;
  pl.nk = p * pl.spd;
  pl.eps = eps;
  const int clusters = pl.pairs < num_sms() / 2 ? pl.pairs : num_sms() / 2;
  patch_embed_kernel<TF, E><<<2 * clusters, THREADS,
                              smem_bytes<TF, E>(), stream>>>(
      ta, tb, tb2, bias, ln_w, ln_b, (OT*)out, pl);
  return (int)cudaGetLastError();
}

template <bool TF>
static int dispatch(int E, const void* canvas, const void* wm,
                    const void* wm_lo, const float* bias, const float* ln_w,
                    const float* ln_b, void* out, int B, int H, int W, int C,
                    int p, int tx, int ty, float eps, cudaStream_t stream) {
  switch (E) {
    case 48:
      return launch<TF, 48>(canvas, wm, wm_lo, bias, ln_w, ln_b, out, B, H,
                            W, C, p, tx, ty, eps, stream);
    case 64:
      return launch<TF, 64>(canvas, wm, wm_lo, bias, ln_w, ln_b, out, B, H,
                            W, C, p, tx, ty, eps, stream);
    case 96:
      return launch<TF, 96>(canvas, wm, wm_lo, bias, ln_w, ln_b, out, B, H,
                            W, C, p, tx, ty, eps, stream);
    case 128:
      return launch<TF, 128>(canvas, wm, wm_lo, bias, ln_w, ln_b, out, B, H,
                             W, C, p, tx, ty, eps, stream);
    case 192:
      return launch<TF, 192>(canvas, wm, wm_lo, bias, ln_w, ln_b, out, B, H,
                             W, C, p, tx, ty, eps, stream);
    case 256:
      return launch<TF, 256>(canvas, wm, wm_lo, bias, ln_w, ln_b, out, B, H,
                             W, C, p, tx, ty, eps, stream);
    default:
      return MB_BAD_ARGS;
  }
}

}  // namespace pe

// canvas (B, H, W, C); wm (E, p p C) K-major; bias, ln_w, ln_b (E,) f32;
// out (B, H/p * W/p, E). bf16 (f32 == 0): canvas, wm, out bf16, wm_lo
// unused; f32: canvas and out f32, wm and wm_lo the weight's TF32 halves
// hi and lo. E one of 48, 64, 96, 128, 192, 256; p C a multiple of 64 (bf16) or
// 32 (f32); (tile_x, tile_y) from ops/patch_embed.py::plan.
MB_EXPORT int patch_embed_forward(const void* canvas, const void* wm,
                                  const void* wm_lo, const float* bias,
                                  const float* ln_w, const float* ln_b,
                                  void* out, int B, int H, int W, int C,
                                  int E, int p, int tile_x, int tile_y,
                                  float eps, int f32, cudaStream_t stream) {
  if (B < 1 || p < 1 || H % p || W % p || H < p || W < p) return MB_BAD_ARGS;
  if (f32)
    return pe::dispatch<true>(E, canvas, wm, wm_lo, bias, ln_w, ln_b, out, B,
                              H, W, C, p, tile_x, tile_y, eps, stream);
  return pe::dispatch<false>(E, canvas, wm, wm_lo, bias, ln_w, ln_b, out, B,
                             H, W, C, p, tile_x, tile_y, eps, stream);
}
