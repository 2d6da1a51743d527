// Persistent warp-specialised GEMM with fused epilogues for Hopper, shared
// by the Swin block chain (kernels 3/4), the decoder stack's k/v
// projections (kernel 5) and window MSA (kernel 7). Replaces the products
// of mask_bev_tpu/ops/pallas_swin_block.py::fused_swin_block (:208) and
// ::fused_swin_block_col (:584) and of pallas_window_msa.py::
// fused_window_msa (:71).
//
// out[M, N] (bf16, or f32 for int8 and f32 operands) = epilogue(A[M, K] .
// Bt[N, K]^T), any K and N. A and Bt are both K-contiguous (Bt is a torch
// Linear weight), as wgmma requires for 8-bit and 32-bit operands, their
// rows lda and ldb elements apart: TMA takes only row pitches of whole
// 16-byte steps, so an int8 A with K % 16 != 0 (a bf16 one with K % 8, an
// f32 one with K % 4) is written by its producer at a padded pitch, and the
// weight is padded when it is packed (ops/swin_block.py::pitched); TMA
// reads the k past K as zeros, and the k-steps wholly past K are skipped,
// so the padding is never multiplied. N % 8 != 0 takes the N-tail
// instances (gemm_ntail.cu: tiles fitted to N, a staged epilogue with
// 16-byte stores); the flagship instances (N % 8 == 0) are these.
// Three operand kinds:
//   * bf16: f32 accumulation, wgmma m64n96k16;
//   * int8: int32 accumulation, wgmma m64n96k32, then dequantised with a
//     per-row activation scale and a per-column weight scale;
//   * f32 as 3xTF32: each operand x is split into hi = tf32_rna(x) and lo =
//     tf32_rna(x - hi) (common.cuh::split_tf32), and the tile accumulates
//     lo.hi + hi.lo + hi.hi in f32 with wgmma m64n96k8 .tf32 (lo.lo, below
//     2^-22 of the product, is dropped): an f32 product to within a few f32
//     roundings (~1e-6 relative), where one TF32 pass keeps ~3 digits. The
//     weight is split once, when the layer is prepared (ops/swin_block.py::
//     make_dense: Bt_hi, Bt_lo), and both halves arrive by TMA; the A tile
//     arrives by TMA in f32 and each consumer thread splits its own
//     fragment in registers (wgmma takes A from registers), so A is read
//     from device memory once, in f32.
//
// What bounds it on the H100: bytes at the Swin backbone's stage 0 (M =
// 125,000 tokens of C = 192: the four products of a block move ~26 C bytes
// a token and do 24 C^2 operations, well under the int8 ridge), operations
// at stages 2-3; and, in practice, the epilogue's instructions: each output
// takes ~15 f32 operations, ~35 with the exact erf GELU, so the fc1
// products are bound by instruction issue. f32 operands: 3 TF32 products a
// multiply-add, so the bound is 3 x ops / 495 TFLOP/s; the f32 tiles and
// the two weight halves make a stage 40 KB, and with 128 x 96 tiles the L2
// must deliver ~1.3 KB per k for 37k multiply-adds. The tensor cores' f32
// accumulation truncates, which at K = 1536 cost 1.3e-5 relative when all
// 3 K / 8 products went into one accumulator: each 32-deep stage's partial
// is added into f32 registers with rounding to nearest instead, which
// doubles the accumulator registers. The first f32 version ran on the
// CUDA cores (128 x 64 SIMT tiles, ~36 of their 67 TFLOP/s). The first
// bf16/int8 version staged 64-byte K slices through registers with WMMA
// 16x16x16 fragments and a per-warp shared-memory epilogue, and never
// reached a steady pipeline at K = 192. This design:
//   * a persistent grid of two blocks per SM walks 128 x 96 output tiles
//     in row-major tile order, so the blocks in flight share A rows in L2;
//     two blocks of 8 consumer warps each give the epilogue 16 warps an SM;
//     3xTF32 runs one block an SM, 4 stages deep, and gives its producer a
//     whole warpgroup so that setmaxnreg moves the producer's registers to
//     the consumers (40 and 232 a thread);
//   * one producer warp keeps a ring of stages in flight with TMA
//     (128-byte swizzle, mbarrier completion), across tile boundaries, so
//     one tile's epilogue overlaps the next tile's loads;
//   * two consumer warpgroups each take 64 rows of the tile and run wgmma
//     (both operands K-major; A from shared memory, or from registers for
//     3xTF32, where the next stage's A is read and split while this
//     stage's wgmmas run), releasing each stage as soon as its products
//     complete; k-steps wholly in the zero-filled K tail are skipped;
//   * the epilogue runs from the accumulator registers: a 4x4 transpose of
//     2-column pairs inside each lane quad gives every lane 8 consecutive
//     columns, finished with the same f32 operations in the same order as
//     before and one 16-byte store.
// int32 accumulation is exact in any order, so the int8 results are
// bit-identical to the first version's and to a float64 product.
//
// Epilogue modes (low bits) and flags:
//   0 bias            v = acc + bias
//   1 bias + GELU     erf GELU of the bf16-rounded v
//   2 bias + residual out = residual + bf16-rounded v
//   +16 round acc     bf16-round the raw product before the bias (XLA's
//                     order for ``x @ kernel + bias`` in bf16)
// int8: v = acc * sx[row] * sw[col] + bias, as int8_sim_dense computes it.
// The output type OT (bf16 or f32) is the model's: the f32 instances round
// nothing (residual, GELU and output in f32).
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace mbgemm {

// operand kinds
enum { OP_BF16 = 0, OP_S8 = 1, OP_TF32X3 = 2 };
__host__ __device__ constexpr int op_kind(int op) { return op & 3; }

constexpr int BM = 128, BN = 96;
constexpr int BKB = 128;  // bytes of K per stage: one 128-byte swizzle row
constexpr int CONSUMERS = 2;  // warpgroups of 64 rows each
constexpr int THREADS = 128 * CONSUMERS + 32;  // + one producer warp
constexpr int A_BYTES = BM * BKB, B_BYTES = BN * BKB;
constexpr int ACC = BN / 2;  // accumulator registers a thread (m64n96)
// a stage: the A tile and one B tile (two for 3xTF32: hi, lo), each
// 1024-byte aligned; 3 stages keep two blocks an SM within its shared
// memory. 3xTF32 runs one block an SM (its f32 partial sums double the
// accumulator registers) with 4 stages of 40 KB.
template <int OP>
__host__ __device__ constexpr int b_tiles() {
  return op_kind(OP) == OP_TF32X3 ? 2 : 1;
}
template <int OP>
__host__ __device__ constexpr int stages() {
  return op_kind(OP) == OP_TF32X3 ? 4 : 3;
}
template <int OP>
__host__ __device__ constexpr int blocks_per_sm() {
  return op_kind(OP) == OP_TF32X3 ? 1 : 2;
}
// threads a block: 3xTF32 gives the producer a whole warpgroup, so that
// setmaxnreg can move its registers to the consumers (40 and 232 a thread)
template <int OP>
__host__ __device__ constexpr int threads() {
  return op_kind(OP) == OP_TF32X3 ? 128 * CONSUMERS + 128 : THREADS;
}
template <int OP>
__host__ __device__ constexpr int stage_bytes() {
  return A_BYTES + b_tiles<OP>() * B_BYTES;
}
// dynamic shared memory: the ring, 1024-byte alignment slack, barriers
template <int OP>
__host__ __device__ constexpr int smem_bytes() {
  return stages<OP>() * stage_bytes<OP>() + 1024 + 2 * stages<OP>() * 8;
}
template <int OP>
__host__ __device__ constexpr int elem_bytes() {
  return op_kind(OP) == OP_S8 ? 1 : op_kind(OP) == OP_BF16 ? 2 : 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// wait until the barrier's phase differs from ``parity``
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// a 4-D box (c0 innermost); kernel 8 reads its canvas patches so
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- clusters (kernel 8: a cluster of blocks shares the weight tiles) ----
// a 2-D box written to the same offset of every block in ``mask`` of the
// cluster, each block's barrier at ``bar``'s offset receiving its bytes
__device__ __forceinline__ void tma_load_2d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      uint64_t* bar, int c0,
                                                      int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask),
      "r"(c0), "r"(c1)
      : "memory");
}

// arrive on the barrier at ``bar``'s offset in block ``cta`` of the cluster
__device__ __forceinline__ void mbar_arrive_cta(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [ra];\n}" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of every block of the cluster; orders shared-memory
// writes (barrier inits included) before what follows in the others
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the tile
// 1024-byte aligned; +2 advances it by one 32-byte K step
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_acc(uint32_t (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define MB_D8(i)                                                        \
  "+r"(d[(i) + 0]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3]), \
      "+r"(d[(i) + 4]), "+r"(d[(i) + 5]), "+r"(d[(i) + 6]), "+r"(d[(i) + 7])
#define MB_D48 MB_D8(0), MB_D8(8), MB_D8(16), MB_D8(24), MB_D8(32), MB_D8(40)
#define MB_R48                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47}"

// d (+)= A[64 x 32 bytes] . B[96 x 32 bytes]^T; ``acc`` 0 overwrites d
template <bool S8>
__device__ __forceinline__ void wgmma_96(uint32_t (&d)[ACC], uint64_t da,
                                         uint64_t db, int acc) {
  if (S8) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 " MB_R48
        ", %48, %49, p;\n}"
        : MB_D48
        : "l"(da), "l"(db), "r"(acc));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " MB_R48
        ", %48, %49, p, 1, 1, 0, 0;\n}"
        : MB_D48
        : "l"(da), "l"(db), "r"(acc));
  }
}
// d (+)= A[64 x 8] . B[96 x 8]^T in TF32: A from registers (the m16n8k8
// fragment of this warp's 16 rows: (g, t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4)), B K-major from shared memory; ``acc`` 0 overwrites d
__device__ __forceinline__ void wgmma_96_tf32(uint32_t (&d)[ACC],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %53, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 " MB_R48
      ", {%48, %49, %50, %51}, %52, p, 1, 1;\n}"
      : MB_D48
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
#undef MB_D8
#undef MB_D48
#undef MB_R48

// x[s] of lane (quad position) q becomes lane s's x[q]: a 4x4 transpose of
// 2-word items inside each quad of lanes, in two butterfly stages
__device__ __forceinline__ void quad_transpose(uint32_t (&x)[4][2], int q) {
#pragma unroll
  for (int b = 1; b <= 2; b <<= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i & b) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t send = (q & b) ? x[i][e] : x[i ^ b][e];
        const uint32_t recv = __shfl_xor_sync(0xffffffffu, send, b);
        if (q & b)
          x[i][e] = recv;
        else
          x[i ^ b][e] = recv;
      }
    }
  }
}

// grid: min(tiles, blocks_per_sm SMs) blocks of THREADS; warpgroups
// 0..CONSUMERS-1 consume, the warp after them produces. tmB2: the weight's
// lo half for 3xTF32 (tmB its hi half), unused otherwise.
template <int OP, typename OT>
__global__ void __launch_bounds__(threads<OP>(), blocks_per_sm<OP>())
    gemm_kernel(
    const __grid_constant__ CUtensorMap tmA,
    const __grid_constant__ CUtensorMap tmB,
    const __grid_constant__ CUtensorMap tmB2, const float* __restrict__ sx,
    const float* __restrict__ sw, const float* __restrict__ bias,
    const OT* __restrict__ residual, OT* __restrict__ out, int M, int N,
    int K, int mode) {
  constexpr bool S8 = op_kind(OP) == OP_S8, TF = op_kind(OP) == OP_TF32X3;
  constexpr int STAGES = stages<OP>(), STAGE_BYTES = stage_bytes<OP>();
  extern __shared__ unsigned char smraw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smraw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x >> 7;
  const int nt = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * nt;
  const int esz = elem_bytes<OP>();
  const int nk = (K * esz + BKB - 1) / BKB;
  const int bk = BKB / esz;  // K elements a stage

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the ring full -------------------------
    if constexpr (TF) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == CONSUMERS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / nt) * BM, n0 = (tile % nt) * BN;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          unsigned char* st = sm + stage * STAGE_BYTES;
          tma_load_2d(st, &tmA, &full[stage], kt * bk, m0);
          tma_load_2d(st + A_BYTES, &tmB, &full[stage], kt * bk, n0);
          if (TF)
            tma_load_2d(st + A_BYTES + B_BYTES, &tmB2, &full[stage], kt * bk,
                        n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers ------------------------------------------------------------
  if constexpr (TF) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int quad = lane & 3;
  const int kind = mode & 15;
  const bool round_acc = (mode & 16) != 0;
  uint32_t d[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) d[i] = 0u;
  const int kbytes = K * esz;
  auto epilogue = [&](int m0, int n0) {
    // epilogue from the registers: lane (g, q) of warp w holds rows
    // 16 w + g and + 8, columns 8 j + 2 q and + 1 of every 8-column group j
    const int row = m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int p = 0; p < BN / 32; ++p) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t x[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i][0] = d[4 * (4 * p + i) + 2 * h];
          x[i][1] = d[4 * (4 * p + i) + 2 * h + 1];
        }
        quad_transpose(x, quad);  // x[s] = columns 2 s, 2 s + 1 of group 4p+q
        const int gm = row + 8 * h, gn = n0 + 8 * (4 * p + quad);
        if (gm >= M || gn >= N) continue;
        const size_t o = (size_t)gm * N + gn;
        const float4 b0 = *reinterpret_cast<const float4*>(bias + gn);
        const float4 b1 = *reinterpret_cast<const float4*>(bias + gn + 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        float wv[8];
        float sxm = 0.f;
        if (S8) {
          const float4 w0 = *reinterpret_cast<const float4*>(sw + gn);
          const float4 w1 = *reinterpret_cast<const float4*>(sw + gn + 4);
          wv[0] = w0.x; wv[1] = w0.y; wv[2] = w0.z; wv[3] = w0.w;
          wv[4] = w1.x; wv[5] = w1.y; wv[6] = w1.z; wv[7] = w1.w;
          sxm = sx[gm];
        }
        float rv[8];
        if (kind == 2) ld8(residual + o, rv);
        float fv[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const uint32_t raw = x[c >> 1][c & 1];
          float v;
          if (S8) {
            const float a = (float)(int)raw;
            v = __fadd_rn(__fmul_rn(__fmul_rn(a, sxm), wv[c]), bv[c]);
          } else {
            float a = __uint_as_float(raw);
            if (round_acc) a = rd<OT>(a);
            v = __fadd_rn(a, bv[c]);
          }
          v = rd<OT>(v);
          if (kind == 1) {
            v = gelu_erf(v);
          } else if (kind == 2) {
            v = __fadd_rn(rv[c], v);
          }
          fv[c] = v;
        }
        st8(out + o, fv);
      }
    }

  };

  if constexpr (TF) {
    // 3xTF32: the tensor cores add each product into d with truncation, so
    // d holds one stage's partial sum (32 of K) and each stage's partial is
    // added into sacc with f32 round-to-nearest (error ~ K / 32 f32
    // roundings instead of 3 K / 8 truncations). The steps (tile, stage)
    // form one stream: while a stage's wgmmas run, the next stage's A
    // fragments are read from the swizzled f32 tile (16-byte chunk c of row
    // r at chunk c ^ (r & 7): the 32 lanes hit 32 banks) and split.
    float sacc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) sacc[i] = 0.f;
    const int g = lane >> 2, r0 = warp * 16 + g;
    auto split_a = [&](uint32_t (&ah)[4][4], uint32_t (&al)[4][4], int stg) {
      const float* at = reinterpret_cast<const float*>(
          sm + stg * STAGE_BYTES + wg * 64 * BKB);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int c0 = (((2 * ks) ^ g) << 2) + quad;
        const int c1 = (((2 * ks + 1) ^ g) << 2) + quad;
        split_tf32(at[r0 * 32 + c0], ah[ks][0], al[ks][0]);
        split_tf32(at[(r0 + 8) * 32 + c0], ah[ks][1], al[ks][1]);
        split_tf32(at[r0 * 32 + c1], ah[ks][2], al[ks][2]);
        split_tf32(at[(r0 + 8) * 32 + c1], ah[ks][3], al[ks][3]);
      }
    };
    // keep the A registers live until the wgmmas that read them complete
    auto fence_a = [&](uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          asm volatile("" : "+r"(ah[ks][q]), "+r"(al[ks][q])::"memory");
    };
    const int mine = (int)blockIdx.x < tiles
                         ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                         : 0;
    const int total = mine * nk;
    int stage = 0, kt = 0, tile = blockIdx.x;
    uint32_t phase = 0;
    uint32_t xh[2][4][4], xl[2][4][4];
    if (total > 0) {
      mbar_wait(&full[0], 0);
      split_a(xh[0], xl[0], 0);
    }
    auto body = [&](uint32_t (&ch)[4][4], uint32_t (&cl)[4][4],
                    uint32_t (&nh)[4][4], uint32_t (&nl)[4][4], int s) {
      const unsigned char* st = sm + stage * STAGE_BYTES;
      const uint64_t db = sw128_desc(st + A_BYTES);
      const uint64_t dl = sw128_desc(st + A_BYTES + B_BYTES);
      fence_acc(d);
      fence_a(ch, cl);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (kt * BKB + ks * 32 < kbytes) {
          // the small terms first, then hi.hi; d restarts each stage
          wgmma_96_tf32(d, cl[ks], db + 2 * ks, ks);
          wgmma_96_tf32(d, ch[ks], dl + 2 * ks, 1);
          wgmma_96_tf32(d, ch[ks], db + 2 * ks, 1);
        }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      const int nstage = stage + 1 == STAGES ? 0 : stage + 1;
      const uint32_t nphase = nstage == 0 ? phase ^ 1 : phase;
      if (s + 1 < total) {
        mbar_wait(&full[nstage], nphase);
        split_a(nh, nl, nstage);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(d);
      fence_a(ch, cl);
#pragma unroll
      for (int i = 0; i < ACC; ++i)
        sacc[i] = __fadd_rn(sacc[i], __uint_as_float(d[i]));
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);  // the stage is free again
      stage = nstage;
      phase = nphase;
      if (++kt == nk) {
#pragma unroll
        for (int i = 0; i < ACC; ++i) {
          d[i] = __float_as_uint(sacc[i]);
          sacc[i] = 0.f;
        }
        epilogue((tile / nt) * BM, (tile % nt) * BN);
        kt = 0;
        tile += gridDim.x;
      }
    };
    for (int s = 0; s < total; s += 2) {
      body(xh[0], xl[0], xh[1], xl[1], s);
      if (s + 1 < total) body(xh[1], xl[1], xh[0], xl[0], s + 1);
    }
  } else {
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / nt) * BM, n0 = (tile % nt) * BN;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[stage], phase);
        const unsigned char* st = sm + stage * STAGE_BYTES;
        const uint64_t da = sw128_desc(st + wg * 64 * BKB);
        const uint64_t db = sw128_desc(st + A_BYTES);
        fence_acc(d);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < BKB / 32; ++ks)
          if (kt * BKB + ks * 32 < kbytes)  // the zero-filled K tail: skipped
            wgmma_96<S8>(d, da + 2 * ks, db + 2 * ks, kt | ks);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(d);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);  // the stage is free again
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      epilogue(m0, n0);
    }
  }
}

}  // namespace mbgemm

// the N-tail instances' launch (gemm_ntail.cu): op an operand kind,
// out_f32 nonzero for an f32 output (int8; 3xTF32 always writes f32); the
// arguments as gemm.cu's entry points take them
int gemm_ntail(int op, int out_f32, const void* A, const float* sx,
               const void* Bt, const void* Bt2, const float* sw,
               const float* bias, const void* residual, void* out, int M,
               int N, int K, int lda, int ldb, int mode, cudaStream_t stream);

// ---- host side: TMA tensor maps (gemm.cu, patch_embed.cu) ---------------
// cuTensorMapEncodeTiled is looked up at run time through the CUDA runtime,
// so the library links against the runtime only; a map is encoded on the
// host for every call (a few microseconds).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// a ``rank``-D map of elements of ``esz`` bytes (1: int8, 2: bf16, 4: f32):
// dims innermost first, byte strides of dims 1.., box; 128-byte swizzle
// (the box's inner dimension is 128 bytes), zeros read outside the tensor
static inline int encode_map(CUtensorMap* map, const void* base, int esz,
                             int rank, const cuuint64_t* dims,
                             const cuuint64_t* strides,
                             const cuuint32_t* box) {
  EncodeTiledFn fn = encode_fn();
  if (!fn) return MB_TMAP_FAILED;
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  const CUtensorMapDataType dt =
      esz == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
               : esz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUresult r = fn(map, dt, (cuuint32_t)rank, const_cast<void*>(base), dims,
                  strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MB_TMAP_FAILED + (int)r;
}

static inline int num_sms() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}
