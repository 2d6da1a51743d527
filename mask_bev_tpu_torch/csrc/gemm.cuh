// Persistent warp-specialised GEMM with fused epilogues for Hopper, shared
// by the Swin block chain (kernels 3/4), the decoder stack's k/v
// projections (kernel 5) and window MSA (kernel 7).
//
// out[M, N] (bf16, or f32 for int8 operands) = epilogue(A[M, K] .
// Bt[N, K]^T), N a multiple of 8, K a multiple of 16. A and Bt are both K-contiguous (Bt is a torch Linear
// weight), as wgmma requires for 8-bit operands: bf16 (f32 accumulation,
// wgmma m64n96k16) or int8 (int32 accumulation, wgmma m64n96k32, then
// dequantised with a per-row activation scale and a per-column weight
// scale).
//
// What bounds it on the H100: bytes at the Swin backbone's stage 0 (M =
// 125,000 tokens of C = 192: the four products of a block move ~26 C bytes
// a token and do 24 C^2 operations, well under the int8 ridge), operations
// at stages 2-3; and, in practice, the epilogue's instructions: each output
// takes ~15 f32 operations, ~35 with the exact erf GELU, so the fc1
// products are bound by instruction issue. The first version staged 64-byte
// K slices through registers with WMMA 16x16x16 fragments and a per-warp
// shared-memory epilogue, and never reached a steady pipeline at K = 192.
// This design:
//   * a persistent grid of two blocks per SM walks 128 x 96 output tiles
//     in row-major tile order, so the blocks in flight share A rows in L2;
//     two blocks of 8 consumer warps each give the epilogue 16 warps an SM;
//   * one producer warp keeps a ring of STAGES tiles in flight with TMA
//     (128-byte swizzle, mbarrier completion), across tile boundaries, so
//     one tile's epilogue overlaps the next tile's loads;
//   * two consumer warpgroups each take 64 rows of the tile and run wgmma
//     from shared memory (both operands K-major), releasing each stage as
//     soon as its products complete; k-steps wholly in the zero-filled K
//     tail are skipped;
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
// The output type OT (bf16 or f32) is the model's: the f32 instance of the
// int8 products rounds nothing (residual, GELU and output in f32).
//
// gemm_f32_kernel (below) is the f32 instance for f32 operands: the same
// epilogue modes on products taken as f32 FMAs (no operand is rounded, as
// XLA computes an f32 dense layer on the CPU), a plain tiled kernel on the
// CUDA cores (128 x 64 tiles, 8 x 4 outputs a thread).
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace mbgemm {

constexpr int BM = 128, BN = 96;
constexpr int BKB = 128;  // bytes of K per stage: one 128-byte swizzle row
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;  // warpgroups of 64 rows each
constexpr int THREADS = 128 * CONSUMERS + 32;  // + one producer warp
constexpr int A_BYTES = BM * BKB, B_BYTES = BN * BKB;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int ACC = BN / 2;  // accumulator registers a thread (m64n96)
// dynamic shared memory: the ring, 1024-byte alignment slack, barriers
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

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

// grid: min(tiles, 2 SMs) blocks of THREADS, two a SM; warpgroups
// 0..CONSUMERS-1 consume, the warp after them produces
template <bool S8, typename OT>
__global__ void __launch_bounds__(THREADS, 2) gemm_kernel(
    const __grid_constant__ CUtensorMap tmA,
    const __grid_constant__ CUtensorMap tmB, const float* __restrict__ sx,
    const float* __restrict__ sw, const float* __restrict__ bias,
    const OT* __restrict__ residual, OT* __restrict__ out, int M, int N,
    int K, int mode) {
  extern __shared__ unsigned char smraw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smraw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x >> 7;
  const int nt = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * nt;
  const int esz = S8 ? 1 : 2;
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
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int quad = lane & 3;
  const int kind = mode & 15;
  const bool round_acc = (mode & 16) != 0;
  uint32_t d[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) d[i] = 0u;
  int stage = 0;
  uint32_t phase = 0;
  const int kbytes = K * esz;
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
        if (kt * BKB + ks * 32 < kbytes)  // the zero-filled K tail is skipped
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
  }
}

// ---- the f32 instance ----------------------------------------------------
constexpr int F_BM = 128, F_BN = 64, F_BK = 16, F_THREADS = 256;

// out = epilogue(A . Bt^T) in f32; A (M, K), Bt (N, K) row-major f32,
// K % 4 == 0; grid (ceil(N / 64), ceil(M / 128)). Thread (tx, ty) =
// (tid % 16, tid / 16) owns rows 8 ty.. and columns 4 tx.. of the tile;
// the k-slices are staged transposed in shared memory.
__global__ void __launch_bounds__(F_THREADS) gemm_f32_kernel(
    const float* __restrict__ A, const float* __restrict__ Bt,
    const float* __restrict__ bias, const float* __restrict__ residual,
    float* __restrict__ out, int M, int N, int K, int mode) {
  __shared__ __align__(16) float As[F_BK][F_BM + 4];
  __shared__ __align__(16) float Bs[F_BK][F_BN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += F_BK) {
    // A: 128 rows x 16 k = 512 float4, two a thread; Bt: 64 x 16, one
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tid + h * F_THREADS;
      const int r = q >> 2, kk = (q & 3) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M && k0 + kk < K)
        v = *reinterpret_cast<const float4*>(A + (size_t)(m0 + r) * K + k0 +
                                             kk);
      As[kk][r] = v.x; As[kk + 1][r] = v.y;
      As[kk + 2][r] = v.z; As[kk + 3][r] = v.w;
    }
    {
      const int r = tid >> 2, kk = (tid & 3) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n0 + r < N && k0 + kk < K)
        v = *reinterpret_cast<const float4*>(Bt + (size_t)(n0 + r) * K + k0 +
                                             kk);
      Bs[kk][r] = v.x; Bs[kk + 1][r] = v.y;
      Bs[kk + 2][r] = v.z; Bs[kk + 3][r] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][8 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][8 * ty + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  const int kind = mode & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + 8 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n >= N) continue;
      float v = __fadd_rn(acc[i][j], bias[n]);
      if (kind == 1)
        v = gelu_erf(v);
      else if (kind == 2)
        v = __fadd_rn(residual[(size_t)m * N + n], v);
      out[(size_t)m * N + n] = v;
    }
  }
}

}  // namespace mbgemm
