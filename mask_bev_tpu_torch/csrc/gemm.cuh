// Tiled tensor-core GEMM with fused epilogues, shared by the Swin block
// (kernel 3) and decoder stack (kernel 4) chains.
//
// out[M, N] (bf16) = epilogue(A[M, K] . Bt[N, K]^T), N a multiple of 8.
// A and Bt are both K-contiguous (Bt is a torch Linear weight), in bf16 (f32 accumulation) or
// int8 (int32 accumulation, then dequantised with a per-row activation
// scale and a per-column weight scale). Tensor cores via WMMA 16x16x16
// fragments (mma.sync), 128x128 block tiles, 8 warps of 64x32, 64-byte K
// slices staged through shared memory with the next slice's global loads
// in flight during the current slice's products; two blocks per SM. The
// epilogue finishes 8 columns per lane with one 16-byte store.
//
// Epilogue modes (low bits) and flags:
//   0 bias            v = acc + bias
//   1 bias + GELU     erf GELU of the bf16-rounded v
//   2 bias + residual out = residual + bf16-rounded v
//   +16 round acc     bf16-round the raw product before the bias (XLA's
//                     order for ``x @ kernel + bias`` in bf16)
// int8: v = acc * sx[row] * sw[col] + bias, as int8_sim_dense computes it.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace mbgemm {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, KBYTES = 64, THREADS = 256;

template <typename TA> struct Traits;
template <> struct Traits<bf16> {
  typedef float Acc;
  typedef bf16 Elt;
};
template <> struct Traits<signed char> {
  typedef int Acc;
  typedef signed char Elt;
};

template <typename TA, bool S8>
__global__ void __launch_bounds__(THREADS, 2) gemm_kernel(
    const TA* __restrict__ A, const float* __restrict__ sx,
    const TA* __restrict__ Bt, const float* __restrict__ sw,
    const float* __restrict__ bias, const bf16* __restrict__ residual,
    bf16* __restrict__ out, int M, int N, int K, int mode) {
  typedef typename Traits<TA>::Acc Acc;
  constexpr int E = 16 / sizeof(TA);        // elements per 16-byte chunk
  constexpr int BK = KBYTES / sizeof(TA);   // elements per K slice
  constexpr int KS = BK / 16;               // 16-deep MMA steps per slice
  // [kstep][row][16]: every fragment pointer is 32-byte aligned
  __shared__ __align__(128) TA As[KS][BM][16];
  __shared__ __align__(128) TA Bs[KS][BN][16];
  __shared__ __align__(128) Acc stage[THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int nk = (K + BK - 1) / BK;

  uint4 ra[2], rb[2];
  auto gload = [&](int kt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tid + h * THREADS;
      const int row = q >> 2, k0 = (q & 3) * E;
      const int gk = kt * BK + k0;
      const int gm = m0 + row, gn = n0 + row;
      ra[h] = (gm < M && gk < K)
                  ? *reinterpret_cast<const uint4*>(A + (size_t)gm * K + gk)
                  : make_uint4(0, 0, 0, 0);
      rb[h] = (gn < N && gk < K)
                  ? *reinterpret_cast<const uint4*>(Bt + (size_t)gn * K + gk)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto sstore = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = tid + h * THREADS;
      const int row = q >> 2, k0 = (q & 3) * E;
      *reinterpret_cast<uint4*>(&As[k0 / 16][row][k0 % 16]) = ra[h];
      *reinterpret_cast<uint4*>(&Bs[k0 / 16][row][k0 % 16]) = rb[h];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], (Acc)0);

  gload(0);
  sstore();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) gload(kt + 1);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, TA, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, TA, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], &As[ks][wm * 64 + i * 16][0], 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[ks][wn * 32 + j * 16][0], 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
    if (kt + 1 < nk) {
      sstore();
      __syncthreads();
    }
  }

  const int kind = mode & 15;
  const bool round_acc = (mode & 16) != 0;
  Acc* st = stage[warp];
  // each lane finishes 8 consecutive columns of one row of a 16x16 tile:
  // one 16-byte store (N % 8 == 0, so a group is all in or all out)
  const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm * 64 + i * 16 + r;
      const int gn = n0 + wn * 32 + j * 16 + c8;
      if (gm < M && gn < N) {
        const size_t o = (size_t)gm * N + gn;
        const float sxm = S8 ? sx[gm] : 0.f;
        uint4 res = make_uint4(0, 0, 0, 0);
        if (kind == 2) res = *reinterpret_cast<const uint4*>(residual + o);
        const bf16* rv = reinterpret_cast<const bf16*>(&res);
        uint4 pk;
        bf16* pv = reinterpret_cast<bf16*>(&pk);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float a = (float)st[r * 16 + c8 + q];
          float v;
          if (S8) {
            v = __fadd_rn(__fmul_rn(__fmul_rn(a, sxm), sw[gn + q]),
                          bias[gn + q]);
          } else {
            if (round_acc) a = rd_bf16(a);
            v = __fadd_rn(a, bias[gn + q]);
          }
          v = rd_bf16(v);
          if (kind == 1) {
            v = gelu_erf(v);
          } else if (kind == 2) {
            v = __fadd_rn(__bfloat162float(rv[q]), v);
          }
          pv[q] = __float2bfloat16_rn(v);
        }
        *reinterpret_cast<uint4*>(out + o) = pk;
      }
      __syncwarp();
    }
  }
}

}  // namespace mbgemm
