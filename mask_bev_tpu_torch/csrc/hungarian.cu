// Kernel C: the matcher. Rectangular linear sum assignment of the first
// n_rows[k] rows of each (R, C) cost matrix, R <= C, for N problems at once.
//
// Not a TPU kernel: the JAX package runs mask_bev_tpu/ops/hungarian.py::
// hungarian_rows (a shortest-augmenting-path Jonker-Volgenant solver in
// lax.while_loops) under XLA, where the loop conditions need no host round
// trip. Written as PyTorch ops on the card, every inner condition
// (p[j0] != 0) would be a read back to the host; this kernel keeps the whole
// solve on the device, as the roadmap's rule for matching asks.
//
// It repeats the reference's arithmetic step for step in f32, so the
// assignment is the plain version's exactly: reduced cost (c - u[i0]) - v,
// strict < for the improvement, argmin over the columns not yet in the tree
// with ties to the lowest column, then u += delta on the rows of the tree's
// columns, v -= delta on them, minv -= delta elsewhere. Subtractions and
// additions only, so no contraction into FMAs can change a result.
//
// What bounds it on the H100: latency. Each problem is a chain of at most
// n_rows * (C + 1) dependent steps of a few shared-memory operations and one
// warp reduction; the bytes (the N cost matrices, read about once each) and
// operations are negligible. Design: one warp-sized block per problem (L*B
// = 40 problems at the training envelope, all in flight at once), lanes over
// the columns (column j belongs to lane j % 32), the (u, v, minv, way, used,
// p) state in shared memory, the cost rows read from global memory (L2).
#include "common.cuh"

#define HUNG_INF 1e30f

// a is a better argmin candidate than b (NaN first, like argmin; ties to the
// lower column)
__device__ __forceinline__ bool better(float av, int aj, float bv, int bj) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an != bn) return an;
  if (!an && av != bv) return av < bv;
  return aj < bj;
}

__global__ void __launch_bounds__(32) hungarian_rows_kernel(
    const float* __restrict__ cost, const int* __restrict__ n_rows,
    int* __restrict__ row_of_col, int R, int C) {
  extern __shared__ float smem[];
  const int nc = C + 1;
  float* u = smem;                    // R + 1
  float* v = u + (R + 1);             // C + 1
  float* minv = v + nc;               // C + 1
  int* way = (int*)(minv + nc);       // C + 1
  int* used = way + nc;               // C + 1
  int* p = used + nc;                 // C + 1: row (1-based) of column j
  const int lane = threadIdx.x;
  const float* cp = cost + (size_t)blockIdx.x * R * C;
  for (int i = lane; i <= R; i += 32) u[i] = 0.f;
  for (int j = lane; j < nc; j += 32) { v[j] = 0.f; p[j] = 0; }
  const int n = min(min(n_rows[blockIdx.x], R), C);
  __syncwarp();
  for (int i = 0; i < n; ++i) {
    if (lane == 0) p[0] = i + 1;
    for (int j = lane; j < nc; j += 32) {
      minv[j] = HUNG_INF; used[j] = 0; way[j] = 0;
    }
    __syncwarp();
    int j0 = 0;
    // every step adds a new column to the tree, so C + 1 steps suffice
    for (int step = 0; step <= C && p[j0] != 0; ++step) {
      const int i0 = p[j0];
      const float ui0 = u[i0];
      if ((j0 & 31) == lane) used[j0] = 1;
      float bv = 0.f;
      int bj = -1;
      for (int j = lane; j < nc; j += 32) {
        if (!used[j]) {
          const float c =
              j == 0 ? 0.f : __ldg(cp + (size_t)(i0 - 1) * C + j - 1);
          const float cur = __fsub_rn(__fsub_rn(c, ui0), v[j]);
          if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
        }
        const float m = used[j] ? HUNG_INF : minv[j];
        if (bj < 0 || better(m, j, bv, bj)) { bv = m; bj = j; }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, o);
        if (oj >= 0 && (bj < 0 || better(ov, oj, bv, bj))) {
          bv = ov;
          bj = oj;
        }
      }
      __syncwarp();  // every lane has read u[i0] before any lane writes u
      const float delta = bv;
      for (int j = lane; j < nc; j += 32) {
        if (used[j]) {
          u[p[j]] = __fadd_rn(u[p[j]], delta);
          v[j] = __fsub_rn(v[j], delta);
        } else {
          minv[j] = __fsub_rn(minv[j], delta);
        }
      }
      __syncwarp();
      j0 = bj;
    }
    if (lane == 0) {  // augment along the alternating path
      for (int step = 0; step <= C && j0 != 0; ++step) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncwarp();
  }
  for (int j = lane; j < C; j += 32)
    row_of_col[(size_t)blockIdx.x * C + j] = p[j + 1] - 1;
}

MB_EXPORT int hungarian_rows_forward(const float* cost, const int* n_rows,
                                     int* row_of_col, int N, int R, int C,
                                     cudaStream_t stream) {
  if (N < 1 || R < 1 || C < 1 || R > C) return MB_BAD_ARGS;
  const size_t smem = (size_t)(R + 1) * 4 + (size_t)(C + 1) * 4 * 5;
  if (smem > 48 * 1024) return MB_BAD_ARGS;
  hungarian_rows_kernel<<<N, 32, smem, stream>>>(cost, n_rows, row_of_col,
                                                 R, C);
  return (int)cudaGetLastError();
}
