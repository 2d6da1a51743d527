// The shared GEMM's N-tail instances (gemm.cuh): out[M, N] = epilogue(A .
// Bt^T) for N % 8 != 0, every operand kind (bf16, int8, f32 as 3xTF32) and
// the same epilogues, in the same f32 order, as the flagship instances. A
// source of its own, so that it compiles in parallel with gemm.cu; the
// flagship instances (N % 8 == 0) keep their code.
//
// What bounds it on the H100: bytes, at the shapes that reach it (a small
// K: (125000 x 24) . (24 x 100) moves ~31 MB and does 0.6 GFLOP). The first
// version ran the flagship's 128 x 96 tiles, so N 100 computed two tiles
// (192 columns), and its epilogue read the bias and stored the output value
// by value (2-byte stores across rows 200 bytes apart: 4-5x torch.addmm).
// This design:
//   * the tile is fitted to N: ceil(N / 112) tiles across N, each of
//     width w = 8 ceil(N / tiles / 8) (N 100: one tile of 104 columns), run
//     as w / 8 wgmma slices of n 8 (valid for every operand kind, .s8
//     included). A is read into registers once a k-step (ldmatrix from the
//     128-byte swizzled TMA tile; 3xTF32 splits its fragment there), so the
//     slices read only their 8 rows of B from shared memory;
//   * the bias and weight-scale vectors are read into shared memory once a
//     tile;
//   * the epilogue stages the tile's values in shared memory and stores
//     them with 16-byte writes: where one tile spans N, its rows are one
//     contiguous span of rows x N values (whatever N % 8 is), copied as
//     such; where N takes several tiles, each row's segment takes 16-byte
//     writes over its aligned interior and single values at its two ends
//     (the staging row placed at the segment's alignment). The residual
//     comes in the same way, before the values.
// Shapes: any M, K and N (N over 112 in several tiles); the operands at
// their row pitch, as gemm.cu. ops/swin_block.py::gemm_tile_plan mirrors
// the plan.
#include "gemm.cuh"

namespace mbgemm {

// widest tile (N 100: one tile of 104 columns); at 128 the bf16 instance
// spilled 2 KB a thread at the 96 registers two blocks an SM leave. Blocks
// of one consumer warpgroup (64-row tiles, three an SM, no spills) were
// slower on the H100 than gemm.cuh's two.
constexpr int NT_MAXW = 112;
// A-fragment buffers of the bf16 and int8 instances (a k-step each)
constexpr int NT_ABUF = 2;
// the tile width for N: N over ceil(N / maxw) tiles, rounded up to 8
__host__ __device__ inline int nt_width(int N, int maxw) {
  const int tiles = (N + maxw - 1) / maxw;
  return ((N + tiles - 1) / tiles + 7) / 8 * 8;
}
// blocks an SM, as their shared memory allows: a bf16 output's staging
// (128 rows of up to 240 bytes) two; an f32 output's (up to 464 bytes) one,
// as 3xTF32 (its producer a whole warpgroup)
template <int OP, typename OT>
__host__ __device__ constexpr int nt_blocks() {
  return op_kind(OP) == OP_TF32X3 || sizeof(OT) == 4 ? 1 : 2;
}
template <int OP, typename OT>
__host__ __device__ constexpr int nt_stages() {
  return nt_blocks<OP, OT>() == 1 ? 3 : 2;
}
template <int OP>
__host__ __device__ constexpr int nt_stage_bytes() {
  return A_BYTES + b_tiles<OP>() * NT_MAXW * BKB;
}
// bytes of a staging row: the widest tile plus a 16-byte alignment shift
template <typename OT>
__host__ __device__ constexpr int nt_pitch() {
  return NT_MAXW * (int)sizeof(OT) + 16;
}
// the ring, the staging rows, the bias and scale vectors, the barriers
template <int OP, typename OT>
__host__ __device__ constexpr int nt_smem_bytes() {
  return 1024 + nt_stages<OP, OT>() * nt_stage_bytes<OP>() +
         BM * nt_pitch<OT>() + 2 * NT_MAXW * 4 +
         2 * nt_stages<OP, OT>() * 8;
}

// the 256 consumer threads (named barrier 1; the producer never joins it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// d (+)= A[64 x 16] . B[8 x 16]^T, A from registers (bf16: the m16n8k16
// fragment of this warp's 16 rows), B K-major from shared memory
__device__ __forceinline__ void wgmma_n8_bf16(uint32_t (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
// int8: A[64 x 32 bytes] from registers (bytes 4t.., 16 + 4t.. of rows g,
// g + 8), int32 accumulation
__device__ __forceinline__ void wgmma_n8_s8(uint32_t (&d)[4],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
// TF32: A[64 x 8] from registers (the m16n8k8 fragment)
__device__ __forceinline__ void wgmma_n8_tf32(uint32_t (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// wait until at most N committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int G>
__device__ __forceinline__ void fence_slices(uint32_t (&d)[G][4]) {
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[j][e])::"memory");
}

// Copy a tile's rows between the staging rows and device memory (LOAD:
// device -> staging, else staging -> device), by the 256 consumer threads.
// span: the rows are one contiguous span of rows x N values at g (the tile
// spans N), staged as one run; else row r's nv values at g + r N, staged
// at r pitch + (the segment's byte address mod 16), so that the two agree
// in alignment and its 16-byte-aligned interior moves in 16-byte words.
template <bool LOAD, typename OT>
__device__ __forceinline__ void move_rows(unsigned char* stg, OT* g,
                                          int rows, int N, int nv, bool span,
                                          int pitch, int tid) {
  constexpr int E = sizeof(OT), V = 16 / E;
  auto move1 = [](OT* dst_g, unsigned char* s) {
    if (LOAD)
      *reinterpret_cast<OT*>(s) = *dst_g;
    else
      *dst_g = *reinterpret_cast<const OT*>(s);
  };
  auto move16 = [](OT* dst_g, unsigned char* s) {
    if (LOAD)
      *reinterpret_cast<uint4*>(s) = *reinterpret_cast<const uint4*>(dst_g);
    else
      *reinterpret_cast<uint4*>(dst_g) = *reinterpret_cast<const uint4*>(s);
  };
  if (span) {
    // g is 16-byte aligned (m0 N E is a multiple of 128 E)
    const int total = rows * N, words = total / V;
    for (int i = tid; i < words; i += 256) move16(g + i * V, stg + 16 * i);
    for (int i = words * V + tid; i < total; i += 256)
      move1(g + i, stg + (size_t)i * E);
    return;
  }
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < rows; r += 8) {
    OT* gr = g + (size_t)r * N;
    const uintptr_t a = reinterpret_cast<uintptr_t>(gr);
    unsigned char* sr = stg + r * pitch + (a & 15);
    const int head = min(nv, (int)(((16 - (a & 15)) & 15) / E));
    const int words = (nv - head) / V, tail0 = head + words * V;
    for (int i = lane; i < words; i += 32)
      move16(gr + head + i * V, sr + (head + i * V) * E);
    for (int c = lane; c < head; c += 32) move1(gr + c, sr + c * E);
    for (int c = tail0 + lane; c < nv; c += 32) move1(gr + c, sr + c * E);
  }
}

// grid: min(tiles, nt_blocks SMs) blocks; warpgroups 0, 1 consume (64 rows
// of the tile each), the warp (3xTF32: warpgroup) after them produces.
template <int OP, typename OT>
__global__ void __launch_bounds__(threads<OP>(), nt_blocks<OP, OT>())
    gemm_ntail_kernel(const __grid_constant__ CUtensorMap tmA,
                      const __grid_constant__ CUtensorMap tmB,
                      const __grid_constant__ CUtensorMap tmB2,
                      const float* __restrict__ sx,
                      const float* __restrict__ sw,
                      const float* __restrict__ bias,
                      const OT* __restrict__ residual, OT* __restrict__ out,
                      int M, int N, int K, int mode) {
  constexpr bool S8 = op_kind(OP) == OP_S8, TF = op_kind(OP) == OP_TF32X3;
  constexpr int MAXW = NT_MAXW, MAXG = MAXW / 8;
  constexpr int STAGES = nt_stages<OP, OT>();
  constexpr int STAGE_BYTES = nt_stage_bytes<OP>(), BT = MAXW * BKB;
  constexpr int PITCH = nt_pitch<OT>(), E = sizeof(OT);
  extern __shared__ unsigned char smraw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smraw) + 1023) & ~uintptr_t(1023));
  unsigned char* stg = sm + STAGES * STAGE_BYTES;
  float* vb = reinterpret_cast<float*>(stg + BM * PITCH);  // tile's bias
  float* vw = vb + MAXW;                                   // sw (int8)
  uint64_t* full = reinterpret_cast<uint64_t*>(vw + MAXW);
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x >> 7;
  const int w = nt_width(N, MAXW), ng = w / 8;
  const int nt = (N + w - 1) / w;
  const int tiles = ((M + BM - 1) / BM) * nt;
  const int esz = elem_bytes<OP>();
  const int nk = (K * esz + BKB - 1) / BKB;
  const int bk = BKB / esz;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: A (BM rows) and the w rows of B a stage ----------------
    if constexpr (TF) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == CONSUMERS * 128) {
      const uint32_t bytes = A_BYTES + b_tiles<OP>() * w * BKB;
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / nt) * BM, n0 = (tile % nt) * w;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], bytes);
          unsigned char* st = sm + stage * STAGE_BYTES;
          tma_load_2d(st, &tmA, &full[stage], kt * bk, m0);
          tma_load_2d(st + A_BYTES, &tmB, &full[stage], kt * bk, n0);
          if (TF)
            tma_load_2d(st + A_BYTES + BT, &tmB2, &full[stage], kt * bk, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers -----------------------------------------------------------
  if constexpr (TF) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3;
  const int g = lane >> 2, quad = lane & 3;
  const int kind = mode & 15;
  const bool round_acc = (mode & 16) != 0;
  const int kbytes = K * esz;
  // this lane's rows of the 128-row tile: wg 64 + warp 16 + g (+ 8)
  const int rl = wg * 64 + warp * 16 + g;
  uint32_t d[MAXG][4];
#pragma unroll
  for (int j = 0; j < MAXG; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0u;
  float sacc[TF ? MAXG : 1][4];
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / nt) * BM, n0 = (tile % nt) * w;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = sm + stage * STAGE_BYTES;
      const unsigned char* at = st + wg * 64 * BKB;  // this warpgroup's rows
      const uint64_t db = sw128_desc(st + A_BYTES);
      if constexpr (TF) {
        // A's fragments split into TF32 halves (gemm.cuh's split_a), then
        // lo.hi + hi.lo + hi.hi into d, whose stage partial is added into
        // sacc with rounding to nearest, as the flagship does
        const uint64_t dl = sw128_desc(st + A_BYTES + BT);
        const float* af = reinterpret_cast<const float*>(at);
        const int r0 = warp * 16 + g;
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int c0 = (((2 * ks) ^ g) << 2) + quad;
          const int c1 = (((2 * ks + 1) ^ g) << 2) + quad;
          split_tf32(af[r0 * 32 + c0], ah[ks][0], al[ks][0]);
          split_tf32(af[(r0 + 8) * 32 + c0], ah[ks][1], al[ks][1]);
          split_tf32(af[r0 * 32 + c1], ah[ks][2], al[ks][2]);
          split_tf32(af[(r0 + 8) * 32 + c1], ah[ks][3], al[ks][3]);
        }
        fence_slices(d);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          if (kt * BKB + ks * 32 < kbytes) {
#pragma unroll
            for (int j = 0; j < MAXG; ++j)
              if (j < ng) {
                wgmma_n8_tf32(d[j], al[ks], db + 64 * j + 2 * ks, ks);
                wgmma_n8_tf32(d[j], ah[ks], dl + 64 * j + 2 * ks, 1);
                wgmma_n8_tf32(d[j], ah[ks], db + 64 * j + 2 * ks, 1);
              }
          }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_slices(d);
#pragma unroll
        for (int j = 0; j < MAXG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sacc[j][e] =
                __fadd_rn(kt ? sacc[j][e] : 0.f, __uint_as_float(d[j][e]));
      } else {
        // A's fragments by ldmatrix: rows lane & 15 of this warp, 16-byte
        // chunk 2 ks + lane / 16 at its swizzled place (chunk ^ row % 8);
        // NT_ABUF fragment buffers in turn, a k-step's group of slices
        // committed alone, so that a buffer is loaded again only after the
        // group that read it completes
        uint32_t af[NT_ABUF][4];
        const int r = warp * 16 + (lane & 15);
        fence_slices(d);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          if (kt * BKB + ks * 32 < kbytes) {
            uint32_t (&a)[4] = af[ks % NT_ABUF];
            if (ks >= NT_ABUF) wgmma_wait<NT_ABUF - 1>();
            ldsm_x4(a, at + r * BKB +
                           ((((2 * ks + (lane >> 4)) ^ (r & 7))) << 4));
            asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
            for (int j = 0; j < MAXG; ++j)
              if (j < ng) {
                if constexpr (S8)
                  wgmma_n8_s8(d[j], a, db + 64 * j + 2 * ks, kt | ks);
                else
                  wgmma_n8_bf16(d[j], a, db + 64 * j + 2 * ks, kt | ks);
              }
            asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          }
        wgmma_wait<0>();
        fence_slices(d);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);  // the stage is free again
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // ---- epilogue: values staged in shared memory, 16-byte stores -------
    const int nv = min(w, N - n0), rows = min(BM, M - m0);
    const bool span = nt == 1;
    OT* go = out + (size_t)m0 * N + n0;
    // the staging byte offset of the tile's row r (span: rows back to back)
    auto srow = [&](int r) -> int {
      return span ? r * N * E
                  : r * PITCH +
                        (int)(reinterpret_cast<uintptr_t>(go + (size_t)r * N) &
                              15);
    };
    consumers_sync();  // the previous tile's stores have read the staging
    for (int i = tid; i < nv; i += 256) {
      vb[i] = bias[n0 + i];
      if (S8) vw[i] = sw[n0 + i];
    }
    if (kind == 2)
      move_rows<true>(stg, const_cast<OT*>(residual) + (size_t)m0 * N + n0,
                      rows, N, nv, span, PITCH, tid);
    consumers_sync();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h;
      if (r >= rows) continue;
      const float sxm = S8 ? sx[m0 + r] : 0.f;
      unsigned char* sr = stg + srow(r);
#pragma unroll
      for (int j = 0; j < MAXG; ++j) {
        if (j >= ng) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * quad + e;
          if (c >= nv) continue;
          float v;
          if constexpr (S8) {
            const float a = (float)(int)d[j][2 * h + e];
            v = __fadd_rn(__fmul_rn(__fmul_rn(a, sxm), vw[c]), vb[c]);
          } else {
            float a;
            if constexpr (TF)
              a = sacc[j][2 * h + e];
            else
              a = __uint_as_float(d[j][2 * h + e]);
            if (round_acc) a = rd<OT>(a);
            v = __fadd_rn(a, vb[c]);
          }
          v = rd<OT>(v);
          OT* p = reinterpret_cast<OT*>(sr + c * E);
          if (kind == 1)
            v = gelu_erf(v);
          else if (kind == 2)
            v = __fadd_rn(to_f(*p), v);
          *p = from_f<OT>(v);
        }
      }
    }
    consumers_sync();
    move_rows<false>(stg, go, rows, N, nv, span, PITCH, tid);
  }
}

template <int OP, typename OT>
static int launch_ntail(const void* A, const float* sx, const void* Bt,
                        const void* Bt2, const float* sw, const float* bias,
                        const OT* residual, OT* out, int M, int N, int K,
                        int lda, int ldb, int mode, cudaStream_t stream) {
  const int esz = elem_bytes<OP>();
  if (M <= 0 || K <= 0 || N <= 0 || lda < K || ldb < K ||
      (lda * esz) % 16 || (ldb * esz) % 16 ||
      ((mode & 15) == 2 && residual == nullptr) ||
      (op_kind(OP) == OP_TF32X3 && Bt2 == nullptr) ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(residual) % 16)
    return MB_BAD_ARGS;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_ntail_kernel<OP, OT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        nt_smem_bytes<OP, OT>());
    if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
    attr_set = true;
  }
  const int w = nt_width(N, NT_MAXW);
  const cuuint32_t box_a[2] = {(cuuint32_t)(BKB / esz), (cuuint32_t)BM};
  const cuuint32_t box_b[2] = {(cuuint32_t)(BKB / esz), (cuuint32_t)w};
  CUtensorMap ta, tb, tb2;
  const cuuint64_t da[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t sa[1] = {(cuuint64_t)lda * esz};
  int rc = encode_map(&ta, A, esz, 2, da, sa, box_a);
  if (rc) return rc;
  const cuuint64_t dbm[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t sb[1] = {(cuuint64_t)ldb * esz};
  rc = encode_map(&tb, Bt, esz, 2, dbm, sb, box_b);
  if (rc) return rc;
  tb2 = tb;
  if (op_kind(OP) == OP_TF32X3) {
    rc = encode_map(&tb2, Bt2, esz, 2, dbm, sb, box_b);
    if (rc) return rc;
  }
  const int tiles = ceil_div(M, BM) * ceil_div(N, w);
  const int slots = nt_blocks<OP, OT>() * num_sms();
  const int grid = tiles < slots ? tiles : slots;
  gemm_ntail_kernel<OP, OT>
      <<<grid, threads<OP>(), nt_smem_bytes<OP, OT>(), stream>>>(
          ta, tb, tb2, sx, sw, bias, residual, out, M, N, K, mode);
  return (int)cudaGetLastError();
}

}  // namespace mbgemm

int gemm_ntail(int op, int out_f32, const void* A, const float* sx,
               const void* Bt, const void* Bt2, const float* sw,
               const float* bias, const void* residual, void* out, int M,
               int N, int K, int lda, int ldb, int mode,
               cudaStream_t stream) {
  using namespace mbgemm;
  if (op == OP_BF16)
    return launch_ntail<OP_BF16, bf16>(A, sx, Bt, Bt2, sw, bias,
                                       (const bf16*)residual, (bf16*)out, M,
                                       N, K, lda, ldb, mode, stream);
  if (op == OP_S8 && out_f32)
    return launch_ntail<OP_S8, float>(A, sx, Bt, Bt2, sw, bias,
                                      (const float*)residual, (float*)out, M,
                                      N, K, lda, ldb, mode, stream);
  if (op == OP_S8)
    return launch_ntail<OP_S8, bf16>(A, sx, Bt, Bt2, sw, bias,
                                     (const bf16*)residual, (bf16*)out, M, N,
                                     K, lda, ldb, mode, stream);
  if (op == OP_TF32X3)
    return launch_ntail<OP_TF32X3, float>(A, sx, Bt, Bt2, sw, bias,
                                          (const float*)residual, (float*)out,
                                          M, N, K, lda, ldb, mode, stream);
  return MB_BAD_ARGS;
}
