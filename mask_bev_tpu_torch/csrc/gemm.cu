// C entry points of the shared GEMM (see gemm.cuh); the TMA tensor maps
// come from gemm.cuh's encode_map.
#include "gemm.cuh"

// 2D map of a row-major (rows, k) matrix of elements of ``esz`` bytes,
// box (box_rows, 128 bytes of k)
static int encode(CUtensorMap* map, const void* base, int esz, int k,
                  int rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * esz};
  const cuuint32_t box[2] = {(cuuint32_t)(mbgemm::BKB / esz),
                             (cuuint32_t)box_rows};
  return encode_map(map, base, esz, 2, dims, strides, box);
}

// Bt2: the weight's lo half for 3xTF32 (Bt its hi half), else unused
template <int OP, typename OT>
static int launch_gemm(const void* A, const float* sx, const void* Bt,
                       const void* Bt2, const float* sw, const float* bias,
                       const OT* residual, OT* out, int M, int N, int K,
                       int mode, cudaStream_t stream) {
  using namespace mbgemm;
  if (M <= 0 || K <= 0 || K % 16 || N % 8 ||
      ((mode & 15) == 2 && residual == nullptr) ||
      (OP == OP_TF32X3 && Bt2 == nullptr))
    return MB_BAD_ARGS;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<OP, OT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<OP>());
    if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
    attr_set = true;
  }
  const int esz = elem_bytes<OP>();
  CUtensorMap ta, tb, tb2;
  int rc = encode(&ta, A, esz, K, M, BM);
  if (rc) return rc;
  rc = encode(&tb, Bt, esz, K, N, BN);
  if (rc) return rc;
  tb2 = tb;
  if (OP == OP_TF32X3) {
    rc = encode(&tb2, Bt2, esz, K, N, BN);
    if (rc) return rc;
  }
  const int tiles = ceil_div(M, BM) * ceil_div(N, BN);
  const int slots = blocks_per_sm<OP>() * num_sms();
  const int grid = tiles < slots ? tiles : slots;
  gemm_kernel<OP, OT><<<grid, threads<OP>(), smem_bytes<OP>(), stream>>>(
      ta, tb, tb2, sx, sw, bias, residual, out, M, N, K, mode);
  return (int)cudaGetLastError();
}

MB_EXPORT int gemm_bf16(const bf16* A, const bf16* Bt, const float* bias,
                        const bf16* residual, bf16* out, int M, int N, int K,
                        int mode, cudaStream_t stream) {
  return launch_gemm<mbgemm::OP_BF16, bf16>(A, nullptr, Bt, nullptr, nullptr,
                                            bias, residual, out, M, N, K,
                                            mode, stream);
}

// out_f32: nonzero for the f32 instance (f32 residual and output)
MB_EXPORT int gemm_s8(const signed char* A, const float* sx,
                      const signed char* Bt, const float* sw,
                      const float* bias, const void* residual, void* out,
                      int M, int N, int K, int mode, int out_f32,
                      cudaStream_t stream) {
  if (out_f32)
    return launch_gemm<mbgemm::OP_S8, float>(
        A, sx, Bt, nullptr, sw, bias, (const float*)residual, (float*)out, M,
        N, K, mode, stream);
  return launch_gemm<mbgemm::OP_S8, bf16>(A, sx, Bt, nullptr, sw, bias,
                                          (const bf16*)residual, (bf16*)out,
                                          M, N, K, mode, stream);
}

// f32 operands as 3xTF32: Bt_hi, Bt_lo the weight's split (ops/swin_block.py
// ::split_tf32), A plain f32
MB_EXPORT int gemm_f32_3xtf32(const float* A, const float* Bt_hi,
                              const float* Bt_lo, const float* bias,
                              const float* residual, float* out, int M,
                              int N, int K, int mode, cudaStream_t stream) {
  return launch_gemm<mbgemm::OP_TF32X3, float>(A, nullptr, Bt_hi, Bt_lo,
                                               nullptr, bias, residual, out,
                                               M, N, K, mode, stream);
}
