// C entry points of the shared GEMM (see gemm.cuh). The TMA tensor maps are
// encoded on the host for every call (a few microseconds) by
// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so the library links against the runtime only.
#include "gemm.cuh"

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_fn() {
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

// 2D map of a row-major (rows, k) matrix, box (box_rows, 128 bytes of k),
// 128-byte swizzle; reads outside the matrix fill zeros
static int encode(CUtensorMap* map, const void* base, bool s8, int k,
                  int rows, int box_rows) {
  EncodeTiledFn fn = encode_fn();
  if (!fn) return MB_TMAP_FAILED;
  const int esz = s8 ? 1 : 2;
  cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)k * esz};
  cuuint32_t box[2] = {(cuuint32_t)(mbgemm::BKB / esz), (cuuint32_t)box_rows};
  cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(map,
                  s8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  2, const_cast<void*>(base), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MB_TMAP_FAILED + (int)r;
}

static int num_sms() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <bool S8, typename OT>
static int launch_gemm(const void* A, const float* sx, const void* Bt,
                       const float* sw, const float* bias,
                       const OT* residual, OT* out, int M, int N, int K,
                       int mode, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || K % 16 || N % 8 ||
      ((mode & 15) == 2 && residual == nullptr))
    return MB_BAD_ARGS;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        mbgemm::gemm_kernel<S8, OT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        mbgemm::SMEM);
    if (e != cudaSuccess) return MB_ATTR_FAILED + (int)e;
    attr_set = true;
  }
  CUtensorMap ta, tb;
  int rc = encode(&ta, A, S8, K, M, mbgemm::BM);
  if (rc) return rc;
  rc = encode(&tb, Bt, S8, K, N, mbgemm::BN);
  if (rc) return rc;
  const int tiles = ceil_div(M, mbgemm::BM) * ceil_div(N, mbgemm::BN);
  const int grid = tiles < 2 * num_sms() ? tiles : 2 * num_sms();
  mbgemm::gemm_kernel<S8, OT>
      <<<grid, mbgemm::THREADS, mbgemm::SMEM, stream>>>(
      ta, tb, sx, sw, bias, residual, out, M, N, K, mode);
  return (int)cudaGetLastError();
}

MB_EXPORT int gemm_bf16(const bf16* A, const bf16* Bt, const float* bias,
                        const bf16* residual, bf16* out, int M, int N, int K,
                        int mode, cudaStream_t stream) {
  return launch_gemm<false, bf16>(A, nullptr, Bt, nullptr, bias, residual,
                                  out, M, N, K, mode, stream);
}

// out_f32: nonzero for the f32 instance (f32 residual and output)
MB_EXPORT int gemm_s8(const signed char* A, const float* sx,
                      const signed char* Bt, const float* sw,
                      const float* bias, const void* residual, void* out,
                      int M, int N, int K, int mode, int out_f32,
                      cudaStream_t stream) {
  if (out_f32)
    return launch_gemm<true, float>(A, sx, Bt, sw, bias,
                                    (const float*)residual, (float*)out, M,
                                    N, K, mode, stream);
  return launch_gemm<true, bf16>(A, sx, Bt, sw, bias, (const bf16*)residual,
                                 (bf16*)out, M, N, K, mode, stream);
}

MB_EXPORT int gemm_f32(const float* A, const float* Bt, const float* bias,
                       const float* residual, float* out, int M, int N,
                       int K, int mode, cudaStream_t stream) {
  if (M <= 0 || K <= 0 || K % 4 || ((mode & 15) == 2 && residual == nullptr))
    return MB_BAD_ARGS;
  dim3 grid(ceil_div(N, mbgemm::F_BN), ceil_div(M, mbgemm::F_BM));
  mbgemm::gemm_f32_kernel<<<grid, mbgemm::F_THREADS, 0, stream>>>(
      A, Bt, bias, residual, out, M, N, K, mode);
  return (int)cudaGetLastError();
}
