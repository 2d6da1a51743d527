// C entry points of the shared tensor-core GEMM (see gemm.cuh).
#include "gemm.cuh"

static dim3 gemm_grid(int M, int N) {
  return dim3((N + mbgemm::BN - 1) / mbgemm::BN,
              (M + mbgemm::BM - 1) / mbgemm::BM);
}

MB_EXPORT int gemm_bf16(const bf16* A, const bf16* Bt, const float* bias,
                        const bf16* residual, bf16* out, int M, int N, int K,
                        int mode, cudaStream_t stream) {
  if (K % 16 || N % 8 || ((mode & 15) == 2 && residual == nullptr))
    return MB_BAD_ARGS;
  mbgemm::gemm_kernel<bf16, false>
      <<<gemm_grid(M, N), mbgemm::THREADS, 0, stream>>>(
          A, nullptr, Bt, nullptr, bias, residual, out, M, N, K, mode);
  return (int)cudaGetLastError();
}

MB_EXPORT int gemm_s8(const signed char* A, const float* sx,
                      const signed char* Bt, const float* sw,
                      const float* bias, const bf16* residual, bf16* out,
                      int M, int N, int K, int mode, cudaStream_t stream) {
  if (K % 16 || N % 8 || ((mode & 15) == 2 && residual == nullptr))
    return MB_BAD_ARGS;
  mbgemm::gemm_kernel<signed char, true>
      <<<gemm_grid(M, N), mbgemm::THREADS, 0, stream>>>(
          A, sx, Bt, sw, bias, residual, out, M, N, K, mode);
  return (int)cudaGetLastError();
}
