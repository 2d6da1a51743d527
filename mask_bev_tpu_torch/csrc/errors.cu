// Name of a return code of the exported functions (see common.cuh).
#include "common.cuh"

MB_EXPORT const char* mb_error_name(int code) {
  if (code >= MB_TMAP_FAILED)
    return "TMA tensor map encoding failed (code - 300000 is the CUresult)";
  if (code >= MB_ATTR_FAILED)
    return "cudaFuncSetAttribute refused (code - 200000 is the cudaError_t)";
  if (code >= MB_BAD_ARGS) return "arguments rejected by the kernel's checks";
  return cudaGetErrorName((cudaError_t)code);
}
