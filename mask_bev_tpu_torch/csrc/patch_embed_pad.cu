// Kernel 8's padded instances: a width E that has no instruction of its own
// runs on the instance of the next width up (patch_embed.cuh).
#include "patch_embed.cuh"

int pe_dispatch_pad(int f32, int EP, int e, const void* canvas,
                    const void* wm, const void* wm_lo, const float* bias,
                    const float* ln_w, const float* ln_b, void* out, int B,
                    int H, int W, int C, int p, int tx, int ty, float eps,
                    cudaStream_t stream) {
  if (f32)
    return pe::dispatch<true, true>(EP, e, canvas, wm, wm_lo, bias, ln_w,
                                    ln_b, out, B, H, W, C, p, tx, ty, eps,
                                    stream);
  return pe::dispatch<false, true>(EP, e, canvas, wm, wm_lo, bias, ln_w,
                                   ln_b, out, B, H, W, C, p, tx, ty, eps,
                                   stream);
}
