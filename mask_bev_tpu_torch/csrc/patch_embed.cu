// Kernel 8's instances at the widths of their own instruction (48, 64, 96,
// 128, 192, 256) and its C entry (the kernel: patch_embed.cuh; the padded
// instances of every other width: patch_embed_pad.cu).
#include "patch_embed.cuh"

// canvas (B, H, W, C); wm (EP, p p C) K-major; bias, ln_w, ln_b (EP,) f32;
// out (B, H/p * W/p, E). EP = pe_instance_width(E): for E under EP (1 to
// 256) the rows E .. EP - 1 of wm, bias, ln_w and ln_b are zeros. bf16
// (f32 == 0): canvas, wm, out bf16, wm_lo unused; f32: canvas and out f32,
// wm and wm_lo the weight's TF32 halves hi and lo. p C a multiple of 64
// (bf16) or 32 (f32); (tile_x, tile_y) from ops/patch_embed.py::plan.
MB_EXPORT int patch_embed_forward(const void* canvas, const void* wm,
                                  const void* wm_lo, const float* bias,
                                  const float* ln_w, const float* ln_b,
                                  void* out, int B, int H, int W, int C,
                                  int E, int p, int tile_x, int tile_y,
                                  float eps, int f32, cudaStream_t stream) {
  if (B < 1 || p < 1 || H % p || W % p || H < p || W < p) return MB_BAD_ARGS;
  const int EP = pe_instance_width(E);
  if (EP == 0) return MB_BAD_ARGS;
  if (EP != E)
    return pe_dispatch_pad(f32, EP, E, canvas, wm, wm_lo, bias, ln_w, ln_b,
                           out, B, H, W, C, p, tile_x, tile_y, eps, stream);
  if (f32)
    return pe::dispatch<true, false>(EP, E, canvas, wm, wm_lo, bias, ln_w,
                                     ln_b, out, B, H, W, C, p, tile_x,
                                     tile_y, eps, stream);
  return pe::dispatch<false, false>(EP, E, canvas, wm, wm_lo, bias, ln_w,
                                    ln_b, out, B, H, W, C, p, tile_x, tile_y,
                                    eps, stream);
}
