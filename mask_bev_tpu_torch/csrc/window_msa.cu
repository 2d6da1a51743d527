// Kernel 7: window multi-head self-attention on the token grid.
//
// Replaces mask_bev_tpu/ops/pallas_window_msa.py::fused_window_msa
// (_msa_kernel). The chain (ops/window_msa.py), on the unpadded (B*H*W, C)
// LN1 output of an unfused Swin block:
//   gemm_*           qkv = y . Wqkv + b (f32 bias, rounded to D; gemm.cuh)
//   window_msa_attn  per (window, head, sample): S = q k^T (f32), scaled
//                    after the product, plus rel[h] + the -100 shift mask
//                    (f32, summed first), f32 softmax, O = P v (f32),
//                    rounded to D (window_attn.cuh, its MSA variant)
//   gemm_*           out = O . Wproj + b (f32 bias, rounded to D)
// The TPU kernel takes windows already padded, rolled and partitioned in
// XLA; here the window partition, the padding and the cyclic shift are the
// attention's index math, so no rolled or padded copy of the grid is made.
// Pad tokens are zero before the qkv product, so their rows are the qkv
// bias, as the reference's zero-padded windows give.
//
// What bounds it on the H100: operations in the products (8 C^2 a token:
// ~1.3 TFLOP per KITTI forward, ~1.3 ms at the bf16 tensor-core peak),
// bytes in the attention (window_attn.cuh). The products are the shared
// tensor-core GEMM (bf16, or f32 as 3xTF32), so a stage-3 block's weights
// (C 1536: 14 MB of Wqkv) never have to fit in shared memory.
#include "common.cuh"
#include "window_attn.cuh"

// the attention (MSA variant): f32 nonzero for f32 qkv and out, else bf16
MB_EXPORT int window_msa_attn(const void* qkv, const float* qkv_bias,
                              const float* rel, void* out, int B, int H,
                              int W, int C, int heads, int win, int shift,
                              float scale, int f32, cudaStream_t stream) {
  return launch_window_attn<true>(qkv, qkv_bias, rel, out, B, H, W, C, heads,
                                  win, shift, scale, f32, stream);
}
