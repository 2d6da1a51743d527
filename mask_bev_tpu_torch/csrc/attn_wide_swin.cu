// Kernel 3's window attention (the Swin variant, swin_block.cu) at the head
// widths over 64: 72, 80, ..., 128. Up to 128 tokens a window they
// run window_attn_ring_kernel in bf16 (window_attn.cuh: a persistent grid,
// the head's bias expanded in shared memory, q in registers, two blocks an
// SM where shared memory allows) and window_attn_width_kernel in f32 (the
// rows at the exact width, the head's compact bias table in shared memory;
// one block of 8 warps an SM); longer windows take the streaming kernel
// (attn_stream_*.cu). A source of its own, so that these
// instances compile in parallel with the others. It replaces the attention of
// mask_bev_tpu/ops/pallas_swin_block.py::fused_swin_block (:208) and
// ::fused_swin_block_col (:584) at head widths whose Pallas gate sends the
// JAX package to XLA; bound by bytes, as the flagship widths.
#include "common.cuh"
#include "window_attn.cuh"

// f32 nonzero for f32 qkv and out, else bf16
MB_EXPORT int swin_window_attn_wide(const void* qkv, const float* qkv_bias,
                   const float* rel, void* out, int B, int H, int W, int C,
                   int heads, int win, int shift, float scale, int f32,
                   cudaStream_t stream) {
  return launch_window_attn<false, 72, 80, 88, 96, 104, 112, 120, 128>(
      qkv, qkv_bias, rel, out, B, H, W, C, heads, win, shift, scale, f32,
      stream);
}
