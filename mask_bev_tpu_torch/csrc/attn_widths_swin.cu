// Kernel 3's window attention (the Swin variant, swin_block.cu) at the head
// widths outside its flagship instances: 8, 24, 40, 48 and 56. Up to 128
// tokens a window they run window_attn_width_kernel (window_attn.cuh: the
// rows at the exact width, the head's compact bias table in shared memory,
// blocks an SM sized to the instance), above it window_attn_long_kernel. A
// source of its own, so that these instances compile in parallel with the
// flagship ones. It replaces the attention of
// mask_bev_tpu/ops/pallas_swin_block.py::fused_swin_block (:208) and
// ::fused_swin_block_col (:584) at head widths whose Pallas gate sends the
// JAX package to XLA; bound by bytes, as the flagship widths.
#include "common.cuh"
#include "window_attn.cuh"

// f32 nonzero for f32 qkv and out, else bf16
MB_EXPORT int swin_window_attn_widths(const void* qkv, const float* qkv_bias,
                   const float* rel, void* out, int B, int H, int W, int C,
                   int heads, int win, int shift, float scale, int f32,
                   cudaStream_t stream) {
  return launch_window_attn<false, 8, 24, 40, 48, 56>(
      qkv, qkv_bias, rel, out, B, H, W, C, heads, win, shift, scale, f32,
      stream);
}
