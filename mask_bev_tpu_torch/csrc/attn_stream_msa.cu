// Kernel 7's window attention (the MSA variant, window_msa.cu) at windows of
// 257 to 576 tokens (windows 17-24), and of 129 to 256 at head widths over
// 64: window_attn_stream_kernel (window_attn.cuh: a persistent grid pulling
// 128-row query tiles of the windows' real tokens from a counter, the keys
// and values streamed through shared memory in chunks of 64 in a ring of two
// buffers, the rows staged at 16, 32, 64 or 128; in bf16 at 64 and 128 both
// products by wgmma). A source of its own, so that these instances compile
// in parallel with the others. It replaces the attention of
// mask_bev_tpu/ops/pallas_window_msa.py::fused_window_msa (:71) at windows
// whose Pallas gate sends the JAX package to XLA; bound by bytes, as the
// flagship windows.
#include "common.cuh"
#include "window_attn.cuh"

// f32 nonzero for f32 qkv and out, else bf16; next: one int of scratch
// (the item counter, zeroed on the stream before the kernel)
MB_EXPORT int window_msa_attn_stream(const void* qkv, const float* qkv_bias,
                   const float* rel, void* out, int* next, int B, int H,
                   int W, int C, int heads, int win, int shift, float scale,
                   int f32, cudaStream_t stream) {
  return launch_window_attn_streamed<true>(
      qkv, qkv_bias, rel, out, next, B, H, W, C, heads, win, shift, scale,
      f32, stream);
}
