// Kernel 5's split-query instance: its C entry (the kernel and its layout:
// decoder_split.cuh; its instances: decoder_split_f32.cu,
// decoder_split_bf16.cu).
#include "decoder_split.cuh"

// The split-query instance. ptrs: host array of 9 device pointers (k, v per
// level, (B T_l, G C) of the operand type, and the resized f32 features per
// level); T: 3 ints; wd: the weights of the operand type, each matrix
// stored (N, K) (ops/decoder_stack.py::pack_weights(..., fragments=False));
// f32: nonzero for the f32 instance; smem: bytes per block
// (ops/decoder_stack.py::smem_bytes_split); prof: null, or (B cs,
// DS2_PARTS) counters to which each block adds its ns per part, cs =
// ds2_cluster(Q). Heads: 1 (C 64, 128 or 256), 2, 4, 8 or a multiple of 8,
// of a width 8, 16, 32 or 64; Q up to 512.
MB_EXPORT int decoder_split_forward(const float* x0, const float* emb0,
                                    const float* qpos, void* const* ptrs,
                                    const int* T, int nl, int G,
                                    const void* wd, const float* wf,
                                    void* out, unsigned* dbg,
                                    unsigned long long* prof, int B, int Q,
                                    int C, int F, int heads, int smem,
                                    float scale, int f32,
                                    cudaStream_t stream) {
  if (nl < 1 || nl > 3 || heads < 1 || (DS2_WARPS % heads && heads % 8) ||
      C % heads || C % 64 || F % C || Q < 1 ||
      (Q + ds2_cluster(Q) - 1) / ds2_cluster(Q) > DS2_MAXR)
    return MB_BAD_ARGS;
  DecPtrs p;
  int tmax = 0;
  for (int l = 0; l < 3; ++l) {
    p.K[l] = (const bf16*)ptrs[l];  // of the operand type: cast in the kernel
    p.V[l] = (const bf16*)ptrs[3 + l];
    p.F[l] = (const float*)ptrs[6 + l];
    p.T[l] = T[l];
    if (l < nl && T[l] > tmax) tmax = T[l];
  }
  if (ds2_layout(Q, C, heads, tmax, f32 != 0).total * 4 > smem)
    return MB_BAD_ARGS;
  const int words = (tmax + 31) / 32;
  if (f32)
    return ds2_dispatch_f32(x0, emb0, qpos, p, nl, G, wd, wf, out, dbg, prof,
                            B, Q, C, F, heads, words, tmax, smem, scale,
                            stream);
  return ds2_dispatch_bf16(x0, emb0, qpos, p, nl, G, wd, wf, out, dbg, prof,
                           B, Q, C, F, heads, words, tmax, smem, scale,
                           stream);
}
