// Kernel 5's split-query instance: its C entry (the kernels and their
// layouts: decoder_split.cuh; their instances: decoder_split_{f32,bf16}.cu,
// decoder_split_{f32,bf16}_gen.cu and decoder_split_{f32,bf16}_gen_slices.cu).
#include "decoder_split.cuh"

// The split-query instance. ptrs: host array of 9 device pointers (k, v per
// level, (B T_l, G C) of the operand type, and the resized f32 features per
// level, (B T_l, C), or (B T_l, De) where emb is given); T: 3 ints; wd:
// the weights of the operand type, each matrix stored (N, K)
// (ops/decoder_stack.py::pack_weights(..., fragments=False)); f32: nonzero
// for the f32 instance; smem: bytes per block
// (ops/decoder_stack.py::smem_bytes_split); prof: null, or (B cs,
// DS2_PARTS) counters to which each block adds its ns per part, cs =
// ds2_cluster(Q). decoder_split_tc_kernel runs the shapes
// ds2_shared_takes, decoder_split_gen_kernel the rest. ws: null, or where
// the GEN layout keeps its rows in device memory (ds2_layout_gen(...).glob)
// (B cs, 5 R (C + 16)) f32 of workspace.
// emb: null (the embedding has C columns: emb0 (B, Q, C)), or the (B, Q, De)
// f32 embedding of De > C columns (De % 32 == 0), holding emb0 (the kernel
// overwrites it). Heads: 1 (C 64, 128, 256 or 512), or head widths 128 and
// 256 over any heads, or 2, 4, 8 or a multiple of 8 heads of a width 8, 16,
// 32 or 64; Q up to 1024. ht, nh: the true head width and heads of a padded
// model (ops/decoder_stack.py::split_padding; C / heads and heads where
// nothing is padded).
MB_EXPORT int decoder_split_forward(const float* x0, const float* emb0,
                                    const float* qpos, void* const* ptrs,
                                    const int* T, int nl, int G,
                                    const void* wd, const float* wf,
                                    void* out, unsigned* dbg,
                                    unsigned long long* prof, float* ws,
                                    float* emb, int De, int B, int Q, int C,
                                    int F, int heads, int smem, float scale,
                                    int ht, int nh, int f32,
                                    cudaStream_t stream) {
  if (nl < 1 || nl > 3 || heads < 1 || C % heads || C % 64 || F % C ||
      Q < 1 || ht < 1 || ht > C / heads || nh < 1 || nh > heads ||
      (!ds2_column_slices(heads, C / heads) && DS2_WARPS % heads &&
       heads % 8) ||
      (Q + ds2_cluster(Q) - 1) / ds2_cluster(Q) > DS2_MAXR ||
      (emb ? De <= C || De % 32 : De != C))
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
  const int words = (tmax + 31) / 32;
  const Ds2Layout L0 = ds2_layout(Q, C, heads, tmax, f32 != 0);
  auto go = f32 ? ds2_dispatch_f32 : ds2_dispatch_bf16;
  if (ds2_shared_takes(L0, emb != nullptr)) {
    if (L0.total * 4 > smem) return MB_BAD_ARGS;
  } else {
    const Ds2LayoutG L = ds2_layout_gen(Q, C, heads, tmax, f32 != 0);
    if (L.total * 4 > smem || (L.glob && !ws)) return MB_BAD_ARGS;
    go = ds2_column_slices(heads, C / heads)
             ? (f32 ? ds2_dispatch_f32_gen_slices
                    : ds2_dispatch_bf16_gen_slices)
             : (f32 ? ds2_dispatch_f32_gen : ds2_dispatch_bf16_gen);
  }
  return go(x0, emb0, qpos, p, nl, G, wd, wf, out, dbg, prof, ws, emb, De, B,
            Q, C, F, heads, words, tmax, smem, scale, ht, nh, stream);
}
