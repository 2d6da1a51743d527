// Kernel 5's split-query instance: its f32 instances of
// decoder_split_gen_kernel at head widths 8-64 over heads the warps split
// (decoder_split.cuh; the column-slice ones: decoder_split_f32_gen_slices.cu).
#include "decoder_split.cuh"

int ds2_dispatch_f32_gen(DS2_DISPATCH_ARGS) { DS2_DISPATCH_GEN(float) }
