// Kernel 5's split-query instance: its bf16 instances of
// decoder_split_gen_kernel at head widths 8-64 over heads the warps split
// (decoder_split.cuh; the column-slice ones: decoder_split_bf16_gen_slices.cu).
#include "decoder_split.cuh"

int ds2_dispatch_bf16_gen(DS2_DISPATCH_ARGS) { DS2_DISPATCH_GEN(bf16) }
