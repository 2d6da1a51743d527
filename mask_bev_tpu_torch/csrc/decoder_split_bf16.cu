// Kernel 5's split-query instance: its bf16 instances of
// decoder_split_tc_kernel (decoder_split.cuh; those of
// decoder_split_gen_kernel: decoder_split_bf16_gen.cu,
// decoder_split_bf16_gen_slices.cu).
#include "decoder_split.cuh"

int ds2_dispatch_bf16(DS2_DISPATCH_ARGS) { DS2_DISPATCH_BODY(bf16) }
