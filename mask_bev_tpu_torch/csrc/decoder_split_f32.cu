// Kernel 5's split-query instance: its f32 instances of
// decoder_split_tc_kernel (decoder_split.cuh; those of
// decoder_split_gen_kernel: decoder_split_f32_gen.cu,
// decoder_split_f32_gen_slices.cu).
#include "decoder_split.cuh"

int ds2_dispatch_f32(DS2_DISPATCH_ARGS) { DS2_DISPATCH_BODY(float) }
