// Kernel 5's split-query instance: its f32 instances (decoder_split.cuh).
#include "decoder_split.cuh"

int ds2_dispatch_f32(DS2_DISPATCH_ARGS) { DS2_DISPATCH_BODY(float) }
