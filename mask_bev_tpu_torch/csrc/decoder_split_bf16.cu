// Kernel 5's split-query instance: its bf16 instances (decoder_split.cuh).
#include "decoder_split.cuh"

int ds2_dispatch_bf16(DS2_DISPATCH_ARGS) { DS2_DISPATCH_BODY(bf16) }
