// Kernel 5's split-query instance: its f32 instances of
// decoder_split_gen_kernel that split a head's output columns over the
// warps (decoder_split.cuh, ds2_column_slices).
#include "decoder_split.cuh"

int ds2_dispatch_f32_gen_slices(DS2_DISPATCH_ARGS) {
  DS2_DISPATCH_GEN_SLICES(float)
}
