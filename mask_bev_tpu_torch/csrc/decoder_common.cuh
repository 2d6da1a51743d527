// What the two decoder-stack kernels share (csrc/decoder_stack.cu, the
// flagship instance; csrc/decoder_split.cu, the split-query instance): the
// level pointers and the product epilogues.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

struct DecPtrs {
  const bf16* K[3];
  const bf16* V[3];
  const float* F[3];
  int T[3];
};

enum { EPI_RAW = 0, EPI_RD = 1, EPI_RELU_RD = 2 };
