#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s ``[small options]`` tolerances.

    python3 scripts/small_options_tolerance.py

Runs ``chip_smoke.py::small_phase`` (the tiny configuration with every
model option, the card against the plain PyTorch path on the CPU) in f32
and bf16, with and without the int8 backbone, at two seeds, and prints
each ``[small options ...]`` line: the class and mask probability
differences and the final height logits' largest difference over their
largest magnitude (checked against ``chip_smoke.HEIGHT_TOL``). Needs one
CUDA card; builds the kernels from this checkout at first use.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kb.build()
    kb.lib()
    failures = []
    small = tiny_test_config().replace(
        **cs.OPTIONS, encoder_encoding_type="fourier",
        head_feat_channels=128, head_out_channels=128, head_num_attn_heads=4)
    seed = cs.SEED
    for quant in ("none", "int8"):
        for dtype in ("float32", "bfloat16"):
            for shift in (0, 7):
                cs.SEED = seed + shift
                cs.small_phase(np, torch, failures,
                               f"small options {dtype} {quant} seed {shift}",
                               small.replace(backbone_quantize=quant,
                                             compute_dtype=dtype))
    cs.SEED = seed
    print(f"outside the tolerances: {failures}", flush=True)


if __name__ == "__main__":
    main()
