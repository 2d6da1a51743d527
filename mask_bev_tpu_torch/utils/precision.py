"""``compute_dtype`` plumbing and device selection.

``compute_dtype: bfloat16`` casts every float parameter and buffer (the
batch-norm running statistics included) and the input points to bf16, as
``mask_bev_tpu.utils.precision.apply_compute_dtype`` does; batch norms are
folded into affines only after that cast (see ``models/encoder.py``).
"""
from __future__ import annotations

from typing import Dict

import torch

_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def resolve_dtype(compute_dtype: str) -> torch.dtype:
    d = _DTYPES.get(compute_dtype)
    if d is None:
        raise ValueError(f"unknown compute_dtype: {compute_dtype!r}")
    return d


def cast_float_leaves(state: Dict[str, torch.Tensor], dtype: torch.dtype
                      ) -> Dict[str, torch.Tensor]:
    """Cast every float32 tensor of a state dict to ``dtype``."""
    return {k: (v.to(dtype) if v.dtype == torch.float32 else v)
            for k, v in state.items()}


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Asking for CUDA where there is none raises; nothing falls back
    to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
