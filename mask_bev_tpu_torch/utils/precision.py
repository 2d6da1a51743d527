"""``compute_dtype`` plumbing and device selection.

``compute_dtype: bfloat16`` casts every float parameter and buffer (the
batch-norm running statistics included) and the input points to bf16, as
``mask_bev_tpu.utils.precision.apply_compute_dtype`` does; batch norms are
folded into affines only after that cast (see ``models/encoder.py``).

Training keeps f32 master parameters and runs the forward on their bf16
cast (``mask_bev_tpu/train/step.py:78-90``): :func:`cast_parameters`
replaces every f32 parameter of a model by its differentiable cast for the
length of a ``with`` block, so gradients reach the masters in f32 and
buffers (the batch-norm running statistics) keep their f32 storage.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

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


@contextlib.contextmanager
def cast_parameters(model: torch.nn.Module, dtype: torch.dtype
                    ) -> Iterator[None]:
    """Within the block, every float32 parameter of ``model`` reads as its
    cast to ``dtype`` (one cast per parameter, made on entry; autograd
    carries gradients back through it). Forward and backward both run
    inside the block, so a block that ``torch.utils.checkpoint`` recomputes
    sees the casts too. The parameters are restored on exit."""
    swapped = []
    if dtype != torch.float32:
        for mod in model.modules():
            for name, p in list(mod._parameters.items()):
                if p is not None and p.dtype == torch.float32:
                    swapped.append((mod, name, p))
                    mod._parameters[name] = p.to(dtype)
    try:
        yield
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


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
