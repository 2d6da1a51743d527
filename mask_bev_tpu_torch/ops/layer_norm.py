"""Kernel 9: token LayerNorm over the last axis.

Replaces ``mask_bev_tpu/ops/pallas_layer_norm.py::fused_layer_norm``, the
opt-in kernel of the backbone's ``patch_norm`` and ``out_norm{i}`` on the
fused eval path (``mask_bev_tpu/models/swin.py:516-527``). The function is
flax ``nn.LayerNorm``'s: f32 statistics in the fast-variance form
``var = max(0, E[x^2] - E[x]^2)``, eps 1e-6, ``(x - mean) * (rsqrt(var +
eps) * scale) + bias`` in f32, output in the input dtype.

Output dtype: the TPU kernel returns the input dtype. flax promotes to the
result type of the input and the parameters, which is the input dtype
whenever the parameters are in the model dtype, as they are in both
packages' bf16 and f32 runs; the port returns the input dtype.

The CUDA kernel (``csrc/layer_norm.cu``) takes bf16 or f32 tokens and a
scale and bias of the same dtype (widened to f32 in the kernel), one warp
per token; it counts under ``layer_norm``.
"""
from __future__ import annotations

import torch

from mask_bev_tpu_torch.kernels import build as kb


def layer_norm_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """flax ``nn.LayerNorm``: f32 fast-variance statistics, clamped at 0,
    f32 affine, output in the input dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    mul = torch.rsqrt(var + eps) * w.float()
    return ((x32 - mean) * mul + b.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Token LayerNorm of (..., C): the CUDA kernel for CUDA tensors (its
    bf16 or f32 instance), the plain version for CPU tensors."""
    if not x.is_cuda:
        return layer_norm_plain(x, w, b, eps)
    dt = x.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the layer norm kernel takes bf16 or f32 tokens; "
                         f"got {dt}")
    c = x.shape[-1]
    if c % 8 or c > 2048:
        raise ValueError(f"layer norm kernel needs C % 8 == 0 and C <= 2048, "
                         f"got {c}")
    x2 = x.contiguous().reshape(-1, c)
    kb.check_cuda(x2, "x", dt)
    kb.check_cuda(w, "scale", dt, (c,))
    kb.check_cuda(b, "bias", dt, (c,))
    out = torch.empty_like(x2)
    f32 = dt == torch.float32
    kb.launch("layer_norm", "token_layernorm", kb.ptr(x2), kb.ptr(w),
              kb.ptr(b), kb.ptr(out), kb.ci(x2.shape[0]), kb.ci(c),
              kb.cf(eps), kb.ci(f32), kb.stream(),
              instance="f32" if f32 else "bf16")
    return out.reshape(x.shape)
