"""Kernel 2: pillar table -> normalised BEV canvas, in one pass.

Replaces ``mask_bev_tpu/ops/pallas_canvas.py::canvas_from_table`` with its
pseudo-image LayerNorm epilogue (the eval path,
``models/encoder.py:454-458``). Every cell of the (B, H, W, C) canvas is
written: the pillar row whose cell it is, or 0 for an empty cell, then
``((v - mean) * rsqrt(var + eps)) * scale + bias`` in f32, rounded once to
the table's dtype. ``scale``/``bias`` are the full-mode (H, W, C) affine or
the channel-mode (1, 1, C) one. Each cell holds at most one pillar, so the
TPU's 0/1 selection matmul becomes a binary search over the ascending cells.
"""
from __future__ import annotations

from typing import Tuple

import torch

from mask_bev_tpu_torch.kernels import build as kb


def canvas_norm_plain(table: torch.Tensor, cells: torch.Tensor,
                      mean: torch.Tensor, var: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor,
                      grid_hw: Tuple[int, int], eps: float = 1e-3
                      ) -> torch.Tensor:
    """Plain PyTorch version. ``cells`` (B, N) ascending with the ``H*W``
    sentinel on unused rows, whose table rows are never read."""
    b, n, c = table.shape
    h, w = grid_hw
    canvas = torch.zeros((b, h * w + 1, c), dtype=torch.float32,
                         device=table.device)
    canvas.scatter_(1, cells.long()[..., None].expand(b, n, c),
                    table.float())
    canvas = canvas[:, :h * w].reshape(b, h, w, c)
    rstd = torch.rsqrt(var.float() + eps).reshape(b, 1, 1, 1)
    y = ((canvas - mean.float().reshape(b, 1, 1, 1)) * rstd)
    return (y * scale.float() + bias.float()).to(table.dtype)


def canvas_norm(table: torch.Tensor, cells: torch.Tensor,
                num_pillars: torch.Tensor, mean: torch.Tensor,
                var: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                grid_hw: Tuple[int, int], eps: float = 1e-3) -> torch.Tensor:
    """Normalised (B, H, W, C) canvas: the CUDA kernel for CUDA tensors
    (bf16 only), the plain version for CPU tensors."""
    if not table.is_cuda:
        return canvas_norm_plain(table, cells, mean, var, scale, bias,
                                 grid_hw, eps)
    b, n, c = table.shape
    h, w = grid_hw
    if c % 4:
        raise ValueError(f"canvas kernel needs C % 4 == 0, got {c}")
    dt = torch.bfloat16
    if table.dtype != dt:
        raise ValueError(f"the canvas kernel takes a bf16 table, not "
                         f"{table.dtype}; f32 runs only on the CPU")
    kb.check_cuda(table, "table", dt)
    kb.check_cuda(cells, "cells", torch.int32, (b, n))
    kb.check_cuda(num_pillars, "num_pillars", torch.int32, (b,))
    full = scale.numel() == h * w * c
    if not full and scale.numel() != c:
        raise ValueError(f"affine of {scale.numel()} values fits neither "
                         f"(H, W, C) nor (C,)")
    scale = scale.to(dt).contiguous()
    bias = bias.to(dt).contiguous()
    kb.check_cuda(scale, "scale", dt)
    kb.check_cuda(bias, "bias", dt, tuple(scale.shape))
    mv = torch.stack([mean.float(), var.float()], dim=-1).contiguous()
    out = torch.empty((b, h, w, c), dtype=dt, device=table.device)
    kb.launch("canvas_norm", "canvas_norm_forward", kb.ptr(table),
              kb.ptr(cells), kb.ptr(num_pillars), kb.ptr(mv), kb.ptr(scale),
              kb.ptr(bias), kb.ci(full), kb.ptr(out), kb.ci(b), kb.ci(n),
              kb.ci(h * w), kb.ci(c), kb.cf(eps), kb.stream())
    return out
