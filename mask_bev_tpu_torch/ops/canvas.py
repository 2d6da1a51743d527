"""Pillar table -> BEV canvas: kernel 2 (eval, with the norm) and kernels
A and B (training scatter and its gradient).

Kernel 2: pillar table -> normalised BEV canvas, in one pass.

Replaces ``mask_bev_tpu/ops/pallas_canvas.py::canvas_from_table`` with its
pseudo-image LayerNorm epilogue (the eval path,
``models/encoder.py:454-458``). Every cell of the (B, H, W, C) canvas is
written: the pillar row whose cell it is, or 0 for an empty cell, then
``((v - mean) * rsqrt(var + eps)) * scale + bias`` in f32, rounded once to
the table's dtype. ``scale``/``bias`` are the full-mode (H, W, C) affine or
the channel-mode (1, 1, C) one. Each cell holds at most one pillar, so the
TPU's 0/1 selection matmul becomes a binary search over the ascending cells.

Kernels A and B replace ``mask_bev_tpu/ops/pallas_canvas.py::canvas_scatter``
(the training path, ``models/encoder.py:496-500``), the one Pallas kernel
with a custom VJP. :func:`canvas_scatter` is a ``torch.autograd.Function``:
its forward (kernel A) writes the raw (B, H, W, C) canvas, each cell its
pillar's row or 0; its backward (kernel B) gathers ``d_canvas`` at each
pillar's cell, 0 for unused slots. Both only move values, so they are exact.
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


# ------------------------------------------------- kernels A and B (training)


def canvas_scatter_plain(table: torch.Tensor, cells: torch.Tensor,
                         grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain version of kernel A: (B, P, C) table + (B, P) cells (``H*W``
    on unused slots) -> (B, H, W, C) canvas in the table's dtype."""
    b, p, c = table.shape
    h, w = grid_hw
    canvas = torch.zeros((b, h * w + 1, c), dtype=table.dtype,
                         device=table.device)
    canvas.scatter_(1, cells.long()[..., None].expand(b, p, c), table)
    return canvas[:, :h * w].reshape(b, h, w, c)


def canvas_gather_plain(d_canvas: torch.Tensor, cells: torch.Tensor,
                        grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Plain version of kernel B: (B, H, W, C) gradient -> (B, P, C) rows
    at ``cells``, 0 on unused slots."""
    h, w = grid_hw
    b, p = cells.shape
    c = d_canvas.shape[-1]
    gf = d_canvas.reshape(b, h * w, c)
    idx = cells.long().clamp(max=h * w - 1)[..., None].expand(b, p, c)
    return torch.where((cells < h * w)[..., None], torch.gather(gf, 1, idx),
                       0.0)


def _check_rows(t: torch.Tensor, name: str) -> int:
    row_bytes = t.shape[-1] * t.element_size()
    if row_bytes % 16 or t.data_ptr() % 16:
        raise ValueError(f"{name}: the canvas scatter kernels move 16-byte "
                         f"words; rows of {row_bytes} bytes at address "
                         f"{t.data_ptr():#x} are not")
    return row_bytes


def canvas_scatter_forward(table: torch.Tensor, cells: torch.Tensor,
                           grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Kernel A for CUDA tensors, the plain version for CPU tensors."""
    if not table.is_cuda:
        return canvas_scatter_plain(table, cells, grid_hw)
    b, p, c = table.shape
    h, w = grid_hw
    kb.check_cuda(table, "table")
    kb.check_cuda(cells, "cells", torch.int32, (b, p))
    row_bytes = _check_rows(table, "table")
    out = torch.empty((b, h, w, c), dtype=table.dtype, device=table.device)
    kb.launch("canvas_scatter", "canvas_scatter_forward", kb.ptr(table),
              kb.ptr(cells), kb.ptr(out), kb.ci(b), kb.ci(p), kb.ci(h * w),
              kb.ci(row_bytes), kb.stream())
    return out


def canvas_scatter_backward(d_canvas: torch.Tensor, cells: torch.Tensor,
                            grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Kernel B for CUDA tensors, the plain version for CPU tensors."""
    if not d_canvas.is_cuda:
        return canvas_gather_plain(d_canvas, cells, grid_hw)
    d_canvas = d_canvas.contiguous()
    b, p = cells.shape
    h, w = grid_hw
    c = d_canvas.shape[-1]
    kb.check_cuda(d_canvas, "d_canvas", shape=(b, h, w, c))
    kb.check_cuda(cells, "cells", torch.int32, (b, p))
    row_bytes = _check_rows(d_canvas, "d_canvas")
    d_table = torch.empty((b, p, c), dtype=d_canvas.dtype,
                          device=d_canvas.device)
    kb.launch("canvas_scatter_bwd", "canvas_scatter_backward",
              kb.ptr(d_canvas), kb.ptr(cells), kb.ptr(d_table), kb.ci(b),
              kb.ci(p), kb.ci(h * w), kb.ci(row_bytes), kb.stream())
    return d_table


class _CanvasScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, cells, grid_hw):
        ctx.save_for_backward(cells)
        ctx.grid_hw = grid_hw
        return canvas_scatter_forward(table, cells, grid_hw)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_canvas):
        (cells,) = ctx.saved_tensors
        return canvas_scatter_backward(d_canvas, cells, ctx.grid_hw), None, \
            None


def canvas_scatter(table: torch.Tensor, cells: torch.Tensor,
                   grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Differentiable (B, P, C) table -> (B, H, W, C) canvas scatter.
    ``cells`` (B, P) int32, ascending per sample, ``H*W`` on unused slots."""
    return _CanvasScatter.apply(table, cells, tuple(grid_hw))
