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
TPU's 0/1 selection matmul becomes a map from cell to table row: the CUDA
kernel (``csrc/canvas.cu::canvas_norm_kernel``) gives each block a run of
``CANVAS_RUN`` cells of every sample, finds the run's first table row with
one binary search a sample (the TPU kernel's ``lo`` at its block
boundaries), maps the run's cells to rows in shared memory and streams the
run's canvas rows in 16-byte words. Rows of any other width (bf16 C % 8 !=
0, f32 C % 4 != 0) take its narrow instances (``canvas_norm_narrow_kernel``):
the same body in words of the widest power of two bytes that divides the
row's bytes and the addresses (:func:`word_bytes`), counted under
``canvas_norm/<dtype>_w<bytes>``; kernels A and B likewise
(``canvas_scatter/w<bytes>``).

Kernels A and B replace ``mask_bev_tpu/ops/pallas_canvas.py::canvas_scatter``
(the training path, ``models/encoder.py:496-500``), the one Pallas kernel
with a custom VJP. :func:`canvas_scatter` is a ``torch.autograd.Function``:
its forward (kernel A) writes the raw (B, H, W, C) canvas, each cell its
pillar's row or 0; its backward (kernel B) gathers ``d_canvas`` at each
pillar's cell, 0 for unused slots. Both only move values, so they are exact.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from mask_bev_tpu_torch.kernels import build as kb

# csrc/canvas.cu: cells a block of kernel 2 owns in every sample, and the
# most samples its shared-memory cell map (B (CANVAS_RUN + 3) ints in
# 48 KB) takes
CANVAS_RUN = 64
CANVAS_MAX_BATCH = 48 * 1024 // (4 * (CANVAS_RUN + 3))


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


def canvas_chunks(b: int) -> List[Tuple[int, int]]:
    """The (start, stop) sample ranges :func:`canvas_norm` launches kernel
    2 on: as few as take B samples at most ``CANVAS_MAX_BATCH`` each, of
    near-equal size. Each sample's statistics and cells are its own, so a
    sample's canvas does not depend on the chunk it is in."""
    n = -(-b // CANVAS_MAX_BATCH)
    edges = [b * i // n for i in range(n + 1)]
    return list(zip(edges[:-1], edges[1:]))


def word_bytes(row_bytes: int, *ptrs: int) -> int:
    """The bytes a word of kernels 2, A and B moves for rows of
    ``row_bytes`` at these addresses: the widest power of two up to 16 that
    divides all of them (``csrc/canvas.cu::word_bytes``)."""
    v = row_bytes | 16
    for p in ptrs:
        v |= p
    return v & -v


def canvas_refusal(b: int, c: int, dtype) -> Optional[str]:
    """Why kernel 2 does not take a (B, N, C) table of ``dtype``, or None
    where it does: bf16 or f32, any C >= 1 (rows that are not whole 16-byte
    words take the narrow instances) and B >= 1 (any B: :func:`canvas_norm`
    launches it on :func:`canvas_chunks`)."""
    if dtype not in (torch.bfloat16, torch.float32):
        return f"the canvas kernel takes a bf16 or f32 table, not {dtype}"
    if c < 1 or b < 1:
        return f"canvas kernel needs C >= 1 and B >= 1; got C={c}, B={b}"
    return None


def canvas_norm(table: torch.Tensor, cells: torch.Tensor,
                num_pillars: torch.Tensor, mean: torch.Tensor,
                var: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                grid_hw: Tuple[int, int], eps: float = 1e-3) -> torch.Tensor:
    """Normalised (B, H, W, C) canvas: the CUDA kernel for CUDA tensors
    (its bf16 or f32 instance, by the table's dtype; one launch for each of
    :func:`canvas_chunks`), the plain version for CPU tensors."""
    if not table.is_cuda:
        return canvas_norm_plain(table, cells, mean, var, scale, bias,
                                 grid_hw, eps)
    b, n, c = table.shape
    h, w = grid_hw
    dt = table.dtype
    reason = canvas_refusal(b, c, dt)
    if reason:
        raise ValueError(reason)
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
    name = "f32" if dt == torch.float32 else "bf16"
    for i, j in canvas_chunks(b):
        wb = word_bytes(c * table.element_size(), table[i:j].data_ptr(),
                        out[i:j].data_ptr(), scale.data_ptr(),
                        bias.data_ptr())
        kb.launch("canvas_norm", "canvas_norm_forward", kb.ptr(table[i:j]),
                  kb.ptr(cells[i:j]), kb.ptr(num_pillars[i:j]),
                  kb.ptr(mv[i:j]), kb.ptr(scale), kb.ptr(bias), kb.ci(full),
                  kb.ptr(out[i:j]), kb.ci(j - i), kb.ci(n), kb.ci(h * w),
                  kb.ci(c), kb.cf(eps), kb.ci(dt == torch.float32),
                  kb.stream(), instance=name + ("" if wb == 16 else
                                                f"_w{wb}"))
    return out


def pick_rows_per_block(h: int, w: int) -> int:
    """The port's copy of ``mask_bev_tpu/ops/pallas_canvas.py::
    pick_rows_per_block`` (for dense tables, ``slots=0``): the TPU canvas
    kernel's block height (r divides h, r*w a multiple of 8 and at most
    4096, the first with h // r <= 128 if any), 0 if none exists. The
    port's canvas kernel has no such block; the encoder uses it only to
    choose the path the JAX package takes (``models/encoder.py::
    uses_slot_path``)."""
    first = 0
    for r in range(1, h + 1):
        if h % r == 0 and (r * w) % 8 == 0 and r * w <= 4096:
            first = first or r
            if h // r <= 128:
                return r
    return first


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


def _instance(row_bytes: int, *ts: torch.Tensor) -> Optional[str]:
    """Kernels A and B count a narrow launch (rows or addresses not of
    whole 16-byte words) under ``w<bytes>``."""
    wb = word_bytes(row_bytes, *(t.data_ptr() for t in ts))
    return None if wb == 16 else f"w{wb}"


def canvas_scatter_forward(table: torch.Tensor, cells: torch.Tensor,
                           grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Kernel A for CUDA tensors, the plain version for CPU tensors."""
    if not table.is_cuda:
        return canvas_scatter_plain(table, cells, grid_hw)
    b, p, c = table.shape
    h, w = grid_hw
    kb.check_cuda(table, "table")
    kb.check_cuda(cells, "cells", torch.int32, (b, p))
    row_bytes = c * table.element_size()
    out = torch.empty((b, h, w, c), dtype=table.dtype, device=table.device)
    kb.launch("canvas_scatter", "canvas_scatter_forward", kb.ptr(table),
              kb.ptr(cells), kb.ptr(out), kb.ci(b), kb.ci(p), kb.ci(h * w),
              kb.ci(row_bytes), kb.stream(),
              instance=_instance(row_bytes, table, out))
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
    row_bytes = c * d_canvas.element_size()
    d_table = torch.empty((b, p, c), dtype=d_canvas.dtype,
                          device=d_canvas.device)
    kb.launch("canvas_scatter_bwd", "canvas_scatter_backward",
              kb.ptr(d_canvas), kb.ptr(cells), kb.ptr(d_table), kb.ci(b),
              kb.ci(p), kb.ci(h * w), kb.ci(row_bytes), kb.stream(),
              instance=_instance(row_bytes, d_canvas, d_table))
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
