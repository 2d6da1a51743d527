"""Kernels 1 and 10: the pillar feature net on the sorted point stream.

Replaces ``mask_bev_tpu/ops/pallas_pfn.py::fused_stream_pfn_slots``. Where
the TPU kernel emits one slot per sorted point, this one emits a dense
pillar table: one row per occupied cell, in ascending cell order (row r of
sample b is cell ``ps.cells[b, r]``), plus per-sample ``[sum, sum of
squares]`` of the written values for the pseudo-image norm.

Per pillar: decorate its kept points ``[x, y, z, i, x-mx, y-my, z-mz, x-cx,
y-cy, |xyz|]``, then per layer ``relu((x @ W) * g + b)`` (batch norm folded
into ``g, b``), max over the pillar's kept points, and, for every layer but
the last, the pooled value concatenated back onto each point. The last
layer's max is the pillar's row. When the weights are bf16 the layer inputs
are rounded to bf16 before each product (f32 accumulation), as the TPU
kernel does; the table is written in ``out_dtype`` and the statistics
describe the rounded values that were written.

Rows at and beyond ``ps.num_pillars[b]`` are left unspecified by the kernel
(the canvas never reads them) and are zero in the plain version.

Kernel 10 (:func:`stream_pfn`) replaces
``mask_bev_tpu/ops/pallas_pfn.py::fused_stream_pfn``, the v1 PFN that the
eval path runs when the slot path is off (``models/encoder.py:228-240,
460-471``): the capped stream of ``ops/stream_pillars.py::
pillarize_stream`` (only the first ``max_pillars`` cells keep their
points), the same decoration and layers as kernel 1 with windowed
reductions over contiguous pid runs, and the rows read at the pillar
starts (``gather_at_starts``). Its output is that (B, P, C) pillar table,
zero on unused slots, with the same statistics as kernel 1.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from mask_bev_tpu_torch.kernels import build as kb
from mask_bev_tpu_torch.ops.stream_pillars import (
    PillarStream, StreamPillars, gather_at_starts, windowed_segment_max,
    windowed_segment_sum)

Weights = Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def decorate(ps: PillarStream, *, point_dim: int, with_distance: bool,
             grid_w: int, voxel_size: float, x0: float, y0: float
             ) -> torch.Tensor:
    """(B, N, D_in) f32 decorated points, zero on points that are not kept."""
    x, y, z, inten = ps.cols
    b, n = x.shape
    keptf = ps.kept.float()[..., None]
    seg = ps.seg.clamp(min=0)
    xyz = torch.stack([x, y, z], dim=-1)
    w4 = torch.cat([xyz, torch.ones_like(x)[..., None]], -1) * keptf
    sums = torch.zeros((b, n, 4), dtype=torch.float32, device=x.device)
    sums.scatter_add_(1, seg[..., None].expand(b, n, 4), w4)
    per_pt = torch.gather(sums, 1, seg[..., None].expand(b, n, 4))
    mean = per_pt[..., :3] / torch.clamp(per_pt[..., 3:], min=1.0)
    pid = ps.pid.long()
    ix = (pid % grid_w).float()
    iy = torch.div(pid, grid_w, rounding_mode="floor").float()
    cx = ix * voxel_size + (x0 + 0.5 * voxel_size)
    cy = iy * voxel_size + (y0 + 0.5 * voxel_size)
    parts = [torch.stack([x, y, z, inten], -1)[..., :point_dim],
             xyz - mean, torch.stack([x - cx, y - cy], -1)]
    if with_distance:
        parts.append(torch.sqrt((xyz * xyz).sum(-1, keepdim=True)))
    return torch.cat(parts, dim=-1) * keptf


def pfn_plain(ps: PillarStream, weights: Weights, *, point_dim: int,
              with_distance: bool, grid_w: int, voxel_size: float, x0: float,
              y0: float, out_dtype: torch.dtype
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (table (B, N, C) out_dtype, stats (B, 2) f32)."""
    x = decorate(ps, point_dim=point_dim, with_distance=with_distance,
                 grid_w=grid_w, voxel_size=voxel_size, x0=x0, y0=y0)
    b, n, _ = x.shape
    keptf = ps.kept.float()[..., None]
    seg = ps.seg.clamp(min=0)
    nl = len(weights)
    for li, (w, g, bias) in enumerate(weights):
        xin = x.to(w.dtype).float()
        z = torch.relu((xin @ w.float()) * g.float() + bias.float()) * keptf
        u = z.shape[-1]
        pooled = torch.zeros((b, n, u), dtype=torch.float32, device=x.device)
        pooled.scatter_reduce_(1, seg[..., None].expand(b, n, u), z,
                               reduce="amax", include_self=True)
        if li == nl - 1:
            x = pooled
        else:
            x = torch.cat([z, torch.gather(pooled, 1, seg[..., None].expand(
                b, n, u))], dim=-1)
    occupied = (torch.arange(n, device=x.device)[None]
                < ps.num_pillars[:, None].to(x.device))
    table = torch.where(occupied[..., None], x, 0.0).to(out_dtype)
    return table, table_stats(table)


def table_stats(table: torch.Tensor) -> torch.Tensor:
    """(B, 2) f32 [sum, sum of squares] of a (B, P, C) table's values."""
    t32 = table.float()
    return torch.stack([t32.sum(dim=(1, 2)), (t32 * t32).sum(dim=(1, 2))],
                       dim=-1)


_WARPS = 16  # most pillars in flight per block, one warp each


def pack_weights(weights: Weights, device) -> Tuple[torch.Tensor, List[int]]:
    """All layers' (W, g, b) as one f32 buffer + the int dims the kernel
    reads: [n_layers, in_0, units_0, in_1, units_1, ...]. bf16 weights keep
    their values exactly in f32."""
    parts, dims = [], [len(weights)]
    for (w, g, b) in weights:
        parts += [w.float().reshape(-1), g.float().reshape(-1),
                  b.float().reshape(-1)]
        dims += [w.shape[0], w.shape[1]]
    return torch.cat(parts).to(device).contiguous(), dims


def pfn(ps: PillarStream, weights: Weights, *, point_dim: int,
        with_distance: bool, grid_w: int, voxel_size: float, x0: float,
        y0: float, max_points_per_pillar: int, out_dtype: torch.dtype,
        packed=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pillar table + statistics: the CUDA kernel for CUDA tensors (bf16
    weights and table only), the plain version for CPU tensors.
    ``packed``: cached ``pack_weights``."""
    x = ps.cols[0]
    if not x.is_cuda:
        return pfn_plain(ps, weights, point_dim=point_dim,
                         with_distance=with_distance, grid_w=grid_w,
                         voxel_size=voxel_size, x0=x0, y0=y0,
                         out_dtype=out_dtype)
    b, n = x.shape
    k = max_points_per_pillar
    if k > 32:
        raise ValueError(f"pfn kernel takes at most 32 points per pillar, "
                         f"got {k}")
    if len(weights) > 4 or any(w.shape[1] > 128 for (w, _, _) in weights):
        raise ValueError("pfn kernel takes at most 4 layers of at most 128 "
                         "units")
    if out_dtype != torch.bfloat16 or any(
            w.dtype != torch.bfloat16 for (w, _, _) in weights):
        raise ValueError("the pfn kernel takes bf16 weights and writes a bf16 "
                         "table; f32 runs only on the CPU")
    for t, name in ((ps.starts, "starts"), (ps.counts, "counts"),
                    (ps.cells, "cells")):
        kb.check_cuda(t, name, torch.int32, (b, n))
    for i, c in enumerate(ps.cols):
        kb.check_cuda(c, f"cols[{i}]", torch.float32, (b, n))
    kb.check_cuda(ps.num_pillars, "num_pillars", torch.int32, (b,))
    wpack, dims = packed if packed is not None else pack_weights(
        weights, x.device)
    kb.check_cuda(wpack, "wpack", torch.float32)
    c_out = dims[-1]
    table = torch.empty((b, n, c_out), dtype=out_dtype, device=x.device)
    partials = torch.empty((b, n, 2), dtype=torch.float32, device=x.device)
    stats = torch.empty((b, 2), dtype=torch.float32, device=x.device)
    dims_arr = (kb.ctypes.c_int * len(dims))(*dims)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks_per_sample = max(1, (2 * sms + b - 1) // b)
    kb.launch("pfn", "pfn_forward",
              *(kb.ptr(c) for c in ps.cols), kb.ptr(ps.starts),
              kb.ptr(ps.counts), kb.ptr(ps.cells), kb.ptr(ps.num_pillars),
              kb.ptr(wpack), dims_arr, kb.ptr(table), kb.ptr(partials), kb.ci(b), kb.ci(n), kb.ci(k),
              kb.ci(point_dim), kb.ci(with_distance), kb.ci(grid_w),
              kb.cf(voxel_size), kb.cf(x0 + 0.5 * voxel_size),
              kb.cf(y0 + 0.5 * voxel_size), kb.ci(blocks_per_sample),
              kb.ci(_WARPS), kb.stream())
    kb.launch("pfn", "pfn_stats", kb.ptr(partials), kb.ptr(ps.num_pillars),
              kb.ptr(stats), kb.ci(b), kb.ci(n), kb.stream())
    return table, stats


# --------------------------------------------------------------- kernel 10


def stream_pfn_plain(sp: StreamPillars, weights: Weights, *, k: int,
                     with_distance: bool, grid_w: int, voxel_size: float,
                     x0: float, y0: float, out_dtype: torch.dtype
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 10, the TPU kernel's function step
    by step: (table (B, P, C) out_dtype, stats (B, 2) f32)."""
    pts = sp.pts.float()
    keptf = sp.kept.float()[..., None]
    xyz = pts[..., :3]
    w4 = torch.cat([xyz, torch.ones_like(xyz[..., :1])], -1) * keptf
    sums = windowed_segment_sum(w4, sp.pid, k)
    mean = sums[..., :3] / torch.clamp(sums[..., 3:], min=1.0)
    pid = sp.pid.long()
    ix = (pid % grid_w).float()
    iy = torch.div(pid, grid_w, rounding_mode="floor").float()
    cx = ix * voxel_size + (x0 + 0.5 * voxel_size)
    cy = iy * voxel_size + (y0 + 0.5 * voxel_size)
    parts = [pts, xyz - mean, torch.stack([xyz[..., 0] - cx,
                                           xyz[..., 1] - cy], -1)]
    if with_distance:
        parts.append(torch.sqrt((xyz * xyz).sum(-1, keepdim=True)))
    x = torch.cat(parts, -1) * keptf
    nl = len(weights)
    for li, (w, g, bias) in enumerate(weights):
        z = torch.relu((x.to(w.dtype).float() @ w.float()) * g.float()
                       + bias.float()) * keptf
        pooled = windowed_segment_max(z, sp.pid, k, symmetric=li < nl - 1)
        x = pooled if li == nl - 1 else torch.cat([z, pooled], -1)
    table = gather_at_starts(x, sp.starts, sp.valid).to(out_dtype)
    return table, table_stats(table)


def stream_pfn(sp: StreamPillars, weights: Weights, *, k: int,
               with_distance: bool, grid_w: int, voxel_size: float,
               x0: float, y0: float, out_dtype: torch.dtype,
               num_valid: torch.Tensor, packed=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 10 for CUDA tensors (bf16 points, weights and table only),
    the plain version for CPU tensors. ``num_valid`` (B,) int32: occupied
    slots per sample; ``packed``: cached ``pack_weights``."""
    if not sp.pts.is_cuda:
        return stream_pfn_plain(sp, weights, k=k, with_distance=with_distance,
                                grid_w=grid_w, voxel_size=voxel_size, x0=x0,
                                y0=y0, out_dtype=out_dtype)
    b, n, d = sp.pts.shape
    p = sp.starts.shape[1]
    if k > 32 or d not in (3, 4):
        raise ValueError(f"stream pfn kernel takes at most 32 points per "
                         f"pillar and 3 or 4 point columns, got k={k}, D={d}")
    if len(weights) > 4 or any(w.shape[1] > 128 for (w, _, _) in weights):
        raise ValueError("stream pfn kernel takes at most 4 layers of at "
                         "most 128 units")
    if (sp.pts.dtype != torch.bfloat16 or out_dtype != torch.bfloat16
            or any(w.dtype != torch.bfloat16 for (w, _, _) in weights)):
        raise ValueError("the stream pfn kernel takes bf16 points and "
                         "weights and writes a bf16 table; f32 runs only on "
                         "the CPU")
    pts = sp.pts.contiguous()
    starts = sp.starts.to(torch.int32).contiguous()
    kb.check_cuda(pts, "pts", torch.bfloat16, (b, n, d))
    kb.check_cuda(sp.pid, "pid", torch.int32, (b, n))
    kb.check_cuda(sp.kept, "kept", torch.bool, (b, n))
    kb.check_cuda(starts, "starts", torch.int32, (b, p))
    kb.check_cuda(sp.cells, "cells", torch.int32, (b, p))
    kb.check_cuda(num_valid, "num_valid", torch.int32, (b,))
    wpack, dims = packed if packed is not None else pack_weights(
        weights, pts.device)
    kb.check_cuda(wpack, "wpack", torch.float32)
    c_out = dims[-1]
    table = torch.empty((b, p, c_out), dtype=out_dtype, device=pts.device)
    partials = torch.empty((b, p, 2), dtype=torch.float32, device=pts.device)
    stats = torch.empty((b, 2), dtype=torch.float32, device=pts.device)
    dims_arr = (kb.ctypes.c_int * len(dims))(*dims)
    sms = torch.cuda.get_device_properties(pts.device).multi_processor_count
    blocks_per_sample = max(1, (2 * sms + b - 1) // b)
    kb.launch("stream_pfn", "stream_pfn_forward", kb.ptr(pts), kb.ci(d),
              kb.ptr(sp.pid), kb.ptr(sp.kept), kb.ptr(starts),
              kb.ptr(sp.cells), kb.ptr(num_valid), kb.ptr(wpack), dims_arr,
              kb.ptr(table), kb.ptr(partials), kb.ci(b), kb.ci(n), kb.ci(p),
              kb.ci(k), kb.ci(d), kb.ci(with_distance), kb.ci(grid_w),
              kb.cf(voxel_size), kb.cf(x0 + 0.5 * voxel_size),
              kb.cf(y0 + 0.5 * voxel_size), kb.ci(blocks_per_sample),
              kb.ci(_WARPS), kb.stream())
    kb.launch("stream_pfn", "pfn_stats", kb.ptr(partials), kb.ptr(num_valid),
              kb.ptr(stats), kb.ci(b), kb.ci(p), kb.stream())
    return table, stats
