"""Eval-form pillarization: pid fusion, one stable sort, the pillar directory.

Port of ``mask_bev_tpu/ops/stream_pillars.py::pillarize_stream_packed``
(pid fusion with the range filter, one stable sort by pid carrying the point
columns) plus the pillar directory that the JAX slot kernel builds in-kernel
(``ops/pallas_pfn.py::_pfn_slots_kernel``): kept = rank within the run < K,
run starts, per-pillar kept counts, and the ascending occupied cells with the
``H*W`` sentinel after the last pillar. All plain torch.

Every occupied cell is kept, as the TPU slot path does (there is no
``max_pillars`` cap on the eval path; the reference voxelizer's
``max_voxels`` equals the full grid). "First K" is the first K points of a
cell in input order: the sort is stable.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class PillarStream(NamedTuple):
    """Sorted point columns and the dense pillar directory, all (B, N).

    cols:        (x, y, z, intensity) float32, sorted stably by pid
    pid:         int32 sorted cell id per point; ``H*W`` for dropped points
    seg:         int64 pillar row of each point (-1 for dropped points)
    kept:        bool, in range and rank within its cell < K
    starts:      int32 first point of pillar row r (``N`` beyond the last)
    counts:      int32 kept points of pillar row r (0 beyond the last)
    cells:       int32 ascending cell of pillar row r, ``H*W`` beyond the last
    num_pillars: (B,) int32 occupied cells per sample
    """

    cols: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
    pid: torch.Tensor
    seg: torch.Tensor
    kept: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    cells: torch.Tensor
    num_pillars: torch.Tensor


def grid_size(x_range, y_range, voxel_size) -> Tuple[int, int]:
    """(grid_h, grid_w) of the BEV grid."""
    grid_w = int(round((x_range[1] - x_range[0]) / voxel_size))
    grid_h = int(round((y_range[1] - y_range[0]) / voxel_size))
    return grid_h, grid_w


def fuse_pid(points: torch.Tensor, valid: torch.Tensor, *, x_range,
             y_range, z_range, voxel_size) -> torch.Tensor:
    """(B, N, D) points (in the compute dtype) -> (B, N) int32 cell ids,
    ``H*W`` for points out of range or masked out."""
    grid_h, grid_w = grid_size(x_range, y_range, voxel_size)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    in_range = ((x >= x_range[0]) & (x < x_range[1])
                & (y >= y_range[0]) & (y < y_range[1])
                & (z >= z_range[0]) & (z < z_range[1]) & valid)
    ix = torch.clamp(torch.floor((x - x_range[0]) / voxel_size).to(
        torch.int32), 0, grid_w - 1)
    iy = torch.clamp(torch.floor((y - y_range[0]) / voxel_size).to(
        torch.int32), 0, grid_h - 1)
    sentinel = torch.tensor(grid_h * grid_w, dtype=torch.int32,
                            device=points.device)
    return torch.where(in_range, iy * grid_w + ix, sentinel)


def pillarize_stream_packed(points: torch.Tensor, valid: torch.Tensor, *,
                            x_range, y_range, z_range, voxel_size: float,
                            max_points_per_pillar: int) -> PillarStream:
    """(B, N, D) points + (B, N) mask -> :class:`PillarStream`."""
    b, n, d = points.shape
    k = max_points_per_pillar
    grid_h, grid_w = grid_size(x_range, y_range, voxel_size)
    sentinel = grid_h * grid_w
    dev = points.device

    pid = fuse_pid(points, valid, x_range=x_range, y_range=y_range,
                   z_range=z_range, voxel_size=voxel_size)
    pid_s, order = torch.sort(pid, dim=1, stable=True)
    pts = torch.gather(points, 1, order[..., None].expand(b, n, d)).float()
    zeros = torch.zeros((b, n), dtype=torch.float32, device=dev)
    cols = tuple(pts[..., i].contiguous() if i < d else zeros
                 for i in range(4))

    real = pid_s < sentinel
    prev = torch.cat([torch.full((b, 1), -1, dtype=pid_s.dtype, device=dev),
                      pid_s[:, :-1]], dim=1)
    is_first = real & (pid_s != prev)
    seg = torch.cumsum(is_first.to(torch.int64), dim=1) - 1
    seg = torch.where(real, seg, torch.full_like(seg, -1))
    num_pillars = is_first.sum(dim=1).to(torch.int32)

    pos = torch.arange(n, dtype=torch.int64, device=dev).expand(b, n)
    # scatter each run's first position to its pillar row; non-first points
    # write into the spare column n, dropped afterwards
    starts = torch.full((b, n + 1), n, dtype=torch.int64, device=dev)
    starts.scatter_(1, torch.where(is_first, seg, torch.full_like(seg, n)),
                    pos)
    starts = starts[:, :n]
    rank = pos - torch.gather(starts, 1, seg.clamp(min=0))
    kept = real & (rank < k)

    n_real = real.sum(dim=1, keepdim=True)
    ends = torch.minimum(torch.cat(
        [starts[:, 1:], torch.full((b, 1), n, dtype=torch.int64,
                                   device=dev)], dim=1), n_real)
    counts = torch.clamp(ends - starts, 0, k)
    row = torch.arange(n, device=dev)[None]
    occupied = row < num_pillars[:, None]
    cells = torch.where(
        occupied, torch.gather(pid_s, 1, starts.clamp(max=n - 1)),
        torch.full_like(pid_s, sentinel))
    return PillarStream(
        cols=cols, pid=pid_s, seg=seg, kept=kept,
        starts=starts.to(torch.int32).contiguous(),
        counts=torch.where(occupied, counts, 0).to(torch.int32).contiguous(),
        cells=cells.to(torch.int32).contiguous(), num_pillars=num_pillars)
