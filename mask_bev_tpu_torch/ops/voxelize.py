"""Fixed-capacity pillarization of padded point clouds into a (P, K, D)
pillar buffer.

Port of ``mask_bev_tpu/ops/voxelize.py`` (:49-163), batched over a leading
dimension where the JAX package vmaps. The model does not call it (its
encoders stream the sorted points, ``ops/stream_pillars.py``); the accuracy
harness of the JAX package and users who want the reference voxelizer's
buffer do:

  points (B, N, D) + valid mask (B, N)
    -> per-point pillar id (out of range or masked out -> the sentinel
       H*W)
    -> stable sort by pillar id (the input order within a pillar)
    -> each pillar slot's start in the sorted stream, its count
    -> (B, P, K, D) windows of the sorted points, zero past each count.

Semantics, as in the JAX package: at most K points a pillar, the first K in
input order; at most P pillars, in ascending cell order (the reference keeps
them in first-appearance order; real scans never reach its cap); points out
of the range are dropped. Plain torch on any device: the cell of a point
divides by a voxel-size tensor (a division by a Python scalar is a product
with its reciprocal on the card), so the card's buffer is the CPU's bit for
bit.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class PillarBatch(NamedTuple):
    """feats (B, P, K, D) the pillars' points, zero-padded; num_points (B,
    P) int32 points a pillar (<= K); coords (B, P, 2) int32 (iy, ix) cell,
    (-1, -1) for an empty slot; valid (B, P) bool occupied slots."""

    feats: torch.Tensor
    num_points: torch.Tensor
    coords: torch.Tensor
    valid: torch.Tensor


def pillarize_batch(points: torch.Tensor, valid: torch.Tensor, *,
                    x_range: Tuple[float, float],
                    y_range: Tuple[float, float],
                    z_range: Tuple[float, float], voxel_size: float,
                    max_points_per_pillar: int, max_pillars: int
                    ) -> PillarBatch:
    """Pillarize (B, N, D) padded clouds with columns [x, y, z, ...] and
    their (B, N) masks of real points."""
    b, n, d = points.shape
    k, p = max_points_per_pillar, max_pillars
    dev = points.device
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    grid_w = int(round((x_range[1] - x_range[0]) / voxel_size))
    grid_h = int(round((y_range[1] - y_range[0]) / voxel_size))
    sentinel = grid_h * grid_w

    in_range = ((x >= x_range[0]) & (x < x_range[1])
                & (y >= y_range[0]) & (y < y_range[1])
                & (z >= z_range[0]) & (z < z_range[1]) & valid)
    vs = torch.full_like(x, voxel_size)
    ix = torch.clamp(torch.floor((x - x_range[0]) / vs).to(torch.int32),
                     0, grid_w - 1)
    iy = torch.clamp(torch.floor((y - y_range[0]) / vs).to(torch.int32),
                     0, grid_h - 1)
    pid = torch.where(in_range, iy * grid_w + ix,
                      torch.full_like(ix, sentinel))

    # the stable sort keeps each pillar's points in input order, so the
    # first K of a pillar are the first K in the input
    pid_s, order = torch.sort(pid, dim=1, stable=True)
    pts_s = torch.gather(points, 1, order[..., None].expand(b, n, d))
    is_first = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev),
                          pid_s[:, 1:] != pid_s[:, :-1]], dim=1)
    is_first &= pid_s < sentinel
    num_segments = is_first.sum(1)

    # slot s starts at the s-th segment start; n past the last one
    arange_n = torch.arange(n, dtype=torch.int32, device=dev)
    starts_all = torch.sort(torch.where(
        is_first, arange_n, torch.full_like(arange_n, n)), dim=1).values
    if n >= p + 1:
        starts_ext = starts_all[:, :p + 1]
    else:  # fewer points than pillar slots
        starts_ext = torch.cat([starts_all, torch.full(
            (b, p + 1 - n), n, dtype=torch.int32, device=dev)], dim=1)
    starts = starts_ext[:, :p]
    slot = torch.arange(p, device=dev)
    pillar_valid = slot[None] < torch.clamp(num_segments, max=p)[:, None]

    # a slot ends where the next segment starts (the last slot takes no
    # points of segments past the cap), at most at the in-range count
    num_valid_pts = (pid < sentinel).sum(1, dtype=torch.int32)
    ends = torch.minimum(torch.where(pillar_valid, starts_ext[:, 1:], starts),
                         num_valid_pts[:, None])
    counts = torch.clamp(ends - starts, min=0)
    num_points = torch.clamp(counts, max=k).to(torch.int32)

    # (B, P, K, D) windows of the sorted points, zero-padded past the end
    pts_pad = torch.cat([pts_s, torch.zeros((b, k, d), dtype=pts_s.dtype,
                                            device=dev)], dim=1)
    safe = torch.where(pillar_valid, starts, torch.zeros_like(starts))
    rows = (safe[..., None].long()
            + torch.arange(k, device=dev)).reshape(b, p * k)
    feats = torch.gather(pts_pad, 1, rows[..., None].expand(b, p * k, d))
    feats = feats.reshape(b, p, k, d)
    point_ok = torch.arange(k, device=dev)[None, None] < num_points[..., None]
    feats = torch.where(point_ok[..., None], feats,
                        torch.zeros((), dtype=feats.dtype, device=dev))

    first_pid = torch.gather(pid_s, 1, torch.clamp(starts, 0, n - 1).long())
    cell = torch.where(pillar_valid, first_pid, torch.full_like(first_pid, -1))
    coords = torch.where(
        pillar_valid[..., None],
        torch.stack([torch.div(cell, grid_w, rounding_mode="floor"),
                     cell % grid_w], dim=-1),
        torch.full((b, p, 2), -1, dtype=cell.dtype, device=dev)
    ).to(torch.int32)
    return PillarBatch(feats, num_points, coords, pillar_valid & (counts > 0))


def pillarize(points: torch.Tensor, valid: torch.Tensor, **kw
              ) -> PillarBatch:
    """One (N, D) cloud and its (N,) mask: :func:`pillarize_batch` of a
    batch of one, without the batch dimension."""
    out = pillarize_batch(points[None], valid[None], **kw)
    return PillarBatch(*(t[0] for t in out))


def pad_points(points_np, max_points: int, point_dim: int):
    """Host-side helper: pad/truncate one (Ni, D) numpy cloud to
    (max_points, D) + mask."""
    n = min(points_np.shape[0], max_points)
    out = np.zeros((max_points, point_dim), np.float32)
    out[:n] = points_np[:n, :point_dim]
    mask = np.zeros((max_points,), bool)
    mask[:n] = True
    return out, mask
