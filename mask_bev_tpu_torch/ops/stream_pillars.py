"""Pillarization of padded scans into sorted point streams.

Eval form: port of
``mask_bev_tpu/ops/stream_pillars.py::pillarize_stream_packed`` (pid fusion
with the range filter, one stable sort by pid carrying the point columns)
plus the pillar directory that the JAX slot kernel builds in-kernel
(``ops/pallas_pfn.py::_pfn_slots_kernel``): kept = rank within the run < K,
run starts, per-pillar kept counts, and the ascending occupied cells with
the ``H*W`` sentinel after the last pillar. All plain torch.

Every occupied cell is kept, as the TPU slot path does (there is no
``max_pillars`` cap on the eval path; the reference voxelizer's
``max_voxels`` equals the full grid). "First K" is the first K points of a
cell in input order: the sort is stable.

Training form: port of ``pillarize_stream`` (:135-224) with its
``max_pillars`` cap (only the first ``max_pillars`` cells in pid order are
kept, and the points of the others are dropped), and of the windowed
segment reductions that the training pillar feature net runs on the sorted
stream (``windowed_segment_max`` :85, ``windowed_segment_sum`` :110-132,
``gather_at_starts`` :290). The shifts and gates are the JAX package's,
op for op, so the sums are taken in the same order and the gradient of
every max splits between ties as it does there.
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


# ------------------------------------------------------------ training form


class StreamPillars(NamedTuple):
    """Sorted point stream and capped pillar directory, batched.

    pts:        (B, N, D) points sorted stably by pillar id
    pid:        (B, N) int32 sorted pillar ids; ``H*W`` for dropped points
    kept:       (B, N) bool, in range, rank within the cell < K, and the
                cell among the first ``max_pillars``
    starts:     (B, P) int64 first point of each pillar slot (``N - 1`` for
                an unused slot)
    valid:      (B, P) bool pillar occupancy
    cells:      (B, P) int32 ascending cell ``iy * W + ix`` of each slot,
                ``H*W`` for an unused slot (the canvas scatter's input, in
                place of the reference's (iy, ix) coords)
    """

    pts: torch.Tensor
    pid: torch.Tensor
    kept: torch.Tensor
    starts: torch.Tensor
    valid: torch.Tensor
    cells: torch.Tensor


def shift_rows(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    """``out[..., i] = x[..., i + s]`` along ``dim`` 1 (the stream axis),
    ``fill`` where ``i + s`` falls outside."""
    if s == 0:
        return x
    n = x.shape[1]
    pad_shape = list(x.shape)
    pad_shape[1] = min(abs(s), n)
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    if abs(s) >= n:
        return pad
    if s > 0:
        return torch.cat([x[:, s:], pad], dim=1)
    return torch.cat([pad, x[:, :n + s]], dim=1)


def _num_steps(k: int) -> int:
    """Doubling steps so that the window reach 2^t - 1 covers k - 1 rows:
    ceil(log2(k))."""
    return max(k - 1, 0).bit_length()


def windowed_segment_max(vals: torch.Tensor, pid: torch.Tensor, k: int, *,
                         symmetric: bool = True) -> torch.Tensor:
    """Per-row max over same-pid rows within reach k-1 (forward only, or
    both ways). ``vals`` (B, N, C) with non-contributing rows pre-masked to a
    lower bound of the real values; ``pid`` (B, N), segments contiguous."""
    out = vals
    for t in range(_num_steps(k)):
        s = 1 << t
        gate = (shift_rows(pid, s, -1) == pid)[..., None]
        out = torch.maximum(out, torch.where(gate, shift_rows(out, s, 0),
                                             vals))
        if symmetric:
            gate = (shift_rows(pid, -s, -1) == pid)[..., None]
            out = torch.maximum(out, torch.where(
                gate, shift_rows(out, -s, 0), vals))
    return out


def _directional_window_sum(vals, pid, k, sign) -> torch.Tensor:
    """Exact sum over same-pid rows in [i, i + 2^t - 1] (sign +1) or
    [i - 2^t + 1, i] (sign -1), with 2^t >= k."""
    out = vals
    for t in range(_num_steps(k)):
        s = (1 << t) * sign
        gate = (shift_rows(pid, s, -1) == pid)[..., None]
        out = out + torch.where(gate, shift_rows(out, s, 0.0), 0.0)
    return out


def windowed_segment_sum(vals: torch.Tensor, pid: torch.Tensor, k: int
                         ) -> torch.Tensor:
    """Per-row sum over all same-pid rows of a segment spanning at most k
    rows: forward window + backward window - self."""
    fwd = _directional_window_sum(vals, pid, k, +1)
    bwd = _directional_window_sum(vals, pid, k, -1)
    return fwd + bwd - vals


def gather_at_starts(stream_vals: torch.Tensor, starts: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """(B, N, C) stream + (B, P) starts -> (B, P, C) pillar table, zero on
    invalid slots."""
    b, _, c = stream_vals.shape
    table = torch.gather(stream_vals, 1,
                         starts[..., None].expand(b, starts.shape[1], c))
    return torch.where(valid[..., None], table, 0.0)


def pillarize_stream(points: torch.Tensor, valid: torch.Tensor, *, x_range,
                     y_range, z_range, voxel_size: float,
                     max_points_per_pillar: int, max_pillars: int
                     ) -> StreamPillars:
    """(B, N, D) points + (B, N) mask -> :class:`StreamPillars` with at most
    ``max_pillars`` pillars per sample, the first ones in pid order."""
    b, n, d = points.shape
    k = max_points_per_pillar
    p = max_pillars
    grid_h, grid_w = grid_size(x_range, y_range, voxel_size)
    sentinel = grid_h * grid_w
    dev = points.device

    pid = fuse_pid(points, valid, x_range=x_range, y_range=y_range,
                   z_range=z_range, voxel_size=voxel_size)
    pid_s, order = torch.sort(pid, dim=1, stable=True)
    pts_s = torch.gather(points, 1, order[..., None].expand(b, n, d))

    # rank within the run < K  <=>  the row K before belongs to another run
    kept = (pid_s < sentinel) & (shift_rows(pid_s, -k, -1) != pid_s)
    prev = shift_rows(pid_s, -1, -1)
    is_first = (pid_s != prev) & (pid_s < sentinel)
    num_segments = is_first.sum(dim=1)
    # points of the segments beyond the P pillar slots are dropped, as the
    # reference voxelizer's max_voxels cap drops whole voxels
    seg_idx = torch.cumsum(is_first.to(torch.int64), dim=1) - 1
    kept = kept & (seg_idx < p)

    arange_n = torch.arange(n, dtype=torch.int64, device=dev)
    start_keys = torch.where(is_first, arange_n, n)
    starts = torch.sort(start_keys, dim=1).values[:, :p]
    if n < p:
        starts = torch.cat([starts, torch.full(
            (b, p - n), n, dtype=torch.int64, device=dev)], dim=1)
    slot = torch.arange(p, device=dev)[None]
    # every segment holds at least one point, so the first
    # min(segments, P) slots are the occupied ones
    valid_slot = slot < torch.clamp(num_segments, max=p)[:, None]
    cells = torch.where(
        valid_slot, torch.gather(pid_s, 1, torch.where(valid_slot, starts, 0)),
        sentinel)
    return StreamPillars(
        pts_s, pid_s, kept, torch.where(valid_slot, starts, n - 1),
        valid_slot, cells.to(torch.int32).contiguous())
