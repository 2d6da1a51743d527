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

Both run as one CUDA kernel (``csrc/pfn.cu::pfn_tile_kernel``) on tiles of
whole pillars (``ops/stream_pillars.py::pfn_tiles``), chosen by the weights'
dtype: a bf16 instance (layer products on ``mma.sync`` m16n8k16, counted
as ``<kernel>/bf16``) or an f32 instance (3xTF32 on ``mma.sync`` m16n8k8,
two tile groups a block sharing the f32 weights, counted as
``<kernel>/f32_3xtf32``; it took the place of an f32 instance whose
products were FMAs on the CUDA cores, ``<kernel>/f32``). Up to 32 points a
pillar a tile spans at most 95 rows (6 m16 tiles); up to 128 (mmdet3d's
64, the PointPillars paper's 100) it spans at most 191, the instances of
12 m16 tiles (:data:`LONG_SUFFIX`: ``<kernel>/bf16_k128``,
``<kernel>/f32_3xtf32_k128``). Each wrapper launches it and the statistics
reduction, two launches a call.

Widths: 1 to :data:`MAX_UNITS` units a layer, up to :data:`MAX_LAYERS`
layers, each fed ``[z, pooled]`` of the one before, as the JAX package's
stream PFN takes them. The kernel works on units padded to a multiple of 8
(:func:`kernel_dims`, :func:`pack_weights`: zero weight columns and a zero
affine, so the padded z and pooled columns are exact zeros, and zero rows
for them in the next layer's weight) and writes the table at its true
width. Layers of more than 128 units take the wide instances (suffix
:data:`WIDE_SUFFIX`).

What the tiles cannot hold, a block's shared memory (:func:`smem_bytes`:
two layers of 256 units) or pillars of more than :data:`MAX_K` kept points
(any K the JAX package takes), runs on the layered route
(``csrc/pfn.cu::pfn_layered_forward``, counted as ``<kernel>/bf16_layered``
or ``<kernel>/f32_3xtf32_layered``): the same decoration, products and
rounding, one layer at a time over all of its pillars' kept rows with the
activations in device memory (:func:`layered_lda`). Where the tiles take
the layers, only the pillars of more than :data:`MAX_K` kept points go
there (:func:`layered_directory`); the tiles take the rest as they do at K
= :data:`MAX_K` (:func:`route`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from mask_bev_tpu_torch.kernels import build as kb
from mask_bev_tpu_torch.ops.decoder_stack import pack_fragments
from mask_bev_tpu_torch.ops.stream_pillars import (
    PillarStream, StreamPillars, gather_at_starts, kept_counts, pfn_tiles,
    windowed_segment_max, windowed_segment_sum)

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
    """Plain PyTorch version: (table (B, N, C) out_dtype, stats (B, 2) f32).
    ``out_dtype`` float64 runs the layers in float64 (the decoration stays
    f32, as the kernel's): a reference for the f32 instance."""
    x = decorate(ps, point_dim=point_dim, with_distance=with_distance,
                 grid_w=grid_w, voxel_size=voxel_size, x0=x0, y0=y0)
    b, n, _ = x.shape
    work = _work_dtype(out_dtype)
    keptf = ps.kept.to(work)[..., None]
    seg = ps.seg.clamp(min=0)
    nl = len(weights)
    for li, (w, g, bias) in enumerate(weights):
        xin = x.to(w.dtype).to(work)
        z = torch.relu((xin @ w.to(work)) * g.to(work) + bias.to(work)) * keptf
        u = z.shape[-1]
        pooled = torch.zeros((b, n, u), dtype=work, device=x.device)
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


def _work_dtype(out_dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if out_dtype == torch.float64 else torch.float32


def table_stats(table: torch.Tensor) -> torch.Tensor:
    """(B, 2) [sum, sum of squares] of a (B, P, C) table's values: f32, or
    float64 for a float64 table."""
    t = table.to(_work_dtype(table.dtype))
    return torch.stack([t.sum(dim=(1, 2)), (t * t).sum(dim=(1, 2))], dim=-1)


# the f32 instance's name in ``kb.INSTANCES``
F32_INSTANCE = "f32_3xtf32"
# ``csrc/pfn.cu``: points a pillar of the instances of 6 and 12 m16 tiles
# (a tile spans at most 64 + K - 1 rows), the suffix of the second one's
# name, a block's shared memory
SHORT_K, MAX_K = 32, 128
LONG_SUFFIX = "_k128"
SMEM_LIMIT = 232448
# ``csrc/pfn.cu``: units a layer (``PFN_MAXU``), layers (``PFN_MAXL``), the
# widest layer of the instances that are not wide, their name's suffix
MAX_UNITS, MAX_LAYERS = 256, 8
NARROW_UNITS = 128
WIDE_SUFFIX = "_u256"


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def kernel_dims(dims: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The (in, units) of the layers the kernel runs for true layers
    ``dims``: units padded to a multiple of 8, so a layer after the first
    takes [z, pooled] of the padded width."""
    out, prev = [], None
    for k, u in dims:
        out.append((k if prev is None else 2 * prev, _pad(u, 8)))
        prev = out[-1][1]
    return out


def is_wide(dims: Sequence[Tuple[int, int]]) -> bool:
    """Whether layers ``dims`` take the wide instances (a layer over
    :data:`NARROW_UNITS` units)."""
    return any(u > NARROW_UNITS for _, u in dims)


def instance(f32: bool, k: int, wide: bool = False) -> str:
    """The instance name a launch of the tiles counts under for K points a
    pillar (and layers over :data:`NARROW_UNITS` units: ``wide``)."""
    return ((F32_INSTANCE if f32 else "bf16")
            + (LONG_SUFFIX if k > SHORT_K else "")
            + (WIDE_SUFFIX if wide else ""))


LAYERED_SUFFIX = "_layered"


def layered_instance(f32: bool) -> str:
    """The instance name a launch of the layered route counts under."""
    return (F32_INSTANCE if f32 else "bf16") + LAYERED_SUFFIX


def layered_lda(dims: Sequence[Tuple[int, int]]) -> int:
    """The layered route's row stride in its workspace: the widest of the
    kernel layers' inputs (padded to 16) and units."""
    kd = kernel_dims(dims)
    return max([_pad(k, 16) for k, _ in kd] + [u for _, u in kd])


def layered_directory(counts: torch.Tensor, num: torch.Tensor,
                      all_pillars: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layered route's directory, from the (B, P) kept counts and (B,)
    occupied pillars: (counts, lrow0, tot) int32, each pillar's kept rows
    on the route (every occupied pillar's where ``all_pillars``, else only
    those of more than :data:`MAX_K`; 0 elsewhere), its first row among the
    route's rows of its sample (an exclusive cumulative sum, so a pillar's
    rows stay in sorted order: its first K points), and the route's rows a
    sample."""
    occupied = (torch.arange(counts.shape[1], device=counts.device)[None]
                < num.to(counts.device)[:, None])
    on = occupied if all_pillars else occupied & (counts > MAX_K)
    lc = torch.where(on, counts, 0).to(torch.int64)
    lrow0 = torch.cumsum(lc, dim=1) - lc
    return (lc.to(torch.int32).contiguous(),
            lrow0.to(torch.int32).contiguous(),
            lc.sum(dim=1).to(torch.int32).contiguous())


def tile_counts(counts: torch.Tensor) -> torch.Tensor:
    """The kept counts the tiles take beside the layered route: a pillar
    of more than :data:`MAX_K` kept points counts one (its row is written
    again by the layered route, which runs after), so that each pillar of
    a tile keeps a first row of its own."""
    return torch.where(counts > MAX_K, 1, counts).to(torch.int32)


def smem_bytes(dims: Sequence[Tuple[int, int]], f32: bool, k: int) -> int:
    """A block's shared memory for true layers ``dims``, as ``csrc/pfn.cu::
    pfn_smem`` lays it out for :func:`kernel_dims`: the f32 g/b and the
    weights (each layer's input padded to 16 rows), then per tile group its
    16 MT rows (stride the widest padded input or units + 4 f32 or + 8
    bf16), the tile's directory and raw points; the f32 instance that is
    not wide runs two tile groups where they fit."""
    kd = kernel_dims(dims)
    esz = 4 if f32 else 2
    kps = [_pad(kk, 16) for kk, _ in kd]
    wsz = sum(kp * u for kp, (_, u) in zip(kps, kd))
    gbsz = (2 * sum(u for _, u in kd) + 3) & ~3
    lda = max(kps + [u for _, u in kd]) + (4 if f32 else 8)
    rows = 16 * (6 if k <= SHORT_K else 12)
    group = esz * rows * lda + 4 * (4 * 64 + rows) + 16 * (rows + 64)
    shared = 4 * gbsz + esz * wsz
    groups = (2 if f32 and not is_wide(kd)
              and shared + 2 * group <= SMEM_LIMIT else 1)
    return shared + groups * group
# the parts of the tile walk that ``profile`` times, in its order
# (``csrc/pfn.cu::PFN_PARTS``)
PFN_PARTS = ("set-up", "directory", "gather", "decorate", "products",
             "epilogue", "max", "zero tail")


def _check_profile(profile):
    """The kernel's ``prof`` pointer: null, or a zeroed (len(PFN_PARTS) +
    1,) int64 CUDA tensor that the kernel adds the parts' ns to (summed over
    its tile groups), then the number of groups."""
    if profile is not None:
        kb.check_cuda(profile, "profile", torch.int64, (len(PFN_PARTS) + 1,))
    return kb.ptr(profile)


def pack_fragments_tf32(w: torch.Tensor) -> torch.Tensor:
    """(K, N) f32 weight -> the same values, flat, in ``mma.sync`` m16n8k8
    (TF32) B-fragment order: for each 8-column tile j and 8-row step ks,
    lane ``4g + t`` holds rows ``8 ks + t`` and ``8 ks + t + 4`` of column
    ``8j + g`` (one 8-byte load a lane; the kernel splits the f32 values
    into TF32 halves). K % 8 == 0 and N % 8 == 0."""
    k, n = w.shape
    return (w.reshape(k // 8, 2, 4, n // 8, 8)
            .permute(3, 0, 4, 2, 1).reshape(-1))


def unpack_fragments_tf32(p: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_fragments_tf32`."""
    return (p.reshape(n // 8, k // 8, 8, 4, 2)
            .permute(1, 4, 3, 0, 2).reshape(k, n))


def padded_layers(weights: Weights) -> List[Tuple[torch.Tensor,
                                                 torch.Tensor, torch.Tensor]]:
    """The layers the kernel runs (:func:`kernel_dims`): each W (in, units)
    at (kernel in, units padded to 8), its true rows placed at the
    kernel's z and pooled columns and every other entry zero, g and b f32
    with zeros past the true units. The padded z and pooled columns are
    relu(0 * acc + 0) = 0, so the rows, pooled values and table columns the
    true layers give are unchanged (held against the true layers in
    float64 on the CPU: ``tests/test_torch_port_audit.py``)."""
    out, prev = [], None
    for (w, g, b), (kk, up) in zip(weights, kernel_dims(
            [tuple(w.shape) for (w, _, _) in weights])):
        k, u = w.shape
        wp = torch.zeros((kk, up), dtype=w.dtype, device=w.device)
        if prev is None:
            wp[:k, :u] = w
        else:  # rows [z (prev units), pooled (prev units)] at [0, kk / 2)
            wp[:prev, :u] = w[:prev]
            wp[kk // 2:kk // 2 + prev, :u] = w[prev:]
        gp, bp = (torch.zeros(up, dtype=torch.float32, device=w.device)
                  for _ in range(2))
        gp[:u] = g.float().reshape(-1)
        bp[:u] = b.float().reshape(-1)
        out.append((wp, gp, bp))
        prev = u
    return out


def pack_weights(weights: Weights, device):
    """The kernels' weights: (weights, g/b, dims) of :func:`padded_layers`.
    Each layer's W (in, units) is zero-padded to ``kp`` = in rounded up to
    16 rows, in ``mma.sync`` B-fragment order: bf16 weights for m16n8k16
    (``ops/decoder_stack.py::pack_fragments``), f32 weights for m16n8k8
    (:func:`pack_fragments_tf32`). g and b are f32 per layer; dims
    ``[n_layers, in_0, units_0, ...]`` of the padded layers."""
    wparts, gbparts, dims = [], [], [len(weights)]
    for (w, g, b) in padded_layers(weights):
        k, u = w.shape
        kp = -(-k // 16) * 16
        wp = torch.zeros((kp, u), dtype=w.dtype, device=w.device)
        wp[:k] = w
        wparts.append(pack_fragments(wp) if w.dtype == torch.bfloat16
                      else pack_fragments_tf32(wp))
        gbparts += [g, b]
        dims += [k, u]
    gb = torch.cat(gbparts)
    gb = torch.cat([gb, gb.new_zeros(-gb.numel() % 4)])
    return (torch.cat(wparts).to(device).contiguous(),
            gb.to(device).contiguous(), dims)


def layers_refusal(dims: Sequence[Tuple[int, int]], in0: int, dtype,
                   out_dtype) -> Optional[str]:
    """Why the tile kernels do not take layers of (in, units) ``dims`` with
    weights of ``dtype`` (None: mixed) and a table of ``out_dtype``, or
    None where they do: bf16 or f32, one dtype for both, 1 to
    :data:`MAX_LAYERS` layers of 1 to :data:`MAX_UNITS` units, each fed
    [z, pooled] of the one before."""
    if dtype not in (torch.bfloat16, torch.float32) or out_dtype != dtype:
        return (f"the pfn kernels take bf16 or f32 weights with a table of "
                f"the same dtype; got {dtype} weights and a {out_dtype} "
                f"table")
    prev = None
    for i, (k, u) in enumerate(dims):
        if (not 1 <= u <= MAX_UNITS or (i == 0 and k != in0)
                or (prev is not None and k != 2 * prev)):
            return (f"pfn kernels take layers of 1 to {MAX_UNITS} units, "
                    f"each fed [z, pooled]; got {list(dims)}")
        prev = u
    if not 1 <= len(dims) <= MAX_LAYERS:
        return (f"pfn kernels take 1 to {MAX_LAYERS} layers; got "
                f"{len(dims)}")
    return None


def tiles_refusal(k: int, dims: Sequence[Tuple[int, int]], dtype
                  ) -> Optional[str]:
    """Why the tile kernel's instance for K points a pillar does not take
    these layers, or None: 1 to :data:`MAX_K` points a pillar and a
    block's shared memory (:func:`smem_bytes`) within the card's. What it
    refuses runs on the layered route (:func:`route`)."""
    if not 1 <= k <= MAX_K:
        return (f"pfn tiles take at most {MAX_K} points per pillar, got "
                f"{k}")
    smem = smem_bytes(dims, dtype == torch.float32, k)
    if smem > SMEM_LIMIT:
        return (f"pfn tiles: {smem} B of shared memory a block for layers "
                f"{list(dims)} at {k} points a pillar, limit {SMEM_LIMIT}")
    return None


def route(k: int, dims: Sequence[Tuple[int, int]], dtype
          ) -> Tuple[Optional[int], bool]:
    """(tile K, layered) for K points a pillar: the tiles at K (at most
    :data:`MAX_K`) where their shared memory holds the layers, else None;
    and whether the layered route runs, for every pillar where the tiles
    do not, or for those of more than :data:`MAX_K` kept points."""
    kt = min(k, MAX_K)
    if tiles_refusal(kt, dims, dtype) is not None:
        return None, True
    return kt, k > MAX_K


def _points_refusal(k: int) -> Optional[str]:
    return (None if k >= 1 else
            f"pfn kernels take at least 1 point per pillar, got {k}")


def pfn_refusal(max_points_per_pillar: int,
                dims: Sequence[Tuple[int, int]], in0: int, dtype,
                out_dtype) -> Optional[str]:
    """Why kernel 1 does not take these shapes, or None where it does:
    :func:`layers_refusal` and at least one point a pillar (the tiles or
    the layered route take any K, :func:`route`)."""
    return (layers_refusal(dims, in0, dtype, out_dtype)
            or _points_refusal(max_points_per_pillar))


def stream_pfn_refusal(k: int, point_cols: int,
                       dims: Sequence[Tuple[int, int]], with_distance: bool,
                       dtype, out_dtype, points_dtype) -> Optional[str]:
    """Why kernel 10 does not take these shapes, or None where it does: 3
    or 4 point columns of the table's dtype, :func:`layers_refusal` and
    at least one point a pillar."""
    if point_cols not in (3, 4):
        return (f"stream pfn kernel takes 3 or 4 point columns, got "
                f"D={point_cols}")
    reason = (layers_refusal(dims, point_cols + 5 + int(with_distance),
                             dtype, out_dtype)
              or _points_refusal(k))
    if reason is None and points_dtype != out_dtype:
        reason = (f"the stream pfn kernel takes points of the weights' "
                  f"dtype {out_dtype}; got {points_dtype}")
    return reason


def _layers(weights: Weights):
    """(dims, dtype) of the layers: dtype None where they mix dtypes."""
    dts = {w.dtype for (w, _, _) in weights}
    return ([tuple(w.shape) for (w, _, _) in weights],
            dts.pop() if len(dts) == 1 else None)


def pfn(ps: PillarStream, weights: Weights, *, point_dim: int,
        with_distance: bool, grid_w: int, voxel_size: float, x0: float,
        y0: float, max_points_per_pillar: int, out_dtype: torch.dtype,
        packed=None, profile=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pillar table + statistics: the CUDA kernel for CUDA tensors (its
    bf16 or 3xTF32 f32 instance, by the weights' dtype), the plain version
    for CPU tensors; the tiles, the layered route or both (:func:`route`).
    ``packed``: cached ``pack_weights``; ``profile``: a zeroed
    (len(PFN_PARTS) + 1,) int64 tensor the tiles add their time by part to
    (:data:`PFN_PARTS`; the layered route is not timed by part)."""
    x = ps.cols[0]
    if not x.is_cuda:
        return pfn_plain(ps, weights, point_dim=point_dim,
                         with_distance=with_distance, grid_w=grid_w,
                         voxel_size=voxel_size, x0=x0, y0=y0,
                         out_dtype=out_dtype)
    b, n = x.shape
    shapes, dt = _layers(weights)
    reason = pfn_refusal(max_points_per_pillar, shapes,
                         point_dim + 5 + int(with_distance), dt, out_dtype)
    if reason:
        raise ValueError(reason)
    f32 = dt == torch.float32
    for t, name in ((ps.starts, "starts"), (ps.counts, "counts"),
                    (ps.cells, "cells")):
        kb.check_cuda(t, name, torch.int32, (b, n))
    for i, c in enumerate(ps.cols):
        kb.check_cuda(c, f"cols[{i}]", torch.float32, (b, n))
    kb.check_cuda(ps.num_pillars, "num_pillars", torch.int32, (b,))
    wbuf, gb, dims = packed if packed is not None else pack_weights(
        weights, x.device)
    kb.check_cuda(wbuf, "weights", out_dtype)
    kb.check_cuda(gb, "g/b", torch.float32)
    c_out = shapes[-1][1]
    table = torch.empty((b, n, c_out), dtype=out_dtype, device=x.device)
    partials = torch.empty((b, n, 2), dtype=torch.float32, device=x.device)
    stats = torch.empty((b, 2), dtype=torch.float32, device=x.device)
    dims_arr = (kb.ctypes.c_int * len(dims))(*dims)
    geom = (kb.ci(with_distance), kb.ci(grid_w), kb.cf(voxel_size),
            kb.cf(x0 + 0.5 * voxel_size), kb.cf(y0 + 0.5 * voxel_size))
    kt, layered = route(max_points_per_pillar, shapes, dt)
    if kt is not None:
        counts = tile_counts(ps.counts) if layered else ps.counts
        row0, first = pfn_tiles(counts, ps.num_pillars, n)
        inst = instance(f32, kt, is_wide(shapes))
        kb.launch("pfn", "pfn_forward", *(kb.ptr(c) for c in ps.cols),
                  kb.ptr(ps.starts), kb.ptr(counts), kb.ptr(ps.cells),
                  kb.ptr(ps.num_pillars), kb.ptr(row0), kb.ptr(first),
                  kb.ptr(wbuf), kb.ptr(gb), dims_arr, kb.ptr(table),
                  kb.ptr(partials), _check_profile(profile), kb.ci(b),
                  kb.ci(n), kb.ci(first.shape[1] - 1), kb.ci(point_dim),
                  *geom, kb.ci(kt), kb.ci(c_out), kb.ci(f32), kb.stream(),
                  instance=inst)
    if layered:
        inst = _launch_layered("pfn", ps.cols, None, point_dim, ps.starts,
                               ps.counts, ps.cells, ps.num_pillars,
                               kt is None, wbuf, gb, dims_arr, shapes, table,
                               partials, geom, 0, f32)
    kb.launch("pfn", "pfn_stats", kb.ptr(partials), kb.ptr(ps.num_pillars),
              kb.ptr(stats), kb.ci(b), kb.ci(n), kb.stream(), instance=inst)
    return table, stats


def _launch_layered(name, cols, pts, point_dim, starts, counts, cells, num,
                    all_pillars, wbuf, gb, dims_arr, shapes, table, partials,
                    geom, zero_tail, f32) -> str:
    """Launch the layered route of kernel ``name`` (kernel 1: the sorted
    ``cols``; kernel 10: the sorted ``pts``) on its directory
    (:func:`layered_directory`) and a workspace of the table's dtype;
    return its instance name."""
    b, p = counts.shape
    n = (pts if pts is not None else cols[0]).shape[1]
    lc, lrow0, tot = layered_directory(counts, num, all_pillars)
    lda = layered_lda(shapes)
    work = torch.empty((b * n, lda), dtype=table.dtype, device=table.device)
    inst = layered_instance(f32)
    kb.launch(name, "pfn_layered_forward",
              *(kb.ptr(c) for c in (cols if pts is None else [None] * 4)),
              kb.ptr(pts), kb.ci(point_dim if pts is not None else 0),
              kb.ptr(starts), kb.ptr(lc), kb.ptr(cells), kb.ptr(num),
              kb.ptr(lrow0), kb.ptr(tot), kb.ptr(wbuf), kb.ptr(gb), dims_arr,
              kb.ptr(work), kb.ci(lda), kb.ptr(table), kb.ptr(partials),
              kb.ci(b), kb.ci(n), kb.ci(p), kb.ci(point_dim), *geom,
              kb.ci(zero_tail), kb.ci(table.shape[-1]), kb.ci(f32),
              kb.stream(), instance=inst)
    return inst


# --------------------------------------------------------------- kernel 10


def stream_pfn_plain(sp: StreamPillars, weights: Weights, *, k: int,
                     with_distance: bool, grid_w: int, voxel_size: float,
                     x0: float, y0: float, out_dtype: torch.dtype
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 10, the TPU kernel's function step
    by step: (table (B, P, C) out_dtype, stats (B, 2) f32); ``out_dtype``
    float64 runs the layers in float64, as :func:`pfn_plain` does."""
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
    work = _work_dtype(out_dtype)
    keptw = keptf.to(work)
    nl = len(weights)
    for li, (w, g, bias) in enumerate(weights):
        z = torch.relu((x.to(w.dtype).to(work) @ w.to(work)) * g.to(work)
                       + bias.to(work)) * keptw
        pooled = windowed_segment_max(z, sp.pid, k, symmetric=li < nl - 1)
        x = pooled if li == nl - 1 else torch.cat([z, pooled], -1)
    table = gather_at_starts(x, sp.starts, sp.valid).to(out_dtype)
    return table, table_stats(table)


def stream_pfn(sp: StreamPillars, weights: Weights, *, k: int,
               with_distance: bool, grid_w: int, voxel_size: float,
               x0: float, y0: float, out_dtype: torch.dtype,
               num_valid: torch.Tensor, packed=None, profile=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 10 for CUDA tensors (its bf16 or f32 instance: points,
    weights and table of one dtype), the plain version for CPU tensors.
    ``num_valid`` (B,) int32: occupied slots per sample; ``packed``: cached
    ``pack_weights``; ``profile`` as for :func:`pfn`."""
    if not sp.pts.is_cuda:
        return stream_pfn_plain(sp, weights, k=k, with_distance=with_distance,
                                grid_w=grid_w, voxel_size=voxel_size, x0=x0,
                                y0=y0, out_dtype=out_dtype)
    b, n, d = sp.pts.shape
    p = sp.starts.shape[1]
    shapes, dt = _layers(weights)
    reason = stream_pfn_refusal(k, d, shapes, with_distance, dt, out_dtype,
                                sp.pts.dtype)
    if reason:
        raise ValueError(reason)
    f32 = dt == torch.float32
    pts = sp.pts.contiguous()
    starts = sp.starts.to(torch.int32).contiguous()
    kb.check_cuda(pts, "pts", out_dtype, (b, n, d))
    kb.check_cuda(sp.pid, "pid", torch.int32, (b, n))
    kb.check_cuda(sp.kept, "kept", torch.bool, (b, n))
    kb.check_cuda(starts, "starts", torch.int32, (b, p))
    kb.check_cuda(sp.cells, "cells", torch.int32, (b, p))
    kb.check_cuda(num_valid, "num_valid", torch.int32, (b,))
    wbuf, gb, dims = packed if packed is not None else pack_weights(
        weights, pts.device)
    kb.check_cuda(wbuf, "weights", out_dtype)
    kb.check_cuda(gb, "g/b", torch.float32)
    counts = kept_counts(sp.pid, sp.kept, p)
    c_out = shapes[-1][1]
    table = torch.empty((b, p, c_out), dtype=out_dtype, device=pts.device)
    partials = torch.empty((b, p, 2), dtype=torch.float32, device=pts.device)
    stats = torch.empty((b, 2), dtype=torch.float32, device=pts.device)
    dims_arr = (kb.ctypes.c_int * len(dims))(*dims)
    geom = (kb.ci(with_distance), kb.ci(grid_w), kb.cf(voxel_size),
            kb.cf(x0 + 0.5 * voxel_size), kb.cf(y0 + 0.5 * voxel_size))
    kt, layered = route(k, shapes, dt)
    if kt is not None:
        tc = tile_counts(counts) if layered else counts
        row0, first = pfn_tiles(tc, num_valid, n)
        inst = instance(f32, kt, is_wide(shapes))
        kb.launch("stream_pfn", "stream_pfn_forward", kb.ptr(pts), kb.ci(d),
                  kb.ptr(starts), kb.ptr(tc), kb.ptr(sp.cells),
                  kb.ptr(num_valid), kb.ptr(row0), kb.ptr(first),
                  kb.ptr(wbuf), kb.ptr(gb), dims_arr, kb.ptr(table),
                  kb.ptr(partials), _check_profile(profile), kb.ci(b),
                  kb.ci(n), kb.ci(p), kb.ci(first.shape[1] - 1), *geom,
                  kb.ci(kt), kb.ci(c_out), kb.ci(f32), kb.stream(),
                  instance=inst)
    if layered:
        # the tiles zero the unused slots where they run, else this route
        inst = _launch_layered("stream_pfn", None, pts, d, starts, counts,
                               sp.cells, num_valid, kt is None, wbuf, gb,
                               dims_arr, shapes, table, partials, geom,
                               int(kt is None), f32)
    kb.launch("stream_pfn", "pfn_stats", kb.ptr(partials), kb.ptr(num_valid),
              kb.ptr(stats), kb.ci(b), kb.ci(p), kb.stream(), instance=inst)
    return table, stats
