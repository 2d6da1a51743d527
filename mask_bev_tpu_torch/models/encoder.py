"""Pillar encoder: raw padded scans -> normalised BEV canvas (NHWC).

Port of ``mask_bev_tpu/models/encoder.py``. The eval form is the path the
TPU runs at inference: pid fusion + stable sort
(``ops/stream_pillars.py``), the pillar feature net with eval-mode batch
norm folded into an affine (``ops/pfn.py``, kernel 1), and the scatter
with the pseudo-image LayerNorm fused in (``ops/canvas.py``, kernel 2).
The norm statistics come from the pillar table: canvas cells are pillar
features or exact zeros, so sum and sum of squares over the canvas equal
those over the table.

Every occupied cell is kept (no ``max_pillars`` cap), as on the TPU slot
path.

The training form (``forward(..., train=True)``) is the JAX package's
training path: the capped stream pillarizer
(``ops/stream_pillars.py::pillarize_stream``), the stream pillar feature net
with masked batch norm in train mode (statistics over kept points, running
statistics updated), the table-derived norm statistics, the differentiable
canvas scatter (``ops/canvas.py::canvas_scatter``, kernels A and B) and the
unfused pseudo-image norm, all in the model dtype.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from mask_bev_tpu_torch.models.swin import forget_packed
from mask_bev_tpu_torch.ops.canvas import canvas_norm, canvas_scatter
from mask_bev_tpu_torch.ops.pfn import pack_weights, pfn
from mask_bev_tpu_torch.ops.stream_pillars import (
    StreamPillars, gather_at_starts, grid_size, pillarize_stream,
    pillarize_stream_packed, windowed_segment_max, windowed_segment_sum)


class MaskedBatchNorm(nn.Module):
    """``MaskedBatchNorm`` (eps 1e-3): the eval form is used through
    :meth:`folded`; :meth:`forward` is the train form.

    Train form: statistics over the kept rows only (biased variance), output
    zeroed on dropped rows, and the f32 running statistics updated with
    decay 0.99 (torch momentum 0.01), in place, as flax's
    ``mutable=["batch_stats"]`` returns them."""

    DECAY = 0.99  # torch momentum 0.01

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(g, b) with bn(x) = x * g + b, in the parameters' dtype (the
        fold happens after the compute-dtype cast, as in JAX)."""
        g = self.weight * torch.rsqrt(self.running_var + self.eps)
        return g, self.bias - self.running_mean * g

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (..., C) in the model dtype, mask (...,) bool."""
        m = mask[..., None].to(x.dtype)
        dims = tuple(range(x.ndim - 1))
        count = torch.clamp(m.sum(), min=1.0)
        mean = (x * m).sum(dims) / count
        var = ((x - mean).square() * m).sum(dims) / count
        with torch.no_grad():
            d = self.DECAY
            self.running_mean.copy_(self.running_mean * d
                                    + (mean * (1 - d)).to(
                                        self.running_mean.dtype))
            self.running_var.copy_(self.running_var * d
                                   + (var * (1 - d)).to(
                                       self.running_var.dtype))
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return torch.where(mask[..., None], y, 0.0)


class PFNLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, last: bool):
        super().__init__()
        units = out_channels if last else out_channels // 2
        self.units = units
        self.last = last
        self.linear = nn.Linear(in_channels, units, bias=False)
        self.norm = MaskedBatchNorm(units)

    def forward(self, x, pid, kept, k: int):
        """Train form on the sorted stream (B, N, Cin): linear -> masked BN
        -> relu -> windowed segment max (the max-pool and its broadcast
        back to the points); non-last layers concatenate the pooled value."""
        x = self.norm(self.linear(x), kept)
        x = torch.where(kept[..., None], torch.relu(x), 0.0)
        # post-ReLU values are >= 0, so zeroed dropped rows do not change
        # the max
        pooled = windowed_segment_max(x, pid, k, symmetric=not self.last)
        return pooled if self.last else torch.cat([x, pooled], dim=-1)


class PillarFeatureNet(nn.Module):
    def __init__(self, feat_channels: Sequence[int], point_dim: int = 4,
                 with_distance: bool = True):
        super().__init__()
        if point_dim > 4:
            raise ValueError("the encoder takes at most 4 point columns")
        self.point_dim = point_dim
        self.with_distance = with_distance
        in_dim = point_dim + 3 + 2 + (1 if with_distance else 0)
        nl = len(feat_channels)
        for i, ch in enumerate(feat_channels):
            layer = PFNLayer(in_dim, ch, last=(i == nl - 1))
            self.add_module(f"pfn_{i}", layer)
            in_dim = 2 * layer.units
        self.num_layers = nl

    def folded_weights(self):
        """Per layer (W (in, out), g, b) with eval-mode BN folded in."""
        out = []
        for i in range(self.num_layers):
            layer = getattr(self, f"pfn_{i}")
            g, b = layer.norm.folded()
            out.append((layer.linear.weight.detach().t().contiguous(),
                        g.detach(), b.detach()))
        return out

    def forward(self, sp: StreamPillars, *, k: int, grid_w: int,
                voxel_size: float, x0: float, y0: float) -> torch.Tensor:
        """Train form: decorate the sorted stream (cluster offset from a
        windowed segment sum, pillar-centre offset, distance), run the
        layers, read each pillar's row at its start: (B, P, C)."""
        pts, pid, kept = sp.pts, sp.pid, sp.kept
        xyz = pts[..., :3]
        w = torch.where(kept[..., None], torch.cat(
            [xyz, torch.ones_like(xyz[..., :1])], -1), 0.0)
        sums = windowed_segment_sum(w, pid, k)
        f_cluster = xyz - sums[..., :3] / torch.clamp(sums[..., 3:], min=1.0)
        ixf = (pid % grid_w).to(pts.dtype)
        iyf = torch.div(pid, grid_w, rounding_mode="floor").to(pts.dtype)
        cx = ixf * voxel_size + x0 + 0.5 * voxel_size
        cy = iyf * voxel_size + y0 + 0.5 * voxel_size
        parts = [pts, f_cluster, torch.stack([xyz[..., 0] - cx,
                                              xyz[..., 1] - cy], -1)]
        if self.with_distance:
            parts.append(torch.sqrt((xyz * xyz).sum(-1, keepdim=True)))
        x = torch.where(kept[..., None], torch.cat(parts, -1), 0.0)
        for i in range(self.num_layers):
            x = getattr(self, f"pfn_{i}")(x, pid, kept, k)
        return gather_at_starts(x, sp.starts, sp.valid)


class PseudoImageNorm(nn.Module):
    """LayerNorm over the whole pseudo-image, eps 1e-3: 'full' keeps an
    (H, W, C) affine like the reference's ``nn.LayerNorm([C, H, W])``;
    'channel' a (1, 1, C) one."""

    def __init__(self, grid_hw: Tuple[int, int], channels: int,
                 mode: str = "full", eps: float = 1e-3):
        super().__init__()
        shape = (*grid_hw, channels) if mode == "full" else (1, 1, channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))

    def forward(self, x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor
                ) -> torch.Tensor:
        """Unfused form on a (B, H, W, C) canvas with per-sample (mean,
        var): normalise in f32, round to the canvas dtype, then the affine
        in that dtype."""
        y = ((x.float() - mean.reshape(-1, 1, 1, 1))
             * torch.rsqrt(var.reshape(-1, 1, 1, 1) + self.eps)).to(x.dtype)
        return y * self.weight + self.bias


class MaskBevEncoder(nn.Module):
    """points (B, N, D) + mask -> normalised canvas (B, H, W, C).
    ``max_pillars`` caps the pillars of the training form only."""

    def __init__(self, x_range, y_range, z_range, voxel_size: float,
                 feat_channels: Sequence[int] = (128, 128, 128),
                 max_points_per_pillar: int = 32, point_dim: int = 4,
                 pseudo_image_norm: str = "full",
                 encoding_type: str = "vanilla", max_pillars: int = 32768):
        super().__init__()
        if encoding_type != "vanilla":
            raise NotImplementedError(
                f"encoder encoding {encoding_type!r} is not ported yet")
        self.x_range, self.y_range, self.z_range = (
            tuple(x_range), tuple(y_range), tuple(z_range))
        self.voxel_size = voxel_size
        self.k = max_points_per_pillar
        self.max_pillars = max_pillars
        self.grid_hw = grid_size(x_range, y_range, voxel_size)
        self.pillar_feature_net = PillarFeatureNet(feat_channels, point_dim)
        self.norm = PseudoImageNorm(self.grid_hw, feat_channels[-1],
                                    pseudo_image_norm)
        self._packed = None
        self.register_load_state_dict_post_hook(forget_packed)

    def _apply(self, fn, *args, **kwargs):
        self._packed = None  # weights moved or cast: re-pack for the kernel
        return super()._apply(fn, *args, **kwargs)

    def pillar_table(self, points: torch.Tensor, point_mask: torch.Tensor):
        """Kernel 1's inputs and outputs: (stream, table, stats)."""
        ps = pillarize_stream_packed(
            points, point_mask, x_range=self.x_range, y_range=self.y_range,
            z_range=self.z_range, voxel_size=self.voxel_size,
            max_points_per_pillar=self.k)
        weights = self.pillar_feature_net.folded_weights()
        if points.is_cuda and self._packed is None:
            self._packed = pack_weights(weights, points.device)
        table, stats = pfn(
            ps, weights, point_dim=self.pillar_feature_net.point_dim,
            with_distance=self.pillar_feature_net.with_distance,
            grid_w=self.grid_hw[1], voxel_size=self.voxel_size,
            x0=self.x_range[0], y0=self.y_range[0],
            max_points_per_pillar=self.k, out_dtype=points.dtype,
            packed=self._packed if points.is_cuda else None)
        return ps, table, stats

    def forward(self, points: torch.Tensor, point_mask: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        if train:
            return self.forward_train(points, point_mask)
        ps, table, stats = self.pillar_table(points, point_mask)
        h, w = self.grid_hw
        elems = float(h * w * table.shape[-1])
        mean = stats[:, 0] / elems
        var = stats[:, 1] / elems - mean * mean
        return canvas_norm(table, ps.cells, ps.num_pillars, mean, var,
                           self.norm.weight.detach(),
                           self.norm.bias.detach(), self.grid_hw,
                           self.norm.eps)

    def forward_train(self, points: torch.Tensor, point_mask: torch.Tensor
                      ) -> torch.Tensor:
        """Training form (updates the batch-norm running statistics)."""
        sp = pillarize_stream(
            points, point_mask, x_range=self.x_range, y_range=self.y_range,
            z_range=self.z_range, voxel_size=self.voxel_size,
            max_points_per_pillar=self.k, max_pillars=self.max_pillars)
        pf = self.pillar_feature_net(
            sp, k=self.k, grid_w=self.grid_hw[1], voxel_size=self.voxel_size,
            x0=self.x_range[0], y0=self.y_range[0])
        # canvas cells are pillar rows or exact zeros, so the sums over the
        # canvas equal those over the valid rows of the table
        h, w = self.grid_hw
        pf32 = torch.where(sp.valid[..., None], pf.float(), 0.0)
        elems = float(h * w * pf.shape[-1])
        mean = pf32.sum(dim=(1, 2)) / elems
        var = pf32.square().sum(dim=(1, 2)) / elems - mean.square()
        canvas = canvas_scatter(pf, sp.cells, self.grid_hw)
        return self.norm(canvas, mean, var)
