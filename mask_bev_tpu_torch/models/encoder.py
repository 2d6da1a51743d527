"""Pillar encoder, eval form: raw padded scans -> normalised BEV canvas (NHWC).

Port of ``mask_bev_tpu/models/encoder.py`` on the path the TPU runs at
inference: pid fusion + stable sort (``ops/stream_pillars.py``), the pillar
feature net with eval-mode batch norm folded into an affine
(``ops/pfn.py``, kernel 1), and the scatter with the pseudo-image LayerNorm
fused in (``ops/canvas.py``, kernel 2). The norm statistics come from the
pillar table: canvas cells are pillar features or exact zeros, so sum and
sum of squares over the canvas equal those over the table.

Every occupied cell is kept (no ``max_pillars`` cap), as on the TPU slot
path. Training-mode batch norm (statistics over kept points) waits for the
training slice.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from mask_bev_tpu_torch.models.swin import forget_packed
from mask_bev_tpu_torch.ops.canvas import canvas_norm
from mask_bev_tpu_torch.ops.pfn import pack_weights, pfn
from mask_bev_tpu_torch.ops.stream_pillars import (
    grid_size, pillarize_stream_packed)


class MaskedBatchNorm(nn.Module):
    """Eval-mode state of ``MaskedBatchNorm`` (eps 1e-3): affine + running
    statistics, used only through :meth:`folded`."""

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


class PFNLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, last: bool):
        super().__init__()
        units = out_channels if last else out_channels // 2
        self.units = units
        self.linear = nn.Linear(in_channels, units, bias=False)
        self.norm = MaskedBatchNorm(units)


class PillarFeatureNet(nn.Module):
    def __init__(self, feat_channels: Sequence[int], point_dim: int = 4,
                 with_distance: bool = True):
        super().__init__()
        if point_dim > 4:
            raise ValueError("the eval encoder takes at most 4 point columns")
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


class MaskBevEncoder(nn.Module):
    """points (B, N, D) + mask -> normalised canvas (B, H, W, C)."""

    def __init__(self, x_range, y_range, z_range, voxel_size: float,
                 feat_channels: Sequence[int] = (128, 128, 128),
                 max_points_per_pillar: int = 32, point_dim: int = 4,
                 pseudo_image_norm: str = "full",
                 encoding_type: str = "vanilla"):
        super().__init__()
        if encoding_type != "vanilla":
            raise NotImplementedError(
                f"encoder encoding {encoding_type!r} is not ported yet")
        self.x_range, self.y_range, self.z_range = (
            tuple(x_range), tuple(y_range), tuple(z_range))
        self.voxel_size = voxel_size
        self.k = max_points_per_pillar
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

    def forward(self, points: torch.Tensor, point_mask: torch.Tensor
                ) -> torch.Tensor:
        ps, table, stats = self.pillar_table(points, point_mask)
        h, w = self.grid_hw
        elems = float(h * w * table.shape[-1])
        mean = stats[:, 0] / elems
        var = stats[:, 1] / elems - mean * mean
        return canvas_norm(table, ps.cells, ps.num_pillars, mean, var,
                           self.norm.weight.detach(),
                           self.norm.bias.detach(), self.grid_hw,
                           self.norm.eps)
