"""Pillar encoder: raw padded scans -> normalised BEV canvas (NHWC).

Port of ``mask_bev_tpu/models/encoder.py``. The eval form takes the path
the JAX package takes (:meth:`MaskBevEncoder.uses_slot_path`, JAX
:395-407 without the backend check):

* the slot path, when ``use_pallas`` is set, the points are decorated the
  vanilla way from at most 4 columns, and the last PFN layer has a
  multiple of 128 channels on a grid the TPU canvas kernel can tile: pid
  fusion + stable sort (``ops/stream_pillars.py``), the pillar feature net
  with eval-mode batch norm folded into an affine (``ops/pfn.py``, kernel
  1). Every occupied cell is kept, as the reference voxelizer's
  ``max_voxels`` equals the full grid;
* otherwise the capped stream (JAX :460-490): only the first
  ``max_pillars`` cells in pid order keep their points
  (``ops/stream_pillars.py::pillarize_stream``), and the v1 PFN
  (``ops/pfn.py::stream_pfn``, kernel 10) writes their (B, P, C) table;
* the capped stream with the plain pillar feature net, when the points
  carry a Fourier or cosine encoding or more than 4 columns: the kernels
  take exactly the vanilla decoration of at most 4 raw columns, and the
  JAX package's gate (``_can_fuse``, JAX :183-190) runs its XLA stream PFN
  there too. :meth:`PillarFeatureNet.forward` with ``train=False`` (batch
  norm on its running statistics) writes the table in plain torch on any
  device; the configuration chooses this route, not a failed kernel.

All three end in the scatter with the pseudo-image LayerNorm fused in
(``ops/canvas.py``, kernel 2). The norm statistics come from the pillar
table: canvas cells are pillar features or exact zeros, so sum and sum of
squares over the canvas equal those over the table.

The training form (``forward(..., train=True)``) is the JAX package's
training path: the capped stream pillarizer
(``ops/stream_pillars.py::pillarize_stream``), the stream pillar feature net
with masked batch norm in train mode (statistics over kept points of the
whole batch, across ranks under a process group; running statistics
updated), the table-derived norm statistics, the differentiable
canvas scatter (``ops/canvas.py::canvas_scatter``, kernels A and B) and the
unfused pseudo-image norm, all in the model dtype.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from mask_bev_tpu_torch.models.positional import (
    LearnableFourierPositionalEncoding)
from mask_bev_tpu_torch.models.swin import forget_packed
from mask_bev_tpu_torch.ops.canvas import (
    canvas_norm, canvas_scatter, pick_rows_per_block)
from mask_bev_tpu_torch.ops.pfn import (
    pack_weights, pfn, stream_pfn, table_stats)
from mask_bev_tpu_torch.ops.stream_pillars import (
    StreamPillars, gather_at_starts, grid_size, pillarize_stream,
    pillarize_stream_packed, windowed_segment_max, windowed_segment_sum)
from mask_bev_tpu_torch.parallel import distributed


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
        """x (..., C) in the model dtype, mask (...,) bool. Under a process
        group the count and the sums of the mean and of the two-pass
        variance are summed over the ranks (the two sums through a
        differentiable all-reduce), so the statistics, and the running
        statistics, are those of the whole batch on every rank. The count
        is exact before its one rounding to the model dtype."""
        m = mask[..., None].to(x.dtype)
        dims = tuple(range(x.ndim - 1))
        n = distributed.all_reduce_(mask.sum().float())
        count = torch.clamp(n.to(x.dtype), min=1.0)
        mean = distributed.all_reduce_sum((x * m).sum(dims)) / count
        var = distributed.all_reduce_sum(
            ((x - mean).square() * m).sum(dims)) / count
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

    def eval_form(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Eval form on the running statistics, unfolded, in the model
        dtype (JAX ``use_running_average=True``); zero on dropped rows."""
        y = ((x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
             * self.weight + self.bias)
        return torch.where(mask[..., None], y, 0.0)


class PFNLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, last: bool):
        super().__init__()
        units = out_channels if last else out_channels // 2
        self.units = units
        self.last = last
        self.linear = nn.Linear(in_channels, units, bias=False)
        self.norm = MaskedBatchNorm(units)

    def forward(self, x, pid, kept, k: int, train: bool = True):
        """On the sorted stream (B, N, Cin): linear -> masked BN (train
        form, or on the running statistics) -> relu -> windowed segment max
        (the max-pool and its broadcast back to the points); non-last
        layers concatenate the pooled value."""
        y = self.linear(x)
        x = self.norm(y, kept) if train else self.norm.eval_form(y, kept)
        x = torch.where(kept[..., None], torch.relu(x), 0.0)
        # post-ReLU values are >= 0, so zeroed dropped rows do not change
        # the max
        pooled = windowed_segment_max(x, pid, k, symmetric=not self.last)
        return pooled if self.last else torch.cat([x, pooled], dim=-1)


# decoration columns each encoding appends (JAX ``_enc_extra``)
ENCODING_COLUMNS = {"vanilla": 0, "fourier": 16, "cosine": 24}


class PillarFeatureNet(nn.Module):
    """Point decoration and PFN layers. ``encoding_type`` appends 16
    learnable Fourier columns of xyz (``fourier_pe``, one group: the JAX
    module reshapes the 3 xyz columns into (groups, 3)) or 24 cosine
    columns (sin, then cos, of xyz x 2^[0..3], coordinate-major)."""

    def __init__(self, feat_channels: Sequence[int], point_dim: int = 4,
                 with_distance: bool = True, encoding_type: str = "vanilla",
                 fourier_enc_group: int = 1):
        super().__init__()
        if point_dim < 3:
            raise ValueError(f"the encoder needs x, y, z: {point_dim} point "
                             f"columns")
        if encoding_type not in ENCODING_COLUMNS:
            raise ValueError(f"encoder encoding {encoding_type!r}: one of "
                             f"{sorted(ENCODING_COLUMNS)}")
        self.point_dim = point_dim
        self.with_distance = with_distance
        self.encoding_type = encoding_type
        if encoding_type == "fourier":
            if fourier_enc_group != 1:
                raise ValueError(
                    f"encoder_fourier_enc_group {fourier_enc_group}: the "
                    f"Fourier encoding reshapes the 3 xyz columns into "
                    f"(groups, 3), so only 1 group is defined")
            self.fourier_pe = LearnableFourierPositionalEncoding(
                groups=1, m_dim=3, f_dim=128, h_dim=64, d_dim=16)
        in_dim = (point_dim + 3 + 2 + (1 if with_distance else 0)
                  + ENCODING_COLUMNS[encoding_type])
        nl = len(feat_channels)
        for i, ch in enumerate(feat_channels):
            layer = PFNLayer(in_dim, ch, last=(i == nl - 1))
            self.add_module(f"pfn_{i}", layer)
            in_dim = 2 * layer.units
        self.num_layers = nl

    @property
    def kernel_ok(self) -> bool:
        """The PFN kernels (1 and 10) take these points: the vanilla
        decoration of at most 4 raw columns (JAX ``_can_fuse`` without its
        TPU and ``use_pallas`` checks)."""
        return self.encoding_type == "vanilla" and self.point_dim <= 4

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
                voxel_size: float, x0: float, y0: float,
                train: bool = True) -> torch.Tensor:
        """Decorate the sorted stream (cluster offset from a windowed
        segment sum, pillar-centre offset, distance, the encoding), run the
        layers (batch norm in train form, or on the running statistics),
        read each pillar's row at its start: (B, P, C)."""
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
        if self.encoding_type == "fourier":
            parts.append(self.fourier_pe(xyz))
        elif self.encoding_type == "cosine":
            b, n = xyz.shape[:2]
            freqs = 2.0 ** torch.arange(4, dtype=pts.dtype, device=pts.device)
            ang = xyz[..., None] * freqs  # (B, N, 3, 4)
            parts += [torch.sin(ang).reshape(b, n, 12),
                      torch.cos(ang).reshape(b, n, 12)]
        x = torch.where(kept[..., None], torch.cat(parts, -1), 0.0)
        for i in range(self.num_layers):
            x = getattr(self, f"pfn_{i}")(x, pid, kept, k, train)
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
    ``max_pillars`` caps the pillars of the training form and of the eval
    form when the slot path is off."""

    def __init__(self, x_range, y_range, z_range, voxel_size: float,
                 feat_channels: Sequence[int] = (128, 128, 128),
                 max_points_per_pillar: int = 32, point_dim: int = 4,
                 pseudo_image_norm: str = "full",
                 encoding_type: str = "vanilla", max_pillars: int = 32768,
                 use_pallas: bool = True, fourier_enc_group: int = 1):
        super().__init__()
        self.x_range, self.y_range, self.z_range = (
            tuple(x_range), tuple(y_range), tuple(z_range))
        self.voxel_size = voxel_size
        self.k = max_points_per_pillar
        self.max_pillars = max_pillars
        self.use_pallas = use_pallas
        self.channels = feat_channels[-1]
        self.grid_hw = grid_size(x_range, y_range, voxel_size)
        self.pillar_feature_net = PillarFeatureNet(
            feat_channels, point_dim, encoding_type=encoding_type,
            fourier_enc_group=fourier_enc_group)
        self.norm = PseudoImageNorm(self.grid_hw, feat_channels[-1],
                                    pseudo_image_norm)
        self._packed = None
        self.register_load_state_dict_post_hook(forget_packed)

    def _apply(self, fn, *args, **kwargs):
        self._packed = None  # weights moved or cast: re-pack for the kernel
        return super()._apply(fn, *args, **kwargs)

    def uses_slot_path(self, train: bool) -> bool:
        """True iff the eval form takes the slot path (kernel 1, every cell
        kept); the JAX package's condition without its TPU check."""
        h, w = self.grid_hw
        return (self.use_pallas and not train
                and self.pillar_feature_net.kernel_ok
                and self.channels % 128 == 0
                and bool(pick_rows_per_block(h, w)))

    def _weights(self, device):
        weights = self.pillar_feature_net.folded_weights()
        if device.type == "cuda" and self._packed is None:
            self._packed = pack_weights(weights, device)
        return weights, (self._packed if device.type == "cuda" else None)

    def pillar_table(self, points: torch.Tensor, point_mask: torch.Tensor):
        """Kernel 1's inputs and outputs: (stream, table, stats).
        ``cells`` and ``num_pillars`` of the stream index the table."""
        ps = pillarize_stream_packed(
            points, point_mask, x_range=self.x_range, y_range=self.y_range,
            z_range=self.z_range, voxel_size=self.voxel_size,
            max_points_per_pillar=self.k)
        weights, packed = self._weights(points.device)
        table, stats = pfn(
            ps, weights, point_dim=self.pillar_feature_net.point_dim,
            with_distance=self.pillar_feature_net.with_distance,
            grid_w=self.grid_hw[1], voxel_size=self.voxel_size,
            x0=self.x_range[0], y0=self.y_range[0],
            max_points_per_pillar=self.k, out_dtype=points.dtype,
            packed=packed)
        return ps, table, stats

    def capped_table(self, points: torch.Tensor, point_mask: torch.Tensor):
        """The capped stream's (stream, table, stats (B, 2) [sum, sum of
        squares], occupied slots per sample): kernel 10's, or the plain
        pillar feature net's where the kernels do not take the points
        (:attr:`PillarFeatureNet.kernel_ok`)."""
        sp = pillarize_stream(
            points, point_mask, x_range=self.x_range, y_range=self.y_range,
            z_range=self.z_range, voxel_size=self.voxel_size,
            max_points_per_pillar=self.k, max_pillars=self.max_pillars)
        num_valid = sp.valid.sum(dim=1).to(torch.int32)
        net = self.pillar_feature_net
        if not net.kernel_ok:
            table = self.plain_table(sp)
            return sp, table, table_stats(table), num_valid
        weights, packed = self._weights(points.device)
        table, stats = stream_pfn(
            sp, weights, k=self.k, with_distance=net.with_distance,
            grid_w=self.grid_hw[1], voxel_size=self.voxel_size,
            x0=self.x_range[0], y0=self.y_range[0], out_dtype=points.dtype,
            num_valid=num_valid, packed=packed)
        return sp, table, stats, num_valid

    def plain_table(self, sp: StreamPillars) -> torch.Tensor:
        """The eval pillar feature net in plain torch (batch norm on its
        running statistics) on the capped stream: (B, P, C), zero rows on
        unused slots."""
        return self.pillar_feature_net(
            sp, k=self.k, grid_w=self.grid_hw[1], voxel_size=self.voxel_size,
            x0=self.x_range[0], y0=self.y_range[0], train=False)

    def forward(self, points: torch.Tensor, point_mask: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        if train:
            return self.forward_train(points, point_mask)
        if self.uses_slot_path(train):
            ps, table, stats = self.pillar_table(points, point_mask)
            cells, num_pillars = ps.cells, ps.num_pillars
        else:
            sp, table, stats, num_pillars = self.capped_table(points,
                                                              point_mask)
            cells = sp.cells
        h, w = self.grid_hw
        elems = float(h * w * table.shape[-1])
        mean = stats[:, 0] / elems
        var = stats[:, 1] / elems - mean * mean
        return canvas_norm(table, cells, num_pillars, mean, var,
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
