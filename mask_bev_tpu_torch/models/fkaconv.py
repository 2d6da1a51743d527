"""FKAConv point convolution (feature-kernel alignment).

Port of ``mask_bev_tpu/models/fkaconv.py``, the JAX package's working
rebuild of the reference's experimental FKAConv (adapted there from
LightConvPoint; the reference copy is dead code). MaskBev does not call it.
On static neighbourhoods, channels last:

  * the neighbours' coordinates relative to their support point are divided
    by a running mean of the neighbourhood radius (``norm_radius``, a
    buffer updated in train mode with momentum 0.1 from the mean over the
    batch of each neighbourhood's largest distance);
  * soft distance weights ``sigmoid(-alpha d + beta)``, normalised to sum to
    K over each neighbourhood;
  * a 3-layer MLP over the scaled coordinates, with two distance-weighted
    max-pool concatenations and an instance norm over the neighbourhood
    after the first two layers, estimates the (K, kernel_size) alignment;
  * the features projected through the alignment, then a linear map from
    ``in_channels * kernel_size`` to ``out_channels``.

``features`` (B, S, K, I) and ``rel_coords`` (B, S, K, D) -> (B, S, O).
Parameter names follow the flax module, so ``models/convert.py::from_flax``
maps its variables: ``fc1``-``fc3`` and ``cv`` (``Dense`` -> ``Linear``),
``bn1``/``bn2`` (the flax ``bn1_scale``/``bn1_bias`` leaves -> ``weight``/
``bias``), ``alpha``, ``beta`` and the ``norm_radius`` batch statistic.
"""
from __future__ import annotations

import torch
from torch import nn


class InstanceNorm(nn.Module):
    """Normalisation over the neighbourhood axis (-2) of (..., K, C), with
    a per-channel affine (the reference's ``InstanceNorm2d(kernel_size)``
    on this layout)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(-2, keepdim=True)
        var = (x - mu).square().mean(-2, keepdim=True)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class FKAConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 16, dim: int = 3, use_bias: bool = False,
                 norm_radius_momentum: float = 0.1, eps: float = 1e-6):
        super().__init__()
        ks = kernel_size
        self.kernel_size = ks
        self.momentum = norm_radius_momentum
        self.eps = eps
        self.alpha = nn.Parameter(torch.ones(()))
        self.beta = nn.Parameter(torch.ones(()))
        self.fc1 = nn.Linear(dim, ks, bias=False)
        self.bn1 = InstanceNorm(ks)
        self.fc2 = nn.Linear(2 * ks, ks, bias=False)
        self.bn2 = InstanceNorm(ks)
        self.fc3 = nn.Linear(2 * ks, ks, bias=False)
        self.cv = nn.Linear(in_channels * ks, out_channels, bias=use_bias)
        self.register_buffer("norm_radius", torch.ones(()))

    def forward(self, features: torch.Tensor, rel_coords: torch.Tensor,
                train: bool = True) -> torch.Tensor:
        """features (B, S, K, I), rel_coords (B, S, K, D) -> (B, S, O);
        ``train`` updates ``norm_radius`` before it is used."""
        b, s, k, i = features.shape
        with torch.no_grad():
            dist = torch.sqrt(torch.clamp(rel_coords.square().sum(-1),
                                          min=0.0))  # (B, S, K)
            if train:
                m = self.momentum
                self.norm_radius.copy_(self.norm_radius * (1 - m)
                                       + dist.amax(-1).mean() * m)
        pts = rel_coords / self.norm_radius

        # soft distance weights, normalised to sum to K a neighbourhood
        w = torch.sigmoid(-self.alpha * dist + self.beta)
        ws = w.sum(-1, keepdim=True)
        w = w / (ws + (ws == 0).to(ws.dtype) + self.eps) * k  # (B, S, K)
        w = w[..., None]

        mat = torch.relu(self.bn1(self.fc1(pts)))
        mp1 = (mat * w).amax(-2, keepdim=True)  # (B, S, 1, ks)
        mat = torch.cat([mat, mp1.expand_as(mat)], dim=-1)
        mat = torch.relu(self.bn2(self.fc2(mat)))
        mp2 = (mat * w).amax(-2, keepdim=True)
        mat = torch.cat([mat, mp2.expand_as(mat)], dim=-1)
        mat = torch.relu(self.fc3(mat)) * w  # (B, S, K, ks)

        # align the features onto the kernel: (B, S, I, ks) -> (B, S, O)
        aligned = torch.einsum("bski,bskj->bsij", features, mat)
        return self.cv(aligned.reshape(b, s, i * self.kernel_size))
