"""Conv-FPN pixel decoder (port of ``mask_bev_tpu/models/pixel_decoder.py``,
``num_attn_layers=0`` only): 1x1 laterals + GroupNorm(32, eps 1e-6), a
top-down path with nearest upsampling, 3x3 output convs + GN + ReLU, and a
3x3 ``mask_feature`` conv. NHWC in and out; memories ordered /32, /16, /8.
The GroupNorms compute flax ``nn.GroupNorm``'s form (:class:`GroupNorm`).

``jax.image.resize(method="nearest")`` samples at pixel centres, which is
``F.interpolate(mode="nearest-exact")``; plain ``"nearest"`` picks other
rows when the size ratio is not an integer (63 -> 125).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm`` on NCHW: per-group f32 statistics in the
    fast-variance form ``var = max(0, E[x^2] - E[x]^2)``, then ``(x - mean)
    * (rsqrt(var + eps) * scale) + bias`` in f32, output in the input
    dtype. (torch's own group norm takes a two-pass variance.)"""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.num_groups
        x32 = x.float().reshape(b, g, c // g, h, w)
        mean = x32.mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp((x32 * x32).mean(dim=(2, 3, 4), keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float().reshape(
            1, g, c // g, 1, 1)
        y = (x32 - mean) * mul + self.bias.float().reshape(1, g, c // g, 1, 1)
        return y.reshape(b, c, h, w).to(x.dtype)


class PixelDecoder(nn.Module):
    def __init__(self, in_channels: Sequence[int], feat_channels: int = 256,
                 out_channels: int = 256, num_attn_layers: int = 0):
        super().__init__()
        if num_attn_layers:
            raise NotImplementedError(
                "pixel-decoder attention refinement is not ported yet")
        c = feat_channels
        for i, cin in enumerate(in_channels):
            self.add_module(f"lateral{i}", nn.Conv2d(cin, c, 1))
            self.add_module(f"lateral_gn{i}", GroupNorm(32, c, eps=1e-6))
            self.add_module(f"output{i}", nn.Conv2d(c, c, 3, padding=1))
            self.add_module(f"output_gn{i}", GroupNorm(32, c, eps=1e-6))
        self.mask_feature = nn.Conv2d(c, out_channels, 3, padding=1)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        assert len(feats) == 4
        lat = []
        for i, x in enumerate(feats):
            y = getattr(self, f"lateral{i}")(x.permute(0, 3, 1, 2))
            lat.append(getattr(self, f"lateral_gn{i}")(y))
        path = [None] * 4
        path[3] = lat[3]
        for i in (2, 1, 0):
            up = F.interpolate(path[i + 1], size=lat[i].shape[-2:],
                               mode="nearest-exact")
            path[i] = lat[i] + up
        outs = []
        for i in range(4):
            y = getattr(self, f"output{i}")(path[i])
            outs.append(torch.relu(getattr(self, f"output_gn{i}")(y)))
        mask_features = self.mask_feature(outs[0]).permute(0, 2, 3, 1)
        memories = [outs[i].permute(0, 2, 3, 1) for i in (3, 2, 1)]
        return mask_features.contiguous(), [m.contiguous() for m in memories]
