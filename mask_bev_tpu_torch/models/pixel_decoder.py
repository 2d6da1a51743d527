"""Conv-FPN pixel decoder (port of ``mask_bev_tpu/models/pixel_decoder.py``):
1x1 laterals + GroupNorm(32, eps 1e-6), the window-attention refinement of
the three coarse laterals, a top-down path with nearest upsampling, 3x3
output convs + GN + ReLU, and a 3x3 ``mask_feature`` conv. NHWC in and out;
memories ordered /32, /16, /8. The GroupNorms compute flax
``nn.GroupNorm``'s form (:class:`GroupNorm`).

The refinement (``num_attn_layers`` > 0, JAX :48-59): for levels 1-3 and
``l < num_attn_layers``, ``refine{i}_{l}`` is a Swin block of
``feat_channels`` channels, 8 heads and 10 x 10 windows, shifted for odd
``l``, on the lateral's tokens. The JAX package builds these blocks without
``quantize``, so they are never int8, whatever the backbone's setting. At
eval they run the block's XLA form with kernel 7 for the window MSA
(``SwinBlock.forward(..., fused=False, fused_attention=True)``, the bf16 or
f32 instance on the card, its plain version on the CPU); in training the
plain form on the live parameters.

``jax.image.resize(method="nearest")`` samples at pixel centres, which is
``F.interpolate(mode="nearest-exact")``; plain ``"nearest"`` picks other
rows when the size ratio is not an integer (63 -> 125).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mask_bev_tpu_torch.models.swin import SwinBlock


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
                 out_channels: int = 256, num_attn_layers: int = 0,
                 attn_heads: int = 8, attn_window: int = 10):
        super().__init__()
        c = feat_channels
        self.num_attn_layers = num_attn_layers
        for i in range(1, 4):
            for l in range(num_attn_layers):
                self.add_module(f"refine{i}_{l}", SwinBlock(
                    c, attn_heads, attn_window, shift=(l % 2 == 1)))
        for i, cin in enumerate(in_channels):
            self.add_module(f"lateral{i}", nn.Conv2d(cin, c, 1))
            self.add_module(f"lateral_gn{i}", GroupNorm(32, c, eps=1e-6))
            self.add_module(f"output{i}", nn.Conv2d(c, c, 3, padding=1))
            self.add_module(f"output_gn{i}", GroupNorm(32, c, eps=1e-6))
        self.mask_feature = nn.Conv2d(c, out_channels, 3, padding=1)

    def forward(self, feats: Sequence[torch.Tensor], train: bool = False
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        assert len(feats) == 4
        lat = []
        for i, x in enumerate(feats):
            y = getattr(self, f"lateral{i}")(x.permute(0, 3, 1, 2))
            lat.append(getattr(self, f"lateral_gn{i}")(y))
        for i in range(1, 4):
            if not self.num_attn_layers:
                break
            b, c, h, w = lat[i].shape
            t = lat[i].permute(0, 2, 3, 1).reshape(b, h * w, c)
            for l in range(self.num_attn_layers):
                t = getattr(self, f"refine{i}_{l}")(
                    t, (h, w), train, None, fused=False, fused_attention=True)
            lat[i] = t.reshape(b, h, w, c).permute(0, 3, 1, 2)
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
