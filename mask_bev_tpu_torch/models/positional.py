"""DETR sine positional encoding (port of
``mask_bev_tpu/models/positional.py::sine_positional_encoding_2d``). The
learnable Fourier encoding is not ported yet."""
from __future__ import annotations

import math

import torch


def sine_positional_encoding_2d(h: int, w: int, num_feats: int = 128,
                                temperature: float = 10000.0,
                                normalize: bool = True,
                                scale: float = 2 * math.pi,
                                eps: float = 1e-6, device="cpu"
                                ) -> torch.Tensor:
    """Full (h, w) grid -> (h*w, 2*num_feats) f32: y then x embeddings,
    interleaved sin/cos, mmdet ``SinePositionalEncoding`` with no mask."""
    f32 = torch.float32
    y = torch.arange(1, h + 1, dtype=f32, device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=f32, device=device)[None, :].expand(h, w)
    if normalize:
        y = y / (h + eps) * scale
        x = x / (w + eps) * scale
    dim_t = temperature ** (
        2 * torch.div(torch.arange(num_feats, dtype=f32, device=device), 2,
                      rounding_mode="floor") / num_feats)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = torch.stack([torch.sin(pos_x[..., 0::2]),
                         torch.cos(pos_x[..., 1::2])], -1).reshape(
                             h, w, num_feats)
    pos_y = torch.stack([torch.sin(pos_y[..., 0::2]),
                         torch.cos(pos_y[..., 1::2])], -1).reshape(
                             h, w, num_feats)
    return torch.cat([pos_y, pos_x], dim=-1).reshape(h * w, 2 * num_feats)
