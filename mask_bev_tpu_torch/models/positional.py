"""Positional encodings (port of ``mask_bev_tpu/models/positional.py``):
the learnable Fourier encoding of the pillar encoder's points and the DETR
sine encoding of the decoder's memories."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class LearnableFourierPositionalEncoding(nn.Module):
    """Positions (..., G*M) -> encodings (..., G*D): ``r = [cos(x W_r),
    sin(x W_r)] / sqrt(F)`` (``W_r`` without bias), then ``mlp_hidden``,
    exact-erf GELU and ``mlp_out``, the same weights for every group
    (arXiv 2106.02795 Alg. 1; JAX :20-48). Products in the operand dtype,
    the bias added after the product rounds, as flax's ``nn.Dense``."""

    def __init__(self, groups: int = 1, m_dim: int = 3, f_dim: int = 128,
                 h_dim: int = 64, d_dim: int = 16):
        super().__init__()
        self.groups, self.m_dim, self.f_dim = groups, m_dim, f_dim
        self.d_dim = d_dim
        self.w_r = nn.Linear(m_dim, f_dim // 2, bias=False)
        self.mlp_hidden = nn.Linear(f_dim, h_dim)
        self.mlp_out = nn.Linear(h_dim, d_dim)

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        lead = pos.shape[:-1]
        if pos.shape[-1] != self.groups * self.m_dim:
            raise ValueError(
                f"Fourier encoding of {self.groups} groups of {self.m_dim} "
                f"coordinates: positions have {pos.shape[-1]} columns")
        x = pos.reshape(*lead, self.groups, self.m_dim)
        w = x @ self.w_r.weight.t()
        f = torch.cat([torch.cos(w), torch.sin(w)], dim=-1) / math.sqrt(
            self.f_dim)
        y = f @ self.mlp_hidden.weight.t() + self.mlp_hidden.bias
        y = F.gelu(y, approximate="none")
        y = y @ self.mlp_out.weight.t() + self.mlp_out.bias
        return y.reshape(*lead, self.groups * self.d_dim)


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
