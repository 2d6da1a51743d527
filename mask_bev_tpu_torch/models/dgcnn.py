"""Dynamic EdgeConv (DGCNN) building block.

Port of ``mask_bev_tpu/models/dgcnn.py``, the JAX package's working
static-shape rebuild of the reference's experimental factory (dead code
there). MaskBev does not call it. kNN in feature space from a dense
pairwise-distance matrix, an ``h_theta([x_i, x_j - x_i])`` MLP (linear ->
tanh GELU, flax's default -> linear) and max or mean aggregation over the
K neighbours. Parameter names follow the flax module (``linear1``,
``linear2``), so ``models/convert.py::from_flax`` maps its variables.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def knn_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, C) -> (B, N, K) int64 indices of the K nearest neighbours in
    feature space, self excluded; ties keep the lower index (a stable
    sort)."""
    sq = x.square().sum(-1)
    d2 = (sq[:, :, None] - 2.0 * torch.einsum("bnc,bmc->bnm", x, x)
          + sq[:, None, :])
    n = x.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d2 = torch.where(eye, torch.full_like(d2, float("inf")), d2)
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k]


class DynamicEdgeConv(nn.Module):
    """EdgeConv on the kNN graph of its own input (rebuilt every call)."""

    def __init__(self, in_channels: int, out_channels: int, k: int = 16,
                 aggr: str = "max"):
        super().__init__()
        if aggr not in ("max", "mean"):
            raise ValueError(f"unknown aggr {aggr!r}")
        self.k = k
        self.aggr = aggr
        self.linear1 = nn.Linear(2 * in_channels, 2 * in_channels)
        self.linear2 = nn.Linear(2 * in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, C_in) -> (B, N, C_out)."""
        b, n, c = x.shape
        idx = knn_indices(x, self.k)  # (B, N, K)
        neigh = torch.gather(x, 1, idx.reshape(b, n * self.k, 1).expand(
            b, n * self.k, c)).reshape(b, n, self.k, c)
        center = x[:, :, None].expand_as(neigh)
        e = torch.cat([center, neigh - center], dim=-1)
        h = self.linear2(F.gelu(self.linear1(e), approximate="tanh"))
        return h.amax(dim=2) if self.aggr == "max" else h.mean(dim=2)


def make_edge_conv(in_channels: int, out_channels: int, k: int,
                   aggr: str = "max") -> DynamicEdgeConv:
    """The reference's ``make_edge_conv`` signature."""
    return DynamicEdgeConv(in_channels, out_channels, k=k, aggr=aggr)
