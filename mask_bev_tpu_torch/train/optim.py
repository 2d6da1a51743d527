"""Adam and AdamW as ``optax.adam`` / ``optax.adamw`` compute them.

Port of the adam and adam_w entries of ``mask_bev_tpu/train/optim.py``
(:25-35) under the constant schedules (``plateau`` and ``none``): the
learning rate is ``cfg.lr`` times the host-driven ``lr_scale`` (the plateau
schedule's factor). Per parameter, in optax's order and in f32:

    mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g**2 + b2 * nu
    u = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)
    u = u + weight_decay * p            (AdamW only)
    p = p + (-lr) * u

with the bias corrections taken in f32, as optax takes ``decay**count``.
LAMB, SGD, the cosine and poly schedules, differential learning rates,
frozen stages and gradient clipping are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from mask_bev_tpu_torch.config import MaskBevConfig


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class Adam:
    """``optax.adam`` (``weight_decay=None``) or ``optax.adamw``."""

    def __init__(self, lr: float, weight_decay: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.weight_decay = lr, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(
            0, {k: torch.zeros_like(p) for k, p in params.items()},
            {k: torch.zeros_like(p) for k, p in params.items()})

    def _correction(self, decay: float, count: int) -> float:
        return float(1 - torch.tensor(decay, dtype=torch.float32) ** count)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: AdamState,
             lr_scale: float = 1.0) -> AdamState:
        """Update ``params`` in place and return the new state."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1),
                                torch._foreach_mul(
                                    [state.mu[k] for k in names], self.b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2),
            torch._foreach_mul([state.nu[k] for k in names], self.b2))
        count = state.count + 1
        mu_hat = torch._foreach_div(mu, self._correction(self.b1, count))
        nu_hat = torch._foreach_div(nu, self._correction(self.b2, count))
        den = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        upd = torch._foreach_div(mu_hat, den)
        if self.weight_decay is not None:
            upd = torch._foreach_add(
                upd, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_add_(p, torch._foreach_mul(
            upd, -(self.lr * lr_scale)))
        return AdamState(count, dict(zip(names, mu)), dict(zip(names, nu)))


def make_optimizer(cfg: MaskBevConfig) -> Adam:
    """The optimizer of ``cfg`` (adam or adam_w, constant schedule)."""
    if cfg.lr_schedulers_type not in ("plateau", "none"):
        raise NotImplementedError(
            f"lr schedule {cfg.lr_schedulers_type!r} is not ported yet")
    if (cfg.differential_lr or cfg.backbone_frozen_stages >= 0
            or cfg.grad_clip_norm > 0):
        raise NotImplementedError(
            "differential learning rates, frozen stages and gradient "
            "clipping are not ported yet")
    if cfg.optimiser_type == "adam":
        return Adam(cfg.lr)
    if cfg.optimiser_type == "adam_w":
        return Adam(cfg.lr, weight_decay=cfg.weight_decay)
    raise NotImplementedError(
        f"optimiser {cfg.optimiser_type!r} is not ported yet")
