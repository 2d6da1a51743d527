"""Optimizers and learning-rate schedules as optax computes them.

Port of ``mask_bev_tpu/train/optim.py`` (:25-142): Adam, AdamW, LAMB and SGD
(momentum 0.9); the constant (``plateau``, ``none``), ``cosine`` and
``poly`` schedules; differential learning rates (the backbone's rate times
``differential_lr_scaling``); frozen backbone stages; global-norm gradient
clipping; and the host-driven plateau scale (:class:`PlateauState`, whose
factor the train state carries as ``TrainState.lr_scale``, where the JAX
package injects it as a hyperparameter).

Per parameter, in optax's order and in f32, with ``t`` the step (from 1):

    g = g * max_norm / ||g||       (clipping, when ||g|| >= max_norm; the
                                    norm over every trainable parameter)
    adam/adamw/lamb:
      mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g**2 + b2 * nu
      u = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)
      u = u + weight_decay * p        (adamw, lamb)
      u = u * ||p|| / ||u||           (lamb; 1 where either norm is 0)
    sgd:
      mu = g + 0.9 * mu;  u = mu
    p = p + u * -(schedule(t - 1) * lr_scale * lr_mult)

``eps`` is 1e-8 (1e-6 for LAMB, as ``optax.lamb``); ``schedule`` is
``cfg.lr``, ``optax.cosine_decay_schedule(cfg.lr, max_epochs *
steps_per_epoch)`` or ``optax.polynomial_schedule(cfg.lr, 0, 0.9, max_epochs
* steps_per_epoch)``; ``lr_mult`` is ``differential_lr_scaling`` for the
backbone's parameters under ``differential_lr``, else 1. Frozen parameters
(:func:`is_frozen`) get no update, no optimizer state and no part in the
clipping norm, as ``optax.multi_transform`` with ``set_to_zero`` gives them.

Parameters are keyed by the port's names, where the JAX package keys flax
paths. Where the JAX package stacks blocks under ``nn.scan`` (the
``stage{i}_pairs`` of a deep stage, the decoder's ``layers/lvl{l}_*``),
LAMB's norms are taken over the stacked leaf, every block of it together
(:func:`stacked_leaf`), as there. One difference stays: ``stage{k}_block*``
freezes a deep stage's blocks, which the JAX package's path match does not
find.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, Optional

import torch

from mask_bev_tpu_torch.config import MaskBevConfig

OPTIMISERS = ("adam", "adam_w", "lamb", "sgd")


@dataclasses.dataclass
class OptState:
    """``count`` steps taken; ``mu`` the first moment (SGD: the momentum
    trace) and ``nu`` the second (empty for SGD), by parameter name, for
    the trainable parameters only."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def lr_schedule(cfg: MaskBevConfig, steps_per_epoch: int = 1000
                ) -> Callable[[int], torch.Tensor]:
    """Step (from 0) -> the f32 base learning rate of ``cfg``'s schedule
    (plateau and none: ``cfg.lr``, scaled on the host through
    ``lr_scale``)."""
    t = cfg.lr_schedulers_type
    steps = float(max(cfg.max_epochs * steps_per_epoch, 1))
    if t == "cosine":
        def cosine(count: int) -> torch.Tensor:
            c = torch.tensor(min(float(count), steps), dtype=torch.float32)
            decay = 0.5 * (1 + torch.cos(math.pi * c / steps))
            return cfg.lr * decay
        return cosine
    if t == "poly":
        def poly(count: int) -> torch.Tensor:
            c = torch.tensor(min(max(float(count), 0.0), steps),
                             dtype=torch.float32)
            frac = 1 - c / steps
            return cfg.lr * frac ** 0.9
        return poly
    if t not in ("plateau", "none"):
        raise ValueError(f"unknown lr_schedulers_type: {t}")
    return lambda count: torch.tensor(cfg.lr, dtype=torch.float32)


def is_frozen(cfg: MaskBevConfig, name: str) -> bool:
    """Whether parameter ``name`` belongs to a frozen backbone stage
    (``backbone_frozen_stages`` = k >= 0: the patch embed and its norm, and
    every block and patch merging of stages <= k)."""
    k = cfg.backbone_frozen_stages
    parts = name.split(".")
    if k < 0 or parts[0] != "backbone":
        return False
    part = parts[1]
    if part in ("patch_embed", "patch_norm", "absolute_pos_embed"):
        return True
    if part.startswith("stage") and "_block" in part:
        return int(part[5:part.index("_")]) <= k
    if part.startswith("merge"):
        return int(part[5:]) <= k
    return False


def stacked_leaf(cfg: MaskBevConfig, name: str) -> str:
    """The JAX package's leaf that holds port parameter ``name``: a block
    of a deep stage (an even depth of at least 4, ``nn.scan``-ned in
    (unshifted, shifted) pairs) lies in ``stage{i}_pairs.block{d % 2}``,
    and decoder layer ``n`` in ``layers.lvl{n % 3}`` where the 3 memory
    levels divide the layers; any other parameter is a leaf of its own."""
    parts = name.split(".")
    m = re.fullmatch(r"stage(\d+)_block(\d+)", parts[1]) if len(
        parts) > 1 else None
    if parts[0] == "backbone" and m:
        i, d = int(m.group(1)), int(m.group(2))
        depth = cfg.backbone_depths[i]
        if depth % 2 == 0 and depth >= 4:
            return ".".join(["backbone", f"stage{i}_pairs", f"block{d % 2}"]
                            + parts[2:])
    m = re.fullmatch(r"layer(\d+)", parts[1]) if len(parts) > 1 else None
    if parts[0] == "decoder" and m and cfg.head_num_decoder_layers % 3 == 0:
        return ".".join(["decoder", "layers", f"lvl{int(m.group(1)) % 3}"]
                        + parts[2:])
    return name


class Optimizer:
    """One of :data:`OPTIMISERS` over a dict of f32 parameters, updated in
    place by :meth:`step`."""

    def __init__(self, kind: str, schedule: Callable[[int], torch.Tensor],
                 *, weight_decay: float = 0.0, grad_clip_norm: float = 0.0,
                 lr_mult: Optional[Callable[[str], float]] = None,
                 frozen: Optional[Callable[[str], bool]] = None,
                 leaf: Optional[Callable[[str], str]] = None,
                 b1: float = 0.9, b2: float = 0.999,
                 eps: Optional[float] = None, momentum: float = 0.9):
        if kind not in OPTIMISERS:
            raise ValueError(f"unknown optimiser_type: {kind}")
        self.kind = kind
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.lr_mult = lr_mult or (lambda name: 1.0)
        self.frozen = frozen or (lambda name: False)
        self.leaf = leaf or (lambda name: name)
        self.b1, self.b2, self.momentum = b1, b2, momentum
        self.eps = (1e-6 if kind == "lamb" else 1e-8) if eps is None else eps

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        names = [k for k in params if not self.frozen(k)]
        mu = {k: torch.zeros_like(params[k]) for k in names}
        nu = ({} if self.kind == "sgd"
              else {k: torch.zeros_like(params[k]) for k in names})
        return OptState(0, mu, nu)

    @staticmethod
    def _correction(decay: float, count: int) -> float:
        return float(1 - torch.tensor(decay, dtype=torch.float32) ** count)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: OptState,
             lr_scale: float = 1.0) -> OptState:
        """Update the trainable ``params`` in place; return the new state."""
        names = list(state.mu)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        if self.grad_clip_norm > 0:
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
            if not bool(norm < self.grad_clip_norm):
                g = torch._foreach_mul(
                    torch._foreach_div(g, norm), self.grad_clip_norm)
        count = state.count + 1
        if self.kind == "sgd":
            mu = torch._foreach_add(g, torch._foreach_mul(
                [state.mu[k] for k in names], self.momentum))
            upd, nu = list(mu), []
        else:
            b1, b2 = self.b1, self.b2
            mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                    torch._foreach_mul(
                                        [state.mu[k] for k in names], b1))
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                torch._foreach_mul([state.nu[k] for k in names], b2))
            mu_hat = torch._foreach_div(mu, self._correction(b1, count))
            nu_hat = torch._foreach_div(nu, self._correction(b2, count))
            den = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
            upd = torch._foreach_div(mu_hat, den)
            if self.kind in ("adam_w", "lamb"):
                upd = torch._foreach_add(
                    upd, torch._foreach_mul(p, self.weight_decay))
            if self.kind == "lamb":
                upd = self._trust(names, p, upd)
        # the f32 rate, as optax multiplies schedule, scale and factor
        base = self.schedule(state.count) * torch.tensor(
            lr_scale, dtype=torch.float32)
        rates = [-float(base * self.lr_mult(k)) for k in names]
        torch._foreach_add_(p, torch._foreach_mul(upd, rates))
        return OptState(count, dict(zip(names, mu)), dict(zip(names, nu)))


    def _trust(self, names, p, upd):
        """LAMB's ``u * ||p|| / ||u||`` (1 where either norm is 0), the
        norms over each stacked leaf (:attr:`leaf`) of the JAX package."""
        groups: Dict[str, list] = {}
        for i, k in enumerate(names):
            groups.setdefault(self.leaf(k), []).append(i)
        out = list(upd)
        for idx in groups.values():
            pn, un = (torch.linalg.vector_norm(torch.stack([
                torch.linalg.vector_norm(t[i]) for i in idx]))
                for t in (p, upd))
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                                pn / un)
            for i in idx:
                out[i] = upd[i] * ratio
        return out


class Adam(Optimizer):
    """``optax.adam`` (``weight_decay=None``) or ``optax.adamw`` at a
    constant learning rate."""

    def __init__(self, lr: float, weight_decay: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(
            "adam" if weight_decay is None else "adam_w",
            lambda count: torch.tensor(lr, dtype=torch.float32),
            weight_decay=weight_decay or 0.0, b1=b1, b2=b2, eps=eps)


def make_optimizer(cfg: MaskBevConfig, steps_per_epoch: int = 1000
                   ) -> Optimizer:
    """The optimizer of ``cfg`` (``make_optimizer`` of the JAX package)."""
    scaling = cfg.differential_lr_scaling
    return Optimizer(
        cfg.optimiser_type, lr_schedule(cfg, steps_per_epoch),
        weight_decay=cfg.weight_decay, grad_clip_norm=cfg.grad_clip_norm,
        lr_mult=((lambda name: scaling if name.startswith("backbone.")
                  else 1.0) if cfg.differential_lr else None),
        frozen=(lambda name: is_frozen(cfg, name))
        if cfg.backbone_frozen_stages >= 0 else None,
        leaf=lambda name: stacked_leaf(cfg, name))


@dataclasses.dataclass
class PlateauState:
    """Host-side ReduceLROnPlateau (torch semantics: factor 0.1, patience
    10), as the JAX package's; :meth:`update` returns the new scale, which
    the trainer writes to ``TrainState.lr_scale``."""

    factor: float = 0.1
    patience: int = 10
    min_scale: float = 1e-4
    best: float = float("inf")
    bad_epochs: int = 0
    scale: float = 1.0

    def update(self, metric: float) -> float:
        if metric < self.best - 1e-8:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad_epochs = 0
        return self.scale
