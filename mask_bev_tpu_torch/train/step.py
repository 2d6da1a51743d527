"""The training step: bf16 forward over f32 master weights, deep-supervised
loss, AdamW.

Port of ``mask_bev_tpu/train/step.py:44-103``. :func:`create_train_state`
builds the model with f32 parameters and f32 batch-norm running statistics
on the device (``cuda`` unless the caller asks for the CPU; without a card
it raises). :func:`train_step` runs, inside
:func:`~mask_bev_tpu_torch.utils.precision.cast_parameters`, the training
forward on the compute-dtype cast of the parameters and the points
(``MaskBev(train=True, final_only=False)``: every head pass), the loss in f32
(``losses.py::maskbev_loss``, the matcher on the card), and the gradients,
which reach the f32 masters through the cast; then the optimizer step. The
running statistics are updated in place by the forward and stay f32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.losses import maskbev_loss
from mask_bev_tpu_torch.models.mask2former import DecoderOutputs
from mask_bev_tpu_torch.models.maskbev import MaskBev
from mask_bev_tpu_torch.train.optim import Adam, AdamState, make_optimizer
from mask_bev_tpu_torch.utils.precision import (
    cast_parameters, resolve_device, resolve_dtype)


@dataclasses.dataclass
class TrainState:
    cfg: MaskBevConfig
    model: MaskBev  # f32 masters and f32 running statistics, on ``device``
    optimizer: Adam
    opt_state: AdamState
    device: torch.device
    step: int = 0
    lr_scale: float = 1.0  # host-driven plateau factor


def create_train_state(cfg: MaskBevConfig,
                       state_dict: Optional[Dict[str, torch.Tensor]] = None,
                       *, seed: int = 0, device="cuda") -> TrainState:
    """Train state from ``state_dict`` (any float dtype; held as f32) or,
    without one, from ``MaskBev.random_state_dict(seed)``."""
    dev = resolve_device(device)
    model = MaskBev(cfg)
    sd = model.random_state_dict(seed) if state_dict is None else state_dict
    model.load_state_dict({k: v.float() if v.is_floating_point() else v
                           for k, v in sd.items()}, strict=True)
    model.to(dev)
    opt = make_optimizer(cfg)
    return TrainState(cfg, model, opt,
                      opt.init(dict(model.named_parameters())), dev)


def loss_and_grads(state: TrainState, batch, generator=None, *,
                   coords=None):
    """The step's forward and backward on ``batch`` (``points``,
    ``point_mask``, ``gt_labels``, ``gt_masks``, ``gt_valid``: numpy arrays
    or tensors) -> (logs, outputs, grads by parameter name). Random draws
    (drop path, loss points) come from ``generator``, which lives on the
    state's device; ``coords`` pins the loss points instead (see
    ``losses.maskbev_loss``). Updates the running statistics."""
    cfg = state.cfg
    dtype = resolve_dtype(cfg.compute_dtype)
    b = {k: torch.as_tensor(v).to(state.device) for k, v in batch.items()}
    model = state.model
    params = dict(model.named_parameters())
    with cast_parameters(model, dtype):
        out = model(b["points"].to(dtype), b["point_mask"], train=True,
                    final_only=False, generator=generator)
        total, logs = maskbev_loss(
            out, b["gt_labels"], b["gt_masks"], b["gt_valid"], cfg,
            generator=generator, coords=coords)
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    outputs = DecoderOutputs(*(None if t is None else t.detach()
                               for t in out))
    return {k: v.detach() for k, v in logs.items()}, outputs, grads


def train_step(state: TrainState, batch, generator=None, *, coords=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor],
                          DecoderOutputs]:
    """One step (:func:`loss_and_grads`, then the optimizer) -> (state,
    logs, outputs). The state is updated in place and returned."""
    logs, outputs, grads = loss_and_grads(state, batch, generator,
                                          coords=coords)
    state.opt_state = state.optimizer.step(
        dict(state.model.named_parameters()), grads, state.opt_state,
        state.lr_scale)
    state.step += 1
    return state, logs, outputs
