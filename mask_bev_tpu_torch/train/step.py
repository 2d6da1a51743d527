"""The training step (bf16 forward over f32 master weights, deep-supervised
loss, the configuration's optimizer), the eval step and the predict step.

Port of ``mask_bev_tpu/train/step.py:44-142``. :func:`create_train_state`
builds the model with f32 parameters and f32 batch-norm running statistics
on the device (``cuda`` unless the caller asks for the CPU, under a process
group the rank's card; without a card it raises). :func:`train_step` runs, inside
:func:`~mask_bev_tpu_torch.utils.precision.cast_parameters`, the training
forward on the compute-dtype cast of the parameters and the points
(``MaskBev(train=True, final_only=False)``: every head pass), the loss in f32
(``losses.py::maskbev_loss``, the matcher on the card; the height term
from the batch's ``gt_heights`` with ``predict_height``), and the gradients,
which reach the f32 masters through the cast; then the optimizer step. The
running statistics are updated in place by the forward and stay f32.
:func:`eval_step` runs the eval forward with every head pass
(``MaskBev(train=False, final_only=False)``) on the compute-dtype cast and
the loss in f32; :func:`predict_step` the ``final_only`` forward's class
softmax and mask sigmoid.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.losses import maskbev_loss
from mask_bev_tpu_torch.models.mask2former import DecoderOutputs
from mask_bev_tpu_torch.models.maskbev import MaskBev
from mask_bev_tpu_torch.parallel import distributed
from mask_bev_tpu_torch.train.optim import OptState, Optimizer, make_optimizer
from mask_bev_tpu_torch.utils.precision import (
    cast_parameters, full_f32, resolve_device, resolve_dtype)


@dataclasses.dataclass
class TrainState:
    cfg: MaskBevConfig
    model: MaskBev  # f32 masters and f32 running statistics, on ``device``
    optimizer: Optimizer
    opt_state: OptState
    device: torch.device
    step: int = 0
    lr_scale: float = 1.0  # host-driven plateau factor


def create_train_state(cfg: MaskBevConfig,
                       state_dict: Optional[Dict[str, torch.Tensor]] = None,
                       *, seed: int = 0, device="cuda",
                       steps_per_epoch: int = 1000) -> TrainState:
    """Train state from ``state_dict`` (any float dtype; held as f32) or,
    without one, from ``MaskBev.random_state_dict(seed)``;
    ``steps_per_epoch`` sets the length of the cosine and poly
    schedules."""
    dev = resolve_device(distributed.device(device))
    model = MaskBev(cfg)
    sd = model.random_state_dict(seed) if state_dict is None else state_dict
    model.load_state_dict({k: v.float() if v.is_floating_point() else v
                           for k, v in sd.items()}, strict=True)
    model.to(dev)
    opt = make_optimizer(cfg, steps_per_epoch)
    return TrainState(cfg, model, opt,
                      opt.init(dict(model.named_parameters())), dev)


def loss_and_grads(state: TrainState, batch, generator=None, *,
                   coords=None):
    """The step's forward and backward on ``batch`` (``points``,
    ``point_mask``, ``gt_labels``, ``gt_masks``, ``gt_valid``: numpy arrays
    or tensors) -> (logs, outputs, grads by parameter name). Random draws
    (drop path, loss points) come from ``generator``, which lives on the
    state's device; ``coords`` pins the loss points instead (see
    ``losses.maskbev_loss``). Updates the running statistics.

    Under a process group ``batch`` holds the rank's rows of the global
    batch (``coords`` too): the logs and the gradients returned are the
    global ones, summed over the ranks (the gradients in a few flat
    buckets, ``parallel/distributed.py::all_reduce_grads``), and the
    outputs are the rank's."""
    cfg = state.cfg
    dtype = resolve_dtype(cfg.compute_dtype)
    b = _device_batch(state, batch)
    model = state.model
    params = dict(model.named_parameters())
    # the backward too runs in full f32 for an f32 configuration
    with cast_parameters(model, dtype), full_f32(dtype):
        out = model(b["points"].to(dtype), b["point_mask"], train=True,
                    final_only=False, generator=generator)
        total, logs = maskbev_loss(
            out, b["gt_labels"], b["gt_masks"], b["gt_valid"], cfg,
            generator=generator, coords=coords,
            gt_heights=_gt_heights(cfg, b))
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
    grads = distributed.all_reduce_grads(
        {k: torch.zeros_like(p) if g is None else g
         for (k, p), g in zip(params.items(), grads)})
    outputs = DecoderOutputs(*(None if t is None else t.detach()
                               for t in out))
    return (distributed.all_reduce_logs(
        {k: v.detach() for k, v in logs.items()}), outputs, grads)


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


def _gt_heights(cfg: MaskBevConfig, b: Dict[str, torch.Tensor]):
    """The batch's GT heights where the configuration predicts heights
    (JAX :88, :121), else None."""
    return b.get("gt_heights") if cfg.predict_height else None


def _device_batch(state: TrainState, batch) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(state.device) for k, v in batch.items()
            if k != "num_instances"}


@contextlib.contextmanager
def fresh_kernel_weights(model: MaskBev):
    """The eval forward's kernels read kernel-ready copies of the weights
    that each module builds at first use and keeps (``_packed``); the
    optimizer changes the weights in place, so drop the copies before the
    forward (built from the compute-dtype cast) and after it."""
    def forget():
        for m in model.modules():
            if hasattr(m, "_packed"):
                m._packed = None
    forget()
    try:
        yield
    finally:
        forget()


@torch.no_grad()
def eval_step(state: TrainState, batch, generator=None, *, coords=None
              ) -> Tuple[Dict[str, torch.Tensor], DecoderOutputs]:
    """The eval forward (every head pass, the compute-dtype cast of the
    parameters and points) and the f32 loss on ``batch`` -> (logs,
    outputs). Loss points are drawn from ``generator`` or pinned by
    ``coords``, as in :func:`loss_and_grads`; under a process group the
    logs are the global batch's."""
    cfg = state.cfg
    dtype = resolve_dtype(cfg.compute_dtype)
    b = _device_batch(state, batch)
    with cast_parameters(state.model, dtype), full_f32(dtype), \
            fresh_kernel_weights(state.model):
        out = state.model(b["points"].to(dtype), b["point_mask"],
                          train=False, final_only=False)
        _, logs = maskbev_loss(out, b["gt_labels"], b["gt_masks"],
                               b["gt_valid"], cfg, generator=generator,
                               coords=coords, gt_heights=_gt_heights(cfg, b))
    return distributed.all_reduce_logs(logs), out


@torch.no_grad()
def predict_step(state: TrainState, points, point_mask
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final-layer class probabilities (B, Q, K+1) and mask probabilities
    (B, Q, H/4, W/4), f32, of the ``final_only`` eval forward."""
    dtype = resolve_dtype(state.cfg.compute_dtype)
    with cast_parameters(state.model, dtype), full_f32(dtype), \
            fresh_kernel_weights(state.model):
        out = state.model(torch.as_tensor(points).to(state.device, dtype),
                          torch.as_tensor(point_mask).to(state.device),
                          final_only=True)
    return (torch.softmax(out.cls_logits[-1].float(), dim=-1),
            torch.sigmoid(out.mask_logits[-1].float()))
