"""Training loop: epochs, validation, checkpoints, early stop, logging.

Port of ``mask_bev_tpu/train/loop.py``: the training and eval steps of
``train/step.py`` over host batches (prefetched on a thread), the
per-decoder-layer metric banks on train and val (``train/metrics.py``),
ReduceLROnPlateau on the validation loss (:class:`~mask_bev_tpu_torch.
train.optim.PlateauState`, its scale written to ``TrainState.lr_scale``),
early stop, ``best`` and ``last`` checkpoints (``train/checkpoint.py``),
the first batch's images every epoch (``visualization/bev_viz.py``,
matplotlib) and jsonl metric logging (stdout mirrors the scalars).

``Trainer(cfg, workdir, device="cuda")`` runs on the card unless the caller
asks for the CPU; the kernels run wherever their shapes are taken (the
models' shape predicates), on every device, with no override. The random
draws of epoch ``e`` come from two ``torch.Generator``s on the device, the
training one seeded from ``(cfg.seed + 1, 2 e)`` and the validation one from
``(cfg.seed + 1, 2 e + 1)``: derived, never stored, as the JAX loop's
``fold_in``, so a run resumed from ``last`` draws what an unbroken one
draws. A resume restores the whole train state (parameters, running
statistics, optimizer moments, step, plateau scale) and the host counters.

Data parallel (``parallel/distributed.py``): under a process group of N
ranks, one process a device, each rank's ``Trainer`` takes its own rows of
every global batch of ``cfg.batch_size`` rows (the data modules of
``train_mask_bev_torch.py`` load only those; ``distributed.shard_batch``
cuts a global batch) and runs on the rank's device. The train state starts
as rank 0's on every rank, the steps sum the gradients, the logs and the
losses over the ranks and the metric banks gather every rank's rows, so the
validation loss, the plateau, ``best`` and the early stop decide alike on
every rank. Rank 0 alone logs, dumps images and writes the checkpoints,
the other ranks wait at a barrier after each write; every rank restores.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import pathlib
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.parallel import distributed
from mask_bev_tpu_torch.train.checkpoint import CheckpointManager
from mask_bev_tpu_torch.train.metrics import LayerMetricsBank
from mask_bev_tpu_torch.train.optim import OptState, PlateauState
from mask_bev_tpu_torch.train.step import (
    TrainState, create_train_state, eval_step, fresh_kernel_weights,
    train_step)
from mask_bev_tpu_torch.utils.precision import (
    cast_parameters, full_f32, resolve_dtype)
from mask_bev_tpu_torch.utils.prefetch import prefetch


class MetricLogger:
    def __init__(self, log_dir: str, name: str):
        self.dir = pathlib.Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / f"{name}.metrics.jsonl"
        self._f = open(self.path, "a")

    def log(self, payload: Dict) -> None:
        payload = {k: (float(v) if hasattr(v, "item") or isinstance(v, float)
                       else v) for k, v in payload.items()}
        self._f.write(json.dumps(payload) + "\n")
        self._f.flush()
        scalars = {k: v for k, v in payload.items()
                   if isinstance(v, (int, float))}
        print(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in scalars.items()), flush=True)

    def close(self) -> None:
        self._f.close()


class NullLogger:
    """The logger of the ranks other than 0: writes and prints nothing."""

    def log(self, payload: Dict) -> None:
        pass

    def close(self) -> None:
        pass


def epoch_seed(seed: int, k: int) -> int:
    """A 63-bit generator seed derived from ``(seed, k)``."""
    digest = hashlib.sha256(f"{seed},{k}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def ckpt_state(state: TrainState) -> Dict:
    """What a checkpoint holds: the model's state_dict, the optimizer
    state, the step and the plateau scale."""
    st = state.opt_state
    return {"model": state.model.state_dict(),
            "opt": {"count": st.count, "mu": st.mu, "nu": st.nu},
            "step": state.step, "lr_scale": state.lr_scale}


def load_ckpt_state(state: TrainState, restored: Dict) -> None:
    """Restore :func:`ckpt_state` into ``state`` (on its device)."""
    dev = state.device
    state.model.load_state_dict(restored["model"], strict=True)
    opt = restored["opt"]
    state.opt_state = OptState(
        int(opt["count"]), {k: v.to(dev) for k, v in opt["mu"].items()},
        {k: v.to(dev) for k, v in opt["nu"].items()})
    state.step = int(restored["step"])
    state.lr_scale = float(restored["lr_scale"])


class Trainer:
    def __init__(self, cfg: MaskBevConfig, workdir: str = "runs",
                 device="cuda"):
        self.cfg = cfg
        world = distributed.world_size()
        if cfg.batch_size % world:
            raise distributed.divisibility_error(cfg.batch_size,
                                                 "batch_size", world)
        self.main = distributed.rank() == 0  # logs and writes
        self.workdir = pathlib.Path(workdir) / cfg.name
        self.logger = (MetricLogger(str(self.workdir), cfg.name)
                       if self.main else NullLogger())
        self.ckpt = CheckpointManager(str(self.workdir / "checkpoints"),
                                      write=self.main)
        self.state = create_train_state(cfg, seed=cfg.seed, device=device)
        self.device = self.state.device
        self.plateau = PlateauState()
        self.epoch = 0
        # per-decoder-layer metric banks on both phases
        self.train_metrics = LayerMetricsBank(cfg)
        self.val_metrics = LayerMetricsBank(cfg)

        # resume (reference: checkpoint key 'last' | path): the whole train
        # state and the host counters, so a resumed run continues as an
        # unbroken one would
        if cfg.checkpoint:
            restored = self.ckpt.restore(cfg.checkpoint)
            if restored is not None:
                load_ckpt_state(self.state, restored)
                meta = self.ckpt.meta(
                    cfg.checkpoint if cfg.checkpoint in ("last", "best")
                    else "last")
                self.epoch = int(meta.get(
                    "epoch", self.ckpt.index.get("last_epoch", 0))) + 1
                for f in ("best", "bad_epochs", "scale"):
                    if f"plateau_{f}" in meta:
                        setattr(self.plateau, f, meta[f"plateau_{f}"])
        distributed.replicate_state(self.state)

    def generator(self, k: int) -> torch.Generator:
        """The generator of draw stream ``k`` (2 e: training of epoch e,
        2 e + 1: its validation)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(epoch_seed(self.cfg.seed + 1, k))
        return g

    def _ckpt_meta(self, bad_epochs: int):
        return {"epoch": self.epoch,
                "plateau_best": self.plateau.best,
                "plateau_bad_epochs": self.plateau.bad_epochs,
                "plateau_scale": self.plateau.scale,
                "early_stop_bad_epochs": bad_epochs}

    def _dump_images(self, batch: Dict[str, np.ndarray], outputs) -> None:
        """First-batch images: the encoded pseudo-image, the first backbone
        level, the GT instance map, the predicted masks of the queries whose
        class is not the background."""
        from mask_bev_tpu_torch.visualization import bev_viz

        d = self.workdir / "images"
        d.mkdir(parents=True, exist_ok=True)
        ep = self.epoch
        model = self.state.model
        dtype = resolve_dtype(self.cfg.compute_dtype)
        pts = torch.as_tensor(batch["points"][:1]).to(self.device, dtype)
        pmask = torch.as_tensor(batch["point_mask"][:1]).to(self.device)
        with torch.no_grad(), cast_parameters(model, dtype), \
                full_f32(dtype), fresh_kernel_weights(model):
            enc = model.encoder(pts, pmask, train=False)
            feat0 = model.backbone(enc, train=False)[0]
        # NHWC -> (C, H, W) for the heatmap helpers
        bev_viz.plot_pseudo_image(
            enc[0].float().cpu().numpy().transpose(2, 0, 1),
            path=str(d / f"epoch{ep:04d}_encoded.png"))
        bev_viz.plot_pseudo_image(
            feat0[0].float().cpu().numpy().transpose(2, 0, 1),
            path=str(d / f"epoch{ep:04d}_backbone.png"))
        gt = batch["gt_masks"][0]
        inst = np.zeros(gt.shape[-2:], np.int32)
        for g in range(gt.shape[0]):
            if batch["gt_valid"][0][g]:
                inst[gt[g].astype(bool)] = g + 1
        bev_viz.plot_instance_mask(
            inst, path=str(d / f"epoch{ep:04d}_gt.png"))
        cls = outputs.cls_logits[-1][0].float().cpu().numpy()
        probs = torch.sigmoid(outputs.mask_logits[-1][0].float()).cpu().numpy()
        keep = cls.argmax(-1) != 0  # reference: per-query argmax > 0
        if keep.any():
            bev_viz.plot_query_masks(
                probs[keep], path=str(d / f"epoch{ep:04d}_pred_sig.png"))

    def train_epoch(self, batches: Iterator[Dict],
                    generator: torch.Generator) -> float:
        losses = []
        t0 = time.time()
        # closing the prefetch at a limit stops its thread and closes the
        # source, so a sample_stream's worker pool is terminated
        with contextlib.closing(prefetch(batches)) as stream:
            for i, batch in enumerate(stream):
                if (self.cfg.limit_train_batches is not None
                        and i >= self.cfg.limit_train_batches):
                    break
                self.state, logs, outputs = train_step(self.state, batch,
                                                       generator)
                if self.cfg.compute_train_metrics:
                    self.train_metrics.update(outputs, batch, generator)
                if i == 0 and self.cfg.log_images and self.main:
                    try:
                        self._dump_images(batch, outputs)
                    except Exception as e:  # images must never stop training
                        self.logger.log({"phase": "viz_error",
                                         "error": repr(e)})
                if i % max(self.cfg.log_every_n_step, 1) == 0:
                    loss = float(logs["loss"])
                    losses.append(loss)
                    self.logger.log({
                        "phase": "train", "epoch": self.epoch, "step": i,
                        "loss": loss,
                        "loss_cls": float(logs["loss_cls"]),
                        "loss_mask": float(logs["loss_mask"]),
                        "loss_dice": float(logs["loss_dice"]),
                        **({"loss_height": float(logs["loss_height"])}
                           if "loss_height" in logs else {}),
                        "sec_per_step": (time.time() - t0) / (i + 1),
                    })
        return float(np.mean(losses)) if losses else float("nan")

    def validate(self, batches: Iterator[Dict], generator: torch.Generator,
                 with_metrics: bool = True) -> Dict[str, float]:
        losses = []
        self.val_metrics.reset()
        for i, batch in enumerate(batches):
            if (self.cfg.limit_val_batches is not None
                    and i >= self.cfg.limit_val_batches):
                break
            logs, outputs = eval_step(self.state, batch, generator)
            # the loss stays on the device: one sync an epoch
            losses.append(logs["loss"])
            if with_metrics:
                self.val_metrics.update(outputs, batch, generator)
        if hasattr(batches, "close"):  # a cut epoch's workers end here
            batches.close()
        out = {"val_loss": float(torch.stack(losses).mean())
               if losses else float("nan")}
        if with_metrics:
            out.update(
                {f"val_{k}": v for k, v in self.val_metrics.compute().items()})
        return out

    def fit(self, train_batches_fn: Callable[[int], Iterator[Dict]],
            val_batches_fn: Callable[[int], Iterator[Dict]],
            max_epochs: Optional[int] = None) -> Dict[str, float]:
        max_epochs = max_epochs or self.cfg.max_epochs
        best_val = self.ckpt.index.get("best_val_loss") or float("inf")
        bad_epochs = int(self.ckpt.meta().get("early_stop_bad_epochs", 0))
        last_val: Dict[str, float] = {}
        while self.epoch < max_epochs:
            train_loss = self.train_epoch(
                train_batches_fn(self.cfg.seed + self.epoch),
                self.generator(2 * self.epoch))
            if self.cfg.compute_train_metrics:
                self.logger.log({
                    "phase": "train_metrics", "epoch": self.epoch,
                    **{f"train_{k}": v
                       for k, v in self.train_metrics.compute().items()}})
                self.train_metrics.reset()
            last_val = self.validate(val_batches_fn(0),
                                     self.generator(2 * self.epoch + 1))
            val_loss = last_val["val_loss"]
            self.logger.log({"phase": "val", "epoch": self.epoch,
                             "train_loss": train_loss, **last_val})

            scale = self.plateau.update(val_loss)
            if self.cfg.lr_schedulers_type == "plateau":
                self.state.lr_scale = scale

            if val_loss < best_val:
                best_val = val_loss
                bad_epochs = 0
            else:
                bad_epochs += 1
            state = ckpt_state(self.state)
            meta = self._ckpt_meta(bad_epochs)
            self.ckpt.save_last(state, self.state.step, self.epoch,
                                meta=meta)
            self.ckpt.save_best(state, self.state.step, self.epoch, val_loss,
                                meta=meta)
            distributed.barrier()  # rank 0's files are complete
            if bad_epochs > self.cfg.early_stop_patience:
                self.logger.log({"phase": "early_stop",
                                 "epoch": self.epoch,
                                 "best_val_loss": best_val})
                break
            self.epoch += 1
        return last_val
