"""Hyperparameter-search trial pruning at validation boundaries.

Port of ``mask_bev_tpu/utils/prune_callback.py`` (the reference's
``utils/optuna_prune_callback.py`` without a hard optuna dependency): any
object with ``report(value, step)`` and ``should_prune() -> bool`` (optuna's
``Trial`` is one) can stop training after a validation. Under a process
group rank 0 alone reports and decides, and its decision is broadcast, so
every rank stops together (a rank that stopped alone would wait at the
next collective). It is a standalone hook, as in the JAX package: call
:meth:`PruneCallback.on_validation_end` with the validation metrics; the
``Trainer`` does not call it.
"""
from __future__ import annotations

import warnings
from typing import Protocol

from mask_bev_tpu_torch.parallel import distributed


class TrialLike(Protocol):
    def report(self, value: float, step: int) -> None: ...

    def should_prune(self) -> bool: ...


class TrialPruned(Exception):
    pass


class PruneCallback:
    def __init__(self, trial: TrialLike, monitor: str = "val_loss"):
        self.trial = trial
        self.monitor = monitor

    def on_validation_end(self, epoch: int, metrics: dict) -> None:
        """Report ``metrics[monitor]`` for ``epoch`` (rank 0) and raise
        :class:`TrialPruned` on every rank when the trial says so."""
        value = metrics.get(self.monitor)
        if value is None:
            warnings.warn(
                f"metric '{self.monitor}' missing from validation metrics; "
                "cannot report to the trial")
            return
        should_stop = False
        if distributed.rank() == 0:
            self.trial.report(float(value), step=epoch)
            should_stop = bool(self.trial.should_prune())
        should_stop = distributed.broadcast_object(should_stop)
        if should_stop:
            raise TrialPruned(f"Trial was pruned at epoch {epoch}.")
