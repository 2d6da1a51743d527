"""Checkpoints with the reference's best + last semantics.

Port of ``mask_bev_tpu/train/checkpoint.py``: a ``best`` and a ``last``
checkpoint beside an ``index.json`` that maps them to their step, epoch and
validation loss (``best_val_loss``, ``best_step``, ``best_epoch``,
``last_step``, ``last_epoch``) and to the trainer's host state
(``best_meta``, ``last_meta``); ``best`` is kept top-1 on the validation
loss. The format is the port's own (the JAX package writes orbax): one
``torch.save`` file holding the model's ``state_dict`` (parameters and
batch-norm running statistics), the optimizer state and the step, every
tensor on the CPU. A checkpoint is written to a temporary file and moved
into place by ``os.replace``, so a reader never sees half of one.
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Any, Dict, Optional

import torch


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    """``write=False`` keeps the index in memory without writing anything:
    the ranks other than 0 of a process group, whose rank 0 writes."""

    def __init__(self, ckpt_dir: str, write: bool = True):
        self.dir = pathlib.Path(ckpt_dir).absolute()
        self.write = write
        if write:
            self.dir.mkdir(parents=True, exist_ok=True)
        self._index_path = self.dir / "index.json"
        self.index: Dict[str, Any] = (
            json.loads(self._index_path.read_text())
            if self._index_path.exists() else {"best_val_loss": None,
                                               "best_step": None,
                                               "last_step": None})

    def path(self, which: str) -> pathlib.Path:
        """'last' | 'best' -> its file in this directory; any other value
        is taken as a path."""
        if which in ("last", "best"):
            return self.dir / f"{which}.pt"
        return pathlib.Path(which)

    def _write_index(self):
        if not self.write:
            return
        tmp = self.dir / f"index.json.{os.getpid()}.tmp"
        tmp.write_text(json.dumps(self.index, indent=2))
        os.replace(tmp, self._index_path)

    def _save(self, name: str, state: Dict[str, Any]) -> None:
        if not self.write:
            return
        path = self.path(name)
        tmp = self.dir / f"{name}.{os.getpid()}.tmp"
        torch.save(_cpu(state), tmp)
        os.replace(tmp, path)

    def save_last(self, state: Dict[str, Any], step: int, epoch: int,
                  meta: Optional[Dict[str, Any]] = None) -> None:
        self._save("last", state)
        self.index["last_step"] = int(step)
        self.index["last_epoch"] = int(epoch)
        if meta is not None:
            self.index["last_meta"] = meta
        self._write_index()

    def save_best(self, state: Dict[str, Any], step: int, epoch: int,
                  val_loss: float, meta: Optional[Dict[str, Any]] = None
                  ) -> bool:
        """Keep top-1 by validation loss (reference ModelCheckpoint)."""
        best = self.index.get("best_val_loss")
        if best is None or val_loss < best:
            self._save("best", state)
            self.index["best_val_loss"] = float(val_loss)
            self.index["best_step"] = int(step)
            self.index["best_epoch"] = int(epoch)
            if meta is not None:
                self.index["best_meta"] = meta
            self._write_index()
            return True
        return False

    def meta(self, which: str = "last") -> Dict[str, Any]:
        """The trainer's host state saved with a checkpoint (plateau and
        early-stop counters); empty for an external path."""
        return dict(self.index.get(f"{which}_meta") or {})

    def restore(self, which: str = "last") -> Optional[Dict[str, Any]]:
        """which: 'last' | 'best' | a path -> the saved dict (tensors on
        the CPU), or None where there is none."""
        path = self.path(which)
        if not path.exists():
            return None
        return torch.load(path, map_location="cpu", weights_only=True)

    @property
    def has_last(self) -> bool:
        return self.path("last").exists()
