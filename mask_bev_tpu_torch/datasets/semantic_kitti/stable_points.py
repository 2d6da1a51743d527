"""Stable-points side experiment: point clouds only, 80/20 random split.

The port's copy of ``mask_bev_tpu/datasets/semantic_kitti/stable_points.py``.
Rebuild of reference ``semantic_kitti_stable_points_data_module.py:17-58``:
concatenate all splits (train/valid/test), keep only the point clouds, and
re-split 80/20 at random (``np.random.default_rng(seed).permutation``, so
one seed gives the JAX package's split).
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.datasets.semantic_kitti.dataset import (
    SemanticKittiDataset)
from mask_bev_tpu_torch.datasets.semantic_kitti.taxonomy import RawLabel
from mask_bev_tpu_torch.parallel import distributed


class SemanticKittiStablePointsDataModule:
    def __init__(self, root_path: str, cfg: MaskBevConfig, seed: int = 0):
        self.cfg = cfg
        self._datasets: List[SemanticKittiDataset] = []
        for split in ("train", "valid", "test"):
            try:
                ds = SemanticKittiDataset(
                    root_path, split, included_labels=[RawLabel.CAR])
                if len(ds):
                    self._datasets.append(ds)
            except FileNotFoundError:
                continue
        self._lengths = [len(d) for d in self._datasets]
        total = sum(self._lengths)
        rng = np.random.default_rng(seed)
        order = rng.permutation(total)
        cut = int(np.ceil(total * 0.8))
        self.train_indices = order[:cut].tolist()
        self.val_indices = order[cut:].tolist()

    def _get_points(self, global_idx: int) -> np.ndarray:
        for ds, length in zip(self._datasets, self._lengths):
            if global_idx < length:
                return ds[global_idx].point_cloud
            global_idx -= length
        raise IndexError(global_idx)

    def _epoch(self, indices: List[int], shuffle: bool, seed: int
               ) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        order = list(indices)
        if shuffle:
            rng.shuffle(order)
        pos, b = distributed.rank_positions(len(order), self.cfg.batch_size)
        n = self.cfg.max_points_per_scan
        for start in range(0, len(pos), b):
            pts = np.zeros((b, n, self.cfg.pc_point_dim), np.float32)
            mask = np.zeros((b, n), bool)
            for j, p in enumerate(pos[start:start + b]):
                i = order[p]
                pc = self._get_points(i)
                take = min(pc.shape[0], n)
                pts[j, :take] = pc[:take, : self.cfg.pc_point_dim]
                mask[j, :take] = True
            yield {"points": pts, "point_mask": mask}

    def train_batches(self, seed: int = 0):
        return self._epoch(self.train_indices, self.cfg.shuffle_train, seed)

    def val_batches(self, seed: int = 0):
        return self._epoch(self.val_indices, False, seed)
