"""KITTI training-sample assembly + data module.

The port's copy of ``mask_bev_tpu/datasets/kitti/kitti_data.py``.

Rebuild of the reference pipeline (``kitti_data_module.py:83-114`` and
``kitti_transforms.py``): frame -> augmentations -> ObjectRangeFilter ->
rasterize -> (labels, masks) padded to ``num_queries`` -> fixed-shape
numpy batch dicts for the training step.

Reference-parity GT convention (see ``kitti_transforms.py:88-104`` and the
commented-out ``LabelMaskToMask2FormerLabel`` at ``kitti_data_module.py:98``):
labels are padded to Q entries; instance i gets label ``type + 1`` (car-like
-> 1), padding keeps label 0 with an empty mask, and ALL Q entries are
treated as valid GT by the loss (the reference never filters them).
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from mask_bev_tpu_torch.augmentations.kitti_augmentations import (
    apply_augmentations, make_kitti_augmentation_list)
from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.datasets.kitti.kitti_dataset import (
    CAR_LIKE, KittiDataset, KittiFrame, KittiOccluded, read_split_ids)
from mask_bev_tpu_torch.datasets.kitti.kitti_rasterizer import KittiRasterizer


def object_range_filter(frame: KittiFrame, x_range, y_range) -> KittiFrame:
    """Drop labels outside the BEV range (ref kitti_transforms.py:199-219)."""
    b = frame.boxes
    keep = (
        (b.center[:, 0] >= x_range[0]) & (b.center[:, 0] <= x_range[1])
        & (b.center[:, 1] >= y_range[0]) & (b.center[:, 1] <= y_range[1])
    )
    frame.boxes = b.select(keep)
    return frame


def difficulty_of(boxes) -> np.ndarray:
    """KITTI easy/moderate/hard per label (ref kitti_transforms.py:163-196).
    1=easy, 2=moderate, 3=hard, 4=other."""
    occ = boxes.occluded
    trunc = boxes.truncated
    out = np.full(len(boxes), 4, np.int32)
    out[(occ == KittiOccluded.LargelyOccluded) & (trunc <= 0.5)] = 3
    out[(occ <= KittiOccluded.PartlyOccluded) & (trunc <= 0.3)] = 2
    out[(occ <= KittiOccluded.FullyVisible) & (trunc < 0.15)] = 1
    return out


def filter_label_difficulty(frame: KittiFrame) -> KittiFrame:
    """Keep only labels passing the difficulty gates (ref :48-78)."""
    d = difficulty_of(frame.boxes)
    frame.boxes = frame.boxes.select(d <= 3)
    return frame


def frame_to_sample(frame: KittiFrame, cfg: MaskBevConfig,
                    rasterizer: KittiRasterizer,
                    rng: Optional[np.random.Generator] = None,
                    augmentations: Optional[List[Callable]] = None,
                    filter_difficulty: bool = False) -> Dict[str, np.ndarray]:
    """One frame -> fixed-shape sample dict (reference-parity GT layout)."""
    if augmentations and rng is not None:
        frame = apply_augmentations(frame, augmentations, rng)
    frame = object_range_filter(frame, cfg.x_range, cfg.y_range)
    if filter_difficulty:
        frame = filter_label_difficulty(frame)

    masks_by_class = rasterizer.get_mask(frame)
    h, w = rasterizer.num_voxel_y, rasterizer.num_voxel_x
    q = cfg.num_queries
    labels = np.zeros((q,), np.int32)
    masks = np.zeros((q, h, w), bool)
    heights = np.zeros((q,), np.float32)
    count = 0
    for cls_type, inst_img in masks_by_class.items():
        instances = np.unique(inst_img)
        instances = instances[instances != 0]
        for inst in instances:
            if count >= q:
                break
            labels[count] = int(cls_type) + 1  # ref kitti_transforms.py:100
            masks[count] = inst_img == inst
            # rounded clipped height (ref kitti_transforms.py:222-226)
            bi = int(inst) - 1
            if bi < len(frame.boxes):
                hgt = frame.boxes.dims[bi, 2]
                heights[count] = float(np.clip(round(hgt * 5) / 5, 1, 3))
            count += 1

    npts = frame.points.shape[0]
    n = cfg.max_points_per_scan
    points = np.zeros((n, cfg.pc_point_dim), np.float32)
    take = min(npts, n)
    points[:take] = frame.points[:take, : cfg.pc_point_dim]
    point_mask = np.zeros((n,), bool)
    point_mask[:take] = True

    return {
        "points": points,
        "point_mask": point_mask,
        "gt_labels": labels,
        "gt_masks": masks,
        # reference-parity: every padded GT row is "valid" (empty mask,
        # label 0) and participates in matching/losses
        "gt_valid": np.ones((q,), bool),
        "gt_heights": heights,
        "num_instances": np.int32(count),
    }


class KittiMaskDataModule:
    """Train/val sample streams over the KITTI object training split.

    Mirrors the reference data module (``kitti_data_module.py:19-114``):
    ``train.txt``/``val.txt`` index files at the dataset root, augmentations
    applied before rasterization, drop_last batching.
    """

    def __init__(self, root_path: str, cfg: MaskBevConfig,
                 filter_difficulty: bool = False,
                 sample_transforms=()):
        from mask_bev_tpu_torch.utils.pipeline import Compose, Identity

        self.cfg = cfg
        self.root = pathlib.Path(root_path).expanduser()
        self.dataset = KittiDataset(str(self.root), "training")
        self.train_ids = read_split_ids(self.root / "train.txt")
        self.val_ids = read_split_ids(self.root / "val.txt")
        self.rasterizer = KittiRasterizer(
            cfg.x_range, cfg.y_range, cfg.z_range, cfg.voxel_size,
            remove_unseen=cfg.remove_unseen, min_points=cfg.min_num_points)
        self.augmentations = make_kitti_augmentation_list(cfg.augmentations)
        self.filter_difficulty = filter_difficulty
        # user-extensible post-assembly hook, composed with the pipeline DSL
        # (the reference wires its datamodules through the same combinators,
        # ref kitti_data_module.py:83-105)
        self.sample_transform = (
            Compose(sample_transforms) if sample_transforms else Identity())

    def sample(self, idx: int, train: bool,
               rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        frame = self.dataset[idx]
        return self.sample_transform(frame_to_sample(
            frame, self.cfg, self.rasterizer,
            rng=rng, augmentations=self.augmentations if train else None,
            filter_difficulty=self.filter_difficulty))

    def _epoch(self, ids: List[int], train: bool, seed: int) -> Iterator[Dict]:
        from mask_bev_tpu_torch.utils.workers import batched, sample_stream

        order = list(ids)
        if train and self.cfg.shuffle_train:
            np.random.default_rng(seed).shuffle(order)
        stream = sample_stream(
            lambda i, rng: self.sample(i, train, rng), order, seed,
            num_workers=self.cfg.num_workers)
        # drop_last batching (ref :108-110)
        yield from batched(stream, self.cfg.batch_size, len(order))

    def train_batches(self, seed: int = 0) -> Iterator[Dict]:
        return self._epoch(self.train_ids, True, seed)

    def val_batches(self, seed: int = 0) -> Iterator[Dict]:
        return self._epoch(self.val_ids, False, seed)
