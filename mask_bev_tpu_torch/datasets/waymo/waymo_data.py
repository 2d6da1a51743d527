"""Waymo (converted) dataset: loader, rasterizer, data module.

The port's copy of ``mask_bev_tpu/datasets/waymo/waymo_data.py``.

The reference consumes Waymo through the external ``torch_waymo`` package's
pre-converted frames (reference ``waymo_data_module.py:5,48-85``): TOP lidar
only, ``TYPE_VEHICLE`` labels with ``num_lidar_points_in_box >= min_points``
(``waymo_rasterizer.py:29-45``), 3-dim points (no intensity), GT padded to
``num_queries`` with label = type + 1.

Here frames live in a plain converted layout that any Waymo exporter can
produce (one ``.npz`` per frame under ``<root>/<split>/``; the port's
converter is ``mask_bev_tpu_torch/datasets/waymo/convert.py``):

  points:          (N, >=3) float32 — TOP-lidar first-return points
  box_center:      (M, 3) float32
  box_dims:        (M, 3) float32 — (length, width, height)
  box_heading:     (M,)  float32
  box_type:        (M,)  int32  — waymo Type enum (1 = TYPE_VEHICLE)
  box_num_points:  (M,)  int32  — lidar points in box

Rasterization reuses the analytic rotated-box fill (KITTI path); masks are
(H=y, W=x) like everywhere in this framework (the reference's Waymo masks
are (x, y), see ``waymo_rasterizer.py:32``). ``remove_unseen`` is accepted
and not used, as in the JAX package: the ``min_points`` filter on
``box_num_points`` is the only visibility test.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, Iterator, Optional

import numpy as np

from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.datasets.kitti.kitti_rasterizer import (
    fill_rotated_boxes)
from mask_bev_tpu_torch.parallel import distributed

TYPE_UNKNOWN, TYPE_VEHICLE, TYPE_PEDESTRIAN, TYPE_SIGN, TYPE_CYCLIST = range(5)


@dataclasses.dataclass
class WaymoFrame:
    points: np.ndarray  # (N, >=3)
    box_center: np.ndarray  # (M, 3)
    box_dims: np.ndarray  # (M, 3) (l, w, h)
    box_heading: np.ndarray  # (M,)
    box_type: np.ndarray  # (M,)
    box_num_points: np.ndarray  # (M,)
    frame_id: int = -1


class WaymoDataset:
    """Converted-frame dataset over <root>/<split>/*.npz."""

    def __init__(self, root: str, split: str = "training"):
        self.root = pathlib.Path(root).expanduser() / split
        self.files = sorted(self.root.glob("*.npz"))
        if not self.files:
            raise FileNotFoundError(f"no converted frames under {self.root}")

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> WaymoFrame:
        d = np.load(self.files[idx])
        return WaymoFrame(
            points=d["points"].astype(np.float32),
            box_center=d["box_center"].astype(np.float32),
            box_dims=d["box_dims"].astype(np.float32),
            box_heading=d["box_heading"].astype(np.float32),
            box_type=d["box_type"].astype(np.int32),
            box_num_points=d["box_num_points"].astype(np.int32),
            frame_id=idx,
        )


class WaymoRasterizer:
    """frame -> {type: (H, W) instance-id image}; TYPE_VEHICLE only
    (reference waymo_rasterizer.py:31-47). ``remove_unseen`` is accepted
    and ignored, as the JAX package's rasterizer ignores it."""

    def __init__(self, x_range, y_range, z_range, voxel_size,
                 remove_unseen: bool = False, min_points: int = 1):
        self.x_range = tuple(x_range)
        self.y_range = tuple(y_range)
        self.voxel_size = voxel_size
        self.num_voxel_x = int(round((x_range[1] - x_range[0]) / voxel_size))
        self.num_voxel_y = int(round((y_range[1] - y_range[0]) / voxel_size))
        self.min_points = min_points

    def vehicle_indices(self, frame: WaymoFrame) -> np.ndarray:
        """Rows of the frame's boxes that are rasterized, in order."""
        return np.flatnonzero((frame.box_type == TYPE_VEHICLE)
                              & (frame.box_num_points >= self.min_points))

    def get_mask(self, frame: WaymoFrame) -> Dict[int, np.ndarray]:
        out = {TYPE_VEHICLE: np.zeros(
            (self.num_voxel_y, self.num_voxel_x), np.int32)}
        idxs = self.vehicle_indices(frame)
        if idxs.size == 0:
            return out
        foot = fill_rotated_boxes(
            frame.box_center[idxs, :2], frame.box_dims[idxs, :2],
            frame.box_heading[idxs], self.x_range, self.y_range,
            self.voxel_size)
        img = out[TYPE_VEHICLE]
        for n in range(idxs.size):
            img[foot[n]] = n + 1
        return out


def frame_to_sample(frame: WaymoFrame, cfg: MaskBevConfig,
                    rasterizer: WaymoRasterizer,
                    rng: Optional[np.random.Generator] = None,
                    augmentations=None) -> Dict[str, np.ndarray]:
    """Converted frame -> fixed-shape sample (reference-parity GT layout)."""
    if augmentations and rng is not None:
        from mask_bev_tpu_torch.augmentations.waymo_augmentations import (
            apply_waymo_augmentations)
        frame = apply_waymo_augmentations(frame, augmentations, rng)

    masks_by_type = rasterizer.get_mask(frame)
    h, w = rasterizer.num_voxel_y, rasterizer.num_voxel_x
    q = cfg.num_queries
    labels = np.zeros((q,), np.int32)
    masks = np.zeros((q, h, w), bool)
    heights = np.zeros((q,), np.float32)
    count = 0
    vehicle_idx = rasterizer.vehicle_indices(frame)
    for t, img in masks_by_type.items():
        instances = np.unique(img)
        for inst in instances[instances != 0]:
            if count >= q:
                break
            labels[count] = int(t) + 1  # ref: label = type + 1
            masks[count] = img == inst
            bi = vehicle_idx[int(inst) - 1]
            # Python round on a numpy float: halves go to even
            heights[count] = float(
                np.clip(round(frame.box_dims[bi, 2] * 5) / 5, 1, 3))
            count += 1

    n = cfg.max_points_per_scan
    pts = np.zeros((n, cfg.pc_point_dim), np.float32)
    take = min(frame.points.shape[0], n)
    pts[:take] = frame.points[:take, : cfg.pc_point_dim]
    pmask = np.zeros((n,), bool)
    pmask[:take] = True
    return {
        "points": pts,
        "point_mask": pmask,
        "gt_labels": labels,
        "gt_masks": masks,
        "gt_valid": np.ones((q,), bool),
        "gt_heights": heights,
        "num_instances": np.int32(count),
    }


class WaymoDataModule:
    """Train (``training/``) and val (``validation/``) batch streams over a
    converted root, the samples assembled on ``cfg.num_workers`` processes
    (``utils/workers.py``), drop-last batching."""

    def __init__(self, root: str, cfg: MaskBevConfig):
        from mask_bev_tpu_torch.augmentations.waymo_augmentations import (
            make_waymo_augmentation_list)

        self.cfg = cfg
        self.train_dataset = WaymoDataset(root, "training")
        self.val_dataset = WaymoDataset(root, "validation")
        self.rasterizer = WaymoRasterizer(
            cfg.x_range, cfg.y_range, cfg.z_range, cfg.voxel_size,
            remove_unseen=cfg.remove_unseen, min_points=cfg.min_num_points)
        self.augmentations = make_waymo_augmentation_list(cfg.augmentations)

    def sample(self, ds: WaymoDataset, idx: int, train: bool,
               rng: Optional[np.random.Generator] = None
               ) -> Dict[str, np.ndarray]:
        return frame_to_sample(
            ds[idx], self.cfg, self.rasterizer, rng=rng,
            augmentations=self.augmentations if train else None)

    def _epoch(self, ds: WaymoDataset, train: bool, seed: int) -> Iterator[Dict]:
        from mask_bev_tpu_torch.utils.workers import batched, sample_stream

        order = np.arange(len(ds))
        if train and self.cfg.shuffle_train:
            np.random.default_rng(seed).shuffle(order)
        # the rank's rows of each global batch (all of them without a
        # process group)
        pos, rows = distributed.rank_positions(len(order),
                                               self.cfg.batch_size)
        stream = sample_stream(
            lambda i, rng: self.sample(ds, i, train, rng), order, seed,
            num_workers=self.cfg.num_workers, positions=pos)
        yield from batched(stream, rows, len(pos))

    def train_batches(self, seed: int = 0) -> Iterator[Dict]:
        return self._epoch(self.train_dataset, True, seed)

    def val_batches(self, seed: int = 0) -> Iterator[Dict]:
        return self._epoch(self.val_dataset, False, seed)
