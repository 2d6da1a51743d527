"""KITTI GT rasterizer: rotated-box footprints -> BEV instance-id image.

Behavioral rebuild of the reference rasterizer
(``datasets/kitti/kitti_rasterizer.py:36-80``) without cv2, the port's copy
of ``mask_bev_tpu/datasets/kitti/kitti_rasterizer.py``: each car-like
label's footprint polygon is filled analytically (a cell belongs to the box
iff its center, rotated into the box frame, lies within the half-extents)
instead of ``cv2.drawContours``. Pixel-level differences vs cv2 are confined
to the polygon boundary (cv2 rasterizes integer-truncated corners). The
fill and the in-box point counts run in the port's C++ host core
(``native.py``); their numpy twins are :func:`fill_rotated_boxes_img` and
:func:`points_in_boxes_count`.

Mask orientation is (num_voxel_y, num_voxel_x) — i.e. (H, W) rows=y like the
pseudo-image. (The reference's KITTI rasterizer already produced (y, x) while
its SemanticKITTI/Waymo rasterizers produce (x, y) and transpose later
(``kitti_rasterizer.py:39`` vs ``waymo_rasterizer.py:32``); we standardize on
(H=y, W=x) everywhere.)

Deliberate fix (documented deviation): the reference's in-range check
``x_range[0] <= b.location[0] and x_range[1]`` (``kitti_rasterizer.py:46-47``)
truncates to a lower-bound-only test due to a typo; we test the full range.
The upstream ``ObjectRangeFilter`` made the bug mostly unobservable.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from mask_bev_tpu_torch import native
from mask_bev_tpu_torch.datasets.kitti.kitti_dataset import (
    BoxArray, CAR_LIKE, KittiFrame, KittiType)

LABEL_MAPPING = {KittiType.Car: KittiType.Car, KittiType.Van: KittiType.Car,
                 KittiType.Truck: KittiType.Car}


def fill_rotated_boxes(
    centers: np.ndarray,  # (N, 2)
    dims: np.ndarray,  # (N, 2) (length, width)
    yaws: np.ndarray,  # (N,)
    x_range: Tuple[float, float],
    y_range: Tuple[float, float],
    voxel_size: float,
) -> np.ndarray:
    """Vectorized: N rotated boxes -> (N, H, W) bool footprints (cell-center test)."""
    h = int(round((y_range[1] - y_range[0]) / voxel_size))
    w = int(round((x_range[1] - x_range[0]) / voxel_size))
    n = len(yaws)
    if n == 0:
        return np.zeros((0, h, w), bool)
    xs = (np.arange(w) + 0.5) * voxel_size + x_range[0]
    ys = (np.arange(h) + 0.5) * voxel_size + y_range[0]
    gx = xs[None, None, :] - centers[:, 0, None, None]  # (N, 1, W)
    gy = ys[None, :, None] - centers[:, 1, None, None]  # (N, H, 1)
    c = np.cos(yaws)[:, None, None]
    s = np.sin(yaws)[:, None, None]
    lx = gx * c + gy * s  # box-frame longitudinal
    ly = -gx * s + gy * c  # box-frame lateral
    half_l = dims[:, 0, None, None] / 2
    half_w = dims[:, 1, None, None] / 2
    return (np.abs(lx) <= half_l) & (np.abs(ly) <= half_w)


class KittiRasterizer:
    """frame -> {class: (H, W) instance-id image} (0 = background)."""

    def __init__(self, x_range, y_range, z_range, voxel_size,
                 remove_unseen: bool = False, min_points: int = 1):
        self.x_range = tuple(x_range)
        self.y_range = tuple(y_range)
        self.z_range = tuple(z_range)
        self.voxel_size = voxel_size
        self.num_voxel_x = int(round((x_range[1] - x_range[0]) / voxel_size))
        self.num_voxel_y = int(round((y_range[1] - y_range[0]) / voxel_size))
        self.remove_unseen = remove_unseen
        self.min_points = min_points

    def get_mask(self, frame: KittiFrame) -> Dict[KittiType, np.ndarray]:
        out = {KittiType.Car: np.zeros(
            (self.num_voxel_y, self.num_voxel_x), np.int32)}
        keep = np.isin(frame.boxes.types, [int(t) for t in CAR_LIKE])
        boxes = frame.boxes.select(keep)
        if len(boxes) == 0:
            return out
        in_range = (
            (boxes.center[:, 0] >= self.x_range[0])
            & (boxes.center[:, 0] <= self.x_range[1])
            & (boxes.center[:, 1] >= self.y_range[0])
            & (boxes.center[:, 1] <= self.y_range[1])
        )
        if self.remove_unseen and frame.points is not None:
            counts = native.points_in_boxes_count(
                frame.points, boxes.center, boxes.dims, boxes.yaw)
            in_range &= counts >= self.min_points
        # sequential fill: later instances overwrite overlap (ref :56-57);
        # instance id = position in the car-like list + 1
        out[KittiType.Car] = native.fill_rotated_boxes_img(
            self.num_voxel_y, self.num_voxel_x,
            boxes.center[:, :2], boxes.dims[:, :2], boxes.yaw,
            in_range.astype(np.uint8),
            self.x_range[0], self.y_range[0], self.voxel_size)
        return out


def fill_rotated_boxes_img(h: int, w: int, centers: np.ndarray,
                           dims: np.ndarray, yaws: np.ndarray,
                           keep: np.ndarray, x0: float, y0: float,
                           voxel: float) -> np.ndarray:
    """The numpy twin of ``native.fill_rotated_boxes_img``: the (H, W)
    int32 image in which box i (where ``keep``) writes i + 1 over its
    footprint (:func:`fill_rotated_boxes`), later boxes over earlier ones.
    It computes in float64 and the host core in float32, so a cell centre
    within float32 rounding of a box edge may fall apart."""
    foot = fill_rotated_boxes(
        np.asarray(centers), np.asarray(dims), np.asarray(yaws),
        (x0, x0 + w * voxel), (y0, y0 + h * voxel), voxel)
    img = np.zeros((h, w), np.int32)
    for i in range(len(yaws)):
        if keep[i]:
            img[foot[i]] = i + 1
    return img


def points_in_boxes_count(points: np.ndarray, boxes: BoxArray) -> np.ndarray:
    """Count LiDAR points inside each box footprint (z within [cz, cz+h]):
    the numpy twin of ``native.points_in_boxes_count``."""
    n = len(boxes)
    if n == 0 or len(points) == 0:
        return np.zeros((n,), np.int32)
    dx = points[None, :, 0] - boxes.center[:, 0, None]
    dy = points[None, :, 1] - boxes.center[:, 1, None]
    c = np.cos(boxes.yaw)[:, None]
    s = np.sin(boxes.yaw)[:, None]
    lx = dx * c + dy * s
    ly = -dx * s + dy * c
    inside = (
        (np.abs(lx) <= boxes.dims[:, 0, None] / 2)
        & (np.abs(ly) <= boxes.dims[:, 1, None] / 2)
        & (points[None, :, 2] >= boxes.center[:, 2, None])
        & (points[None, :, 2] <= boxes.center[:, 2, None]
           + boxes.dims[:, 2, None])
    )
    return inside.sum(axis=1).astype(np.int32)
