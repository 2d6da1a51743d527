"""Synthetic BEV scenes: rotated-box "cars" with LiDAR-ish point clusters.

The port's own copy of ``mask_bev_tpu/datasets/synthetic.py`` (numpy only):
the same draws in the same order, so the same seed and knobs give the same
arrays. Consistent scan/mask pairs for tests and for driving the training
step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from mask_bev_tpu_torch.config import MaskBevConfig


def rasterize_rotated_box(mask, cx, cy, length, width, yaw, cfg: MaskBevConfig):
    """Analytic half-plane fill of a rotated box footprint into mask (H, W).

    Equivalent role to the reference's cv2.drawContours box rasterization
    (kitti_rasterizer.py:36-58) without cv2: a cell is inside iff its center,
    expressed in the box frame, lies within the half-extents.
    """
    h, w = mask.shape
    ys = (np.arange(h) + 0.5) * cfg.voxel_size + cfg.y_range[0]
    xs = (np.arange(w) + 0.5) * cfg.voxel_size + cfg.x_range[0]
    gx, gy = np.meshgrid(xs, ys)  # (H, W)
    dx, dy = gx - cx, gy - cy
    c, s = np.cos(-yaw), np.sin(-yaw)
    lx = dx * c - dy * s
    ly = dx * s + dy * c
    inside = (np.abs(lx) <= length / 2) & (np.abs(ly) <= width / 2)
    mask[inside] = True
    return mask


@dataclasses.dataclass
class SyntheticScene:
    points: np.ndarray  # (N, D)
    labels: np.ndarray  # (G,) int
    masks: np.ndarray  # (G, H, W) bool
    heights: np.ndarray  # (G,) float
    num_instances: int


def make_scene(rng: np.random.Generator, cfg: MaskBevConfig,
               max_instances: int = 6, noise_points: int = 256,
               points_per_instance: int = 200,
               box_frac: tuple = (0.10, 0.18),
               max_overlap: float = 1.0) -> SyntheticScene:
    """``box_frac`` sets the box length range as a fraction of the scene
    span; ``max_overlap`` < 1 rejection-samples centers so a new box covers
    at most that fraction of any earlier box (easier, less ambiguous scenes
    for the accuracy harness's signal-level runs)."""
    h, w = cfg.grid_hw
    g = int(rng.integers(1, max_instances + 1))
    pts, labels, masks, heights = [], [], [], []
    span_x = cfg.x_range[1] - cfg.x_range[0]
    span_y = cfg.y_range[1] - cfg.y_range[0]
    occupied = np.zeros((h, w), bool)
    for _ in range(g):
        # RNG call order (cx, cy, length, width, yaw, height) is part of the
        # seeded-fixture contract — keep it; overlap retries only resample
        # the center, and only when max_overlap < 1 (opt-in).
        cx = rng.uniform(cfg.x_range[0] + 0.15 * span_x,
                         cfg.x_range[1] - 0.15 * span_x)
        cy = rng.uniform(cfg.y_range[0] + 0.15 * span_y,
                         cfg.y_range[1] - 0.15 * span_y)
        length = rng.uniform(box_frac[0] * span_x, box_frac[1] * span_x)
        width = length * rng.uniform(0.4, 0.6)
        yaw = rng.uniform(-np.pi, np.pi)
        height = rng.uniform(1.2, 2.4)
        m = np.zeros((h, w), bool)
        rasterize_rotated_box(m, cx, cy, length, width, yaw, cfg)
        if max_overlap < 1.0:
            ok = m.any() and (m & occupied).sum() <= max_overlap * m.sum()
            for _try in range(8):
                if ok:
                    break
                cx = rng.uniform(cfg.x_range[0] + 0.15 * span_x,
                                 cfg.x_range[1] - 0.15 * span_x)
                cy = rng.uniform(cfg.y_range[0] + 0.15 * span_y,
                                 cfg.y_range[1] - 0.15 * span_y)
                m[:] = False
                rasterize_rotated_box(m, cx, cy, length, width, yaw, cfg)
                ok = m.any() and (m & occupied).sum() <= max_overlap * m.sum()
            if not ok:
                continue
        if m.sum() < 4:
            continue
        occupied |= m
        # surface-ish points on the box
        t = rng.uniform(-0.5, 0.5, (points_per_instance, 2))
        local = t * np.array([length, width])
        c, s = np.cos(yaw), np.sin(yaw)
        px = cx + local[:, 0] * c - local[:, 1] * s
        py = cy + local[:, 0] * s + local[:, 1] * c
        pz = rng.uniform(0, height, points_per_instance)
        inten = rng.uniform(0, 1, points_per_instance)
        pts.append(np.stack([px, py, pz, inten], -1))
        labels.append(int(rng.integers(0, cfg.head_num_classes)))
        masks.append(m)
        heights.append(height)
    # background clutter
    bx = rng.uniform(cfg.x_range[0], cfg.x_range[1], noise_points)
    by = rng.uniform(cfg.y_range[0], cfg.y_range[1], noise_points)
    bz = rng.uniform(-1, 3, noise_points)
    bi = rng.uniform(0, 1, noise_points)
    pts.append(np.stack([bx, by, bz, bi], -1))

    points = np.concatenate(pts).astype(np.float32)
    rng.shuffle(points)
    if cfg.pc_point_dim < points.shape[1]:
        points = points[:, : cfg.pc_point_dim]
    return SyntheticScene(
        points=points,
        labels=np.array(labels, np.int32),
        masks=(np.stack(masks) if masks else np.zeros((0, h, w), bool)),
        heights=np.array(heights, np.float32),
        num_instances=len(labels),
    )


def make_batch(rng: np.random.Generator, cfg: MaskBevConfig,
               batch_size: Optional[int] = None, **scene_kw) -> Dict[str, np.ndarray]:
    """Padded training batch: points/mask + (labels, masks, valid, heights)."""
    b = batch_size or cfg.batch_size
    h, w = cfg.grid_hw
    q = cfg.num_queries
    n = cfg.max_points_per_scan
    batch = {
        "points": np.zeros((b, n, cfg.pc_point_dim), np.float32),
        "point_mask": np.zeros((b, n), bool),
        "gt_labels": np.zeros((b, q), np.int32),
        "gt_masks": np.zeros((b, q, h, w), bool),
        "gt_valid": np.zeros((b, q), bool),
        "gt_heights": np.zeros((b, q), np.float32),
    }
    for i in range(b):
        sc = make_scene(rng, cfg, **scene_kw)
        npts = min(sc.points.shape[0], n)
        batch["points"][i, :npts] = sc.points[:npts]
        batch["point_mask"][i, :npts] = True
        gi = min(sc.num_instances, q)
        batch["gt_labels"][i, :gi] = sc.labels[:gi]
        batch["gt_masks"][i, :gi] = sc.masks[:gi]
        batch["gt_valid"][i, :gi] = True
        batch["gt_heights"][i, :gi] = sc.heights[:gi]
    return batch
