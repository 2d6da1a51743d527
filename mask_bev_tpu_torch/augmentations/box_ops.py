"""Vectorized numpy box utilities for augmentation (host-side).

The port's copy of ``mask_bev_tpu/augmentations/box_ops.py``: equivalents
of the numba-JIT helpers the reference pulls from
mmdet3d (``box_np_ops.{center_to_corner_box2d,points_in_rbbox}``,
``data_augment_utils.{box_collision_test,noise_per_object_v3_}`` used at
reference ``kitti_mask_augmentations.py:10-11,253-332``; SURVEY.md §2.2 N6).
Pure numpy: these run in the host input pipeline, not on the card.

Box convention: 2D rotated rectangles (cx, cy, l, w, yaw); corners CCW.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def center_to_corner_box2d(centers: np.ndarray, dims: np.ndarray,
                           yaws: np.ndarray) -> np.ndarray:
    """(N,2) centers + (N,2) (l,w) + (N,) yaw -> (N,4,2) corners."""
    n = len(yaws)
    half = dims / 2.0  # (N, 2)
    # unit square corners (+-l/2, +-w/2)
    base = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float64)
    local = base[None] * half[:, None, :]  # (N, 4, 2)
    c, s = np.cos(yaws), np.sin(yaws)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], axis=-2)
    return np.einsum("nij,nkj->nki", rot, local) + centers[:, None, :]


def _project(corners: np.ndarray, axes: np.ndarray):
    """corners (N,4,2) onto axes (M,2) -> (N, M, 4) projections."""
    return np.einsum("nkc,mc->nmk", corners, axes)


def box_collision_test(corners_a: np.ndarray,
                       corners_b: np.ndarray) -> np.ndarray:
    """SAT overlap test for rotated rectangles: (N,4,2) x (M,4,2) -> (N,M) bool."""
    n, m = len(corners_a), len(corners_b)
    if n == 0 or m == 0:
        return np.zeros((n, m), bool)

    def axes_of(c):
        e1 = c[:, 1] - c[:, 0]
        e2 = c[:, 3] - c[:, 0]
        ax = np.stack([e1, e2], axis=1)  # (N, 2, 2)
        norm = np.linalg.norm(ax, axis=-1, keepdims=True)
        return ax / np.maximum(norm, 1e-12)

    ax_a = axes_of(corners_a)  # (N, 2, 2)
    ax_b = axes_of(corners_b)  # (M, 2, 2)

    overlap = np.ones((n, m), bool)
    # axes from A
    for k in range(2):
        pa = np.einsum("nkc,nc->nk", corners_a, ax_a[:, k])  # (N, 4)
        pb = np.einsum("mkc,nc->nmk", corners_b, ax_a[:, k])  # (N, M, 4)
        sep = (pb.max(-1) < pa.min(-1)[:, None]) | (pb.min(-1) > pa.max(-1)[:, None])
        overlap &= ~sep
    # axes from B
    for k in range(2):
        pb = np.einsum("mkc,mc->mk", corners_b, ax_b[:, k])  # (M, 4)
        pa = np.einsum("nkc,mc->nmk", corners_a, ax_b[:, k])  # (N, M, 4)
        sep = (pa.max(-1) < pb.min(-1)[None, :]) | (pa.min(-1) > pb.max(-1)[None, :])
        overlap &= ~sep
    return overlap


def points_in_rbbox(points: np.ndarray, centers: np.ndarray, dims: np.ndarray,
                    yaws: np.ndarray, z0: Optional[np.ndarray] = None,
                    heights: Optional[np.ndarray] = None) -> np.ndarray:
    """(P,>=3) points x N boxes -> (P, N) bool membership.

    Boxes are footprint rectangles; if z0/heights given, z in [z0, z0+h]
    (KITTI boxes sit on their bottom face).
    """
    p, n = len(points), len(yaws)
    if p == 0 or n == 0:
        return np.zeros((p, n), bool)
    dx = points[:, None, 0] - centers[None, :, 0]
    dy = points[:, None, 1] - centers[None, :, 1]
    c, s = np.cos(yaws)[None], np.sin(yaws)[None]
    lx = dx * c + dy * s
    ly = -dx * s + dy * c
    inside = (np.abs(lx) <= dims[None, :, 0] / 2) & (np.abs(ly) <= dims[None, :, 1] / 2)
    if z0 is not None and heights is not None and points.shape[1] >= 3:
        z = points[:, 2, None]
        inside &= (z >= z0[None]) & (z <= (z0 + heights)[None])
    return inside


def noise_per_object(
    rng: np.random.Generator,
    centers: np.ndarray,  # (N, 3), modified in place
    dims: np.ndarray,  # (N, 3) (l, w, h)
    yaws: np.ndarray,  # (N,), modified in place
    points: np.ndarray,  # (P, >=3), modified in place
    rot_range: Tuple[float, float] = (-np.pi / 10, np.pi / 10),
    trans_std: Tuple[float, float, float] = (0.25, 0.25, 0.25),
    num_try: int = 100,
) -> None:
    """Per-object pose perturbation with collision rejection.

    Equivalent role to mmdet3d ``noise_per_object_v3_``: each box in turn
    draws up to ``num_try`` (rotation, translation) proposals and applies the
    first that does not collide with any other (current-pose) box; the points
    inside the box move rigidly with it.
    """
    n = len(yaws)
    if n == 0:
        return
    member = points_in_rbbox(points, centers, dims[:, :2], yaws,
                             z0=centers[:, 2], heights=dims[:, 2])
    for i in range(n):
        others = np.delete(np.arange(n), i)
        corners_others = center_to_corner_box2d(
            centers[others, :2], dims[others, :2], yaws[others])
        rots = rng.uniform(rot_range[0], rot_range[1], num_try)
        trans = rng.standard_normal((num_try, 3)) * np.asarray(trans_std)
        for t in range(num_try):
            new_yaw = yaws[i] + rots[t]
            new_center = centers[i] + trans[t]
            corners = center_to_corner_box2d(
                new_center[None, :2], dims[i : i + 1, :2], np.array([new_yaw]))
            if box_collision_test(corners, corners_others).any():
                continue
            # apply: rotate member points about the old box center, translate
            sel = member[:, i]
            if sel.any():
                rel = points[sel, :2] - centers[i, :2]
                c, s = np.cos(rots[t]), np.sin(rots[t])
                points[sel, 0] = rel[:, 0] * c - rel[:, 1] * s + centers[i, 0]
                points[sel, 1] = rel[:, 0] * s + rel[:, 1] * c + centers[i, 1]
                points[sel, :3] += trans[t]
            centers[i] = new_center
            yaws[i] = new_yaw
            break
