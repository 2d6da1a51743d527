"""Minimum-area enclosing rectangle of a point set (rotating calipers).

The port's own copy of ``mask_bev_tpu/evaluation/min_area_rect.py``
(numpy only).

cv2-free replacement for the reference's ``cv2.minAreaRect`` usage in mask ->
rotated-box extraction (reference ``evaluation/kitti_eval.py:27-45`` and
``average_precision.py:84-121``; SURVEY.md §2.2 N9). Convex hull via
Andrew's monotone chain, then the classic result that the min-area rectangle
has one side collinear with a hull edge.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def convex_hull(points: np.ndarray) -> np.ndarray:
    """(N, 2) -> hull vertices CCW (M, 2). Handles degenerate N<3."""
    pts = np.unique(points, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and cross2(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def min_area_rect(points: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    """(N, 2) points -> (center (2,), size (2,), angle_rad).

    size = (extent along angle direction, extent orthogonal). Degenerate
    inputs (collinear/single point) return zero-area rects.
    """
    hull = convex_hull(np.asarray(points, np.float64))
    if len(hull) == 1:
        return hull[0], np.zeros(2), 0.0
    if len(hull) == 2:
        d = hull[1] - hull[0]
        ang = float(np.arctan2(d[1], d[0]))
        return (hull[0] + hull[1]) / 2, np.array([np.linalg.norm(d), 0.0]), ang

    edges = np.roll(hull, -1, axis=0) - hull  # (M, 2)
    angles = np.arctan2(edges[:, 1], edges[:, 0])
    best = None
    for ang in np.unique(np.mod(angles, np.pi / 2)):
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([[c, s], [-s, c]])
        proj = hull @ rot.T
        lo, hi = proj.min(0), proj.max(0)
        size = hi - lo
        area = size[0] * size[1]
        if best is None or area < best[0]:
            center_local = (lo + hi) / 2
            center = center_local @ rot  # rot is orthonormal; inverse = transpose
            best = (area, center, size, float(ang))
    _, center, size, ang = best
    return center, size, ang


def rect_corners(center: np.ndarray, size: np.ndarray, angle: float) -> np.ndarray:
    """Rect params -> (4, 2) corners."""
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]])
    half = np.asarray(size) / 2
    base = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]]) * half
    return base @ rot.T + center
