"""PR-curve average precision + mask IoU variants (numpy).

The port's own copy of ``mask_bev_tpu/evaluation/average_precision.py``
(numpy and scipy).

Rebuild of reference ``evaluation/average_precision.py:17-121``: AP with the
four integration modes (COCO 1001-point interp, PASCAL 11-point, continuous
envelope, raw diff), elementwise mask IoU via min/max, and the rotated-box
mask IoU (mask -> largest connected component -> min-area rectangle ->
rendered box IoU) rebuilt without cv2 on scipy.ndimage labeling + rotating
calipers.
"""
from __future__ import annotations

import enum

import numpy as np
from scipy import ndimage

from mask_bev_tpu_torch.evaluation.min_area_rect import min_area_rect, rect_corners

_EPS = 1e-12


class IntegrationMode(enum.Enum):
    InterpolationCOCO = "coco"
    InterpolationPASCAL = "pascal"
    Continuous = "continuous"
    Diff = "diff"


def average_precision(confidences, is_true_positive, total_gt: int,
                      method: IntegrationMode = IntegrationMode.InterpolationPASCAL
                      ) -> float:
    confidences = np.asarray(confidences, np.float64)
    is_true_positive = np.asarray(is_true_positive, np.float64)
    if confidences.shape != is_true_positive.shape:
        raise ValueError("confidences and is_tp must have the same shape")
    if confidences.size == 0:
        return 0.0

    order = np.argsort(-confidences, kind="stable")
    tp = is_true_positive[order]
    cum_tp = np.cumsum(tp)
    n = len(tp)
    recalls = cum_tp / (total_gt + _EPS)
    precisions = cum_tp / (np.arange(1, n + 1) + _EPS)

    recalls = np.concatenate([[0.0], recalls, [1.0]])
    precisions = np.concatenate([[1.0], precisions, [0.0]])
    # precision envelope
    max_prec = np.maximum.accumulate(precisions[::-1])[::-1]

    if method == IntegrationMode.InterpolationCOCO:
        x = np.linspace(0, 1, 1001)
        return float(np.trapezoid(np.interp(x, recalls, max_prec), x))
    if method == IntegrationMode.InterpolationPASCAL:
        x = np.linspace(0, 1, 101)
        interp = np.interp(x, recalls, max_prec)
        return float(np.sum(interp[::10]) / 11)
    if method == IntegrationMode.Continuous:
        i = np.where(recalls[1:] != recalls[:-1])[0]
        return float(np.sum((recalls[i + 1] - recalls[i]) * max_prec[i + 1]))
    if method == IntegrationMode.Diff:
        return float(np.sum(np.diff(recalls) * precisions[:-1]))
    raise NotImplementedError(method)


def mask_iou(mask1, mask2) -> float:
    m1 = np.asarray(mask1, np.float64)
    m2 = np.asarray(mask2, np.float64)
    inter = np.minimum(m1, m2).sum()
    union = np.maximum(m1, m2).sum()
    return float(inter / (union + _EPS))


def batched_mask_iou(masks1, masks2) -> np.ndarray:
    m1 = np.asarray(masks1, np.float64)
    m2 = np.asarray(masks2, np.float64)
    inter = np.minimum(m1, m2).sum((-2, -1))
    union = np.maximum(m1, m2).sum((-2, -1))
    return inter / (union + _EPS)


def mask_to_min_area_box(mask: np.ndarray, scale=(1.0, 1.0)):
    """Binary mask -> min-area rect of its largest connected component,
    or None for an empty mask. Returns (center, size, angle).

    ``scale`` = (sx, sy) cell size: cell coordinates are scaled BEFORE the
    rect fit, so anisotropic grids get the true metric min-area rect (a
    pixel-space fit scaled afterwards is only exact for square cells)."""
    m = np.asarray(mask) > 0
    if not m.any():
        return None
    lab, n = ndimage.label(m)
    if n > 1:
        sizes = ndimage.sum_labels(m, lab, index=np.arange(1, n + 1))
        comp = 1 + int(np.argmax(sizes))
        m = lab == comp
    ys, xs = np.nonzero(m)
    pts = np.stack([xs * scale[0], ys * scale[1]], -1).astype(np.float64)
    return min_area_rect(pts)


def _render_rect(center, size, angle, shape) -> np.ndarray:
    h, w = shape
    corners = rect_corners(center, size, angle)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    c, s = np.cos(angle), np.sin(angle)
    dx = xx - center[0]
    dy = yy - center[1]
    lx = dx * c + dy * s
    ly = -dx * s + dy * c
    return (np.abs(lx) <= size[0] / 2 + 0.5) & (np.abs(ly) <= size[1] / 2 + 0.5)


def rot_mask_iou(masks1, masks2) -> np.ndarray:
    """Per-pair IoU of min-area-rect fits of two mask stacks (ref :84-121)."""
    m1 = np.asarray(masks1)
    m2 = np.asarray(masks2)
    out = np.zeros(m1.shape[0])
    for i in range(m1.shape[0]):
        r1 = mask_to_min_area_box(m1[i])
        r2 = mask_to_min_area_box(m2[i])
        if r1 is None or r2 is None:
            out[i] = 0.0
            continue
        b1 = _render_rect(*r1, m1[i].shape)
        b2 = _render_rect(*r2, m2[i].shape)
        out[i] = mask_iou(b1, b2)
    return out
