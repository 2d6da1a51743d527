"""Predicted BEV masks -> scored rotated boxes -> KITTI annos dicts.

The port's own copy of the MaskBEV glue of
``mask_bev_tpu/evaluation/kitti_eval.py`` (:463-544): ``mask_to_boxes``
(largest-component min-area rectangle in meters, ref ``mask_to_pred``
:27-45), ``boxes_to_annos`` and ``gt_boxes_to_annos`` (numpy only). The
official KITTI AP evaluation of that module is not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.evaluation.average_precision import (
    mask_to_min_area_box)


def mask_to_boxes(cls_probs: np.ndarray, masks: np.ndarray,
                  cfg: MaskBevConfig, score_threshold: float = 0.0,
                  mask_threshold: float = 0.5):
    """Per-query sigmoid masks -> rotated boxes in meters + scores.

    cls_probs: (Q, K+1) softmax scores; masks: (Q, h, w) sigmoid probs at any
    resolution covering the BEV range. A query predicts an object when its
    argmax class is non-background; score = that class prob.
    """
    q, h, w = masks.shape
    sx = (cfg.x_range[1] - cfg.x_range[0]) / w
    sy = (cfg.y_range[1] - cfg.y_range[0]) / h
    boxes, scores, labels = [], [], []
    for i in range(q):
        c = int(np.argmax(cls_probs[i]))
        score = float(cls_probs[i, c])
        # non-background = any class except index 0 ("no object" in the
        # reference's unflipped label convention; see datasets docstrings)
        if c == 0 or score < score_threshold:
            continue
        # rect fit in METERS (scale applied before the fit, so anisotropic
        # grids are exact; a pixel-space fit is only exact for square cells)
        rect = mask_to_min_area_box(masks[i] > mask_threshold, scale=(sx, sy))
        if rect is None:
            continue
        (mcx, mcy), (mw, ml), ang = rect[0], rect[1], rect[2]
        cx = cfg.x_range[0] + mcx + 0.5 * sx
        cy = cfg.y_range[0] + mcy + 0.5 * sy
        boxes.append([cx, cy, ml, mw, ang])  # (x, y, w, l, yaw)
        scores.append(score)
        labels.append(c)
    return (np.asarray(boxes, np.float64).reshape(-1, 5),
            np.asarray(scores), np.asarray(labels, np.int64))


def boxes_to_annos(boxes: np.ndarray, scores: np.ndarray,
                   names: Sequence[str] = None, height: float = 1.6) -> dict:
    """(N,5) BEV boxes + scores -> annos dict (dummy 2D bbox tall enough to
    pass MIN_HEIGHT, like the reference's ``_preds_to_annos`` :66-79)."""
    n = len(scores)
    names = list(names) if names is not None else ["Car"] * n
    loc = np.zeros((n, 3))
    dims = np.zeros((n, 3))
    rot = np.zeros(n)
    if n:
        loc[:, 0] = boxes[:, 0]
        loc[:, 1] = boxes[:, 1]
        dims[:, 0] = boxes[:, 3]  # l
        dims[:, 1] = height  # h
        dims[:, 2] = boxes[:, 2]  # w
        rot = boxes[:, 4]
    return dict(
        name=np.asarray(names), bbox=np.tile([0, 0, 0, 100.0], (n, 1)),
        location=loc, dimensions=dims, rotation_y=rot,
        score=np.asarray(scores, np.float64),
        # masks carry no facing direction: alpha = -10 is the official
        # 'no orientation' sentinel that disables AOS (reference :932-937)
        alpha=np.full(n, -10.0), occluded=np.zeros(n, np.int64),
        truncated=np.zeros(n))


def gt_boxes_to_annos(centers: np.ndarray, dims_lwh: np.ndarray,
                      yaws: np.ndarray, names: Sequence[str],
                      occluded: np.ndarray = None,
                      truncated: np.ndarray = None,
                      bbox: np.ndarray = None) -> dict:
    n = len(yaws)
    dims = np.zeros((n, 3))
    if n:
        dims[:, 0] = dims_lwh[:, 0]
        dims[:, 1] = dims_lwh[:, 2]
        dims[:, 2] = dims_lwh[:, 1]
    return dict(
        name=np.asarray(list(names)),
        bbox=(bbox if bbox is not None else np.tile([0, 0, 0, 100.0], (n, 1))),
        location=np.asarray(centers, np.float64).reshape(-1, 3),
        dimensions=dims,
        rotation_y=np.asarray(yaws, np.float64),
        score=np.zeros(n),
        alpha=np.zeros(n),
        occluded=(occluded if occluded is not None else np.zeros(n, np.int64)),
        truncated=(truncated if truncated is not None else np.zeros(n)))
