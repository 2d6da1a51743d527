"""Rotated-box IoU via polygon clipping: batched torch and host numpy.

The port's copy of ``mask_bev_tpu/ops/rotated_iou.py``. It replaces the
reference's numba.cuda shared-memory kernel (``evaluation/rotate_iou.py:
264-332``) with a Sutherland-Hodgman clip over fixed 8-vertex buffers: clip
quad A by each of quad B's 4 half-planes, track vertex validity masks,
shoelace area at the end.

* The torch half (:func:`rotated_iou_matrix`, :func:`rotated_iou_pair`)
  broadcasts over any leading shape, so an (N, M) grid of pairs is one
  batch of tensor ops (no Python loop over pairs), on whatever device the
  boxes live.
* The numpy half (:func:`rotate_iou_eval`) is the host path the official
  KITTI evaluation uses (``evaluation/kitti_eval.py``), in float64.

Box format: (cx, cy, w, l, angle) — the KITTI-eval convention the reference
kernel consumes (its ``rotate_iou_gpu_eval`` takes [x, y, w, l, ry]).
"""
from __future__ import annotations

import numpy as np
import torch

_MAX_V = 8  # intersection of two convex quads has <= 8 vertices


def box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) -> (..., 4, 2) corners CCW."""
    cx, cy, w, l, a = boxes.unbind(-1)
    c, s = torch.cos(a), torch.sin(a)
    # local corners (+-l/2 along heading, +-w/2 lateral), CCW
    lx = torch.stack([l / 2, -l / 2, -l / 2, l / 2], -1)
    ly = torch.stack([w / 2, w / 2, -w / 2, -w / 2], -1)
    x = cx[..., None] + lx * c[..., None] - ly * s[..., None]
    y = cy[..., None] + lx * s[..., None] + ly * c[..., None]
    return torch.stack([x, y], -1)


def _next_index(valid: torch.Tensor):
    """(index (V,), count (...,), index of each vertex's successor among
    the first ``count`` (..., V))."""
    idx = torch.arange(_MAX_V, device=valid.device)
    count = valid.sum(-1, keepdim=True)
    nxt = torch.where(idx + 1 < count, idx + 1, torch.zeros_like(idx))
    return idx, count, nxt


def _polygon_area(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Shoelace over the first k valid vertices of fixed (..., V, 2)
    buffers -> (...,)."""
    idx, count, nxt = _next_index(valid)
    x, y = pts[..., 0], pts[..., 1]
    terms = x * torch.gather(y, -1, nxt) - torch.gather(x, -1, nxt) * y
    terms = torch.where(idx < count, terms, torch.zeros_like(terms))
    return terms.sum(-1).abs() / 2.0


def _clip_by_halfplane(pts, valid, a, b, c):
    """Clip polygons (fixed (..., V, 2) buffers + (..., V) validity) by the
    half-planes a x + b y + c >= 0 (a, b, c of shape (...,)).

    Classic Sutherland-Hodgman emit rule, done with static shapes: each input
    edge (p -> q) emits up to 2 vertices; the 2V candidate slots are
    compacted with a cumsum scatter (dropped slots go to a spare slot 2V).
    """
    v = _MAX_V
    idx, count, nxt = _next_index(valid)
    p = pts
    q = torch.gather(pts, -2, nxt[..., None].expand_as(pts))
    a, b, c = a[..., None], b[..., None], c[..., None]
    fp = a * p[..., 0] + b * p[..., 1] + c
    fq = a * q[..., 0] + b * q[..., 1] + c
    p_in = fp >= 0
    q_in = fq >= 0
    edge_active = idx < count

    denom = fp - fq
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    t = torch.where(denom.abs() > 1e-12, fp / safe, torch.zeros_like(fp))
    inter = p + t[..., None] * (q - p)

    # per edge: emit p if p_in; emit intersection if p_in != q_in
    emit1 = edge_active & p_in
    emit2 = edge_active & (p_in ^ q_in)
    lead = pts.shape[:-2]
    cand = torch.stack([p, inter], -2).reshape(*lead, 2 * v, 2)
    emit = torch.stack([emit1, emit2], -1).reshape(*lead, 2 * v)

    pos = torch.cumsum(emit.to(torch.int64), -1) - 1
    dest = torch.where(emit, pos, torch.full_like(pos, 2 * v))
    out = pts.new_zeros(*lead, 2 * v + 1, 2)
    out = out.scatter(-2, dest[..., None].expand(*lead, 2 * v, 2), cand)
    new_count = torch.clamp(emit.sum(-1, keepdim=True), max=v)
    return out[..., :v, :], idx < new_count


def rotated_iou_pair(box_a: torch.Tensor, box_b: torch.Tensor
                     ) -> torch.Tensor:
    """IoU of rotated boxes (..., 5) x (..., 5) -> (...,), broadcasting."""
    box_a, box_b = torch.broadcast_tensors(box_a, box_b)
    ca = box_corners(box_a)
    cb = box_corners(box_b)
    lead = ca.shape[:-2]
    pts = torch.cat([ca, ca.new_zeros(*lead, _MAX_V - 4, 2)], -2)
    valid = (torch.arange(_MAX_V, device=ca.device) < 4).expand(
        *lead, _MAX_V)

    # clip by each edge of B (CCW -> interior is left of each edge)
    for i in range(4):
        p0 = cb[..., i, :]
        p1 = cb[..., (i + 1) % 4, :]
        # half-plane: cross(p1-p0, x-p0) >= 0
        a = -(p1[..., 1] - p0[..., 1])
        b = p1[..., 0] - p0[..., 0]
        c = -(a * p0[..., 0] + b * p0[..., 1])
        pts, valid = _clip_by_halfplane(pts, valid, a, b, c)
    inter = _polygon_area(pts, valid)
    area_a = box_a[..., 2] * box_a[..., 3]
    area_b = box_b[..., 2] * box_b[..., 3]
    union = area_a + area_b - inter
    safe = torch.where(union > 1e-12, union, torch.ones_like(union))
    return torch.where(union > 1e-12, inter / safe, torch.zeros_like(inter))


def rotated_iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor
                       ) -> torch.Tensor:
    """(N, 5) x (M, 5) -> (N, M) IoU matrix, on the boxes' device."""
    return rotated_iou_pair(boxes_a[:, None, :], boxes_b[None, :, :])


def _np_box_corners(boxes: np.ndarray) -> np.ndarray:
    cx, cy, w, l, a = (boxes[:, i] for i in range(5))
    c, s = np.cos(a), np.sin(a)
    lx = np.stack([l / 2, -l / 2, -l / 2, l / 2], -1)
    ly = np.stack([w / 2, w / 2, -w / 2, -w / 2], -1)
    x = cx[:, None] + lx * c[:, None] - ly * s[:, None]
    y = cy[:, None] + lx * s[:, None] + ly * c[:, None]
    return np.stack([x, y], -1)


def _np_clip_area(poly_a: np.ndarray, poly_b: np.ndarray) -> float:
    """Sutherland-Hodgman clip of quad A by quad B, shoelace area (numpy)."""
    out = list(poly_a)
    for i in range(4):
        p0, p1 = poly_b[i], poly_b[(i + 1) % 4]
        a = -(p1[1] - p0[1])
        b = p1[0] - p0[0]
        c = -(a * p0[0] + b * p0[1])
        inp, out = out, []
        if not inp:
            return 0.0
        prev = inp[-1]
        fprev = a * prev[0] + b * prev[1] + c
        for cur in inp:
            fcur = a * cur[0] + b * cur[1] + c
            if fcur >= 0:
                if fprev < 0:
                    t = fprev / (fprev - fcur)
                    out.append(prev + t * (cur - prev))
                out.append(cur)
            elif fprev >= 0:
                t = fprev / (fprev - fcur)
                out.append(prev + t * (cur - prev))
            prev, fprev = cur, fcur
    if len(out) < 3:
        return 0.0
    pts = np.asarray(out)
    x, y = pts[:, 0], pts[:, 1]
    return abs(float(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y))) / 2


def rotate_iou_eval(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Host-facing drop-in for the reference's ``rotate_iou_gpu_eval``.

    Pure numpy in float64 (the offline eval's path); use
    :func:`rotated_iou_matrix` for the on-device version.
    """
    na, nb = len(boxes_a), len(boxes_b)
    if na == 0 or nb == 0:
        return np.zeros((na, nb), np.float32)
    boxes_a = np.asarray(boxes_a, np.float64)
    boxes_b = np.asarray(boxes_b, np.float64)
    ca = _np_box_corners(boxes_a)
    cb = _np_box_corners(boxes_b)
    area_a = boxes_a[:, 2] * boxes_a[:, 3]
    area_b = boxes_b[:, 2] * boxes_b[:, 3]
    out = np.zeros((na, nb), np.float64)
    for i in range(na):
        # cheap AABB prefilter
        lo_a, hi_a = ca[i].min(0), ca[i].max(0)
        for j in range(nb):
            if (cb[j][:, 0].max() < lo_a[0] or cb[j][:, 0].min() > hi_a[0]
                    or cb[j][:, 1].max() < lo_a[1] or cb[j][:, 1].min() > hi_a[1]):
                continue
            inter = _np_clip_area(ca[i], cb[j])
            union = area_a[i] + area_b[j] - inter
            out[i, j] = inter / union if union > 1e-12 else 0.0
    return out.astype(np.float32)
