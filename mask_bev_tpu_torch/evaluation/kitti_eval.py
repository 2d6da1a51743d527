"""Official-style KITTI AP evaluation and the MaskBEV glue, numpy on the host.

The port's copy of ``mask_bev_tpu/evaluation/kitti_eval.py``. It covers the
role of the reference's vendored kitti-object-eval-python port (reference
``evaluation/kitti_eval.py:82-967``): 41 recall-point AP for 2D bbox / BEV /
3D metrics with the official easy/moderate/hard gating (occlusion,
truncation, 2D-box pixel height), the adaptive score-threshold schedule,
and the greedy TP/FP/FN matcher, vectorized across thresholds
(:func:`compute_statistics_multi`). The rotated IoU is the port's numpy
polygon clip (``ops/rotated_iou.py::rotate_iou_eval``).

Conventions: annos dicts mirror the reference
(name/bbox/location/dimensions(l,h,w)/rotation_y/score/alpha/occluded/
truncated); BEV/3D boxes are evaluated in the velodyne frame with z up
(locations (x, y, z), dims (l, w, h), yaw about z). The MaskBEV glue
(:func:`mask_to_boxes`, :func:`boxes_to_annos`, :func:`gt_boxes_to_annos`)
turns predicted BEV masks into scored rotated boxes in meters via the
largest component's min-area rectangle (ref ``mask_to_pred`` :27-45, with
the pixel->meter conversion the reference leaves to the caller).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.evaluation.average_precision import (
    mask_to_min_area_box)
from mask_bev_tpu_torch.ops.rotated_iou import rotate_iou_eval

CLASS_NAMES = ["car", "pedestrian", "cyclist", "van", "person_sitting"]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41


def get_thresholds(scores: np.ndarray, num_gt: int,
                   num_sample_pts: int = N_SAMPLE_PTS) -> np.ndarray:
    """Adaptive score thresholds hitting ~evenly spaced recall points
    (reference :100-120 semantics)."""
    scores = np.sort(scores)[::-1]
    thresholds = []
    current_recall = 0.0
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return np.array(thresholds)


def clean_data(gt_anno: dict, dt_anno: dict, current_class: int,
               difficulty: int):
    """Official gating: 0 = counted, 1 = ignored, -1 = irrelevant
    (reference :122-178)."""
    cls_name = CLASS_NAMES[current_class]
    num_gt = len(gt_anno["name"])
    num_dt = len(dt_anno["name"])
    ignored_gt = np.full(num_gt, -1, np.int64)
    ignored_dt = np.full(num_dt, -1, np.int64)
    num_valid_gt = 0
    for i in range(num_gt):
        name = str(gt_anno["name"][i]).lower()
        if name == cls_name:
            valid = 1
        elif cls_name == "pedestrian" and name == "person_sitting":
            valid = 0
        elif cls_name == "car" and name == "van":
            valid = 0
        else:
            valid = -1
        bbox = gt_anno["bbox"][i]
        height = bbox[3] - bbox[1]
        ignore = (
            gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
            or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
            or height <= MIN_HEIGHT[difficulty]
        )
        if valid == 1 and not ignore:
            ignored_gt[i] = 0
            num_valid_gt += 1
        elif valid == 0 or (ignore and valid == 1):
            ignored_gt[i] = 1
    for i in range(num_dt):
        name = str(dt_anno["name"][i]).lower()
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt[i] = 1
        elif name == cls_name:
            ignored_dt[i] = 0
    return num_valid_gt, ignored_gt, ignored_dt


def image_box_overlap(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """2D axis-aligned IoU (x1,y1,x2,y2): (N,4) x (M,4) -> (N,M)."""
    n, m = len(boxes), len(query)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    lt = np.maximum(boxes[:, None, :2], query[None, :, :2])
    rb = np.minimum(boxes[:, None, 2:], query[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_b = (query[:, 2] - query[:, 0]) * (query[:, 3] - query[:, 1])
    union = area_a[:, None] + area_b[None] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _bev_boxes(anno: dict) -> np.ndarray:
    """annos -> (N, 5) [x, y, w, l, yaw] for the rotated IoU kernel."""
    loc = np.asarray(anno["location"], np.float64).reshape(-1, 3)
    dims = np.asarray(anno["dimensions"], np.float64).reshape(-1, 3)  # (l,h,w)
    rot = np.asarray(anno["rotation_y"], np.float64).reshape(-1)
    return np.stack([loc[:, 0], loc[:, 1], dims[:, 2], dims[:, 0], rot], -1)


def bev_box_overlap(gt_anno: dict, dt_anno: dict) -> np.ndarray:
    return rotate_iou_eval(_bev_boxes(gt_anno), _bev_boxes(dt_anno))


def d3_box_overlap(gt_anno: dict, dt_anno: dict) -> np.ndarray:
    """3D IoU: BEV intersection x vertical overlap (z up, boxes sit on z0)."""
    bev_g, bev_d = _bev_boxes(gt_anno), _bev_boxes(dt_anno)
    iou_bev = rotate_iou_eval(bev_g, bev_d)
    if iou_bev.size == 0:
        return iou_bev
    area_g = bev_g[:, 2] * bev_g[:, 3]
    area_d = bev_d[:, 2] * bev_d[:, 3]
    # recover intersection area from IoU
    inter_bev = iou_bev * (area_g[:, None] + area_d[None]) / (1.0 + iou_bev)
    zg0 = np.asarray(gt_anno["location"], np.float64).reshape(-1, 3)[:, 2]
    zd0 = np.asarray(dt_anno["location"], np.float64).reshape(-1, 3)[:, 2]
    hg = np.asarray(gt_anno["dimensions"], np.float64).reshape(-1, 3)[:, 1]
    hd = np.asarray(dt_anno["dimensions"], np.float64).reshape(-1, 3)[:, 1]
    z_lo = np.maximum(zg0[:, None], zd0[None])
    z_hi = np.minimum((zg0 + hg)[:, None], (zd0 + hd)[None])
    inter_h = np.clip(z_hi - z_lo, 0, None)
    inter = inter_bev * inter_h
    vol_g = area_g * hg
    vol_d = area_d * hd
    union = vol_g[:, None] + vol_d[None] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def compute_statistics(
    overlaps: np.ndarray,  # (num_gt, num_dt)
    gt_ignored: np.ndarray,
    dt_ignored: np.ndarray,
    dt_scores: np.ndarray,
    min_overlap: float,
    score_threshold: float,
    compute_fp: bool = True,
    gt_alphas: np.ndarray = None,
    dt_alphas: np.ndarray = None,
) -> Tuple[int, int, int, float, List[float]]:
    """Greedy matcher (reference ``compute_statistics_jit`` :266-384).

    When alphas are given, also accumulates the AOS orientation similarity
    sum over TPs: sum of (1 + cos(gt_alpha - dt_alpha)) / 2 (reference
    :375-383); callers divide by tp + fp.
    """
    num_gt, num_dt = overlaps.shape
    assigned = np.zeros(num_dt, bool)
    valid_det = (dt_scores >= score_threshold) & (dt_ignored != -1)
    tp = fp = fn = 0
    similarity = 0.0
    matched_scores = []
    for i in range(num_gt):
        if gt_ignored[i] == -1:
            continue
        det_idx = -1
        max_overlap = 0.0
        assigned_ignored = False
        for j in range(num_dt):
            if not valid_det[j] or assigned[j]:
                continue
            ov = overlaps[i, j]
            if ov < min_overlap:
                continue
            if dt_ignored[j] == 0 and (ov > max_overlap or assigned_ignored):
                max_overlap = ov
                det_idx = j
                assigned_ignored = False
            elif dt_ignored[j] == 1 and det_idx == -1:
                det_idx = j
                assigned_ignored = True
        if det_idx == -1:
            if gt_ignored[i] == 0:
                fn += 1
        else:
            assigned[det_idx] = True
            if gt_ignored[i] == 0 and dt_ignored[det_idx] == 0:
                tp += 1
                matched_scores.append(float(dt_scores[det_idx]))
                if gt_alphas is not None and dt_alphas is not None:
                    delta = float(gt_alphas[i]) - float(dt_alphas[det_idx])
                    similarity += (1.0 + np.cos(delta)) / 2.0
    if compute_fp:
        for j in range(num_dt):
            if valid_det[j] and not assigned[j] and dt_ignored[j] == 0:
                fp += 1
    return tp, fp, fn, similarity, matched_scores


def compute_statistics_multi(
    overlaps: np.ndarray,  # (num_gt, num_dt)
    gt_ignored: np.ndarray,
    dt_ignored: np.ndarray,
    dt_scores: np.ndarray,
    min_overlap: float,
    thresholds: np.ndarray,  # (T,)
    gt_alphas: np.ndarray = None,
    dt_alphas: np.ndarray = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """:func:`compute_statistics` vectorized across score thresholds.

    The greedy matcher's state depends on the threshold only through
    ``valid_det``, so one pass over the gts can carry the (T, num_dt)
    assignment state for every threshold at once — this is what makes the
    full-split eval tractable without numba (the reference needed
    ``fused_compute_statistics`` + numba.jit for the same reason, reference
    kitti_eval.py:266,396). Returns (tp, fp, fn, similarity) each (T,).

    Matcher semantics per gt (proved equal to the scalar loop in
    tests/test_torch_port_kitti_eval.py): among valid unassigned candidates with
    ov >= min_overlap, pick the first-wins argmax-overlap NON-ignored det
    if any exists, else the first ignored det; ignored gts consume their
    det but count toward nothing.
    """
    num_gt, num_dt = overlaps.shape
    nt = len(thresholds)
    tp = np.zeros(nt, np.int64)
    fn = np.zeros(nt, np.int64)
    sim = np.zeros(nt, np.float64)
    if num_dt == 0:
        if num_gt:
            fn[:] = int(np.sum(gt_ignored == 0))
        return tp, np.zeros(nt, np.int64), fn, sim

    valid = (dt_scores[None, :] >= np.asarray(thresholds)[:, None]) \
        & (dt_ignored[None, :] != -1)                      # (T, D)
    assigned = np.zeros((nt, num_dt), bool)
    dt_norm = (dt_ignored == 0)[None, :]
    dt_ign1 = (dt_ignored == 1)[None, :]
    rows = np.arange(nt)
    for i in range(num_gt):
        if gt_ignored[i] == -1:
            continue
        reach = overlaps[i][None, :] >= min_overlap
        cand = valid & ~assigned & reach
        cand_n = cand & dt_norm
        has_n = cand_n.any(1)
        # first-wins argmax == the scalar loop's strict '>' update
        ovm = np.where(cand_n, overlaps[i][None, :], -1.0)
        j_n = ovm.argmax(1)
        cand_i = cand & dt_ign1
        has_i = cand_i.any(1)
        j_i = cand_i.argmax(1)                 # first True
        det = np.where(has_n, j_n, np.where(has_i, j_i, -1))
        hit = det >= 0
        assigned[rows[hit], det[hit]] = True
        if gt_ignored[i] == 0:
            fn += ~hit
            is_tp = has_n                      # det normal => counted TP
            tp += is_tp
            if gt_alphas is not None and dt_alphas is not None:
                delta = float(gt_alphas[i]) - dt_alphas[j_n]
                sim += np.where(is_tp, (1.0 + np.cos(delta)) / 2.0, 0.0)
    fp = np.sum(valid & ~assigned & dt_norm, axis=1)
    return tp, fp, fn, sim


def _frame_overlaps(gt: dict, dt: dict, metric: str) -> np.ndarray:
    if metric == "bbox":
        return image_box_overlap(np.asarray(gt["bbox"]).reshape(-1, 4),
                                 np.asarray(dt["bbox"]).reshape(-1, 4))
    if metric == "bev":
        return bev_box_overlap(gt, dt)
    if metric == "3d":
        return d3_box_overlap(gt, dt)
    raise ValueError(metric)


def prepare_overlaps(gt_annos: List[dict], dt_annos: List[dict],
                     metric: str) -> List[np.ndarray]:
    """Per-frame (num_gt, num_dt) overlap matrices for one metric.

    Overlaps depend on neither difficulty nor min_overlap, so callers
    sweeping those (official 3 difficulties, COCO 10-point overlap sweep)
    compute them ONCE per metric (the reference batches this the same way:
    ``calculate_iou_partly`` reference kitti_eval.py:386-460).
    """
    return [_frame_overlaps(gt, dt, metric)
            for gt, dt in zip(gt_annos, dt_annos)]


def eval_class(gt_annos: List[dict], dt_annos: List[dict], current_class: int,
               difficulty: int, metric: str, min_overlap: float,
               compute_aos: bool = False,
               overlaps: Optional[List[np.ndarray]] = None,
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(precision, aos) curves at 41 recall points for one
    (class, difficulty, metric); aos is None unless requested (bbox only,
    reference :593-681). ``overlaps`` optionally injects per-frame matrices
    from :func:`prepare_overlaps` (they are metric-only)."""
    assert len(gt_annos) == len(dt_annos)
    per_frame = []
    total_valid_gt = 0
    for fi, (gt, dt) in enumerate(zip(gt_annos, dt_annos)):
        num_valid, ig_gt, ig_dt = clean_data(gt, dt, current_class, difficulty)
        total_valid_gt += num_valid
        ov = overlaps[fi] if overlaps is not None else _frame_overlaps(
            gt, dt, metric)
        ga = np.asarray(gt.get("alpha", np.zeros(len(ig_gt)))).reshape(-1)
        da = np.asarray(dt.get("alpha", np.zeros(len(ig_dt)))).reshape(-1)
        per_frame.append((ov, ig_gt, ig_dt,
                          np.asarray(dt["score"], np.float64).reshape(-1),
                          ga, da))

    if total_valid_gt == 0:
        return np.zeros(N_SAMPLE_PTS), (
            np.zeros(N_SAMPLE_PTS) if compute_aos else None)

    # thresholds from TP scores at threshold 0
    all_scores = []
    for ov, ig_gt, ig_dt, scores, _, _ in per_frame:
        _, _, _, _, ms = compute_statistics(
            ov, ig_gt, ig_dt, scores, min_overlap, 0.0, compute_fp=False)
        all_scores.extend(ms)
    thresholds = get_thresholds(np.asarray(all_scores), total_valid_gt)

    nt = len(thresholds)
    tp = np.zeros(nt, np.int64)
    fp = np.zeros(nt, np.int64)
    sim = np.zeros(nt, np.float64)
    for ov, ig_gt, ig_dt, scores, ga, da in per_frame:
        a, b, _, s = compute_statistics_multi(
            ov, ig_gt, ig_dt, scores, min_overlap, thresholds,
            gt_alphas=ga if compute_aos else None,
            dt_alphas=da if compute_aos else None)
        tp += a; fp += b; sim += s

    precision = np.zeros(N_SAMPLE_PTS)
    aos = np.zeros(N_SAMPLE_PTS) if compute_aos else None
    denom = tp + fp
    ok = denom > 0
    precision[:nt][ok] = tp[ok] / denom[ok]
    if compute_aos:
        aos[:nt][ok] = sim[ok] / denom[ok]
    # envelope (official: curve[i] = max(curve[i:]))
    for i in range(N_SAMPLE_PTS):
        precision[i] = precision[i:].max()
        if compute_aos:
            aos[i] = aos[i:].max()
    return precision, aos


def get_mAP(precision: np.ndarray) -> float:
    """11-point sampling of the 41-point curve (reference :93-97)."""
    return float(sum(precision[::4]) / 11 * 100)


DEFAULT_MIN_OVERLAPS = {  # (class) -> (bbox, bev, 3d) moderate overlaps
    0: (0.7, 0.7, 0.7),  # car
    1: (0.5, 0.5, 0.5),  # pedestrian
    2: (0.5, 0.5, 0.5),  # cyclist
    3: (0.7, 0.7, 0.7),  # van
    4: (0.5, 0.5, 0.5),  # person_sitting
}


def _annos_have_alpha(dt_annos: List[dict]) -> bool:
    """AOS auto-detection (reference :932-937): the first non-empty dt anno
    decides; alpha == -10 is the 'no orientation' sentinel."""
    for anno in dt_annos:
        alpha = np.asarray(anno.get("alpha", [])).reshape(-1)
        if alpha.shape[0] != 0:
            return alpha[0] != -10
    return False


def get_official_eval_result(gt_annos: List[dict], dt_annos: List[dict],
                             current_classes: Sequence[int] = (0,),
                             difficulties: Sequence[int] = (0, 1, 2)
                             ) -> Dict[str, Dict[str, List[float]]]:
    """{class_name: {metric: [AP per difficulty]}} (reference :802-879).

    When detections carry valid alphas, an 'aos' entry (orientation
    similarity AP on the bbox matching) is included, like the reference's
    compute_aos path.
    """
    compute_aos = _annos_have_alpha(dt_annos)
    out: Dict[str, Dict[str, List[float]]] = {}
    for cls in current_classes:
        name = CLASS_NAMES[cls]
        out[name] = {}
        for metric in ("bbox", "bev", "3d"):
            min_ov = DEFAULT_MIN_OVERLAPS[cls][("bbox", "bev", "3d").index(metric)]
            ovs = prepare_overlaps(gt_annos, dt_annos, metric)
            aps, aoss = [], []
            for diff in difficulties:
                prec, aos = eval_class(
                    gt_annos, dt_annos, cls, diff, metric, min_ov,
                    compute_aos=compute_aos and metric == "bbox",
                    overlaps=ovs)
                aps.append(get_mAP(prec))
                if aos is not None:
                    aoss.append(get_mAP(aos))
            out[name][metric] = aps
            if metric == "bbox" and compute_aos:
                out[name]["aos"] = aoss
    return out


# COCO-style overlap sweep per class: (start, stop, num) — reference
# ``get_coco_eval_result`` class_to_range (:907-915)
COCO_OVERLAP_RANGES = {
    0: (0.5, 0.95, 10),   # car
    1: (0.25, 0.7, 10),   # pedestrian
    2: (0.25, 0.7, 10),   # cyclist
    3: (0.5, 0.95, 10),   # van
    4: (0.25, 0.7, 10),   # person_sitting
}


def get_coco_eval_result(gt_annos: List[dict], dt_annos: List[dict],
                         current_classes: Sequence[int] = (0,),
                         difficulties: Sequence[int] = (0, 1, 2)
                         ) -> Dict[str, Dict[str, List[float]]]:
    """COCO-style AP averaged over an overlap sweep (reference :881-967):
    {class_name: {metric: [AP per difficulty]}}, metrics bbox/bev/3d (+aos
    when detections carry valid alphas)."""
    compute_aos = _annos_have_alpha(dt_annos)
    out: Dict[str, Dict[str, List[float]]] = {}
    for cls in current_classes:
        name = CLASS_NAMES[cls]
        lo, hi, num = COCO_OVERLAP_RANGES[cls]
        overlaps = np.linspace(lo, hi, num)
        out[name] = {}
        for metric in ("bbox", "bev", "3d"):
            ovs = prepare_overlaps(gt_annos, dt_annos, metric)
            aps = np.zeros((len(difficulties), len(overlaps)))
            aoss = np.zeros_like(aps)
            for oi, min_ov in enumerate(overlaps):
                for di, diff in enumerate(difficulties):
                    prec, aos = eval_class(
                        gt_annos, dt_annos, cls, diff, metric, float(min_ov),
                        compute_aos=compute_aos and metric == "bbox",
                        overlaps=ovs)
                    aps[di, oi] = get_mAP(prec)
                    if aos is not None:
                        aoss[di, oi] = get_mAP(aos)
            out[name][metric] = aps.mean(axis=1).tolist()
            if metric == "bbox" and compute_aos:
                out[name]["aos"] = aoss.mean(axis=1).tolist()
    return out


# ---- MaskBEV glue: predicted masks -> scored BEV boxes -> annos ----

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


def synthetic_split(frames: int, seed: int = 0):
    """A synthetic KITTI val split from the seed: (gt annos, dt annos) of
    ``frames`` frames, drawn as ``scripts/time_kitti_eval.py::synth_split``
    draws them (4,071 frames is the full split's scale: ~6.9 labelled Car,
    Van and Pedestrian objects a frame with occlusion, truncation and 2D
    heights; detections are the jittered GT boxes, 85 % of them, plus false
    positives, as mask-derived boxes with the no-orientation alpha)."""
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for _ in range(frames):
        n = int(rng.poisson(6.9))
        centers = np.column_stack([
            rng.uniform(3, 70, n), rng.uniform(-30, 30, n), np.zeros(n)])
        yaws = rng.uniform(-np.pi, np.pi, n)
        dims = np.column_stack([
            rng.uniform(3.2, 4.8, n), rng.uniform(1.5, 2.0, n),
            rng.uniform(1.4, 1.8, n)])
        names = rng.choice(["Car", "Car", "Car", "Van", "Pedestrian"], n)
        occl = rng.choice([0, 0, 1, 2], n)
        trunc = rng.uniform(0, 0.4, n) * (rng.random(n) < 0.3)
        h_px = rng.uniform(20, 120, n)
        bbox = np.column_stack(
            [np.zeros(n), np.zeros(n), np.full(n, 60.0), h_px])
        gts.append(gt_boxes_to_annos(centers, dims, yaws, names,
                                     occluded=occl, truncated=trunc,
                                     bbox=bbox))
        keep = rng.random(n) < 0.85
        c = centers[keep] + rng.normal(0, 0.3, (keep.sum(), 3))
        y = yaws[keep] + rng.normal(0, 0.1, keep.sum())
        nfp = int(rng.poisson(1.5))
        cf = np.column_stack([rng.uniform(3, 70, nfp),
                              rng.uniform(-30, 30, nfp), np.zeros(nfp)])
        yf = rng.uniform(-np.pi, np.pi, nfp)
        cc = np.concatenate([c, cf])
        yy = np.concatenate([y, yf])
        m = len(cc)
        boxes = np.column_stack([cc[:, 0], cc[:, 1], np.full(m, 1.7),
                                 np.full(m, 4.0), yy])
        scores = np.concatenate([rng.uniform(0.5, 1.0, keep.sum()),
                                 rng.uniform(0.05, 0.6, nfp)])
        dts.append(boxes_to_annos(boxes, scores))
    return gts, dts
