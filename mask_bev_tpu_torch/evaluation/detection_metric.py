"""Online metric accumulators (host-side numpy).

The port's own copy of ``mask_bev_tpu/evaluation/detection_metric.py``
(numpy only).

Rebuild of reference ``evaluation/detection_metric.py:10-111`` without
torchmetrics: same update/compute/reset API, plain numpy state. Cross-host
reduction (the reference's ``dist_reduce_fx``) is a ``gather_states`` hook:
states are plain arrays, so multi-host training can allgather and merge.

Includes a COCO-style segmentation mAP (``MaskMeanAveragePrecision``)
standing in for torchmetrics ``MeanAveragePrecision(iou_type='segm')`` used
per decoder layer by the reference (``mask_bev_module.py:85-94``). Matching
and AP follow pycocotools ``COCOeval`` exactly (score-ordered greedy
matching with first-max tie-breaking; 101-recall-point precision lookup via
left ``searchsorted``, zero beyond the attained recall), verified against
hand-computed oracle values in ``tests/test_evaluation.py``. Not modeled
(never binding for this task): COCO area ranges (BEV masks are one range)
and maxDets=100 (the model emits <= num_queries=45 predictions/image).
"""
from __future__ import annotations

import pickle
from typing import Dict, List, Optional

import numpy as np

from mask_bev_tpu_torch.evaluation.average_precision import (
    IntegrationMode, average_precision, batched_mask_iou)

_EPS = 1e-12


class _ListMetric:
    def __init__(self):
        self.reset()

    def reset(self):
        for k in self._state_names():
            setattr(self, k, [])

    def _state_names(self):
        raise NotImplementedError


def _thresholded_binary_ap(scores: np.ndarray, targets: np.ndarray,
                           num_thresholds: int = 11) -> float:
    """torchmetrics binary_average_precision(thresholds=N) semantics."""
    t = np.linspace(0, 1, num_thresholds)
    preds = scores[None, :] >= t[:, None]  # (T, N)
    tp = (preds & (targets[None] == 1)).sum(1).astype(np.float64)
    fp = (preds & (targets[None] == 0)).sum(1).astype(np.float64)
    fn = ((~preds) & (targets[None] == 1)).sum(1).astype(np.float64)
    precision = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 1.0)
    recall = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
    precision = np.concatenate([precision, [1.0]])
    recall = np.concatenate([recall, [0.0]])
    return float(-np.sum(np.diff(recall) * precision[:-1]))


class BinaryClassifMapMetric(_ListMetric):
    """11-threshold binary AP over accumulated scores (ref :10-31)."""

    def _state_names(self):
        return ["y_score", "y_true"]

    def update(self, y_score, y_true):
        self.y_score.append(np.asarray(y_score).reshape(-1))
        self.y_true.append(np.asarray(y_true).reshape(-1))

    def compute(self) -> float:
        if not self.y_score:
            return 0.0
        return _thresholded_binary_ap(
            np.concatenate(self.y_score),
            np.concatenate(self.y_true).astype(np.int64))


class ClassifMapMetric(_ListMetric):
    """Macro multiclass AP at 11 thresholds (ref :34-52)."""

    def __init__(self, num_classes: int = 12):
        self.num_classes = num_classes
        super().__init__()

    def _state_names(self):
        return ["y_score", "y_true"]

    def update(self, y_score, y_true):
        self.y_score.append(np.asarray(y_score).reshape(-1, self.num_classes))
        self.y_true.append(np.asarray(y_true).reshape(-1))

    def compute(self) -> float:
        if not self.y_score:
            return 0.0
        scores = np.concatenate(self.y_score)
        true = np.concatenate(self.y_true).astype(np.int64)
        aps = [
            _thresholded_binary_ap(scores[:, c], (true == c).astype(np.int64))
            for c in range(self.num_classes)
        ]
        return float(np.mean(aps))


class DetectionMapMetric(_ListMetric):
    """Custom AP over accumulated TP flags (ref :54-74)."""

    def __init__(self, integration_mode=IntegrationMode.InterpolationPASCAL):
        self.integration_mode = integration_mode
        super().__init__()

    def _state_names(self):
        return ["confidences", "is_true_positive", "_total_gt"]

    def reset(self):
        super().reset()
        self.total_gt = 0

    def update(self, confidences, is_true_positive, total_gt: int):
        self.confidences.append(np.asarray(confidences).reshape(-1))
        self.is_true_positive.append(np.asarray(is_true_positive).reshape(-1))
        self.total_gt += int(total_gt)

    def compute(self) -> float:
        if not self.confidences:
            return 0.0
        return average_precision(
            np.concatenate(self.confidences),
            np.concatenate(self.is_true_positive),
            self.total_gt, self.integration_mode)


class MeanIoU(_ListMetric):
    def _state_names(self):
        return ["ious"]

    def update(self, ious):
        self.ious.append(np.asarray(ious).reshape(-1))

    def compute(self) -> float:
        if not self.ious:
            return 0.0
        cat = np.concatenate(self.ious)
        return float(cat.mean()) if cat.size else 0.0


class MaskArea(_ListMetric):
    """Footprint-completion area bookkeeping (ref :95-111). The reference
    dumps to a hardcoded pickle path in compute(); here the path is an
    argument (documented deviation)."""

    def _state_names(self):
        return ["_dummy"]

    def reset(self):
        self.areas: Dict = {}

    def update(self, target_masks, pred_masks, inst):
        tgt = int((np.asarray(target_masks) > 0).sum())
        pred = int((np.asarray(pred_masks) > 0).sum())
        entry = self.areas.setdefault(inst, {"tgt": 0, "pred": 0})
        entry["tgt"] = max(tgt, entry["tgt"])
        entry["pred"] = max(pred, entry["pred"])

    def compute(self, dump_path: Optional[str] = None):
        if dump_path:
            with open(dump_path, "wb") as f:
                pickle.dump(dict(self.areas), f)
        return dict(self.areas)


def _cocoeval_ap(confidences: np.ndarray, is_tp: np.ndarray,
                 total_gt: int) -> float:
    """AP exactly as pycocotools ``COCOeval.accumulate`` computes it: sort
    by score (stable), precision envelope from the right, then look up the
    envelope at 101 recall thresholds with a left ``searchsorted`` — recall
    levels beyond the attained maximum contribute ZERO (no trapezoid ramp,
    unlike the reference's own homegrown ``InterpolationCOCO`` mode, which
    this class does not use because it stands in for torchmetrics)."""
    if total_gt <= 0:
        return 0.0
    confidences = np.asarray(confidences, np.float64)
    is_tp = np.asarray(is_tp, np.float64)
    if confidences.size == 0:
        return 0.0
    order = np.argsort(-confidences, kind="stable")
    tp = is_tp[order]
    cum_tp = np.cumsum(tp)
    recalls = cum_tp / total_gt
    precisions = cum_tp / np.arange(1, len(tp) + 1)
    envelope = np.maximum.accumulate(precisions[::-1])[::-1]
    rec_thrs = np.linspace(0.0, 1.0, 101)
    idx = np.searchsorted(recalls, rec_thrs, side="left")
    ok = idx < len(envelope)
    q = np.zeros(101)
    q[ok] = envelope[idx[ok]]
    return float(q.mean())


class MaskMeanAveragePrecision:
    """COCO-style segm mAP over accumulated (pred, target) image pairs.

    Accumulates per-image (scores, labels, gt labels, pred x gt IoU matrix) —
    callers that already have device-computed IoUs (the train metric bank)
    feed them directly via :meth:`update_from_ious`; the mask-based
    :meth:`update` derives the IoUs here.
    """

    IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)

    def __init__(self):
        self.reset()

    def reset(self):
        self._images: List[dict] = []

    def update_from_ious(self, pred_scores, pred_labels, gt_labels, ious):
        """One image: scores (P,), labels (P,), gt_labels (G,), ious (P, G)."""
        self._images.append(dict(
            ps=np.asarray(pred_scores, np.float64).reshape(-1),
            pl=np.asarray(pred_labels, np.int64).reshape(-1),
            gl=np.asarray(gt_labels, np.int64).reshape(-1),
            ious=np.asarray(ious, np.float64),
        ))

    def update(self, pred_masks, pred_scores, pred_labels,
               gt_masks, gt_labels):
        """One image: pred_masks (P, H, W) bool, scores (P,), labels (P,);
        gt_masks (G, H, W) bool, gt_labels (G,)."""
        pm = np.asarray(pred_masks, bool)
        gm = np.asarray(gt_masks, bool)
        pf = pm.reshape(pm.shape[0], -1).astype(np.float64)
        gf = gm.reshape(gm.shape[0], -1).astype(np.float64)
        inter = pf @ gf.T
        union = pf.sum(-1)[:, None] + gf.sum(-1)[None, :] - inter
        ious = inter / (union + _EPS)
        self.update_from_ious(pred_scores, pred_labels, gt_labels, ious)

    def _match_all(self) -> dict:
        """Greedy score-order matching for every class at ALL IoU thresholds
        in one pass (torchmetrics/COCOeval semantics): each detection takes
        the available same-class gt of highest IoU >= threshold. Ties break
        to the LAST gt index — COCOeval's gt scan skips only on strictly
        SMALLER IoU (``if ious[dind,gind] < iou: continue``, pycocotools
        cocoeval.py ``evaluateImg``), so an equal IoU still updates the
        match and the final gt of the tie wins. Vectorized over the
        threshold axis — the
        per-detection loop is the only python loop, so an epoch-end compute
        stays O(total detections) host-side.

        Returns {cls: (confs (D,), tps (T, D), total_gt)}.
        """
        ts = self.IOU_THRESHOLDS
        nt = len(ts)
        classes = sorted(set(np.concatenate(
            [img["gl"] for img in self._images] or [np.array([], np.int64)]
        ).tolist()))
        out = {}
        for cls in classes:
            total_gt = 0
            confs, tps = [], []
            for img in self._images:
                pi = img["pl"] == cls
                gi = img["gl"] == cls
                ps = img["ps"][pi]
                ious = img["ious"][pi][:, gi]
                g = ious.shape[1]
                total_gt += int(gi.sum())
                if ps.size == 0:
                    continue
                order = np.argsort(-ps, kind="stable")
                confs.append(ps[order])
                if g == 0:
                    tps.append(np.zeros((nt, ps.size)))
                    continue
                taken = np.zeros((nt, g), bool)
                tp = np.zeros((nt, ps.size))
                for di, d in enumerate(order):
                    masked = np.where(taken, -1.0, ious[d][None, :])  # (T, G)
                    # LAST gt index among ties (COCOeval updates on >=)
                    best_g = (g - 1) - np.argmax(masked[:, ::-1], axis=1)
                    best_iou = masked[np.arange(nt), best_g]
                    hit = best_iou >= ts
                    taken[hit, best_g[hit]] = True
                    tp[:, di] = hit
                tps.append(tp)
            if total_gt == 0:
                continue
            out[cls] = (
                np.concatenate(confs) if confs else np.zeros(0),
                np.concatenate(tps, axis=1) if tps else np.zeros((nt, 0)),
                total_gt)
        return out

    def _ap_per_threshold(self) -> np.ndarray:
        """(T,) mean-over-classes AP at each IoU threshold."""
        matches = self._match_all()
        nt = len(self.IOU_THRESHOLDS)
        if not matches:
            return np.zeros(nt)
        aps = np.array([
            [_cocoeval_ap(confs, tps[t], total_gt) for t in range(nt)]
            for confs, tps, total_gt in matches.values()])
        return aps.mean(axis=0)

    def compute(self) -> float:
        if not self._images:
            return 0.0
        return float(self._ap_per_threshold().mean())

    def compute_dict(self) -> dict:
        """torchmetrics-style keys (reference logs map/map_50/map_75,
        ``mask_bev_module.py:228-236``)."""
        if not self._images:
            return {"map": 0.0, "map_50": 0.0, "map_75": 0.0}
        per_t = self._ap_per_threshold()
        ts = [round(float(t), 2) for t in self.IOU_THRESHOLDS]
        return {"map": float(per_t.mean()),
                "map_50": float(per_t[ts.index(0.5)]),
                "map_75": float(per_t[ts.index(0.75)])}
