"""Per-decoder-layer online metrics.

Port of ``mask_bev_tpu/train/metrics.py``: for every decoder output, on
train and val, the query -> GT assignment is derived again and feeds
  * binary classification AP of ``evaluated_class`` (its target is
    ``labels == evaluated_class``, the JAX package's completion of the
    reference's binary AP),
  * the mean IoU of the thresholded matched masks against their GT,
  * COCO-style segm mAP (map / map_50 / map_75).

The device part (:func:`make_layer_stats_fn`) runs where the outputs are:
the matcher through ``losses.py::match_costs`` and ``ops/hungarian.py::
match`` (kernel C on the card), the bilinear upsample of the mask logits to
the GT grid (``F.interpolate(..., align_corners=False, antialias=False)``,
which is ``jax.image.resize`` when upsampling), the 0.5 threshold of their
sigmoid and the (B, Q, G) IoU matrices. The host receives small per-query
arrays, queued and flushed every few batches (``_flush``, numpy, as in the
JAX module); under a process group the flush gathers every rank's arrays
first, so each rank computes the metrics of the global batch. The matching points come from an explicit
``torch.Generator``; ``match_coords`` pins them, one (B, P, 2) array per
layer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.evaluation.detection_metric import (
    BinaryClassifMapMetric, MaskMeanAveragePrecision, MeanIoU)
from mask_bev_tpu_torch.losses import match_costs
from mask_bev_tpu_torch.models.mask2former import DecoderOutputs
from mask_bev_tpu_torch.ops.hungarian import match
from mask_bev_tpu_torch.parallel import distributed
from mask_bev_tpu_torch.parallel.distributed import rand_rows


@dataclasses.dataclass
class LayerMetrics:
    cls_ap: BinaryClassifMapMetric
    segm_map: MaskMeanAveragePrecision
    miou: MeanIoU

    @classmethod
    def create(cls) -> "LayerMetrics":
        return cls(BinaryClassifMapMetric(), MaskMeanAveragePrecision(),
                   MeanIoU())

    def reset(self):
        self.cls_ap.reset()
        self.segm_map.reset()
        self.miou.reset()

    def compute(self) -> Dict[str, float]:
        out = {"cls_mAP": self.cls_ap.compute(), "mIoU": self.miou.compute()}
        out.update({f"mask_{k}": v for k, v in
                    self.segm_map.compute_dict().items()})
        return out


def make_layer_stats_fn(cfg: MaskBevConfig, evaluated_class: int = 0):
    """The per-layer device computation shared by all decoder layers:
    (cls_logits (B, Q, K+1), mask_logits (B, Q, h, w), gt_labels, gt_masks
    (B, G, H, W), gt_valid, match_coords (B, P, 2)) -> (class
    probabilities, matched (B, Q), gt_of_query (B, Q), IoUs (B, Q, G), IoU
    of each query with its matched GT (B, Q))."""

    @torch.no_grad()
    def layer_stats(cls_logits, mask_logits, gt_labels, gt_masks, gt_valid,
                    match_coords):
        b, q = cls_logits.shape[:2]
        h, w = gt_masks.shape[-2:]
        costs = match_costs(cls_logits, mask_logits, gt_labels, gt_masks,
                            cfg, match_coords)
        gt_of_query, matched = match(costs, gt_valid.sum(-1))
        probs = torch.softmax(cls_logits.float(), dim=-1)
        logits = F.interpolate(mask_logits.float(), size=(h, w),
                               mode="bilinear", align_corners=False,
                               antialias=False)
        pm = (torch.sigmoid(logits) > 0.5).float().reshape(b, q, h * w)
        gm = gt_masks.float().reshape(b, -1, h * w)
        inter = pm @ gm.transpose(1, 2)
        area_p = pm.sum(-1)
        area_g = gm.sum(-1)
        ious = inter / (area_p[:, :, None] + area_g[:, None, :] - inter
                        + 1e-7)
        iou_matched = torch.gather(
            ious, 2, gt_of_query.long().clamp(min=0)[..., None])[..., 0]
        return probs, matched, gt_of_query, ious, iou_matched

    return layer_stats


def _draw_match_coords(b: int, cfg: MaskBevConfig, generator, device):
    return rand_rows((b, cfg.head_num_points, 2), generator=generator,
                     device=device)


class LayerMetricsBank:
    """One :class:`LayerMetrics` per decoder output, with lazy
    device -> host flushing."""

    def __init__(self, cfg: MaskBevConfig, evaluated_class: int = 0,
                 max_pending_batches: int = 8):
        self.cfg = cfg
        self.evaluated_class = evaluated_class
        self.num_layers = cfg.num_decoder_outputs
        self.layers = {i: LayerMetrics.create()
                       for i in range(self.num_layers)}
        self._stats_fn = make_layer_stats_fn(cfg, evaluated_class)
        self._pending: List = []
        # each pending entry holds (B, Q, G) IoU matrices on the device:
        # flush every few batches to bound them
        self._max_pending = max_pending_batches * self.num_layers

    def reset(self):
        for m in self.layers.values():
            m.reset()
        self._pending.clear()

    def update(self, outputs: DecoderOutputs, batch: Dict[str, np.ndarray],
               generator: Optional[torch.Generator] = None,
               match_coords: Optional[Sequence] = None) -> None:
        """Queue every layer's device stats; no host sync here.
        ``match_coords``: per layer, the pinned (B, P, 2) matching points;
        otherwise drawn from ``generator``, layer by layer."""
        dev = outputs.cls_logits.device
        gt_labels = torch.as_tensor(batch["gt_labels"]).to(dev)
        gt_masks = torch.as_tensor(batch["gt_masks"]).to(dev)
        gt_valid = torch.as_tensor(batch["gt_valid"]).to(dev)
        gt_labels_np = np.asarray(batch["gt_labels"])
        # GT rows entering segm mAP: valid and non-degenerate
        gt_real = np.asarray(batch["gt_valid"]) & (
            np.asarray(batch["gt_masks"]).sum((-2, -1)) > 0)
        b = gt_labels.shape[0]
        for i in range(self.num_layers):
            mc = (_draw_match_coords(b, self.cfg, generator, dev)
                  if match_coords is None
                  else torch.as_tensor(match_coords[i]).to(dev))
            stats = self._stats_fn(
                outputs.cls_logits[i], outputs.mask_logits[i], gt_labels,
                gt_masks, gt_valid, mc)
            self._pending.append((i, stats, gt_labels_np, gt_real))
        if len(self._pending) >= self._max_pending:
            self._flush()

    def _host_pending(self) -> List:
        """The queued stats on the host; under a process group every
        rank's, joined along the batch in rank order (the rows of the
        global batch), so that every rank computes the whole batch's
        metrics (COCO mAP does not split into per-rank parts)."""
        host = [(i, tuple(s.cpu().numpy() for s in stats), gl, gr)
                for i, stats, gl, gr in self._pending]
        if not distributed.active():
            return host
        ranks = distributed.all_gather_object(host)
        return [(e[0],
                 tuple(np.concatenate([r[j][1][t] for r in ranks])
                       for t in range(len(e[1]))),
                 np.concatenate([r[j][2] for r in ranks]),
                 np.concatenate([r[j][3] for r in ranks]))
                for j, e in enumerate(ranks[0])]

    def _flush(self) -> None:
        for i, stats, gt_labels_np, gt_real_np in self._host_pending():
            probs, matched, gt_of_query, ious, iou_matched = stats
            gt_of_query = gt_of_query.astype(np.int64)
            m = self.layers[i]
            b = probs.shape[0]
            nc = self.cfg.head_num_classes
            # cls-AP and mIoU pool over every query of the batch
            labels = np.where(
                matched,
                np.take_along_axis(gt_labels_np, gt_of_query.clip(min=0), 1),
                nc)
            m.cls_ap.update(
                probs[..., self.evaluated_class].ravel(),
                (labels == self.evaluated_class).astype(np.int64).ravel())
            if matched.any():
                m.miou.update(iou_matched[matched])
            # COCO segm mAP matches per image
            pred_cls = probs.argmax(-1)
            pred_score = probs.max(-1)
            keep = pred_cls != self.evaluated_class
            for s in range(b):
                ks, gs = keep[s], gt_real_np[s]
                m.segm_map.update_from_ious(
                    pred_scores=pred_score[s][ks],
                    pred_labels=pred_cls[s][ks],
                    gt_labels=gt_labels_np[s][gs],
                    ious=ious[s][ks][:, gs])
        self._pending.clear()

    def compute(self) -> Dict[str, float]:
        """Reference metric names: mAP_cls_{i}, mAP_{i}_{map*}, mIoU_{i}."""
        self._flush()
        out: Dict[str, float] = {}
        for i, m in self.layers.items():
            vals = m.compute()
            out[f"mAP_cls_{i}"] = vals["cls_mAP"]
            out[f"mIoU_{i}"] = vals["mIoU"]
            for k, v in vals.items():
                if k.startswith("mask_"):
                    out[f"mAP_{i}_{k[5:]}"] = v
        return out


def update_layer_metrics(outputs: DecoderOutputs,
                         batch: Dict[str, np.ndarray],
                         metrics: LayerMetrics, cfg: MaskBevConfig,
                         layer_index: int = -1, evaluated_class: int = 0, *,
                         generator: Optional[torch.Generator] = None,
                         match_coords=None) -> None:
    """Update one :class:`LayerMetrics` for a single decoder layer
    (``match_coords``: that layer's pinned (B, P, 2) points)."""
    bank = LayerMetricsBank(cfg, evaluated_class)
    idx = layer_index % cfg.num_decoder_outputs
    bank.layers[idx] = metrics
    dev = outputs.cls_logits.device
    b = np.asarray(batch["gt_labels"]).shape[0]
    mc = (_draw_match_coords(b, cfg, generator, dev) if match_coords is None
          else torch.as_tensor(match_coords).to(dev))
    stats = bank._stats_fn(
        outputs.cls_logits[idx], outputs.mask_logits[idx],
        torch.as_tensor(batch["gt_labels"]).to(dev),
        torch.as_tensor(batch["gt_masks"]).to(dev),
        torch.as_tensor(batch["gt_valid"]).to(dev), mc)
    gt_real = np.asarray(batch["gt_valid"]) & (
        np.asarray(batch["gt_masks"]).sum((-2, -1)) > 0)
    bank._pending.append((idx, stats, np.asarray(batch["gt_labels"]),
                          gt_real))
    bank._flush()
