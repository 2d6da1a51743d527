"""Batched inference over padded raw scans (port of
``mask_bev_tpu/inference.py``).

``MaskBevPredictor(cfg, state_dict, device="cuda")`` casts the model per
``cfg.compute_dtype``, runs the ``final_only`` forward, and decodes each
scan by the reference rule: keep queries whose argmax class is not the
background, then threshold their score; ``boxes`` holds the BEV rotated
boxes of the scan's masks in meters (``evaluation/kitti_eval.py::
mask_to_boxes``, largest component -> min-area rectangle).
``MaskBevPredictor.from_checkpoint`` serves a checkpoint that the trainer
wrote (``train/checkpoint.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.evaluation.kitti_eval import mask_to_boxes
from mask_bev_tpu_torch.models.maskbev import MaskBev
from mask_bev_tpu_torch.utils.precision import (
    cast_float_leaves, resolve_device, resolve_dtype)


@dataclasses.dataclass
class ScanPredictions:
    scores: np.ndarray  # (n,) kept-query score
    labels: np.ndarray  # (n,) class index
    masks: np.ndarray  # (n, H/4, W/4) bool
    mask_probs: np.ndarray  # (n, H/4, W/4) float
    boxes: np.ndarray  # (m, 5) BEV rotated boxes in meters (x, y, w, l, yaw)


def pad_points(points: np.ndarray, n: int, dim: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(M, >=dim) cloud -> (n, dim) zero-padded points + (n,) mask; clouds
    longer than ``n`` are cut to their first ``n`` points."""
    m = min(len(points), n)
    out = np.zeros((n, dim), np.float32)
    out[:m] = points[:m, :dim]
    mask = np.zeros((n,), bool)
    mask[:m] = True
    return out, mask


class MaskBevPredictor:
    def __init__(self, cfg: MaskBevConfig, state_dict: Dict[str, torch.Tensor],
                 device="cuda", background_class: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(cfg.compute_dtype)
        self.background_class = background_class
        # every float tensor, batch-norm statistics included, in the compute
        # dtype; the kernels fold batch norm from these values
        model = MaskBev(cfg).to(self.dtype)
        model.load_state_dict(cast_float_leaves(state_dict, self.dtype),
                              strict=True)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, cfg: MaskBevConfig, ckpt_dir: str,
                        which: str = "best", device="cuda"
                        ) -> "MaskBevPredictor":
        """Serve checkpoint ``which`` ('best', 'last' or a path) of
        ``ckpt_dir``: its parameters and running statistics."""
        from mask_bev_tpu_torch.train.checkpoint import CheckpointManager

        restored = CheckpointManager(ckpt_dir).restore(which)
        if restored is None:
            raise FileNotFoundError(f"no '{which}' checkpoint in {ckpt_dir}")
        return cls(cfg, restored["model"], device=device)

    @torch.no_grad()
    def forward(self, points: torch.Tensor, point_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, N, D) points + (B, N) mask -> (class probabilities (B, Q,
        K+1), mask probabilities (B, Q, H/4, W/4)), f32, on the device."""
        out = self.model(points.to(self.device, self.dtype),
                         point_mask.to(self.device), final_only=True)
        return (torch.softmax(out.cls_logits[-1].float(), dim=-1),
                torch.sigmoid(out.mask_logits[-1].float()))

    def predict_batch(self, points: np.ndarray, point_mask: np.ndarray,
                      score_threshold: float = 0.5) -> List[ScanPredictions]:
        cls_t, mask_t = self.forward(torch.as_tensor(points),
                                     torch.as_tensor(point_mask))
        cls_probs = cls_t.cpu().numpy()
        mask_probs = mask_t.cpu().numpy()
        out = []
        for b in range(cls_probs.shape[0]):
            pred_cls = cls_probs[b].argmax(-1)
            keep = np.flatnonzero(pred_cls != self.background_class)
            scores = cls_probs[b][keep, pred_cls[keep]]
            keep = keep[scores >= score_threshold]
            boxes, _, _ = mask_to_boxes(cls_probs[b], mask_probs[b],
                                        self.cfg,
                                        score_threshold=score_threshold)
            out.append(ScanPredictions(
                scores=cls_probs[b][keep, pred_cls[keep]],
                labels=pred_cls[keep],
                masks=mask_probs[b][keep] > 0.5,
                mask_probs=mask_probs[b][keep],
                boxes=boxes))
        return out

    def predict_scan(self, points: np.ndarray,
                     score_threshold: float = 0.5) -> ScanPredictions:
        padded, mask = pad_points(points, self.cfg.max_points_per_scan,
                                  self.cfg.pc_point_dim)
        return self.predict_batch(padded[None], mask[None],
                                  score_threshold)[0]
