"""Hungarian matching and the deep-supervised MaskBEV loss.

Port of ``mask_bev_tpu/losses.py``: GT crops (:99-162), the matching costs
(:165-250: 2 * class + 5 * point-sampled binary CE + 5 * dice), the class
weights (:187), the per-layer losses (:273-387: class CE weighted by class,
sigmoid BCE and dice on uncertainty-sampled points, normalised by the
global count of GT masks) and their sum over all L+1 head passes
(:390-472), with the assignments of all L*B problems solved at once
(``ops/hungarian.py``, kernel C on the card). The loss maths runs in f32.

Random draws come from an explicit ``torch.Generator``, in this order: the
matching points (B, P, 2) of every head pass, then per head pass the
candidate and fill points of the loss's importance sampling. Tests pin
every draw instead: ``match_coords``/``loss_coords`` for one pass
(:func:`layer_losses`), and ``coords``, one ``(match_coords,
loss_coords)`` pair per head pass, for :func:`maskbev_loss`.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.models.mask2former import DecoderOutputs
from mask_bev_tpu_torch.ops.hungarian import match
from mask_bev_tpu_torch.ops.point_sample import (
    point_sample, point_sample_dense, point_sample_dense_per,
    point_sample_per, uncertain_point_coords)

# elements of one chunked dense-sampling intermediate (f32): bounds each
# (chunk, P, H) hat or product tensor to ~192 MB
_CHUNK_BUDGET = 48 * 1024 * 1024


def _largest_divisor_leq(n: int, target: int) -> int:
    for d in range(max(1, min(n, target)), 0, -1):
        if n % d == 0:
            return d
    return 1


def _sample_cfg(cfg: MaskBevConfig) -> Tuple[bool, torch.dtype]:
    dtype = cfg.loss_sample_dtype
    if dtype == "auto":  # follow the model's compute dtype
        dtype = cfg.compute_dtype
    mm = torch.bfloat16 if dtype in ("bfloat16", "bf16") else torch.float32
    return cfg.loss_sample_dense, mm


def _sample_shared(imgs, pts, cfg):
    """(N, H, W) at shared (P, 2) -> (N, P)."""
    dense, mm = _sample_cfg(cfg)
    if not dense:
        return point_sample(imgs, pts)
    n, h, _ = imgs.shape
    chunk = _largest_divisor_leq(pts.shape[0],
                                 max(1, _CHUNK_BUDGET // (max(n, 1) * h)))
    return point_sample_dense(imgs, pts, mm_dtype=mm, chunk=chunk)


def _sample_per(imgs, pts, cfg):
    """(N, H, W) at per-image (N, P, 2) -> (N, P)."""
    dense, mm = _sample_cfg(cfg)
    if not dense:
        return point_sample_per(imgs, pts)
    n, h, _ = imgs.shape
    chunk = _largest_divisor_leq(n, max(1, _CHUNK_BUDGET
                                        // (pts.shape[1] * h)))
    return point_sample_dense_per(imgs, pts, mm_dtype=mm, chunk=chunk)


class MatchResult(NamedTuple):
    gt_of_query: torch.Tensor  # (..., Q) int32, -1 = unmatched
    matched: torch.Tensor  # (..., Q) bool


def gt_crop_size(cfg: MaskBevConfig, gt_hw) -> int:
    """Active GT-crop size, or 0 when off or not smaller than the grid."""
    s = cfg.loss_gt_crop
    if s and s < min(int(gt_hw[0]), int(gt_hw[1])):
        return int(s)
    return 0


def gt_crops(gt_masks: torch.Tensor, crop: int):
    """Square crops of the (B, G, H, W) binary GT masks centred on each
    instance's bbox -> (crops (B, G, S, S) f32, origins (B, G, 2) int32 (oy,
    ox), truncated (B, G) bool: the bbox exceeds the crop). Sampling through
    a crop is exact when the bbox fits it."""
    b, g, h, w = gt_masks.shape
    on = gt_masks > 0
    rows = on.any(-1)
    cols = on.any(-2)

    def span(v, n):
        first = torch.argmax(v.to(torch.uint8), dim=-1)
        last = n - 1 - torch.argmax(v.flip(-1).to(torch.uint8), dim=-1)
        return first, last

    y0, y1 = span(rows, h)
    x0, x1 = span(cols, w)
    oy = torch.clamp(torch.div(y0 + y1 + 1 - crop, 2, rounding_mode="floor"),
                     0, h - crop)
    ox = torch.clamp(torch.div(x0 + x1 + 1 - crop, 2, rounding_mode="floor"),
                     0, w - crop)
    ar = torch.arange(crop, device=gt_masks.device)
    ri = (oy[..., None] + ar)[..., :, None]
    ci = (ox[..., None] + ar)[..., None, :]
    bi = torch.arange(b, device=gt_masks.device)[:, None, None, None]
    gi = torch.arange(g, device=gt_masks.device)[None, :, None, None]
    crops = gt_masks[bi, gi, ri, ci].float()
    truncated = (((y1 - y0 + 1 > crop) | (x1 - x0 + 1 > crop))
                 & on.any(-1).any(-1))
    return (crops, torch.stack([oy, ox], dim=-1).to(torch.int32), truncated)


def crop_local_coords(pts: torch.Tensor, origins: torch.Tensor, gt_hw,
                      s: int) -> torch.Tensor:
    """Normalised full-grid (x, y) coords (..., P, 2) -> coords in the (S,
    S) crops at ``origins`` (..., 2) (oy, ox)."""
    h, w = gt_hw
    scale = torch.tensor([w, h], dtype=pts.dtype, device=pts.device)
    off = origins.flip(-1)[..., None, :].to(pts.dtype)
    return (pts * scale - off) / s


def binary_ce_cost(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Pairwise mean binary CE: (Q, P) logits x (G, P) targets -> (Q, G)."""
    p = pred.shape[-1]
    pos = F.softplus(-pred)
    neg = F.softplus(pred)
    cost = (torch.einsum("...qp,...gp->...qg", pos, gt)
            + torch.einsum("...qp,...gp->...qg", neg, 1.0 - gt))
    return cost / p


def dice_cost(pred: torch.Tensor, gt: torch.Tensor, eps: float = 1.0
              ) -> torch.Tensor:
    """Pairwise naive-dice cost: (Q, P) x (G, P) -> (Q, G)."""
    pr = torch.sigmoid(pred)
    num = 2.0 * torch.einsum("...qp,...gp->...qg", pr, gt)
    den = pr.sum(-1)[..., :, None] + gt.sum(-1)[..., None, :]
    return 1.0 - (num + eps) / (den + eps)


def class_weights(cfg: MaskBevConfig, device="cpu") -> torch.Tensor:
    """Per-class CE weights, the background (last index) down-weighted."""
    k = cfg.head_num_classes
    bg = cfg.head_bg_cls_weight
    w = ([bg] * k + [1.0]) if cfg.head_reverse_class_weights else (
        [1.0] * k + [bg])
    return torch.tensor(w, dtype=torch.float32, device=device)


def match_costs(cls_logits: torch.Tensor, mask_logits: torch.Tensor,
                gt_labels: torch.Tensor, gt_masks: torch.Tensor,
                cfg: MaskBevConfig, match_coords: torch.Tensor,
                gt_crop=None) -> torch.Tensor:
    """(B, Q, G) matching costs of one head pass at the (B, P, 2) points
    ``match_coords``; no gradient (the assignment is discrete)."""
    gt_hw = gt_masks.shape[-2:]
    with torch.no_grad():
        mask_l = mask_logits.float()
        pred_pts = torch.stack([_sample_shared(m, p, cfg) for m, p in
                                zip(mask_l, match_coords)])  # (B, Q, P)
        if gt_crop is not None:
            crops, origins = gt_crop  # (B, G, S, S), (B, G, 2)
            loc = crop_local_coords(match_coords[:, None], origins, gt_hw,
                                    crops.shape[-1])  # (B, G, P, 2)
            gt_pts = torch.stack([_sample_per(c, lc, cfg)
                                  for c, lc in zip(crops, loc)])
        else:
            gtm = gt_masks.to(mask_l.dtype)
            gt_pts = torch.stack([_sample_shared(m, p, cfg) for m, p in
                                  zip(gtm, match_coords)])
        # class scores in the logits' dtype, as the reference takes them
        scores = torch.softmax(cls_logits, dim=-1).float()
        cost_cls = -torch.gather(
            scores, 2, gt_labels.long()[:, None, :].expand(
                -1, scores.shape[1], -1))  # (B, Q, G)
        return (cfg.head_cls_weight * cost_cls
                + cfg.head_mask_weight * binary_ce_cost(pred_pts, gt_pts)
                + cfg.head_dice_weight * dice_cost(pred_pts, gt_pts))


def _draw_match_coords(b: int, cfg: MaskBevConfig, generator, device):
    return torch.rand((b, cfg.head_num_points, 2), generator=generator,
                      device=device)


def layer_losses(cls_logits: torch.Tensor, mask_logits: torch.Tensor,
                 gt_labels: torch.Tensor, gt_masks: torch.Tensor,
                 gt_valid: torch.Tensor, cfg: MaskBevConfig, *,
                 generator=None, match_coords=None, loss_coords=None,
                 gt_crop=None, match_result: Optional[MatchResult] = None
                 ) -> Tuple[Dict[str, torch.Tensor], MatchResult]:
    """Losses of one head pass, normalised by global batch counts.

    ``match_result``: use this assignment instead of solving one here.
    ``match_coords`` (B, P, 2) / ``loss_coords`` (B*Q, P, 2): pinned points;
    otherwise they are drawn from ``generator``."""
    dev = cls_logits.device
    mask_logits = mask_logits.float()
    b, q = cls_logits.shape[:2]
    k = cfg.head_num_classes
    gt_hw = gt_masks.shape[-2:]
    if gt_crop is None and gt_crop_size(cfg, gt_hw):
        gt_crop = gt_crops(gt_masks, gt_crop_size(cfg, gt_hw))[:2]
    if match_result is None:
        if match_coords is None:
            match_coords = _draw_match_coords(b, cfg, generator, dev)
        costs = match_costs(cls_logits, mask_logits, gt_labels, gt_masks,
                            cfg, match_coords, gt_crop)
        mr = MatchResult(*match(costs, gt_valid.sum(-1)))
    else:
        mr = match_result

    num_total_masks = torch.clamp(gt_valid.sum().float(), min=1.0)

    # classification
    safe_gt = mr.gt_of_query.long().clamp(0, gt_labels.shape[1] - 1)
    matched_labels = torch.gather(gt_labels.long(), 1, safe_gt)
    labels = torch.where(mr.matched, matched_labels, k)
    cw = class_weights(cfg, dev)
    logp = torch.log_softmax(cls_logits.float(), dim=-1)
    ce = -torch.gather(logp, 2, labels[..., None])[..., 0]
    w = cw[labels]
    loss_cls = (cfg.head_cls_weight * (ce * w).sum()
                / torch.clamp(w.sum(), min=1e-6))

    # mask + dice on uncertainty-sampled points
    flat_masks = mask_logits.reshape(b * q, *mask_logits.shape[2:])
    dense, _ = _sample_cfg(cfg)
    if loss_coords is None:
        n_over = int(cfg.head_num_points * cfg.head_oversample_ratio)
        # uncertainty values only rank points: bf16 products are enough
        loss_coords = uncertain_point_coords(
            flat_masks.detach(), cfg.head_num_points,
            cfg.head_oversample_ratio, cfg.head_importance_sample_ratio,
            dense=dense, mm_dtype=torch.bfloat16,
            chunk=_largest_divisor_leq(
                b * q, max(1, _CHUNK_BUDGET
                           // (n_over * mask_logits.shape[-2]))),
            generator=generator)
    coords = loss_coords
    pred_pts = _sample_per(flat_masks, coords, cfg)  # (B*Q, P)
    with torch.no_grad():  # targets: matched GT mask (zeros if unmatched)
        if gt_crop is not None:
            crops, origins = gt_crop
            s = crops.shape[-1]
            q_crops = torch.gather(crops, 1, safe_gt[..., None, None].expand(
                b, q, s, s))
            q_orig = torch.gather(origins, 1, safe_gt[..., None].expand(
                b, q, 2))
            loc = crop_local_coords(coords.reshape(b, q, -1, 2), q_orig,
                                    gt_hw, s)
            tgt_pts = _sample_per(q_crops.reshape(b * q, s, s),
                                  loc.reshape(b * q, -1, 2), cfg)
        else:
            hh, ww = gt_hw
            tgt = torch.gather(gt_masks.float(), 1, safe_gt[..., None, None]
                               .expand(b, q, hh, ww))
            tgt_pts = _sample_per(tgt.reshape(b * q, hh, ww), coords, cfg)
    wmask = mr.matched.reshape(-1).float()

    p = pred_pts.shape[-1]
    bce = (F.softplus(-pred_pts) * tgt_pts
           + F.softplus(pred_pts) * (1.0 - tgt_pts)).sum(-1)
    loss_mask = (cfg.head_mask_weight * (bce * wmask).sum()
                 / (num_total_masks * p))
    pr = torch.sigmoid(pred_pts)
    num = 2.0 * (pr * tgt_pts).sum(-1)
    den = pr.sum(-1) + tgt_pts.sum(-1)
    dice = 1.0 - (num + 1.0) / (den + 1.0)
    loss_dice = cfg.head_dice_weight * (dice * wmask).sum() / num_total_masks
    return ({"loss_cls": loss_cls, "loss_mask": loss_mask,
             "loss_dice": loss_dice}, mr)


def maskbev_loss(outputs: DecoderOutputs, gt_labels: torch.Tensor,
                 gt_masks: torch.Tensor, gt_valid: torch.Tensor,
                 cfg: MaskBevConfig, *, generator=None,
                 coords: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]]
                 = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Deep-supervised loss over all L+1 head passes -> (total, logs).

    ``coords``: per head pass, the pinned ``(match_coords (B, P, 2),
    loss_coords (B*Q, P, 2))``; otherwise drawn from ``generator``. Logs
    hold per-layer vectors (``*_layers``), their sums, ``loss`` and, when GT
    crops are on, ``gt_crop_truncated`` (instances whose bbox exceeds the
    crop: any nonzero means ``loss_gt_crop`` is too small)."""
    n_layers, b = outputs.cls_logits.shape[:2]
    dev = outputs.cls_logits.device
    s = gt_crop_size(cfg, gt_masks.shape[-2:])
    gt_crop, truncated = None, None
    if s:
        crops, origins, truncated = gt_crops(gt_masks, s)
        gt_crop = (crops, origins)
    if coords is None:
        coords = [(_draw_match_coords(b, cfg, generator, dev), None)
                  for _ in range(n_layers)]

    # pass 1: every head pass's matching costs; pass 2: one solve for all
    # L*B problems (the matcher's steps are latency-bound, so batching the
    # problems costs about as much as one pass's)
    costs = torch.stack([match_costs(
        outputs.cls_logits[li], outputs.mask_logits[li], gt_labels,
        gt_masks, cfg, coords[li][0], gt_crop) for li in range(n_layers)])
    nv = gt_valid.sum(-1).to(torch.int32).repeat(n_layers)
    gq, mt = match(costs.reshape(n_layers * b, *costs.shape[2:]), nv)
    gq = gq.reshape(n_layers, b, -1)
    mt = mt.reshape(n_layers, b, -1)

    # pass 3: each head pass's losses under its assignment
    per_layer = [layer_losses(
        outputs.cls_logits[li], outputs.mask_logits[li], gt_labels, gt_masks,
        gt_valid, cfg, generator=generator, loss_coords=coords[li][1],
        gt_crop=gt_crop, match_result=MatchResult(gq[li], mt[li]))[0]
        for li in range(n_layers)]
    logs = {}
    total = None
    for name in per_layer[0]:
        v = torch.stack([d[name] for d in per_layer])
        logs[f"{name}_layers"] = v
        logs[name] = v.sum()
        total = logs[name] if total is None else total + logs[name]
    logs["loss"] = total
    if truncated is not None:
        logs["gt_crop_truncated"] = (truncated & gt_valid).sum().float()
    return total, logs
