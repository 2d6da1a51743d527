"""Inference figures from a checkpoint: the port's counterpart of
``scripts/figures/generate_figures.py``.

    python -m mask_bev_tpu_torch.figures.generate_figures --config <yml> \
        --ckpt-dir <run>/checkpoints --data-root <tree> [--out-dir figures] \
        [--num-scans 4] [--which best] [--device cuda]

Serves the first validation batch through ``MaskBevPredictor``
(``from_checkpoint``: on the card unless ``--device cpu``) and writes, a
scan: the scan's points from above (``scan_<i>.png``), its GT instance map
(``gt_<i>.png``) and its predicted masks (``pred_<i>.png``, where a query
passed the score threshold).
"""
from __future__ import annotations

import argparse
import pathlib
from typing import List

import numpy as np

from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.datasets.modules import build_datamodule
from mask_bev_tpu_torch.inference import MaskBevPredictor
from mask_bev_tpu_torch.visualization.bev_viz import (
    plot_instance_mask, plot_point_cloud_bev, plot_query_masks)


def write_figures(predictor: MaskBevPredictor, batch: dict,
                  cfg: MaskBevConfig, out: pathlib.Path,
                  num_scans: int) -> List[pathlib.Path]:
    """The figures of the first ``num_scans`` scans of ``batch``; returns
    the paths written."""
    out.mkdir(parents=True, exist_ok=True)
    preds = predictor.predict_batch(batch["points"], batch["point_mask"])
    written = []
    for i in range(min(num_scans, len(preds))):
        pts = batch["points"][i][batch["point_mask"][i]]
        written.append(out / f"scan_{i}.png")
        plot_point_cloud_bev(pts, cfg.x_range, cfg.y_range,
                             path=str(written[-1]))
        gt = np.zeros(cfg.grid_hw, np.int64)
        for g, mask in enumerate(batch["gt_masks"][i]):
            gt[mask] = g + 1
        written.append(out / f"gt_{i}.png")
        plot_instance_mask(gt, path=str(written[-1]))
        if len(preds[i].mask_probs):
            written.append(out / f"pred_{i}.png")
            plot_query_masks(preds[i].mask_probs, preds[i].scores,
                             path=str(written[-1]))
        print(f"scan {i}: {len(preds[i].scores)} detections, "
              f"{len(preds[i].boxes)} boxes")
    return written


def main(argv=None) -> List[pathlib.Path]:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--data-root", required=True)
    p.add_argument("--out-dir", default="figures")
    p.add_argument("--num-scans", type=int, default=4)
    p.add_argument("--which", default="best")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    args = p.parse_args(argv)
    cfg = MaskBevConfig.from_yaml(args.config)
    dm = build_datamodule(cfg, args.data_root)
    predictor = MaskBevPredictor.from_checkpoint(
        cfg, args.ckpt_dir, which=args.which, device=args.device)
    batch = next(iter(dm.val_batches(seed=0)))
    written = write_figures(predictor, batch, cfg,
                            pathlib.Path(args.out_dir), args.num_scans)
    print(f"{len(written)} figures in {args.out_dir}")
    return written


if __name__ == "__main__":
    main()
