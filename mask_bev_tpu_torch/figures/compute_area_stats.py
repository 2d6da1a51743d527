"""Footprint-completion area analysis: the port's counterpart of
``scripts/figures/compute_area_stats.py``.

    python -m mask_bev_tpu_torch.figures.compute_area_stats \
        --compute-gt {completion,no_completion} --root <SemanticKITTI tree>
    python -m mask_bev_tpu_torch.figures.compute_area_stats \
        --pred-areas <MaskArea pickle> [--out area_stats.png]

The first writes the car instances' footprint areas (cells of the 0.16 m
grid over +-40 m) of the validation split: from the multi-scan accumulated
masks (``completion``, the mask dataset's scene) or each scan rasterized
alone (``no_completion``). The second plots the ``A_pred / A_complete``
histogram of a pickle from ``evaluation.detection_metric.MaskArea``, with
its mean.
"""
from __future__ import annotations

import argparse
import pickle
from typing import Dict, List

import numpy as np

from mask_bev_tpu_torch.datasets.semantic_kitti.dataset import (
    SemanticKittiSequenceDataset)
from mask_bev_tpu_torch.datasets.semantic_kitti.mask_data import (
    SemanticKittiMaskDataset)
from mask_bev_tpu_torch.datasets.semantic_kitti.rasterizer import (
    SemanticKittiRasterizer)
from mask_bev_tpu_torch.datasets.semantic_kitti.scene import SceneMaker
from mask_bev_tpu_torch.datasets.semantic_kitti.taxonomy import RawLabel

GRID = ((-40, 40), (-40, 40), (-10, 10), 0.16)


def _instance_areas(mask: np.ndarray) -> List[int]:
    ids = np.unique(mask)
    return [int((mask == i).sum()) for i in ids[ids != 0]]


def compute_gt_areas(root: str, split: str = "valid",
                     single_scan: bool = False) -> List[int]:
    """Car instance footprint areas over a split; ``single_scan`` rasterizes
    each scan alone (no completion)."""
    seq_ds = SemanticKittiSequenceDataset(root, split,
                                          included_labels=[RawLabel.CAR])
    areas = []
    if single_scan:
        r = SemanticKittiRasterizer(*GRID, remove_unseen=True, min_points=1)
        for i in range(len(seq_ds.dataset)):
            scan = seq_ds.dataset[i]
            maker = SceneMaker()
            maker.add_scan(scan)
            areas += _instance_areas(r.get_mask_around(scan, maker.scene))
    else:
        md = SemanticKittiMaskDataset(seq_ds, *GRID, remove_unseen=True,
                                      min_points=1)
        for i in range(len(md)):
            areas += _instance_areas(md[i].mask)
    return areas


def area_ratios(area_pred: Dict) -> List[float]:
    """``A_pred / A_complete`` of each instance with a target area."""
    return [m["pred"] / m["tgt"] for m in area_pred.values() if m["tgt"] > 0]


def plot_area_ratios(ratios: List[float], out: str) -> float:
    """The histogram of ``ratios`` with its mean, written to ``out``;
    returns the mean."""
    from mask_bev_tpu_torch.visualization.bev_viz import _mpl

    plt = _mpl()
    mu = float(np.mean(ratios)) if ratios else float("nan")
    fig, ax = plt.subplots(figsize=(7, 6))
    ax.hist(ratios, bins=25, color="#dc3f76")
    ax.axvline(mu, color="#001482")
    ax.set_xlabel(r"$A_{pred} / A_{complete}$")
    ax.set_ylabel("# Instances")
    ax.set_xlim(0, 3)
    ax.set_title(f"mean ratio = {mu:.2f}")
    fig.savefig(out, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return mu


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--pred-areas",
                   help="MaskArea pickle ({inst: {tgt, pred}})")
    p.add_argument("--root", default="data/SemanticKITTI")
    p.add_argument("--compute-gt", choices=["completion", "no_completion"])
    p.add_argument("--out", default="area_stats.png")
    args = p.parse_args(argv)
    if args.compute_gt:
        areas = compute_gt_areas(
            args.root, single_scan=args.compute_gt == "no_completion")
        out = f"mask_area_{args.compute_gt}.pkl"
        with open(out, "wb") as f:
            pickle.dump(areas, f)
        print(f"wrote {len(areas)} instance areas to {out}")
        return
    if args.pred_areas:
        with open(args.pred_areas, "rb") as f:
            ratios = area_ratios(pickle.load(f))
        mu = plot_area_ratios(ratios, args.out)
        print(f"mean A_pred/A_complete = {mu:.3f}; wrote {args.out}")


if __name__ == "__main__":
    main()
