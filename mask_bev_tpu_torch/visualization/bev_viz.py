"""BEV visualization (matplotlib, headless-friendly).

The port's own copy of ``mask_bev_tpu/visualization/bev_viz.py``.

Covers the reference's visualization roles (``visualization/point_cloud_viz.py``
OpenGL viewer + the TensorBoard image dumps at ``mask_bev_module.py:257-264,
281-294,353-364``) with matplotlib renders that work over SSH/headless
hosts: top-down point clouds, GT instance maps, per-query predicted masks,
and pseudo-image/backbone feature summaries.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_point_cloud_bev(points: np.ndarray, x_range, y_range,
                         labels: Optional[np.ndarray] = None,
                         path: Optional[str] = None, s: float = 0.3):
    """Top-down scatter of a scan; color by label if given."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 8))
    c = labels if labels is not None else points[:, 2]
    ax.scatter(points[:, 0], points[:, 1], c=c, s=s, cmap="viridis")
    ax.set_xlim(*x_range)
    ax.set_ylim(*y_range)
    ax.set_aspect("equal")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_instance_mask(mask: np.ndarray, path: Optional[str] = None):
    """(H, W) instance-id image with a categorical colormap."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 6))
    m = np.ma.masked_where(mask == 0, mask)
    ax.imshow(m, origin="lower", cmap="tab20", interpolation="nearest")
    ax.set_facecolor("black")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_query_masks(mask_probs: np.ndarray, scores: Optional[np.ndarray] = None,
                     max_queries: int = 16, path: Optional[str] = None):
    """Grid of per-query sigmoid masks (ref TB dump mask_bev_module.py:353-364)."""
    plt = _mpl()
    q = min(mask_probs.shape[0], max_queries)
    cols = int(np.ceil(np.sqrt(q)))
    rows = int(np.ceil(q / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 2.2 * rows))
    axes = np.atleast_1d(axes).ravel()
    for i in range(q):
        axes[i].imshow(mask_probs[i], origin="lower", vmin=0, vmax=1)
        title = f"q{i}"
        if scores is not None:
            title += f" {scores[i]:.2f}"
        axes[i].set_title(title, fontsize=7)
        axes[i].axis("off")
    for ax in axes[q:]:
        ax.axis("off")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_pseudo_image(pseudo: np.ndarray, path: Optional[str] = None):
    """(C, H, W) -> mean-channel magnitude heatmap."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(np.abs(pseudo).mean(0), origin="lower")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig
