"""Prediction-sequence video: the port's counterpart of
``scripts/figures/make_video.py``.

    python -m mask_bev_tpu_torch.figures.make_video --config <yml> \
        --ckpt-dir <run>/checkpoints [--dataset-root <tree>] [--split valid] \
        [--num-frames 100] [--every-nth 1] [--fps 10] [--out video.mp4] \
        [--which best] [--device cuda]

Serves consecutive scans of the configuration's dataset (SemanticKITTI's
split, or KITTI's training frames) one at a time through
``MaskBevPredictor`` (``from_checkpoint``: on the card unless ``--device
cpu``) and renders each as a BEV frame (points, predicted masks) with
matplotlib; the frames go to a video through ``cv2.VideoWriter`` where cv2
is installed, else to a directory of PNG frames any ffmpeg can assemble.
"""
from __future__ import annotations

import argparse
import pathlib
from typing import Iterator, Optional

import numpy as np

from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.inference import MaskBevPredictor, ScanPredictions


def render_frame(points: np.ndarray, preds: ScanPredictions,
                 cfg: MaskBevConfig,
                 gt_masks: Optional[np.ndarray] = None) -> np.ndarray:
    """One BEV frame: scan points, predicted masks (and GT contours) ->
    (H, W, 3) uint8 RGB."""
    from mask_bev_tpu_torch.visualization.bev_viz import _mpl

    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 6), dpi=110)
    ax.scatter(points[:, 0], points[:, 1], s=0.2, c="#777777", linewidths=0)
    extent = [cfg.x_range[0], cfg.x_range[1], cfg.y_range[0], cfg.y_range[1]]
    if preds.masks.shape[0]:
        overlay = np.zeros(preds.masks.shape[1:], np.float32)
        for i in range(preds.masks.shape[0]):
            overlay = np.maximum(overlay, preds.masks[i] * (i + 1))
        ax.imshow(np.ma.masked_where(overlay == 0, overlay), origin="lower",
                  extent=extent, alpha=0.6, cmap="tab20",
                  interpolation="nearest")
    if gt_masks is not None and gt_masks.shape[0]:
        ax.contour(gt_masks.any(0).astype(np.float32), levels=[0.5],
                   colors="#dc3f76", origin="lower", extent=extent,
                   linewidths=1.0)
    ax.set_xlim(*cfg.x_range)
    ax.set_ylim(*cfg.y_range)
    ax.set_aspect("equal")
    ax.axis("off")
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf


class VideoSink:
    """``cv2.VideoWriter`` where cv2 is installed; a directory of PNG
    frames (the output path without its suffix) otherwise."""

    def __init__(self, out_path: str, fps: int = 10):
        self.path = pathlib.Path(out_path)
        self.fps = fps
        self._writer = None
        self._frame_dir = None
        self._count = 0
        try:
            import cv2
        except ImportError:
            cv2 = None
            self._frame_dir = self.path.with_suffix("")
            self._frame_dir.mkdir(parents=True, exist_ok=True)
        self._cv2 = cv2

    def write(self, rgb: np.ndarray) -> None:
        if self._cv2 is not None:
            if self._writer is None:
                h, w = rgb.shape[:2]
                fourcc = self._cv2.VideoWriter_fourcc(*"mp4v")
                self._writer = self._cv2.VideoWriter(
                    str(self.path), fourcc, self.fps, (w, h))
            self._writer.write(np.ascontiguousarray(rgb[..., ::-1]))
        else:
            from PIL import Image

            Image.fromarray(rgb).save(
                self._frame_dir / f"frame_{self._count:06d}.png")
        self._count += 1

    def close(self) -> str:
        if self._writer is not None:
            self._writer.release()
            return str(self.path)
        return str(self._frame_dir)


def scan_points(cfg: MaskBevConfig, root: str,
                split: str) -> Iterator[np.ndarray]:
    """The (N, 4) points of the dataset's scans, in order."""
    if cfg.dataset == "kitti":
        from mask_bev_tpu_torch.datasets.kitti.kitti_dataset import (
            KittiDataset)

        ds = KittiDataset(root, "training")
        return (ds[i].points for i in range(len(ds)))
    from mask_bev_tpu_torch.datasets.semantic_kitti.dataset import (
        SemanticKittiDataset)

    ds = SemanticKittiDataset(root, split)
    return (ds[i].point_cloud for i in range(len(ds)))


def write_video(predictor: MaskBevPredictor, scans, cfg: MaskBevConfig,
                out: str, num_frames: int, every_nth: int = 1,
                fps: int = 10):
    """Render every ``every_nth`` scan of ``scans``, up to ``num_frames``,
    into ``out``; returns (frames written, the video or frame directory)."""
    sink = VideoSink(out, fps=fps)
    written = 0
    for i, pc in enumerate(scans):
        if i % every_nth:
            continue
        preds = predictor.predict_scan(np.asarray(pc, np.float32))
        sink.write(render_frame(pc, preds, cfg))
        written += 1
        if written >= num_frames:
            break
    return written, sink.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--dataset-root", default=None)
    ap.add_argument("--split", default="valid")
    ap.add_argument("--num-frames", type=int, default=100)
    ap.add_argument("--every-nth", type=int, default=1)
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--out", default="maskbev_video.mp4")
    ap.add_argument("--which", default="best", choices=["best", "last"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    cfg = MaskBevConfig.from_yaml(args.config)
    root = args.dataset_root or cfg.dataset_root or f"data/{cfg.dataset}"
    predictor = MaskBevPredictor.from_checkpoint(
        cfg, args.ckpt_dir, which=args.which, device=args.device)
    written, out = write_video(predictor, scan_points(cfg, root, args.split),
                               cfg, args.out, args.num_frames,
                               args.every_nth, args.fps)
    print(f"wrote {written} frames -> {out}")
    return written, out


if __name__ == "__main__":
    main()
