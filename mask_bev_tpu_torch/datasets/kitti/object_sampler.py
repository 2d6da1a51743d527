"""Build the GT-paste sample bank for KITTI's ``object_sample`` augmentation.

The port's counterpart of the JAX package's
``scripts/generate_kitti_object_sampler.py`` (reference
``scripts/generate_kitti_object_sampler.py:10-29``): every labelled object
of the ``training`` split with at least ``MIN_PTS`` interior LiDAR points
becomes a sample (its points and box), pickled to ``<root>/samples.pkl`` in
the dict format that
:class:`mask_bev_tpu_torch.augmentations.kitti_augmentations.ObjectSample`
reads. Both packages write and read the same file.

    python -m mask_bev_tpu_torch.datasets.kitti.object_sampler --root <tree>
"""
from __future__ import annotations

import argparse
import pathlib
import pickle
from typing import Dict, List, Optional

import numpy as np

from mask_bev_tpu_torch.augmentations.box_ops import points_in_rbbox
from mask_bev_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset

MIN_PTS = 5


def collect_samples(root: str, log_every: int = 500) -> List[Dict]:
    """Every object of ``<root>``'s training frames with >= ``MIN_PTS``
    interior points, in frame and label order."""
    dataset = KittiDataset(root, "training")
    samples = []
    for idx in range(len(dataset)):
        frame = dataset[idx]
        boxes = frame.boxes
        if len(boxes) == 0:
            continue
        member = points_in_rbbox(
            frame.points, boxes.center, boxes.dims[:, :2], boxes.yaw,
            z0=boxes.center[:, 2], heights=boxes.dims[:, 2])
        for i in range(len(boxes)):
            m = member[:, i]
            if m.sum() >= MIN_PTS:
                samples.append({
                    "points": frame.points[m].astype(np.float32),
                    "center": boxes.center[i].copy(),
                    "dims": boxes.dims[i].copy(),
                    "yaw": float(boxes.yaw[i]),
                    "type": int(boxes.types[i]),
                })
        if log_every and idx % log_every == 0:
            print(f"{idx}/{len(dataset)} frames, {len(samples)} samples")
    return samples


def write_samples(root: str, out: Optional[str] = None,
                  log_every: int = 500) -> pathlib.Path:
    """Collect the bank and pickle it to ``out`` (default
    ``<root>/samples.pkl``); returns the path."""
    samples = collect_samples(root, log_every)
    path = pathlib.Path(out or (pathlib.Path(root) / "samples.pkl"))
    with open(path, "wb") as f:
        pickle.dump(samples, f)
    if log_every:
        print(f"wrote {len(samples)} samples to {path}")
    return path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default="data/KITTI")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    write_samples(args.root, args.out)


if __name__ == "__main__":
    main()
