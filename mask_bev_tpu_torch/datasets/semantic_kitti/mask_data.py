"""SemanticKITTI mask dataset (with npy disk cache) + data module.

The port's copy of ``mask_bev_tpu/datasets/semantic_kitti/mask_data.py``,
with the cache warmer of the JAX package's
``scripts/generate_semantic_kitti_mask_cache.py`` as its ``python -m``
entry (``python -m mask_bev_tpu_torch.datasets.semantic_kitti.mask_data
--root <tree> [--split train] [--processes N]``). The cache's layout and
file names are the JAX package's, so a cache written by either package is
read by the other.

Rebuild of reference ``semantic_kitti_mask_dataset.py:22-147`` and
``semantic_kitti_mask_data_module.py:19-149``:

  * per-scan GT instance mask, cached at ``<root>/dataset/masks_cache/
    <seq>/<scan>.npy`` (identical layout to the reference so existing caches
    are reusable — note the cached array is in the reference's (x, y)
    orientation; we transpose on read/write);
  * on cache miss: select the sequence scans whose positions fall in a 2x
    range window around the scan (or the walk-out approximation), accumulate
    the scene, rasterize;
  * per-scan instance heights cached alongside (``<scan>.heights.npy``) —
    replaces the reference's pre-built ``heights/<seq>.pkl`` lookup
    (``semantic_kitti_transforms.py:153-177``);
  * sample assembly in reference-parity GT layout (labels padded to Q, CAR=1,
    all rows valid — see ``MaskToLabelInstanceMasks``,
    ``semantic_kitti_transforms.py:69-82``) with ``FilterSmallMasks``;
  * data module over train/valid/test splits, CAR-only labels
    (``semantic_kitti_mask_data_module.py:56-60``), drop_last batching.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.datasets.semantic_kitti.dataset import (
    SemanticKittiScan, SemanticKittiSequenceDataset)
from mask_bev_tpu_torch.datasets.semantic_kitti.rasterizer import SemanticKittiRasterizer
from mask_bev_tpu_torch.datasets.semantic_kitti.scene import SceneMaker
from mask_bev_tpu_torch.datasets.semantic_kitti.taxonomy import LearningLabel, RawLabel


@dataclasses.dataclass
class SemanticKittiMaskScan:
    scan: SemanticKittiScan
    mask: np.ndarray  # (H, W) instance ids
    heights: Dict[int, float]


class SemanticKittiMaskDataset:
    def __init__(self, sequence_dataset: SemanticKittiSequenceDataset,
                 x_range, y_range, z_range, voxel_size: float,
                 remove_unseen: bool, min_points: int,
                 use_cache: bool = True, approx_scene: bool = False,
                 cache_name: str = "masks_cache"):
        self._seq_dataset = sequence_dataset
        self._scan_dataset = sequence_dataset.dataset
        self.x_range = tuple(x_range)
        self.y_range = tuple(y_range)
        self.rasterizer = SemanticKittiRasterizer(
            x_range, y_range, z_range, voxel_size, remove_unseen, min_points)
        self._use_cache = use_cache
        self._approx_scene = approx_scene
        self._cache_path = sequence_dataset.root_path / cache_name
        self.cache_hit = 0
        self.cache_miss = 0

    def __len__(self) -> int:
        return len(self._scan_dataset)

    @property
    def cache_hit_ratio(self) -> float:
        total = self.cache_hit + self.cache_miss
        return self.cache_hit / total if total else 0.0

    def _cache_of_scan(self, scan: SemanticKittiScan) -> pathlib.Path:
        return (self._cache_path / str(scan.seq_number)
                / f"{scan.scan_number}.npy")

    def __getitem__(self, idx: int) -> SemanticKittiMaskScan:
        scan = self._scan_dataset[idx]
        if self._use_cache:
            path = self._cache_of_scan(scan)
            hpath = path.with_suffix(".heights.npy")
            if path.exists():
                self.cache_hit += 1
                # reference cache layout is (x, y); transpose to (H=y, W=x)
                mask = np.load(path).T
                heights = {}
                if hpath.exists():
                    arr = np.load(hpath)
                    heights = {int(i): float(h) for i, h in arr}
                return SemanticKittiMaskScan(scan, mask, heights)
        self.cache_miss += 1
        return self._generate(scan)

    def _valid_scan_numbers(self, scan: SemanticKittiScan) -> List[int]:
        seq = self._seq_dataset[scan.seq_idx]
        pos = seq.positions()
        pos_local = pos @ scan.velo_to_inv_pose[:3, :3].T \
            + scan.velo_to_inv_pose[:3, 3]
        if self._approx_scene:
            # walk out from the scan until out of range (ref :103-128)
            def in_range(i):
                return (self.x_range[0] < pos_local[i, 0] < self.x_range[1]
                        and self.y_range[0] < pos_local[i, 1] < self.y_range[1])

            nums = []
            i = scan.scan_number
            while i >= 0 and in_range(i):
                nums.append(i)
                i -= 1
            i = scan.scan_number + 1
            while i < len(pos_local) and in_range(i):
                nums.append(i)
                i += 1
            return sorted(nums)
        scaling = 2  # ref :89-95
        ok = (
            (pos_local[:, 0] > scaling * self.x_range[0])
            & (pos_local[:, 0] < scaling * self.x_range[1])
            & (pos_local[:, 1] > scaling * self.y_range[0])
            & (pos_local[:, 1] < scaling * self.y_range[1])
        )
        return np.flatnonzero(ok).tolist()

    def _generate(self, scan: SemanticKittiScan) -> SemanticKittiMaskScan:
        seq = self._seq_dataset[scan.seq_idx]
        maker = SceneMaker()
        for s in self._seq_dataset.load_scan_numbers_in_sequence(
                seq, self._valid_scan_numbers(scan)):
            maker.add_scan(s)
        mask, heights = self.rasterizer.get_mask_around(
            scan, maker.scene, return_heights=True)
        if self._use_cache:
            path = self._cache_of_scan(scan)
            path.parent.mkdir(parents=True, exist_ok=True)
            np.save(path, mask.T)  # store in reference (x, y) layout
            harr = np.array([[i, h] for i, h in heights.items()], np.float64)
            np.save(path.with_suffix(".heights.npy"), harr.reshape(-1, 2))
        return SemanticKittiMaskScan(scan, mask, heights)


def filter_small_masks(mask: np.ndarray, min_pixels: int) -> np.ndarray:
    """Zero out instances under min_pixels (ref semantic_kitti_transforms.py:11-25)."""
    if min_pixels <= 0:
        return mask
    ids, counts = np.unique(mask[mask != 0], return_counts=True)
    for i, c in zip(ids, counts):
        if c < min_pixels:
            mask[mask == i] = 0
    return mask


def mask_scan_to_sample(ms: SemanticKittiMaskScan, cfg: MaskBevConfig,
                        augmentations=None,
                        rng: Optional[np.random.Generator] = None
                        ) -> Dict[str, np.ndarray]:
    """MaskScan -> fixed-shape sample dict (reference-parity GT layout)."""
    from mask_bev_tpu_torch.augmentations.semantic_kitti_augmentations import (
        apply_mask_augmentations)

    points = ms.scan.point_cloud.astype(np.float32)
    mask = filter_small_masks(ms.mask.copy(), cfg.min_num_inst_pixels)
    if augmentations and rng is not None:
        points, mask = apply_mask_augmentations(points, mask, augmentations, rng)

    q = cfg.num_queries
    h, w = mask.shape
    labels = np.zeros((q,), np.int32)
    masks = np.zeros((q, h, w), bool)
    heights = np.zeros((q,), np.float32)
    ids = np.unique(mask)
    ids = ids[ids != 0]
    for i, inst in enumerate(ids[:q]):
        labels[i] = LearningLabel.CAR  # ref semantic_kitti_transforms.py:79
        masks[i] = mask == inst
        raw_h = ms.heights.get(int(inst), 1.0)
        heights[i] = float(np.clip(round(raw_h * 5) / 5, 1, 3))

    n = cfg.max_points_per_scan
    pts = np.zeros((n, cfg.pc_point_dim), np.float32)
    take = min(points.shape[0], n)
    pts[:take] = points[:take, : cfg.pc_point_dim]
    pmask = np.zeros((n,), bool)
    pmask[:take] = True
    return {
        "points": pts,
        "point_mask": pmask,
        "gt_labels": labels,
        "gt_masks": masks,
        "gt_valid": np.ones((q,), bool),  # reference-parity (no filtering)
        "gt_heights": heights,
        "num_instances": np.int32(len(ids[:q])),
    }


class SemanticKittiMaskDataModule:
    """Train/val/test sample streams (CAR-only labels, like the reference)."""

    def __init__(self, root_path: str, cfg: MaskBevConfig,
                 use_cache: bool = True, sample_transforms=()):
        from mask_bev_tpu_torch.augmentations.semantic_kitti_augmentations import (
            make_semantic_kitti_augmentation_list)
        from mask_bev_tpu_torch.utils.pipeline import Compose, Identity

        self.cfg = cfg
        self.root = root_path
        self._use_cache = use_cache
        self.augmentations = make_semantic_kitti_augmentation_list(
            cfg.augmentations)
        # user-extensible post-assembly hook, composed with the pipeline DSL
        # (the reference wires its datamodules through the same combinators,
        # ref semantic_kitti_mask_data_module.py:88-120)
        self.sample_transform = (
            Compose(sample_transforms) if sample_transforms else Identity())
        self._datasets: Dict[str, SemanticKittiMaskDataset] = {}

    def _mask_dataset(self, split: str) -> SemanticKittiMaskDataset:
        if split not in self._datasets:
            seq = SemanticKittiSequenceDataset(
                self.root, split, included_labels=[RawLabel.CAR])
            c = self.cfg
            self._datasets[split] = SemanticKittiMaskDataset(
                seq, c.x_range, c.y_range, c.z_range, c.voxel_size,
                remove_unseen=c.remove_unseen, min_points=c.min_num_points,
                use_cache=self._use_cache)
        return self._datasets[split]

    def _epoch(self, split: str, train: bool, seed: int) -> Iterator[Dict]:
        from mask_bev_tpu_torch.utils.workers import batched, sample_stream

        ds = self._mask_dataset(split)
        order = np.arange(len(ds))
        if train and self.cfg.shuffle_train:
            np.random.default_rng(seed).shuffle(order)

        def sample(i: int, rng: np.random.Generator):
            return self.sample_transform(mask_scan_to_sample(
                ds[i], self.cfg,
                augmentations=self.augmentations if train else None, rng=rng))

        stream = sample_stream(sample, order, seed,
                               num_workers=self.cfg.num_workers)
        yield from batched(stream, self.cfg.batch_size, len(order))

    def train_batches(self, seed: int = 0) -> Iterator[Dict]:
        return self._epoch("train", True, seed)

    def val_batches(self, seed: int = 0) -> Iterator[Dict]:
        return self._epoch("valid", False, seed)

    def test_batches(self, seed: int = 0) -> Iterator[Dict]:
        """Test split has no labels: yields points-only batches (the
        reference's test dataloader likewise emits bare point clouds,
        ``semantic_kitti_mask_data_module.py:75``)."""
        from mask_bev_tpu_torch.datasets.semantic_kitti.dataset import (
            SemanticKittiDataset)

        ds = SemanticKittiDataset(self.root, "test")
        c = self.cfg
        b = c.batch_size
        n = c.max_points_per_scan
        for start in range(0, len(ds) - b + 1, b):
            pts = np.zeros((b, n, c.pc_point_dim), np.float32)
            pmask = np.zeros((b, n), bool)
            for j in range(b):
                pc = ds[start + j].point_cloud
                take = min(pc.shape[0], n)
                pts[j, :take] = pc[:take, : c.pc_point_dim]
                pmask[j, :take] = True
            yield {"points": pts, "point_mask": pmask}


def _warm_dataset(args) -> SemanticKittiMaskDataset:
    seq = SemanticKittiSequenceDataset(
        args.root, args.split, included_labels=[RawLabel.CAR])
    return SemanticKittiMaskDataset(
        seq, tuple(args.x_range), tuple(args.y_range), tuple(args.z_range),
        args.voxel_size, remove_unseen=True, min_points=args.min_points)


def _warm_indices(payload) -> int:
    args, indices = payload
    ds = _warm_dataset(args)
    for i in indices:
        ds[i]
    return len(indices)


def main(argv=None) -> None:
    """Warm the GT-mask disk cache of one split (reference
    ``scripts/generate_semantic_kitti_mask_cache.py:27-29``), sequentially
    or over ``--processes`` worker processes."""
    import argparse
    import multiprocessing

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--root", default="data/SemanticKITTI")
    p.add_argument("--split", default="train")
    p.add_argument("--x-range", nargs=2, type=float, default=[-40, 40])
    p.add_argument("--y-range", nargs=2, type=float, default=[-40, 40])
    p.add_argument("--z-range", nargs=2, type=float, default=[-20, 20])
    p.add_argument("--voxel-size", type=float, default=0.16)
    p.add_argument("--min-points", type=int, default=1)
    p.add_argument("--processes", type=int, default=1)
    args = p.parse_args(argv)

    ds = _warm_dataset(args)
    n = len(ds)
    if args.processes <= 1:
        for i in range(n):
            ds[i]
            if i % 100 == 0:
                print(f"{i}/{n} (hit ratio {ds.cache_hit_ratio:.2f})")
    else:
        chunks = [(args, list(range(i, n, args.processes)))
                  for i in range(args.processes)]
        with multiprocessing.Pool(args.processes) as pool:
            pool.map(_warm_indices, chunks)
    print(f"cached {n} masks")


if __name__ == "__main__":
    main()
