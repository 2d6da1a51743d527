"""The data module a configuration names, built on the tree at ``root``:
the port's SemanticKITTI, KITTI and Waymo modules, or the synthetic one.
Shared by the training CLI (``train_mask_bev_torch.py``) and the figure
tools (``mask_bev_tpu_torch/figures``)."""
from __future__ import annotations


def build_datamodule(cfg, root: str):
    if cfg.dataset == "kitti":
        from mask_bev_tpu_torch.datasets.kitti.kitti_data import (
            KittiMaskDataModule)

        return KittiMaskDataModule(root, cfg)
    if cfg.dataset == "semantic_kitti":
        from mask_bev_tpu_torch.datasets.semantic_kitti.mask_data import (
            SemanticKittiMaskDataModule)

        return SemanticKittiMaskDataModule(root, cfg)
    if cfg.dataset == "waymo":
        from mask_bev_tpu_torch.datasets.waymo.waymo_data import (
            WaymoDataModule)

        return WaymoDataModule(root, cfg)
    if cfg.dataset == "synthetic":
        import numpy as np

        from mask_bev_tpu_torch.datasets.synthetic import make_batch

        from mask_bev_tpu_torch.parallel.distributed import shard_batch

        class SyntheticModule:
            """The global batches drawn in sequence from one generator;
            each rank keeps its rows (the draws of a batch depend on those
            of the rows before it)."""

            def train_batches(self, seed=0):
                rng = np.random.default_rng(seed)
                for _ in range(cfg.limit_train_batches or 16):
                    yield shard_batch(make_batch(rng, cfg))

            def val_batches(self, seed=0):
                rng = np.random.default_rng(seed + 10_000)
                for _ in range(cfg.limit_val_batches or 4):
                    yield shard_batch(make_batch(rng, cfg))

        return SyntheticModule()
    raise ValueError(f"unknown dataset: {cfg.dataset}")
