#!/usr/bin/env python3
"""Training CLI of the PyTorch port:
``python train_mask_bev_torch.py --config <yml> [--train] [--test]``.

The counterpart of ``train_mask_bev.py`` with the same flags, plus
``--device`` (default ``cuda``; ``--device cpu`` runs the plain PyTorch
path). It reads the flat YAML config with the port's ``MaskBevConfig``,
trains with ``mask_bev_tpu_torch.train.loop.Trainer`` (early stop, best and
last checkpoints, plateau LR) and, with ``--test``, restores the ``best``
checkpoint and runs a validation pass with the per-layer metrics. The
port trains on ``dataset: semantic_kitti`` and ``dataset: kitti`` trees
(``--data-root``; the data modules of ``mask_bev_tpu_torch/datasets``,
their samples assembled on ``num_workers`` processes) and on ``dataset:
synthetic``; the Waymo loader is not ported yet.
"""
from __future__ import annotations

import argparse


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
        raise NotImplementedError(
            "the waymo loader is not ported to mask_bev_tpu_torch yet (the "
            "next slice of ROADMAP.md queue 1: the Waymo loader, its "
            "augmentations and converter); use train_mask_bev.py")
    if cfg.dataset == "synthetic":
        import numpy as np

        from mask_bev_tpu_torch.datasets.synthetic import make_batch

        class SyntheticModule:
            def train_batches(self, seed=0):
                rng = np.random.default_rng(seed)
                for _ in range(cfg.limit_train_batches or 16):
                    yield make_batch(rng, cfg)

            def val_batches(self, seed=0):
                rng = np.random.default_rng(seed + 10_000)
                for _ in range(cfg.limit_val_batches or 4):
                    yield make_batch(rng, cfg)

        return SyntheticModule()
    raise ValueError(f"unknown dataset: {cfg.dataset}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, help="flat YAML config")
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--data-root", default=None,
                        help="dataset root (overrides config dataset_root)")
    parser.add_argument("--workdir", default="runs")
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from mask_bev_tpu_torch.config import MaskBevConfig
    from mask_bev_tpu_torch.train.loop import Trainer

    cfg = MaskBevConfig.from_yaml(args.config)
    if args.test and not args.train:
        # test-time overrides (reference train_mask_bev.py:62-63)
        cfg = cfg.replace(
            batch_size=cfg.test_batch_size or cfg.batch_size,
            num_workers=(cfg.test_num_workers
                         if cfg.test_num_workers is not None
                         else cfg.num_workers))
    root = args.data_root or cfg.dataset_root or f"data/{cfg.dataset}"

    dev = torch.device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            and torch.cuda.is_available() else str(dev))
    print(f"device: {name}")
    print(f"experiment: {cfg.name} dataset={cfg.dataset} grid={cfg.grid_hw}")

    dm = build_datamodule(cfg, root)
    trainer = Trainer(cfg, workdir=args.workdir, device=args.device)

    if args.train or not args.test:
        trainer.fit(dm.train_batches, dm.val_batches,
                    max_epochs=args.max_epochs)

    if args.test:
        from mask_bev_tpu_torch.train.loop import load_ckpt_state

        restored = trainer.ckpt.restore("best")
        if restored is not None:
            load_ckpt_state(trainer.state, restored)
            print(f"restored best checkpoint "
                  f"(val_loss={trainer.ckpt.index.get('best_val_loss')})")
        results = trainer.validate(dm.val_batches(0), trainer.generator(0))
        print("test results:", results)


if __name__ == "__main__":
    main()
