#!/usr/bin/env python3
"""Training CLI of the PyTorch port:
``python train_mask_bev_torch.py --config <yml> [--train] [--test]``.

The counterpart of ``train_mask_bev.py`` with the same flags, plus
``--device`` (default ``cuda``; ``--device cpu`` runs the plain PyTorch
path). It reads the flat YAML config with the port's ``MaskBevConfig``,
trains with ``mask_bev_tpu_torch.train.loop.Trainer`` (early stop, best and
last checkpoints, plateau LR) and, with ``--test``, restores the ``best``
checkpoint and runs a validation pass with the per-layer metrics. The
port trains on ``dataset: semantic_kitti`` and ``dataset: kitti`` trees,
on ``dataset: waymo`` roots of converted frames
(``python -m mask_bev_tpu_torch.datasets.waymo.convert``), all named by
``--data-root`` (the data modules of ``mask_bev_tpu_torch/datasets``, their
samples assembled on ``num_workers`` processes), and on ``dataset:
synthetic``.

Data parallel: launched as N processes, one a device, it joins their
process group from the environment (``torchrun --nproc_per_node N
train_mask_bev_torch.py ...``, or ``MASKBEV_COORDINATOR``,
``MASKBEV_NUM_PROCESSES`` and ``MASKBEV_PROCESS_ID`` per process, or
SLURM's ``SLURM_NTASKS``/``SLURM_PROCID`` with ``MASKBEV_COORDINATOR``; see
``mask_bev_tpu_torch/parallel/distributed.py``) and prints ``multi-host:
process r/n``. ``batch_size`` stays the global batch: each rank loads and
steps on its ``batch_size / N`` rows of it, ``--device cuda`` is the rank's
card (NCCL) and ``--device cpu`` runs the ranks over gloo.
"""
from __future__ import annotations

import argparse

from mask_bev_tpu_torch.datasets.modules import build_datamodule


def build_parser() -> argparse.ArgumentParser:
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
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from mask_bev_tpu_torch.config import MaskBevConfig
    from mask_bev_tpu_torch.parallel import distributed
    from mask_bev_tpu_torch.train.loop import Trainer

    if distributed.init_from_env(args.device):
        print(f"multi-host: process {distributed.rank()}"
              f"/{distributed.world_size()}")

    cfg = MaskBevConfig.from_yaml(args.config)
    if args.test and not args.train:
        # test-time overrides (reference train_mask_bev.py:62-63)
        cfg = cfg.replace(
            batch_size=cfg.test_batch_size or cfg.batch_size,
            num_workers=(cfg.test_num_workers
                         if cfg.test_num_workers is not None
                         else cfg.num_workers))
    root = args.data_root or cfg.dataset_root or f"data/{cfg.dataset}"

    dev = distributed.device(args.device)
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
    distributed.shutdown()


if __name__ == "__main__":
    main()
