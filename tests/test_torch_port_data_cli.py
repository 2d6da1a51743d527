"""The training CLI ``train_mask_bev_torch.py --device cpu --train --test``
on SemanticKITTI and KITTI trees written from a seed
(``datasets/disk_trees.py``), with a YAML at ``tiny_test_config()`` widths
on an 80x80 grid: one training and one validation batch of 2 scans, one
epoch, the datasets' shipped augmentations (SemanticKITTI's on 2 worker
processes). Each run must exit 0, restore ``best`` and print the test
results.
"""
import pathlib
import shutil
import subprocess
import sys

import pytest
import yaml

pytest.importorskip("torch")

from mask_bev_tpu_torch.config import MaskBevConfig, tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.datasets.disk_trees import (  # noqa: E402
    write_kitti_tree, write_semantic_kitti_tree)
from mask_bev_tpu_torch.datasets.kitti.object_sampler import (  # noqa: E402
    write_samples)

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None,
    reason="g++ not found on PATH: the port's host core cannot be built")

ROOT = pathlib.Path(__file__).resolve().parent.parent
SHIPPED = {"semantic_kitti": "semantic_kitti/01_semantic_kitti.yml",
           "kitti": "kitti/01_kitti.yml"}


def _yaml(path, dataset, root, **kw):
    augs = MaskBevConfig.from_yaml(
        ROOT / "configs/training" / SHIPPED[dataset]).augmentations
    augs = [dict(a, dataset_root=str(root)) if a["name"] == "object_sample"
            else a for a in augs]
    cfg = tiny_test_config().replace(
        dataset=dataset, voxel_size=0.16, batch_size=2, max_epochs=1,
        limit_train_batches=1, limit_val_batches=1, max_num_pillars=256,
        head_num_points=64, loss_gt_crop=48, log_images=False,
        augmentations=augs, **kw)
    d = {k: list(v) if isinstance(v, tuple) else v
         for k, v in cfg.to_dict().items() if k != "name"}
    path.write_text(yaml.safe_dump(d))
    return path


def _run(cfg, root, work):
    return subprocess.run(
        [sys.executable, str(ROOT / "train_mask_bev_torch.py"), "--config",
         str(cfg), "--data-root", str(root), "--train", "--test",
         "--device", "cpu", "--workdir", str(work)],
        capture_output=True, text=True, timeout=300, cwd=work)


@pytest.mark.parametrize("dataset", ["semantic_kitti", "kitti"])
def test_cli_trains_and_tests_on_a_tree(tmp_path, dataset):
    if dataset == "semantic_kitti":
        root = write_semantic_kitti_tree(
            tmp_path / "sk", seed=2, train_scans=3, valid_scans=2,
            points=1800, radius=9.0, spacing=5.0, lanes=(-3.0, 3.0),
            car_points=1500.0)
        kw = dict(x_range=(-6.4, 6.4), y_range=(-6.4, 6.4), num_workers=2)
    else:
        root = write_kitti_tree(tmp_path / "kitti", seed=2, frames=4,
                                train=2, points=1800, boxes=(3, 6),
                                radius=14.0)
        write_samples(str(root), log_every=0)
        kw = dict(x_range=(0, 12.8), y_range=(-6.4, 6.4),
                  head_num_classes=3)
    cfg = _yaml(tmp_path / f"tiny_{dataset}.yml", dataset, root, **kw)
    res = _run(cfg, root, tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert f"dataset={dataset} grid=(80, 80)" in res.stdout
    assert "restored best checkpoint" in res.stdout
    assert "test results:" in res.stdout
    assert (tmp_path / cfg.stem / "checkpoints" / "best.pt").exists()
