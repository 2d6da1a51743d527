"""The port's figure tools (``mask_bev_tpu_torch/figures``), on the CPU.

* ``compute_gt_areas`` against the JAX package's script
  (``scripts/figures/compute_area_stats.py``, imported from its path) bit
  for bit, with and without completion, each on its own
  ``disk_trees.write_semantic_kitti_tree`` tree of the same seed (the
  mask dataset caches its masks in the tree);
* the area histogram, the figure writer and the frame writer (a video
  through cv2, and PNG frames where cv2 is missing) write their files,
  serving a ``Trainer`` checkpoint of the tiny config on the CPU through
  the modules' own ``main``.
"""
import importlib.util
import pathlib
import pickle

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import yaml  # noqa: E402

from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.datasets.disk_trees import (  # noqa: E402
    write_semantic_kitti_tree)
from mask_bev_tpu_torch.datasets.synthetic import make_batch  # noqa: E402
from mask_bev_tpu_torch.figures import (  # noqa: E402
    compute_area_stats, generate_figures, make_video)
from mask_bev_tpu_torch.train.loop import Trainer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
TREE = dict(seed=3, train_scans=1, valid_scans=4, points=4000)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_compute_area_stats",
        ROOT / "scripts" / "figures" / "compute_area_stats.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("single_scan", [False, True],
                         ids=["completion", "no_completion"])
def test_gt_areas_match_the_jax_script(tmp_path, single_scan):
    mine = write_semantic_kitti_tree(tmp_path / "port", **TREE)
    theirs = write_semantic_kitti_tree(tmp_path / "jax", **TREE)
    got = compute_area_stats.compute_gt_areas(str(mine),
                                              single_scan=single_scan)
    want = _jax_script().compute_gt_areas(str(theirs),
                                          single_scan=single_scan)
    assert len(want) > 0 and got == want


def test_area_histogram(tmp_path):
    areas = {i: {"tgt": 10 + i, "pred": 12 + 2 * i} for i in range(20)}
    pkl = tmp_path / "areas.pkl"
    pkl.write_bytes(pickle.dumps(areas))
    out = tmp_path / "ratios.png"
    compute_area_stats.main(["--pred-areas", str(pkl), "--out", str(out)])
    assert out.stat().st_size > 0
    ratios = compute_area_stats.area_ratios(areas)
    assert ratios == [(12 + 2 * i) / (10 + i) for i in range(20)]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A one-epoch ``Trainer`` run of the tiny config on the CPU, its YAML
    config beside it, and a SemanticKITTI tree for the frames."""
    work = tmp_path_factory.mktemp("figures")
    cfg = tiny_test_config().replace(
        name="tiny_figures", batch_size=2, limit_train_batches=1,
        limit_val_batches=1, max_epochs=1, head_num_points=64,
        max_points_per_scan=1024, loss_gt_crop=48, max_num_pillars=256)

    def batches(offset):
        def gen(seed):
            rng = np.random.default_rng(seed + offset)
            yield make_batch(rng, cfg, noise_points=600)
        return gen

    Trainer(cfg, workdir=str(work), device="cpu").fit(batches(0),
                                                      batches(10_000))
    yml = work / "tiny_figures.yml"
    yml.write_text(yaml.safe_dump(cfg.to_dict()))
    tree = write_semantic_kitti_tree(work / "tree", **TREE)
    return yml, work / cfg.name / "checkpoints", tree


def test_figures_from_a_checkpoint(checkpoint, tmp_path):
    yml, ckpt, _ = checkpoint
    out = tmp_path / "figs"
    written = generate_figures.main([
        "--config", str(yml), "--ckpt-dir", str(ckpt), "--data-root",
        "unused", "--out-dir", str(out), "--num-scans", "2",
        "--device", "cpu"])
    names = {p.name for p in written}
    assert {"scan_0.png", "gt_0.png", "scan_1.png", "gt_1.png"} <= names
    assert all(p.stat().st_size > 0 for p in written)


@pytest.mark.parametrize("cv2", [True, False], ids=["video", "frames"])
def test_frames_from_a_checkpoint(checkpoint, tmp_path, monkeypatch, cv2):
    yml, ckpt, tree = checkpoint
    cfg = yaml.safe_load(yml.read_text())
    cfg["dataset"] = "semantic_kitti"
    sk = tmp_path / "sk.yml"
    sk.write_text(yaml.safe_dump(cfg))
    if not cv2:
        monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    out = tmp_path / "seq.mp4"
    written, path = make_video.main([
        "--config", str(sk), "--ckpt-dir", str(ckpt), "--dataset-root",
        str(tree), "--num-frames", "3", "--out", str(out), "--device",
        "cpu"])
    assert written == 3
    if cv2:
        assert path == str(out) and out.stat().st_size > 0
    else:
        frames = sorted(pathlib.Path(path).glob("frame_*.png"))
        assert len(frames) == 3 and all(f.stat().st_size for f in frames)
