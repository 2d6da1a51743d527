"""The port's KITTI host data against the JAX package's, on one on-disk
tree written from a seed (``datasets/disk_trees.py``: 6 training frames of
3000 points with 4-8 Car, Pedestrian and Cyclist boxes, a 120x120 grid at
0.2 m).

Compared bit for bit (tolerance 0): calibrations, labels and points, the
difficulty rules and filters, the rasterizer (the port's fill and in-box
counts run in its C++ host core), ``frame_to_sample`` with the shipped
augmentations of ``01_kitti.yml`` (``object_sample`` included), whole
train and val batches of the data modules (the port's with 0 and 2 worker
processes), and ``samples.pkl`` read across the two packages in both
directions.
"""
import copy
import dataclasses
import pathlib
import pickle
import runpy
import shutil
import sys

import numpy as np
import pytest

from mask_bev_tpu.config import MaskBevConfig as JaxConfig
from mask_bev_tpu.datasets.kitti import kitti_data as jkd
from mask_bev_tpu.datasets.kitti import kitti_dataset as jds
from mask_bev_tpu.datasets.kitti.kitti_rasterizer import (
    KittiRasterizer as JaxRasterizer)
from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.datasets.disk_trees import write_kitti_tree
from mask_bev_tpu_torch.datasets.kitti import kitti_data as tkd
from mask_bev_tpu_torch.datasets.kitti import kitti_dataset as tds
from mask_bev_tpu_torch.datasets.kitti import object_sampler
from mask_bev_tpu_torch.datasets.kitti.kitti_rasterizer import KittiRasterizer

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None,
    reason="g++ not found on PATH: the port's host core cannot be built")

ROOT = pathlib.Path(__file__).resolve().parent.parent
SHIPPED = MaskBevConfig.from_yaml(ROOT / "configs/training/kitti/01_kitti.yml")


def _kw(root):
    augs = [dict(a, dataset_root=str(root)) if a["name"] == "object_sample"
            else a for a in SHIPPED.augmentations]
    return dict(dataset="kitti", x_range=(0, 24), y_range=(-12, 12),
                z_range=(-20, 20), voxel_size=0.2, num_queries=10,
                head_num_classes=3, max_points_per_scan=4096, batch_size=2,
                augmentations=augs)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = write_kitti_tree(tmp_path_factory.mktemp("kitti"), seed=8,
                            frames=6, train=4, points=3000, boxes=(4, 8),
                            radius=20.0)
    object_sampler.write_samples(str(root), log_every=0)
    return root


def _eq(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _eq(got[k], want[k])
    elif dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            _eq(getattr(got, f.name), getattr(want, f.name))
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_frames(tree):
    got = tds.KittiDataset(str(tree))
    want = jds.KittiDataset(str(tree))
    assert len(got) == len(want) == 6
    types = set()
    for i in range(6):
        g, w = got[i], want[i]
        _eq(g.calib, w.calib)
        _eq(g.boxes, w.boxes)
        _eq(g.points, w.points)
        _eq(tkd.difficulty_of(g.boxes), jkd.difficulty_of(w.boxes))
        types |= set(g.boxes.types.tolist())
    assert types == {0, 3, 5}  # Car, Pedestrian, Cyclist
    assert tds.read_split_ids(tree / "val.txt") == [4, 5]


@pytest.mark.parametrize("unseen,min_points", [(False, 1), (True, 1),
                                               (True, 150)])
def test_rasterizer(tree, unseen, min_points):
    c = _kw(tree)
    args = (c["x_range"], c["y_range"], c["z_range"], c["voxel_size"])
    r = KittiRasterizer(*args, remove_unseen=unseen, min_points=min_points)
    jr = JaxRasterizer(*args, remove_unseen=unseen, min_points=min_points)
    filled = 0
    for i in range(6):
        got = r.get_mask(tds.KittiDataset(str(tree))[i])
        want = jr.get_mask(jds.KittiDataset(str(tree))[i])
        assert set(got) == set(want)
        for k in want:
            _eq(got[k], want[k])
            filled += len(np.unique(got[k])) - 1
    assert filled > 6


@pytest.mark.parametrize("augment,difficulty", [(False, False),
                                                (True, False), (True, True)])
def test_frame_to_sample(tree, augment, difficulty):
    c = _kw(tree)
    cfg, jcfg = MaskBevConfig(**c), JaxConfig(**copy.deepcopy(c))
    gdm = tkd.KittiMaskDataModule(str(tree), cfg)
    jdm = jkd.KittiMaskDataModule(str(tree), jcfg)
    for i in range(6):
        kw = [dict(filter_difficulty=difficulty) for _ in range(2)]
        if augment:
            for k, dm in zip(kw, (gdm, jdm)):
                k.update(rng=np.random.default_rng([3, i]),
                         augmentations=dm.augmentations)
        s = tkd.frame_to_sample(gdm.dataset[i], cfg, gdm.rasterizer, **kw[0])
        _eq(s, jkd.frame_to_sample(jdm.dataset[i], jcfg, jdm.rasterizer,
                                   **kw[1]))
        n = int(s["num_instances"])
        assert s["gt_valid"].all() and (s["gt_labels"][n:] == 0).all()
        assert not s["gt_masks"][n:].any()


@pytest.mark.parametrize("split,workers", [("train", 0), ("train", 2),
                                           ("val", 2)])
def test_batches(tree, split, workers):
    c = _kw(tree)
    gdm = tkd.KittiMaskDataModule(
        str(tree), MaskBevConfig(**c).replace(num_workers=workers))
    jdm = jkd.KittiMaskDataModule(str(tree), JaxConfig(**copy.deepcopy(c)))
    fn = f"{split}_batches"
    got = list(getattr(gdm, fn)(5))
    want = list(getattr(jdm, fn)(5))
    assert len(got) == len(want) == (2 if split == "train" else 1)
    for g, w in zip(got, want):
        _eq(g, w)
        assert g["gt_masks"].shape == (2, 10, 120, 120)
        assert g["num_instances"].min() >= 1


def test_samples_pkl_both_directions(tree, tmp_path, monkeypatch):
    """The JAX package's sampler script and the port's write the same bank,
    and ``object_sample`` of each package pastes the same objects from the
    other's file."""
    theirs = tmp_path / "jax_samples.pkl"
    monkeypatch.setattr(sys, "argv", [
        "generate_kitti_object_sampler.py", "--root", str(tree), "--out",
        str(theirs)])
    runpy.run_path(str(ROOT / "scripts/generate_kitti_object_sampler.py"),
                   run_name="__main__")
    with open(tree / "samples.pkl", "rb") as f:
        ours = pickle.load(f)
    with open(theirs, "rb") as f:
        want = pickle.load(f)
    assert len(ours) == len(want) > 10
    for a, b in zip(ours, want):
        assert set(a) == set(b)
        for k in b:
            _eq(a[k], b[k])
    from mask_bev_tpu.augmentations.kitti_augmentations import (
        ObjectSample as JaxObjectSample)
    from mask_bev_tpu_torch.augmentations.kitti_augmentations import (
        ObjectSample)

    cross = tmp_path / "cross"
    cross.mkdir()
    shutil.copy(theirs, cross / "samples.pkl")
    pairs = [(ObjectSample(str(cross), 15), JaxObjectSample(str(tree), 15)),
             (ObjectSample(str(tree), 15), JaxObjectSample(str(cross), 15))]
    for port_os, jax_os in pairs:
        for seed in (1, 2):
            g = port_os(tds.KittiDataset(str(tree))[0],
                        np.random.default_rng(seed))
            w = jax_os(jds.KittiDataset(str(tree))[0],
                       np.random.default_rng(seed))
            _eq(g.boxes, w.boxes)
            _eq(g.points, w.points)
