"""The port's SemanticKITTI host data against the JAX package's, on one
on-disk tree written from a seed (``datasets/disk_trees.py``: sequences
00, 08 and 11 of a few thousand points a scan, a 160x160 grid at 0.16 m).

Compared bit for bit (tolerance 0): the label LUT, scans, labels and poses,
the accumulated scene, the rasterizer's mask and heights (the port's
morphology runs in its C++ host core), samples with the shipped
augmentations, whole train and valid batches of the data modules (the
port's with 0 and 2 worker processes), the mask cache read across the two
packages in both directions, the cache warmer, and ``test_batches``.
"""
import pathlib
import shutil

import numpy as np
import pytest

from mask_bev_tpu.config import MaskBevConfig as JaxConfig
from mask_bev_tpu.datasets.semantic_kitti import dataset as jds
from mask_bev_tpu.datasets.semantic_kitti import mask_data as jmd
from mask_bev_tpu.datasets.semantic_kitti import taxonomy as jtax
from mask_bev_tpu.datasets.semantic_kitti.rasterizer import (
    SemanticKittiRasterizer as JaxRasterizer)
from mask_bev_tpu.datasets.semantic_kitti.scene import (
    SceneMaker as JaxSceneMaker)
from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.datasets.disk_trees import write_semantic_kitti_tree
from mask_bev_tpu_torch.datasets.semantic_kitti import dataset as tds
from mask_bev_tpu_torch.datasets.semantic_kitti import mask_data as tmd
from mask_bev_tpu_torch.datasets.semantic_kitti import taxonomy as ttax
from mask_bev_tpu_torch.datasets.semantic_kitti.rasterizer import (
    SemanticKittiRasterizer)
from mask_bev_tpu_torch.datasets.semantic_kitti.scene import SceneMaker

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None,
    reason="g++ not found on PATH: the port's host core cannot be built")

ROOT = pathlib.Path(__file__).resolve().parent.parent
RANGE = (-12.8, 12.8)
# the shipped augmentations of 01_semantic_kitti.yml
AUGS = MaskBevConfig.from_yaml(
    ROOT / "configs/training/semantic_kitti/01_semantic_kitti.yml"
).augmentations
KW = dict(dataset="semantic_kitti", x_range=RANGE, y_range=RANGE,
          z_range=(-20, 20), voxel_size=0.16, num_queries=8,
          max_points_per_scan=4096, batch_size=2, augmentations=AUGS,
          min_num_inst_pixels=20)


def write_tree(root):
    return write_semantic_kitti_tree(
        root, seed=3, train_scans=6, valid_scans=4, test_scans=2,
        points=3000, radius=16.0, spacing=6.0, lanes=(-3.5, 3.5),
        car_points=2000.0)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("sk"))


def _eq(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _eq(got[k], want[k])
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"included_labels": [10]},
                                {"excluded_labels": [10, 40]}])
def test_lut(kw):
    _eq(ttax.learning_map_lut(**kw), jtax.learning_map_lut(**kw))
    assert ttax.LEARNING_MAP == jtax.LEARNING_MAP
    assert ttax.SPLITS == jtax.SPLITS


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_scans_and_poses(tree, split):
    kw = {} if split == "test" else {"included_labels": [10]}
    got = tds.SemanticKittiDataset(str(tree), split, **kw)
    want = jds.SemanticKittiDataset(str(tree), split, **kw)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        g, w = got[i], want[i]
        for f in ("point_cloud", "pose", "sem_label", "inst_label",
                  "velo_to_pose", "velo_to_inv_pose", "position"):
            if getattr(w, f) is None:
                assert getattr(g, f) is None
            else:
                _eq(getattr(g, f), getattr(w, f))
        assert (g.seq_number, g.scan_number, g.time) == (
            w.seq_number, w.scan_number, w.time)
        _eq(g.calib.velo_to_cam, w.calib.velo_to_cam)
    gs = tds.SemanticKittiSequenceDataset(str(tree), split, **kw)
    ws = jds.SemanticKittiSequenceDataset(str(tree), split, **kw)
    _eq(gs[0].positions(), ws[0].positions())
    # the sensor moved 1 m a scan in the world's velodyne frame
    steps = np.linalg.norm(np.diff(gs[0].positions(), axis=0), axis=1)
    np.testing.assert_allclose(steps, 1.0, atol=1e-6)


def test_scene_and_rasterizer(tree):
    got = tds.SemanticKittiSequenceDataset(str(tree), "train",
                                           included_labels=[10])
    want = jds.SemanticKittiSequenceDataset(str(tree), "train",
                                            included_labels=[10])
    gm, wm = SceneMaker(), JaxSceneMaker()
    for s in got.load_scan_numbers_in_sequence(got[0], range(6)):
        gm.add_scan(s)
    for s in want.load_scan_numbers_in_sequence(want[0], range(6)):
        wm.add_scan(s)
    for f in ("point_cloud", "sem_label", "inst_label"):
        _eq(getattr(gm.scene, f), getattr(wm.scene, f))
    for unseen in (True, False):
        r = SemanticKittiRasterizer(RANGE, RANGE, (-20, 20), 0.16,
                                    remove_unseen=unseen, min_points=1)
        jr = JaxRasterizer(RANGE, RANGE, (-20, 20), 0.16,
                           remove_unseen=unseen, min_points=1)
        for i in (0, 3, 5):
            mask, heights = r.get_mask_around(got.load_scan_index(i),
                                              gm.scene, return_heights=True)
            jmask, jheights = jr.get_mask_around(
                want.load_scan_index(i), wm.scene, return_heights=True)
            _eq(mask, jmask)
            assert heights == jheights
            assert mask.shape == (160, 160) and len(heights) >= 2


def _datasets(root, cache=True):
    c = KW
    return [m.SemanticKittiMaskDataset(
        d.SemanticKittiSequenceDataset(str(root), "train",
                                       included_labels=[10]),
        c["x_range"], c["y_range"], c["z_range"], c["voxel_size"],
        remove_unseen=True, min_points=1, use_cache=cache)
        for m, d in ((tmd, tds), (jmd, jds))]


@pytest.mark.parametrize("augment", [False, True])
def test_mask_scan_to_sample(tree, augment):
    got_ds, want_ds = _datasets(tree, cache=False)
    cfg, jcfg = MaskBevConfig(**KW), JaxConfig(**KW)
    gaug = tmd.SemanticKittiMaskDataModule(str(tree), cfg).augmentations
    jaug = jmd.SemanticKittiMaskDataModule(str(tree), jcfg).augmentations
    for i in range(len(want_ds)):
        ms, jms = got_ds[i], want_ds[i]
        _eq(ms.mask, jms.mask)
        assert ms.heights == jms.heights
        kw = [{}, {}]
        if augment:
            kw = [dict(augmentations=a, rng=np.random.default_rng([5, i]))
                  for a in (gaug, jaug)]
        s = tmd.mask_scan_to_sample(ms, cfg, **kw[0])
        _eq(s, jmd.mask_scan_to_sample(jms, jcfg, **kw[1]))
        # every GT row valid; padding rows carry label 0 and empty masks
        n = int(s["num_instances"])
        assert n >= 1 and s["gt_valid"].all()
        assert (s["gt_labels"][:n] == 1).all()
        assert (s["gt_labels"][n:] == 0).all()
        assert not s["gt_masks"][n:].any()


@pytest.mark.parametrize("split,workers", [("train", 0), ("train", 2),
                                           ("valid", 2)])
def test_batches(tree, split, workers):
    cfg = MaskBevConfig(**KW).replace(num_workers=workers)
    gdm = tmd.SemanticKittiMaskDataModule(str(tree), cfg, use_cache=False)
    jdm = jmd.SemanticKittiMaskDataModule(str(tree), JaxConfig(**KW),
                                          use_cache=False)
    fn = "train_batches" if split == "train" else "val_batches"
    got = list(getattr(gdm, fn)(7))
    want = list(getattr(jdm, fn)(7))
    assert len(got) == len(want) == (3 if split == "train" else 2)
    for g, w in zip(got, want):
        _eq(g, w)
        assert g["gt_masks"].shape == (2, 8, 160, 160)
        assert g["gt_valid"].all()


def test_mask_cache_both_directions(tree, tmp_path):
    for writer in (1, 0):  # 1: JAX writes and the port reads; 0: the reverse
        root = tmp_path / f"w{writer}"
        shutil.copytree(tree, root)
        sets = _datasets(root)
        made = [sets[writer][i] for i in range(len(sets[writer]))]
        cache = root / "dataset" / "masks_cache" / "0"
        assert sorted(p.name for p in cache.iterdir()) == sorted(
            f"{i}{s}" for i in range(6) for s in (".npy", ".heights.npy"))
        reader = sets[1 - writer]
        for i, ms in enumerate(made):
            got = reader[i]
            _eq(got.mask, ms.mask)
            assert got.heights == ms.heights
            # the stored layout is the reference's (x, y)
            _eq(np.load(cache / f"{i}.npy"), ms.mask.T)
        assert reader.cache_hit == 6 and reader.cache_miss == 0


def test_cache_warmer(tree, tmp_path):
    root = tmp_path / "warm"
    shutil.copytree(tree, root)
    tmd.main(["--root", str(root), "--x-range", *map(str, RANGE),
              "--y-range", *map(str, RANGE), "--processes", "2"])
    _, want_ds = _datasets(root)
    _, cold = _datasets(tree, cache=False)
    for i in range(len(want_ds)):
        _eq(want_ds[i].mask, cold[i].mask)
    assert want_ds.cache_hit == 6 and want_ds.cache_miss == 0


def test_test_batches_and_filter(tree):
    cfg = MaskBevConfig(**KW)
    got = list(tmd.SemanticKittiMaskDataModule(str(tree), cfg).test_batches())
    want = list(jmd.SemanticKittiMaskDataModule(
        str(tree), JaxConfig(**KW)).test_batches())
    assert len(got) == len(want) == 1
    _eq(got[0], want[0])
    assert set(got[0]) == {"points", "point_mask"}
    m = np.random.default_rng(0).integers(0, 6, (40, 40))
    for px in (0, 5, 300):
        _eq(tmd.filter_small_masks(m.copy(), px),
            jmd.filter_small_masks(m.copy(), px))
