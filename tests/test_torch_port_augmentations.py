"""Every SemanticKITTI and KITTI augmentation of the port against the JAX
package's, from the same ``default_rng`` seed on the same scan.

Both packages draw numpy's generator in the same order, so points, masks
and boxes must be equal bit for bit (tolerance 0), and the generators must
end in the same state. Inputs are read from trees written by
``datasets/disk_trees.py``: a SemanticKITTI scan with its rasterized mask
(160x160 at 0.16 m) and KITTI frames with Car, Pedestrian and Cyclist
boxes; ``object_sample`` reads the ``samples.pkl`` of the port's
``datasets/kitti/object_sampler.py``.
"""
import copy
import dataclasses
import pathlib
import shutil

import numpy as np
import pytest

from mask_bev_tpu.augmentations import kitti_augmentations as jka
from mask_bev_tpu.augmentations import semantic_kitti_augmentations as jska
from mask_bev_tpu.datasets.kitti.kitti_dataset import (
    KittiDataset as JaxKittiDataset)
from mask_bev_tpu_torch.augmentations import kitti_augmentations as tka
from mask_bev_tpu_torch.augmentations import (
    semantic_kitti_augmentations as tska)
from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.datasets.disk_trees import (
    write_kitti_tree, write_semantic_kitti_tree)
from mask_bev_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset
from mask_bev_tpu_torch.datasets.kitti.object_sampler import write_samples
from mask_bev_tpu_torch.datasets.semantic_kitti.dataset import (
    SemanticKittiSequenceDataset)
from mask_bev_tpu_torch.datasets.semantic_kitti.mask_data import (
    SemanticKittiMaskDataset)

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None,
    reason="g++ not found on PATH: the port's host core cannot be built")

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEEDS = (0, 1, 2)
RAND = {"name": "rand_augment", "num_augments": 2, "magnitude": 0.7}

SK_AUGS = {
    "flip_x": {"name": "flip", "prob_flip_x": 1.0, "prob_flip_y": 0.0},
    "flip_y": {"name": "flip", "prob_flip_x": 0.0, "prob_flip_y": 1.0},
    "shuffle": {"name": "shuffle", "prob_shuffle": 1.0},
    "rotate": {"name": "rotate", "rotate_prob": 1.0, "rotation_range": 5},
    "decimate": {"name": "decimate", "prob_decimate": 1.0, "keep_every": 2},
    "jitter": {"name": "jitter", "prob_jitter": 1.0, "jitter_std": 0.02,
               "max_delta": 0.05, "intensity_std": 0.01,
               "intensity_max_delta": 0.02},
    "drop": {"name": "drop", "prob_drop": 1.0, "per_point_drop_prob": 0.1},
    "cut_pc": {"name": "cut_pc", "prob_cut": 1.0},
    "rand_augment": {**RAND, "transforms": [
        {"name": "flip", "prob_flip_x": 0.5, "prob_flip_y": 0.5},
        {"name": "rotate", "rotate_prob": 1.0, "rotation_range": 10},
        {"name": "drop", "prob_drop": 1.0, "per_point_drop_prob": 0.2}]},
}
KITTI_AUGS = {
    "flip": {"name": "flip", "prob_flip_x": 0, "prob_flip_y": 1.0},
    "shuffle": {"name": "shuffle", "prob_shuffle": 1.0},
    "rotate": {"name": "rotate", "rotate_prob": 1.0, "rotation_range": 2.5},
    "decimate": {"name": "decimate", "prob_decimate": 1.0, "keep_every": 3},
    "jitter": {"name": "jitter", "prob_jitter": 1.0, "jitter_std": 0.01,
               "intensity_std": 0.01},
    "drop": {"name": "drop", "prob_drop": 1.0, "per_point_drop_prob": 0.05},
    "cut_pc": {"name": "cut_pc", "prob_cut": 1.0},
    "global_noise": {"name": "global_noise", "prob_aug": 1.0},
    "object_noise": {"name": "object_noise"},
    "object_sample": {"name": "object_sample", "num_sample": 15},
    "rand_augment": {**RAND, "transforms": [
        {"name": "rotate", "rotate_prob": 1.0, "rotation_range": 10},
        {"name": "global_noise", "prob_aug": 1.0},
        {"name": "object_noise", "num_try": 20}]},
}


@pytest.fixture(scope="module")
def sk_scan(tmp_path_factory):
    root = write_semantic_kitti_tree(
        tmp_path_factory.mktemp("sk"), seed=5, train_scans=3, valid_scans=0,
        points=3000, radius=16.0, spacing=6.0, lanes=(-3.5, 3.5),
        car_points=2000.0)
    ds = SemanticKittiMaskDataset(
        SemanticKittiSequenceDataset(str(root), "train",
                                     included_labels=[10]),
        (-12.8, 12.8), (-12.8, 12.8), (-20, 20), 0.16, remove_unseen=True,
        min_points=1, use_cache=False)
    ms = ds[1]
    assert len(np.unique(ms.mask)) >= 3  # background and two cars or more
    return ms.scan.point_cloud.astype(np.float32), ms.mask


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = write_kitti_tree(tmp_path_factory.mktemp("kitti"), seed=6,
                            frames=3, train=2, points=3000, boxes=(5, 8),
                            radius=20.0)
    write_samples(str(root), log_every=0)
    return root


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(SK_AUGS))
def test_semantic_kitti_augmentation(sk_scan, name, seed):
    points, mask = sk_scan
    got_aug = tska.make_augmentation(SK_AUGS[name])
    want_aug = jska.make_augmentation(SK_AUGS[name])
    g_rng, w_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    gp, gm = got_aug((points.copy(), mask.copy()), g_rng)
    wp, wm = want_aug((points.copy(), mask.copy()), w_rng)
    for g, w in ((gp, wp), (gm, wm)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert g_rng.bit_generator.state == w_rng.bit_generator.state
    if name not in ("rand_augment",):  # every transform fired
        assert not (gp.shape == points.shape and np.array_equal(gp, points)
                    and np.array_equal(gm, mask))


def test_rotate_mask_nearest(sk_scan):
    _, mask = sk_scan
    for theta in (-0.3, 0.05, 1.2):
        np.testing.assert_array_equal(tska.rotate_mask_nearest(mask, theta),
                                      jska.rotate_mask_nearest(mask, theta))


def _frame_eq(g, w):
    np.testing.assert_array_equal(g.points, w.points)
    assert g.points.dtype == w.points.dtype
    for f in dataclasses.fields(w.boxes):
        a, b = getattr(g.boxes, f.name), getattr(w.boxes, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(KITTI_AUGS))
def test_kitti_augmentation(kitti_root, name, seed):
    args = copy.deepcopy(KITTI_AUGS[name])
    if name == "object_sample":
        args["dataset_root"] = str(kitti_root)
    got_aug = tka.make_augmentation(args)
    want_aug = jka.make_augmentation(copy.deepcopy(args))
    idx = seed % 3
    g = KittiDataset(str(kitti_root))[idx]
    w = JaxKittiDataset(str(kitti_root))[idx]
    n_points, n_boxes = len(g.points), len(g.boxes)
    g_rng, w_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    g = got_aug(g, g_rng)
    w = want_aug(w, w_rng)
    _frame_eq(g, w)
    assert g_rng.bit_generator.state == w_rng.bit_generator.state
    if name == "object_sample" and seed:
        assert len(g.boxes) > n_boxes and len(g.points) != n_points


def test_shipped_kitti_list(kitti_root):
    """The ten transforms of 01_kitti.yml in order, over every frame."""
    augs = MaskBevConfig.from_yaml(
        ROOT / "configs/training/kitti/01_kitti.yml").augmentations
    augs = [dict(a, dataset_root=str(kitti_root))
            if a["name"] == "object_sample" else a for a in augs]
    got_list = tka.make_kitti_augmentation_list(copy.deepcopy(augs))
    want_list = jka.make_kitti_augmentation_list(copy.deepcopy(augs))
    for idx in range(3):
        g_rng = np.random.default_rng([9, idx])
        w_rng = np.random.default_rng([9, idx])
        g = tka.apply_augmentations(KittiDataset(str(kitti_root))[idx],
                                    got_list, g_rng)
        w = jka.apply_augmentations(JaxKittiDataset(str(kitti_root))[idx],
                                    want_list, w_rng)
        _frame_eq(g, w)
