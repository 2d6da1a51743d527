"""The rest of the JAX package's host modules that the port copies: the
stable-points data module and the torch morphology.

* ``datasets/semantic_kitti/stable_points.py`` on a SemanticKITTI tree
  written from a seed (``datasets/disk_trees.py``: train, valid and test
  sequences of a few hundred points a scan): the 80/20 split from the seed
  and every batch bit for bit against the JAX package's.
* ``ops/morphology.py``'s torch functions against the JAX package's
  ``jnp_dilate``, ``jnp_erode`` and ``jnp_close_then_open`` bit for bit, at
  k = 9 on odd shapes (and k = 3, 5), and against the host core's
  ``close_then_open`` and its numpy twin.
"""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mask_bev_tpu.config import MaskBevConfig as JaxConfig  # noqa: E402
from mask_bev_tpu.datasets.semantic_kitti.stable_points import (  # noqa: E402
    SemanticKittiStablePointsDataModule as JaxModule)
from mask_bev_tpu.ops import morphology as jmorph  # noqa: E402
from mask_bev_tpu_torch import native  # noqa: E402
from mask_bev_tpu_torch.config import MaskBevConfig  # noqa: E402
from mask_bev_tpu_torch.datasets.disk_trees import (  # noqa: E402
    write_semantic_kitti_tree)
from mask_bev_tpu_torch.datasets.semantic_kitti.stable_points import (  # noqa: E402
    SemanticKittiStablePointsDataModule)
from mask_bev_tpu_torch.ops import morphology as tmorph  # noqa: E402

KW = dict(dataset="semantic_kitti", max_points_per_scan=400, batch_size=2,
          shuffle_train=True)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_semantic_kitti_tree(
        tmp_path_factory.mktemp("sk"), seed=21, train_scans=5,
        valid_scans=3, test_scans=3, points=500, radius=12.0, spacing=6.0,
        lanes=(-3.0, 3.0), car_points=300.0)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("point_dim", [3, 4])
def test_split_and_batches(tree, seed, point_dim):
    cfg = MaskBevConfig(**KW, pc_point_dim=point_dim)
    got = SemanticKittiStablePointsDataModule(str(tree), cfg, seed=seed)
    want = JaxModule(str(tree), JaxConfig(**KW, pc_point_dim=point_dim),
                     seed=seed)
    assert got.train_indices == want.train_indices
    assert got.val_indices == want.val_indices
    assert len(got.train_indices) == 9 and len(got.val_indices) == 2  # 80/20
    assert sorted(got.train_indices + got.val_indices) == list(range(11))
    assert got._lengths == [5, 3, 3]
    for fn in ("train_batches", "val_batches"):
        g = list(getattr(got, fn)(seed + 1))
        w = list(getattr(want, fn)(seed + 1))
        assert len(g) == len(w) == (4 if fn == "train_batches" else 1)
        for a, b in zip(g, w):
            assert set(a) == set(b) == {"points", "point_mask"}
            for k in b:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k])
        assert g[0]["points"].shape == (2, 400, point_dim)
        assert g[0]["point_mask"].all()  # 500 points a scan, 400 slots
    with pytest.raises(IndexError):
        got._get_points(11)


def test_missing_splits(tree, tmp_path):
    """Splits whose sequences are absent are skipped, as in the JAX
    package."""
    only = tmp_path / "only_train"
    shutil.copytree(tree / "dataset" / "sequences" / "00",
                    only / "dataset" / "sequences" / "00")
    got = SemanticKittiStablePointsDataModule(str(only), MaskBevConfig(**KW))
    want = JaxModule(str(only), JaxConfig(**KW))
    assert got._lengths == want._lengths == [5]
    assert (got.train_indices, got.val_indices) == (want.train_indices,
                                                    want.val_indices)


def _masks(seed, h, w):
    """A sparse speckle with car-sized blobs and marks on the border."""
    rng = np.random.default_rng(seed)
    m = rng.random((h, w)) < 0.03
    for r, c in rng.integers(0, max(min(h, w) - 6, 1), (4, 2)):
        m[r:r + 14, c:c + 6] = True
    m[0, :3] = True
    m[-4:, -1] = True
    return m


@pytest.mark.parametrize("shape", [(37, 53), (101, 77), (9, 9), (5, 13),
                                   (161, 159)])
def test_torch_close_then_open_k9(shape):
    m = _masks(sum(shape), *shape)
    got = tmorph.torch_close_then_open(torch.as_tensor(m))
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    got = got.numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jmorph.jnp_close_then_open(jnp.asarray(m))))
    np.testing.assert_array_equal(got, tmorph.close_then_open(m))
    if shutil.which("g++"):
        np.testing.assert_array_equal(got, native.close_then_open(m))
    if min(shape) > 20:
        assert 0 < got.mean() < 1  # the cleanup kept and removed cells


@pytest.mark.parametrize("k", [3, 5, 9])
def test_torch_dilate_erode(k):
    m = _masks(k, 45, 31)
    x = torch.as_tensor(m)
    for t_fn, j_fn in ((tmorph.torch_dilate, jmorph.jnp_dilate),
                       (tmorph.torch_erode, jmorph.jnp_erode),
                       (tmorph.torch_close_then_open,
                        jmorph.jnp_close_then_open)):
        np.testing.assert_array_equal(t_fn(x, k).numpy(),
                                      np.asarray(j_fn(jnp.asarray(m), k)))
    # a border pixel survives erosion (outside reads 1); the float input
    # takes the same route as the bool one
    full = torch.ones(7, 7)
    assert bool(tmorph.torch_erode(full, k).all())
    stack = torch.as_tensor(np.stack([m, ~m, m]))
    batched = tmorph.torch_close_then_open(stack, k)
    for i in range(3):
        assert torch.equal(batched[i], tmorph.torch_close_then_open(
            stack[i], k))
