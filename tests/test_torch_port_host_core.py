"""The port's C++ host core (``mask_bev_tpu_torch/native.py``) against its
numpy twins and against the JAX package's host ops, bit for bit.

The JAX package's ``mask_bev_tpu.native`` runs its own numpy fallback
where its library is not built, and its C++ otherwise; either way each
entry point must give the port's result exactly (tolerance 0). The fill
and the in-box counts compare float32 C++ arithmetic with float64 or
numpy float32 arithmetic: they could part only for a cell centre or a
point within float32 rounding of a box edge, which these seeded inputs
do not hold. The host core is built at first call from the checkout's
source; without ``g++`` these tests skip.
"""
import shutil

import numpy as np
import pytest

from mask_bev_tpu import native as jax_native
from mask_bev_tpu.augmentations.box_ops import points_in_rbbox
from mask_bev_tpu.datasets.kitti.kitti_dataset import BoxArray
from mask_bev_tpu.datasets.kitti.kitti_rasterizer import (
    fill_rotated_boxes as jax_fill,
    points_in_boxes_count as jax_count)
from mask_bev_tpu.ops.morphology import close_then_open as jax_cto
from mask_bev_tpu_torch import native
from mask_bev_tpu_torch.datasets.kitti.kitti_rasterizer import (
    fill_rotated_boxes_img, points_in_boxes_count)
from mask_bev_tpu_torch.ops.morphology import close_then_open

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None,
    reason="g++ not found on PATH: the port's host core cannot be built")


@pytest.mark.parametrize("shape", [(64, 64), (120, 140), (200, 200),
                                   (500, 500)])
@pytest.mark.parametrize("k", [3, 9])
def test_close_then_open(shape, k):
    rng = np.random.default_rng(shape[0] * 10 + k)
    m = rng.random(shape) < 0.03
    m[10:40, 20:60] = True  # a blob that survives the opening
    got = native.close_then_open(m, k)
    assert got.dtype == bool and got.shape == shape
    np.testing.assert_array_equal(got, close_then_open(m, k))
    np.testing.assert_array_equal(got, jax_cto(m, k))
    np.testing.assert_array_equal(got, jax_native.close_then_open(m, k))
    assert got.any() and not np.array_equal(got, m)


def test_close_then_open_leaves_its_input():
    m = np.zeros((30, 30), bool)
    m[5:20, 5:20] = True
    m[25, 25] = True
    before = m.copy()
    native.close_then_open(m, 9)
    np.testing.assert_array_equal(m, before)


def _boxes(rng, n):
    centers = rng.uniform(-15, 15, (n, 2)).astype(np.float32)
    dims = np.stack([rng.uniform(3.5, 5.0, n),
                     rng.uniform(1.5, 2.0, n)], 1).astype(np.float32)
    yaws = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    return centers, dims, yaws


@pytest.mark.parametrize("hw,voxel", [((100, 100), 0.5), ((80, 200), 0.25)])
def test_fill_rotated_boxes(hw, voxel):
    rng = np.random.default_rng(hw[1])
    centers, dims, yaws = _boxes(rng, 12)
    keep = (rng.random(12) < 0.8).astype(np.uint8)
    h, w = hw
    x0, y0 = -w * voxel / 2, -h * voxel / 2
    got = native.fill_rotated_boxes_img(h, w, centers, dims, yaws, keep,
                                        x0, y0, voxel)
    assert got.dtype == np.int32 and got.shape == hw
    np.testing.assert_array_equal(
        got, fill_rotated_boxes_img(h, w, centers, dims, yaws, keep, x0, y0,
                                    voxel))
    # the JAX package's rasterizer fill without its library
    foot = jax_fill(centers, dims, yaws, (x0, -x0), (y0, -y0), voxel)
    want = np.zeros(hw, np.int32)
    for i in range(12):
        if keep[i]:
            want[foot[i]] = i + 1
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 5  # boxes land in the grid


def test_points_in_boxes_count():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-20, 20, (5000, 4)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 1, 5000)
    centers, dims2, yaws = _boxes(rng, 9)
    centers3 = np.concatenate(
        [centers, np.full((9, 1), -1.5, np.float32)], 1)
    dims3 = np.concatenate(
        [dims2, np.full((9, 1), 1.6, np.float32)], 1)
    got = native.points_in_boxes_count(pts, centers3, dims3, yaws)
    assert got.dtype == np.int32 and got.sum() > 0
    boxes = BoxArray(centers3, dims3, yaws, *([np.zeros(9)] * 7))
    np.testing.assert_array_equal(got, points_in_boxes_count(pts, boxes))
    np.testing.assert_array_equal(got, jax_count(pts, boxes))
    np.testing.assert_array_equal(
        got, points_in_rbbox(pts, centers3, dims3[:, :2], yaws,
                             z0=centers3[:, 2], heights=dims3[:, 2]).sum(0))


def test_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" { int f( { return 0; } }\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="failed to build") as e:
        native.build()
    assert "error" in str(e.value)
    assert not list((tmp_path / "_build").rglob("*.so"))


def test_build_is_cached_by_source(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    first = native.build()
    stamp = first.stat().st_mtime_ns
    assert native.build() == first and first.stat().st_mtime_ns == stamp
    assert first.parent.name.startswith("host-")
    assert [p.name for p in first.parent.iterdir()] == [first.name]


def test_entry_points_check_shapes():
    n3 = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="centers"):
        native.fill_rotated_boxes_img(10, 10, np.zeros((2, 2)),
                                      np.zeros((3, 2)), np.zeros(3),
                                      np.ones(3), 0.0, 0.0, 1.0)
    with pytest.raises(ValueError, match="dims3"):
        native.points_in_boxes_count(np.zeros((5, 4)), n3, n3[:2],
                                     np.zeros(3))
    with pytest.raises(ValueError, match="points"):
        native.points_in_boxes_count(np.zeros((5, 2)), n3, n3, np.zeros(3))
    with pytest.raises(ValueError, match="mask"):
        native.close_then_open(np.zeros((2, 3, 4), bool))
