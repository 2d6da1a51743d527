"""Masks -> rotated boxes in the port against the JAX package: the
min-area rectangle (rotating calipers), the largest-component box of a
mask, ``mask_to_boxes`` and the annos glue, on random and edge masks (empty,
one pixel, a line, rotated rectangles, two components), to 1e-9; and
``MaskBevPredictor.predict_batch(...).boxes`` against the JAX predictor on
``tiny_test_config()`` with the same weights.

The two predictors' probabilities agree to 1e-4 (f32 forwards summed in
another order); their boxes are compared where that cannot move a mask's
0.5 threshold: every kept query's mask probabilities stay farther from 0.5
than that tolerance on this seeded input (asserted), so the thresholded
masks are equal and the boxes agree to 1e-9.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from mask_bev_tpu.evaluation import average_precision as jap  # noqa: E402
from mask_bev_tpu.evaluation import kitti_eval as jke  # noqa: E402
from mask_bev_tpu.evaluation import min_area_rect as jmar  # noqa: E402
from mask_bev_tpu.inference import (  # noqa: E402
    MaskBevPredictor as JaxPredictor)
from mask_bev_tpu.models.maskbev import MaskBev as JaxMaskBev  # noqa: E402
from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.evaluation import (  # noqa: E402
    average_precision as tap, kitti_eval as tke, min_area_rect as tmar)
from mask_bev_tpu_torch.inference import MaskBevPredictor  # noqa: E402
from mask_bev_tpu_torch.models.convert import from_flax  # noqa: E402


def _rect_mask(h, w, cx, cy, length, width, yaw):
    yy, xx = np.mgrid[:h, :w]
    dx, dy = xx - cx, yy - cy
    c, s = np.cos(yaw), np.sin(yaw)
    return ((np.abs(dx * c + dy * s) <= length / 2)
            & (np.abs(-dx * s + dy * c) <= width / 2))


def _masks():
    rng = np.random.default_rng(0)
    h, w = 40, 56
    out = {"empty": np.zeros((h, w), bool)}
    one = np.zeros((h, w), bool)
    one[7, 11] = True
    out["one pixel"] = one
    line = np.zeros((h, w), bool)
    line[20, 5:40] = True
    out["line"] = line
    diag = np.zeros((h, w), bool)
    diag[np.arange(30), np.arange(30) + 3] = True
    out["diagonal"] = diag
    for i, yaw in enumerate((0.0, 0.3, -1.1, np.pi / 4)):
        out[f"rect {yaw:.2f}"] = _rect_mask(h, w, 25 + i, 18, 20, 8, yaw)
    two = _rect_mask(h, w, 10, 10, 6, 4, 0.5) | _rect_mask(h, w, 40, 25, 14,
                                                          9, -0.4)
    out["two components"] = two
    for i in range(4):
        out[f"random {i}"] = rng.uniform(size=(h, w)) > 0.7
    return out


MASKS = _masks()


@pytest.mark.parametrize("name", list(MASKS))
@pytest.mark.parametrize("scale", [(1.0, 1.0), (0.16, 0.25)])
def test_mask_to_min_area_box(name, scale):
    want = jap.mask_to_min_area_box(MASKS[name], scale=scale)
    got = tap.mask_to_min_area_box(MASKS[name], scale=scale)
    if want is None:
        assert got is None
        return
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)


def test_min_area_rect_on_point_sets():
    rng = np.random.default_rng(1)
    for n in (1, 2, 3, 7, 50, 400):
        pts = rng.normal(size=(n, 2)) * [3.0, 0.7]
        want = jmar.min_area_rect(pts)
        got = tmar.min_area_rect(pts)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
        np.testing.assert_allclose(tmar.rect_corners(*got),
                                   jmar.rect_corners(*want), rtol=0,
                                   atol=1e-9)
        np.testing.assert_array_equal(tmar.convex_hull(pts),
                                      jmar.convex_hull(pts))


def test_mask_to_boxes_and_annos():
    rng = np.random.default_rng(2)
    cfg_t, cfg_j = tiny_test_config(), jax_tiny()
    masks = np.stack([MASKS[k].astype(np.float64) * 0.9 + 0.05
                      for k in MASKS])[:, :20, :20]
    q = masks.shape[0]
    cls = rng.dirichlet(np.ones(2), size=q)
    cls[:3] = [0.9, 0.1]  # background queries are skipped
    for thr in (0.0, 0.5):
        want = jke.mask_to_boxes(cls, masks, cfg_j, score_threshold=thr)
        got = tke.mask_to_boxes(cls, masks, cfg_t, score_threshold=thr)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
    boxes, scores, _ = got
    assert len(boxes) > 0
    for g, w in zip(tke.boxes_to_annos(boxes, scores).items(),
                    jke.boxes_to_annos(boxes, scores).items()):
        assert g[0] == w[0]
        np.testing.assert_array_equal(g[1], w[1])
    args = (rng.normal(size=(3, 3)), rng.uniform(1, 4, (3, 3)),
            rng.uniform(-3, 3, 3), ["Car"] * 3)
    for g, w in zip(tke.gt_boxes_to_annos(*args).items(),
                    jke.gt_boxes_to_annos(*args).items()):
        assert g[0] == w[0]
        np.testing.assert_array_equal(g[1], w[1])


def _variables(cfg, pts, mask, seed=1):
    shapes = jax.eval_shape(lambda: JaxMaskBev(cfg).init(
        jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask),
        train=False))
    rng = np.random.default_rng(seed)

    def value(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        r = rng.normal(size=s.shape).astype(np.float32)
        if name == "var":
            return 0.5 + rng.uniform(size=s.shape)
        if name in ("mean", "bias"):
            return 0.05 * r
        if name == "scale":
            return 1.0 + 0.1 * r
        if name == "kernel":
            return r / np.sqrt(np.prod(s.shape[:-1]))
        if name == "rel_pos_bias_table":
            return 0.02 * r
        return r
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(value(p, s), np.float32), shapes)


def test_predictor_boxes_match_jax():
    jcfg, tcfg = jax_tiny(), tiny_test_config()
    rng = np.random.default_rng(3)
    n = jcfg.max_points_per_scan
    pts = np.stack([rng.uniform(-9.9, 9.9, (2, n)),
                    rng.uniform(-9.9, 9.9, (2, n)),
                    rng.uniform(-3, 3, (2, n)), rng.uniform(0, 1, (2, n))],
                   -1).astype(np.float32)
    msk = np.ones((2, n), bool)
    msk[1, 1500:] = False
    v = _variables(jcfg, pts, msk)
    want = JaxPredictor(jcfg, v).predict_batch(pts, msk, score_threshold=0.0)
    port = MaskBevPredictor(tcfg, from_flax(v), device="cpu")
    got = port.predict_batch(pts, msk, score_threshold=0.0)
    cls_t, mask_t = port.forward(torch.as_tensor(pts), torch.as_tensor(msk))
    n_boxes = 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_allclose(g.scores, w.scores, rtol=0, atol=1e-4)
        np.testing.assert_allclose(g.mask_probs, w.mask_probs, rtol=0,
                                   atol=1e-4)
        assert np.abs(g.mask_probs - 0.5).min() > 1e-4
        np.testing.assert_array_equal(g.masks, w.masks)
        assert g.boxes.shape == w.boxes.shape
        np.testing.assert_allclose(g.boxes, w.boxes, rtol=0, atol=1e-9)
        n_boxes += len(g.boxes)
    assert n_boxes > 0
    # the boxes are mask_to_boxes of the predictor's own probabilities
    for b, g in enumerate(got):
        boxes, _, _ = tke.mask_to_boxes(cls_t[b].numpy(), mask_t[b].numpy(),
                                        tcfg, score_threshold=0.0)
        np.testing.assert_array_equal(g.boxes, boxes)
