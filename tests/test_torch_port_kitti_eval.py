"""The port's official KITTI AP evaluation and rotated IoU against the JAX
package's, on the same annos and boxes from a seed.

Held exactly (tolerance 0): the constants, ``get_thresholds``,
``clean_data``, every overlap (2D, BEV and 3D, the numpy
``rotate_iou_eval``), ``compute_statistics`` and
``compute_statistics_multi`` (which also equals the scalar loop),
``prepare_overlaps``, ``eval_class``, ``get_mAP``, ``_annos_have_alpha``
and the synthetic split of ``scripts/time_kitti_eval.py``. The official and
COCO results within 1e-6, on a synthetic split and on the known-answer
cases of ``tests/test_kitti_eval.py`` (perfect detection, false positives,
misses, a van ignored, AOS and the no-alpha sentinel). The batched torch
``rotated_iou_pair`` / ``rotated_iou_matrix`` against the jnp ones within
1e-5 (identical, disjoint, contained and 45-degree boxes, random boxes).
"""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mask_bev_tpu.evaluation import kitti_eval as jke  # noqa: E402
from mask_bev_tpu.ops import rotated_iou as jri  # noqa: E402
from mask_bev_tpu_torch.evaluation import kitti_eval as tke  # noqa: E402
from mask_bev_tpu_torch.ops import rotated_iou as tri  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
METRICS = ("bbox", "bev", "3d")


@pytest.fixture(scope="module")
def split():
    """60 frames of the synthetic split, with random 2D boxes and alphas on
    the detections (so bbox and AOS are exercised), as both packages'
    annos (the port's generator; the JAX package reads the same dicts)."""
    gts, dts = tke.synthetic_split(60, seed=5)
    rng = np.random.default_rng(6)
    for g, d in zip(gts, dts):
        n = len(g["name"])
        x1 = rng.uniform(0, 800, n)
        g["bbox"] = np.column_stack([x1, g["bbox"][:, 1], x1 + 60,
                                     g["bbox"][:, 3]])
        g["alpha"] = rng.uniform(-np.pi, np.pi, n)
        m = len(d["name"])
        d["bbox"] = np.column_stack([rng.uniform(0, 800, m), np.zeros(m),
                                     rng.uniform(850, 900, m),
                                     rng.uniform(20, 120, m)])
        d["alpha"] = rng.uniform(-np.pi, np.pi, m)
    return gts, dts


def _res_close(got, want):
    assert got.keys() == want.keys()
    for cls in want:
        assert got[cls].keys() == want[cls].keys()
        for metric in want[cls]:
            np.testing.assert_allclose(got[cls][metric], want[cls][metric],
                                       rtol=0, atol=1e-6)


def test_constants_and_split_generator():
    for name in ("CLASS_NAMES", "MIN_HEIGHT", "MAX_OCCLUSION",
                 "MAX_TRUNCATION", "N_SAMPLE_PTS", "DEFAULT_MIN_OVERLAPS",
                 "COCO_OVERLAP_RANGES"):
        assert getattr(tke, name) == getattr(jke, name), name
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        from time_kitti_eval import synth_split
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    for got, want in zip(tke.synthetic_split(25, seed=3),
                         synth_split(25, seed=3)):
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_thresholds():
    rng = np.random.default_rng(0)
    for n_scores, num_gt in ((0, 3), (5, 5), (37, 50), (120, 41), (80, 9)):
        scores = np.round(rng.uniform(0, 1, n_scores), 2)
        got = tke.get_thresholds(scores, num_gt)
        np.testing.assert_array_equal(got, jke.get_thresholds(scores, num_gt))
        assert (np.diff(got) <= 0).all()


@pytest.mark.parametrize("cls", [0, 1, 3])
@pytest.mark.parametrize("difficulty", [0, 1, 2])
def test_clean_data(split, cls, difficulty):
    gts, dts = split
    for g, d in zip(gts, dts):
        got = tke.clean_data(g, d, cls, difficulty)
        want = jke.clean_data(g, d, cls, difficulty)
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("metric", METRICS)
def test_overlaps(split, metric):
    gts, dts = split
    got = tke.prepare_overlaps(gts, dts, metric)
    want = jke.prepare_overlaps(gts, dts, metric)
    assert sum(o.size for o in want) > 200
    for g, w, gt, dt in zip(got, want, gts, dts):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(tke._frame_overlaps(gt, dt, metric), w)
    np.testing.assert_array_equal(tke._bev_boxes(gts[0]),
                                  jke._bev_boxes(gts[0]))
    np.testing.assert_array_equal(
        tke.image_box_overlap(np.zeros((0, 4)), np.ones((3, 4))),
        jke.image_box_overlap(np.zeros((0, 4)), np.ones((3, 4))))
    np.testing.assert_array_equal(tke.bev_box_overlap(gts[1], dts[1]),
                                  jke.bev_box_overlap(gts[1], dts[1]))
    np.testing.assert_array_equal(tke.d3_box_overlap(gts[2], dts[2]),
                                  jke.d3_box_overlap(gts[2], dts[2]))


def test_compute_statistics():
    """Scalar and threshold-vectorized matchers of both packages on random
    frames (ignored gts and dts, forced ties), and the vectorized one
    equal to the scalar loop threshold by threshold."""
    rng = np.random.default_rng(7)
    for _ in range(60):
        ng, nd = int(rng.integers(0, 9)), int(rng.integers(0, 12))
        ov = rng.uniform(0, 1, (ng, nd))
        if ng >= 2 and nd >= 2 and rng.random() < 0.5:
            ov[0, :] = ov[-1, :]
            ov[:, 0] = ov[:, -1]
        ig_gt = rng.choice([-1, 0, 0, 0, 1], ng)
        ig_dt = rng.choice([-1, 0, 0, 0, 1], nd)
        scores = np.round(rng.uniform(0, 1, nd), 2)
        ga = rng.uniform(-np.pi, np.pi, ng)
        da = rng.uniform(-np.pi, np.pi, nd)
        thr = np.round(np.sort(rng.uniform(0, 1, 5))[::-1], 2)
        args = (ov, ig_gt, ig_dt, scores, 0.5)
        multi = tke.compute_statistics_multi(*args, thr, gt_alphas=ga,
                                             dt_alphas=da)
        for a, b in zip(multi, jke.compute_statistics_multi(
                *args, thr, gt_alphas=ga, dt_alphas=da)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for ti, t in enumerate(thr):
            for fp in (False, True):
                got = tke.compute_statistics(*args, float(t), compute_fp=fp,
                                             gt_alphas=ga, dt_alphas=da)
                assert got == jke.compute_statistics(
                    *args, float(t), compute_fp=fp, gt_alphas=ga,
                    dt_alphas=da)
            assert got[:3] == (multi[0][ti], multi[1][ti], multi[2][ti])
            np.testing.assert_allclose(got[3], multi[3][ti], atol=1e-12)


@pytest.mark.parametrize("metric", METRICS)
def test_eval_class(split, metric):
    gts, dts = split
    ovs = tke.prepare_overlaps(gts, dts, metric)
    for cls, diff, aos in ((0, 0, metric == "bbox"), (0, 2, False),
                           (1, 1, False)):
        got = tke.eval_class(gts, dts, cls, diff, metric, 0.5,
                             compute_aos=aos, overlaps=ovs)
        want = jke.eval_class(gts, dts, cls, diff, metric, 0.5,
                              compute_aos=aos)
        np.testing.assert_array_equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None)
        if aos:
            np.testing.assert_array_equal(got[1], want[1])
        assert tke.get_mAP(got[0]) == jke.get_mAP(want[0])


def test_official_and_coco_results(split):
    gts, dts = split
    assert tke._annos_have_alpha(dts) and jke._annos_have_alpha(dts)
    got = tke.get_official_eval_result(gts, dts, current_classes=(0, 1))
    _res_close(got, jke.get_official_eval_result(gts, dts,
                                                 current_classes=(0, 1)))
    assert set(got["car"]) == {"bbox", "bev", "3d", "aos"}
    assert 0 < got["car"]["bev"][1] < 100
    _res_close(tke.get_coco_eval_result(gts, dts),
               jke.get_coco_eval_result(gts, dts))


# ---- the known-answer cases of tests/test_kitti_eval.py ----------------

def _gt(mod, centers, names=None):
    centers = np.asarray(centers, float).reshape(-1, 3)
    n = len(centers)
    return mod.gt_boxes_to_annos(centers, np.tile([4.0, 1.8, 1.5], (n, 1)),
                                 np.zeros(n), names or ["Car"] * n)


def _dt(mod, centers, scores):
    centers = np.asarray(centers, float).reshape(-1, 3)
    n = len(centers)
    boxes = np.stack([centers[:, 0], centers[:, 1], np.full(n, 1.8),
                      np.full(n, 4.0), np.zeros(n)], -1)
    return mod.boxes_to_annos(boxes, np.asarray(scores))


def _perfect(mod):
    rng = np.random.default_rng(0)
    gts, dts, score = [], [], 0.99
    for _ in range(10):
        c = np.column_stack([rng.uniform(-30, 30, 6),
                             rng.uniform(-30, 30, 6), np.zeros(6)])
        gts.append(_gt(mod, c))
        dts.append(_dt(mod, c, score - rng.uniform(0, 0.01, 6)))
        score -= 0.02
    return gts, dts


def _aos(mod, shift):
    gt = _gt(mod, [[10, 0, 0], [20, 5, 0]])
    gt["alpha"] = np.array([0.3, -0.7])
    dt = _dt(mod, [[10, 0, 0], [20, 5, 0]], [0.9, 0.8])
    dt["alpha"] = np.array([0.3 + shift, -0.7 + shift])
    return [gt], [dt]


def _sentinel(mod):
    gt, dt = _gt(mod, [[10, 0, 0]]), _dt(mod, [[10, 0, 0]], [0.9])
    dt["alpha"] = np.array([-10.0])
    return [gt], [dt]


CASES = {
    "perfect": _perfect,
    "false_positive": lambda m: ([_gt(m, [[10, 0, 0]])],
                                 [_dt(m, [[10, 0, 0], [30, 30, 0]],
                                      [0.5, 0.9])]),
    "misses": lambda m: ([_gt(m, [[10, 0, 0], [20, 0, 0]])],
                         [_dt(m, [[10, 0, 0]], [0.9])]),
    "van_ignored": lambda m: ([_gt(m, [[10, 0, 0]], names=["Van"])],
                              [_dt(m, [[10, 0, 0]], [0.9])]),
    "aos_exact": lambda m: _aos(m, 0.0),
    "aos_opposite": lambda m: _aos(m, np.pi),
    "no_alpha_sentinel": _sentinel,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_known_answers(case):
    gts, dts = CASES[case](tke)
    jgts, jdts = CASES[case](jke)
    got = tke.get_official_eval_result(gts, dts, current_classes=[0])
    _res_close(got, jke.get_official_eval_result(jgts, jdts,
                                                 current_classes=[0]))
    _res_close(tke.get_coco_eval_result(gts, dts, current_classes=[0]),
               jke.get_coco_eval_result(jgts, jdts, current_classes=[0]))
    car = got["car"]
    if case == "perfect":
        assert car["bev"] == pytest.approx([100.0] * 3, abs=1.0)
        assert car["3d"] == pytest.approx([100.0] * 3, abs=1.0)
    elif case == "false_positive":
        assert car["bev"][1] < 100.0
    elif case == "misses":
        prec, _ = tke.eval_class(gts, dts, 0, 1, "bev", 0.7)
        assert prec[0] == pytest.approx(1.0) and prec[-1] == 0.0
    elif case == "van_ignored":
        stats = tke.compute_statistics(
            np.array([[1.0]]), np.array([1]), np.array([0]),
            np.array([0.9]), min_overlap=0.7, score_threshold=0.0)
        assert stats[:3] == (0, 0, 0)
        assert tke.clean_data(gts[0], dts[0], 0, 1)[1].tolist() == [1]
    elif case == "aos_exact":
        assert car["aos"][1] == pytest.approx(car["bbox"][1])
    elif case == "aos_opposite":
        assert car["aos"][1] == pytest.approx(0.0, abs=1e-9)
    else:
        assert "aos" not in car


# ---- rotated IoU: numpy exactly, torch against jnp ----------------------

def _box(cx, cy, w, l, a):
    return np.array([cx, cy, w, l, a], np.float32)


PAIRS = {
    "identical": (_box(1, 2, 2, 4, 0.5), _box(1, 2, 2, 4, 0.5), 1.0),
    "disjoint": (_box(0, 0, 2, 2, 0.0), _box(10, 10, 2, 2, 0.7), 0.0),
    "shifted": (_box(0, 0, 2, 2, 0.0), _box(1, 1, 2, 2, 0.0), 1.0 / 7.0),
    "contained": (_box(0, 0, 4, 4, 0.3), _box(0, 0, 2, 2, 0.3), 0.25),
    "rot45": (_box(0, 0, 2, 2, 0.0), _box(0, 0, 2, 2, np.pi / 4),
              8 * (np.sqrt(2) - 1) / (8 - 8 * (np.sqrt(2) - 1))),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_rotated_iou_pairs(name):
    a, b, expect = PAIRS[name]
    got = float(tri.rotated_iou_pair(torch.as_tensor(a), torch.as_tensor(b)))
    want = float(jri.rotated_iou_pair(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= 1e-5
    assert got == pytest.approx(expect, abs=1e-4)
    np.testing.assert_array_equal(tri.rotate_iou_eval(a[None], b[None]),
                                  jri.rotate_iou_eval(a[None], b[None]))


def test_rotated_iou_random():
    """Random boxes (about a third of the pairs overlap): the torch matrix
    against the jnp one within 1e-5 and against the numpy host version,
    which both packages compute bit for bit alike; a batched pair call
    broadcasts as the matrix does."""
    rng = np.random.default_rng(11)

    def boxes(n):
        return np.column_stack([
            rng.uniform(-4, 4, n), rng.uniform(-4, 4, n),
            rng.uniform(0.5, 3, n), rng.uniform(0.5, 5, n),
            rng.uniform(-np.pi, np.pi, n)]).astype(np.float32)

    a, b = boxes(48), boxes(40)
    got = tri.rotated_iou_matrix(torch.as_tensor(a), torch.as_tensor(b))
    assert got.shape == (48, 40) and got.dtype == torch.float32
    want = np.asarray(jri.rotated_iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    host = tri.rotate_iou_eval(a, b)
    np.testing.assert_array_equal(host, jri.rotate_iou_eval(a, b))
    np.testing.assert_allclose(got.numpy(), host, rtol=0, atol=1e-5)
    assert 0.2 < (host > 0).mean() < 0.6
    pair = tri.rotated_iou_pair(torch.as_tensor(a[:5, None]),
                                torch.as_tensor(b[None, :7]))
    torch.testing.assert_close(pair, got[:5, :7], rtol=0, atol=0)
    assert tri.rotate_iou_eval(np.zeros((0, 5)), b).shape == (0, 40)
    f64 = tri.rotated_iou_matrix(torch.as_tensor(a, dtype=torch.float64),
                                 torch.as_tensor(b, dtype=torch.float64))
    np.testing.assert_allclose(f64.numpy(), host, rtol=0, atol=1e-6)
