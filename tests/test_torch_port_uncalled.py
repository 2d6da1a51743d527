"""The modules MaskBev does not call, against the JAX package's: the
pillarizer (``ops/voxelize.py``), FKAConv and DynamicEdgeConv
(``models/fkaconv.py``, ``models/dgcnn.py``, weights through
``models/convert.py::from_flax``), the trial-pruning hook
(``utils/prune_callback.py``) and the point-cloud viewer's numpy part
(``visualization/point_cloud_viz.py``).

Tolerances: the pillar buffers, the kNN indices, the camera matrices and the
box wireframes bit for bit; FKAConv and DynamicEdgeConv outputs, and
FKAConv's updated ``norm_radius``, within 1e-5 of the largest value (the
same f32 operations, in another order inside the products); FKAConv's
gradients within 1e-4 of each one's largest magnitude, the gradient
tolerance of ``test_torch_port_train_step.py`` (through two instance norms
over 5 neighbours the JAX package's f32 gradient is 1.8e-5 of the largest
value off its float64 value, the port's 6e-6).
"""
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.models import dgcnn as jdg  # noqa: E402
from mask_bev_tpu.models import fkaconv as jfk  # noqa: E402
from mask_bev_tpu.ops import voxelize as jvox  # noqa: E402
from mask_bev_tpu.visualization import point_cloud_viz as jviz  # noqa: E402
from mask_bev_tpu_torch.models import dgcnn, fkaconv  # noqa: E402
from mask_bev_tpu_torch.models.convert import from_flax  # noqa: E402
from mask_bev_tpu_torch.ops import voxelize  # noqa: E402
from mask_bev_tpu_torch.utils.prune_callback import (  # noqa: E402
    PruneCallback, TrialPruned)
from mask_bev_tpu_torch.visualization import (  # noqa: E402
    point_cloud_viz as viz)

GEO = dict(x_range=(-10.0, 10.0), y_range=(-10.0, 10.0), z_range=(-4.0, 4.0),
           voxel_size=0.5, max_points_per_pillar=8, max_pillars=256)


def _clouds(case: str):
    """(B, N, 4) clouds and masks of the JAX package's voxelize tests:
    random clouds past the range, 20 points in one cell (over K), 2000
    points over +-15 m, 2000 points over the 40 x 40 grid (over P = 256
    pillars), and fewer points than pillar slots."""
    rng = np.random.default_rng(0)
    if case == "random":
        pts = [rng.uniform(-12, 12, size=(500, 4)) for _ in range(3)]
        n = 600
    elif case == "over_k":
        p = np.zeros((20, 4))
        p[:, :2] = 0.26
        p[:, 3] = np.arange(20)
        pts, n = [p, p[::-1].copy()], 32
    elif case == "bounded":  # the JAX test's cloud over +-15 m
        pts = [rng.uniform(-15, 15, size=(2000, 4)) for _ in range(2)]
        n = 2048
    elif case == "over_p":  # ~900 occupied cells for 256 slots
        pts = [np.concatenate([rng.uniform(-12, 12, size=(2000, 2)),
                               rng.uniform(-3, 3, size=(2000, 2))], 1)
               for _ in range(2)]
        n = 2048
    else:  # fewer points than slots
        pts = [rng.uniform(-9, 9, size=(100, 4)) for _ in range(2)]
        n = 120
    padded = [jvox.pad_points(p.astype(np.float32), n, 4) for p in pts]
    got = [voxelize.pad_points(p.astype(np.float32), n, 4) for p in pts]
    for (a, am), (b, bm) in zip(padded, got):
        assert np.array_equal(a, b) and np.array_equal(am, bm)
    points = np.stack([p for p, _ in padded])
    mask = np.stack([m for _, m in padded])
    points[~mask] = 5.0  # garbage in the padding is ignored
    return points, mask


@pytest.mark.parametrize("case", ["random", "over_k", "bounded", "over_p",
                                  "few"])
def test_pillarize_batch_matches_jax_bitwise(case):
    points, mask = _clouds(case)
    want = jax.jit(lambda p, m: jvox.pillarize_batch(p, m, **GEO))(
        points, mask)
    got = voxelize.pillarize_batch(torch.as_tensor(points),
                                   torch.as_tensor(mask), **GEO)
    for name in ("feats", "num_points", "coords", "valid"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name
    if case == "over_k":
        assert int(got.num_points.max()) == GEO["max_points_per_pillar"]
    if case == "over_p":
        assert bool(got.valid.all())  # every slot taken: the cap cuts
    single = voxelize.pillarize(torch.as_tensor(points[0]),
                                torch.as_tensor(mask[0]), **GEO)
    assert torch.equal(single.feats, got.feats[0])


def _noisy(variables, seed):
    """flax variables with every leaf moved off its initial value."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.3 * rng.normal(size=np.shape(a)).astype(np.float32), variables)


@pytest.mark.parametrize("use_bias", [False, True])
def test_fkaconv_matches_jax(use_bias):
    rng = np.random.default_rng(1)
    b, s, k, i, d, o, ks = 2, 6, 5, 4, 3, 7, 4
    feats = rng.normal(size=(b, s, k, i)).astype(np.float32)
    rel = rng.normal(size=(b, s, k, d)).astype(np.float32)
    m = jfk.FKAConv(in_channels=i, out_channels=o, kernel_size=ks,
                    use_bias=use_bias)
    v = m.init(jax.random.PRNGKey(0), feats, rel, train=False)
    v = {"params": _noisy(v["params"], 2),
         "batch_stats": {"norm_radius": np.float32(1.7)}}
    port = fkaconv.FKAConv(i, o, kernel_size=ks, use_bias=use_bias)
    port.load_state_dict(from_flax(v), strict=True)
    ft, rt = torch.as_tensor(feats), torch.as_tensor(rel)

    want = np.asarray(m.apply(v, feats, rel, train=False))
    got = port(ft, rt, train=False)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert float(port.norm_radius) == np.float32(1.7)

    want, mut = m.apply(v, feats, rel, train=True, mutable=["batch_stats"])
    got = port(ft, rt, train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(float(port.norm_radius),
                               float(mut["batch_stats"]["norm_radius"]),
                               rtol=1e-5)

    # gradients through alpha, beta, the MLP and the final linear
    def jloss(p):
        return (m.apply({"params": p, "batch_stats": v["batch_stats"]},
                       feats, rel, train=False) ** 2).sum()
    want_g = from_flax({"params": jax.device_get(
        jax.grad(jloss)(v["params"]))})
    port.norm_radius.fill_(1.7)
    port.zero_grad()
    port(ft, rt, train=False).square().sum().backward()
    for name, p in port.named_parameters():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("aggr", ["max", "mean"])
def test_dynamic_edge_conv_matches_jax(aggr):
    rng = np.random.default_rng(3)
    b, n, c, o, k = 2, 12, 4, 6, 3
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = dgcnn.knn_indices(torch.as_tensor(x), k)
    assert np.array_equal(idx.numpy(),
                          np.asarray(jdg.knn_indices(jnp.asarray(x), k)))
    conv = jdg.make_edge_conv(c, o, k=k, aggr=aggr)
    v = {"params": _noisy(conv.init(jax.random.PRNGKey(0), x)["params"], 4)}
    want = np.asarray(conv.apply(v, x))
    port = dgcnn.make_edge_conv(c, o, k=k, aggr=aggr)
    port.load_state_dict(from_flax(v), strict=True)
    got = port(torch.as_tensor(x)).detach().numpy()
    assert got.shape == (b, n, o)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="unknown aggr"):
        dgcnn.DynamicEdgeConv(c, o, aggr="sum")


class FakeTrial:
    def __init__(self, prune_at):
        self.reports = []
        self.prune_at = prune_at

    def report(self, value, step):
        self.reports.append((value, step))

    def should_prune(self):
        return len(self.reports) >= self.prune_at


def test_prune_callback_with_a_fake_trial():
    trial = FakeTrial(prune_at=2)
    cb = PruneCallback(trial)
    cb.on_validation_end(0, {"val_loss": 3.5, "other": 1.0})
    assert trial.reports == [(3.5, 0)]
    with pytest.raises(TrialPruned, match="epoch 1"):
        cb.on_validation_end(1, {"val_loss": np.float32(2.5)})
    assert trial.reports == [(3.5, 0), (2.5, 1)]
    with pytest.warns(UserWarning, match="missing"):
        PruneCallback(FakeTrial(1), monitor="val_mIoU").on_validation_end(
            0, {"val_loss": 1.0})


def test_viewer_math_matches_jax_bitwise():
    for args in ((np.deg2rad(60), 4 / 3, 0.5, 100.0),
                 (np.deg2rad(50), 320 / 240, 0.5, 500.0)):
        assert np.array_equal(viz.perspective(*args), jviz.perspective(*args))
    for args in (((1, 2, 3), 10.0, 0.0, 0.0),
                 ((0, 0, 0), 60.0, -np.pi / 2, np.pi / 4)):
        eye = viz.orbit_eye(*args)
        assert np.array_equal(eye, jviz.orbit_eye(*args))
        assert np.array_equal(viz.look_at(eye, args[0], (0, 0, 1)),
                              jviz.look_at(eye, args[0], (0, 0, 1)))
    rng = np.random.default_rng(5)
    for boxes in (rng.uniform(-5, 5, size=(4, 5)),
                  rng.uniform(-5, 5, size=(3, 7)),
                  np.zeros((0, 5))):
        got = viz.box_wireframe(boxes)
        assert got.shape == (len(boxes) * 24, 3)
        assert np.array_equal(got, jviz.box_wireframe(boxes))
    labels = np.arange(25)
    assert np.array_equal(viz.label_colors(labels), jviz.label_colors(labels))
    shaders = sorted(p.name for p in viz._SHADER_DIR.iterdir())
    assert shaders == sorted(p.name for p in jviz._SHADER_DIR.iterdir())
    for name in shaders:
        assert ((viz._SHADER_DIR / name).read_text()
                == (jviz._SHADER_DIR / name).read_text())


def test_viewer_imports_no_opengl():
    code = ("import sys\n"
            "import mask_bev_tpu_torch.visualization.point_cloud_viz\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('OpenGL', 'glfw')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _egl_available() -> bool:
    try:
        viz._EglContext().close()
        return True
    except Exception:
        return False


@pytest.mark.skipif(not _egl_available(), reason="no surfaceless EGL")
def test_headless_render_matches_jax():
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-20, 20, (2000, 2)),
                          rng.uniform(-1, 1, (2000, 1)),
                          rng.uniform(0, 1, (2000, 1))], 1).astype(np.float32)
    labels = (np.linalg.norm(pts[:, :2], axis=1) < 8).astype(np.int64)
    boxes = np.array([[0.0, 0.0, 4.0, 8.0, 0.6]])
    got = viz.render_point_cloud(pts, labels, boxes, size=(160, 120))
    want = jviz.render_point_cloud(pts, labels, boxes, size=(160, 120))
    assert got.shape == (120, 160, 3)
    assert np.array_equal(got, want)
