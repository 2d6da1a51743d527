"""The port's training encoder against the JAX package's training path:
the capped stream pillarizer, the windowed segment reductions, masked batch
norm in train mode, the whole encoder forward with its running-statistics
update, and the canvas scatter with its gradient.

Tolerances: integer and boolean outputs, the windowed max and the canvas
scatter and its gradient exactly (the same values, only moved or compared);
the windowed sum to 1 f32 step (2^-23 relative, the same adds in the same
order); batch norm to 1e-5 absolute on values of unit scale and the f32
encoder to 1e-5 of the canvas's largest magnitude (the same f32 arithmetic,
sums taken in another order). The bf16 encoder: largest error 2^-5 of the
canvas's largest magnitude and mean error 1 % of its mean magnitude, the
running statistics to 1e-2 relative. In bf16 the two frameworks round at
different places (XLA may keep f32 between fused bf16 operations, the port
rounds after each), the batch statistics round the sums and the point count
to bf16, and a pillar-centre offset near |x| = 10 m moves in steps of 2^-4.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.models.encoder import (  # noqa: E402
    MaskBevEncoder as JaxEncoder, MaskedBatchNorm as JaxBN,
    scatter_to_canvas)
from mask_bev_tpu.ops import stream_pillars as jsp  # noqa: E402
from mask_bev_tpu_torch.models.convert import load_flax  # noqa: E402
from mask_bev_tpu_torch.models.encoder import (  # noqa: E402
    MaskBevEncoder, MaskedBatchNorm)
from mask_bev_tpu_torch.ops import stream_pillars as tsp  # noqa: E402
from mask_bev_tpu_torch.ops.canvas import (  # noqa: E402
    canvas_gather_plain, canvas_scatter, canvas_scatter_plain)

GEO = dict(x_range=(-10.0, 10.0), y_range=(-10.0, 10.0),
           z_range=(-4.0, 4.0), voxel_size=0.5)
H = W = 40
K = 8
FC = (16, 16, 32)
CAP = 160  # smaller than the occupied cells of every sample


def _points(seed=0, b=2, n=1024):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-9.8, 9.8, (b, n, 4)).astype(np.float32)
    pts[:, :, 2] = rng.uniform(-3, 3, (b, n))
    r = min(300, n // 3)
    pts[0, :r, :2] = 2.1 + rng.uniform(0, 0.3, (r, 2))  # runs > K
    pts[0, n - n // 8:n - n // 16, 0] = 30.0           # out of range
    msk = np.ones((b, n), bool)
    msk[1, n * 2 // 3:] = False
    return pts, msk


def _jax_stream(pts, msk, cap=CAP):
    return jsp.pillarize_stream_batch(
        jnp.asarray(pts), jnp.asarray(msk), max_points_per_pillar=K,
        max_pillars=cap, **GEO)


def _port_stream(pts, msk, cap=CAP, dtype=torch.float32):
    return tsp.pillarize_stream(
        torch.as_tensor(pts).to(dtype), torch.as_tensor(msk),
        max_points_per_pillar=K, max_pillars=cap, **GEO)


def _assert_same_stream(got, want):
    """The port's stream and directory equal the JAX package's; its cells
    are the reference's (iy, ix) coords flattened, ascending, with the
    ``H*W`` sentinel on unused slots."""
    np.testing.assert_array_equal(got.pts.numpy(), np.asarray(want.pts))
    for name in ("pid", "kept", "starts", "valid"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name)
    v = got.valid.numpy()
    cells = got.cells.numpy()
    c = np.asarray(want.coords)
    np.testing.assert_array_equal(cells[v], (c[..., 0] * W + c[..., 1])[v])
    assert (cells[~v] == H * W).all()
    assert (np.diff(cells, axis=1) >= 0).all()  # ascending, sentinel last


def test_pillarize_stream_matches_jax_with_the_cap():
    pts, msk = _points()
    want = _jax_stream(pts, msk)
    occupied = [len(np.unique(np.asarray(want.pid)[b][np.asarray(
        want.pid)[b] < H * W])) for b in range(2)]
    assert min(occupied) > CAP  # the cap cuts real cells
    _assert_same_stream(_port_stream(pts, msk), want)


def test_pillarize_stream_more_slots_than_points():
    pts, msk = _points(seed=1, n=96)
    want = _jax_stream(pts, msk, cap=128)
    assert not np.asarray(want.valid).all()  # unused slots
    _assert_same_stream(_port_stream(pts, msk, cap=128), want)


@pytest.mark.parametrize("k", [1, 5, 8])
def test_windowed_segment_reductions_match_jax(k):
    pts, msk = _points(seed=2)
    sp = _jax_stream(pts, msk)
    pid = np.asarray(sp.pid)
    rng = np.random.default_rng(k)
    vals = rng.normal(size=pid.shape + (6,)).astype(np.float32)
    vals[~np.asarray(sp.kept)] = 0.0
    tv, tp = torch.as_tensor(vals), torch.as_tensor(pid.copy())
    for sym in (True, False):
        want = jsp.windowed_segment_max(jnp.asarray(vals), jnp.asarray(pid),
                                        k, symmetric=sym)
        got = tsp.windowed_segment_max(tv, tp, k, symmetric=sym)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jsp.windowed_segment_sum(jnp.asarray(vals), jnp.asarray(pid), k)
    got = tsp.windowed_segment_sum(tv, tp, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2 ** -23,
                               atol=1e-6)
    starts = np.array(sp.starts)  # writable copies for torch.as_tensor
    valid = np.array(sp.valid)
    want = jsp.gather_at_starts(jnp.asarray(vals), jnp.asarray(starts),
                                jnp.asarray(valid))
    got = tsp.gather_at_starts(tv, torch.as_tensor(starts).long(),
                               torch.as_tensor(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_masked_batch_norm_train_matches_flax():
    rng = np.random.default_rng(3)
    x = rng.normal(1.0, 2.0, size=(2, 64, 12)).astype(np.float32)
    mask = rng.uniform(size=(2, 64)) < 0.6
    bn = JaxBN(12)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
                use_running_average=False)
    v = jax.tree.map(lambda a: np.asarray(a) + 0.3 * rng.uniform(
        size=a.shape).astype(np.float32), jax.device_get(v))
    want, mut = bn.apply(v, jnp.asarray(x), jnp.asarray(mask),
                         use_running_average=False, mutable=["batch_stats"])
    port = MaskedBatchNorm(12)
    with torch.no_grad():
        port.weight.copy_(torch.as_tensor(v["params"]["scale"]))
        port.bias.copy_(torch.as_tensor(v["params"]["bias"]))
        port.running_mean.copy_(torch.as_tensor(v["batch_stats"]["mean"]))
        port.running_var.copy_(torch.as_tensor(v["batch_stats"]["var"]))
    got = port(torch.as_tensor(x), torch.as_tensor(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    assert (got.detach().numpy()[~mask] == 0).all()
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=0, atol=1e-6)
    assert port.running_mean.dtype == torch.float32


@pytest.fixture(scope="module")
def encoder_case():
    pts, msk = _points(seed=4)
    enc = JaxEncoder(feat_channels=FC, max_points_per_pillar=K,
                     max_pillars=CAP, pseudo_image_norm="full", **GEO)
    v = enc.init(jax.random.PRNGKey(1), jnp.asarray(pts), jnp.asarray(msk),
                 train=False)
    rng = np.random.default_rng(5)
    v = jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(x) + 0.3 * rng.uniform(size=x.shape).astype(
            np.float32) if ("batch_stats" in str(p[0]) or "norm" in str(p))
        else np.asarray(x), jax.device_get(v))
    return enc, v, pts, msk


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_train_forward_matches_jax(encoder_case, dtype):
    enc, v, pts, msk = encoder_case
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jv = {"params": jax.tree.map(lambda a: jnp.asarray(a, jd), v["params"]),
          "batch_stats": v["batch_stats"]}
    want, mut = enc.apply(jv, jnp.asarray(pts, jd), jnp.asarray(msk),
                          train=True, mutable=["batch_stats"])
    port = MaskBevEncoder(GEO["x_range"], GEO["y_range"], GEO["z_range"],
                          GEO["voxel_size"], feat_channels=FC,
                          max_points_per_pillar=K, max_pillars=CAP)
    load_flax(port, v)
    for name, p in port.named_parameters():
        p.data = p.data.to(td)
    got = port(torch.as_tensor(pts).to(td), torch.as_tensor(msk),
               train=True)
    want = np.asarray(want.astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == (2, H, W, FC[-1])
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    else:
        err = np.abs(got - want)
        assert err.max() <= 2 ** -5 * np.abs(want).max()
        assert err.mean() <= 1e-2 * np.abs(want).mean()
    sd = port.state_dict()
    for i in range(len(FC)):
        jbs = mut["batch_stats"]["pillar_feature_net"][f"pfn_{i}"]["norm"]
        for jn, tn in (("mean", "running_mean"), ("var", "running_var")):
            t = sd[f"pillar_feature_net.pfn_{i}.norm.{tn}"]
            assert t.dtype == torch.float32
            np.testing.assert_allclose(
                t.numpy(), np.asarray(jbs[jn]),
                rtol=1e-5 if dtype == "float32" else 1e-2, atol=1e-6)


def test_canvas_scatter_plain_forward_and_grad_match_jax():
    pts, msk = _points(seed=6)
    sp = _jax_stream(pts, msk)
    rng = np.random.default_rng(7)
    table = rng.normal(size=(2, CAP, 8)).astype(np.float32)
    table[~np.asarray(sp.valid)] = 0.0
    cot = rng.normal(size=(2, H, W, 8)).astype(np.float32)

    def jfn(t):
        return scatter_to_canvas(t, sp.coords, sp.valid, (H, W))

    want, vjp = jax.vjp(jfn, jnp.asarray(table))
    (want_grad,) = vjp(jnp.asarray(cot))
    cells = _port_stream(pts, msk).cells
    tt = torch.as_tensor(table).requires_grad_(True)
    got = canvas_scatter(tt, cells, (H, W))
    got.backward(torch.as_tensor(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(tt.grad.numpy(), np.asarray(want_grad))
    np.testing.assert_array_equal(
        canvas_scatter_plain(tt.detach(), cells, (H, W)).numpy(),
        np.asarray(want))
    np.testing.assert_array_equal(
        canvas_gather_plain(torch.as_tensor(cot), cells, (H, W)).numpy(),
        np.asarray(want_grad))
