"""The port's point samplers, matcher and losses against the JAX package on
the same inputs, every random draw pinned.

Tolerances: the gather-form samplers and the importance sampling built on
them, the GT crops and the assignments are held exactly; the dense samplers
to 1e-6 of the largest magnitude (in f32, and with bf16 operands the second
product's f32 operand is not a bf16 value: products and sums in another
order, or fused); the importance sampling on the dense bf16 sampler to 98 %
of its picked points (a one-step difference can swap two candidates whose
|logit| are that close); the losses to 1e-5 relative (f32 sums over the
sampled points in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu import losses as jl  # noqa: E402
from mask_bev_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from mask_bev_tpu.models.mask2former import (  # noqa: E402
    DecoderOutputs as JaxOutputs)
from mask_bev_tpu.ops import point_sample as jps  # noqa: E402
from mask_bev_tpu.ops.hungarian import match as jax_match  # noqa: E402
from mask_bev_tpu_torch import losses as tl  # noqa: E402
from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.models.mask2former import DecoderOutputs  # noqa: E402
from mask_bev_tpu_torch.ops import point_sample as tps  # noqa: E402
from mask_bev_tpu_torch.ops.hungarian import (  # noqa: E402
    hungarian_rows_plain, match)

T = torch.as_tensor


def _imgs(seed=0, n=6, h=12, w=10):
    return np.random.default_rng(seed).normal(size=(n, h, w)).astype(
        np.float32)


def _coords(seed, shape):
    # include points off the grid's edge (zero padding) and on cell centres
    c = np.random.default_rng(seed).uniform(-0.05, 1.05, shape)
    return c.astype(np.float32)


def test_point_sample_gather_forms_match_jax():
    img = _imgs()
    pts = _coords(1, (40, 2))
    per = _coords(2, (6, 40, 2))
    np.testing.assert_array_equal(
        tps.point_sample(T(img), T(pts)).numpy(),
        np.asarray(jps.point_sample(jnp.asarray(img), jnp.asarray(pts))))
    np.testing.assert_array_equal(
        tps.point_sample_per(T(img), T(per)).numpy(),
        np.asarray(jax.vmap(jps.point_sample)(jnp.asarray(img),
                                              jnp.asarray(per))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_point_samplers_match_jax(dtype):
    img = _imgs(3)
    pts = _coords(4, (40, 2))
    per = _coords(5, (6, 40, 2))
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cases = [
        (tps.point_sample_dense(T(img), T(pts), mm_dtype=td, chunk=8),
         jps.point_sample_dense(jnp.asarray(img), jnp.asarray(pts),
                                mm_dtype=jd, chunk=8)),
        (tps.point_sample_dense_per(T(img), T(per), mm_dtype=td, chunk=2),
         jps.point_sample_dense_per(jnp.asarray(img), jnp.asarray(per),
                                    mm_dtype=jd, chunk=2)),
    ]
    for got, want in cases:
        want = np.asarray(want)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    # the dense form samples the same values as the gather form
    np.testing.assert_allclose(
        tps.point_sample_dense(T(img), T(pts)).numpy(),
        tps.point_sample(T(img), T(pts)).numpy(), rtol=0, atol=1e-5)


def test_dense_sampler_gradient_matches_jax():
    img = _imgs(6)
    per = _coords(7, (6, 40, 2))
    cot = np.random.default_rng(8).normal(size=(6, 40)).astype(np.float32)
    _, vjp = jax.vjp(lambda i: jps.point_sample_dense_per(
        i, jnp.asarray(per), chunk=3), jnp.asarray(img))
    (want,) = vjp(jnp.asarray(cot))
    ti = T(img).requires_grad_(True)
    tps.point_sample_dense_per(ti, T(per), chunk=3).backward(T(cot))
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("dense", [False, True])
def test_uncertain_point_coords_with_the_jax_draws(dense):
    logits = _imgs(9, n=5, h=16, w=16)
    rng = jax.random.PRNGKey(3)
    num, over, imp = 24, 3.0, 0.75
    want = jps.uncertain_point_coords(
        rng, jnp.asarray(logits), num, over, imp, dense=dense,
        mm_dtype=jnp.bfloat16, chunk=5)
    # the draws the JAX function makes from its own key split
    k1, k2 = jax.random.split(rng)
    n_sampled, n_random = int(num * over), num - int(imp * num)
    u1 = np.asarray(jax.random.uniform(k1, (5, n_sampled, 2)))
    u2 = np.asarray(jax.random.uniform(k2, (5, n_random, 2)))
    got = tps.uncertain_point_coords(
        T(logits), num, over, imp, dense=dense, mm_dtype=torch.bfloat16,
        chunk=5, draws=(T(u1.copy()), T(u2.copy()))).numpy()
    want = np.asarray(want)
    if not dense:
        np.testing.assert_array_equal(got, want)
        return
    n_unc = int(imp * num)
    np.testing.assert_array_equal(got[:, n_unc:], want[:, n_unc:])
    same = [len({tuple(p) for p in g} & {tuple(p) for p in w})
            for g, w in zip(got[:, :n_unc], want[:, :n_unc])]
    assert sum(same) >= 0.98 * got.shape[0] * n_unc


def _jax_match(cost, nv):
    g, m = jax.vmap(jax_match)(jnp.asarray(cost), jnp.asarray(nv))
    return np.asarray(g), np.asarray(m)


@pytest.mark.parametrize("kind", ["random", "tied", "padded"])
def test_match_assignments_equal_jax(kind):
    rng = np.random.default_rng({"random": 0, "tied": 1, "padded": 2}[kind])
    n, q, g = 12, 9, 9
    if kind == "tied":  # few distinct values: many equal minima
        cost = rng.integers(0, 3, (n, q, g)).astype(np.float32)
        cost[0] = 1.0  # every entry tied
    else:
        cost = rng.normal(size=(n, q, g)).astype(np.float32)
    nv = rng.integers(1, g + 1, n).astype(np.int32)
    if kind == "padded":
        nv[:3] = [0, g, 1]
        cost[:, :, 5:] = 1e6  # padded columns: a large constant
    got_g, got_m = match(T(cost), T(nv))
    want_g, want_m = _jax_match(cost, nv)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    assert got_g.dtype == torch.int32
    assert (got_m.sum(1).numpy() == np.minimum(nv, q)).all()


def test_hungarian_rows_optimal_on_small_problems():
    """The assignment's cost equals the best over all assignments."""
    import itertools

    rng = np.random.default_rng(4)
    cost = rng.normal(size=(5, 3, 4)).astype(np.float32)  # 3 rows, 4 cols
    rows = hungarian_rows_plain(T(cost), T(np.full(5, 3)))
    for k in range(5):
        col_of_row = {int(r): j for j, r in enumerate(rows[k]) if r >= 0}
        got = sum(cost[k, r, c] for r, c in col_of_row.items())
        best = min(sum(cost[k, r, c] for r, c in enumerate(p))
                   for p in itertools.permutations(range(4), 3))
        assert abs(got - best) < 1e-5


def _gt(seed=0, b=2, g=6, hw=32, n_valid=(2, 4)):
    rng = np.random.default_rng(seed)
    masks = np.zeros((b, g, hw, hw), bool)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(n_valid[i]):
            y, x = rng.integers(0, hw - 8, 2)
            hh, ww = rng.integers(3, 12, 2)
            masks[i, j, y:y + hh, x:x + ww] = True
            valid[i, j] = True
    labels = rng.integers(0, 2, (b, g)).astype(np.int32)
    return labels, masks, valid


def test_gt_crops_match_jax():
    _, masks, _ = _gt(1)
    want = jl.gt_crops(jnp.asarray(masks), 8)
    got = tl.gt_crops(T(masks), 8)
    for gv, wv in zip(got, want):
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert got[2].any()  # some instance exceeds an 8-pixel crop
    loc = tl.crop_local_coords(T(_coords(2, (2, 1, 30, 2))), got[1], (32, 32),
                               8)
    want_loc = jl._crop_local_coords(jnp.asarray(_coords(2, (2, 1, 30, 2))),
                                     want[1], (32, 32), 8)
    np.testing.assert_array_equal(loc.numpy(), np.asarray(want_loc))


def _cfgs(**kw):
    kw = dict(head_num_points=64, num_queries=6, head_num_classes=2, **kw)
    return jax_tiny().replace(**kw), tiny_test_config().replace(**kw)


def _head_inputs(seed, layers=None, b=2, q=6, hw=16, k=2):
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)
    cls = rng.normal(size=lead + (b, q, k + 1)).astype(np.float32)
    mask = (2 * rng.normal(size=lead + (b, q, hw, hw))).astype(np.float32)
    return cls, mask


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol,
                               atol=1e-6)


@pytest.mark.parametrize("crop,dense", [(0, True), (16, True), (16, False)])
def test_layer_losses_match_jax(crop, dense):
    jcfg, tcfg = _cfgs(loss_gt_crop=crop, loss_sample_dense=dense)
    labels, masks, valid = _gt(2)
    cls, mask = _head_inputs(3)
    rng = np.random.default_rng(4)
    mc = rng.uniform(size=(2, 64, 2)).astype(np.float32)
    lc = rng.uniform(size=(12, 64, 2)).astype(np.float32)
    want, wmr = jl.layer_losses(
        jax.random.PRNGKey(0), jnp.asarray(cls), jnp.asarray(mask), None,
        jnp.asarray(labels), jnp.asarray(masks), jnp.asarray(valid), None,
        jcfg, match_coords=jnp.asarray(mc), loss_coords=jnp.asarray(lc))
    got, mr = tl.layer_losses(
        T(cls), T(mask), T(labels), T(masks), T(valid), tcfg,
        match_coords=T(mc), loss_coords=T(lc))
    np.testing.assert_array_equal(mr.gt_of_query.numpy(),
                                  np.asarray(wmr.gt_of_query))
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name])


@pytest.mark.parametrize("crop", [0, 16])
def test_maskbev_loss_with_pinned_coords_matches_jax(crop):
    """The port's loss over L+1 head passes with every point pinned, against
    the JAX per-layer losses at the same points (the JAX ``maskbev_loss``
    solves the same assignments in one batch)."""
    jcfg, tcfg = _cfgs(loss_gt_crop=crop)
    labels, masks, valid = _gt(5)
    n_l = 3
    cls, mask = _head_inputs(6, layers=n_l)
    rng = np.random.default_rng(7)
    mcs = rng.uniform(size=(n_l, 2, 64, 2)).astype(np.float32)
    lcs = rng.uniform(size=(n_l, 12, 64, 2)).astype(np.float32)
    per = [jl.layer_losses(
        jax.random.PRNGKey(li), jnp.asarray(cls[li]), jnp.asarray(mask[li]),
        None, jnp.asarray(labels), jnp.asarray(masks), jnp.asarray(valid),
        None, jcfg, match_coords=jnp.asarray(mcs[li]),
        loss_coords=jnp.asarray(lcs[li]))[0] for li in range(n_l)]
    total, logs = tl.maskbev_loss(
        DecoderOutputs(T(cls), T(mask), None), T(labels), T(masks),
        T(valid), tcfg, coords=[(T(mcs[li]), T(lcs[li]))
                                for li in range(n_l)])
    want_total = 0.0
    for name in ("loss_cls", "loss_mask", "loss_dice"):
        wv = np.asarray([float(d[name]) for d in per])
        np.testing.assert_allclose(logs[f"{name}_layers"].numpy(), wv,
                                   rtol=1e-5, atol=1e-6)
        _close(logs[name], wv.sum())
        want_total += wv.sum()
    _close(total, want_total)
    _close(logs["loss"], want_total)
    if crop:
        want_trunc = float((np.asarray(jl.gt_crops(
            jnp.asarray(masks), crop)[2]) & valid).sum())
        assert float(logs["gt_crop_truncated"]) == want_trunc
    else:
        assert "gt_crop_truncated" not in logs


def test_maskbev_loss_draws_from_the_generator():
    _, tcfg = _cfgs()
    labels, masks, valid = _gt(8)
    cls, mask = _head_inputs(9, layers=2)
    out = DecoderOutputs(T(cls), T(mask), None)

    def run(seed):
        return tl.maskbev_loss(out, T(labels), T(masks), T(valid), tcfg,
                               generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert float(a[0]) == float(b[0]) and float(a[0]) != float(c[0])
    assert np.isfinite(float(a[0]))
    # the JAX loss on the same outputs lands in the same range
    jcfg, _ = _cfgs()
    jt, _ = jl.maskbev_loss(jax.random.PRNGKey(0), JaxOutputs(
        jnp.asarray(cls), jnp.asarray(mask), None), jnp.asarray(labels),
        jnp.asarray(masks), jnp.asarray(valid), None, jcfg)
    assert abs(float(a[0]) - float(jt)) <= 0.2 * float(jt)
