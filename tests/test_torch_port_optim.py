"""The port's optimizers and schedules against the JAX package's
(``mask_bev_tpu.train.optim.make_optimizer``, optax) on the same parameters
and gradients: modules of ``tiny_test_config()``'s parameter tree (``KEEP``)
with random values, moved across by ``models/convert.py::from_flax``.

Adam, AdamW, LAMB and SGD under the plateau, cosine and poly schedules, one
and three steps; differential learning rates; frozen stages (every frozen
parameter unchanged, bit for bit); gradient clipping; the plateau scale;
the :class:`PlateauState` sequence. Tolerance, in f32: each parameter to
1e-6 of its leaf's largest magnitude, and each update (new minus old
parameter; the learning rate is 1e-2 so that updates stand well above the
parameters' rounding) to 1e-4 of its leaf's largest update or two f32
rounding steps of its largest parameter, whichever is larger (the
subtraction carries the parameters' rounding; a 0.1 backbone factor makes
updates of 1e-3 on parameters of ~1).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from mask_bev_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from mask_bev_tpu.models.maskbev import MaskBev as JaxMaskBev  # noqa: E402
from mask_bev_tpu.train import optim as jopt  # noqa: E402
from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.models.convert import from_flax  # noqa: E402
from mask_bev_tpu_torch.train import optim as topt  # noqa: E402

BASE = dict(lr=1e-2, weight_decay=1e-2, max_epochs=2)
STEPS_PER_EPOCH = 2  # cosine and poly decay over 4 steps


# the tiny model's modules the tests keep: every family the labels name
# (patch embed and norm, stage blocks and merges on both sides of a frozen
# stage, an output norm, the encoder, the decoder's heads and queries)
KEEP = {"encoder": ("pillar_feature_net",),
        "backbone": ("patch_embed", "patch_norm", "stage0_block0", "merge0",
                     "stage1_block0", "out_norm0"),
        "decoder": ("heads", "query_feat")}


# a tiny model with stacked trees: a deep stage (depth 4: two scanned
# block pairs) and 6 decoder layers (two scanned groups of the 3 levels)
STACKED = dict(backbone_depths=(1, 1, 4, 1), head_num_decoder_layers=6)
KEEP_STACKED = {"backbone": ("stage2_pairs", "merge1"),
                "decoder": ("layers", "query_feat")}


@pytest.fixture(scope="module")
def tree():
    """Random flax parameters of the tiny model's modules in ``KEEP`` (its
    real paths and shapes; each eager optax operation compiles once a
    shape, so the whole tree would cost minutes) and three random gradient
    trees of the same shapes."""
    return _tree(jax_tiny(), KEEP)


@pytest.fixture(scope="module")
def stacked_tree():
    """As :func:`tree`, for the stacked modules of ``STACKED``."""
    return _tree(jax_tiny().replace(**STACKED), KEEP_STACKED)


def _tree(cfg, keep_tree):
    n = cfg.max_points_per_scan
    full = jax.eval_shape(lambda: JaxMaskBev(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, n, 4)), jnp.zeros((1, n), bool),
        train=False))["params"]
    shapes = {top: full[top] if keep is None else {k: full[top][k]
                                                    for k in keep}
              for top, keep in keep_tree.items()}
    rng = np.random.default_rng(0)

    def draw(scale):
        return jax.tree.map(lambda s: (scale * rng.normal(size=s.shape))
                            .astype(np.float32), shapes)

    return draw(0.5), [draw(1.0) for _ in range(3)]


def _run_jax(cfg, params, grads, scale=None):
    tx = jopt.make_optimizer(cfg, params, steps_per_epoch=STEPS_PER_EPOCH)
    p = jax.tree.map(jnp.asarray, params)
    st = tx.init(p)
    if scale is not None:
        st = jopt.set_lr_scale(st, scale)
    out = []
    for g in grads:
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, p)
        p = optax.apply_updates(p, upd)
        out.append(from_flax({"params": jax.device_get(p)}))
    return out


def _run_port(cfg, params, grads, scale=1.0):
    opt = topt.make_optimizer(cfg, STEPS_PER_EPOCH)
    p = from_flax({"params": params})
    st = opt.init(p)
    out = []
    for g in grads:
        st = opt.step(p, from_flax({"params": g}), st, scale)
        out.append({k: v.clone() for k, v in p.items()})
    assert st.count == len(grads)
    return out


def _check(got, want, before):
    assert set(got) == set(want)
    for k in want:
        w, g, b = want[k].numpy(), got[k].numpy(), before[k].numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)
        dw = w - b
        if np.abs(dw).max() > 0:
            tol = max(1e-4 * np.abs(dw).max(),
                      2 * np.finfo(np.float32).eps * np.abs(w).max())
            np.testing.assert_allclose(g - b, dw, rtol=0, atol=tol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, b, err_msg=k)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's parameters after each of three steps, by
    configuration (the one- and three-step cases share a run)."""
    return {}


def _compare(tree, steps, scale=None, jax_runs=None, **kw):
    params, grads = tree
    jcfg = jax_tiny().replace(**BASE, **kw)
    tcfg = tiny_test_config().replace(**BASE, **kw)
    runs = {} if jax_runs is None else jax_runs
    key = (scale, tuple(sorted(kw.items())))
    if key not in runs:
        runs[key] = _run_jax(jcfg, params, grads, scale)
    want = runs[key][:steps]
    got = _run_port(tcfg, params, grads[:steps],
                    1.0 if scale is None else scale)
    before = from_flax({"params": params})
    for g, w in zip(got, want):
        _check(g, w, before)
    return before, got[-1]


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("sched", ["plateau", "cosine", "poly"])
@pytest.mark.parametrize("kind", ["adam", "adam_w", "lamb", "sgd"])
def test_optimizer_matches_optax(tree, jax_runs, kind, sched, steps):
    _compare(tree, steps, jax_runs=jax_runs, optimiser_type=kind,
             lr_schedulers_type=sched)


@pytest.mark.parametrize("kind", ["adam_w", "lamb"])
def test_differential_lr(tree, kind):
    before, after = _compare(tree, 3, optimiser_type=kind,
                             differential_lr=True,
                             differential_lr_scaling=0.1)
    assert not torch.equal(before["backbone.patch_embed.weight"],
                           after["backbone.patch_embed.weight"])


@pytest.mark.parametrize("kind", ["adam_w", "sgd"])
def test_frozen_stages(tree, kind):
    before, after = _compare(tree, 3, optimiser_type=kind,
                             backbone_frozen_stages=1)
    cfg = tiny_test_config().replace(backbone_frozen_stages=1)
    frozen = [k for k in before if topt.is_frozen(cfg, k)]
    assert "backbone.patch_embed.weight" in frozen
    assert "backbone.stage1_block0.ffn_1.weight" in frozen
    assert "backbone.merge0.reduction.weight" in frozen
    assert not topt.is_frozen(cfg, "backbone.merge2.reduction.weight")
    assert not topt.is_frozen(cfg, "backbone.stage2_block0.ffn_1.weight")
    assert not topt.is_frozen(cfg, "backbone.out_norm0.weight")
    for k in frozen:
        assert torch.equal(before[k], after[k]), k
    moved = [k for k in before if k not in frozen]
    assert moved and all(not torch.equal(before[k], after[k])
                         for k in moved if "decoder" in k)


@pytest.mark.parametrize("kind", ["lamb", "adam_w"])
def test_stacked_leaves(stacked_tree, kind):
    """A deep stage's block pairs and the decoder's layer groups, which the
    JAX package stacks under ``nn.scan``: LAMB takes its norms over each
    stacked leaf, every block of it together (per block, the numbers
    would differ: asserted)."""
    before, after = _compare(stacked_tree, 3, optimiser_type=kind, **STACKED)
    assert {"backbone.stage2_block3.ffn_1.weight",
            "decoder.layer5.ffn.fc1.weight"} <= set(before)
    if kind == "lamb":
        cfg = tiny_test_config().replace(**BASE, **STACKED,
                                         optimiser_type=kind)
        opt = topt.make_optimizer(cfg, STEPS_PER_EPOCH)
        opt.leaf = lambda name: name  # per block
        p = from_flax({"params": stacked_tree[0]})
        st = opt.init(p)
        for g in stacked_tree[1]:
            st = opt.step(p, from_flax({"params": g}), st)
        k = "backbone.stage2_block0.ffn_1.weight"
        assert float((p[k] - after[k]).abs().max()) > 1e-4 * float(
            (after[k] - before[k]).abs().max())


@pytest.mark.parametrize("kind", ["adam_w", "sgd", "lamb"])
def test_gradient_clipping(tree, kind):
    """A clip norm far under the gradients' global norm (asserted): every
    step is clipped."""
    for g in tree[1]:
        norm = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                           for x in jax.tree.leaves(g)))
        assert norm > 20 * 0.5
    _compare(tree, 3, optimiser_type=kind, grad_clip_norm=0.5)


def test_clipping_and_frozen_together(tree):
    """The clipping norm covers the trainable parameters only."""
    _compare(tree, 2, optimiser_type="adam_w", grad_clip_norm=0.5,
             backbone_frozen_stages=0, differential_lr=True)


@pytest.mark.parametrize("kind", ["adam_w", "sgd"])
def test_plateau_scale(tree, kind):
    _compare(tree, 2, scale=0.1, optimiser_type=kind)


def test_plateau_state_sequence():
    rng = np.random.default_rng(4)
    metrics = list(np.cumsum(rng.normal(size=60)))
    metrics += [metrics[-1] + 1.0] * 30  # long plateaus: the scale falls
    kw = dict(patience=3)
    j, t = jopt.PlateauState(**kw), topt.PlateauState(**kw)
    scales = []
    for m in metrics:
        scales.append(t.update(float(m)))
        assert j.update(float(m)) == scales[-1]
        assert (j.best, j.bad_epochs) == (t.best, t.bad_epochs)
    assert min(scales) < 1e-3 and scales[-1] == t.min_scale


def test_schedules_match_optax():
    cfg = tiny_test_config().replace(lr=0.3, max_epochs=5)
    for sched, ref in (
            ("cosine", optax.cosine_decay_schedule(0.3, decay_steps=35)),
            ("poly", optax.polynomial_schedule(0.3, 0.0, 0.9, 35))):
        fn = topt.lr_schedule(cfg.replace(lr_schedulers_type=sched), 7)
        for step in (0, 1, 17, 34, 35, 50):
            np.testing.assert_allclose(float(fn(step)), float(ref(step)),
                                       rtol=1e-6, atol=1e-9)
    const = topt.lr_schedule(cfg.replace(lr_schedulers_type="none"))
    assert float(const(10)) == np.float32(0.3)
    with pytest.raises(ValueError, match="optimiser_type"):
        topt.make_optimizer(cfg.replace(optimiser_type="rmsprop"))
