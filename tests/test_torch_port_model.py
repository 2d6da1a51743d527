"""The whole slice: ``MaskBev(train=False, final_only=True)`` and the
predictor's decode, port against the JAX package, through ``from_flax``.

Tolerances on the final logits:
* f32: 1e-3 absolute (the same f32 arithmetic in another order);
* int8 backbone in f32: the int8 products match bit for bit, but an
  activation one f32 step from a rounding boundary moves by one int8 step,
  and the decoder's hard ``m < 0`` threshold can pass such a change on, so
  the mask logits are held on their mean error (3 % of the mean magnitude)
  and on their sign (99 % agree), class logits to 0.05;
* bf16 (with and without int8): the two frameworks round to bf16 (8-bit
  mantissa, ~0.4 % a step) at different places, and the difference grows
  through the backbone and the decoder layers: mean mask error 8 % of the
  mean magnitude, 97 % of signs agree, class logits to 0.25 (16 bf16 steps
  at magnitude 2).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from mask_bev_tpu.inference import (  # noqa: E402
    MaskBevPredictor as JaxPredictor)
from mask_bev_tpu.models.maskbev import MaskBev as JaxMaskBev  # noqa: E402
from mask_bev_tpu.utils.precision import apply_compute_dtype  # noqa: E402
from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.inference import MaskBevPredictor  # noqa: E402
from mask_bev_tpu_torch.models.convert import (  # noqa: E402
    from_flax, load_flax)
from mask_bev_tpu_torch.models.maskbev import MaskBev  # noqa: E402


def _scans(cfg, seed=0, b=2):
    rng = np.random.default_rng(seed)
    n = cfg.max_points_per_scan
    pts = np.stack([rng.uniform(-11, 11, (b, n)), rng.uniform(-11, 11, (b, n)),
                    rng.uniform(-3, 3, (b, n)), rng.uniform(0, 1, (b, n))],
                   -1).astype(np.float32)
    pts[0, :300, :2] = 1.3 + rng.uniform(0, 0.2, (300, 2))
    mask = np.ones((b, n), bool)
    mask[:, 1800:] = False
    return pts, mask


def _jax_cfg(**kw):
    """The JAX package's CPU path caps pillars at ``max_num_pillars``; the
    port keeps every occupied cell, like the TPU slot path, so the
    reference runs uncapped (H*W)."""
    cfg = jax_tiny()
    h, w = cfg.grid_hw
    return cfg.replace(max_num_pillars=h * w, **kw)


def _variables(cfg, pts, mask, seed=1):
    """Random flax variables of the right tree (shapes from ``eval_shape``,
    values from numpy: no init compile), at trained-model scales."""
    shapes = jax.eval_shape(lambda: JaxMaskBev(cfg).init(
        jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask),
        train=False))
    rng = np.random.default_rng(seed)

    def value(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        r = rng.normal(size=s.shape).astype(np.float32)
        if name == "var":
            return (0.5 + rng.uniform(size=s.shape)).astype(np.float32)
        if name in ("mean", "bias"):
            return 0.05 * r
        if name == "scale":
            return 1.0 + 0.1 * r
        if name == "kernel":
            return r / np.sqrt(np.prod(s.shape[:-1]))
        if name == "rel_pos_bias_table":
            return 0.02 * r
        return r  # query_feat, query_embed, level_embed
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(value(p, s), np.float32), shapes)


@pytest.mark.parametrize("dtype,quant", [("float32", "none"),
                                         ("float32", "int8"),
                                         ("bfloat16", "none"),
                                         ("bfloat16", "int8")])
def test_maskbev_matches_jax(dtype, quant):
    jcfg = _jax_cfg(compute_dtype=dtype, backbone_quantize=quant)
    pts, mask = _scans(jcfg)
    v = _variables(jcfg, pts, mask)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = JaxMaskBev(jcfg).apply(
        apply_compute_dtype(v, jcfg), jnp.asarray(pts).astype(jd),
        jnp.asarray(mask), train=False, final_only=True)
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    model = load_flax(MaskBev(tiny_test_config().replace(
        compute_dtype=dtype, backbone_quantize=quant)), v).to(td)
    with torch.no_grad():
        got = model(torch.as_tensor(pts).to(td), torch.as_tensor(mask))
    gc = got.cls_logits.float().numpy()
    gm = got.mask_logits.float().numpy()
    wc = np.asarray(want.cls_logits, np.float32)
    wm = np.asarray(want.mask_logits, np.float32)
    assert gc.shape == wc.shape and gm.shape == wm.shape
    if (dtype, quant) == ("float32", "none"):
        np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-3)
        np.testing.assert_allclose(gm, wm, rtol=0, atol=1e-3)
        return
    loose = dtype == "bfloat16"
    assert np.abs(gc - wc).max() <= (0.25 if loose else 0.05)
    assert (np.abs(gm - wm).mean()
            <= (0.08 if loose else 0.03) * np.abs(wm).mean())
    assert ((gm > 0) == (wm > 0)).mean() >= (0.97 if loose else 0.99)


def test_predictor_decode_matches_jax():
    jcfg = _jax_cfg()
    pts, mask = _scans(jcfg, seed=2)
    v = _variables(jcfg, pts, mask, seed=3)
    # lean the class head to the foreground so some queries are kept
    v["params"]["decoder"]["heads"]["cls_embed"]["bias"] = np.asarray(
        [-3.0, 3.0], np.float32)
    want = JaxPredictor(jcfg, v).predict_batch(pts, mask,
                                               score_threshold=0.3)
    pred = MaskBevPredictor(tiny_test_config(), from_flax(v), device="cpu")
    got = pred.predict_batch(pts, mask, score_threshold=0.3)
    assert sum(len(w.scores) for w in want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_allclose(g.scores, w.scores, rtol=0, atol=1e-5)
        np.testing.assert_allclose(g.mask_probs, w.mask_probs, rtol=0,
                                   atol=1e-5)
        assert (g.masks == w.masks).mean() >= 0.999
