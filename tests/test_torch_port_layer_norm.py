"""Kernel 9's plain version (``ops/layer_norm.py``) against flax
``nn.LayerNorm`` and ``fused_layer_norm(interpret=True)``; the blocks'
``LayerNormP`` form and the pixel decoder's GroupNorm against theirs.

Tolerances (absolute, on unit-scale outputs): f32 1e-5 on centred inputs
(the same f32 formula, summed in another order); bf16 2e-2 (two bf16 steps
at magnitude 2). On inputs offset by 300 the fast-variance form
``E[x^2] - E[x]^2`` cancels ~90000 against ~90000 in f32, where one ulp is
0.0078 of the unit variance: flax's own result lies 0.057 from the exact
LayerNorm on this input (f64 reference), and any other summation order
lands elsewhere in that band (the Pallas kernel in interpret mode shares
XLA's reductions and stays within 0.006 of flax). There the port is held to
0.15 of flax, about twice flax's own error, and to the exact result within
flax's own distance from it plus 0.05. The two-pass ``LayerNormP`` form is exact to
f32 rounding of the mean (2e-4 at offset 300).
"""
import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.models.swin import LayerNormP  # noqa: E402
from mask_bev_tpu.ops.pallas_layer_norm import fused_layer_norm  # noqa: E402
from mask_bev_tpu_torch.models.pixel_decoder import GroupNorm  # noqa: E402
from mask_bev_tpu_torch.models.swin import LayerNorm  # noqa: E402
from mask_bev_tpu_torch.ops.layer_norm import (  # noqa: E402
    MAX_WORDS, layer_norm, layer_norm_plain, plan)
from mask_bev_tpu_torch.ops.swin_block import layer_norm_p  # noqa: E402

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(offset, dtype, shape=(2, 37, 192), seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (offset + rng.normal(size=shape)).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    b = (0.1 * rng.normal(size=c)).astype(np.float32)
    jd, td = _DT[dtype]
    j = [jnp.asarray(a).astype(jd) for a in (x, w, b)]
    t = [torch.as_tensor(a).to(td) for a in (x, w, b)]
    return j, t


def _tol(dtype, offset):
    if offset:
        return 0.15
    return 2e-2 if dtype == "bfloat16" else 1e-5


def _exact_ln(x, w, b, eps=1e-6):
    x = np.asarray(x, np.float64)
    y = (x - x.mean(-1, keepdims=True)) / np.sqrt(
        x.var(-1, keepdims=True) + eps)
    return y * np.asarray(w, np.float64) + np.asarray(b, np.float64)


@pytest.mark.parametrize("offset", [0.0, 300.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_flax_and_pallas(dtype, offset):
    (jx, jw, jb), (tx, tw, tb) = _inputs(offset, dtype)
    want = nn.LayerNorm().apply({"params": {"scale": jw, "bias": jb}}, jx)
    pallas = fused_layer_norm(jx, jw, jb, block_rows=32, interpret=True)
    got = layer_norm_plain(tx, tw, tb)
    assert got.dtype == tx.dtype
    tol = _tol(dtype, offset)
    g = got.float().numpy()
    np.testing.assert_allclose(g, np.asarray(want, np.float32), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(g, np.asarray(pallas, np.float32), rtol=0,
                               atol=tol)
    if offset and dtype == "float32":
        exact = _exact_ln(jx, jw, jb)
        flax_err = np.abs(np.asarray(want, np.float64) - exact).max()
        assert np.abs(g - exact).max() <= flax_err + 0.05
    # the wrapper takes the plain version for CPU tensors
    torch.testing.assert_close(layer_norm(tx, tw, tb), got, rtol=0, atol=0)
    # and so does the backbone's module (patch_norm, out_norm, merge norm)
    ln = LayerNorm(tx.shape[-1]).to(tx.dtype)
    ln.load_state_dict({"weight": tw, "bias": tb})
    with torch.no_grad():
        torch.testing.assert_close(ln(tx), got, rtol=0, atol=0)


def test_layer_norm_output_dtype():
    """Both JAX paths return the input dtype when the parameters are in the
    model dtype (the fused kernel always does; flax promotes to f32 only
    when f32 parameters meet bf16 tokens, which neither package's model
    runs); the port returns the input dtype."""
    (jx, jw, jb), (tx, tw, tb) = _inputs(0.0, "bfloat16")
    flax_bf16 = nn.LayerNorm().apply({"params": {"scale": jw, "bias": jb}},
                                     jx)
    pallas = fused_layer_norm(jx, jw.astype(jnp.float32),
                              jb.astype(jnp.float32), interpret=True)
    flax_mixed = nn.LayerNorm().apply(
        {"params": {"scale": jw.astype(jnp.float32),
                    "bias": jb.astype(jnp.float32)}}, jx)
    assert flax_bf16.dtype == jnp.bfloat16
    assert pallas.dtype == jnp.bfloat16
    assert flax_mixed.dtype == jnp.float32
    assert layer_norm_plain(tx, tw.float(), tb.float()).dtype == torch.bfloat16
    np.testing.assert_allclose(
        np.asarray(pallas, np.float32),
        np.asarray(flax_mixed.astype(jnp.bfloat16), np.float32), rtol=0,
        atol=2e-2)


@pytest.mark.parametrize("offset", [0.0, 300.0])
def test_block_norm_matches_layer_norm_p(offset):
    """The blocks' and decoder's norms are the JAX ``LayerNormP``: a
    two-pass variance, exact to f32 rounding even at offset 300."""
    (jx, jw, jb), (tx, tw, tb) = _inputs(offset, "float32", seed=1)
    want = np.asarray(LayerNormP(192).apply(
        {"params": {"scale": jw, "bias": jb}}, jx))
    tol = 2e-4 if offset else 1e-5
    got = layer_norm_p(tx, tw, tb).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    ln = LayerNorm(192, fast_variance=False)
    ln.load_state_dict({"weight": tw, "bias": tb})
    with torch.no_grad():
        np.testing.assert_allclose(ln(tx).numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("offset", [0.0, 300.0])
def test_group_norm_matches_flax(offset):
    """flax ``nn.GroupNorm``'s fast-variance form (the same cancellation
    band at offset 300: 198 values a group)."""
    rng = np.random.default_rng(2)
    c = 64
    x = (offset + rng.normal(size=(2, 9, 11, c))).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    b = (0.1 * rng.normal(size=c)).astype(np.float32)
    want = np.asarray(nn.GroupNorm(num_groups=32).apply(
        {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}},
        jnp.asarray(x)))
    gn = GroupNorm(32, c, eps=1e-6)
    gn.load_state_dict({"weight": torch.as_tensor(w),
                        "bias": torch.as_tensor(b)})
    with torch.no_grad():
        got = gn(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=0.25 if offset else 1e-5)


def _check_plan(c, f32):
    g, w, r = plan(c, f32)
    words = c // 8
    assert g in (1, 2, 4, 8, 16, 32) and 1 <= w <= MAX_WORDS
    assert g <= words           # every lane of a group holds a word
    assert g * (w - 1) < words <= g * w  # the fewest words a lane
    if words // min(32, words & -words) <= MAX_WORDS:
        assert g == min(32, words & -words)
    vecs = r * w * (2 if f32 else 1)  # 16-byte vectors a lane holds a step
    assert vecs <= 24 and (r >= 2 or vecs > 12)
    return g, w, r


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("c,want", [
    (192, (8, 3, 4, 2)), (384, (16, 3, 4, 2)), (768, (32, 3, 4, 2)),
    (1536, (32, 6, 2, 2)),                 # path E's rows
    (8, (1, 1, 12, 6)), (16, (2, 1, 12, 6)), (2048, (32, 8, 2, 1)),
    (2040, (32, 8, 2, 1)), (200, (4, 7, 2, 1)), (96, (4, 3, 4, 2)),
])
def test_layer_norm_plan(c, want, f32):
    """Kernel 9's lanes a token, words a lane and tokens a step (bf16, f32):
    no lane of a group idles at path E's widths (8 x 3 words at C = 192,
    16 x 3 at 384, 32 x 3 at 768, 32 x 6 at 1536), and a group takes two
    tokens or more there."""
    g, w, r_bf16, r_f32 = want
    assert _check_plan(c, f32) == (g, w, r_f32 if f32 else r_bf16)


def test_layer_norm_plan_every_width():
    """Every C = 8 ... 2048 (multiples of 8) gets a split the kernel takes
    (``csrc/layer_norm.cu::token_layernorm``'s checks), in both
    instances."""
    for c in range(8, 2049, 8):
        for f32 in (False, True):
            _check_plan(c, f32)
