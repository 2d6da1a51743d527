"""Port pixel decoder, sine positional encoding and Mask2Former decoder
(kernel 4's plain stack) against the JAX package.

Tolerances: 1e-5 absolute on the sine encoding (the same f32 formula);
1e-4 relative to max-abs on the pixel decoder (f32 convolutions and
GroupNorms summed in another order); 1e-4 absolute on the final decoder
logits. Every layer's mask logit lies farther from the ``m < 0`` threshold
than four times the largest difference between the two packages' final
logits (the test checks that margin), so no attention-bias entry differs.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.models.mask2former import (  # noqa: E402
    Mask2FormerDecoder as JaxDecoder)
from mask_bev_tpu.models.pixel_decoder import (  # noqa: E402
    PixelDecoder as JaxPixelDecoder)
from mask_bev_tpu.models.positional import (  # noqa: E402
    sine_positional_encoding_2d as jax_sine)
from mask_bev_tpu_torch.models.convert import load_flax  # noqa: E402
from mask_bev_tpu_torch.models.mask2former import (  # noqa: E402
    Mask2FormerDecoder)
from mask_bev_tpu_torch.models.pixel_decoder import PixelDecoder  # noqa: E402
from mask_bev_tpu_torch.models.positional import (  # noqa: E402
    sine_positional_encoding_2d)
from mask_bev_tpu_torch.ops.decoder_stack import (  # noqa: E402
    decoder_stack_plain)


def _perturb(v, seed):
    rng = np.random.default_rng(seed)

    def f(path, x):
        name = str(path[-1])
        r = rng.normal(size=x.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * r
        if "bias" in name:
            return 0.1 * r
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(f, jax.device_get(v))


@pytest.mark.parametrize("hw", [(16, 16), (63, 63), (5, 7)])
def test_sine_encoding(hw):
    want = np.asarray(jax_sine(*hw, num_feats=32))
    got = sine_positional_encoding_2d(*hw, num_feats=32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_pixel_decoder():
    rng = np.random.default_rng(0)
    # a 63 -> 125 level pair: plain "nearest" would pick other rows
    shapes = [(125, 125, 24), (63, 63, 48), (32, 32, 96), (16, 16, 192)]
    feats = [rng.normal(size=(1,) + s).astype(np.float32) for s in shapes]
    jd = JaxPixelDecoder(feat_channels=64, out_channels=64)
    v = _perturb(jd.init(jax.random.PRNGKey(0),
                         [jnp.asarray(f) for f in feats], train=False), 1)
    wmf, wmems = jd.apply(v, [jnp.asarray(f) for f in feats], train=False)
    pd = load_flax(PixelDecoder([24, 48, 96, 192], 64, 64), v)
    with torch.no_grad():
        gmf, gmems = pd([torch.as_tensor(f) for f in feats])
    for g, w in zip([gmf] + gmems, [wmf] + list(wmems)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


def _decoder_setup(seed=3, c=64, heads=2, q=8, layers=9):
    rng = np.random.default_rng(seed)
    b = 2
    mf = rng.normal(size=(b, 32, 32, c)).astype(np.float32)
    mems = [rng.normal(size=(b, h, w, c)).astype(np.float32)
            for (h, w) in [(4, 4), (8, 8), (16, 16)]]
    kw = dict(num_queries=q, num_classes=1, num_layers=layers,
              feat_channels=c, out_channels=c, num_heads=heads, ffn_dim=128)
    jd = JaxDecoder(**kw)
    v = jd.init(jax.random.PRNGKey(seed), jnp.asarray(mf),
                [jnp.asarray(m) for m in mems], train=False)
    v = _perturb(v, seed + 1)
    dec = load_flax(Mask2FormerDecoder(**kw), v)
    return jd, kw, v, dec, mf, mems


@pytest.mark.parametrize("pallas", [False, True])
def test_decoder_final_only(pallas):
    """Against the XLA scan path, and against the fused Pallas stack run in
    interpret mode."""
    jd, kw, v, dec, mf, mems = _decoder_setup()
    if pallas:
        jd = JaxDecoder(**kw, use_pallas=True, pallas_interpret=True)
    want = jd.apply(v, jnp.asarray(mf), [jnp.asarray(m) for m in mems],
                    train=False, final_only=True)
    with torch.no_grad():
        tmf = torch.as_tensor(mf)
        tmems = [torch.as_tensor(m) for m in mems]
        got = dec(tmf, tmems, final_only=True)
        # the decision margin: no mask logit lies within the tolerance of
        # the m < 0 threshold, so no bias entry differs from the reference
        layers, head, _ = dec.kernel_inputs(False, 3)
        _, logits = decoder_stack_plain(
            *dec.stack_inputs(tmf, tmems), layers, head,
            num_heads=dec.num_heads, return_logits=True)
    np.testing.assert_allclose(got.cls_logits.numpy(),
                               np.asarray(want.cls_logits), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.mask_logits.numpy(),
                               np.asarray(want.mask_logits), rtol=0,
                               atol=1e-4)
    err = float(np.abs(got.mask_logits.numpy()
                       - np.asarray(want.mask_logits)).max())
    margin = min(float(m.abs().min()) for m in logits)
    assert margin > 4 * err
