"""Port Swin backbone (kernel 3's plain block) against the JAX XLA path.

Tolerances, relative to the reference's largest magnitude: f32 1e-4 (the
same f32 arithmetic summed in another order); int8 2e-2 (int8_sim_dense is
followed bit for bit, but an f32 LayerNorm that differs in its last bit can
move an activation across a rounding boundary, one int8 step; the JAX
package's own kernel-level int8 fidelity is ~1.3 %).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.models.swin import (  # noqa: E402
    SwinBlock as JaxBlock, SwinTransformer as JaxSwin)
from mask_bev_tpu_torch.models.convert import load_flax  # noqa: E402
from mask_bev_tpu_torch.models.swin import (  # noqa: E402
    SwinBlock, SwinTransformer)


def _perturb(v, seed):
    """Random values for every leaf (norm scales near 1), so biases, LN
    affines and the relative-position table all count."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        name = str(path[-1])
        r = rng.normal(size=x.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * r
        if "bias" in name or "rel_pos" in name:
            return 0.1 * r
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(f, jax.device_get(v))


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("shift", [False, True])
def test_block_matches_xla(shift, quant):
    c, heads, win, hw = 24, 3, 5, (7, 9)  # pads to 10 x 10: pad tokens
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, hw[0] * hw[1], c)).astype(np.float32)
    jb = JaxBlock(c, heads, win, shift=shift, quantize=quant,
                  use_pallas=False)
    v = _perturb(jb.init(jax.random.PRNGKey(0), jnp.asarray(x), hw,
                         train=False), 2)
    want = np.asarray(jb.apply(v, jnp.asarray(x), hw, train=False))
    blk = load_flax(SwinBlock(c, heads, win, shift=shift, quantize=quant), v)
    with torch.no_grad():
        got = blk(torch.as_tensor(x), hw).numpy()
    assert _rel(got, want) <= (2e-2 if quant else 1e-4)


@pytest.mark.parametrize("quant", [False, True])
def test_pyramid_matches_xla(quant):
    depths, heads = (2, 2, 4, 2), (3, 3, 6, 6)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 40, 40, 16)).astype(np.float32)
    js = JaxSwin(embed_dim=24, depths=depths, num_heads=heads, window=5,
                 quantize_int8=quant, use_pallas=False)
    v = _perturb(js.init(jax.random.PRNGKey(1), jnp.asarray(x),
                         train=False), 4)
    want = [np.asarray(o) for o in js.apply(v, jnp.asarray(x), train=False)]
    sw = load_flax(SwinTransformer(16, embed_dim=24, depths=depths,
                                   num_heads=heads, window=5,
                                   quantize_int8=quant), v)
    with torch.no_grad():
        got = [o.numpy() for o in sw(torch.as_tensor(x))]
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert _rel(g, w) <= (2e-2 if quant else 1e-4)
