"""Kernel 8's plain version (``ops/patch_embed.py``) against the TPU kernel
``fused_patch_embed(interpret=True)`` fed the batch-minor flat form of the
same canvas, and the port's backbone with ``fused_embed`` against the JAX
``SwinTransformer(fused_interpret=True)(None, canvas_flat=...)``.

Tolerances, relative to the reference's largest magnitude: f32 1e-5 for the
kernel (the same f32 products and LayerNorm summed in another order), 1e-4
through the backbone's blocks (as ``test_torch_port_swin.py``); bf16 2e-2.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.models.swin import SwinTransformer as JaxSwin  # noqa: E402
from mask_bev_tpu.ops.pallas_patch_embed import (  # noqa: E402
    fused_patch_embed)
from mask_bev_tpu_torch.models.convert import load_flax  # noqa: E402
from mask_bev_tpu_torch.models.swin import SwinTransformer  # noqa: E402
from mask_bev_tpu_torch.ops.patch_embed import (  # noqa: E402
    embed_matrix, patch_embed, patch_embed_plain)

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _flat(x):
    """(B, H, W, C) -> the TPU canvas kernel's flat (H*W, B*C) form."""
    b, h, w, c = x.shape
    return jnp.transpose(x, (1, 2, 0, 3)).reshape(h * w, b * c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(dtype):
    jd, td = _DT[dtype]
    b, h, w, c, e, p = 2, 24, 16, 8, 32, 4
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    kern = (rng.normal(size=(p, p, c, e)) / np.sqrt(p * p * c)).astype(
        np.float32)
    bias = (0.1 * rng.normal(size=e)).astype(np.float32)
    ls = (1.0 + 0.1 * rng.normal(size=e)).astype(np.float32)
    lb = (0.1 * rng.normal(size=e)).astype(np.float32)
    want = fused_patch_embed(
        _flat(jnp.asarray(x).astype(jd)), jnp.asarray(kern).astype(jd),
        jnp.asarray(bias).astype(jd), jnp.asarray(ls).astype(jd),
        jnp.asarray(lb).astype(jd), h=h, w=w, bsz=b, patch=p, out_dtype=jd,
        interpret=True)
    # flax HWIO (p, p, C, E) -> torch conv weight (E, C, p, p)
    weight = torch.as_tensor(kern).permute(3, 2, 0, 1).to(td)
    wm = embed_matrix(weight)
    args = (torch.as_tensor(x).to(td), wm,
            *(torch.as_tensor(a).to(td) for a in (bias, ls, lb)), p)
    got = patch_embed_plain(*args)
    assert got.dtype == td and tuple(got.shape) == tuple(want.shape)
    torch.testing.assert_close(patch_embed(*args), got, rtol=0, atol=0)
    assert _rel(got.float().numpy(), want) <= (
        2e-2 if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_backbone_fused_embed_matches_jax_flat_canvas_path(use_pallas):
    """Path K's backbone at tiny size: kernel 8 for the patch embed, the
    XLA-form blocks (their attention on kernel 7 with ``use_pallas``)."""
    b, h, w, c = 2, 40, 40, 16
    rng = np.random.default_rng(1)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    kw = dict(embed_dim=32, depths=(2, 2), num_heads=(2, 4), window=5,
              patch_size=4, use_pallas=use_pallas, use_pallas_block=False)
    ref = JaxSwin(**kw)
    v = jax.device_get(ref.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                train=False))
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(
            np.float32), v)
    want = JaxSwin(fused_interpret=True, **kw).apply(
        v, None, train=False, canvas_flat=(_flat(jnp.asarray(x)), (h, w, b)))
    sw = load_flax(SwinTransformer(c, embed_dim=32, depths=(2, 2),
                                   num_heads=(2, 4), window=5,
                                   use_pallas=use_pallas,
                                   use_pallas_block=False), v)
    with torch.no_grad():
        got = sw(torch.as_tensor(x), fused_embed=True)
    assert [tuple(g.shape) for g in got] == [tuple(o.shape) for o in want]
    for g, o in zip(got, want):
        assert _rel(g.numpy(), o) <= 1e-4
