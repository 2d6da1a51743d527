"""Kernel 10's plain version (``ops/pfn.py::stream_pfn_plain``) against the
TPU kernel ``gather_at_starts(fused_stream_pfn(..., interpret=True))`` on the
same capped stream, and the port's capped eval encoder against the JAX XLA
encoder with the cap binding.

Tolerances: the TPU kernel writes bf16 rows, so the tables compared with
it are bf16 in both: 1 bf16 step (2^-8 relative) of the largest value. The
f32 canvas against the XLA encoder: 1e-5 of its largest magnitude (the
same f32 arithmetic in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.models.encoder import (  # noqa: E402
    MaskBevEncoder as JaxEncoder)
from mask_bev_tpu.ops.pallas_canvas import (  # noqa: E402
    pick_rows_per_block as jax_pick)
from mask_bev_tpu.ops.pallas_pfn import fused_stream_pfn  # noqa: E402
from mask_bev_tpu.ops.stream_pillars import (  # noqa: E402
    gather_at_starts as jax_gather, pillarize_stream_batch)
from mask_bev_tpu_torch.models.convert import load_flax  # noqa: E402
from mask_bev_tpu_torch.models.encoder import MaskBevEncoder  # noqa: E402
from mask_bev_tpu_torch.ops.canvas import pick_rows_per_block  # noqa: E402
from mask_bev_tpu_torch.ops.pfn import stream_pfn, stream_pfn_plain  # noqa: E402
from mask_bev_tpu_torch.ops.stream_pillars import (  # noqa: E402
    pillarize_stream)

GEO = dict(x_range=(-10.0, 10.0), y_range=(-10.0, 10.0),
           z_range=(-4.0, 4.0), voxel_size=0.5)
H = W = 40
K = 8
FC = (16, 16, 32)
CAP = 64


def _points(seed=0, b=2, n=1024):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-9.8, 9.8, (b, n, 4)).astype(np.float32)
    pts[:, :, 2] = rng.uniform(-3, 3, (b, n))
    pts[0, :300, :2] = 2.1 + rng.uniform(0, 0.3, (300, 2))  # runs > K
    pts[0, 900:950, 0] = 30.0                               # out of range
    msk = np.ones((b, n), bool)
    msk[1, 700:] = False
    return pts, msk


def _weights(dtype, seed=1):
    rng = np.random.default_rng(seed)
    out, d_in = [], 10
    for i, ch in enumerate(FC):
        units = ch if i == len(FC) - 1 else ch // 2
        w = (rng.normal(size=(d_in, units)) / np.sqrt(d_in)).astype(
            np.float32)
        g = (1.0 + 0.1 * rng.normal(size=units)).astype(np.float32)
        b = (0.1 * rng.normal(size=units)).astype(np.float32)
        out.append((w, g, b))
        d_in = 2 * units
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return ([(torch.as_tensor(w).to(td), torch.as_tensor(g),
              torch.as_tensor(b)) for (w, g, b) in out],
            [(jnp.asarray(w).astype(jd), jnp.asarray(g), jnp.asarray(b))
             for (w, g, b) in out])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_v1_kernel(dtype):
    pts, msk = _points()
    tw, jw = _weights(dtype)
    sp = pillarize_stream(torch.as_tensor(pts), torch.as_tensor(msk),
                          max_points_per_pillar=K, max_pillars=CAP, **GEO)
    jsp = pillarize_stream_batch(jnp.asarray(pts), jnp.asarray(msk),
                                 max_points_per_pillar=K, max_pillars=CAP,
                                 **GEO)
    np.testing.assert_array_equal(sp.kept.numpy(), np.asarray(jsp.kept))
    np.testing.assert_array_equal(sp.valid.numpy(), np.asarray(jsp.valid))
    assert (sp.valid.sum(1) == CAP).all()  # the cap binds
    kw = dict(with_distance=True, grid_w=W, voxel_size=GEO["voxel_size"],
              x0=GEO["x_range"][0], y0=GEO["y_range"][0])
    got, stats = stream_pfn_plain(sp, tw, k=K, out_dtype=torch.bfloat16,
                                  **kw)
    num_valid = sp.valid.sum(1).to(torch.int32)
    got2, stats2 = stream_pfn(sp, tw, k=K, out_dtype=torch.bfloat16,
                              num_valid=num_valid, **kw)
    torch.testing.assert_close(got2, got, rtol=0, atol=0)
    torch.testing.assert_close(stats2, stats, rtol=0, atol=0)
    feats = fused_stream_pfn(jsp.pts, jsp.pid, jsp.kept, jw, point_dim=4,
                             k=K, tile=256, interpret=True, **kw)
    want = np.asarray(jax_gather(feats, jsp.starts, jsp.valid)
                      .astype(jnp.float32))
    assert got.shape == want.shape == (2, CAP, FC[-1])
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=scale * 2 ** -8)
    t32 = got.float()
    np.testing.assert_allclose(
        stats.numpy(), np.stack([t32.sum((1, 2)).numpy(),
                                 (t32 * t32).sum((1, 2)).numpy()], -1),
        rtol=1e-6)


@pytest.mark.parametrize("mode", ["full", "channel"])
def test_capped_encoder_matches_xla_encoder(mode):
    """The cap binds (CAP < occupied cells): both keep the first CAP cells
    in pid order; the canvas is kernel 10's table through kernel 2."""
    pts, msk = _points(seed=3)
    jenc = JaxEncoder(feat_channels=FC, max_points_per_pillar=K,
                      max_pillars=CAP, pseudo_image_norm=mode,
                      use_pallas=False, **GEO)
    v = jenc.init(jax.random.PRNGKey(1), jnp.asarray(pts), jnp.asarray(msk),
                  train=False)
    rng = np.random.default_rng(5)
    v = jax.device_get(jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.3 * rng.uniform(size=x.shape).astype(np.float32)
        if ("batch_stats" in str(p[0]) or "norm" in str(p)) else x, v))
    want = np.asarray(jenc.apply(v, jnp.asarray(pts), jnp.asarray(msk),
                                 train=False))
    enc = load_flax(MaskBevEncoder(
        GEO["x_range"], GEO["y_range"], GEO["z_range"], GEO["voxel_size"],
        feat_channels=FC, max_points_per_pillar=K, pseudo_image_norm=mode,
        max_pillars=CAP), v)
    assert not enc.uses_slot_path(False)
    with torch.no_grad():
        sp, _, _, num_valid = enc.capped_table(torch.as_tensor(pts),
                                               torch.as_tensor(msk))
        got = enc(torch.as_tensor(pts), torch.as_tensor(msk)).numpy()
    assert (num_valid == CAP).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_slot_path_choice():
    """``uses_slot_path``: the JAX condition without the TPU check, on the
    port's copy of the canvas block rule."""
    for h in range(1, 140, 3):
        for w in range(1, 900, 37):
            assert pick_rows_per_block(h, w) == jax_pick(h, w), (h, w)
    assert pick_rows_per_block(800, 800) and pick_rows_per_block(500, 500)

    def enc(fc, **kw):
        return MaskBevEncoder(GEO["x_range"], GEO["y_range"],
                              GEO["z_range"], GEO["voxel_size"],
                              feat_channels=fc, **kw)
    assert enc((16, 16, 128)).uses_slot_path(False)
    assert not enc((16, 16, 128)).uses_slot_path(True)
    assert not enc((16, 16, 128), use_pallas=False).uses_slot_path(False)
    assert not enc((16, 16, 32)).uses_slot_path(False)
