"""Port encoder (stream pillars, kernel 1's PFN, kernel 2's canvas + norm)
against the JAX package on the same points and weights.

Tolerances: f32 canvas against the XLA encoder 1e-5 absolute (the same f32
arithmetic in another order; the canvas is normalised to unit scale). The
JAX slot kernel writes bf16 features, so the pillar table and canvas
compared with it are bf16 in both: 1 bf16 step (2^-8 relative) of the
largest value, and the statistics, which sum the same rounded values,
1e-5 relative.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.models.encoder import (  # noqa: E402
    MaskBevEncoder as JaxEncoder, PillarFeatureNet as JaxPFN)
from mask_bev_tpu.ops.pallas_canvas import canvas_from_table  # noqa: E402
from mask_bev_tpu.ops.pallas_pfn import fused_stream_pfn_slots  # noqa: E402
from mask_bev_tpu.ops.stream_pillars import (  # noqa: E402
    pillarize_stream_batch, pillarize_stream_packed as jax_packed)
from mask_bev_tpu_torch.models.convert import load_flax  # noqa: E402
from mask_bev_tpu_torch.models.encoder import MaskBevEncoder  # noqa: E402
from mask_bev_tpu_torch.ops.canvas import canvas_norm  # noqa: E402
from mask_bev_tpu_torch.ops.pfn import pfn_plain  # noqa: E402
from mask_bev_tpu_torch.ops.stream_pillars import (  # noqa: E402
    pillarize_stream_packed)

GEO = dict(x_range=(-10.0, 10.0), y_range=(-10.0, 10.0),
           z_range=(-4.0, 4.0), voxel_size=0.5)
H = W = 40
K = 8
FC = (16, 16, 32)


def _points(seed=0, b=2, n=1024):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-9.8, 9.8, (b, n, 4)).astype(np.float32)
    pts[:, :, 2] = rng.uniform(-3, 3, (b, n))
    pts[0, :300, :2] = 2.1 + rng.uniform(0, 0.3, (300, 2))  # runs > K
    pts[0, 900:950, 0] = 30.0                               # out of range
    msk = np.ones((b, n), bool)
    msk[1, 700:] = False
    return pts, msk


def _variables(pts, msk, mode="full"):
    enc = JaxEncoder(feat_channels=FC, max_points_per_pillar=K,
                     max_pillars=H * W, pseudo_image_norm=mode, **GEO)
    v = enc.init(jax.random.PRNGKey(1), jnp.asarray(pts), jnp.asarray(msk),
                 train=False)
    rng = np.random.default_rng(5)
    # non-trivial BN statistics and affine so folding and the affine count
    v = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.3 * rng.uniform(size=x.shape).astype(np.float32)
        if ("batch_stats" in str(p[0]) or "norm" in str(p)) else x, v)
    return enc, jax.device_get(v)


def _port(v, mode="full"):
    enc = MaskBevEncoder(GEO["x_range"], GEO["y_range"], GEO["z_range"],
                         GEO["voxel_size"], feat_channels=FC,
                         max_points_per_pillar=K, pseudo_image_norm=mode)
    return load_flax(enc, v)


@pytest.mark.parametrize("mode", ["full", "channel"])
def test_canvas_matches_xla_encoder(mode):
    pts, msk = _points()
    jenc, v = _variables(pts, msk, mode)
    want = np.asarray(jenc.apply(v, jnp.asarray(pts), jnp.asarray(msk),
                                 train=False))
    enc = _port(v, mode)
    with torch.no_grad():
        got = enc(torch.as_tensor(pts), torch.as_tensor(msk)).numpy()
    assert got.shape == (2, H, W, FC[-1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_table_and_stats_match_pallas_slot_kernels():
    pts, msk = _points(seed=3)
    _, v = _variables(pts, msk)
    enc = _port(v)
    weights = enc.pillar_feature_net.folded_weights()
    ps = pillarize_stream_packed(
        torch.as_tensor(pts), torch.as_tensor(msk),
        max_points_per_pillar=K, **GEO)
    table, stats = pfn_plain(
        ps, weights, point_dim=4, with_distance=True, grid_w=W,
        voxel_size=GEO["voxel_size"], x0=GEO["x_range"][0],
        y0=GEO["y_range"][0], out_dtype=torch.bfloat16)

    cols = jax_packed(jnp.asarray(pts), jnp.asarray(msk), **GEO)
    jw = [(jnp.asarray(w.numpy()), jnp.asarray(g.numpy()),
           jnp.asarray(b.numpy())) for (w, g, b) in weights]
    feats, cells, jstats = fused_stream_pfn_slots(
        cols, jw, point_dim=4, with_distance=True, k=K, grid_w=W, grid_h=H,
        voxel_size=GEO["voxel_size"], x0=GEO["x_range"][0],
        y0=GEO["y_range"][0], tile=256, interpret=True)
    feats = np.asarray(feats.astype(jnp.float32))
    starts = ps.starts.numpy()
    for b in range(2):
        p = int(ps.num_pillars[b])
        want = feats[b, starts[b, :p]]
        got = table[b, :p].float().numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=scale * 2 ** -8)
        np.testing.assert_array_equal(np.asarray(cells)[b, starts[b, :p]],
                                      ps.cells[b, :p].numpy())
    js = np.asarray(jstats).sum(-1)  # (B, 2): [sum, sum of squares]
    np.testing.assert_allclose(stats.numpy(), js, rtol=1e-5)

    # canvas + norm against the Pallas canvas kernel on the same table
    elems = float(H * W * FC[-1])
    mean = stats[:, 0] / elems
    var = stats[:, 1] / elems - mean * mean
    nw = enc.norm
    got = canvas_norm(table, ps.cells, ps.num_pillars, mean, var,
                      nw.weight.detach().to(torch.bfloat16),
                      nw.bias.detach().to(torch.bfloat16), (H, W))
    want = canvas_from_table(
        jnp.asarray(feats, jnp.bfloat16), cells.astype(jnp.int32), None,
        (H, W), rows_per_block=4, norm_stats=(jnp.asarray(mean.numpy()),
                                              jnp.asarray(var.numpy())),
        norm_affine=(jnp.asarray(nw.weight.detach().numpy(), jnp.bfloat16),
                     jnp.asarray(nw.bias.detach().numpy(), jnp.bfloat16)),
        interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=np.abs(want).max() * 2 ** -8)


def test_every_cell_kept_where_xla_caps_pillars():
    """The XLA stream path keeps only the first ``max_pillars`` cells by
    ascending id; the port's slot-path table (like the TPU slot path) keeps
    every occupied cell. With the cap on, the XLA table is its first
    rows."""
    pts, msk = _points(seed=4)
    cap = 64
    pfn = JaxPFN(feat_channels=FC, max_points_per_pillar=K, use_pallas=False,
                 **GEO)
    sp = pillarize_stream_batch(jnp.asarray(pts), jnp.asarray(msk),
                                max_points_per_pillar=K, max_pillars=cap,
                                **GEO)
    v = jax.device_get(pfn.init(jax.random.PRNGKey(2), sp, train=False))
    want = np.asarray(pfn.apply(v, sp, train=False))  # (B, cap, C)

    enc = MaskBevEncoder(GEO["x_range"], GEO["y_range"], GEO["z_range"],
                         GEO["voxel_size"], feat_channels=FC,
                         max_points_per_pillar=K)
    load_flax(enc.pillar_feature_net, v)
    with torch.no_grad():
        ps, table, _ = enc.pillar_table(torch.as_tensor(pts),
                                        torch.as_tensor(msk))
    assert (ps.num_pillars > cap).all()
    np.testing.assert_allclose(table[:, :cap].numpy(), want, rtol=0,
                               atol=1e-5)
    assert float(table[:, cap:].abs().sum()) > 0  # cells the cap drops


def test_stream_directory():
    pts, msk = _points(seed=6)
    ps = pillarize_stream_packed(torch.as_tensor(pts), torch.as_tensor(msk),
                                 max_points_per_pillar=K, **GEO)
    for b in range(2):
        p = int(ps.num_pillars[b])
        cells = ps.cells[b].numpy()
        assert (np.diff(cells[:p]) > 0).all() and (cells[p:] == H * W).all()
        assert (ps.counts[b, :p] >= 1).all() and (ps.counts[b, :p] <= K).all()
        assert int(ps.counts[b].sum()) == int(ps.kept[b].sum())
    # the 300-point run keeps the first K points in input order
    sp = pillarize_stream_batch(jnp.asarray(pts), jnp.asarray(msk),
                                max_points_per_pillar=K, max_pillars=H * W,
                                **GEO)
    np.testing.assert_array_equal(ps.kept.numpy(), np.asarray(sp.kept))
    np.testing.assert_array_equal(ps.cols[0].numpy(),
                                  np.asarray(sp.pts)[..., 0])
