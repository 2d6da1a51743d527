"""The wider shapes the JAX package serves, port against the JAX package on
the CPU: the port's plain route (the kernels' plain versions, which the
card's kernels are held against) against the JAX XLA route, on the same
weights (``from_flax`` / ``load_flax``) and inputs drawn from a seed with
numpy.

* a Swin block at windows 12 and 16 (144 and 256 tokens), shifted and not,
  C 32 over 2 heads, as kernel 3's chain and as the XLA form with kernel
  7's attention: 1e-4 of the reference's largest magnitude (f32, the same
  arithmetic in another order; ``test_torch_port_swin.py``'s tolerance);
* the backbone with kernel 8's patch embed + LN at E = 48 and 96 against
  the JAX backbone's conv + LN: 1e-4;
* the slot PFN (kernel 1, every occupied cell) and the capped-stream PFN
  (kernel 10) at K = 64 and 100 points a pillar, on scans whose pillars
  hold up to K kept points: the canvas against the JAX XLA encoder's,
  1e-5 absolute (the canvas is normalised to unit scale;
  ``test_torch_port_encoder.py``'s tolerance);
* the decoder at Q = 300 and with 1 and 16 heads, C 64: final logits 1e-4
  absolute (``test_torch_port_heads.py``'s);
* ``MaskBevPredictor`` against ``MaskBev(train=False, final_only=True)``
  for ``tiny_test_config()`` at window 12, and at 64 points a pillar on
  long pillars: class and mask probabilities 1e-4 absolute (f32; the
  logits' 1e-3 of ``test_torch_port_model.py`` through a softmax and a
  sigmoid, whose slopes are at most 1/4 and 1).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from mask_bev_tpu.models.encoder import (  # noqa: E402
    MaskBevEncoder as JaxEncoder)
from mask_bev_tpu.models.mask2former import (  # noqa: E402
    Mask2FormerDecoder as JaxDecoder)
from mask_bev_tpu.models.maskbev import MaskBev as JaxMaskBev  # noqa: E402
from mask_bev_tpu.models.swin import (  # noqa: E402
    SwinBlock as JaxBlock, SwinTransformer as JaxSwin)
from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.inference import MaskBevPredictor  # noqa: E402
from mask_bev_tpu_torch.models.convert import (  # noqa: E402
    from_flax, load_flax)
from mask_bev_tpu_torch.models.encoder import MaskBevEncoder  # noqa: E402
from mask_bev_tpu_torch.models.mask2former import (  # noqa: E402
    Mask2FormerDecoder)
from mask_bev_tpu_torch.models.swin import (  # noqa: E402
    SwinBlock, SwinTransformer)
from mask_bev_tpu_torch.ops import pfn as kpfn  # noqa: E402
from mask_bev_tpu_torch.ops.canvas import canvas_norm  # noqa: E402
from mask_bev_tpu_torch.ops.stream_pillars import (  # noqa: E402
    pillarize_stream_packed)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _variables(init, seed):
    """Random flax variables of ``init()``'s tree (shapes from
    ``eval_shape``, values from numpy: no init compile) at trained-model
    scales: kernels of fan-in variance, norm scales near 1, small biases
    and relative-position tables, batch statistics away from 0 and 1."""
    shapes = jax.eval_shape(init)
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


# ---- a Swin block at windows 12 and 16 --------------------------------------


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("win,hw", [(12, (15, 13)), (16, (19, 17))])
def test_block_long_windows_match_xla(win, hw, shift):
    """C 32 over 2 heads on a grid that pads to 2 x 2 windows: kernel 3's
    chain (``fused``) and the XLA form with kernel 7's attention
    (``fused_attention``), both plain, against the JAX block's XLA path."""
    c, heads = 32, 2
    rng = np.random.default_rng(win)
    x = rng.normal(size=(2, hw[0] * hw[1], c)).astype(np.float32)
    jb = JaxBlock(c, heads, win, shift=shift, use_pallas=False)
    v = _variables(lambda: jb.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   hw, train=False), win + 1)
    want = np.asarray(jax.jit(lambda v_, x_: jb.apply(
        v_, x_, hw, train=False))(v, jnp.asarray(x)))
    blk = load_flax(SwinBlock(c, heads, win, shift=shift), v)
    with torch.no_grad():
        chain = blk(torch.as_tensor(x), hw).numpy()
        msa = blk(torch.as_tensor(x), hw, fused=False,
                  fused_attention=True).numpy()
    assert _rel(chain, want) <= 1e-4
    assert _rel(msa, want) <= 1e-4


# ---- patch embed + LN at E = 48 and 96 ---------------------------------------


@pytest.mark.parametrize("e,heads", [(48, (3, 6)), (96, (3, 6))])
def test_backbone_embed_48_96_matches_jax(e, heads):
    """The port's backbone with kernel 8's patch embed + LN (its plain
    version) at E = 48 (``tiny_test_config()``'s width) and 96 (Swin-T's)
    over a 128-channel canvas, against the JAX backbone's XLA conv + LN."""
    b, h, w, c = 2, 32, 32, 128
    rng = np.random.default_rng(e)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    kw = dict(embed_dim=e, depths=(1, 1), num_heads=heads, window=4,
              patch_size=4, use_pallas=False)
    ref = JaxSwin(**kw)
    v = _variables(lambda: ref.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                    train=False), e + 1)
    want = jax.jit(lambda v_, x_: ref.apply(v_, x_, train=False))(
        v, jnp.asarray(x))
    sw = load_flax(SwinTransformer(c, embed_dim=e, depths=(1, 1),
                                   num_heads=heads, window=4), v)
    with torch.no_grad():
        got = sw(torch.as_tensor(x), fused_embed=True)
    assert [tuple(g.shape) for g in got] == [tuple(o.shape) for o in want]
    assert got[0].shape[-1] == e
    for g, o in zip(got, want):
        assert _rel(g.numpy(), o) <= 1e-4


# ---- the PFNs at 64 and 100 points a pillar ----------------------------------

GEO = dict(x_range=(-10.0, 10.0), y_range=(-10.0, 10.0),
           z_range=(-4.0, 4.0), voxel_size=0.5)
H = W = 40
FC = (16, 16, 32)


def long_pillars(seed, b=2, n=2048):
    """Scans whose pillars (0.5 m cells) hold up to hundreds of points: a
    patch of 600 points over 0.5 m x 0.5 m (one to four cells), one of 160
    over 1 m (~40 a cell), over a uniform spread; points out of range and
    masked points."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-9.8, 9.8, (b, n, 4)).astype(np.float32)
    pts[:, :, 2] = rng.uniform(-3, 3, (b, n))
    pts[0, :600, :2] = 2.1 + rng.uniform(0, 0.5, (600, 2))
    pts[1, :160, :2] = -4.0 + rng.uniform(0, 1.0, (160, 2))
    pts[0, 1900:1950, 0] = 30.0
    msk = np.ones((b, n), bool)
    msk[1, 1500:] = False
    return pts, msk


def _encoders(k, pts, msk):
    """The JAX XLA encoder (every occupied cell kept: ``max_pillars`` H W)
    and the port's, on the same variables."""
    enc = JaxEncoder(feat_channels=FC, max_points_per_pillar=k,
                     max_pillars=H * W, pseudo_image_norm="full", **GEO)
    v = _variables(lambda: enc.init(jax.random.PRNGKey(1), jnp.asarray(pts),
                                    jnp.asarray(msk), train=False), k)
    port = load_flax(MaskBevEncoder(
        GEO["x_range"], GEO["y_range"], GEO["z_range"], GEO["voxel_size"],
        feat_channels=FC, max_points_per_pillar=k,
        pseudo_image_norm="full", max_pillars=H * W), v)
    return enc, v, port


@pytest.mark.parametrize("k", [64, 100])
def test_pfns_on_long_pillars_match_xla(k):
    """Kernel 10's plain version (the port's capped eval encoder) and kernel
    1's (the slot table, then kernel 2's plain canvas) against the JAX XLA
    encoder, at K = 64 and 100 on pillars of up to K kept points."""
    pts, msk = long_pillars(k)
    enc, v, port = _encoders(k, pts, msk)
    want = np.asarray(jax.jit(lambda v_, p_, m_: enc.apply(
        v_, p_, m_, train=False))(v, jnp.asarray(pts), jnp.asarray(msk)))
    tp, tm = torch.as_tensor(pts), torch.as_tensor(msk)
    ps = pillarize_stream_packed(tp, tm, max_points_per_pillar=k, **GEO)
    assert int(ps.counts.max()) == k and int((ps.counts > 32).sum()) >= 3
    with torch.no_grad():
        capped = port(tp, tm).numpy()
        net = port.pillar_feature_net
        table, stats = kpfn.pfn_plain(
            ps, net.folded_weights(), point_dim=4, with_distance=True,
            grid_w=W, voxel_size=GEO["voxel_size"], x0=GEO["x_range"][0],
            y0=GEO["y_range"][0], out_dtype=torch.float32)
        elems = float(H * W * FC[-1])
        mean = stats[:, 0] / elems
        var = stats[:, 1] / elems - mean * mean
        slot = canvas_norm(table, ps.cells, ps.num_pillars, mean, var,
                           port.norm.weight, port.norm.bias, (H, W),
                           port.norm.eps).numpy()
    assert capped.shape == slot.shape == want.shape == (2, H, W, FC[-1])
    np.testing.assert_allclose(capped, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(slot, want, rtol=0, atol=1e-5)


# ---- the decoder at 300 queries, 1 and 16 heads ------------------------------


@pytest.mark.parametrize("q,heads", [(300, 8), (8, 1), (8, 16)],
                         ids=["q300", "heads1", "heads16"])
def test_decoder_wide_matches_xla(q, heads):
    """The decoder's plain final-only stack (the split instance's plain
    version) at C 64 against the JAX decoder's XLA path."""
    rng = np.random.default_rng(q + heads)
    b, c = 2, 64
    mf = rng.normal(size=(b, 32, 32, c)).astype(np.float32)
    mems = [rng.normal(size=(b, h, w, c)).astype(np.float32)
            for (h, w) in [(4, 4), (8, 8), (16, 16)]]
    kw = dict(num_queries=q, num_classes=1, num_layers=3, feat_channels=c,
              out_channels=c, num_heads=heads, ffn_dim=128)
    jd = JaxDecoder(**kw)
    v = _variables(lambda: jd.init(jax.random.PRNGKey(q), jnp.asarray(mf),
                                   [jnp.asarray(m) for m in mems],
                                   train=False), heads)
    want = jax.jit(lambda v_, mf_, ms_: jd.apply(
        v_, mf_, ms_, train=False, final_only=True))(
            v, jnp.asarray(mf), [jnp.asarray(m) for m in mems])
    dec = load_flax(Mask2FormerDecoder(**kw), v)
    with torch.no_grad():
        got = dec(torch.as_tensor(mf), [torch.as_tensor(m) for m in mems],
                  final_only=True)
    wm = np.asarray(want.mask_logits)
    assert got.mask_logits.shape == wm.shape and wm.shape[2] == q
    np.testing.assert_allclose(got.cls_logits.numpy(),
                               np.asarray(want.cls_logits), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.mask_logits.numpy(), wm, rtol=0,
                               atol=1e-4)


# ---- the predictor against MaskBev -------------------------------------------


def _tiny_scans(cfg, seed):
    """The tiny config's scans with long pillars: a patch of 1200 points
    over 0.5 m x 0.5 m (cells of 0.25 m: up to ~300 a cell)."""
    rng = np.random.default_rng(seed)
    n = cfg.max_points_per_scan
    pts = np.stack([rng.uniform(-11, 11, (2, n)), rng.uniform(-11, 11, (2, n)),
                    rng.uniform(-3, 3, (2, n)), rng.uniform(0, 1, (2, n))],
                   -1).astype(np.float32)
    pts[0, :1200, :2] = 1.3 + rng.uniform(0, 0.5, (1200, 2))
    mask = np.ones((2, n), bool)
    mask[1, 1800:] = False
    return pts, mask


@pytest.mark.parametrize("over", [dict(backbone_window_size=12),
                                  dict(max_num_points=64)],
                         ids=["window12", "points64"])
def test_predictor_wide_matches_maskbev(over):
    """``tiny_test_config()`` at window 12 (the 20 x 20 stage-0 grid in 2 x 2
    windows of 144 tokens, then single windows) and at 64 points a pillar
    on long pillars; both packages keep every occupied cell
    (``max_num_pillars`` H W)."""
    cfg = tiny_test_config()
    h, w = cfg.grid_hw
    jcfg = jax_tiny().replace(max_num_pillars=h * w, **over)
    pcfg = cfg.replace(max_num_pillars=h * w, **over)
    pts, mask = _tiny_scans(pcfg, seed=7)
    model = JaxMaskBev(jcfg)
    v = _variables(lambda: model.init(jax.random.PRNGKey(0),
                                      jnp.asarray(pts), jnp.asarray(mask),
                                      train=False), 8)
    out = jax.jit(lambda v_, p_, m_: model.apply(
        v_, p_, m_, train=False, final_only=True))(
            v, jnp.asarray(pts), jnp.asarray(mask))
    want_cls = np.asarray(jax.nn.softmax(out.cls_logits[-1], axis=-1))
    want_mask = np.asarray(jax.nn.sigmoid(out.mask_logits[-1]))
    pred = MaskBevPredictor(pcfg, from_flax(v), device="cpu")
    got_cls, got_mask = pred.forward(torch.as_tensor(pts),
                                     torch.as_tensor(mask))
    assert got_cls.shape == want_cls.shape and got_mask.shape == (
        want_mask.shape)
    np.testing.assert_allclose(got_cls.numpy(), want_cls, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_mask.numpy(), want_mask, rtol=0,
                               atol=1e-4)
