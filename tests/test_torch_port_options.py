"""The model options, port against the JAX package on the same weights
(``load_flax``) and inputs from a numpy seed: the height head and loss, the
absolute position embedding with ``swap_dims``, the Fourier and cosine
encodings, a fifth point column and the pixel decoder's window-attention
refinement, each alone at its module and all together in the whole model.

Tolerances (all f32):
* whole model, every option on: the final logits of both decoder forms
  (kernel 5's plain version, the per-layer decoder), all L+1 head passes
  of the eval and training forwards and the running statistics 1e-4
  absolute (``test_torch_port_model.py`` holds f32 to 1e-3);
* decoder with the height head: 1e-4 absolute against the XLA decoder and
  against kernel 5 run in interpret mode (``test_torch_port_heads.py``'s);
* encoder canvases (Fourier, cosine, 5 columns; eval and training forms):
  1e-6 of the canvas's largest magnitude (~20 under the random full-mode
  affine: sin and cos differ by an f32 step between the two packages, and
  the training form's batch statistics sum in another order);
* Swin pyramid with the absolute embedding, and the pixel decoder with its
  refinement blocks: 1e-4 relative to the largest magnitude;
* height bins exactly; the losses and ``loss_height``'s gradient 1e-5
  relative (f32 sums in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu import losses as jl  # noqa: E402
from mask_bev_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from mask_bev_tpu.models.encoder import (  # noqa: E402
    MaskBevEncoder as JaxEncoder)
from mask_bev_tpu.models.mask2former import (  # noqa: E402
    Mask2FormerDecoder as JaxDecoder)
from mask_bev_tpu.models.maskbev import MaskBev as JaxMaskBev  # noqa: E402
from mask_bev_tpu.models.pixel_decoder import (  # noqa: E402
    PixelDecoder as JaxPixelDecoder)
from mask_bev_tpu.models.swin import SwinTransformer as JaxSwin  # noqa: E402
from mask_bev_tpu_torch import losses as tl  # noqa: E402
from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.models.convert import load_flax  # noqa: E402
from mask_bev_tpu_torch.models.encoder import MaskBevEncoder  # noqa: E402
from mask_bev_tpu_torch.models.mask2former import (  # noqa: E402
    Mask2FormerDecoder)
from mask_bev_tpu_torch.models.maskbev import MaskBev  # noqa: E402
from mask_bev_tpu_torch.models.pixel_decoder import PixelDecoder  # noqa: E402
from mask_bev_tpu_torch.models.swin import SwinTransformer  # noqa: E402

T = torch.as_tensor
ALL = dict(predict_height=True, backbone_use_abs_emb=True,
           backbone_swap_dims=True, pixel_decoder_num_attn_layers=2,
           encoder_encoding_type="fourier", pc_point_dim=5)


def _value(name, shape, rng):
    r = rng.normal(size=shape).astype(np.float32)
    if name == "var":
        return (0.5 + rng.uniform(size=shape)).astype(np.float32)
    if name in ("mean", "bias"):
        return 0.05 * r
    if name == "scale":
        return 1.0 + 0.1 * r
    if name == "kernel":
        return r / np.sqrt(np.prod(shape[:-1]))
    if name in ("rel_pos_bias_table", "absolute_pos_embed"):
        return 0.02 * r
    return r  # query_feat, query_embed, level_embed


def _randomise(tree, seed):
    """Random values of the tree's shapes at trained-model scales."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _value(str(getattr(p[-1], "key", p[-1])), s.shape, rng),
        tree)


def _scans(d, seed=0, b=2, n=2048):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-11, 11, (b, n, 2)),
                          rng.uniform(-3, 3, (b, n, 1)),
                          rng.uniform(0, 1, (b, n, d - 3))],
                         -1).astype(np.float32)
    pts[0, :300, :2] = 1.3 + rng.uniform(0, 0.2, (300, 2))
    mask = np.ones((b, n), bool)
    mask[:, 1800:] = False
    return pts, mask


# ---- the whole model, every option on --------------------------------------

@pytest.fixture(scope="module")
def whole():
    """The JAX model with every option on (shapes from one eval-shape
    trace, jitted applies: a compile costs less than the op-by-op run) and
    the port's configuration."""
    h, w = jax_tiny().grid_hw
    kw = dict(ALL, max_num_pillars=h * w)
    jcfg = jax_tiny().replace(**kw)
    pts, mask = _scans(5)
    jm = JaxMaskBev(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask),
        train=False))
    v = _randomise(shapes, 1)
    out = {fo: jax.jit(lambda a, b, fo=fo: jm.apply(
        v, a, b, train=False, final_only=fo))(pts, mask)
        for fo in (True, False)}
    tr, mut = jax.jit(lambda a, b: jm.apply(
        v, a, b, train=True, final_only=False, mutable=["batch_stats"]))(
            pts, mask)
    return dict(cfg=tiny_test_config().replace(**kw), v=v, pts=pts,
                mask=mask, out=out, train=tr, stats=mut["batch_stats"])


def _close(got, want, atol=1e-4):
    assert got is not None and want is not None
    g, w = got.detach().float().numpy(), np.asarray(want, np.float32)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=atol)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_whole_model_final_matches_jax(whole, use_kernel):
    """``load_flax`` consumes every leaf of the JAX model with every option
    on; the final head pass of kernel 5's form and of the per-layer
    decoder, height logits included."""
    cfg = whole["cfg"].replace(use_pallas_head=use_kernel)
    model = load_flax(MaskBev(cfg), whole["v"])
    with torch.no_grad():
        got = model(T(whole["pts"]), T(whole["mask"]))
    want = whole["out"][True]
    assert got.height_logits.shape == (1, 2, cfg.num_queries,
                                       cfg.head_num_height_bins)
    for g, w in zip(got, want):
        _close(g, w)


def test_whole_model_per_layer_matches_jax(whole):
    model = load_flax(MaskBev(whole["cfg"]), whole["v"])
    with torch.no_grad():
        got = model(T(whole["pts"]), T(whole["mask"]), final_only=False)
    want = whole["out"][False]
    assert got.height_logits.shape[0] == whole["cfg"].head_num_decoder_layers + 1
    for g, w in zip(got, want):
        _close(g, w)


def test_whole_model_training_forward_matches_jax(whole):
    """The training forward (batch norm in train form, refinement blocks on
    the live parameters): every head pass, and the running statistics it
    updates."""
    model = load_flax(MaskBev(whole["cfg"]), whole["v"])
    got = model(T(whole["pts"]), T(whole["mask"]), train=True,
                final_only=False)
    for g, w in zip(got, whole["train"]):
        _close(g, w)
    enc = model.encoder.pillar_feature_net
    for i in range(enc.num_layers):
        jst = whole["stats"]["encoder"]["pillar_feature_net"][f"pfn_{i}"][
            "norm"]
        norm = getattr(enc, f"pfn_{i}").norm
        _close(norm.running_mean, jst["mean"], 1e-5)
        _close(norm.running_var, jst["var"], 1e-5)


# ---- the height head: kernel 5's form, the XLA decoder ----------------------

@pytest.fixture(scope="module")
def height_decoder():
    rng = np.random.default_rng(3)
    c, b = 64, 2
    mf = rng.normal(size=(b, 32, 32, c)).astype(np.float32)
    mems = [rng.normal(size=(b, h, h, c)).astype(np.float32)
            for h in (4, 8, 16)]
    kw = dict(num_queries=8, num_classes=1, num_layers=6, feat_channels=c,
              out_channels=c, num_heads=2, ffn_dim=128)
    jd = JaxDecoder(**kw, predict_height=True)
    shapes = jax.eval_shape(lambda: jd.init(
        jax.random.PRNGKey(0), jnp.asarray(mf),
        [jnp.asarray(m) for m in mems], train=False))
    v = _randomise(shapes, 4)
    return jd, kw, v, mf, mems


@pytest.mark.parametrize("form", ["interpret", "xla", "per_layer"])
def test_height_head_matches_jax(height_decoder, form):
    """``interpret``: JAX's decoder stack kernel in interpret mode against
    the port's kernel-5 form (its plain version here); ``xla``: the scanned
    XLA decoder against the port's per-layer ``final_only`` form;
    ``per_layer``: all L+1 head passes."""
    jd, kw, v, mf, mems = height_decoder
    if form == "interpret":
        jd = JaxDecoder(**kw, predict_height=True, use_pallas=True,
                        pallas_interpret=True)
    final = form != "per_layer"
    want = jax.jit(lambda a, b: jd.apply(v, a, b, train=False,
                                         final_only=final))(mf, mems)
    dec = load_flax(Mask2FormerDecoder(**kw, predict_height=True,
                                       use_kernel=form == "interpret"), v)
    with torch.no_grad():
        got = dec(T(mf), [T(m) for m in mems], final_only=final)
    assert got.height_logits.shape == (1 if final else 7, 2, 8, 12)
    for g, w in zip(got, want):
        _close(g, w)


# ---- the height loss ---------------------------------------------------------

def test_height_bins_match_jax():
    """Every centimetre from -0.5 to 4 m as the f32 of its decimal, the
    heights near a .5 boundary of the bins (1.3, 1.5, ...) included, and
    the clip at both ends."""
    h = np.array([[f"{i / 100:.2f}" for i in range(-50, 400)]], np.float32)
    want = np.clip(np.asarray(jnp.round((jnp.asarray(h) - 1.0) / 0.2))
                   .astype(np.int32) + 1, 0, 11)
    got = tl.height_bins(T(h), 12).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(want)) == set(range(12))


def _loss_inputs(seed, n_l=3, b=2, q=6, g=6, hw=16):
    rng = np.random.default_rng(seed)
    cls = rng.normal(size=(n_l, b, q, 3)).astype(np.float32)
    mask = (2 * rng.normal(size=(n_l, b, q, hw, hw))).astype(np.float32)
    height = rng.normal(size=(n_l, b, q, 12)).astype(np.float32)
    masks = np.zeros((b, g, hw, hw), bool)
    valid = np.zeros((b, g), bool)
    for i, nv in enumerate((2, 4)):
        for j in range(nv):
            y, x = rng.integers(0, hw - 6, 2)
            masks[i, j, y:y + 5, x:x + 4] = True
            valid[i, j] = True
    labels = rng.integers(0, 2, (b, g)).astype(np.int32)
    heights = rng.choice(np.float32([0.7, 1.3, 1.5, 1.62, 2.1, 3.4]),
                         (b, g)).astype(np.float32)
    mcs = rng.uniform(size=(n_l, b, 64, 2)).astype(np.float32)
    lcs = rng.uniform(size=(n_l, b * q, 64, 2)).astype(np.float32)
    return cls, mask, height, labels, masks, valid, heights, mcs, lcs


def test_loss_with_height_matches_jax():
    """The deep-supervised loss with ``loss_height`` over 3 head passes,
    every point pinned, and the gradient of ``loss_height`` in the height
    logits, against the JAX per-layer losses at the same points."""
    kw = dict(head_num_points=64, num_queries=6, head_num_classes=2,
              predict_height=True, head_height_weight=0.7)
    jcfg, tcfg = jax_tiny().replace(**kw), tiny_test_config().replace(**kw)
    (cls, mask, height, labels, masks, valid, heights, mcs,
     lcs) = _loss_inputs(5)
    n_l = cls.shape[0]

    def jax_layer(hl, c, m, mc, lc):
        return jl.layer_losses(
            jax.random.PRNGKey(0), c, m, hl, jnp.asarray(labels),
            jnp.asarray(masks), jnp.asarray(valid), jnp.asarray(heights),
            jcfg, match_coords=mc, loss_coords=lc)[0]

    layer = jax.jit(jax_layer)
    grad = jax.jit(jax.grad(lambda *a: jax_layer(*a)["loss_height"]))
    args = [(height[li], cls[li], mask[li], mcs[li], lcs[li])
            for li in range(n_l)]
    per = [layer(*a) for a in args]
    grads = [np.asarray(grad(*a)) for a in args]
    th = T(height).clone().requires_grad_(True)
    outputs = tl.DecoderOutputs(T(cls), T(mask), th)
    total, logs = tl.maskbev_loss(
        outputs, T(labels), T(masks), T(valid), tcfg,
        coords=[(T(mcs[li]), T(lcs[li])) for li in range(n_l)],
        gt_heights=T(heights))
    want_total = 0.0
    for name in ("loss_cls", "loss_mask", "loss_dice", "loss_height"):
        wv = np.asarray([float(d[name]) for d in per])
        np.testing.assert_allclose(logs[f"{name}_layers"].detach().numpy(),
                                   wv, rtol=1e-5, atol=1e-6)
        want_total += wv.sum()
    assert float(logs["loss_height"].detach()) > 0
    np.testing.assert_allclose(float(total.detach()), want_total, rtol=1e-5)
    (g,) = torch.autograd.grad(logs["loss_height"], th)
    np.testing.assert_allclose(g.numpy(), np.stack(grads), rtol=1e-5,
                               atol=1e-7)
    # without GT heights (predict_height off in the step) no height term
    _, logs0 = tl.maskbev_loss(
        outputs, T(labels), T(masks), T(valid), tcfg,
        coords=[(T(mcs[li]), T(lcs[li])) for li in range(n_l)])
    assert "loss_height" not in logs0


# ---- the encodings and wider point columns ----------------------------------

GEO = dict(x_range=(-10.0, 10.0), y_range=(-10.0, 10.0),
           z_range=(-4.0, 4.0), voxel_size=0.5)
ENCODERS = {"fourier": dict(encoding_type="fourier"),
            "cosine": dict(encoding_type="cosine"),
            "point_dim5": dict(point_dim=5)}


@pytest.mark.parametrize("case", sorted(ENCODERS))
def test_encoder_canvas_matches_jax(case):
    """The eval canvas (the capped stream with the plain pillar feature
    net, then kernel 2's plain version) and the training canvas, with the
    running statistics the training form updates. A cap of 256 pillars
    binds on both sides."""
    kw = dict(feat_channels=(16, 32), max_points_per_pillar=8,
              max_pillars=256, **ENCODERS[case])
    d = kw.get("point_dim", 4)
    pts, msk = _scans(d, seed=7, n=1024)
    jenc = JaxEncoder(**GEO, **kw)
    shapes = jax.eval_shape(lambda: jenc.init(
        jax.random.PRNGKey(1), jnp.asarray(pts), jnp.asarray(msk),
        train=False))
    v = _randomise(shapes, 6)
    want = np.asarray(jax.jit(lambda a, b: jenc.apply(
        v, a, b, train=False))(pts, msk))
    want_tr, mut = jax.jit(lambda a, b: jenc.apply(
        v, a, b, train=True, mutable=["batch_stats"]))(pts, msk)
    enc = load_flax(MaskBevEncoder(
        GEO["x_range"], GEO["y_range"], GEO["z_range"], GEO["voxel_size"],
        **kw), v)
    assert not enc.uses_slot_path(False)
    with torch.no_grad():
        got = enc(T(pts), T(msk)).numpy()
    assert got.shape == (2, 40, 40, 32)
    top = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * top)
    got_tr = enc(T(pts), T(msk), train=True)
    np.testing.assert_allclose(got_tr.detach().numpy(), np.asarray(want_tr),
                               rtol=0, atol=1e-6 * top)
    for i in range(2):
        jst = mut["batch_stats"]["pillar_feature_net"][f"pfn_{i}"]["norm"]
        norm = getattr(enc.pillar_feature_net, f"pfn_{i}").norm
        _close(norm.running_mean, jst["mean"], 1e-6)
        _close(norm.running_var, jst["var"], 1e-6)


def test_fourier_groups_other_than_one_raise():
    """The JAX encoding reshapes the 3 xyz columns into (groups, 3): only
    one group is defined, and the port refuses the others."""
    with pytest.raises(ValueError, match="groups"):
        MaskBevEncoder(**GEO, encoding_type="fourier", fourier_enc_group=2)
    with pytest.raises(ValueError, match="x, y, z"):
        MaskBevEncoder(**GEO, point_dim=2)


# ---- the absolute position embedding ----------------------------------------

@pytest.mark.parametrize("grid,swap", [(None, True), ((6, 5), True),
                                       ((4, 4), False)])
def test_swin_absolute_embedding_matches_jax(grid, swap):
    """On a non-square token grid (10 x 8): the runtime grid transposed by
    ``swap_dims`` (then resized back), and embeddings of another grid
    resized bicubically, up and down."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 40, 32, 16)).astype(np.float32)
    kw = dict(embed_dim=24, depths=(2, 2), num_heads=(3, 3), window=5)
    js = JaxSwin(**kw, use_abs_pos_embed=True, abs_pos_grid=grid,
                 swap_dims=swap, use_pallas=False)
    shapes = jax.eval_shape(lambda: js.init(jax.random.PRNGKey(1),
                                            jnp.asarray(x), train=False))
    v = _randomise(shapes, 10)
    # an embedding at the runtime grid's scale of variation
    v["params"]["absolute_pos_embed"] = 0.5 * rng.normal(
        size=shapes["params"]["absolute_pos_embed"].shape).astype(np.float32)
    want = [np.asarray(o) for o in jax.jit(
        lambda a: js.apply(v, a, train=False))(x)]
    sw = load_flax(SwinTransformer(16, **kw, use_abs_pos_embed=True,
                                   abs_pos_grid=grid or (10, 8),
                                   swap_dims=swap), v)
    with torch.no_grad():
        got = [o.numpy() for o in sw(T(x))]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


# ---- the pixel decoder's refinement ------------------------------------------

@pytest.mark.parametrize("shapes", [
    # the main path's levels at C = 64: 63 x 63 and 32 x 32 padded and
    # shifted, 16 x 16 padded to 20 and shifted by 5
    ((40, 40, 24), (63, 63, 48), (32, 32, 96), (16, 16, 192)),
    # the tiny config's levels: 10 x 10, 5 x 5 and 3 x 3, each one window
    # or less, so no shift
    ((20, 20, 24), (10, 10, 48), (5, 5, 96), (3, 3, 192))])
def test_pixel_decoder_refinement_matches_jax(shapes):
    """Two refinement blocks a level (the second shifted), 8 heads, 10 x 10
    windows; eval (kernel 7's plain version for the window MSA) and
    training (the plain form on the live parameters)."""
    rng = np.random.default_rng(11)
    feats = [rng.normal(size=(2,) + s).astype(np.float32) for s in shapes]
    jfeats = [jnp.asarray(f) for f in feats]
    jd = JaxPixelDecoder(feat_channels=64, out_channels=64,
                         num_attn_layers=2)
    tree = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0), jfeats,
                                          train=False))
    v = _randomise(tree, 12)
    assert "refine3_1" in v["params"]
    wmf, wmems = jax.jit(lambda f: jd.apply(v, f, train=False))(jfeats)
    pd = load_flax(PixelDecoder([24, 48, 96, 192], 64, 64,
                                num_attn_layers=2), v)
    for train in (False, True):
        with torch.set_grad_enabled(train):
            gmf, gmems = pd([T(f) for f in feats], train=train)
        for g, w in zip([gmf] + gmems, [wmf] + list(wmems)):
            g, w = g.detach().numpy(), np.asarray(w)
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
