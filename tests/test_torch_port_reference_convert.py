"""The reference-checkpoint converters and the bicubic resize, port
against the JAX package.

``from_reference_maskbev`` and ``from_reference_swin`` go straight from an
upstream torch checkpoint (here a synthetic one with the upstream key
names and shapes, values from a numpy seed) to the port's state_dict; the
JAX package's ``convert_torch_maskbev`` / ``convert_torch_swin`` followed
by ``from_flax`` must give the same state_dict, bit for bit on every key,
in both key flavours (mmdet's ``stages.*`` with the patch-merging
permutation, the original release's ``layers.*``). Where the checkpoint's
window or embedding grid differs from the model's, the resized tables and
embedding are held to 1e-6 of their largest magnitude (the two packages'
bicubic weights and sums differ in the last f32 bits), every other key
still bit for bit.

``ops/resize.py::resize_bicubic`` against ``jax.image.resize(...,
"bicubic")``: within 1e-6 of the largest magnitude, upscaling and
downscaling (a window-7 bias table, 13 x 13, to window 10, 19 x 19, and
back; an embedding of a 20 x 20 grid at 13 x 17 and at 32 x 24).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from mask_bev_tpu.models.convert import (  # noqa: E402
    convert_torch_maskbev, convert_torch_swin)
from mask_bev_tpu.models.maskbev import MaskBev as JaxMaskBev  # noqa: E402
from mask_bev_tpu.models.swin import SwinTransformer as JaxSwin  # noqa: E402
from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.models.convert import (  # noqa: E402
    from_flax, from_reference_maskbev, from_reference_swin, load_flax)
from mask_bev_tpu_torch.models.maskbev import MaskBev  # noqa: E402
from mask_bev_tpu_torch.models.swin import SwinTransformer  # noqa: E402
from mask_bev_tpu_torch.ops.resize import resize_bicubic  # noqa: E402

OPTIONS = dict(predict_height=True, backbone_use_abs_emb=True,
               backbone_swap_dims=True, pixel_decoder_num_attn_layers=2)
HP = "_panoptic_head._panoptic_head."
BB = "_backbone._backbone."


def _random_tree(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), tree)


def _swin_sd(rng, swin, flavour, window=None, grid=None):
    """Upstream Swin keys for the port's ``swin`` module: mmdet
    (``stages.*``, ``w_msa``, ``ffn.layers``, ``projection``, ``norm{i}``)
    or the original release (``layers.*``, ``mlp``, ``proj``)."""
    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    sd = {}
    e = swin.embed_dim
    pe = tuple(swin.patch_embed.weight.shape)
    mm = flavour == "mmdet"
    stage = "stages" if mm else "layers"
    sd["patch_embed.projection.weight" if mm
       else "patch_embed.proj.weight"] = r(*pe)
    sd["patch_embed.projection.bias" if mm else "patch_embed.proj.bias"] = r(e)
    sd["patch_embed.norm.weight"] = 1 + 0.1 * r(e)
    sd["patch_embed.norm.bias"] = r(e)
    if swin.absolute_pos_embed is not None:
        gh, gw = grid or swin.absolute_pos_embed.shape[:2]
        sd["absolute_pos_embed"] = r(1, gh * gw, e)
    dim = e
    for i, depth in enumerate(swin.depths):
        for d in range(depth):
            blk = getattr(swin, f"stage{i}_block{d}")
            win = window or blk.window
            p = f"{stage}.{i}.blocks.{d}."
            attn = p + ("attn.w_msa." if mm else "attn.")
            for nm in ("norm1", "norm2"):
                sd[p + f"{nm}.weight"] = 1 + 0.1 * r(dim)
                sd[p + f"{nm}.bias"] = r(dim)
            sd[attn + "relative_position_bias_table"] = r(
                (2 * win - 1) ** 2, blk.num_heads)
            sd[attn + "qkv.weight"] = r(3 * dim, dim)
            sd[attn + "qkv.bias"] = r(3 * dim)
            sd[attn + "proj.weight"] = r(dim, dim)
            sd[attn + "proj.bias"] = r(dim)
            fc1, fc2 = (("ffn.layers.0.0", "ffn.layers.1") if mm
                        else ("mlp.fc1", "mlp.fc2"))
            sd[p + fc1 + ".weight"] = r(4 * dim, dim)
            sd[p + fc1 + ".bias"] = r(4 * dim)
            sd[p + fc2 + ".weight"] = r(dim, 4 * dim)
            sd[p + fc2 + ".bias"] = r(dim)
        if mm:
            sd[f"norm{i}.weight"] = 1 + 0.1 * r(dim)
            sd[f"norm{i}.bias"] = r(dim)
        if i < len(swin.depths) - 1:
            p = f"{stage}.{i}.downsample."
            sd[p + "norm.weight"] = 1 + 0.1 * r(4 * dim)
            sd[p + "norm.bias"] = r(4 * dim)
            sd[p + "reduction.weight"] = r(2 * dim, 4 * dim)
            dim *= 2
    sd["norm.weight"] = r(dim)  # the original release's final norm: unused
    return sd


def _maskbev_sd(model, cfg, flavour, seed=0, window=None, grid=None):
    """A whole upstream ``MaskBevModule`` checkpoint for the port's
    ``model``: PFN layers and batch norms, the (C, H, W) pseudo-image norm,
    the Swin backbone, the decoder (packed ``in_proj``, ``norms.{0,1,2}``,
    ``ffn.layers``), the heads with ``height_embed``, and a pixel-decoder
    key neither converter maps."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    sd = {}
    net = model.encoder.pillar_feature_net
    for i in range(net.num_layers):
        out, inp = getattr(net, f"pfn_{i}").linear.weight.shape
        p = f"_encoder._voxel_encoder.pfn_layers.{i}."
        sd[p + "linear.weight"] = r(out, inp)
        sd[p + "norm.weight"] = 1 + 0.1 * r(out)
        sd[p + "norm.bias"] = r(out)
        sd[p + "norm.running_mean"] = r(out)
        sd[p + "norm.running_var"] = 0.5 + rng.uniform(size=out).astype(
            np.float32)
    h, w, c = model.encoder.norm.weight.shape
    sd["_encoder._layer_norm.weight"] = r(c, h, w)
    sd["_encoder._layer_norm.bias"] = r(c, h, w)
    sd.update({BB + k: v for k, v in _swin_sd(
        rng, model.backbone, flavour, window, grid).items()})
    c = cfg.head_feat_channels
    q, k, f = cfg.num_queries, cfg.head_num_classes, cfg.head_ffn_dim
    sd[HP + "query_feat.weight"] = r(q, c)
    sd[HP + "query_embed.weight"] = r(q, c)
    sd[HP + "level_embed.weight"] = r(3, c)
    sd[HP + "transformer_decoder.post_norm.weight"] = 1 + 0.1 * r(c)
    sd[HP + "transformer_decoder.post_norm.bias"] = r(c)
    sd[HP + "cls_embed.weight"] = r(k + 1, c)
    sd[HP + "cls_embed.bias"] = r(k + 1)
    sd[HP + "height_embed.weight"] = r(cfg.head_num_height_bins, c)
    sd[HP + "height_embed.bias"] = r(cfg.head_num_height_bins)
    for j in (0, 2, 4):
        sd[HP + f"mask_embed.{j}.weight"] = r(c, c)
        sd[HP + f"mask_embed.{j}.bias"] = r(c)
    for i in range(cfg.head_num_decoder_layers):
        p = HP + f"transformer_decoder.layers.{i}."
        for kind in ("cross_attn", "self_attn"):
            sd[p + f"{kind}.attn.in_proj_weight"] = r(3 * c, c)
            sd[p + f"{kind}.attn.in_proj_bias"] = r(3 * c)
            sd[p + f"{kind}.attn.out_proj.weight"] = r(c, c)
            sd[p + f"{kind}.attn.out_proj.bias"] = r(c)
        for j in range(3):
            sd[p + f"norms.{j}.weight"] = 1 + 0.1 * r(c)
            sd[p + f"norms.{j}.bias"] = r(c)
        sd[p + "ffn.layers.0.0.weight"] = r(f, c)
        sd[p + "ffn.layers.0.0.bias"] = r(f)
        sd[p + "ffn.layers.1.weight"] = r(c, f)
        sd[p + "ffn.layers.1.bias"] = r(c)
    sd[HP + "pixel_decoder.input_convs.0.conv.weight"] = r(c, 4, 1, 1)
    return sd


@pytest.fixture(scope="module")
def jax_variables():
    cfg = jax_tiny().replace(**OPTIONS)
    pts = np.zeros((1, cfg.max_points_per_scan, 4), np.float32)
    mask = np.zeros((1, cfg.max_points_per_scan), bool)
    shapes = jax.eval_shape(lambda: JaxMaskBev(cfg).init(
        jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask),
        train=False))
    return _random_tree(shapes, 1)


def _compare(got, want, resized=()):
    assert set(got) == set(want)
    for k in sorted(want):
        g, w = got[k], want[k]
        assert g.dtype == w.dtype == torch.float32, k
        assert tuple(g.shape) == tuple(w.shape), k
        if any(s in k for s in resized):
            top = float(w.abs().max())
            assert float((g - w).abs().max()) <= 1e-6 * top, k
        else:
            assert torch.equal(g, w), k


@pytest.mark.parametrize("flavour", ["mmdet", "original"])
def test_maskbev_converter_matches_jax(jax_variables, flavour):
    """Every key, height head and absolute embedding included; the pixel
    decoder keeps the model's own weights on both sides."""
    cfg = tiny_test_config().replace(**OPTIONS)
    model = load_flax(MaskBev(cfg), jax_variables)
    sd = _maskbev_sd(model, cfg, flavour)
    got = from_reference_maskbev(sd, model)
    want = from_flax(convert_torch_maskbev(sd, jax_variables))
    _compare(got, want)
    for k in ("decoder.heads.height_embed.weight",
              "backbone.absolute_pos_embed", "decoder.layer2.self_attn.v.bias",
              "backbone.merge0.reduction.weight"):
        assert not torch.equal(got[k], model.state_dict()[k]), k
    assert torch.equal(got["pixel_decoder.refine1_0.norm1.weight"],
                       model.state_dict()["pixel_decoder.refine1_0.norm1."
                                          "weight"])
    model.load_state_dict(got)  # every key of the model, in its shapes


def test_maskbev_converter_resizes_as_jax(jax_variables):
    """A window-3 checkpoint (5 x 5 tables) into the model's window 5, and
    an embedding of a 16 x 16 grid into the model's 20 x 20."""
    cfg = tiny_test_config().replace(**OPTIONS)
    model = load_flax(MaskBev(cfg), jax_variables)
    sd = _maskbev_sd(model, cfg, "mmdet", seed=2, window=3, grid=(16, 16))
    got = from_reference_maskbev(sd, model)
    want = from_flax(convert_torch_maskbev(sd, jax_variables))
    _compare(got, want, resized=("rel_pos_bias_table", "absolute_pos_embed"))


@pytest.mark.parametrize("window", [None, 3])
def test_swin_converter_matches_jax(window):
    """``from_reference_swin`` on a standalone Swin (two stages, one block
    each, an absolute embedding) against ``convert_torch_swin``."""
    kw = dict(embed_dim=16, depths=(1, 1), num_heads=(2, 2), window=5)
    x = jnp.zeros((1, 24, 24, 4), jnp.float32)
    js = JaxSwin(**kw, use_abs_pos_embed=True, out_indices=(0, 1))
    params = _random_tree(jax.eval_shape(
        lambda: js.init(jax.random.PRNGKey(0), x, train=False)), 3)["params"]
    swin = load_flax(SwinTransformer(4, **kw, use_abs_pos_embed=True,
                                     abs_pos_grid=(6, 6)),
                     {"params": params})
    sd = _swin_sd(np.random.default_rng(4), swin, "mmdet", window=window)
    got = from_reference_swin(sd, swin)
    want = from_flax({"params": convert_torch_swin(
        sd, {"backbone": params})["backbone"]})
    _compare(got, want, resized=("rel_pos_bias_table",) if window else ())


@pytest.mark.parametrize("src,dst", [
    ((13, 13, 6), (19, 19, 6)),    # window 7 -> 10 bias table
    ((19, 19, 6), (13, 13, 6)),    # and back
    ((20, 20, 48), (13, 17, 48)),  # an embedding, down
    ((20, 20, 48), (32, 24, 48)),  # and up
])
def test_resize_matches_jax_bicubic(src, dst):
    x = np.random.default_rng(5).normal(size=src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, "bicubic"))
    got = resize_bicubic(torch.as_tensor(x), dst).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
