"""The refusal audit's entries 1 and 3 (the PFN's layers, the window
attention's head widths and windows), on the CPU.

* The rules take what the JAX package serves there and still refuse, with
  their reason, what is left: the PFN layers of 1 to 256 units, up to 8
  layers, each fed [z, pooled] (not 257 units, 9 layers, or an input that
  is not the one before's [z, pooled]); the attention head widths of a
  multiple of 8 up to 128 and windows up to 24 (not 4, 12 or 136, not
  window 25). The C sources' limits are the host's.
* Shared memory: every new attention instance fits the blocks an SM it is
  built for (the head-width kernel at widths 72-128 up to window 11, the
  streaming kernel at windows 12-24), with the 1 KB the card reserves a
  block; the PFN's wide layers fit where the rule says they do.
* The PFN's padding: units padded to a multiple of 8 (zero weight columns
  and affine, zero rows for the padded z and pooled columns) give the true
  layers' table (float64: 1e-12 absolute; the padded columns exact zeros).
* ``chip_smoke.py``'s ``[shapes audit]`` rows (``.u100``, ``.hd96``,
  ``.w24``) pass every rule at full width, and with a tensor whose
  ``is_cuda`` reads True the attention launches its wide or streaming
  instance.
* The plain route against the JAX package on the same weights
  (``load_flax``) and inputs drawn with numpy, f32: the capped-stream
  encoder (kernel 10's plain version) at feat channels (16, 12), (24, 136)
  and 5 layers against the JAX XLA encoder, 1e-5 absolute on the
  normalised canvas (``test_torch_port_encoder.py``'s tolerance); a Swin
  block at head widths 72, 96 and 128, and at windows 17 and 24, as kernel
  3's chain and as the XLA form with kernel 7's attention, against the JAX
  block, and the backbone at windows 17 and 24 against the JAX backbone,
  1e-4 of the reference's largest magnitude (``test_torch_port_swin.py``'s
  tolerance).
"""
import importlib.util
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.models.encoder import (  # noqa: E402
    MaskBevEncoder as JaxEncoder)
from mask_bev_tpu.models.swin import (  # noqa: E402
    SwinBlock as JaxBlock, SwinTransformer as JaxSwin)
from mask_bev_tpu_torch.config import semantic_kitti_default  # noqa: E402
from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402
from mask_bev_tpu_torch.models.convert import load_flax  # noqa: E402
from mask_bev_tpu_torch.models.encoder import MaskBevEncoder  # noqa: E402
from mask_bev_tpu_torch.models.swin import (  # noqa: E402
    SwinBlock, SwinTransformer)
from mask_bev_tpu_torch.ops import pfn as kpfn  # noqa: E402
from mask_bev_tpu_torch.ops import swin_block as kswin  # noqa: E402
from mask_bev_tpu_torch.ops import window_msa as kwmsa  # noqa: E402
from mask_bev_tpu_torch.ops.stream_pillars import (  # noqa: E402
    pillarize_stream_packed)
from test_torch_port_shapes import on_card, refusals  # noqa: E402
from test_torch_port_shapes_wide import _variables, long_pillars  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
CSRC = pathlib.Path(kb.CSRC)
SMEM_SM = 228 * 1024      # an H100 SM's shared memory
SMEM_RESERVED = 1024      # reserved by the card for each block


def _define(source: str, name: str) -> int:
    m = re.search(rf"#define {name} (\d+)", (CSRC / source).read_text())
    return int(m.group(1))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


# ---- entry 1: the PFN's layers ---------------------------------------------


def test_pfn_limits_are_the_sources():
    assert kpfn.MAX_UNITS == _define("pfn.cu", "PFN_MAXU") == 256
    assert kpfn.MAX_LAYERS == _define("pfn.cu", "PFN_MAXL") == 8


def _dims(units, in0=10):
    out, d = [], in0
    for u in units:
        out.append((d, u))
        d = 2 * u
    return out


@pytest.mark.parametrize("units", [(1,), (8, 12), (12, 136), (256,),
                                   (64, 64, 100), (32,) * 8, (7, 5, 3, 1, 9)],
                         ids=lambda u: "-".join(map(str, u)))
def test_pfn_takes_the_audit_layers(units):
    for dt in (BF16, F32):
        assert kpfn.layers_refusal(_dims(units), 10, dt, dt) is None
    kd = kpfn.kernel_dims(_dims(units))
    assert [u for _, u in kd] == [-(-u // 8) * 8 for u in units]
    assert kpfn.is_wide(kd) == any(u > 128 for u in units)


@pytest.mark.parametrize("dims,why", [
    (_dims((257,)), "1 to 256 units"), (_dims((32,) * 9), "1 to 8 layers"),
    ([(10, 16), (30, 8)], "1 to 256 units"), ([(9, 16)], "1 to 256 units")],
    ids=["257-units", "9-layers", "not-z-pooled", "not-the-decoration"])
def test_pfn_still_refuses(dims, why):
    assert why in kpfn.layers_refusal(dims, 10, BF16, BF16)
    assert kpfn.pfn_refusal(32, dims, 10, BF16, BF16)


def test_pfn_wide_layers_fit_or_are_refused():
    """One layer of 256 units and 8 layers of 32 fit a block; two layers
    of 256 do not (their weights alone are 270 KB in bf16), and the rule
    says so with the shared memory it counted."""
    for units in ((256,), (32,) * 8, (12, 136), (64, 64, 100)):
        for dt in (BF16, F32):
            for k in (32, 128):
                assert kpfn.tiles_refusal(k, _dims(units), dt) is None
                assert kpfn.smem_bytes(_dims(units), dt == F32, k) <= \
                    kpfn.SMEM_LIMIT
    assert "shared memory" in kpfn.tiles_refusal(32, _dims((256, 256)),
                                                 BF16)
    # the flagship layers' block is as it was
    assert kpfn.smem_bytes(_dims((64, 64, 128)), False, 32) == 83328


@pytest.mark.parametrize("units", [(8, 12), (12, 136), (5, 7, 3)],
                         ids=lambda u: "-".join(map(str, u)))
def test_padded_layers_are_the_layers(units):
    """The kernel's padded layers give the true layers' table: the padded
    z and pooled columns are zeros, so every row, pooled value and table
    column the true layers give is unchanged."""
    rng = np.random.default_rng(sum(units))
    weights, d = [], 10
    for u in units:
        weights.append((torch.as_tensor(rng.normal(size=(d, u)) / d ** 0.5,
                                        dtype=F32),
                        torch.as_tensor(1 + 0.1 * rng.normal(size=u),
                                        dtype=F32),
                        torch.as_tensor(0.1 * rng.normal(size=u), dtype=F32)))
        d = 2 * u
    padded = kpfn.padded_layers(weights)
    assert [tuple(w.shape) for w, _, _ in padded] == kpfn.kernel_dims(
        [tuple(w.shape) for w, _, _ in weights])
    pts, msk = long_pillars(7)
    ps = pillarize_stream_packed(torch.as_tensor(pts), torch.as_tensor(msk),
                                 max_points_per_pillar=32, x_range=(-10, 10),
                                 y_range=(-10, 10), z_range=(-4, 4),
                                 voxel_size=0.5)
    kw = dict(point_dim=4, with_distance=True, grid_w=40, voxel_size=0.5,
              x0=-10.0, y0=-10.0, out_dtype=torch.float64)
    want, wstats = kpfn.pfn_plain(ps, weights, **kw)
    got, gstats = kpfn.pfn_plain(ps, padded, **kw)
    c = units[-1]
    assert bool((got[..., c:] == 0).all())
    np.testing.assert_allclose(got[..., :c].numpy(), want.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(gstats.numpy(), wstats.numpy(), rtol=1e-12)
    wbuf, gb, dims = kpfn.pack_weights(weights, "cpu")
    assert dims == [len(units)] + [v for kd in kpfn.kernel_dims(
        [tuple(w.shape) for w, _, _ in weights]) for v in kd]


GEO = dict(x_range=(-10.0, 10.0), y_range=(-10.0, 10.0),
           z_range=(-4.0, 4.0), voxel_size=0.5)
H = W = 40


@pytest.mark.parametrize("fc", [(16, 12), (24, 136), (16, 16, 32, 32, 20)],
                         ids=["16-12", "24-136", "5-layers"])
def test_capped_encoder_matches_xla(fc):
    """Kernel 10's plain version (the port's capped eval encoder, as it
    runs on the card: units 8 and 12; 12 and 136; 8, 8, 16, 16 and 20)
    against the JAX XLA encoder on the same variables."""
    pts, msk = long_pillars(len(fc) + fc[-1])
    enc = JaxEncoder(feat_channels=fc, max_points_per_pillar=32,
                     max_pillars=H * W, pseudo_image_norm="full", **GEO)
    v = _variables(lambda: enc.init(jax.random.PRNGKey(1), jnp.asarray(pts),
                                    jnp.asarray(msk), train=False), fc[-1])
    port = load_flax(MaskBevEncoder(
        GEO["x_range"], GEO["y_range"], GEO["z_range"], GEO["voxel_size"],
        feat_channels=fc, max_points_per_pillar=32,
        pseudo_image_norm="full", max_pillars=H * W), v)
    assert not port.uses_slot_path(False)
    want = np.asarray(jax.jit(lambda v_, p_, m_: enc.apply(
        v_, p_, m_, train=False))(v, jnp.asarray(pts), jnp.asarray(msk)))
    with torch.no_grad():
        got = port(torch.as_tensor(pts), torch.as_tensor(msk)).numpy()
    assert got.shape == want.shape == (2, H, W, fc[-1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---- entry 3: the window attention's head widths and windows ---------------


def test_attention_limits_are_the_sources():
    assert kswin.ATTN_WIDE_F32_BLOCKS == _define(
        "window_attn.cuh", "ATT_WIDTH_BLOCKS_WIDE_F32")
    text = (CSRC / "window_attn.cuh").read_text()
    assert "ATT_WIDTH_BLOCKS_WIDE_BF16" not in text  # bf16: the ring kernel
    assert f"ATT_STREAM_TOKENS = {kswin.ATTN_MAX_TOKENS};" in text
    assert f"ATT_STREAM_WARPS = {kswin.ATTN_STREAM_WARPS};" in text
    assert f"ATT_STREAM_STAGES = {kswin.ATTN_STREAM_STAGES};" in text
    assert f"ATT_STREAM_SLOTS = {kswin.ATTN_STREAM_SLOTS};" in text
    assert (f"ATT_STREAM_WGMMA = {str(kswin.ATTN_STREAM_WGMMA).lower()};"
            in text)
    assert f"ATT_KCH = {kswin.ATTN_KEY_CHUNK // 16};" in text
    for name in ("swin", "msa"):
        assert "launch_window_attn_streamed<" in (
            CSRC / f"attn_stream_{name}.cu").read_text()
    for src in ("attn_wide_swin.cu", "attn_wide_msa.cu"):
        widths = re.search(r"launch_window_attn<\w+, ([\d, ]+)>",
                           (CSRC / src).read_text()).group(1)
        assert tuple(int(w) for w in widths.split(",")) == \
            kswin.ATTN_WIDE_DIMS


@pytest.mark.parametrize("hd", kswin.ATTN_WIDE_DIMS)
def test_attention_takes_head_widths_to_128(hd):
    for win in (1, 7, 10, 11, 12, 16, 17, 24):
        assert kswin.attn_refusal("x", 2 * hd, 2, win) is None
        for dt in (BF16, F32):
            assert kwmsa.window_msa_refusal(2 * hd, 2, win, dt) is None
            assert kswin.swin_block_refusal(2 * hd, 2, win, 8 * hd,
                                            dt) is None
    assert kswin.attn_instance(False, 10, hd) == f"attn_bf16_hd{hd}"
    assert kswin.attn_instance(True, 12, hd) == f"attn_f32_stream_hd{hd}"


@pytest.mark.parametrize("win", range(1, 25))
def test_attention_instances_fit_their_blocks(win):
    """Every new instance's shared memory (``attn_smem_bytes``, as the C
    source sizes it) fits the blocks an SM it is built for: at widths
    72-128 up to window 11 the ring kernel in bf16 (q in registers; two
    blocks at window 10 in both variants, one at least at every window: its
    launch sizes the grid by the occupancy the card reports) and the
    head-width kernel in f32 (one block), the streaming kernel (two bf16
    blocks up to a staged width of 64, else one) at windows over 16 and at
    widths over 64 above window 11."""
    for hd in kswin.ATTN_HEAD_DIMS + kswin.ATTN_WIDE_DIMS:
        route = kswin.attn_route(win, hd)
        if hd <= 64 and route != "stream":
            continue  # the instances of the earlier slices
        for f32 in (False, True):
            for msa in (False, True):
                smem = kswin.attn_smem_bytes(win, hd, f32, msa)
                if route == "stream":
                    blocks = (2 if not f32 and kswin.attn_stream_dim(hd)
                              <= 64 else 1)
                else:
                    assert route == "one_pass"
                    blocks = kswin.attn_blocks(f32, win, hd)
                    if kswin.attn_ring(f32, hd):
                        n_pad = -(-win * win // 16) * 16
                        if n_pad == 112:  # window 10: two blocks fit
                            assert blocks == kswin.ATTN_RING_BLOCKS
                        else:  # one at least (the grid follows occupancy)
                            blocks = 1
                assert blocks * (smem + SMEM_RESERVED) <= SMEM_SM


@pytest.mark.parametrize("c,heads,win,refused", [
    (12, 3, 10, False), (408, 3, 10, False), (96, 3, 25, False),
    (60, 5, 10, False), (792, 3, 10, True), (96, 3, 33, True)],
    ids=["hd4", "hd136", "win25", "hd12", "hd264", "win33"])
def test_attention_still_refuses_the_rest(c, heads, win, refused):
    """Head widths 4, 136 and 12 and a window of 25 (the refusals of the
    first audit) are taken; a head width of 264 and a window of 33 are
    still refused, with the rule's reason."""
    reason = kswin.attn_refusal("x", c, heads, win)
    if not refused:
        assert reason is None
        assert kwmsa.window_msa_refusal(c, heads, win, BF16) is None
        return
    assert "from 1 to 256" in reason and "1024 tokens" in reason
    assert kwmsa.window_msa_refusal(c, heads, win, BF16)


@pytest.fixture
def launches(monkeypatch):
    """Record each launch (C function, instance) instead of making it."""
    made = []

    def launch(name, fn, *args, instance=None):
        made.append((fn, instance))
    monkeypatch.setattr(kb, "launch", launch)
    monkeypatch.setattr(kb, "stream", lambda: kb.ptr(None))
    return made


@pytest.mark.parametrize("hd,win", [(96, 10), (128, 7), (72, 12), (32, 24),
                                    (8, 17), (128, 24)])
@pytest.mark.parametrize("msa", [False, True], ids=["swin", "msa"])
def test_attention_route_on_the_card(launches, hd, win, msa):
    heads, hw = 2, (win + 3, win + 5)
    c = heads * hd
    qkv = on_card(torch.ones(hw[0] * hw[1], 3 * c, dtype=BF16))
    kswin.attention("x", qkv, on_card(torch.zeros(3 * c)),
                    on_card(torch.zeros(heads, win * win, win * win)), 1, hw,
                    heads, win, 0, msa)
    (fn, inst), = launches
    base = "window_msa_attn" if msa else "swin_window_attn"
    stream = win > 16 or (hd > 64 and win > 11)
    suffix = ("_stream" if stream else "_wide" if hd > 64 else
              "" if hd in kswin.ATTN_FLAGSHIP_DIMS else "_widths")
    assert fn == base + suffix
    assert inst == kswin.attn_instance(False, win, hd)
    assert ("_stream" in inst) == stream


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CSRC.parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("row,fuse_ln", [("U100", True), ("HD96", False),
                                         ("W24", False)],
                         ids=["u100", "hd96", "w24"])
def test_audit_rows_take_every_kernel(row, fuse_ln):
    """Every kernel each ``[shapes audit]`` row selects takes its shapes at
    full width (the models on the meta device), in bf16 and f32: ``.u100``
    on path E (the capped encoder: kernel 10 at 64, 64 and 100 units),
    ``.hd96`` and ``.w24`` on the main path."""
    over = getattr(_smoke(), row)
    assert over == {"U100": dict(encoder_feat_channels=(128, 128, 100)),
                    "HD96": dict(backbone_num_heads=(2, 4, 8, 16)),
                    "W24": dict(backbone_window_size=24)}[row]
    cfg = semantic_kitti_default().replace(**over)
    if fuse_ln:
        cfg = cfg.replace(use_pallas_encoder=False)
    for dt in (BF16, F32):
        got = refusals(cfg, 8, dt, fuse_ln=fuse_ln)
        want = {"stream_pfn" if row == "U100" else "pfn", "canvas_norm",
                "swin_block", "decoder_stack"}
        assert want <= set(got)
        assert all(r is None for r in got.values()), got


# ---- the plain route against the JAX package -------------------------------


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("c,heads,win,hw", [
    (96, 1, 7, (9, 11)), (144, 2, 7, (9, 11)), (128, 1, 7, (9, 11)),
    (32, 2, 17, (19, 21)), (32, 2, 24, (26, 25))],
    ids=["hd96", "hd72", "hd128", "win17", "win24"])
def test_block_matches_xla(c, heads, win, hw, shift):
    """Kernel 3's chain (``fused``) and the XLA form with kernel 7's
    attention (``fused_attention``), both plain, against the JAX block's
    XLA path, on a grid that pads on both axes."""
    rng = np.random.default_rng(c + win)
    x = rng.normal(size=(2, hw[0] * hw[1], c)).astype(np.float32)
    jb = JaxBlock(c, heads, win, shift=shift, use_pallas=False)
    v = _variables(lambda: jb.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   hw, train=False), c + win)
    want = np.asarray(jax.jit(lambda v_, x_: jb.apply(
        v_, x_, hw, train=False))(v, jnp.asarray(x)))
    blk = load_flax(SwinBlock(c, heads, win, shift=shift), v)
    with torch.no_grad():
        chain = blk(torch.as_tensor(x), hw).numpy()
        msa = blk(torch.as_tensor(x), hw, fused=False,
                  fused_attention=True).numpy()
    assert _rel(chain, want) <= 1e-4
    assert _rel(msa, want) <= 1e-4


@pytest.mark.parametrize("win,side", [(17, 84), (24, 100)])
def test_backbone_long_windows_match_jax(win, side):
    """The port's backbone (kernel 3's chain, plain) at windows 17 and 24
    against the JAX backbone: stage 0's grid (21^2, 25^2) pads to 2 x 2
    windows and shifts, stage 1's fits one window."""
    b, c = 2, 16
    rng = np.random.default_rng(win)
    x = rng.normal(size=(b, side, side, c)).astype(np.float32)
    kw = dict(embed_dim=32, depths=(2, 2), num_heads=(2, 4), window=win,
              patch_size=4, use_pallas=False)
    ref = JaxSwin(**kw)
    v = _variables(lambda: ref.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                    train=False), win + 1)
    want = jax.jit(lambda v_, x_: ref.apply(v_, x_, train=False))(
        v, jnp.asarray(x))
    sw = load_flax(SwinTransformer(c, embed_dim=32, depths=(2, 2),
                                   num_heads=(2, 4), window=win), v)
    with torch.no_grad():
        got = sw(torch.as_tensor(x))
    assert [tuple(g.shape) for g in got] == [tuple(o.shape) for o in want]
    for g, o in zip(got, want):
        assert _rel(g.numpy(), o) <= 1e-4
