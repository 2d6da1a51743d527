"""The last shape gaps on the card, on the CPU: the widened rules, the
route a CUDA call takes, and the plain route against the JAX package.

* The rules take the new shapes and still refuse what their kernels do
  not take: kernel 9 any C >= 1 (12 and 4096 among them), the Swin LN any
  C % 8 == 0 (3072: the walk, its limit the C source's own constant), the
  GEMM any K and N >= 1 (operands at ``row_pitch``), the window attention
  head widths 8 to 64 in steps of 8 (not 4, 12 or 72; windows up to 16),
  kernels 2, A and B any row width (words of ``word_bytes``).
* On the card the route is the kernel: with a tensor whose ``is_cuda``
  reads True (``OnCard``) and the launch recorded instead of made, each
  wrapper launches its new instance at every new shape.
* The full-width configurations of ``chip_smoke.py``'s ``[shapes tail]``
  rows (``.e384``, ``.hd8``, ``.hd40``, ``.c100``) pass every rule.
* The plain route against the JAX package at tiny size, f32 without int8,
  with ``test_torch_port_model.py``'s f32 tolerance (1e-3 on the final
  logits): ``tiny_test_config()`` at embed 24 over (3, 3, 6, 6) heads
  (head widths 8 and 16, the qkv product at K = 24) and with a 12-channel
  canvas under the Fourier encoding. Kernel 9's plain version at C = 12
  and 2056 against flax ``nn.LayerNorm`` (1e-5, as
  ``test_torch_port_layer_norm.py`` holds it).
"""
import importlib.util
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from mask_bev_tpu.models.maskbev import MaskBev as JaxMaskBev  # noqa: E402
from mask_bev_tpu_torch.config import (  # noqa: E402
    semantic_kitti_default, tiny_test_config)
from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402
from mask_bev_tpu_torch.models.convert import load_flax  # noqa: E402
from mask_bev_tpu_torch.models.maskbev import MaskBev  # noqa: E402
from mask_bev_tpu_torch.ops import canvas as kcanvas  # noqa: E402
from mask_bev_tpu_torch.ops import layer_norm as kln  # noqa: E402
from mask_bev_tpu_torch.ops import swin_block as kswin  # noqa: E402
from mask_bev_tpu_torch.ops import window_msa as kwmsa  # noqa: E402
from test_torch_port_model import _scans, _variables  # noqa: E402
from test_torch_port_shapes import on_card, refusals  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
CSRC = pathlib.Path(kb.CSRC)


def _define(source: str, name: str) -> int:
    m = re.search(rf"#define {name} (\d+)", (CSRC / source).read_text())
    return int(m.group(1))


# ---- the rules -----------------------------------------------------------


@pytest.mark.parametrize("c", [1, 7, 12, 100, 2056, 3072, 4096])
def test_layer_norm_takes_any_width(c):
    for dt in (BF16, F32):
        assert kln.layer_norm_refusal(c, dt) is None
        g, w, r = kln.plan(c, dt == F32)
        if c % 8 == 0 and c > 2048:
            # the wide instance: four warps a token, the fewest words a
            # lane
            assert (g, r) == (128, 1)
            assert g * (w - 1) < c // 8 <= g * w <= 16 * 32
            continue
        # the walk: a power of two up to 32 lanes, none of them idle
        assert (w, r) == (0, 1) and g in (1, 2, 4, 8, 16, 32)
        assert g == 32 or g >= -(-c // 8) > g // 2
    assert "C >= 1" in kln.layer_norm_refusal(0, BF16)
    assert "bf16 or f32" in kln.layer_norm_refusal(12, torch.float16)
    # the register tiles' plans are as they were
    assert kln.plan(192, False) == (8, 3, 4)
    assert kln.plan(2048, True) == (32, 8, 1)
    assert kln.MAX_WORDS == _define("layer_norm.cu", "LN_MAX_WORDS")
    assert kln.WIDE_C == _define("layer_norm.cu", "LN_WIDE_C")
    assert kln.plan(4104, False) == (32, 0, 1)  # over the wide rows: walk


def test_swin_ln_limit_is_the_kernels():
    """The Swin LN's register tile and its walk split at the C source's own
    constant, and a block of C 3072 (the .e384 stage 3) is taken."""
    assert kswin.SWIN_LN_MAX_WORDS == _define("swin_block.cu",
                                              "SWIN_LN_MAX_WORDS")
    assert kswin.SWIN_LN_TILE_C == 8 * 32 * kswin.SWIN_LN_MAX_WORDS == 2048
    assert kswin.swin_block_refusal(3072, 48, 10, 12288, BF16) is None
    assert kswin.swin_block_refusal(3072, 48, 10, 12288, F32) is None
    assert kswin.ln_instance(2048, False, True) == "bf16"
    assert kswin.SWIN_LN_WIDE_C == _define("swin_block.cu", "SWIN_LN_WIDE_C")
    assert kswin.ln_instance(2056, False, False) == "bf16_wide"
    assert kswin.ln_instance(4096, True, True) == "f32_wide"
    assert kswin.ln_instance(4104, False, False) == "bf16_walk"
    assert kswin.ln_instance(72, True, True) == "f32_walk"  # int8 pitch 80
    assert kswin.ln_instance(72, True, False) == "f32"


@pytest.mark.parametrize("hd", [8, 24, 40, 48, 56])
def test_attention_takes_head_widths_8_to_64(hd):
    for win in (7, 10, 12, 16):
        assert kswin.attn_refusal("x", 3 * hd, 3, win) is None
        for dt in (BF16, F32):
            assert kwmsa.window_msa_refusal(3 * hd, 3, win, dt) is None
            assert kswin.swin_block_refusal(3 * hd, 3, win, 12 * hd,
                                            dt) is None
    hs = kswin.attn_staged_dim(hd)
    assert hs in kswin.ATTN_FLAGSHIP_DIMS and hs >= hd > hs // 2 - 8
    for f32 in (False, True):
        for msa in (False, True):
            # one pass: the head-width kernel's rows at the exact width and
            # the compact table, less than the staged layout took; long
            # windows: staged at the flagship width
            assert kswin.attn_smem_bytes(10, hd, f32, msa) < \
                kswin.attn_smem_bytes(10, hs, f32, msa)
            assert kswin.attn_smem_bytes(12, hd, f32, msa) == \
                kswin.attn_smem_bytes(12, hs, f32, msa)
            assert hd <= kswin.attn_width_ld(hd, f32) < hs + 8
    assert kswin.attn_instance(False, 10, hd) == f"attn_bf16_hd{hd}"
    assert kswin.attn_instance(True, 12, hd) == f"attn_f32_long_hd{hd}"


@pytest.mark.parametrize("c,heads,win,refused", [
    pytest.param(12, 3, 10, False, id="12-3-10"),
    pytest.param(96, 24, 10, False, id="96-24-10"),
    pytest.param(408, 3, 10, False, id="408-3-10"),
    pytest.param(96, 3, 25, False, id="96-3-25"),
    pytest.param(792, 3, 10, True, id="792-3-10"),
    pytest.param(96, 3, 33, True, id="96-3-33")])
def test_attention_still_refuses(c, heads, win, refused):
    """Head widths 4, 4, 136 and a window of 25 are taken (the first two
    padded to 8, the third on the streaming kernel at 256); a head width of
    264 and a window of 33 stay refused."""
    if not refused:
        assert kswin.attn_refusal("x", c, heads, win) is None
        assert kwmsa.window_msa_refusal(c, heads, win, BF16) is None
        return
    assert "bad shape" in kswin.attn_refusal("x", c, heads, win)
    assert kwmsa.window_msa_refusal(c, heads, win, BF16)


@pytest.mark.parametrize("k,n", [(1, 1), (13, 7), (24, 100), (40, 100),
                                 (72, 216), (120, 360), (12288, 3072)])
def test_gemm_takes_any_k_and_n(k, n):
    assert kswin.gemm_refusal(k, n) is None
    for esz in (1, 2, 4):
        ld = kswin.row_pitch(k, esz)
        assert (ld * esz) % 16 == 0 and k <= ld < k + 16 // esz
    assert kswin.gemm_refusal(0, n) and kswin.gemm_refusal(k, 0)


def test_pitched_pads_only_unaligned_rows():
    """Weights are padded once, where their rows are not whole 16-byte
    steps: the int8 weight at K = 72 (rows 80 bytes apart, the padding
    zero); a bf16 weight at K = 72 and an int8 one at K = 96 stay as
    they are. The padded view gives the same int8 product."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(216, 72, generator=g)
    d = kswin.make_dense(w, torch.zeros(216), True)
    assert d.q8.shape == (216, 72) and d.q8.stride() == (80, 1)
    full = torch.as_strided(d.q8, (216, 80), (80, 1))
    assert not bool(full[:, 72:].any())
    q8, sw = kswin.quantize_weight(w)
    assert torch.equal(d.q8, q8) and torch.equal(d.sw, sw)
    x = torch.randn(5, 72, generator=g)
    want = kswin.int8_sim_dense(x, kswin.Dense(w, torch.zeros(216), q8, sw))
    assert torch.equal(kswin.int8_sim_dense(x, d), want)
    assert kswin.make_dense(w.to(BF16), None, False).wt.is_contiguous()
    assert kswin.make_dense(torch.randn(8, 96), None, True).q8 \
        .is_contiguous()
    assert kswin.pitched(torch.ones(3, 13, dtype=BF16)).stride() == (16, 1)


@pytest.mark.parametrize("row_bytes,ptrs,want", [
    (256, (0x1000, 0x2000), 16), (200, (0x1000,), 8), (404, (0,), 4),
    (6, (0,), 2), (256, (0x1004,), 4), (7, (0,), 1)])
def test_canvas_word_bytes(row_bytes, ptrs, want):
    assert kcanvas.word_bytes(row_bytes, *ptrs) == want


def test_canvas_takes_any_width():
    for c in (1, 3, 12, 100, 101, 128):
        for dt in (BF16, F32):
            assert kcanvas.canvas_refusal(8, c, dt) is None
    assert "bf16 or f32" in kcanvas.canvas_refusal(8, 12, torch.float16)
    assert "C >= 1" in kcanvas.canvas_refusal(8, 0, BF16)


# the [shapes tail] rows' configurations at full width
E384 = dict(backbone_embed_dim=384, backbone_num_heads=(6, 12, 24, 48))
HD8 = dict(backbone_embed_dim=72, backbone_num_heads=(9, 18, 36, 72))
HD40 = dict(backbone_embed_dim=120, backbone_num_heads=(3, 6, 12, 24))
C100 = dict(encoder_encoding_type="fourier",
            encoder_feat_channels=(128, 128, 100))


@pytest.mark.parametrize("over,fuse_ln", [
    (dict(E384, use_pallas_encoder=False), True), (HD8, False),
    (HD40, False), (C100, False)], ids=["e384", "hd8", "hd40", "c100"])
def test_tail_rows_take_every_kernel(over, fuse_ln):
    """Every kernel each ``[shapes tail]`` row selects takes its shapes (the
    models built on the meta device), in bf16 and f32."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CSRC.parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert (chip_smoke.E384, chip_smoke.HD8, chip_smoke.HD40,
            chip_smoke.C100) == (E384, HD8, HD40, C100)
    cfg = semantic_kitti_default().replace(**over)
    with torch.device("meta"):
        net = MaskBev(cfg).encoder.pillar_feature_net
    for dt in (BF16, F32):
        got = refusals(cfg, 8, dt, fuse_ln=fuse_ln)
        if not net.kernel_ok:
            # the Fourier encoding: the plain pillar feature net, as the
            # JAX package's XLA route (kernels 1 and 10 never launch)
            got.pop("stream_pfn")
        assert {"canvas_norm", "swin_block", "decoder_stack"} <= set(got)
        assert all(r is None for r in got.values()), got


# ---- the route on the card -----------------------------------------------


@pytest.fixture
def launches(monkeypatch):
    """Record each launch (C function, instance, int arguments) instead of
    making it; there is no card here."""
    made = []

    def launch(name, fn, *args, instance=None):
        made.append((fn, instance, [a.value for a in args
                                    if isinstance(a, type(kb.ci(0)))]))
    monkeypatch.setattr(kb, "launch", launch)
    monkeypatch.setattr(kb, "stream", lambda: kb.ptr(None))
    return made


@pytest.mark.parametrize("c,dt,inst", [(12, BF16, "bf16_walk"),
                                       (4096, F32, "f32_wide"),
                                       (4104, BF16, "bf16_walk"),
                                       (192, BF16, "bf16")])
def test_layer_norm_route_on_the_card(launches, c, dt, inst):
    x = on_card(torch.ones(3, 5, c, dtype=dt))
    w = on_card(torch.ones(c, dtype=dt))
    kln.layer_norm(x, w, w)
    (fn, got, ints), = launches
    assert (fn, got) == ("token_layernorm", inst)
    assert ints[2:5] == list(kln.plan(c, dt == F32))


def test_swin_ln_and_quant_route_on_the_card(launches):
    """LN at C 3072 (the wide kernel), LN + int8 at C 72 (rows at pitch
    80, the walk), int8 rows of K 72 and 120 (pitch 80 and 128)."""
    w = on_card(torch.ones(3072, dtype=BF16))
    kswin._ln(on_card(torch.ones(4, 3072, dtype=BF16)), w, w, False)
    w = on_card(torch.ones(72, dtype=BF16))
    q8, _ = kswin._ln(on_card(torch.ones(4, 72, dtype=BF16)), w, w, True)
    assert q8.stride() == (80, 1)
    for k in (72, 120):
        q8, _ = kswin._quant(on_card(torch.ones(4, k, dtype=F32)))
        assert q8.stride() == (kswin.row_pitch(k, 1), 1)
    assert [(fn, inst, ints[-2]) for fn, inst, ints in launches] == [
        ("swin_layernorm", "bf16_wide", 3072),
        ("swin_layernorm", "bf16_walk", 80),
        ("swin_quant_rows", "f32_walk", 80),
        ("swin_quant_rows", "f32_walk", 128)]


@pytest.mark.parametrize("kind,k,n", [("int8", 72, 216), ("int8", 24, 100),
                                      ("bf16", 40, 100), ("f32", 13, 7)])
def test_gemm_route_on_the_card(launches, kind, k, n):
    """The GEMM at the new K and N: the operands' pitches passed to the
    kernel, the N-tail instance for N % 8 != 0."""
    dt = F32 if kind == "f32" else BF16
    d = kswin.make_dense(torch.ones(n, k, dtype=dt), torch.zeros(n),
                         kind == "int8")
    if kind == "f32":  # the TF32 halves are made for CUDA weights only
        hi, lo = kswin.split_tf32(d.wt)
        d = d._replace(hi=kswin.pitched(hi), lo=kswin.pitched(lo))
    d = kswin.Dense(*(None if t is None else on_card(t) for t in d))
    a = torch.ones(9, k, dtype=torch.int8 if kind == "int8" else dt)
    a = on_card(kswin.pitched(a))
    sx = on_card(torch.ones(9)) if kind == "int8" else None
    kswin.gemm("swin_block", a, d, kswin.EPI_BIAS, sx=sx)
    (fn, inst, ints), = launches
    tail = "" if n % 8 == 0 else "_ntail"
    assert fn == {"int8": "gemm_s8", "bf16": "gemm_bf16",
                  "f32": "gemm_f32_3xtf32"}[kind]
    assert inst.endswith(tail) and inst.startswith("gemm_")
    esz = {"int8": 1, "bf16": 2, "f32": 4}[kind]
    assert ints[:5] == [9, n, k, kswin.row_pitch(k, esz),
                        kswin.row_pitch(k, esz)]


@pytest.mark.parametrize("hd", [8, 16, 40])
@pytest.mark.parametrize("msa", [False, True])
def test_attention_route_on_the_card(launches, hd, msa):
    heads, win, hw = 3, 10, (11, 12)
    c = heads * hd
    qkv = on_card(torch.ones(hw[0] * hw[1], 3 * c, dtype=BF16))
    kswin.attention("x", qkv, on_card(torch.zeros(3 * c)),
                    on_card(torch.zeros(heads, win * win, win * win)), 1, hw,
                    heads, win, 0, msa)
    (fn, inst, _), = launches
    base = "window_msa_attn" if msa else "swin_window_attn"
    assert fn == base + ("" if hd in kswin.ATTN_FLAGSHIP_DIMS else "_widths")
    assert inst == kswin.attn_instance(False, win, hd)


@pytest.mark.parametrize("c,dt,wb", [(100, BF16, 8), (101, F32, 4),
                                     (128, BF16, 16)])
def test_canvas_route_on_the_card(launches, c, dt, wb):
    table = on_card(torch.ones(2, 16, c, dtype=dt))
    cells = on_card(torch.zeros(2, 16, dtype=torch.int32))
    npil = on_card(torch.zeros(2, dtype=torch.int32))
    ones = torch.ones(2)
    affine = on_card(torch.ones(c, dtype=dt))
    kcanvas.canvas_norm(table, cells, npil, ones, ones, affine, affine,
                        (4, 4))
    kcanvas.canvas_scatter_forward(table, cells, (4, 4))
    kcanvas.canvas_scatter_backward(on_card(torch.ones(2, 4, 4, c,
                                                       dtype=dt)), cells,
                                    (4, 4))
    name = "bf16" if dt == BF16 else "f32"
    narrow = None if wb == 16 else f"w{wb}"
    assert [(fn, inst) for fn, inst, _ in launches] == [
        ("canvas_norm_forward", name + ("" if wb == 16 else f"_w{wb}")),
        ("canvas_scatter_forward", narrow),
        ("canvas_scatter_backward", narrow)]


# ---- the plain route against the JAX package -----------------------------


@pytest.mark.parametrize("c", [12, 2056])
def test_layer_norm_plain_matches_flax(c):
    rng = np.random.default_rng(c)
    x = rng.normal(size=(2, 9, c)).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    b = (0.1 * rng.normal(size=c)).astype(np.float32)
    want = nn.LayerNorm().apply(
        {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}},
        jnp.asarray(x))
    got = kln.layer_norm(*(torch.as_tensor(a) for a in (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


TINY = {"hd8": dict(backbone_embed_dim=24, backbone_num_heads=(3, 3, 6, 6)),
        "c12": dict(encoder_encoding_type="fourier",
                    encoder_feat_channels=(32, 12))}


@pytest.mark.parametrize("name", list(TINY))
def test_tiny_tail_matches_jax(name):
    """The whole model's plain route at the new widths against the JAX
    package (f32, no int8; 1e-3 on the final logits)."""
    kw = dict(TINY[name], compute_dtype="float32", backbone_quantize="none")
    jcfg = jax_tiny()
    h, w = jcfg.grid_hw
    jcfg = jcfg.replace(max_num_pillars=h * w, **kw)
    pts, mask = _scans(jcfg)
    v = _variables(jcfg, pts, mask)
    want = jax.jit(lambda v_, p_, m_: JaxMaskBev(jcfg).apply(
        v_, p_, m_, train=False, final_only=True))(
        v, jnp.asarray(pts), jnp.asarray(mask))
    model = load_flax(MaskBev(tiny_test_config().replace(
        max_num_pillars=h * w, **kw)), v)
    with torch.no_grad():
        got = model(torch.as_tensor(pts), torch.as_tensor(mask))
    for g, w_ in ((got.cls_logits, want.cls_logits),
                  (got.mask_logits, want.mask_logits)):
        g = g.float().numpy()
        assert g.shape == np.shape(w_)
        np.testing.assert_allclose(g, np.asarray(w_, np.float32), rtol=0,
                                   atol=1e-3)
