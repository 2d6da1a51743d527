"""The refusal audit's decoder and attention entries (a mask embedding of any
width, the split decoder past head width 64 and 512 queries, the window
attention at head widths 1-256 and windows up to 32), on the CPU.

* The rules take the new domain and refuse the rest, each with its reason:
  ``decoder_stack_refusal`` at every mask-embedding width D from 1 to 512 at
  C 256 (bf16: the flagship instance up to D 256, zero-padded to C; the
  split instance above), 2 heads of 128 and 8 of 256 (C 2048), one head of
  C 384 and 512, and 1024 queries; ``attn_refusal`` at every head width
  from 1 to 256 in windows up to 32 (not 257, not 33); the new layouts fit
  a block's shared memory.
* The padding transforms are exact, in float64 within 1e-12 (float64, so
  that no sum order of the CPU's products can move a ``m < 0`` decision):
  the mask embedding's D zero-padded to C (``embed_padding``) and a wider
  one through ``padded_split``; the split decoder's heads padded to widths
  128 and 256 and one head to C 512; the attention's heads padded to the
  next multiple of 8 (``padded_heads``: the true width's scale), whose int8
  layers quantise the true rows bit for bit.
* The plain route against the JAX package in f32, on the same variables
  (``load_flax``) and inputs drawn from a seed with numpy: the tiny config
  with a mask embedding of 32 and 96 columns at C 64 through ``MaskBev``
  (final_only; 1e-3 absolute on the logits, ``test_torch_port_model.py``'s
  f32 tolerance); the final-only decoder at C 256 over 2 heads (one layer
  group; 1e-4 absolute, ``test_torch_port_heads.py``'s); the Swin block and
  the XLA form with kernel 7's attention at head widths 12 and 36 and at a
  window of 25 (1e-4 of the largest value, ``test_torch_port_audit.py``'s).
* ``chip_smoke.py``'s ``.emb128`` and ``.audit2`` rows pass every rule at
  full width.
"""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.models.mask2former import (  # noqa: E402
    Mask2FormerDecoder as JaxDecoder)
from mask_bev_tpu.models.maskbev import MaskBev as JaxMaskBev  # noqa: E402
from mask_bev_tpu.models.swin import SwinBlock as JaxBlock  # noqa: E402
from mask_bev_tpu_torch.config import semantic_kitti_default  # noqa: E402
from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402
from mask_bev_tpu_torch.models.convert import load_flax  # noqa: E402
from mask_bev_tpu_torch.models.mask2former import (  # noqa: E402
    Mask2FormerDecoder)
from mask_bev_tpu_torch.models.maskbev import MaskBev  # noqa: E402
from mask_bev_tpu_torch.models.swin import SwinBlock  # noqa: E402
from mask_bev_tpu_torch.ops import decoder_stack as kdec  # noqa: E402
from mask_bev_tpu_torch.ops import swin_block as kswin  # noqa: E402
from mask_bev_tpu_torch.ops import window_msa as kwmsa  # noqa: E402
from test_torch_port_audit_rest import _decoder64  # noqa: E402
from test_torch_port_model import (  # noqa: E402
    _jax_cfg, _port_cfg, _scans, _variables as _model_variables)
from test_torch_port_shapes import refusals  # noqa: E402
from test_torch_port_shapes_wide import _variables  # noqa: E402

BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64
CSRC = pathlib.Path(kb.CSRC)
MAIN = dict(q=45, c=256, ffn=2048, heads=8, nl=3, n_layers=9, t_max=3969)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---- (a) the rules ----------------------------------------------------------


def test_split_limits_are_the_sources():
    text = (CSRC / "decoder_split.cuh").read_text()
    assert f"#define DS2_MAXR {kdec.SPLIT_MAXR} " in text
    assert f"#define DS2_RG {kdec.SPLIT_RG} " in text
    assert kdec.SPLIT_MAXQ == 1024
    for hd in (128, 256):  # the general kernel's, and one head's shared
        assert f"if (hd == {hd}) DS2_LAUNCH(TT, {hd}, 8, true);" in text
        assert f"if (hd == {hd}) DS2_LAUNCH(TT, {hd}, 8, false);" in text
    assert ("if (hd == 512 && heads == 1) DS2_LAUNCH(TT, 512, 8, true);"
            in text)
    attn = (CSRC / "window_attn.cuh").read_text()
    assert ": hd <= 128 ? 128" in attn and "hd > 256" in attn


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_decoder_takes_every_embedding_width(dtype):
    """D from 1 to 512 at the main path's shapes: bf16 up to C on the
    flagship instance (zero-padded), the rest on the split instance (the
    embedding in device memory); D 0 is refused."""
    for d in range(1, 513):
        assert kdec.decoder_stack_refusal(**MAIN, dtype=dtype, d=d) is None
        flagship = kdec.flagship_takes(**MAIN, dtype=dtype, d=d)
        assert flagship == (dtype == BF16 and d <= 256)
        assert kdec.embed_width(256, d) == (256 if d <= 256
                                            else -(-d // 32) * 32)
    assert "embedding=0" in kdec.decoder_stack_refusal(**MAIN, dtype=dtype,
                                                       d=0)
    inst = kdec.split_instance(45, 8, dtype == F32, 256, 2048, 3969, 384)
    assert inst.endswith("_embwide")
    assert kdec.split_instance(45, 8, True, 256, 2048, 3969,
                               128).endswith("_embpad")


@pytest.mark.parametrize("shape,inst", [
    (dict(MAIN, heads=2), "_hd128"), (dict(MAIN, c=2048), "_hd256_glob"),
    (dict(MAIN, heads=1, c=384), "_heads1_padded"),
    (dict(MAIN, heads=1, c=512), "_heads1"),
    (dict(MAIN, q=1024), "_cs16_glob"), (dict(MAIN, q=513), "_cs16_glob"),
    (dict(MAIN, heads=3, c=300), "_hd128_padded"),
    (dict(MAIN, heads=4, c=800), "_hd256_padded")],
    ids=["2x128", "8x256", "1x384", "1x512", "q1024", "q513", "3x100",
         "4x200"])
def test_split_takes_the_new_heads_and_queries(shape, inst):
    """Head widths 128 and 256 over any heads (a head a round, its output
    columns over the warps), one head up to C 512 and up to 1024 queries,
    each in bf16 and f32, its shared memory within the limit (the rows in
    the device-memory workspace where they do not fit beside the rest)."""
    q, c, heads = shape["q"], shape["c"], shape["heads"]
    for f32 in (False, True):
        assert kdec.split_refusal(**shape, f32=f32) is None
        hp, hdp, fp = kdec.split_padding(c, heads, shape["ffn"])
        plan = kdec.split_plan(q, hp * hdp, hp, shape["t_max"], f32)
        assert plan.nbytes <= kdec.SMEM_LIMIT
        assert plan.glob == inst.endswith(("_glob", "_glob_padded"))
        got = kdec.split_instance(q, heads, f32, c, 2048, shape["t_max"])
        assert got == ("split_tc_" + ("f32" if f32 else "bf16") + inst)
    ws = kdec.split_workspace(8, q, kdec.split_padding(c, heads, 2048)[0]
                              * kdec.split_padding(c, heads, 2048)[1])
    assert ws >= 8 * q * (c + 16) * 5


def test_split_plan_keeps_the_shared_rows():
    """Where the rows fit a block (32 rows or fewer at the shipped widths)
    the layout is the earlier one: the same bytes and keys a chunk."""
    for q in (45, 170, 256, 300, 512):
        for f32 in (False, True):
            plan = kdec.split_plan(q, 256, 8, 3969, f32)
            assert not plan.glob
            assert kdec.smem_bytes_split(q, 256, 8, 3969, f32) == \
                plan.nbytes
    assert kdec.smem_bytes_split(170, 256, 8, 3969) == 178528


@pytest.mark.parametrize("win", [1, 7, 10, 12, 16, 17, 24, 25, 31, 32])
def test_attention_takes_every_head_width(win):
    """Every head width from 1 to 256 in windows up to 32: the kernel width
    the next multiple of 8, over 128 the streaming kernel at 256; each
    instance fits its blocks' shared memory."""
    for hd in range(1, 257):
        assert kswin.attn_refusal("x", 2 * hd, 2, win) is None
        w = kswin.attn_kernel_dim(hd)
        assert w % 8 == 0 and hd <= w < hd + 8
        route = kswin.attn_route(win, w)
        if w > 128 or win > 24:
            assert route == "stream"
        inst = kswin.attn_instance(False, win, hd)
        assert inst.endswith("_padded") == (w != hd)
        if route == "stream":
            for f32 in (False, True):
                smem = kswin.attn_smem_bytes(win, w, f32)
                assert smem + 1024 <= 228 * 1024
    assert "bad shape" in kswin.attn_refusal("x", 514, 2, win)
    assert "1024 tokens" in kswin.attn_refusal("x", 64, 2, 33)


def test_attention_stream_at_256_is_single_buffered():
    """Staged at 256 the streaming kernel keeps one q tile and one k / v
    stage: two of each pass a block (bf16 at 264-value rows)."""
    for f32 in (False, True):
        assert kswin.attn_smem_bytes(32, 256, f32) <= 227 * 1024
    q2 = 2 * 128 * 264 * 2 + 2 * 2 * 64 * 264 * 2
    assert q2 > 227 * 1024
    assert kswin.attn_instance(False, 10, 144) == "attn_bf16_stream_hd144"
    assert kswin.attn_instance(True, 10, 36) == "attn_f32_hd40_padded"
    assert kswin.attn_instance(False, 25, 32) == "attn_bf16_stream"


# ---- (b) the padding transforms, exact --------------------------------------


def _decoder_f64(q, c, heads, d, ffn, seed):
    """Float64 decoder inputs with a mask embedding of ``d`` columns."""
    g = torch.Generator().manual_seed(seed)

    def r(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=g)).double()

    def mat(i, o):
        return r(i, o, scale=i ** -0.5)

    def vec(n, base=0.0):
        return base + r(n, scale=0.05)

    hws = [(2, 2), (4, 4), (8, 7)]
    layers = [kdec.LayerWeights(
        mat(c, c), vec(c), mat(c, c), vec(c), mat(c, c), vec(c), mat(c, c),
        vec(c), mat(c, c), vec(c), mat(c, c), vec(c), mat(c, c), vec(c),
        mat(c, c), vec(c), vec(c, 1.0), vec(c), vec(c, 1.0), vec(c),
        vec(c, 1.0), vec(c), mat(c, ffn), vec(ffn), mat(ffn, c), vec(c))
        for _ in range(3)]
    head = kdec.HeadWeights(vec(c, 1.0), vec(c), mat(c, c), vec(c),
                            mat(c, c), vec(c), mat(c, d), vec(d))
    out0, qpos = r(2, q, c), r(q, c)
    mems = [r(2, h * w, c) for (h, w) in hws]
    pes = [r(h * w, c) for (h, w) in hws]
    feats = [r(2, h * w, d) for (h, w) in hws]
    emb0 = r(2, q, d)
    return out0, emb0, qpos, mems, pes, feats, layers, head


@pytest.mark.parametrize("c,heads,d,ffn", [
    (64, 8, 1, 128), (64, 8, 40, 128), (96, 8, 64, 300), (64, 8, 100, 128),
    (96, 8, 300, 300), (200, 2, 64, 300), (200, 2, 333, 300),
    (480, 2, 100, 480), (384, 1, 500, 384)],
    ids=["c64-d1", "c64-d40", "c96-d64", "c64-d100", "c96-d300",
         "c200-2heads-d64", "c200-2heads-d333", "c480-2heads", "c384-1head"])
def test_padded_model_is_the_decoder(c, heads, d, ffn):
    """What the kernels run (the embedding at ``embed_width``, zero-padded;
    then the split instance's padded model, ``padded_split``: heads to 8-64,
    128 or 256 columns, one head to C 512) gives the true decoder's final
    state in float64 within 1e-12, the padded columns exact zeros."""
    out0, emb0, qpos, mems, pes, feats, layers, head = _decoder_f64(
        10, c, heads, d, ffn, c + heads + d)
    scale = (c // heads) ** -0.5
    want = _decoder64(out0, emb0, qpos, mems, pes, feats, layers, head,
                      heads, scale)
    de = kdec.embed_width(c, d)
    hp_ = kdec.embed_padding(head, de)
    assert hp_.m3.shape == (c, de) and bool((hp_.m3[:, d:] == 0).all())

    def pad_d(x):
        return torch.nn.functional.pad(x, (0, de - d))
    # the embedding alone, at C's columns or wider
    got = _decoder64(out0, pad_d(emb0), qpos, mems, pes,
                     [pad_d(f) for f in feats], layers, hp_, heads, scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    # and the split instance's padded model around it
    hp, hdp, fp = kdec.split_padding(c, heads, ffn)
    cp = hp * hdp
    col = kdec.padded_columns(c, heads, hdp)
    lp, hw = kdec.padded_split(layers, hp_, c, heads, ffn)
    assert hw.m3.shape == ((cp, de) if de > c else (cp, cp))

    def widen(x):
        out = x.new_zeros(*x.shape[:-1], cp)
        out[..., col] = x
        return out

    def emb_cols(x):
        return pad_d(x) if de > c else widen(pad_d(x))
    got = _decoder64(widen(out0), emb_cols(emb0), widen(qpos), mems, pes,
                     [emb_cols(f) for f in feats], lp, hw, hp, scale,
                     cols=col)
    pad = torch.ones(cp, dtype=torch.bool)
    pad[col] = False
    assert bool((got[..., pad] == 0).all())
    np.testing.assert_allclose(got[..., col].numpy(), want.numpy(), rtol=0,
                               atol=1e-12)


def _attend64(x, wq, bq, wp, bp, heads, hd, scale):
    """Window-free attention of one window of tokens in float64: qkv =
    x Wq^T + bq (heads of ``hd`` columns each), softmax(q k^T scale) v,
    then the projection."""
    n, c3 = x.shape[0], wq.shape[0]
    t = (x @ wq.T + bq).reshape(n, 3, heads, hd).permute(1, 2, 0, 3)
    p = torch.softmax(t[0] @ t[1].transpose(-1, -2) * scale, dim=-1)
    o = (p @ t[2]).transpose(0, 1).reshape(n, heads * hd)
    return o @ wp.T + bp


@pytest.mark.parametrize("c,heads", [(36, 3), (24, 2), (72, 2), (200, 2),
                                     (4, 1)],
                         ids=["hd12", "hd12-2", "hd36", "hd100", "hd4"])
def test_padded_heads_are_the_attention(c, heads):
    """``padded_heads``: each head's q, k and v columns at the next
    multiple of 8 (zero weight rows and bias), the projection's input rows
    alike; at the true width's scale the attention and projection are the
    true ones in float64 within 1e-12, the padded q, k, v columns exact
    zeros; the int8 layers quantise the true rows bit for bit (a zero row at
    the floor scale). A block's kernel weights carry them, made once."""
    hd = c // heads
    w = kswin.attn_kernel_dim(hd)
    g = torch.Generator().manual_seed(c)
    wq = torch.randn(3 * c, c, generator=g) / c ** 0.5
    bq = 0.1 * torch.randn(3 * c, generator=g)
    wp = torch.randn(c, c, generator=g) / c ** 0.5
    bp = 0.1 * torch.randn(c, generator=g)
    qkv, proj = kswin.make_dense(wq, bq, False), kswin.make_dense(wp, bp,
                                                                  False)
    pq, pp = kswin.padded_heads(qkv, proj, heads)
    assert pq.wt.shape == (3 * heads * w, c) and pp.wt.shape == (c,
                                                                 heads * w)
    x = torch.randn(49, c, generator=g).double()
    want = _attend64(x, wq.double(), bq.double(), wp.double(), bp.double(),
                     heads, hd, hd ** -0.5)
    got = _attend64(x, pq.wt.double(), pq.bias.double(), pp.wt.double(),
                    pp.bias.double(), heads, w, hd ** -0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    cols = kswin.padded_columns(c, heads, w)
    rows = torch.cat([cols + part * heads * w for part in range(3)])
    pad = torch.ones(3 * heads * w, dtype=torch.bool)
    pad[rows] = False
    assert bool((pq.wt[pad] == 0).all()) and bool((pq.bias[pad] == 0).all())
    q8, q8p = (kswin.make_dense(wq, bq, True),
               kswin.padded_heads(kswin.make_dense(wq, bq, True),
                                  kswin.make_dense(wp, bp, True), heads))
    assert torch.equal(q8p[0].q8[rows, :c], q8.q8[:, :c])
    assert torch.equal(q8p[0].sw[rows], q8.sw)
    assert bool((q8p[0].q8[pad] == 0).all())
    assert torch.equal(q8p[1].sw, kswin.make_dense(wp, bp, True).sw)
    blk = SwinBlock(c, heads, 7, shift=False)
    p = blk.weights()
    assert p.qkv_k.wt.shape == pq.wt.shape and p.proj_k.wt.shape == \
        pp.wt.shape
    assert blk.weights() is p
    assert SwinBlock(8 * heads, heads, 7, shift=False).weights().qkv_k is None


def test_plain_attention_takes_the_true_scale():
    """``window_attention_plain`` on padded qkv at the true width (``hd``)
    gives the true attention's columns: f32 within 1e-6 of the largest
    value (the products sum the zero columns in another order)."""
    heads, hd, win, hw = 2, 12, 5, (7, 9)
    c, w = heads * hd, kswin.attn_kernel_dim(hd)
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(2 * hw[0] * hw[1], 3 * c, generator=g)
    qb = 0.1 * torch.randn(3 * c, generator=g)
    rel = kswin.rel_bias_from_table(
        0.02 * torch.randn((2 * win - 1) ** 2, heads, generator=g), win)
    qp, bp, cols = kswin.padded_qkv(qkv, qb, heads)
    assert qp.shape == (qkv.shape[0], 3 * heads * w)
    for msa in (False, True):
        want = kswin.window_attention_plain(qkv, qb, rel, 2, hw, heads, win,
                                            2, msa)
        got = kswin.attention("x", qp, bp, rel, 2, hw, heads, win, 2, msa,
                              hd=hd)[:, cols]
        assert _rel(got.numpy(), want.numpy()) <= 1e-6


@pytest.mark.parametrize("c,heads,hdp", [(36, 3, 16), (200, 2, 104),
                                         (256, 2, 128), (300, 3, 128),
                                         (4, 1, 8)])
def test_padded_columns_layout(c, heads, hdp):
    """The one head-padding rule the attention's and the decoder's padding
    share: true column j of head j // hd at column j % hd of that head's
    ``hdp`` columns; ``padded_qkv`` places q, k and v alike and zeros the
    rest."""
    hd = c // heads
    want = [h * hdp + i for h in range(heads) for i in range(hd)]
    assert kswin.padded_columns(c, heads, hdp).tolist() == want
    assert kdec.padded_columns is kswin.padded_columns
    if kswin.attn_kernel_dim(hd) == hdp:
        qkv = torch.arange(2 * 3 * c, dtype=F32).reshape(2, 3 * c) + 1
        qp, bp, cols = kswin.padded_qkv(qkv, qkv[0], heads)
        for part in range(3):
            for j, col in enumerate(want):
                assert torch.equal(qp[:, part * heads * hdp + col],
                                   qkv[:, part * c + j])
        assert int((qp != 0).sum()) == qkv.numel()
        assert torch.equal(bp, qp[0]) and cols.tolist() == want


def test_window_msa_takes_the_padded_layers_from_its_caller():
    """At a head width that is no multiple of 8 the CUDA chain runs the
    layers the caller padded once (``BlockWeights.qkv_k``/``proj_k``) and
    raises without them, not padding the weights at every call."""
    from test_torch_port_shapes import on_card
    c, heads = 36, 3
    g = torch.Generator().manual_seed(1)
    qkv = kswin.make_dense(torch.randn(3 * c, c, generator=g),
                           torch.zeros(3 * c), False)
    proj = kswin.make_dense(torch.randn(c, c, generator=g), torch.zeros(c),
                            False)
    y = on_card(torch.randn(1, 49, c, generator=g).to(BF16))
    with pytest.raises(ValueError, match="padded="):
        kwmsa.window_msa(y, (7, 7), 7, 0, None, qkv, proj, heads)


def _flip_case():
    """Two layers of (1, 4, 6) logits, their bands and the plain version's
    blocked positions."""
    m = torch.tensor([[[-1.0, -2.0, -1.5, -1.0, -3.0, -1e-6],
                       [1.0, -1.0, 2.0, -1.0, 1.0, -2.0],
                       [-1.0, -1.0, -1.0, -1.0, -1.0, -1.0],
                       [3e-7, 1.0, -1.0, 1.0, 2.0, -1.0]]])
    band = torch.full_like(m, 1e-3)
    return m, band, kdec.blocked_positions(m)


@pytest.mark.parametrize("case", ["same", "tie", "far", "turned-tie",
                                  "turned-far", "cleared-at-ties"])
def test_decision_flips(case):
    """``decision_flips``: a decision that differs beyond its logit's band
    counts, one within it does not; a row whose every-key-blocked rule the
    kernel applies otherwise counts once, beside its far entries."""
    m, band, pb = _flip_case()
    kb_ = pb.clone()
    want = 0
    if case == "tie":  # row 3's first logit is 3e-7: blocked by the kernel
        kb_[0, 3, 0] = True
    elif case == "far":  # row 1's third logit 2.0, blocked
        kb_[0, 1, 2] = True
        want = 1
    elif case == "turned-tie":
        # row 0 blocks every key in the plain version (cleared); the
        # kernel opens its last key, at -1e-6, and blocks the rest
        kb_[0, 0] = torch.tensor([True] * 5 + [False])
        want = 1
    elif case == "turned-far":
        # row 2 (cleared in the plain version): the kernel opens two keys
        # at -1.0
        kb_[0, 2] = torch.tensor([True] * 4 + [False] * 2)
        want = 2 + 1
    elif case == "cleared-at-ties":
        # every logit of row 0 within the band: the kernel's open row reads
        # as the plain version's cleared one
        band[0, 0] = 4.0
    assert kdec.decision_flips([kb_], [m], [band]) == [want]


def test_plain_bands_leave_the_output():
    """``return_bands``: the same output and logits, each layer's band
    positive; at D 1 an embedding value 1e-3 of its terms' size lies in the
    band at every key (the whole row's sign is rounding's), one of their
    size at none."""
    def f32(a):
        return [f32(t) for t in a] if isinstance(a, list) else a.float()
    args = [f32(a) for a in _decoder_f64(6, 64, 8, 1, 128, 5)[:6]]
    _, _, _, _, _, _, layers, head = _decoder_f64(6, 64, 8, 1, 128, 5)
    args += [[kdec.LayerWeights(*f32(list(lw))) for lw in layers],
             kdec.HeadWeights(*f32(list(head)))]
    out, logits = kdec.decoder_stack_plain(*args, num_heads=8,
                                           return_logits=True)
    out_b, logits_b, bands = kdec.decoder_stack_plain(
        *args, num_heads=8, return_logits=True, return_bands=True)
    assert torch.equal(out, out_b)
    assert all(torch.equal(a, b) for a, b in zip(logits, logits_b))
    assert all(bool((b > 0).all()) for b in bands)
    feat = torch.randn(1, 5, 1, generator=torch.Generator().manual_seed(4))
    emb = torch.tensor([[[1e-3], [1.0]]])
    m = emb @ feat.transpose(-1, -2)
    band = kdec.logit_band(torch.ones(1, 2, 1), feat, BF16)
    assert bool((m[0, 0].abs() <= band[0, 0]).all())
    assert bool((m[0, 1].abs() > band[0, 1]).all())


# ---- (c) the plain route against the JAX package ----------------------------


@pytest.mark.parametrize("d", [32, 96])
def test_maskbev_embedding_width_matches_jax(d):
    """The tiny config (C 64) with a mask embedding of ``d`` columns
    through ``MaskBev(final_only=True)``, f32, against the JAX model."""
    jcfg = _jax_cfg(head_out_channels=d)
    pts, mask = _scans(jcfg)
    v = _model_variables(jcfg, pts, mask, seed=d)
    want = jax.jit(lambda v_, p_, m_: JaxMaskBev(jcfg).apply(
        v_, p_, m_, train=False, final_only=True))(
            v, jnp.asarray(pts), jnp.asarray(mask))
    model = load_flax(MaskBev(_port_cfg(head_out_channels=d)), v)
    assert model.decoder.heads.mask_mlp3.weight.shape == (d, 64)
    with torch.no_grad():
        got = model(torch.as_tensor(pts), torch.as_tensor(mask))
    np.testing.assert_allclose(got.cls_logits.numpy(),
                               np.asarray(want.cls_logits), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.mask_logits.numpy(),
                               np.asarray(want.mask_logits), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("d", [256, 384])
def test_decoder_two_heads_matches_xla(d):
    """The final-only decoder at C 256 over 2 heads (head width 128), one
    layer group, FFN 512, with a mask embedding of ``d`` columns, against
    the JAX decoder's XLA path."""
    c, heads = 256, 2
    rng = np.random.default_rng(d)
    b, q = 2, 12
    mf = rng.normal(size=(b, 16, 16, d)).astype(np.float32)
    mems = [rng.normal(size=(b, hh, ww, c)).astype(np.float32)
            for (hh, ww) in [(2, 2), (4, 4), (8, 8)]]
    kw = dict(num_queries=q, num_classes=1, num_layers=3, feat_channels=c,
              out_channels=d, num_heads=heads, ffn_dim=512)
    jd = JaxDecoder(**kw)
    v = _variables(lambda: jd.init(jax.random.PRNGKey(c), jnp.asarray(mf),
                                   [jnp.asarray(m) for m in mems],
                                   train=False), d)
    want = jax.jit(lambda v_, mf_, ms_: jd.apply(
        v_, mf_, ms_, train=False, final_only=True))(
            v, jnp.asarray(mf), [jnp.asarray(m) for m in mems])
    dec = load_flax(Mask2FormerDecoder(**kw), v)
    with torch.no_grad():
        got = dec(torch.as_tensor(mf), [torch.as_tensor(m) for m in mems],
                  final_only=True)
    np.testing.assert_allclose(got.cls_logits.numpy(),
                               np.asarray(want.cls_logits), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.mask_logits.numpy(),
                               np.asarray(want.mask_logits), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("c,heads,win,hw", [
    (36, 3, 7, (9, 11)), (72, 2, 7, (9, 11)), (32, 2, 25, (27, 26))],
    ids=["hd12", "hd36", "win25"])
def test_block_matches_xla(c, heads, win, hw):
    """Kernel 3's chain (``fused``) and the XLA form with kernel 7's
    attention (``fused_attention``), both plain, shifted, against the JAX
    block's XLA path, on a grid that pads on both axes."""
    rng = np.random.default_rng(c + win)
    x = rng.normal(size=(2, hw[0] * hw[1], c)).astype(np.float32)
    jb = JaxBlock(c, heads, win, shift=True, use_pallas=False)
    v = _variables(lambda: jb.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   hw, train=False), c + win)
    want = np.asarray(jax.jit(lambda v_, x_: jb.apply(
        v_, x_, hw, train=False))(v, jnp.asarray(x)))
    blk = load_flax(SwinBlock(c, heads, win, shift=True), v)
    with torch.no_grad():
        chain = blk(torch.as_tensor(x), hw).numpy()
        msa = blk(torch.as_tensor(x), hw, fused=False,
                  fused_attention=True).numpy()
    assert _rel(chain, want) <= 1e-4
    assert _rel(msa, want) <= 1e-4


# ---- (d) the served rows ----------------------------------------------------


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CSRC.parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("row", ["EMB128", "AUDIT2"])
def test_last_rows_take_every_kernel(row):
    """``.emb128`` and ``.audit2`` at full width and batch 8 (the models on
    the meta device): every rule takes them, in bf16 and f32."""
    over = getattr(_smoke(), row)
    cfg = semantic_kitti_default().replace(**over)
    for dt in (BF16, F32):
        got = refusals(cfg, 8, dt)
        assert set(got) == {"pfn", "canvas_norm", "swin_block",
                            "decoder_stack"}
        assert all(r is None for r in got.values()), got
    if row == "EMB128":
        assert kdec.flagship_takes(45, 256, 2048, 8, 3, 9, 3969, BF16, 128)
    else:
        assert kdec.split_instance(45, 2, False, 256, 2048, 3969, 384) == \
            "split_tc_bf16_hd128_embwide"
        assert [cfg.backbone_embed_dim * 2 ** i // h for i, h in
                enumerate(cfg.backbone_num_heads)] == [144, 36, 36, 36]
        assert kwmsa.window_msa_refusal(144, 1, 10, BF16) is None
