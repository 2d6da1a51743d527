"""Every kernel's shape rule (one function a kernel: the reason it refuses
a shape, or None), on the CPU where the rules are pure functions of shapes
and dtype.

* Each rule refuses the shapes its kernel does not take (a window of 25,
  no point a pillar, E = 264, an attention head width of 4 or 12, a
  decoder head width of 128 at 2 heads, 513 queries, float16) and takes
  every shape of
  the flagship's paths
  (``semantic_kitti_default()`` in bf16 and f32, Waymo, paths K and E), of
  ``tiny_test_config()``, whose head width of 8 the decoder's split
  instance takes, and the wider shapes the JAX package serves: windows 12
  and 16, up to 128 points a pillar, E = 48 and 96, up to 512 queries, 1
  and 16 heads.
* Each wrapper raises on a CUDA tensor of a refused shape (before it
  builds or launches anything): on the card there is no plain route. The
  canvas wrapper splits 184 samples into launches of at most 183.
* The decoder's route on the card: the kernel, at the tiny config's 8
  heads and at ``semantic_kitti_default()``. A tensor whose ``is_cuda``
  reads True stands in for the card's.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from mask_bev_tpu_torch.config import (  # noqa: E402
    kitti_default, semantic_kitti_default, tiny_test_config, waymo_default)
from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402
from mask_bev_tpu_torch.models import mask2former as m2f  # noqa: E402
from mask_bev_tpu_torch.models.maskbev import MaskBev  # noqa: E402
from mask_bev_tpu_torch.ops import canvas as kcanvas  # noqa: E402
from mask_bev_tpu_torch.ops import decoder_stack as kdec  # noqa: E402
from mask_bev_tpu_torch.ops import layer_norm as kln  # noqa: E402
from mask_bev_tpu_torch.ops import patch_embed as kpe  # noqa: E402
from mask_bev_tpu_torch.ops import pfn as kpfn  # noqa: E402
from mask_bev_tpu_torch.ops import swin_block as kswin  # noqa: E402
from mask_bev_tpu_torch.ops import window_msa as kwmsa  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
PFN_DIMS = [(10, 64), (128, 64), (128, 128)]  # the flagship's three layers


class OnCard(torch.Tensor):
    """A CPU tensor that reads as a CUDA one: the models choose a CUDA
    call's route from ``is_cuda`` and shapes alone."""

    @property
    def is_cuda(self):
        return True


def on_card(t):
    return t.as_subclass(OnCard)


def test_decoder_takes_head_width_8():
    """The split instance takes head widths 8 and 16 (``tiny_test_config()``
    and ``00_quick_test.yml``: C 64 over 8 heads), and 16 heads of C 64
    (head width 4, padded to 8); a head width of 512 at 2 heads it does
    not (128 and 256 it takes)."""
    tiny = dict(q=8, c=64, ffn=128, heads=8, nl=3, n_layers=3, t_max=100)
    for dt in (BF16, F32):
        assert kdec.decoder_stack_refusal(**tiny, dtype=dt) is None
        assert kdec.decoder_stack_refusal(**dict(tiny, heads=4),
                                          dtype=dt) is None  # width 16
    assert not kdec.flagship_takes(**tiny, dtype=BF16)
    assert kdec.split_refusal(**tiny) is None
    assert kdec.split_refusal(**dict(tiny, heads=16)) is None
    for c in (256, 512):
        assert kdec.split_refusal(**dict(tiny, c=c, heads=2)) is None
    assert "split instance" in kdec.split_refusal(**dict(tiny, c=1024,
                                                         heads=2))
    assert "bf16 or f32" in kdec.decoder_stack_refusal(
        **tiny, dtype=torch.float16)


@pytest.mark.parametrize("c,heads,win,hidden,refused", [
    # a window of 25: 625 tokens (up to 32 are taken)
    pytest.param(192, 6, 25, 768, False, id="192-6-25-768"),
    # head width 4 (padded to 8)
    pytest.param(96, 24, 10, 384, False, id="96-24-10-384"),
    # head width 12 (padded to 16; fc2 K = 200 is taken)
    pytest.param(96, 8, 7, 200, False, id="96-8-7-200"),
    # a window of 33: 1089 tokens
    pytest.param(192, 6, 33, 768, True, id="192-6-33-768"),
    # head width 264 (up to 256 are taken)
    pytest.param(528, 2, 10, 2112, True, id="528-2-10-2112"),
    pytest.param(264, 1, 7, 200, True, id="264-1-7-200"),
])
def test_swin_chain_refuses(c, heads, win, hidden, refused):
    for dt in (BF16, F32):
        reason = kswin.swin_block_refusal(c, heads, win, hidden, dt)
        assert bool(reason) == refused, reason
    if hidden == 4 * c and refused:
        assert "bad shape" in kwmsa.window_msa_refusal(c, heads, win, BF16)
    if win > 24:
        # windows 12, 16, 24 and 32 (144, 256, 576 and 1024 tokens) are
        # taken
        for w, dt in ((12, BF16), (12, F32), (16, BF16), (16, F32),
                      (24, BF16), (24, F32), (32, BF16), (32, F32)):
            assert kswin.swin_block_refusal(c, heads, w, hidden, dt) is None
            assert kwmsa.window_msa_refusal(c, heads, w, dt) is None
    # the GEMM takes any K and N >= 1
    assert "K >= 1" in kswin.gemm_refusal(0, 64)
    for k, n in ((200, 64), (192, 576), (72, 100)):
        assert kswin.gemm_refusal(k, n) is None


def test_pfn_refuses_33_points_a_pillar():
    """33 to 128 points a pillar are taken (the instances of 12 m16 tiles),
    and 129 (the layered route beside them); no point a pillar and 257
    units are not."""
    for k in (33, 64, 100, 128, 129):
        for dt in (BF16, F32):
            assert kpfn.pfn_refusal(k, PFN_DIMS, 10, dt, dt) is None
            assert kpfn.stream_pfn_refusal(k, 4, PFN_DIMS, True, dt, dt,
                                           dt) is None
    assert "at least 1 point" in kpfn.pfn_refusal(0, PFN_DIMS, 10, BF16,
                                                  BF16)
    assert "at least 1 point" in kpfn.stream_pfn_refusal(
        0, 4, PFN_DIMS, True, BF16, BF16, BF16)
    assert "1 to 256 units" in kpfn.pfn_refusal(
        129, [(10, 64), (128, 64), (128, 257)], 10, BF16, BF16)
    assert kpfn.pfn_refusal(32, [(10, 64), (128, 64), (128, 264)], 10,
                            F32, F32)  # 264 units a layer
    assert kpfn.stream_pfn_refusal(32, 5, PFN_DIMS, True, BF16, BF16, BF16)
    assert kpfn.pfn_refusal(32, PFN_DIMS, 10, F32, F32) is None


def test_patch_embed_refuses_e96():
    """E = 48 and 96 are taken (their own wgmma widths), and E = 80 (on
    the instance of 96, padded); E = 264 is not."""
    for e in (48, 80, 96):
        for dt in (BF16, F32):
            assert kpe.patch_embed_refusal(2, 32, 48, 128, e, 4, dt) is None
    assert "E from 1 to 256" in kpe.patch_embed_refusal(2, 32, 48, 128, 264,
                                                        4, BF16)
    assert kpe.patch_embed_refusal(2, 30, 48, 128, 192, 4, BF16)
    assert kpe.patch_embed_refusal(8, 500, 500, 128, 192, 4, BF16) is None


def test_layer_norm_refuses():
    assert "C >= 1" in kln.layer_norm_refusal(0, BF16)
    for c in (12, 4096):  # taken: the walk instance
        assert kln.layer_norm_refusal(c, F32) is None
    assert kln.layer_norm_refusal(192, torch.float16)
    assert kln.layer_norm_refusal(1536, BF16) is None


def test_canvas_splits_184_samples():
    assert kcanvas.CANVAS_MAX_BATCH == 183
    chunks = kcanvas.canvas_chunks(184)
    assert chunks == [(0, 92), (92, 184)]
    assert kcanvas.canvas_refusal(184, 128, BF16) is None
    assert kcanvas.canvas_chunks(183) == [(0, 183)]
    assert [j - i for i, j in kcanvas.canvas_chunks(400)] == [133, 133, 134]
    assert all(j - i <= kcanvas.CANVAS_MAX_BATCH
               for n in (1, 183, 184, 366, 367, 1000)
               for i, j in kcanvas.canvas_chunks(n))
    assert kcanvas.canvas_refusal(8, 12, BF16) is None  # any C
    assert "bf16 or f32" in kcanvas.canvas_refusal(8, 12, torch.float16)


def _path_k():
    return kitti_default().replace(use_pallas_backbone=False,
                                   use_pallas_attention=True,
                                   fuse_patch_embed=True)


def _path_e():
    return semantic_kitti_default().replace(use_pallas_encoder=False)


def refusals(cfg, batch, dtype, fuse_ln=False):
    """Each kernel ``cfg``'s switches select for a serving call of
    ``batch`` scans in ``dtype``, and its rule's verdict on the model's
    shapes (None: taken). The model is built on the meta device."""
    with torch.device("meta"):
        model = MaskBev(cfg)
    enc, bb, dec = model.encoder, model.backbone, model.decoder
    net = enc.pillar_feature_net
    dims = [tuple(getattr(net, f"pfn_{i}").linear.weight.shape[::-1])
            for i in range(net.num_layers)]
    out = {}
    if enc.uses_slot_path(False):
        out["pfn"] = kpfn.pfn_refusal(
            enc.k, dims, net.point_dim + 5 + int(net.with_distance), dtype,
            dtype)
    else:
        out["stream_pfn"] = kpfn.stream_pfn_refusal(
            enc.k, net.point_dim, dims, net.with_distance, dtype, dtype,
            dtype)
    out["canvas_norm"] = kcanvas.canvas_refusal(batch, enc.channels, dtype)
    h, w = enc.grid_hw
    if model.flat_embed_ok(False):
        out["patch_embed"] = kpe.patch_embed_refusal(
            batch, h, w, enc.channels, bb.embed_dim, bb.patch_size, dtype)
    blocks = [getattr(bb, f"stage{i}_block{d}")
              for i, depth in enumerate(bb.depths) for d in range(depth)]
    if bb.use_pallas_block:
        out["swin_block"] = next(filter(None, (kswin.swin_block_refusal(
            blk.norm1.weight.shape[0], blk.num_heads, blk.window,
            blk.ffn_1.weight.shape[0], dtype) for blk in blocks)), None)
        if fuse_ln:
            widths = [bb.embed_dim] + [
                getattr(bb, f"out_norm{i}").weight.shape[0]
                for i in range(len(bb.depths))]
            out["layer_norm"] = next(filter(None, (
                kln.layer_norm_refusal(c, dtype) for c in widths)), None)
    elif bb.use_pallas and not any(blk.quantize for blk in blocks):
        out["window_msa"] = next(filter(None, (kwmsa.window_msa_refusal(
            blk.norm1.weight.shape[0], blk.num_heads, blk.window, dtype)
            for blk in blocks)), None)
    if dec.use_kernel:
        # the memories: patch embed by the stride, then a halving merge a
        # stage; the decoder reads levels 3, 2, 1
        hws = [(-(-h // bb.stride), -(-w // bb.stride))]
        for _ in range(len(bb.depths) - 1):
            hws.append(((hws[-1][0] + 1) // 2, (hws[-1][1] + 1) // 2))
        out["decoder_stack"] = kdec.decoder_stack_refusal(
            dec.query_feat.shape[0], dec.query_feat.shape[1],
            dec.layer0.ffn.fc1.weight.shape[0], dec.num_heads, 3,
            dec.num_layers, max(hh * ww for hh, ww in hws[1:4]), dtype,
            dec.heads.mask_mlp3.weight.shape[0])
    return out


FLAGSHIP = {
    "main": (semantic_kitti_default, BF16,
             {"pfn", "canvas_norm", "swin_block", "decoder_stack"}),
    "F": (semantic_kitti_default, F32,
          {"pfn", "canvas_norm", "swin_block", "decoder_stack"}),
    "W": (waymo_default, F32,
          {"pfn", "canvas_norm", "swin_block", "decoder_stack"}),
    "K": (_path_k, BF16, {"pfn", "canvas_norm", "patch_embed", "window_msa",
                          "decoder_stack"}),
    "Kf32": (_path_k, F32, {"pfn", "canvas_norm", "patch_embed",
                            "window_msa", "decoder_stack"}),
    "E": (_path_e, BF16, {"stream_pfn", "canvas_norm", "swin_block",
                          "layer_norm", "decoder_stack"}),
    "Ef32": (_path_e, F32, {"stream_pfn", "canvas_norm", "swin_block",
                            "layer_norm", "decoder_stack"}),
}


@pytest.mark.parametrize("name", list(FLAGSHIP))
def test_flagship_paths_take_every_kernel(name):
    make, dt, kernels = FLAGSHIP[name]
    got = refusals(make(), 8, dt, fuse_ln=name.startswith("E"))
    assert set(got) == kernels
    assert all(r is None for r in got.values()), got


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_tiny_config_takes_every_kernel(dtype):
    """``tiny_test_config()`` with its own 8 heads: every kernel takes it,
    the decoder's split instance at head width 8 included."""
    got = refusals(tiny_test_config(), 2, dtype)
    assert got == {"stream_pfn": None, "canvas_norm": None,
                   "swin_block": None, "decoder_stack": None}


def test_wrappers_raise_on_refused_shapes():
    """A direct call with a refused shape raises before anything is built
    or launched."""
    g = torch.Generator().manual_seed(0)
    x = on_card(torch.randn(2, 1089, 96, generator=g))
    fc1 = kswin.Dense(torch.zeros(384, 96), torch.zeros(384))
    p = kswin.BlockWeights(None, None, None, None, None, None, fc1, None,
                           None)
    # a window of 33 (1089 tokens); 12, 16, 24, 25 and 32 are taken
    with pytest.raises(ValueError, match="bad shape"):
        kswin.swin_block(x.to(BF16), p, (33, 33), 33, 3, 0, False)
    with pytest.raises(ValueError, match="bad shape"):
        kwmsa.window_msa(x.to(BF16), (33, 33), 33, 0, None, None, None, 3)
    for win in (12, 16, 24, 25, 32):
        assert kswin.swin_block_refusal(96, 3, win, 384, BF16) is None
    with pytest.raises(ValueError, match="bf16 or f32"):
        kln.layer_norm(on_card(torch.zeros(4, 4096, dtype=torch.float16)),
                       None, None)
    canvas = on_card(torch.zeros(2, 32, 48, 128, dtype=BF16))
    # E = 264; 96 is taken, and 80 (padded to 96)
    wm = torch.zeros(264, 4 * 4 * 128, dtype=BF16)
    with pytest.raises(ValueError, match="E from 1 to 256"):
        kpe.patch_embed(canvas, wm, None, None, None, 4)
    assert kpe.patch_embed_refusal(2, 32, 48, 128, 96, 4, BF16) is None
    table = on_card(torch.zeros(2, 16, 12, dtype=torch.float16))
    ones = torch.ones(2)
    with pytest.raises(ValueError, match="bf16 or f32"):
        kcanvas.canvas_norm(table, None, None, ones, ones, ones, ones,
                            (4, 4))
    out0 = on_card(torch.zeros(2, 1025, 64))
    layers = [kdec.LayerWeights(*(torch.zeros(64, 128),) * len(
        kdec.LayerWeights._fields))] * 3
    mems = [on_card(torch.zeros(2, n, 64)) for n in (9, 25, 100)]
    # 1025 queries: 65 rows a block in clusters of 16 (up to 1024 are
    # taken); 16 heads of C 256 are taken, and of C 64 (a head width of 4,
    # padded to 8)
    with pytest.raises(ValueError, match="split instance"):
        kdec.decoder_stack(out0, out0, None, mems, None, None, layers, None,
                           num_heads=16)
    assert kdec.decoder_stack_refusal(45, 256, 2048, 16, 3, 9, 3969,
                                      BF16) is None


def _pfn_stream():
    from mask_bev_tpu_torch.ops.stream_pillars import PillarStream

    z = on_card(torch.zeros(1, 64, dtype=torch.int32))
    f = on_card(torch.zeros(1, 64))
    return PillarStream(*(
        (f, f, f, f) if name == "cols" else z
        for name in PillarStream._fields))


def test_pfn_wrapper_raises_on_33_points():
    """The wrapper raises at no point a pillar; 33 to 128 are taken by
    the tiles, and more by the layered route beside them."""
    wts = [(torch.zeros(k, u, dtype=BF16), torch.zeros(u), torch.zeros(u))
           for k, u in PFN_DIMS]
    with pytest.raises(ValueError, match="at least 1 point"):
        kpfn.pfn(_pfn_stream(), wts, point_dim=4, with_distance=True,
                 grid_w=80, voxel_size=0.25, x0=-10, y0=-10,
                 max_points_per_pillar=0, out_dtype=BF16)
    for k in (33, 129, 4096):
        assert kpfn.pfn_refusal(k, PFN_DIMS, 10, BF16, BF16) is None


def _decoder_inputs(cfg, seed):
    """(decoder, mask features, memories) at ``cfg``'s shapes, batch 1."""
    model = MaskBev(cfg)
    model.load_state_dict(model.random_state_dict(seed))
    dec = model.decoder
    g = torch.Generator().manual_seed(seed)
    c = cfg.head_feat_channels
    h, w = cfg.grid_hw
    s = model.backbone.stride
    hws = [(-(-h // s), -(-w // s))]
    for _ in range(len(model.backbone.depths) - 1):
        hws.append(((hws[-1][0] + 1) // 2, (hws[-1][1] + 1) // 2))
    feats = torch.randn(1, h // 4, w // 4, cfg.head_out_channels,
                        generator=g)
    mems = [torch.randn(1, hh, ww, c, generator=g)
            for hh, ww in (hws[3], hws[2], hws[1])]
    return dec, feats, mems


@pytest.mark.parametrize("make,dtype,heads,q", [
    (tiny_test_config, F32, 8, 8),
    (semantic_kitti_default, BF16, 8, 45),
], ids=["tiny-8-heads", "flagship"])
def test_decoder_takes_the_kernel_on_the_card(monkeypatch, make, dtype,
                                              heads, q):
    """A CUDA ``final_only`` call goes to the decoder-stack kernel, with
    the shapes its rule takes (at the tiny config's head width 8, too)."""
    dec, feats, mems = _decoder_inputs(make(), 4)
    dec = dec.to(dtype)
    picked = []

    class Picked(Exception):
        pass

    def kernel(out0, emb0, qpos, mems_, pes, feats_, layers, head, *,
               num_heads, **k):
        _, q_, c_ = out0.shape
        picked.append(((1, q_, c_), num_heads, kdec.decoder_stack_refusal(
            q_, c_, layers[0].f1.shape[1], num_heads, len(mems_),
            len(layers), max(m.shape[1] for m in mems_), dtype)))
        raise Picked

    monkeypatch.setattr(m2f, "decoder_stack", kernel)
    with torch.no_grad(), pytest.raises(Picked):
        dec(on_card(feats.to(dtype)), [on_card(m.to(dtype)) for m in mems])
    assert picked == [((1, q, dec.query_feat.shape[1]), heads, None)]


def test_cpu_calls_launch_nothing():
    """On the CPU every wrapper runs its plain version: the tiny model's
    forward, decoder included, counts no launch."""
    cfg = tiny_test_config()
    model = MaskBev(cfg)
    model.load_state_dict(model.random_state_dict(5))
    rng = np.random.default_rng(5)
    pts = rng.uniform(-9, 9, (1, cfg.max_points_per_scan, 4)).astype(
        np.float32)
    kb.reset_launches()
    with torch.no_grad():
        model(torch.as_tensor(pts),
              torch.ones(1, cfg.max_points_per_scan, dtype=torch.bool))
    assert not any(kb.LAUNCHES.values()) and not kb.INSTANCES


# ---- on the card (marked cuda; skipped without one) -------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's CUDA kernels (nvcc, sm_90a) "
                    "run only on a card")
    return torch.device("cuda")


def _points(seed, b, n):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-9.9, 9.9, (b, n)),
                    rng.uniform(-9.9, 9.9, (b, n)),
                    rng.uniform(-3, 3, (b, n)), rng.uniform(0, 1, (b, n))],
                   -1).astype(np.float32)
    msk = np.ones((b, n), bool)
    msk[:, 1800:] = False
    return torch.as_tensor(pts), torch.as_tensor(msk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tiny_config_with_8_heads_serves_on_the_card(dev, dtype):
    """``tiny_test_config()`` with its own 8 heads (head width 8): every
    kernel launches, the decoder as its split instance, and the outputs
    agree with the CPU within the small model's tolerances (bf16 with int8
    products: class probs max diff 0.1, mask probs mean diff 0.02; f32:
    1e-3)."""
    from mask_bev_tpu_torch.inference import MaskBevPredictor

    cfg = tiny_test_config().replace(
        compute_dtype=dtype,
        backbone_quantize="int8" if dtype == "bfloat16" else "none")
    assert cfg.head_num_attn_heads == 8
    sd = MaskBev(cfg).random_state_dict(1)
    pts, msk = _points(2, 2, cfg.max_points_per_scan)
    kb.reset_launches()
    c_gpu, m_gpu = MaskBevPredictor(cfg, sd, device="cuda").forward(pts, msk)
    torch.cuda.synchronize()
    launches, inst = dict(kb.LAUNCHES), dict(kb.INSTANCES)
    c_cpu, m_cpu = MaskBevPredictor(cfg, sd, device="cpu").forward(pts, msk)
    split = "split_tc_f32" if dtype == "float32" else "split_tc_bf16"
    assert inst.get(f"decoder_stack/{split}") == 1, inst
    for k in ("stream_pfn", "canvas_norm", "swin_block", "decoder_stack"):
        assert launches[k] > 0, (k, launches)
    d_cls = float((c_gpu.cpu() - c_cpu).abs().max())
    d_mask = (m_gpu.cpu() - m_cpu).abs()
    if dtype == "bfloat16":
        assert d_cls <= 0.1 and float(d_mask.mean()) <= 0.02
    else:
        assert d_cls <= 1e-3 and float(d_mask.max()) <= 1e-3


def canvas_batch(b, h, w, c, n, seed=0):
    """(table, cells, num_pillars, mean, var, scale, bias) f32 CPU tensors
    for ``b`` samples, each with its own number of pillars."""
    rng = np.random.default_rng(seed)
    hw = h * w
    pillars = rng.integers(0, n + 1, b).astype(np.int32)
    cells = np.full((b, n), hw, np.int32)
    for s, p in enumerate(pillars):
        cells[s, :p] = np.sort(rng.choice(hw, p, replace=False))
    table = rng.standard_normal((b, n, c)).astype(np.float32)
    mean = rng.normal(0.0, 0.3, b).astype(np.float32)
    var = rng.uniform(0.5, 2.0, b).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal((h, w, c))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((h, w, c))).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (
        table, cells, pillars, mean, var, scale, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_canvas_at_184_samples_on_the_card(dev, dtype):
    """Kernel 2 at B = 184: two launches of 92 samples; bf16 bit for bit
    the plain version over every sample, f32 within its canvas tolerance
    (1e-5 of the largest value); and bit for bit what the kernel gives each
    sample in a launch of another chunking (each sample's arithmetic is
    its own)."""
    table, cells, pillars, mean, var, scale, bias = (
        t.to(dev) for t in canvas_batch(184, 48, 40, 128, 700))
    table, scale, bias = (t.to(dtype) for t in (table, scale, bias))
    args = (mean, var, scale, bias, (48, 40))
    kb.reset_launches()
    got = kcanvas.canvas_norm(table, cells, pillars, *args)
    torch.cuda.synchronize()
    inst = "bf16" if dtype == BF16 else "f32"
    assert kb.INSTANCES == {f"canvas_norm/{inst}": 2}
    want = kcanvas.canvas_norm_plain(table, cells, *args)
    rel = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    if dtype == BF16:
        assert torch.equal(got, want)
    assert rel <= 1e-5
    tail = kcanvas.canvas_norm(table[100:], cells[100:], pillars[100:],
                               mean[100:], var[100:], scale, bias, (48, 40))
    assert torch.equal(got[100:], tail)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("q,c,heads,f,hws", [
    (8, 64, 8, 128, [(3, 3), (5, 5), (10, 10)]),      # tiny: head width 8
    (45, 128, 8, 512, [(8, 8), (16, 16), (32, 31)]),  # head width 16
], ids=["hd8", "hd16"])
def test_decoder_split_small_head_widths(dev, dtype, q, c, heads, f, hws):
    """The split instance at head widths 8 and 16, held as
    ``test_torch_port_f32_kernels.py::test_decoder_split`` holds the
    shipped widths: mask-bit flips against the plain version's decisions
    (at most 1e-4 in layer 0, 5 % after), on the kernel's own decisions at
    most 1 %, and the output against the plain version on the kernel's
    decisions (bf16 2e-2, f32 1e-3 relative)."""
    from test_torch_port_f32_kernels import _rel
    from test_torch_port_kernels import _decoder_inputs as inputs

    args = inputs(dev, dtype, q, c, heads, f, hws, n_layers=3)
    assert not kdec.flagship_takes(q, c, f, heads, 3, 3,
                                   max(h * w for h, w in hws), dtype)
    kb.reset_launches()
    got, bits = kdec.decoder_stack(*args, num_heads=heads, return_bits=True)
    torch.cuda.synchronize()
    inst = "split_tc_f32" if dtype == F32 else "split_tc_bf16"
    assert kb.INSTANCES[f"decoder_stack/{inst}"] == 1
    assert got.dtype == dtype and got.shape == (2, q, c)
    _, logits = kdec.decoder_stack_plain(*args, num_heads=heads,
                                         return_logits=True)
    flips = [int((kb_ != kdec.blocked_positions(m)).sum())
             for kb_, m in zip(bits, logits)]
    same, same_logits = kdec.decoder_stack_plain(
        *args, num_heads=heads, blocked=bits, return_logits=True)
    own = [int((kb_ != kdec.blocked_positions(m)).sum())
           for kb_, m in zip(bits, same_logits)]
    print(f"decoder split {inst} hd {c // heads}: flips per layer {flips}, "
          f"on its own decisions {own}, of {[m.numel() for m in logits]}")
    assert flips[0] <= 1e-4 * logits[0].numel()
    for li, m in enumerate(logits):
        assert flips[li] <= 0.05 * m.numel(), (li, flips)
        assert own[li] <= 0.01 * m.numel(), (li, own)
    assert _rel(got, same) <= (2e-2 if dtype == BF16 else 1e-3)


# ---- the wider shapes on the card: each new instance against its plain
# ---- version (marked cuda; skipped without one) ------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("e", [48, 96])
def test_patch_embed_new_widths_on_the_card(dev, dtype, e):
    """Kernel 8's instances at E = 48 (a narrow backbone) and 96 (Swin-T,
    Swin-S) on a ragged token grid (gw 70): bf16 within 1e-2 of the plain
    version's largest value, as the other widths; f32 (3xTF32) within
    1e-5 of a float64 product and LN."""
    from test_torch_port_f32_kernels import _patch_embed_f64
    from test_torch_port_kernels import _rel

    g = torch.Generator().manual_seed(23)
    b, h, w, c = 2, 40, 280, 128
    canvas = torch.randn(b, h, w, c, generator=g).to(dev, dtype)
    weight = (torch.randn(e, c, 4, 4, generator=g) / (16 * c) ** 0.5).to(
        dev, dtype)
    vecs = [(base + 0.1 * torch.randn(e, generator=g)).to(dev, dtype)
            for base in (0.0, 1.0, 0.0)]
    wm = kpe.embed_matrix(weight)
    kb.reset_launches()
    got = kpe.patch_embed(canvas, wm, *vecs, 4)
    torch.cuda.synchronize()
    assert kb.INSTANCES == {
        "patch_embed/" + ("f32" if dtype == F32 else "bf16"): 1}
    assert got.shape == (b, (h // 4) * (w // 4), e) and got.dtype == dtype
    if dtype == BF16:
        assert _rel(got, kpe.patch_embed_plain(canvas, wm, *vecs, 4)) <= 1e-2
    else:
        assert _rel(got.double(), _patch_embed_f64(canvas, wm, *vecs,
                                                   4)) <= 1e-5


# a grid with pad tokens on both axes: 3 x 3 windows of 12, or of 16
LONG_GRID = {12: (30, 27), 16: (35, 33)}
# grids of 2 x 4 windows whose last row and column are mostly padding
RAGGED_GRID = {12: (13, 37), 16: (17, 50)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("msa", [False, True], ids=["swin", "msa"])
@pytest.mark.parametrize("win,shifted,grid", [
    (12, False, LONG_GRID), (12, True, LONG_GRID), (16, True, LONG_GRID),
    (12, True, RAGGED_GRID), (16, True, RAGGED_GRID),
    (16, False, RAGGED_GRID)],
    ids=lambda v: (("ragged" if v is RAGGED_GRID else "long")
                   if isinstance(v, dict) else None))
def test_window_attention_long_windows_on_the_card(dev, dtype, msa, win,
                                                   shifted, grid):
    """The attention template's long-window kernel (144 and 256 tokens: key
    chunks of 64 with a running max and sum, the bias from the head's
    compact table in shared memory), Swin and MSA variants, C 64 over 2
    heads, shifted and not, on grids that are not whole windows: bf16
    within 1e-2 of the plain version's largest value (the flagship's
    tolerance); f32 within 1e-4 of the plain version and 1e-5 of a float64
    attention."""
    from test_torch_port_kernels import _attention_f64, _block_weights, _rel

    c, heads, b = 64, 2, 2
    hw = grid[win]
    p = _block_weights(dev, c, heads, win, False, seed=31, dtype=dtype)
    g = torch.Generator().manual_seed(32)
    qkv = torch.randn(b * hw[0] * hw[1], 3 * c, generator=g).to(dev, dtype)
    shift = kswin.effective_shift(hw, win, shifted)
    name = "window_msa" if msa else "swin_block"
    a = (qkv, p.qkv.bias, p.rel_bias, b, hw, heads, win, shift)
    kb.reset_launches()
    got = kswin.attention(name, *a, msa=msa)
    torch.cuda.synchronize()
    inst = kswin.attn_instance(dtype == F32, win)
    assert inst.endswith("_long") and kb.INSTANCES == {f"{name}/{inst}": 1}
    want = kswin.window_attention_plain(*a, msa=msa)
    if dtype == BF16:
        assert _rel(got, want) <= 1e-2
    else:
        exact = _attention_f64(*a, msa=msa)
        print(f"long window {win} f32 msa={msa}: to the plain f32 "
              f"{_rel(got, want):.3g}, to float64 "
              f"{_rel(got.double(), exact):.3g}")
        assert _rel(got, want) <= 1e-4
        assert _rel(got.double(), exact) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("win", [12, 16])
def test_swin_chain_long_windows_on_the_card(dev, quant, win):
    """Kernels 3/4 (the whole block) at windows 12 and 16, shifted, bf16
    with and without int8 products: within 2e-2 of the plain chain, as at
    window 10."""
    from test_torch_port_kernels import _block_weights, _rel

    c, heads, hw = 64, 2, LONG_GRID[win]
    p = _block_weights(dev, c, heads, win, quant, seed=33)
    g = torch.Generator().manual_seed(34)
    x = torch.randn(2, hw[0] * hw[1], c, generator=g).to(dev, BF16)
    shift = kswin.effective_shift(hw, win, True)
    kb.reset_launches()
    got = kswin.swin_block(x, p, hw, win, heads, shift, quant)
    torch.cuda.synchronize()
    assert kb.INSTANCES["swin_block/attn_bf16_long"] == 1
    want = kswin.swin_block_plain(x, p, hw, win, heads, shift, quant)
    assert _rel(got, want) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("win", [12, 16])
def test_window_msa_long_windows_on_the_card(dev, dtype, win):
    """Kernel 7 (the window MSA on the token grid) at windows 12 and 16,
    shifted: within 2e-2 (bf16) or 1e-4 (f32) of its plain version."""
    from test_torch_port_kernels import _block_weights, _rel

    c, heads, hw = 64, 2, LONG_GRID[win]
    p = _block_weights(dev, c, heads, win, False, seed=35, dtype=dtype)
    g = torch.Generator().manual_seed(36)
    y = torch.randn(2, hw[0] * hw[1], c, generator=g).to(dev, dtype)
    shift = kswin.effective_shift(hw, win, True)
    args = (y, hw, win, shift, p.rel_bias, p.qkv, p.proj, heads)
    kb.reset_launches()
    got = kwmsa.window_msa(*args)
    torch.cuda.synchronize()
    inst = kswin.attn_instance(dtype == F32, win)
    assert kb.INSTANCES[f"window_msa/{inst}"] == 1
    want = kwmsa.window_msa_grid_plain(*args)
    assert _rel(got, want) <= (2e-2 if dtype == BF16 else 1e-4)


def long_pillar_points(seed, b=2, n=8192):
    """Scans with long pillars (cells of 0.25 m): sample 0 a dense patch of
    3000 points over 0.75 m x 0.75 m (~330 a pillar), sample 1 one of 200
    points over 0.5 m x 0.5 m (~50 a pillar) beside one of 900 over 0.5 m
    (~225), over a uniform spread (1-3 points a pillar); sample 1 partly
    masked."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-9.9, 9.9, (b, n, 4)).astype(np.float32)
    pts[:, :, 2] = rng.uniform(-3, 3, (b, n))
    pts[0, :3000, :2] = 1.1 + rng.uniform(0, 0.75, (3000, 2))
    pts[1, :200, :2] = -4.0 + rng.uniform(0, 0.5, (200, 2))
    pts[1, 200:1100, :2] = 5.1 + rng.uniform(0, 0.5, (900, 2))
    msk = np.ones((b, n), bool)
    msk[1, 6000:] = False
    return pts, msk


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("k", [64, 100, 128])
def test_pfn_long_pillars_on_the_card(dev, dtype, k):
    """Kernel 1's instance of 12 m16 tiles (33 to 128 points a pillar) on
    pillars of up to K kept points: bf16 within 2^-7 of the plain
    version's largest value and its statistics within 1e-3 (the flagship
    instance's tolerances); f32 within 1e-5 of the same layers in
    float64, statistics too."""
    from test_torch_port_f32_kernels import _pfn_weights
    from test_torch_port_kernels import GEO, W, _rel
    from mask_bev_tpu_torch.ops.stream_pillars import pillarize_stream_packed

    pts, msk = long_pillar_points(40)
    ps = pillarize_stream_packed(
        torch.as_tensor(pts, device=dev).to(dtype),
        torch.as_tensor(msk, device=dev), max_points_per_pillar=k, **GEO)
    assert int(ps.counts.max()) == k and int((ps.counts > 32).sum()) >= 8
    wts = _pfn_weights(dev, dtype, 10)
    kw = dict(point_dim=4, with_distance=True, grid_w=W,
              voxel_size=GEO["voxel_size"], x0=GEO["x_range"][0],
              y0=GEO["y_range"][0])
    kb.reset_launches()
    table, stats = kpfn.pfn(ps, wts, max_points_per_pillar=k,
                            out_dtype=dtype, **kw)
    torch.cuda.synchronize()
    assert kb.INSTANCES == {f"pfn/{kpfn.instance(dtype == F32, k)}": 2}
    want, wstats = kpfn.pfn_plain(
        ps, wts, out_dtype=torch.float64 if dtype == F32 else dtype, **kw)
    err = max(_rel(table[s, :int(ps.num_pillars[s])].double(),
                   want[s, :int(ps.num_pillars[s])].double())
              for s in range(2))
    st_err = float(((stats.double() - wstats.double())
                    / wstats.double().abs()).abs().max())
    print(f"pfn {dtype} k={k}: {err:.3g}, statistics {st_err:.3g}")
    assert err <= (2 ** -7 if dtype == BF16 else 1e-5)
    assert st_err <= (1e-3 if dtype == BF16 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("k,cap", [(64, 256), (128, 8192)])
def test_stream_pfn_long_pillars_on_the_card(dev, dtype, k, cap):
    """Kernel 10's instance of 12 m16 tiles on a capped stream of long
    pillars, the cap binding (256) or not (8192): within 1e-2 (bf16) or
    1e-5 of float64 (f32) of the largest value, as at 32 points."""
    from test_torch_port_f32_kernels import _pfn_weights
    from test_torch_port_kernels import GEO, W, _rel
    from mask_bev_tpu_torch.ops.stream_pillars import pillarize_stream

    pts, msk = long_pillar_points(41)
    sp = pillarize_stream(torch.as_tensor(pts, device=dev).to(dtype),
                          torch.as_tensor(msk, device=dev),
                          max_points_per_pillar=k, max_pillars=cap, **GEO)
    nv = sp.valid.sum(1).to(torch.int32)
    wts = _pfn_weights(dev, dtype, 10)
    kw = dict(k=k, with_distance=True, grid_w=W,
              voxel_size=GEO["voxel_size"], x0=GEO["x_range"][0],
              y0=GEO["y_range"][0])
    kb.reset_launches()
    table, stats = kpfn.stream_pfn(sp, wts, num_valid=nv, out_dtype=dtype,
                                   **kw)
    torch.cuda.synchronize()
    assert kb.INSTANCES == {
        f"stream_pfn/{kpfn.instance(dtype == F32, k)}": 2}
    want, _ = kpfn.stream_pfn_plain(
        sp, wts, out_dtype=torch.float64 if dtype == F32 else dtype, **kw)
    assert table.shape == (2, cap, 128)
    assert _rel(table.double(), want.double()) <= (
        1e-2 if dtype == BF16 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("q,heads", [(300, 8), (512, 8), (45, 1), (45, 16),
                                     (45, 32)],
                         ids=["q300", "q512", "heads1", "heads16",
                              "heads32"])
def test_decoder_split_wide_on_the_card(dev, dtype, q, heads):
    """The split instance at C 256 in clusters of 16 (Q = 300 and 512; Q =
    512 in two sweeps over chunks of the self-attention's keys), with one
    head (its columns split over the warps) and in rounds of 8 heads (16,
    32), held as ``test_decoder_split_small_head_widths`` holds the
    shipped widths."""
    from test_torch_port_f32_kernels import _rel
    from test_torch_port_kernels import _decoder_inputs as inputs

    c, f, hws = 256, 512, [(8, 8), (16, 16), (32, 31)]
    t_max = 32 * 31
    assert kdec.decoder_stack_refusal(q, c, f, heads, 3, 3, t_max,
                                      dtype) is None
    args = inputs(dev, dtype, q, c, heads, f, hws, n_layers=3)
    kb.reset_launches()
    got, bits = kdec.decoder_stack(*args, num_heads=heads, return_bits=True)
    torch.cuda.synchronize()
    inst = kdec.split_instance(q, heads, dtype == F32)
    assert kb.INSTANCES[f"decoder_stack/{inst}"] == 1, kb.INSTANCES
    assert got.dtype == dtype and got.shape == (2, q, c)
    _, logits = kdec.decoder_stack_plain(*args, num_heads=heads,
                                         return_logits=True)
    flips = [int((kb_ != kdec.blocked_positions(m)).sum())
             for kb_, m in zip(bits, logits)]
    same, same_logits = kdec.decoder_stack_plain(
        *args, num_heads=heads, blocked=bits, return_logits=True)
    own = [int((kb_ != kdec.blocked_positions(m)).sum())
           for kb_, m in zip(bits, same_logits)]
    print(f"decoder split {inst} q {q} heads {heads}: flips per layer "
          f"{flips}, on its own decisions {own}, of "
          f"{[m.numel() for m in logits]}, {_rel(got, same):.3g}")
    assert flips[0] <= 1e-4 * logits[0].numel()
    for li, m in enumerate(logits):
        assert flips[li] <= 0.05 * m.numel(), (li, flips)
        assert own[li] <= 0.01 * m.numel(), (li, own)
    assert _rel(got, same) <= (2e-2 if dtype == BF16 else 1e-3)


# ---- the last shape gaps on the card: any C, K, N, head widths 8-64 --------


def _rel_err(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp(min=1e-30))


def _affine(c, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return ((1 + 0.1 * torch.randn(c, generator=g)).to(dev, dtype),
            (0.1 * torch.randn(c, generator=g)).to(dev, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("c", [3, 12, 100, 2056, 3072, 4096])
def test_layer_norm_any_width_on_the_card(dev, dtype, c):
    """Kernel 9 at widths the register tiles do not take: the walk (C % 8
    != 0: rows at 6- and 24-byte steps in bf16) and the wide instance
    (2048 < C <= 4096, the row held in registers): within 1e-2 (bf16) or
    1e-4 (f32) of the plain version, as the tiles are."""
    g = torch.Generator().manual_seed(c)
    x = (0.5 + torch.randn(2, 37, c, generator=g)).to(dev, dtype)
    w, b = _affine(c, dtype, dev, c + 1)
    kb.reset_launches()
    got = kln.layer_norm(x, w, b)
    want = kln.layer_norm_plain(x, w, b)
    torch.cuda.synchronize()
    inst = ("bf16" if dtype == BF16 else "f32") + kln.instance_suffix(c)
    assert kb.INSTANCES == {f"layer_norm/{inst}": 1}
    assert _rel_err(got, want) <= (1e-2 if dtype == BF16 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("c", [72, 120, 2056, 3072])
def test_swin_layernorm_walk_on_the_card(dev, dtype, c):
    """The Swin LN at rows the register tile does not hold (C > 2048) and
    int8 rows at a padded pitch (C % 16 == 8): the normalised rows within
    1e-2 (bf16) or 1e-5 (f32) of ``layer_norm_p``; the int8 rows and scales
    bit for bit the plain quantisation of the LN launch's own output, at
    the GEMM's pitch with zero padding."""
    g = torch.Generator().manual_seed(c)
    x = (0.5 + torch.randn(301, c, generator=g)).to(dev, dtype)
    w, b = _affine(c, dtype, dev, c + 2)
    kb.reset_launches()
    y = kswin._ln(x, w, b, False)
    q8, sx = kswin._ln(x, w, b, True)
    torch.cuda.synchronize()
    f32 = dtype == F32
    want_inst = {}
    for quant in (False, True):
        key = f"swin_block/{kswin.ln_instance(c, f32, quant)}"
        want_inst[key] = want_inst.get(key, 0) + 1
    assert kb.INSTANCES == want_inst
    assert _rel_err(y, kswin.layer_norm_p(x, w, b)) <= (1e-5 if f32 else 1e-2)
    q, s = kswin.quant_rows(y)
    pitch = kswin.row_pitch(c, 1)
    assert q8.stride(0) == pitch and q8.shape == (301, c)
    assert torch.equal(q8.float(), q) and torch.equal(sx, s.reshape(-1))
    full = torch.as_strided(q8, (301, pitch), (pitch, 1))
    assert not bool(full[:, c:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("k", [72, 120, 100])
def test_quant_rows_walk_on_the_card(dev, dtype, k):
    """int8 rows at the GEMM's pitch (K % 16 != 0; K = 100: a partial last
    word): bit for bit the plain quantisation."""
    g = torch.Generator().manual_seed(k)
    x = torch.randn(333, k, generator=g).to(dev, dtype)
    kb.reset_launches()
    q8, sx = kswin._quant(x)
    torch.cuda.synchronize()
    inst = "bf16" if dtype == BF16 else "f32"
    assert kb.INSTANCES == {f"swin_block/{inst}_walk": 1}
    q, s = kswin.quant_rows(x)
    assert q8.stride(0) == kswin.row_pitch(k, 1)
    assert torch.equal(q8.float(), q) and torch.equal(sx, s.reshape(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("mode", [kswin.EPI_BIAS, kswin.EPI_GELU,
                                  kswin.EPI_RESIDUAL])
@pytest.mark.parametrize("m,n,k", [
    (333, 100, 24), (333, 100, 40),  # the held shapes: N % 8 != 0
    (1000, 216, 72), (777, 360, 120),  # .hd8 / .hd40 stage-0 qkv
    (65, 7, 13),                       # every tail at once
])
def test_gemm_any_k_n_on_the_card(dev, kind, mode, m, n, k):
    """The GEMM at any K (operands at ``row_pitch``, the k past K read as
    zeros) and N (the N-tail instance), held as ``test_gemm_kernel`` and
    ``test_gemm_f32`` hold the flagship instances: int8 equal to a float64
    product and the same f32 epilogue (GELU within one bf16 step); bf16
    within 2^-7 of the XLA-order epilogue; 3xTF32 within 1e-5 of a float64
    product."""
    _hold_gemm(dev, kind, mode, m, n, k)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("mode", [kswin.EPI_BIAS, kswin.EPI_GELU,
                                  kswin.EPI_RESIDUAL])
@pytest.mark.parametrize("k", [24, 40])
@pytest.mark.parametrize("n", [4, 12, 100, 260])
def test_gemm_n_tail_on_the_card(dev, kind, mode, k, n):
    """The N-tail instances (``csrc/gemm_ntail.cu``: tiles fitted to N, the
    output and residual staged and moved in 16-byte words) at one tile of
    8, 16 and 104 columns and three of 88 (``gemm_tile_plan``), 1000 rows
    (a part tile), K 24 and 40, every epilogue and operand kind, held as
    ``test_gemm_any_k_n_on_the_card`` holds them (``chip_smoke.py``'s
    tolerances: 2^-7 relative in bf16, 1e-5 in 3xTF32, int8 exact)."""
    _hold_gemm(dev, kind, mode, 1000, n, k)


def _hold_gemm(dev, kind, mode, m, n, k):
    g = torch.Generator().manual_seed(m + n + k)
    a32 = torch.randn(m, k, generator=g)
    w32 = torch.randn(n, k, generator=g) / k ** 0.5
    bias = (0.1 * torch.randn(n, generator=g)).to(dev)
    dt = F32 if kind == "f32" else BF16
    res = torch.randn(m, n, generator=g).to(dev, dt)
    residual = res if mode == kswin.EPI_RESIDUAL else None
    d = kswin.make_dense(w32.to(dev, dt), bias, kind == "int8")
    kb.reset_launches()
    if kind == "int8":
        q, sx = kswin.quant_rows(a32.to(dev, BF16))
        a8 = kswin.pitched(q.to(torch.int8))
        sx = sx.reshape(-1).contiguous()
        got = kswin.gemm("swin_block", a8, d, mode, residual=residual, sx=sx)
        v = ((a8.double() @ d.q8.double().t()).float() * sx[:, None]
             * d.sw[None] + d.bias)
    elif kind == "bf16":
        mode = mode | kswin.EPI_ROUND_ACC
        a = kswin.pitched(a32.to(dev, BF16))
        got = kswin.gemm("swin_block", a, d, mode, residual=residual)
        v = (a.float() @ d.wt.float().t()).to(BF16).float() + d.bias
    else:
        a = kswin.pitched(a32.to(dev))
        got = kswin.gemm("swin_block", a, d, mode, residual=residual)
        v = (a.double() @ w32.to(dev).double().t()).float() + d.bias
    if kind != "f32":
        v = v.to(BF16).float()
    if mode & 15 == kswin.EPI_GELU:
        v = torch.nn.functional.gelu(v, approximate="none")
    elif mode & 15 == kswin.EPI_RESIDUAL:
        v = res.float() + v
    want = v.to(dt)
    torch.cuda.synchronize()
    tail = "" if n % 8 == 0 else "_ntail"
    inst = {"int8": "gemm_s8_bf16", "bf16": "gemm_bf16",
            "f32": "gemm_f32_3xtf32"}[kind] + tail
    assert kb.INSTANCES == {f"swin_block/{inst}": 1}
    assert got.shape == (m, n) and got.dtype == dt
    if kind == "int8" and mode & 15 != kswin.EPI_GELU:
        assert torch.equal(got, want)
    elif kind == "int8":
        step = want.float().abs().clamp(min=2 ** -126) * 2 ** -7
        assert bool(((got.float() - want.float()).abs() <= step).all())
    else:
        assert _rel_err(got, want) <= (2 ** -7 if kind == "bf16" else 1e-5)


def _attn_inputs(dev, dtype, c, heads, win, b, hw, seed):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b * hw[0] * hw[1], 3 * c, generator=g).to(dev, dtype)
    qkv_bias = (0.1 * torch.randn(3 * c, generator=g)).to(dev)
    table = (0.02 * torch.randn((2 * win - 1) ** 2, heads, generator=g)).to(
        dev, dtype)
    return qkv, qkv_bias, kswin.rel_bias_from_table(table, win)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("msa", [False, True], ids=["swin", "msa"])
@pytest.mark.parametrize("hd", [8, 24, 40, 48, 56])
@pytest.mark.parametrize("win", [10, 12])
def test_window_attention_head_widths_on_the_card(dev, dtype, msa, hd, win):
    """The attention at the head widths outside the flagship instances
    (window 10: the head-width kernel, rows at the exact width; window 12:
    the long-window kernel, rows staged at 16, 32 or 64 with zero columns),
    shifted, with pad tokens: within 1e-2 (bf16) or 1e-5 (f32) of the plain
    version, as the flagship widths are held."""
    heads, b, hw = 3, 2, (23, 27)
    c = heads * hd
    qkv, qkv_bias, rel = _attn_inputs(dev, dtype, c, heads, win, b, hw,
                                      hd + win)
    shift = kswin.effective_shift(hw, win, True)
    name = "window_msa" if msa else "swin_block"
    kb.reset_launches()
    got = kswin.attention(name, qkv, qkv_bias, rel, b, hw, heads, win, shift,
                          msa)
    torch.cuda.synchronize()
    want = kswin.window_attention_plain(qkv.double() if dtype == F32 else qkv,
                                        qkv_bias.double(), rel, b, hw, heads,
                                        win, shift, msa)
    assert kb.INSTANCES == {
        f"{name}/{kswin.attn_instance(dtype == F32, win, hd)}": 1}
    assert _rel_err(got, want) <= (1e-5 if dtype == F32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("c,heads,hw", [
    (72, 9, (23, 27)),    # .hd8 stage 0: head width 8, int8 K = 72
    (120, 3, (23, 27)),   # .hd40 stage 0: head width 40, K = 120
    (3072, 48, (5, 4)),   # .e384 stage 3: the LN walk at C 3072
])
def test_swin_chain_new_widths_on_the_card(dev, quant, c, heads, hw):
    """Whole Swin blocks at the new widths against the plain block (bf16,
    within 2e-2 as ``test_swin_block_kernel``): every launch takes it."""
    from test_torch_port_kernels import _block_weights

    win = 10
    p = _block_weights(dev, c, heads, win, quant, seed=c)
    g = torch.Generator().manual_seed(c + 1)
    x = torch.randn(2, hw[0] * hw[1], c, generator=g).to(dev, BF16)
    shift = kswin.effective_shift(hw, win, True)
    got = kswin.swin_block(x, p, hw, win, heads, shift, quant)
    want = kswin.swin_block_plain(x, p, hw, win, heads, shift, quant)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_window_msa_head_width_8_on_the_card(dev, dtype):
    """Kernel 7 at head width 8 (C 64 over 8 heads, the tiny config's
    refinement width) against its plain version: 2e-2 (bf16), 1e-5 (f32)."""
    c, heads, win, hw = 64, 8, 10, (23, 27)
    g = torch.Generator().manual_seed(8)
    y = torch.randn(2, hw[0] * hw[1], c, generator=g).to(dev, dtype)
    qkv = kswin.make_dense((torch.randn(3 * c, c, generator=g) / 8).to(
        dev, dtype), (0.02 * torch.randn(3 * c, generator=g)).to(dev), False)
    proj = kswin.make_dense((torch.randn(c, c, generator=g) / 8).to(
        dev, dtype), (0.02 * torch.randn(c, generator=g)).to(dev), False)
    table = (0.02 * torch.randn((2 * win - 1) ** 2, heads, generator=g)).to(
        dev, dtype)
    rel = kswin.rel_bias_from_table(table, win)
    shift = kswin.effective_shift(hw, win, True)
    kb.reset_launches()
    got = kwmsa.window_msa(y, hw, win, shift, rel, qkv, proj, heads)
    torch.cuda.synchronize()
    want = kwmsa.window_msa_grid_plain(y, hw, win, shift, rel, qkv, proj,
                                       heads)
    assert kb.INSTANCES[
        "window_msa/" + kswin.attn_instance(dtype == F32, win, 8)] == 1
    assert _rel_err(got, want) <= (1e-5 if dtype == F32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c,wb", [(BF16, 100, 8), (F32, 101, 4),
                                        (BF16, 12, 8), (BF16, 3, 2)])
def test_canvas_any_width_on_the_card(dev, dtype, c, wb):
    """Kernel 2 at table rows of any width (its narrow instances: words
    of ``wb`` bytes): bf16 bit for bit the plain version, f32 within 1e-5
    of its largest value, both affine modes."""
    table, cells, pillars, mean, var, scale, bias = (
        t.to(dev) for t in canvas_batch(3, 48, 40, c, 700, seed=c))
    table, scale, bias = (t.to(dtype) for t in (table, scale, bias))
    name = "bf16" if dtype == BF16 else "f32"
    for sc, bi in ((scale, bias), (scale[0, 0], bias[0, 0])):
        kb.reset_launches()
        got = kcanvas.canvas_norm(table, cells, pillars, mean, var, sc, bi,
                                  (48, 40))
        torch.cuda.synchronize()
        assert kb.INSTANCES == {f"canvas_norm/{name}_w{wb}": 1}
        want = kcanvas.canvas_norm_plain(table, cells, mean, var, sc, bi,
                                         (48, 40))
        if dtype == BF16:
            assert torch.equal(got, want)
        assert _rel_err(got, want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c", [(BF16, 100), (F32, 101), (BF16, 7),
                                     (F32, 128)])
def test_canvas_scatter_any_width_on_the_card(dev, dtype, c):
    """Kernels A and B at rows of any width (and at a table that starts
    one value past a 16-byte step): exact, as the 16-byte kernels are."""
    table, cells, *_ = (t.to(dev) for t in canvas_batch(2, 40, 36, c, 500,
                                                        seed=c))
    flat = torch.zeros(table.numel() + 1, device=dev, dtype=dtype)
    flat[1:] = table.flatten()
    table = flat[1:].view(table.shape)  # one value past a 16-byte step
    kb.reset_launches()
    got = kcanvas.canvas_scatter_forward(table, cells, (40, 36))
    torch.cuda.synchronize()
    assert torch.equal(got, kcanvas.canvas_scatter_plain(table, cells,
                                                         (40, 36)))
    g = torch.Generator().manual_seed(c)
    d = torch.randn(2, 40, 36, c, generator=g).to(dev, dtype)
    back = kcanvas.canvas_scatter_backward(d, cells, (40, 36))
    torch.cuda.synchronize()
    assert torch.equal(back, kcanvas.canvas_gather_plain(d, cells, (40, 36)))
    assert kb.LAUNCHES["canvas_scatter"] == 1
    assert kb.LAUNCHES["canvas_scatter_bwd"] == 1


@pytest.mark.cuda
def test_every_taken_shape_launches(dev):
    """The rules and the kernels agree: every shape of a grid that a rule
    takes launches (kernel 9, the Swin LN with and without int8, the GEMM,
    the attention), and each rule refuses what it names."""
    for c in (1, 7, 8, 12, 100, 2048, 2056, 3072, 4096):
        for dt in (BF16, F32):
            assert kln.layer_norm_refusal(c, dt) is None
            w, b = _affine(c, dt, dev, c)
            kln.layer_norm(torch.ones(5, c, device=dev, dtype=dt), w, b)
    for c in (8, 16, 24, 72, 2048, 2056, 3072, 4096):
        w, b = _affine(c, BF16, dev, c)
        for quant in (False, True):
            kswin._ln(torch.randn(9, c, device=dev, dtype=BF16), w, b, quant)
        kswin._quant(torch.randn(9, c, device=dev, dtype=BF16))
    for k, n in ((8, 8), (16, 3), (24, 100), (136, 9), (1, 1)):
        assert kswin.gemm_refusal(k, n) is None
        d = kswin.make_dense(torch.randn(n, k, device=dev, dtype=BF16),
                             torch.zeros(n, device=dev), True)
        q8 = kswin.pitched(torch.ones(7, k, device=dev, dtype=torch.int8))
        kswin.gemm("swin_block", q8, d, kswin.EPI_BIAS,
                   sx=torch.ones(7, device=dev))
    for hd in kswin.ATTN_HEAD_DIMS:
        for win in (7, 10, 12, 16):
            for dt in (BF16, F32):
                assert kswin.attn_refusal("x", 2 * hd, 2, win) is None
                qkv, qb, rel = _attn_inputs(dev, dt, 2 * hd, 2, win, 1,
                                            (win, win + 3), hd)
                kswin.attention("swin_block", qkv, qb, rel, 1, (win, win + 3),
                                2, win, 0, False)
    torch.cuda.synchronize()
    assert kswin.attn_refusal("x", 528, 2, 10)  # head width 264
    assert kswin.attn_refusal("x", 96, 2, 33)  # 1089 tokens
