"""The f32 instances of the serving kernels, the rebuilt PFN kernels and the
decoder stack's split-query instance, against their plain versions on the
card.

Marked ``cuda``; each test skips, from a fixture, where there is no CUDA
device. Run on the card with
``python -m pytest -m cuda tests/test_torch_port_f32_kernels.py``.

Tolerances, relative to the plain result's largest magnitude:

* f32 instances: 1e-4 where both sides take the same f32 operations in
  another order (no operand is rounded below f32); the window attention,
  kernel 7 and the patch embed also within 1e-5 of a float64
  computation; 2e-2 for the int8
  Swin block at f32 (int8 rounding boundaries move by a step between two
  f32 LayerNorms summed in another order, as in bf16);
* the rebuilt PFN in bf16: 2^-7 (two bf16 steps), with the count of rows
  that differ at all printed: the tensor cores sum each product in another
  order than the plain version, so a value can land one bf16 step away,
  and every layer rounds to bf16 again; the statistics within 1e-3; and
  bit for bit against sha256 digests its output had before the f32
  instance changed (the bf16 arithmetic did not);
* the PFN's f32 instance (3xTF32 on the tensor cores) also within 1e-5 of
  the same layers in float64, its statistics within 1e-5 relative;
* the split decoder: its ``m < 0`` decisions per layer within 5 %
  free-running and 1 % on its own decisions (PR 5's limits), its final
  queries on its own blocked positions within 2e-2 (bf16) or 1e-3 (f32);
* the tiny f32 model on the card against the CPU: 1e-3 absolute on the
  class and mask probabilities.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.inference import MaskBevPredictor  # noqa: E402
from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402
from mask_bev_tpu_torch.models.maskbev import MaskBev  # noqa: E402
from mask_bev_tpu_torch.ops import canvas as kcanvas  # noqa: E402
from mask_bev_tpu_torch.ops import decoder_stack as kdec  # noqa: E402
from mask_bev_tpu_torch.ops import layer_norm as kln  # noqa: E402
from mask_bev_tpu_torch.ops import patch_embed as kpe  # noqa: E402
from mask_bev_tpu_torch.ops import pfn as kpfn  # noqa: E402
from mask_bev_tpu_torch.ops import swin_block as kswin  # noqa: E402
from mask_bev_tpu_torch.ops import window_msa as kwmsa  # noqa: E402
from mask_bev_tpu_torch.ops.stream_pillars import (  # noqa: E402
    pillarize_stream, pillarize_stream_packed)
from test_torch_port_kernels import (  # noqa: E402
    _attention_f64, _block_weights, _decoder_inputs, _rel,
    _window_attention_plain)

pytestmark = pytest.mark.cuda

GEO = dict(x_range=(-10.0, 10.0), y_range=(-10.0, 10.0),
           z_range=(-4.0, 4.0), voxel_size=0.25)
H = W = 80
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's CUDA kernels (nvcc, sm_90a) "
                    "run only on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _points(seed, b=2, n=8192, d=4):
    """Ragged pillars: a dense patch (pillars of 32 and more points) over a
    uniform spread (1-3 points a pillar), one sample partly masked."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-9.9, 9.9, (b, n, 4)).astype(np.float32)
    pts[:, :, 2] = rng.uniform(-3, 3, (b, n))
    pts[0, :900, :2] = 1.1 + rng.uniform(0, 0.6, (900, 2))
    pts[1, :300, :2] = -4.0 + rng.uniform(0, 0.3, (300, 2))
    msk = np.ones((b, n), bool)
    msk[1, 6000:] = False
    return pts[..., :d], msk


def _pfn_weights(dev, dtype, d_in, seed=1):
    g = torch.Generator().manual_seed(seed)
    out = []
    for units in (64, 64, 128):
        w = torch.randn(d_in, units, generator=g) / d_in ** 0.5
        out.append((w.to(dev, dtype),
                    (1 + 0.1 * torch.randn(units, generator=g)).to(dev, dtype),
                    (0.1 * torch.randn(units, generator=g)).to(dev, dtype)))
        d_in = 2 * units
    return out


def _pfn_tol(dtype):
    return 2 ** -7 if dtype == torch.bfloat16 else 1e-4


def _slot_inputs(dev, dtype, d, dist):
    """Kernel 1's seeded inputs at d point columns, with or without the
    distance feature: (stream, weights, keyword arguments)."""
    pts, msk = _points(20 + d, d=d)
    ps = pillarize_stream_packed(
        torch.as_tensor(pts, device=dev).to(dtype),
        torch.as_tensor(msk, device=dev), max_points_per_pillar=32, **GEO)
    kw = dict(point_dim=d, with_distance=dist, grid_w=W,
              voxel_size=GEO["voxel_size"], x0=GEO["x_range"][0],
              y0=GEO["y_range"][0], out_dtype=dtype)
    return ps, _pfn_weights(dev, dtype, d + 5 + int(dist)), kw


def _capped_inputs(dev, dtype, cap, d):
    """Kernel 10's seeded inputs on a stream capped at ``cap`` slots:
    (stream, occupied slots, weights, keyword arguments)."""
    pts, msk = _points(30 + d, d=d)
    sp = pillarize_stream(torch.as_tensor(pts, device=dev).to(dtype),
                          torch.as_tensor(msk, device=dev),
                          max_points_per_pillar=32, max_pillars=cap, **GEO)
    nv = sp.valid.sum(1).to(torch.int32)
    kw = dict(k=32, with_distance=True, grid_w=W,
              voxel_size=GEO["voxel_size"], x0=GEO["x_range"][0],
              y0=GEO["y_range"][0], out_dtype=dtype)
    return sp, nv, _pfn_weights(dev, dtype, d + 6), kw


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,dist", [(4, True), (3, True), (4, False)])
def test_pfn_tiles(dev, dtype, d, dist):
    """Kernel 1 (the slot path) in both instances, 3 and 4 point columns,
    with and without the distance feature."""
    ps, wts, kw = _slot_inputs(dev, dtype, d, dist)
    occupied = (torch.arange(ps.counts.shape[1], device=dev)[None]
                < ps.num_pillars[:, None])
    assert int(ps.counts.max()) == 32
    assert int(ps.counts[occupied].min()) == 1
    kb.reset_launches()
    table, stats = kpfn.pfn(ps, wts, max_points_per_pillar=32, **kw)
    want, wstats = kpfn.pfn_plain(ps, wts, **kw)
    torch.cuda.synchronize()
    inst = kpfn.F32_INSTANCE if dtype == torch.float32 else "bf16"
    assert kb.LAUNCHES["pfn"] == 2 and kb.INSTANCES == {f"pfn/{inst}": 2}
    differ = 0
    for s in range(2):
        p = int(ps.num_pillars[s])
        assert table.dtype == dtype
        assert _rel(table[s, :p], want[s, :p]) <= _pfn_tol(dtype)
        differ += int((table[s, :p] != want[s, :p]).any(-1).sum())
    print(f"pfn {inst} d={d} distance={dist}: rows that differ {differ} of "
          f"{int(ps.num_pillars.sum())}")
    np.testing.assert_allclose(stats.cpu().numpy(), wstats.cpu().numpy(),
                               rtol=1e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cap,d", [(256, 4), (8192, 4), (8192, 3)])
def test_stream_pfn_tiles(dev, dtype, cap, d):
    """Kernel 10 on a capped stream in both instances: the cap binds (256)
    or not, 3 or 4 point columns; slots past the occupied ones are zero."""
    sp, nv, wts, kw = _capped_inputs(dev, dtype, cap, d)
    kb.reset_launches()
    table, stats = kpfn.stream_pfn(sp, wts, num_valid=nv, **kw)
    want, wstats = kpfn.stream_pfn_plain(sp, wts, **kw)
    torch.cuda.synchronize()
    inst = kpfn.F32_INSTANCE if dtype == torch.float32 else "bf16"
    assert kb.LAUNCHES["stream_pfn"] == 2
    assert kb.INSTANCES == {f"stream_pfn/{inst}": 2}
    assert table.shape == want.shape == (2, cap, 128)
    assert _rel(table, want) <= _pfn_tol(dtype)
    for s in range(2):
        assert not bool(table[s, int(nv[s]):].any())
    np.testing.assert_allclose(stats.cpu().numpy(), wstats.cpu().numpy(),
                               rtol=1e-3)


@pytest.mark.parametrize("d,dist", [(4, True), (3, True), (4, False),
                                    (3, False)])
def test_pfn_f32_against_float64(dev, d, dist):
    """Kernel 1's f32 instance (3xTF32 products) within 1e-5 of the same
    layers computed in float64, of the largest value; its statistics within
    1e-5 relative of the float64 table's."""
    ps, wts, kw = _slot_inputs(dev, torch.float32, d, dist)
    table, stats = kpfn.pfn(ps, wts, max_points_per_pillar=32, **kw)
    exact, estats = kpfn.pfn_plain(ps, wts, **{**kw, "out_dtype":
                                                torch.float64})
    torch.cuda.synchronize()
    err = 0.0
    for s in range(2):
        p = int(ps.num_pillars[s])
        err = max(err, _rel(table[s, :p].double(), exact[s, :p]))
    st_err = float(((stats.double() - estats) / estats.abs()).abs().max())
    print(f"pfn f32 d={d} distance={dist}: error relative to float64 "
          f"{err:.3g}, statistics {st_err:.3g}")
    assert err <= 1e-5 and st_err <= 1e-5


@pytest.mark.parametrize("cap,d", [(256, 4), (8192, 4), (256, 3),
                                   (8192, 3)])
def test_stream_pfn_f32_against_float64(dev, cap, d):
    """Kernel 10's f32 instance within 1e-5 of the float64 layers, with the
    cap binding (256 slots) or not."""
    sp, nv, wts, kw = _capped_inputs(dev, torch.float32, cap, d)
    table, stats = kpfn.stream_pfn(sp, wts, num_valid=nv, **kw)
    exact, estats = kpfn.stream_pfn_plain(
        sp, wts, **{**kw, "out_dtype": torch.float64})
    torch.cuda.synchronize()
    err = _rel(table.double(), exact)
    st_err = float(((stats.double() - estats) / estats.abs()).abs().max())
    print(f"stream pfn f32 cap={cap} d={d}: error relative to float64 "
          f"{err:.3g}, statistics {st_err:.3g}")
    assert err <= 1e-5 and st_err <= 1e-5


def pfn_bf16_digests(dev, key):
    """sha256 of the bf16 PFN's output on the seeded inputs of
    ``test_pfn_tiles`` (key ("pfn", d, distance): the occupied rows of each
    sample) or ``test_stream_pfn_tiles`` (("stream_pfn", cap, d): every
    slot), and of its statistics: (table digest, statistics digest)."""
    import hashlib

    if key[0] == "pfn":
        ps, wts, kw = _slot_inputs(dev, torch.bfloat16, key[1], key[2])
        table, stats = kpfn.pfn(ps, wts, max_points_per_pillar=32, **kw)
        rows = torch.cat([table[s, :int(ps.num_pillars[s])]
                          for s in range(table.shape[0])])
    else:
        sp, nv, wts, kw = _capped_inputs(dev, torch.bfloat16, key[1], key[2])
        table, stats = kpfn.stream_pfn(sp, wts, num_valid=nv, **kw)
        rows = table
    torch.cuda.synchronize()
    return (hashlib.sha256(rows.contiguous().view(torch.int16).cpu().numpy()
                           .tobytes()).hexdigest(),
            hashlib.sha256(stats.view(torch.int32).cpu().numpy()
                           .tobytes()).hexdigest())


# sha256 of the bf16 PFN's output (table, statistics) on the seeded inputs
# above, as the tile kernel gave them on the H100 before its f32 instance
# moved onto the tensor cores: the bf16 instance's arithmetic did not change
PFN_BF16_SHA256 = {
    ("pfn", 4, True): (
        "1e19b10b13f2d12cd1c5f97bdabae77e05507a659b62d28a9ae1f604eaac8298",
        "8473a4d119f6d978facafe01eb35e0db571e70dc7ff575fad3af70b904db9150"),
    ("pfn", 3, True): (
        "6fc82cd1a72544ec198b12f29d7b829b43321e84e6440056bdc10686b1c8cd7f",
        "a4e821b3f034043718e484b73d55a7096887782c1de2e8f1b22e17cc294bab3d"),
    ("pfn", 4, False): (
        "527950a533f61e51ca13d9905f15c275fa8e89e43cdac8a7dc4f43a87fb1848f",
        "cc1de24c1d71e952c5ec14d78df0e95ec4b96aee9329311b99dd1ab5b61e3dc1"),
    ("stream_pfn", 256, 4): (
        "980294d8b334d1eca04693aba39872b08a21113b231822e0478a0602c20c5264",
        "308849336d92ad627220c99d1040406cbcbe21d408d96984bd4f886a509502a0"),
    ("stream_pfn", 8192, 4): (
        "fc8dc0f3ad2effb5712cda6e630537a9155edcbe1771fa14443dc70b9beee312",
        "b291ee174377788545e79072ffaf59d21ef41d9c50bea04bbe5768441a75c52f"),
    ("stream_pfn", 8192, 3): (
        "6a455b2e8569199e2ed8ddef6f1effec0a5e627cf7f5df6c07bd86cbcd22e8a3",
        "af13dbd3e03c913a3bd9e55f56f9220c27fe39469b6106bb761767f963460ebb"),
}


@pytest.mark.parametrize("key", list(PFN_BF16_SHA256),
                         ids=lambda k: "-".join(map(str, k)))
def test_pfn_bf16_keeps_its_output(dev, key):
    """Kernels 1 and 10 in bf16, bit for bit against their recorded
    output."""
    kb.reset_launches()
    digests = pfn_bf16_digests(dev, key)
    print(f"pfn bf16 {key}: sha256 {digests}")
    assert kb.INSTANCES == {f"{key[0]}/bf16": 2}
    assert digests == PFN_BF16_SHA256[key]


@pytest.mark.parametrize("mode", ["full", "channel"])
def test_canvas_f32(dev, mode):
    pts, msk = _points(2)
    ps = pillarize_stream_packed(torch.as_tensor(pts, device=dev),
                                 torch.as_tensor(msk, device=dev),
                                 max_points_per_pillar=32, **GEO)
    table, stats = kpfn.pfn_plain(
        ps, _pfn_weights(dev, torch.float32, 10), point_dim=4,
        with_distance=True, grid_w=W, voxel_size=GEO["voxel_size"],
        x0=GEO["x_range"][0], y0=GEO["y_range"][0], out_dtype=torch.float32)
    shape = (H, W, 128) if mode == "full" else (1, 1, 128)
    g = torch.Generator().manual_seed(3)
    scale = (1 + 0.1 * torch.randn(shape, generator=g)).to(dev)
    bias = (0.1 * torch.randn(shape, generator=g)).to(dev)
    mean = stats[:, 0] / float(H * W * 128)
    var = stats[:, 1] / float(H * W * 128) - mean * mean
    kb.reset_launches()
    got = kcanvas.canvas_norm(table, ps.cells, ps.num_pillars, mean, var,
                              scale, bias, (H, W))
    want = kcanvas.canvas_norm_plain(table, ps.cells, mean, var, scale, bias,
                                     (H, W))
    torch.cuda.synchronize()
    assert kb.INSTANCES["canvas_norm/f32"] == 1 and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("c", [192, 768])
def test_layer_norm_f32(dev, c):
    g = torch.Generator().manual_seed(14)
    x = (0.5 + torch.randn(3, 517, c, generator=g)).to(dev)
    w = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
    b = (0.1 * torch.randn(c, generator=g)).to(dev)
    kb.reset_launches()
    got = kln.layer_norm(x, w, b)
    want = kln.layer_norm_plain(x, w, b)
    torch.cuda.synchronize()
    assert kb.INSTANCES["layer_norm/f32"] == 1 and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-4


def test_patch_embed_f32(dev):
    g = torch.Generator().manual_seed(13)
    b, h, w, c, e = 2, 64, 48, 128, 192
    canvas = torch.randn(b, h, w, c, generator=g).to(dev)
    weight = (torch.randn(e, c, 4, 4, generator=g) / (16 * c) ** 0.5).to(dev)
    vecs = [(base + 0.1 * torch.randn(e, generator=g)).to(dev)
            for base in (0.0, 1.0, 0.0)]
    wm = kpe.embed_matrix(weight)
    kb.reset_launches()
    got = kpe.patch_embed(canvas, wm, *vecs, 4)
    want = kpe.patch_embed_plain(canvas, wm, *vecs, 4)
    torch.cuda.synchronize()
    assert kb.INSTANCES["patch_embed/f32"] == 1
    assert got.shape == (b, (h // 4) * (w // 4), e)
    assert _rel(got, want) <= 1e-4


def _patch_embed_f64(canvas, wm, bias, ln_w, ln_b, p, eps=1e-6):
    """Patch embed + LN in float64 (the plain version's arithmetic)."""
    b, h, w, c = canvas.shape
    gh, gw = h // p, w // p
    t = (canvas.double().reshape(b, gh, p, gw, p, c)
         .permute(0, 1, 3, 2, 4, 5).reshape(b * gh * gw, p * p * c))
    y = t @ wm.double().t() + bias.double()
    mean = y.mean(-1, keepdim=True)
    var = ((y * y).mean(-1, keepdim=True) - mean * mean).clamp(min=0)
    out = (y - mean) * torch.rsqrt(var + eps) * ln_w.double() + ln_b.double()
    return out.reshape(b, gh * gw, -1)


@pytest.mark.parametrize("b,h,w,c,e", [
    (2, 64, 48, 128, 192), (2, 32, 48, 128, 64), (2, 32, 48, 128, 256),
    (2, 40, 280, 64, 192),  # gw 70: tiles that end inside a token row
    (1, 40, 280, 128, 64),
])
@pytest.mark.parametrize("halves", ["given", "split_in_the_wrapper"])
def test_patch_embed_f32_against_float64(dev, b, h, w, c, e, halves):
    """The 3xTF32 instance within 1e-5 of a float64 product + LN (of the
    largest output); the weight's halves as the backbone passes them or
    split by the wrapper."""
    g = torch.Generator().manual_seed(19)
    canvas = torch.randn(b, h, w, c, generator=g).to(dev)
    weight = (torch.randn(e, c, 4, 4, generator=g) / (16 * c) ** 0.5).to(dev)
    vecs = [(base + 0.1 * torch.randn(e, generator=g)).to(dev)
            for base in (0.0, 1.0, 0.0)]
    wm = kpe.embed_matrix(weight)
    split = kswin.split_tf32(wm) if halves == "given" else None
    kb.reset_launches()
    got = kpe.patch_embed(canvas, wm, *vecs, 4, split=split)
    torch.cuda.synchronize()
    assert kb.INSTANCES == {"patch_embed/f32": 1}
    want = _patch_embed_f64(canvas, wm, *vecs, 4)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.double(), want) <= 1e-5


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("c,heads,win,hw", [
    (192, 3, 10, (23, 27)),
    (384, 6, 5, (3, 3)),
])
def test_swin_block_f32(dev, quant, shifted, c, heads, win, hw):
    p = _block_weights(dev, c, heads, win, quant, seed=4, dtype=torch.float32)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, hw[0] * hw[1], c, generator=g).to(dev)
    shift = kswin.effective_shift(hw, win, shifted)
    kb.reset_launches()
    got = kswin.swin_block(x, p, hw, win, heads, shift, quant)
    want = kswin.swin_block_plain(x, p, hw, win, heads, shift, quant)
    torch.cuda.synchronize()
    gk = ("swin_block/gemm_s8_f32" if quant
          else "swin_block/gemm_f32_3xtf32")
    assert kb.INSTANCES[gk] == 4 and kb.INSTANCES["swin_block/f32"] >= 2
    assert got.dtype == torch.float32
    assert _rel(got, want) <= (2e-2 if quant else 1e-4)


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("mode", [kswin.EPI_BIAS, kswin.EPI_GELU,
                                  kswin.EPI_RESIDUAL])
@pytest.mark.parametrize("m,n,k", [(1000, 576, 192), (321, 768, 1536),
                                   (65, 192, 192), (257, 1536, 1536)])
def test_gemm_f32(dev, quant, mode, m, n, k):
    """int8 operands with the f32 epilogue: equal to a float64 product of
    the int8 values and the f32 epilogue (GELU within 1e-6 relative, erf of
    two libraries); f32 operands (the 3xTF32 instance): within 1e-5 of a
    float64 product, up to phase W's stage-3 width (K = N = 1536)."""
    g = torch.Generator().manual_seed(16)
    a32 = torch.randn(m, k, generator=g).to(dev)
    w32 = (torch.randn(n, k, generator=g) / k ** 0.5).to(dev)
    bias = (0.1 * torch.randn(n, generator=g)).to(dev)
    res = torch.randn(m, n, generator=g).to(dev)
    residual = res if mode == kswin.EPI_RESIDUAL else None
    d = kswin.make_dense(w32, bias, quant)
    kb.reset_launches()
    if quant:
        q, sx = kswin.quant_rows(a32)
        a8 = q.to(torch.int8).contiguous()
        sx = sx.reshape(-1).contiguous()
        got = kswin.gemm("swin_block", a8, d, mode, residual=residual, sx=sx,
                         out_dtype=torch.float32)
        v = ((a8.double() @ d.q8.double().t()).float() * sx[:, None]
             * d.sw[None] + d.bias)
    else:
        got = kswin.gemm("swin_block", a32, d, mode, residual=residual)
        v = (a32.double() @ w32.double().t()).float() + d.bias
    if mode == kswin.EPI_GELU:
        v = torch.nn.functional.gelu(v, approximate="none")
    elif mode == kswin.EPI_RESIDUAL:
        v = res + v
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    inst = "gemm_s8_f32" if quant else "gemm_f32_3xtf32"
    assert kb.INSTANCES == {f"swin_block/{inst}": 1}
    if quant and mode != kswin.EPI_GELU:
        assert torch.equal(got, v)
    else:
        assert _rel(got, v) <= (1e-6 if quant else 1e-5)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("c,heads,hw", [
    (192, 3, (23, 27)),    # pad tokens on both axes
    (192, 3, (125, 125)),  # the flagship's stage-0 grid
    (1536, 24, (16, 16)),  # its stage-3 grid
])
def test_window_attention_f32(dev, shifted, c, heads, hw):
    """The Swin chain's f32 attention launch (3xTF32) against the plain
    attention on the same qkv (``test_torch_port_kernels.py``'s, whose
    bf16 roundings are identities in f32) within 1e-4, and against a
    float64 attention within 1e-5 of the largest output."""
    win, b = 10, 2
    p = _block_weights(dev, c, heads, win, False, seed=17,
                       dtype=torch.float32)
    g = torch.Generator().manual_seed(18)
    qkv = torch.randn(b * hw[0] * hw[1], 3 * c, generator=g).to(dev)
    shift = kswin.effective_shift(hw, win, shifted)
    kb.reset_launches()
    got = kswin.window_attention(qkv, p, b, hw, heads, win, shift)
    want = _window_attention_plain(qkv, p, b, hw, heads, win, shift)
    exact = _attention_f64(qkv, p.qkv.bias, p.rel_bias, b, hw, heads, win,
                           shift, msa=False)
    torch.cuda.synchronize()
    assert kb.INSTANCES == {"swin_block/attn_f32": 1}
    assert got.dtype == torch.float32
    err = float((got.double() - exact).abs().max() / exact.abs().max())
    print(f"swin attention f32 {c} {hw} shift {shift}: error relative to "
          f"float64 {err:.3g}, to the plain f32 {_rel(got, want):.3g}")
    assert _rel(got, want) <= 1e-4
    assert err <= 1e-5


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("c,heads,hw", [(192, 3, (23, 27)),
                                        (1536, 24, (7, 7)),
                                        (96, 3, (23, 27))])
def test_window_msa_f32(dev, shifted, c, heads, hw):
    """Kernel 7's f32 instance on the token grid against the plain version
    (1e-4) and against the whole chain in float64 (1e-5 of the largest
    output); its attention launch alone against a float64 attention."""
    win = 5 if c == 1536 else 10
    p = _block_weights(dev, c, heads, win, False, seed=11,
                       dtype=torch.float32)
    g = torch.Generator().manual_seed(12)
    y = torch.randn(2, hw[0] * hw[1], c, generator=g).to(dev)
    shift = kswin.effective_shift(hw, win, shifted)
    args = (y, hw, win, shift, p.rel_bias, p.qkv, p.proj, heads)
    kb.reset_launches()
    got = kwmsa.window_msa(*args)
    want = kwmsa.window_msa_grid_plain(*args)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["window_msa"] == 3
    assert kb.INSTANCES == {"window_msa/gemm_f32_3xtf32": 2,
                            "window_msa/attn_f32": 1}

    def f64(x, d):
        return x @ d.wt.double().t() + d.bias.double()

    qkv64 = f64(y.double().reshape(-1, c), p.qkv)
    o64 = _attention_f64(qkv64, p.qkv.bias, p.rel_bias, 2, hw, heads, win,
                         shift, msa=True)
    exact = f64(o64, p.proj).reshape(y.shape)
    err = float((got.double() - exact).abs().max() / exact.abs().max())
    qkv = kswin.gemm("window_msa", y.reshape(-1, c), p.qkv, kswin.EPI_BIAS)
    o = kswin.attention("window_msa", qkv, p.qkv.bias, p.rel_bias, 2, hw,
                        heads, win, shift, msa=True)
    o_exact = _attention_f64(qkv, p.qkv.bias, p.rel_bias, 2, hw, heads, win,
                             shift, msa=True)
    err_attn = float((o.double() - o_exact).abs().max()
                     / o_exact.abs().max())
    print(f"window msa f32 {c} {hw} shift {shift}: chain error relative to "
          f"float64 {err:.3g}, attention alone {err_attn:.3g}")
    assert _rel(got, want) <= 1e-4
    assert err <= 1e-5 and err_attn <= 1e-5


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q,c,heads,f,hws", [
    (170, 256, 8, 2048, [(16, 16), (32, 32), (63, 63)]),  # Waymo
    (45, 256, 8, 2048, [(8, 8), (16, 16), (32, 31)]),     # flagship widths
    (64, 128, 2, 512, [(4, 4), (8, 8), (16, 15)]),        # head width 64
], ids=["waymo", "q45", "hd64"])
def test_decoder_split(dev, dtype, q, c, heads, f, hws):
    args = _decoder_inputs(dev, dtype, q, c, heads, f, hws)
    if kdec.flagship_takes(q, c, f, heads, 3, 9, max(h * w for h, w in hws),
                           dtype):
        pytest.skip("the flagship instance takes these shapes "
                    "(test_torch_port_kernels.py)")
    kb.reset_launches()
    got, bits = kdec.decoder_stack(*args, num_heads=heads, return_bits=True)
    torch.cuda.synchronize()
    inst = "split_tc_f32" if dtype == torch.float32 else "split_tc_bf16"
    assert kb.INSTANCES[f"decoder_stack/{inst}"] == 1
    gemm = "gemm_f32_3xtf32" if dtype == torch.float32 else "gemm_bf16"
    assert kb.INSTANCES[f"decoder_stack/{gemm}"] == 6
    assert got.dtype == dtype and got.shape == (2, q, c)
    want, logits = kdec.decoder_stack_plain(*args, num_heads=heads,
                                            return_logits=True)
    flips = [int((kb_ != kdec.blocked_positions(m)).sum())
             for kb_, m in zip(bits, logits)]
    same, same_logits = kdec.decoder_stack_plain(
        *args, num_heads=heads, blocked=bits, return_logits=True)
    own = [int((kb_ != kdec.blocked_positions(m)).sum())
           for kb_, m in zip(bits, same_logits)]
    print(f"decoder split {inst} Q={q}: flips per layer {flips}, on its own "
          f"decisions {own}, of {[m.numel() for m in logits]}")
    assert flips[0] <= 1e-4 * logits[0].numel()
    for li, m in enumerate(logits):
        assert flips[li] <= 0.05 * m.numel(), (li, flips)
        assert own[li] <= 0.01 * m.numel(), (li, own)
    assert _rel(got, same) <= (2e-2 if dtype == torch.bfloat16 else 1e-3)


def test_predictor_f32_card_matches_cpu(dev):
    """A tiny f32 model served on the card (every f32 instance on the way:
    PFN, canvas, Swin blocks, decoder split) against the CPU."""
    cfg = tiny_test_config().replace(head_num_attn_heads=2,
                                     compute_dtype="float32")
    sd = MaskBev(cfg).random_state_dict(1)
    rng = np.random.default_rng(2)
    n = cfg.max_points_per_scan
    pts = np.stack([rng.uniform(-9.9, 9.9, (2, n)),
                    rng.uniform(-9.9, 9.9, (2, n)),
                    rng.uniform(-3, 3, (2, n)), rng.uniform(0, 1, (2, n))],
                   -1).astype(np.float32)
    msk = np.ones((2, n), bool)
    msk[:, 1800:] = False
    kb.reset_launches()
    c_gpu, m_gpu = MaskBevPredictor(cfg, sd, device="cuda").forward(
        torch.as_tensor(pts), torch.as_tensor(msk))
    inst = dict(kb.INSTANCES)
    c_cpu, m_cpu = MaskBevPredictor(cfg, sd, device="cpu").forward(
        torch.as_tensor(pts), torch.as_tensor(msk))
    for k in ("canvas_norm/f32", "swin_block/f32",
              "decoder_stack/split_tc_f32", "decoder_stack/gemm_f32_3xtf32"):
        assert inst.get(k, 0) > 0, (k, inst)
    assert float((c_gpu.cpu() - c_cpu).abs().max()) <= 1e-3
    assert float((m_gpu.cpu() - m_cpu).abs().max()) <= 1e-3


# instances of the designs this port removed: the f32 SIMT GEMM, the split
# decoder's FMA kernel and kernel 7's attention kernels on partitioned
# windows (the window-attention template took their place)
REMOVED = ("swin_block/gemm_f32", "window_msa/gemm_f32",
           "decoder_stack/gemm_f32", "decoder_stack/split_f32",
           "decoder_stack/split_bf16", "window_msa/bf16", "window_msa/f32")


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_f32_paths_launch_no_removed_design(dev, quant):
    """A tiny f32 model served on the card, with f32 or int8 backbone
    products: the 3xTF32 GEMM and the tensor-core split decoder launch, the
    removed designs never do."""
    cfg = tiny_test_config().replace(
        head_num_attn_heads=2, compute_dtype="float32",
        backbone_quantize="int8" if quant else "none")
    sd = MaskBev(cfg).random_state_dict(3)
    pts, msk = _points(4, b=2, n=cfg.max_points_per_scan)
    kb.reset_launches()
    MaskBevPredictor(cfg, sd, device="cuda").forward(
        torch.as_tensor(pts), torch.as_tensor(msk))
    torch.cuda.synchronize()
    inst = dict(kb.INSTANCES)
    want = ["decoder_stack/split_tc_f32", "decoder_stack/gemm_f32_3xtf32",
            "swin_block/gemm_s8_f32" if quant
            else "swin_block/gemm_f32_3xtf32"]
    assert all(inst.get(k, 0) > 0 for k in want), inst
    assert not [k for k in inst if k in REMOVED], inst
