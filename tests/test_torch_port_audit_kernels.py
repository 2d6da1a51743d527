"""The redesigned row walks and the audit's new shapes on the card.

Marked ``cuda``; each test skips, from a fixture, where there is no CUDA
device (the kernels build with nvcc for sm_90a and have no CPU mode). Run on
the card with ``python -m pytest -m cuda tests/test_torch_port_audit_kernels.py``.

* Kernel 9 at C 12, 100 (the walk) and 2056, 3072, 4096 (the wide
  instance: the row held in registers) against ``layer_norm_plain``
  (bf16 within 1e-2, f32 within 1e-4 of the largest value, as
  ``chip_smoke.py`` holds it), and the Swin LN above C 2048 (the wide
  kernel) against ``layer_norm_p`` (the same tolerances) and its int8 rows
  against ``quant_rows`` of the plain output (within one step: two f32
  LayerNorms summed in another order can move a value across a rounding
  boundary); every output bit for bit against the sha256 digests of the
  walk they replaced (``chip_smoke.WALK_SHA256``, recorded from the walk on
  the H100: the wide kernels sum in its order).
* Kernels 1 and 10 at layers of units that are not a multiple of 8, over
  128 (the wide instance) and 8 layers, against ``pfn_plain`` /
  ``stream_pfn_plain`` (bf16 within 2^-7 and 1e-2 of the largest value, as
  the flagship widths; f32 within 1e-5 of a float64 plain run), the
  table at its true width.
* The window attention at head widths 72-128 (the head-width kernel up to
  window 11, the streaming kernel above) and at windows 17-24 (the
  streaming kernel, every width class) against ``window_attention_plain``
  (bf16 within 1e-2, f32 within 1e-4 of the largest value), on a grid with
  pad tokens on both axes, shifted and not.
"""
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402
from mask_bev_tpu_torch.ops import layer_norm as kln  # noqa: E402
from mask_bev_tpu_torch.ops import pfn as kpfn  # noqa: E402
from mask_bev_tpu_torch.ops import swin_block as kswin  # noqa: E402
from mask_bev_tpu_torch.ops.stream_pillars import (  # noqa: E402
    pillarize_stream, pillarize_stream_packed)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda
BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's CUDA kernels (nvcc, sm_90a) "
                    "run only on a card")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp(min=1e-12))


# ---- the row walks ---------------------------------------------------------


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("c,rows", chip_smoke.WALK_LN_CASES)
def test_layer_norm_rows_on_the_card(dev, c, rows, f32):
    x, w, b = chip_smoke.walk_inputs(torch, c, rows, f32)
    kb.reset_launches()
    got = kln.layer_norm(x, w, b)
    torch.cuda.synchronize()
    dt = "f32" if f32 else "bf16"
    assert kb.INSTANCES == {f"layer_norm/{dt}{kln.instance_suffix(c)}": 1}
    assert _rel(got, kln.layer_norm_plain(x, w, b)) <= (1e-4 if f32 else 1e-2)


@pytest.mark.parametrize("quant", [False, True], ids=["out", "int8"])
@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("c,rows", chip_smoke.WALK_SWIN_CASES)
def test_swin_ln_rows_on_the_card(dev, c, rows, f32, quant):
    x, w, b = chip_smoke.walk_inputs(torch, c, rows, f32)
    kb.reset_launches()
    got = kswin._ln(x, w, b, quant)
    torch.cuda.synchronize()
    dt = "f32" if f32 else "bf16"
    assert kb.INSTANCES == {f"swin_block/{dt}_wide": 1}
    want = kswin.layer_norm_p(x, w, b)
    if quant:
        q8, sx = got
        q, s = kswin.quant_rows(want)
        assert float((q8.float() - q).abs().max()) <= 1.0
        assert _rel(sx, s.reshape(-1)) <= (1e-4 if f32 else 1e-2)
    else:
        assert _rel(got, want) <= (1e-4 if f32 else 1e-2)


def test_row_walks_keep_their_output(dev):
    """The wide kernels' outputs are the walk's, bit for bit."""
    got = chip_smoke.walk_digests(torch)
    assert got == chip_smoke.WALK_SHA256


# ---- the PFN at the audit's widths -----------------------------------------

GEO = dict(x_range=(-10.0, 10.0), y_range=(-10.0, 10.0),
           z_range=(-4.0, 4.0), voxel_size=0.25)
GRID_W = 80
# the layers' true units: not a multiple of 8, over 128, 8 layers
UNITS = {"8-12": (8, 12), "12-136": (12, 136), "256": (256,),
         "64-64-100": (64, 64, 100), "8x32": (32,) * 8}


def _weights(dev, units, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    out, d_in = [], 10
    for u in units:
        w = torch.randn(d_in, u, generator=g) / d_in ** 0.5
        out.append((w.to(dev, dtype),
                    (1 + 0.1 * torch.randn(u, generator=g)).to(dev),
                    (0.1 * torch.randn(u, generator=g)).to(dev)))
        d_in = 2 * u
    return out


def _points(dev, dtype, b=2, n=8192, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-9.9, 9.9, (b, n, 4)).astype(np.float32)
    pts[:, :, 2] = rng.uniform(-3, 3, (b, n))
    pts[0, :500, :2] = 1.1 + rng.uniform(0, 0.2, (500, 2))
    msk = np.ones((b, n), bool)
    msk[1, 6000:] = False
    return (torch.as_tensor(pts, device=dev).to(dtype),
            torch.as_tensor(msk, device=dev))


def _kw():
    return dict(with_distance=True, grid_w=GRID_W,
                voxel_size=GEO["voxel_size"], x0=GEO["x_range"][0],
                y0=GEO["y_range"][0])


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("units", list(UNITS.values()), ids=list(UNITS))
def test_pfn_widths_on_the_card(dev, units, dtype):
    pts, msk = _points(dev, dtype)
    ps = pillarize_stream_packed(pts, msk, max_points_per_pillar=32, **GEO)
    wts = _weights(dev, units, dtype)
    kb.reset_launches()
    table, stats = kpfn.pfn(ps, wts, point_dim=4, max_points_per_pillar=32,
                            out_dtype=dtype, **_kw())
    torch.cuda.synchronize()
    wide = any(u > 128 for u in units)
    assert kb.INSTANCES == {
        f"pfn/{kpfn.instance(dtype == F32, 32, wide)}": 2}
    assert table.shape[-1] == units[-1] and table.is_contiguous()
    f32 = dtype == F32
    want, wstats = kpfn.pfn_plain(ps, wts, point_dim=4,
                                  out_dtype=torch.float64 if f32 else dtype,
                                  **_kw())
    for b in range(2):
        p = int(ps.num_pillars[b])
        assert _rel(table[b, :p], want[b, :p]) <= (1e-5 if f32 else 2 ** -7)
    np.testing.assert_allclose(stats.cpu().numpy(),
                               wstats.float().cpu().numpy(), rtol=1e-3)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("units", list(UNITS.values()), ids=list(UNITS))
def test_stream_pfn_widths_on_the_card(dev, units, dtype):
    pts, msk = _points(dev, dtype, seed=3)
    sp = pillarize_stream(pts, msk, max_points_per_pillar=32,
                          max_pillars=3000, **GEO)
    nv = sp.valid.sum(dim=1).to(torch.int32)
    wts = _weights(dev, units, dtype, seed=4)
    kb.reset_launches()
    table, stats = kpfn.stream_pfn(sp, wts, k=32, out_dtype=dtype,
                                   num_valid=nv, **_kw())
    torch.cuda.synchronize()
    wide = any(u > 128 for u in units)
    assert kb.INSTANCES == {
        f"stream_pfn/{kpfn.instance(dtype == F32, 32, wide)}": 2}
    assert table.shape == (2, 3000, units[-1])
    f32 = dtype == F32
    want, _ = kpfn.stream_pfn_plain(sp, wts, k=32,
                                    out_dtype=torch.float64 if f32 else dtype,
                                    **_kw())
    assert _rel(table, want) <= (1e-5 if f32 else 1e-2)


# ---- the window attention at the audit's widths and windows ---------------

HW = (31, 29)  # pad tokens on both axes at every window below


def _attn(dev, dtype, hd, win, heads, seed, msa, shifted):
    g = torch.Generator().manual_seed(seed)
    c = heads * hd
    qkv = torch.randn(HW[0] * HW[1], 3 * c, generator=g).to(dev, dtype)
    qb = (0.1 * torch.randn(3 * c, generator=g)).to(dev)
    table = (0.02 * torch.randn((2 * win - 1) ** 2, heads, generator=g)).to(
        dev, dtype)
    rel = kswin.rel_bias_from_table(table, win)
    shift = kswin.effective_shift(HW, win, shifted)
    a = (qkv, qb, rel, 1, HW, heads, win, shift)
    name = "window_msa" if msa else "swin_block"
    kb.reset_launches()
    got = kswin.attention(name, *a, msa=msa)
    torch.cuda.synchronize()
    assert kb.INSTANCES == {
        f"{name}/{kswin.attn_instance(dtype == F32, win, hd)}": 1}
    want = kswin.window_attention_plain(*a, msa=msa)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= (1e-4 if dtype == F32 else 1e-2)


@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("msa", [False, True], ids=["swin", "msa"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("win", [7, 10, 12, 24])
@pytest.mark.parametrize("hd", [72, 96, 104, 128])
def test_wide_head_widths_on_the_card(dev, hd, win, dtype, msa, shifted):
    _attn(dev, dtype, hd, win, 2, hd + win, msa, shifted)


@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("msa", [False, True], ids=["swin", "msa"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("win", [17, 24])
@pytest.mark.parametrize("hd", [8, 16, 32, 48, 64])
def test_long_windows_on_the_card(dev, hd, win, dtype, msa, shifted):
    _attn(dev, dtype, hd, win, 3, 7 * hd + win, msa, shifted)
