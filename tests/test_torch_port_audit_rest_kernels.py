"""The refusal audit's last reachable entries on the card: kernel 8 at any
embed width up to 256, kernels 1 and 10 on the layered route, the decoder's
split instance at padded widths.

Marked ``cuda``; each test skips, from a fixture, where there is no CUDA
device (the kernels build with nvcc for sm_90a and have no CPU mode). Run on
the card with
``python -m pytest -m cuda tests/test_torch_port_audit_rest_kernels.py``.

* Kernel 8 at E 8, 72, 120, 168 and 200 (each on the next instance up,
  padded) against ``patch_embed_plain`` (bf16 within 1e-2 of the largest
  value, as ``test_torch_port_kernels.py`` holds the flagship widths; f32
  within 1e-5 of a float64 product and LN), the output at its true width.
* Kernels 1 and 10 at 129, 256 and 1024 points a pillar (the tiles for the
  pillars of up to 128 kept points, the layered route for the longer ones)
  and at two layers of 256 units (the layered route alone), against
  ``pfn_plain`` / ``stream_pfn_plain`` (bf16 within 2^-7 and 1e-2 of the
  largest value, f32 within 1e-5 of a float64 plain run); the tiles' rows
  at K 129 equal, bit for bit, their rows at K 128.
* The decoder's split instance at C 96 over 8 heads (head width 12), C 192
  over 6, C 96 over one head, C 64 over 16 (head width 4) and C 160 over
  5, FFNs that are no multiple of C, held as
  ``test_torch_port_f32_kernels.py::test_decoder_split`` holds the shipped
  widths.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402
from mask_bev_tpu_torch.ops import decoder_stack as kdec  # noqa: E402
from mask_bev_tpu_torch.ops import patch_embed as kpe  # noqa: E402
from mask_bev_tpu_torch.ops import pfn as kpfn  # noqa: E402
from mask_bev_tpu_torch.ops.stream_pillars import (  # noqa: E402
    pillarize_stream, pillarize_stream_packed)
from test_torch_port_f32_kernels import _patch_embed_f64  # noqa: E402
from test_torch_port_kernels import _decoder_inputs  # noqa: E402

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


# ---- kernel 8 at any embed width --------------------------------------------


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("e", [8, 72, 120, 168, 200])
def test_patch_embed_padded_widths(dev, e, dtype):
    g = torch.Generator().manual_seed(e)
    b, h, w, c = 2, 32, 280, 128  # gw 70: tiles that end inside a token row
    canvas = torch.randn(b, h, w, c, generator=g).to(dev, dtype)
    weight = (torch.randn(e, c, 4, 4, generator=g) / (16 * c) ** 0.5).to(
        dev, dtype)
    vecs = [(base + 0.1 * torch.randn(e, generator=g)).to(dev, dtype)
            for base in (0.0, 1.0, 0.0)]
    wm = kpe.embed_matrix(weight)
    kb.reset_launches()
    got = kpe.patch_embed(canvas, wm, *vecs, 4)
    torch.cuda.synchronize()
    assert kb.INSTANCES == {f"patch_embed/{kpe.instance(dtype == F32, e)}": 1}
    assert kpe.instance(dtype == F32, e).endswith(
        f"_e{kpe.instance_width(e)}")
    assert got.shape == (b, (h // 4) * (w // 4), e) and got.is_contiguous()
    if dtype == F32:
        assert _rel(got, _patch_embed_f64(canvas, wm, *vecs, 4)) <= 1e-5
    else:
        assert _rel(got, kpe.patch_embed_plain(canvas, wm, *vecs, 4)) <= 1e-2


# ---- kernels 1 and 10 on the layered route ----------------------------------

GEO = dict(x_range=(-10.0, 10.0), y_range=(-10.0, 10.0),
           z_range=(-4.0, 4.0), voxel_size=0.25)
GRID_W = 80


def _points(dev, dtype, b=2, n=16384, seed=0):
    """Uniform points with two dense patches in sample 0 (~3000 and ~600
    points a 0.25 m cell) and one in sample 1 (~200 a cell), masked
    points in sample 1."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-9.9, 9.9, (b, n, 4)).astype(np.float32)
    pts[:, :, 2] = rng.uniform(-3, 3, (b, n))
    pts[0, :3000, :2] = 1.05 + rng.uniform(0, 0.15, (3000, 2))
    pts[0, 3000:5400, :2] = -3.9 + rng.uniform(0, 0.45, (2400, 2))
    pts[1, :1800, :2] = 4.1 + rng.uniform(0, 0.7, (1800, 2))
    msk = np.ones((b, n), bool)
    msk[1, 12000:] = False
    return (torch.as_tensor(pts, device=dev).to(dtype),
            torch.as_tensor(msk, device=dev))


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


def _kw():
    return dict(with_distance=True, grid_w=GRID_W,
                voxel_size=GEO["voxel_size"], x0=GEO["x_range"][0],
                y0=GEO["y_range"][0])


# (K, units): the flagship's layers past 128 points a pillar; two layers of
# 256 units (their weights fit no block)
ROUTES = {"k129": (129, (64, 64, 128)), "k256": (256, (64, 64, 128)),
          "k1024": (1024, (64, 64, 128)), "u256x2": (32, (256, 256))}


def _expected(name, dtype, k, units):
    f32 = dtype == F32
    tiles = kpfn.route(k, _dims(units), dtype)[0]
    got = {f"{name}/{kpfn.layered_instance(f32)}": 2}
    if tiles is not None:
        wide = kpfn.is_wide(_dims(units))
        got[f"{name}/{kpfn.instance(f32, tiles, wide)}"] = 1
    return got


def _dims(units):
    out, d = [], 10
    for u in units:
        out.append((d, u))
        d = 2 * u
    return out


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_pfn_layered_route(dev, route, dtype):
    k, units = ROUTES[route]
    pts, msk = _points(dev, dtype)
    ps = pillarize_stream_packed(pts, msk, max_points_per_pillar=k, **GEO)
    assert int((ps.counts > 128).sum()) > 0 or k <= 128
    wts = _weights(dev, units, dtype)
    kb.reset_launches()
    table, stats = kpfn.pfn(ps, wts, point_dim=4, max_points_per_pillar=k,
                            out_dtype=dtype, **_kw())
    torch.cuda.synchronize()
    assert kb.INSTANCES == _expected("pfn", dtype, k, units)
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
def test_pfn_tiles_keep_their_rows(dev, dtype):
    """At K 129 the tiles take every pillar of up to 128 kept points as
    they do at K 128: those rows are equal bit for bit."""
    pts, msk = _points(dev, dtype, seed=5)
    wts = _weights(dev, (64, 64, 128), dtype, seed=6)
    tables = []
    for k in (128, 129):
        ps = pillarize_stream_packed(pts, msk, max_points_per_pillar=k, **GEO)
        table, _ = kpfn.pfn(ps, wts, point_dim=4, max_points_per_pillar=k,
                            out_dtype=dtype, **_kw())
        tables.append(table)
    # the pillars of up to 128 kept points at K 129 (the same pillar rows
    # at both K: one row a cell, in cell order)
    short = ((torch.arange(ps.counts.shape[1], device=dev)[None]
              < ps.num_pillars[:, None]) & (ps.counts <= 128))
    assert int((ps.counts > 128).sum()) > 0
    assert torch.equal(tables[0][short], tables[1][short])


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_stream_pfn_layered_route(dev, route, dtype):
    k, units = ROUTES[route]
    pts, msk = _points(dev, dtype, seed=3)
    sp = pillarize_stream(pts, msk, max_points_per_pillar=k,
                          max_pillars=3000, **GEO)
    nv = sp.valid.sum(dim=1).to(torch.int32)
    wts = _weights(dev, units, dtype, seed=4)
    kb.reset_launches()
    table, stats = kpfn.stream_pfn(sp, wts, k=k, out_dtype=dtype,
                                   num_valid=nv, **_kw())
    torch.cuda.synchronize()
    assert kb.INSTANCES == _expected("stream_pfn", dtype, k, units)
    assert table.shape == (2, 3000, units[-1])
    f32 = dtype == F32
    want, wstats = kpfn.stream_pfn_plain(
        sp, wts, k=k, out_dtype=torch.float64 if f32 else dtype, **_kw())
    assert _rel(table, want) <= (1e-5 if f32 else 1e-2)
    np.testing.assert_allclose(stats.cpu().numpy(),
                               wstats.float().cpu().numpy(), rtol=1e-3)


# ---- the decoder's split instance at padded widths --------------------------

SPLIT = {"c96-8heads": (45, 96, 8, 2048), "c192-6heads": (45, 192, 6, 2048),
         "c96-1head": (45, 96, 1, 2048), "c64-16heads": (8, 64, 16, 100),
         "c160-5heads": (64, 160, 5, 500)}


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(SPLIT))
def test_decoder_split_padded(dev, shape, dtype):
    q, c, heads, f = SPLIT[shape]
    hws = [(8, 8), (16, 16), (32, 31)]
    args = _decoder_inputs(dev, dtype, q, c, heads, f, hws, n_layers=3)
    assert not kdec.flagship_takes(q, c, f, heads, 3, 3, 32 * 31, dtype)
    kb.reset_launches()
    got, bits = kdec.decoder_stack(*args, num_heads=heads, return_bits=True)
    torch.cuda.synchronize()
    inst = kdec.split_instance(q, heads, dtype == F32, c, f)
    assert inst.endswith("_padded")
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
    print(f"decoder split {inst} C {c} heads {heads}: flips per layer "
          f"{flips}, on its own decisions {own}, of "
          f"{[m.numel() for m in logits]}")
    assert flips[0] <= 1e-4 * logits[0].numel()
    for li, m in enumerate(logits):
        assert flips[li] <= 0.05 * m.numel(), (li, flips)
        assert own[li] <= 0.01 * m.numel(), (li, own)
    assert _rel(got, same) <= (2e-2 if dtype == BF16 else 1e-3)
