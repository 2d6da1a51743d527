"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips, from a fixture, where there is no CUDA
device (the kernels build with nvcc for sm_90a and have no CPU mode). Run on
the card with ``python -m pytest -m cuda tests/test_torch_port_kernels.py``.

Both sides run on the card on the same inputs. Tolerances (relative to the
plain result's largest magnitude): 2^-7 where both sides round the same f32
values to bf16 (two bf16 steps), 2e-2 for the Swin block (int8 rounding
boundaries can move by a step between two f32 LayerNorms summed in another
order), 2e-2 for the decoder's final queries given the same blocked positions (its
hard ``m < 0`` threshold flips on tiny differences of the bf16 mask
embedding and a flip moves every later layer, so the threshold decisions
are counted and bounded per layer, and the arithmetic, mask embedding
included, is compared on the kernel's own decisions). The training
kernels are held exactly: the canvas scatter (A) and its gradient (B) only
move values, and the matcher (C) repeats the plain version's f32 steps, so
its assignments are equal.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from mask_bev_tpu_torch.ops import canvas as kcanvas  # noqa: E402
from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402
from mask_bev_tpu_torch.ops import decoder_stack as kdec  # noqa: E402
from mask_bev_tpu_torch.ops import hungarian as khung  # noqa: E402
from mask_bev_tpu_torch.ops import pfn as kpfn  # noqa: E402
from mask_bev_tpu_torch.ops import swin_block as kswin  # noqa: E402
from mask_bev_tpu_torch.ops.stream_pillars import (  # noqa: E402
    pillarize_stream, pillarize_stream_packed)

pytestmark = pytest.mark.cuda

GEO = dict(x_range=(-10.0, 10.0), y_range=(-10.0, 10.0),
           z_range=(-4.0, 4.0), voxel_size=0.25)
H = W = 80


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's CUDA kernels (nvcc, sm_90a) "
                    "run only on a card")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-6))


def _stream(dev, b=2, n=8192, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-9.9, 9.9, (b, n, 4)).astype(np.float32)
    pts[:, :, 2] = rng.uniform(-3, 3, (b, n))
    pts[0, :500, :2] = 1.1 + rng.uniform(0, 0.2, (500, 2))
    msk = np.ones((b, n), bool)
    msk[1, 6000:] = False
    p = torch.as_tensor(pts, device=dev).to(torch.bfloat16)
    return pillarize_stream_packed(p, torch.as_tensor(msk, device=dev),
                                   max_points_per_pillar=32, **GEO)


def _pfn_weights(dev, seed=1):
    g = torch.Generator().manual_seed(seed)
    out, d_in = [], 10
    for units in (64, 64, 128):
        w = torch.randn(d_in, units, generator=g) / d_in ** 0.5
        out.append((w.to(dev, torch.bfloat16),
                    (1 + 0.1 * torch.randn(units, generator=g)).to(dev),
                    (0.1 * torch.randn(units, generator=g)).to(dev)))
        d_in = 2 * units
    return out


def _pfn_kw():
    return dict(point_dim=4, with_distance=True, grid_w=W,
                voxel_size=GEO["voxel_size"], x0=GEO["x_range"][0],
                y0=GEO["y_range"][0])


def test_pfn_kernel(dev):
    ps = _stream(dev)
    wts = _pfn_weights(dev)
    table, stats = kpfn.pfn(ps, wts, max_points_per_pillar=32,
                            out_dtype=torch.bfloat16, **_pfn_kw())
    want, wstats = kpfn.pfn_plain(ps, wts, out_dtype=torch.bfloat16,
                                  **_pfn_kw())
    torch.cuda.synchronize()
    for b in range(2):
        p = int(ps.num_pillars[b])
        assert _rel(table[b, :p], want[b, :p]) <= 2 ** -7
    np.testing.assert_allclose(stats.cpu().numpy(), wstats.cpu().numpy(),
                               rtol=1e-3)


@pytest.mark.parametrize("mode", ["full", "channel"])
def test_canvas_kernel(dev, mode):
    ps = _stream(dev, seed=2)
    table, stats = kpfn.pfn_plain(ps, _pfn_weights(dev),
                                  out_dtype=torch.bfloat16, **_pfn_kw())
    shape = (H, W, 128) if mode == "full" else (1, 1, 128)
    g = torch.Generator().manual_seed(3)
    scale = (1 + 0.1 * torch.randn(shape, generator=g)).to(dev, torch.bfloat16)
    bias = (0.1 * torch.randn(shape, generator=g)).to(dev, torch.bfloat16)
    elems = float(H * W * 128)
    mean = stats[:, 0] / elems
    var = stats[:, 1] / elems - mean * mean
    got = kcanvas.canvas_norm(table, ps.cells, ps.num_pillars, mean, var,
                              scale, bias, (H, W))
    want = kcanvas.canvas_norm_plain(table, ps.cells, mean, var, scale, bias,
                                     (H, W))
    torch.cuda.synchronize()
    assert got.shape == (2, H, W, 128)
    assert _rel(got, want) <= 2 ** -7


def test_pfn_and_canvas_kernels_take_only_bf16(dev):
    ps = _stream(dev, seed=7)
    wts = [(w.float(), g, b) for (w, g, b) in _pfn_weights(dev)]
    with pytest.raises(ValueError, match="bf16"):
        kpfn.pfn(ps, wts, max_points_per_pillar=32, out_dtype=torch.float32,
                 **_pfn_kw())
    table = torch.zeros(ps.cells.shape + (128,), device=dev)
    ones = torch.ones(2, device=dev)
    affine = torch.ones(128, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        kcanvas.canvas_norm(table, ps.cells, ps.num_pillars, ones, ones,
                            affine, affine, (H, W))


def _block_weights(dev, c, heads, win, quant, seed):
    g = torch.Generator().manual_seed(seed)

    def lin(n_out, n_in):
        w = (torch.randn(n_out, n_in, generator=g) / n_in ** 0.5)
        return kswin.make_dense(w.to(dev, torch.bfloat16),
                                0.02 * torch.randn(n_out, generator=g).to(dev),
                                quant)

    def ln():
        return ((1 + 0.1 * torch.randn(c, generator=g)).to(dev, torch.bfloat16),
                (0.1 * torch.randn(c, generator=g)).to(dev, torch.bfloat16))

    table = (0.02 * torch.randn((2 * win - 1) ** 2, heads, generator=g)).to(
        dev, torch.bfloat16)
    l1, l2 = ln(), ln()
    return kswin.BlockWeights(
        *l1, lin(3 * c, c), lin(c, c), *l2, lin(4 * c, c), lin(c, 4 * c),
        kswin.rel_bias_from_table(table, win))


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("c,heads,win,hw", [
    (192, 3, 10, (23, 27)),  # flagship stage-0 widths, pad tokens on both axes
    (384, 6, 5, (3, 3)),     # one window, head dim above the padded window
])
def test_swin_block_kernel(dev, quant, shifted, c, heads, win, hw):
    p = _block_weights(dev, c, heads, win, quant, seed=4)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, hw[0] * hw[1], c, generator=g).to(dev, torch.bfloat16)
    shift = kswin.effective_shift(hw, win, shifted)
    got = kswin.swin_block(x, p, hw, win, heads, shift, quant)
    want = kswin.swin_block_plain(x, p, hw, win, heads, shift, quant)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 2e-2


def test_decoder_stack_kernel(dev):
    b, q, c, heads, f, n_layers = 2, 45, 256, 8, 2048, 9
    hws = [(4, 4), (8, 8), (16, 15)]
    g = torch.Generator().manual_seed(6)

    def r(*s, scale=1.0):
        return scale * torch.randn(*s, generator=g)

    def mat(i, o):
        return r(i, o, scale=i ** -0.5).to(dev, torch.bfloat16)

    def vec(n, base=0.0):
        return (base + r(n, scale=0.05)).to(dev)

    layers = [kdec.LayerWeights(
        mat(c, c), vec(c), mat(c, c), vec(c), mat(c, c), vec(c), mat(c, c),
        vec(c), mat(c, c), vec(c), mat(c, c), vec(c), mat(c, c), vec(c),
        mat(c, c), vec(c), vec(c, 1.0), vec(c), vec(c, 1.0), vec(c),
        vec(c, 1.0), vec(c), mat(c, f), vec(f), mat(f, c), vec(c))
        for _ in range(n_layers)]
    head = kdec.HeadWeights(vec(c, 1.0), vec(c), mat(c, c), vec(c),
                            mat(c, c), vec(c), mat(c, c), vec(c))
    bf = torch.bfloat16
    out0 = r(b, q, c).to(dev, bf)
    emb0 = r(b, q, c).to(dev, bf)
    qpos = r(q, c).to(dev, bf)
    mems = [r(b, h * w, c).to(dev, bf) for (h, w) in hws]
    pes = [r(h * w, c).to(dev, bf) for (h, w) in hws]
    feats = [r(b, h * w, c).to(dev) for (h, w) in hws]
    got, bits = kdec.decoder_stack(out0, emb0, qpos, mems, pes, feats,
                                   layers, head, num_heads=heads,
                                   return_bits=True)
    want, logits = kdec.decoder_stack_plain(
        out0, emb0, qpos, mems, pes, feats, layers, head, num_heads=heads,
        return_logits=True)
    torch.cuda.synchronize()
    flips = [int((kb_ != kdec.blocked_positions(m)).sum())
             for kb_, m in zip(bits, logits)]
    same_bits, same_logits = kdec.decoder_stack_plain(
        out0, emb0, qpos, mems, pes, feats, layers, head, num_heads=heads,
        blocked=bits, return_logits=True)
    # the plain version run on the kernel's decisions computes each layer's
    # logits from its own decoder norm and mask MLP on a query state that
    # follows the kernel's: only logits within rounding of 0 may decide
    # otherwise, so a wrong mask embedding in any layer shows here
    own = [int((kb_ != kdec.blocked_positions(m)).sum())
           for kb_, m in zip(bits, same_logits)]
    print(f"decoder stack: bias entries that differ per layer {flips}, on "
          f"the kernel's own decisions {own}, of "
          f"{[m.numel() for m in logits]}")
    # layer 0 sees identical inputs on both sides: only a logit within
    # rounding of 0 could differ. Later layers inherit bf16 rounding
    # differences of the query state through the mask embedding, and a
    # flipped entry changes everything after it, so the free-running flips
    # are held to 5 % a layer (3.4 % in the last layer on the card) and the
    # arithmetic to the plain version run on the kernel's own decisions.
    assert flips[0] <= 1e-4 * logits[0].numel()
    for li, m in enumerate(logits):
        assert flips[li] <= 0.05 * m.numel(), (li, flips)
        assert own[li] <= 0.01 * m.numel(), (li, own)
    assert _rel(got, same_bits) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_canvas_scatter_kernels(dev, dtype):
    """Kernel A (forward) and B (gradient) against their plain versions,
    with a capped stream and an all-invalid sample."""
    rng = np.random.default_rng(8)
    pts = rng.uniform(-9.9, 9.9, (3, 4096, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(-3, 3, (3, 4096))
    msk = np.ones((3, 4096), bool)
    msk[2] = False  # no valid point: every slot unused
    sp = pillarize_stream(torch.as_tensor(pts, device=dev),
                          torch.as_tensor(msk, device=dev),
                          max_points_per_pillar=8, max_pillars=2048, **GEO)
    assert int(sp.valid[2].sum()) == 0 and bool(sp.valid[0].all())
    g = torch.Generator().manual_seed(9)
    table = torch.randn(3, 2048, 128, generator=g).to(dev, dtype)
    table = torch.where(sp.valid[..., None], table, 0.0)
    kb.reset_launches()
    got = kcanvas.canvas_scatter_forward(table, sp.cells, (H, W))
    want = kcanvas.canvas_scatter_plain(table, sp.cells, (H, W))
    cot = torch.randn(3, H, W, 128, generator=g).to(dev, dtype)
    d_got = kcanvas.canvas_scatter_backward(cot, sp.cells, (H, W))
    d_want = kcanvas.canvas_gather_plain(cot, sp.cells, (H, W))
    torch.cuda.synchronize()
    assert kb.LAUNCHES["canvas_scatter"] == 1
    assert kb.LAUNCHES["canvas_scatter_bwd"] == 1
    assert torch.equal(got, want) and torch.equal(d_got, d_want)
    assert float(got[2].abs().sum()) == 0 and float(d_got[2].abs().sum()) == 0
    # through autograd
    t = table.clone().requires_grad_(True)
    kcanvas.canvas_scatter(t, sp.cells, (H, W)).backward(cot)
    assert torch.equal(t.grad, d_want)


@pytest.mark.parametrize("kind", ["random", "tied", "edge"])
def test_matcher_kernel(dev, kind):
    """Kernel C gives the plain version's assignment exactly, for G = 0,
    G = Q, ties and padded columns."""
    rng = np.random.default_rng({"random": 10, "tied": 11, "edge": 12}[kind])
    n, q, g = 40, 45, 45
    if kind == "tied":
        cost = rng.integers(0, 3, (n, q, g)).astype(np.float32)
        cost[0] = 0.5
    else:
        cost = (rng.normal(size=(n, q, g)) * 3).astype(np.float32)
    nv = rng.integers(0, 7, n).astype(np.int32)
    if kind == "edge":
        nv[:4] = [0, g, g, 1]
        cost[4:, :, 7:] = 1e6
    c = torch.as_tensor(cost, device=dev)
    v = torch.as_tensor(nv, device=dev)
    kb.reset_launches()
    got = khung.hungarian_rows(c.transpose(1, 2), v)
    want = khung.hungarian_rows_plain(c.transpose(1, 2), v)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["hungarian"] == 1
    assert torch.equal(got, want)
    assert ((got >= 0).sum(1).cpu().numpy() == np.minimum(nv, q)).all()
