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
its assignments are equal. Kernels 7-10: 2e-2 for window MSA (as the Swin
block: bf16 rounding of qkv, probabilities and heads on both sides, summed
in another order; its attention launch alone 1e-2, as the Swin chain's),
1e-2 for the patch embed, the token LayerNorm and the
capped PFN (each rounds once to bf16 from f32 values summed in another
order). The PFN kernels (1 and 10) sum their products on the tensor cores
in another order than the plain version (which they equalled exactly while
they summed on the CUDA cores in its order), so they are held within
2^-7 (kernel 1) and 1e-2 (kernel 10) of the largest value. The f32
instances and the split decoder are held in
``test_torch_port_f32_kernels.py``. The shared GEMM's int8 products are held exactly against a float64
product of the int8 values (an int32 sum is exact in any order) followed
by the same f32 epilogue; the Swin chain's attention launch alone within
1e-2, and in bf16 bit for bit against its output before the
window-attention template (a recorded sha256). Kernel 2, both instances,
bit for bit against the sha256 digests its first design (one warp a cell)
gave on the same seeded inputs.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from mask_bev_tpu_torch.ops import canvas as kcanvas  # noqa: E402
from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402
from mask_bev_tpu_torch.ops import decoder_stack as kdec  # noqa: E402
from mask_bev_tpu_torch.ops import hungarian as khung  # noqa: E402
from mask_bev_tpu_torch.ops import layer_norm as kln  # noqa: E402
from mask_bev_tpu_torch.ops import patch_embed as kpe  # noqa: E402
from mask_bev_tpu_torch.ops import pfn as kpfn  # noqa: E402
from mask_bev_tpu_torch.ops import swin_block as kswin  # noqa: E402
from mask_bev_tpu_torch.ops import window_msa as kwmsa  # noqa: E402
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


# canvas inputs made with numpy from a seed (no kernel in their making), so
# the CPU tests (test_torch_port_canvas.py) and the card see the same
# bytes: "random", three samples of random occupancy on a grid whose cell
# count is not a multiple of a block's run of cells; "edges", a sample
# with no pillar, one with pillars in the first and the last cell, one
# whose every cell is occupied (num_pillars == N == H * W) and a random one
CANVAS_CASES = {
    "random": dict(b=3, h=48, w=40, c=128, n=1200, pillars=(900, 1200, 350)),
    "edges": dict(b=4, h=16, w=20, c=64, n=320, pillars=(0, 4, 320, 100)),
}


def canvas_inputs(case, mode, seed=21):
    """(table, cells, num_pillars, mean, var, scale, bias, (h, w)) as f32
    CPU tensors; ``cells`` ascending with the H*W sentinel on unused rows,
    whose table rows hold values no correct reader takes."""
    spec = CANVAS_CASES[case]
    b, h, w, c, n = (spec[k] for k in ("b", "h", "w", "c", "n"))
    rng = np.random.default_rng(seed)
    hw = h * w
    cells = np.full((b, n), hw, np.int32)
    for s, p in enumerate(spec["pillars"]):
        if p == hw:
            chosen = np.arange(hw)
        elif case == "edges" and s == 1:
            chosen = np.array([0, 5, 77, hw - 1])
        else:
            chosen = np.sort(rng.choice(hw, p, replace=False))
        cells[s, :p] = chosen
    table = rng.standard_normal((b, n, c)).astype(np.float32)
    mean = rng.normal(0.0, 0.3, b).astype(np.float32)
    var = rng.uniform(0.5, 2.0, b).astype(np.float32)
    shape = (h, w, c) if mode == "full" else (1, 1, c)
    scale = (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    pillars = np.asarray(spec["pillars"], np.int32)
    return (torch.from_numpy(table), torch.from_numpy(cells),
            torch.from_numpy(pillars), torch.from_numpy(mean),
            torch.from_numpy(var), torch.from_numpy(scale),
            torch.from_numpy(bias), (h, w))


# sha256 of kernel 2's output bytes on canvas_inputs, as the kernel of one
# warp per cell with a binary search per cell and sample gave them on the
# H100: the streaming kernel takes the same f32 operations in the same
# order, so it gives the same bytes
CANVAS_SHA256 = {
    ("bf16", "full", "random"):
        "199fd1c9eb2ca4aa7001f6263f608ba40e48ea01d27ac1e726e19c15b86f0d53",
    ("bf16", "channel", "random"):
        "b0920990d1ce0ba1cae0569af452a941392a597e1091754bd9a923aece34fec4",
    ("bf16", "full", "edges"):
        "7169b631a7f3c613cbd8f7b32419ccd5e503fc826654d45730712d96b1563653",
    ("bf16", "channel", "edges"):
        "ace2f7144e7cf14164ca5dc045a01beee57d79478deddcea2d88ad8ae6c24f45",
    ("f32", "full", "random"):
        "eed879bbacda715513a8bfc72ee3c6f7fc30a0730dc946c567372facab8c1aaa",
    ("f32", "channel", "random"):
        "1de3afaff8f05a4796dee6a3d1ad431950c0245fd376bab8c313cd9709b1f374",
    ("f32", "full", "edges"):
        "8c1c2e812c40ebc919a70405c5b4bbc10c4abfad79652d345c7c80873968713a",
    ("f32", "channel", "edges"):
        "537eed3e617b1b354ef465d3682cc84404b355f44bbe9ca64310ca061133a7fc",
}


@pytest.mark.parametrize("key", list(CANVAS_SHA256), ids="-".join)
def test_canvas_keeps_its_output(dev, key):
    """Both instances of kernel 2, bit for bit against their recorded
    output, and within rounding of the plain version."""
    import hashlib

    name, mode, case = key
    dtype = torch.bfloat16 if name == "bf16" else torch.float32
    args = [t.to(dev) for t in canvas_inputs(case, mode)[:7]]
    table, cells, pillars, mean, var, scale, bias = args
    table, scale, bias = (t.to(dtype) for t in (table, scale, bias))
    hw = canvas_inputs(case, mode)[7]
    kb.reset_launches()
    got = kcanvas.canvas_norm(table, cells, pillars, mean, var, scale, bias,
                              hw)
    want = kcanvas.canvas_norm_plain(table, cells, mean, var, scale, bias,
                                     hw)
    torch.cuda.synchronize()
    assert kb.INSTANCES == {f"canvas_norm/{name}": 1}
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel(got, want) <= (2 ** -7 if name == "bf16" else 1e-5)
    word = torch.int16 if name == "bf16" else torch.int32
    digest = hashlib.sha256(
        got.view(word).cpu().numpy().tobytes()).hexdigest()
    print(f"canvas {key}: sha256 {digest}")
    assert digest == CANVAS_SHA256[key]


def test_pfn_and_canvas_kernels_take_only_bf16(dev):
    """The bf16 and f32 instances are the only ones: other dtypes raise
    (the f32 instances are held in ``test_torch_port_f32_kernels.py``)."""
    ps = _stream(dev, seed=7)
    wts = [(w.half(), g, b) for (w, g, b) in _pfn_weights(dev)]
    with pytest.raises(ValueError, match="bf16 or f32"):
        kpfn.pfn(ps, wts, max_points_per_pillar=32, out_dtype=torch.float16,
                 **_pfn_kw())
    table = torch.zeros(ps.cells.shape + (128,), device=dev,
                        dtype=torch.float16)
    ones = torch.ones(2, device=dev)
    affine = torch.ones(128, device=dev)
    with pytest.raises(ValueError, match="bf16 or f32"):
        kcanvas.canvas_norm(table, ps.cells, ps.num_pillars, ones, ones,
                            affine, affine, (H, W))


def _block_weights(dev, c, heads, win, quant, seed, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)

    def lin(n_out, n_in):
        w = (torch.randn(n_out, n_in, generator=g) / n_in ** 0.5)
        return kswin.make_dense(w.to(dev, dtype),
                                0.02 * torch.randn(n_out, generator=g).to(dev),
                                quant)

    def ln():
        return ((1 + 0.1 * torch.randn(c, generator=g)).to(dev, dtype),
                (0.1 * torch.randn(c, generator=g)).to(dev, dtype))

    table = (0.02 * torch.randn((2 * win - 1) ** 2, heads, generator=g)).to(
        dev, dtype)
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


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("mode", [kswin.EPI_BIAS, kswin.EPI_GELU,
                                  kswin.EPI_RESIDUAL])
@pytest.mark.parametrize("m,n,k", [
    (1000, 576, 192),  # stage-0 qkv; M not a multiple of 64 or 128
    (777, 192, 768),   # stage-0 fc2
    (321, 768, 1536),  # stage-2 proj widths
    (65, 192, 192),    # one partial tile
])
def test_gemm_kernel(dev, quant, mode, m, n, k):
    """The shared wgmma GEMM at main-path widths. int8: against a float64
    product of the int8 values (exact at these sizes) followed by the
    epilogue's f32 operations in the same order: equal for the bias and
    residual modes, within one bf16 step for GELU (erf on two libraries).
    bf16: the XLA-order epilogue (product rounded first), within 2^-7."""
    g = torch.Generator().manual_seed(16)
    a32 = torch.randn(m, k, generator=g)
    w32 = torch.randn(n, k, generator=g) / k ** 0.5
    bias = (0.1 * torch.randn(n, generator=g)).to(dev)
    res = torch.randn(m, n, generator=g).to(dev, torch.bfloat16)
    residual = res if mode == kswin.EPI_RESIDUAL else None
    d = kswin.make_dense(w32.to(dev, torch.bfloat16), bias, quant)
    kb.reset_launches()
    if quant:
        q, sx = kswin.quant_rows(a32.to(dev, torch.bfloat16))
        a8 = q.to(torch.int8).contiguous()
        sx = sx.reshape(-1).contiguous()
        got = kswin.gemm("swin_block", a8, d, mode, residual=residual, sx=sx)
        acc = (a8.double() @ d.q8.double().t()).float()
        v = acc * sx[:, None] * d.sw[None] + d.bias
    else:
        mode = mode | kswin.EPI_ROUND_ACC
        a = a32.to(dev, torch.bfloat16)
        got = kswin.gemm("swin_block", a, d, mode, residual=residual)
        acc = a.float() @ d.wt.float().t()
        v = acc.to(torch.bfloat16).float() + d.bias
    v = v.to(torch.bfloat16).float()
    if mode & 15 == kswin.EPI_GELU:
        v = torch.nn.functional.gelu(v, approximate="none")
    elif mode & 15 == kswin.EPI_RESIDUAL:
        v = res.float() + v
    want = v.to(torch.bfloat16)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["swin_block"] == 1
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    if quant and mode & 15 != kswin.EPI_GELU:
        assert torch.equal(got, want)
    elif quant:
        # one bf16 step of the value at most
        step = want.float().abs().clamp(min=2 ** -126) * 2 ** -7
        assert bool(((got.float() - want.float()).abs() <= step).all())
    else:
        assert _rel(got, want) <= 2 ** -7


def _decoder_inputs(dev, dtype, q, c, heads, f, hws, b=2, n_layers=9,
                    seed=6):
    """The decoder stack's inputs at these widths, random from ``seed``:
    (out0, emb0, qpos, mems, pes, feats, layers, head)."""
    g = torch.Generator().manual_seed(seed)

    def r(*s, scale=1.0):
        return scale * torch.randn(*s, generator=g)

    def mat(i, o):
        return r(i, o, scale=i ** -0.5).to(dev, dtype)

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
    out0 = r(b, q, c).to(dev, dtype)
    emb0 = r(b, q, c).to(dev, dtype)
    qpos = r(q, c).to(dev, dtype)
    mems = [r(b, h * w, c).to(dev, dtype) for (h, w) in hws]
    pes = [r(h * w, c).to(dev, dtype) for (h, w) in hws]
    feats = [r(b, h * w, c).to(dev) for (h, w) in hws]
    return out0, emb0, qpos, mems, pes, feats, layers, head


@pytest.mark.parametrize("c,heads,f,hws", [
    (256, 8, 2048, [(4, 4), (8, 8), (16, 15)]),
    # the flagship's levels: T up to 3969
    (256, 8, 2048, [(16, 16), (32, 32), (63, 63)]),
    # widths the kernel's C = 256 build does not take: C read at run time
    (128, 4, 512, [(8, 8), (16, 16), (32, 31)]),
    (256, 4, 1024, [(8, 8), (16, 16), (32, 31)]),  # head width 64
], ids=["small", "flagship", "c128", "hd64"])
def test_decoder_stack_kernel(dev, c, heads, f, hws):
    (out0, emb0, qpos, mems, pes, feats, layers, head) = _decoder_inputs(
        dev, torch.bfloat16, 45, c, heads, f, hws)
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


def _window_attention_plain(qkv, p, b, hw, heads, win, shift):
    """The attention part of ``window_msa_plain`` on a given qkv: pad
    tokens take the qkv bias (a zero LN1 row through the dense layer)."""
    h, w = hw
    c = qkv.shape[1] // 3
    hd, n = c // heads, win * win
    hp, wp = -(-h // win) * win, -(-w // win) * win
    grid = p.qkv.bias.to(qkv.dtype).expand(b, hp, wp, 3 * c).clone()
    grid[:, :h, :w] = qkv.reshape(b, h, w, 3 * c)
    if shift:
        grid = torch.roll(grid, (-shift, -shift), dims=(1, 2))
    nw = (hp // win) * (wp // win)
    t = (grid.reshape(b, hp // win, win, wp // win, win, 3 * c)
         .permute(0, 1, 3, 2, 4, 5).reshape(b * nw, n, 3, heads, hd)
         .permute(2, 0, 3, 1, 4))
    attn = (t[0] * hd ** -0.5).float() @ t[1].float().transpose(-1, -2)
    bias = p.rel_bias[None]
    mask = kswin.shift_mask(hw, win, shift, qkv.device)
    if mask is not None:
        bias = (bias + mask[:, None]).repeat(b, 1, 1, 1)
    attn = torch.softmax(attn + bias, dim=-1).to(qkv.dtype)
    o = (attn.float() @ t[2].float()).to(qkv.dtype)
    o = o.transpose(1, 2).reshape(b, nw, n, c)
    return kswin.merge_windows(o, hw, win, shift).reshape(b * h * w, c)


def _attention_f64(qkv, qkv_bias, rel, b, hw, heads, win, shift, msa):
    """The window attention in float64 on the same inputs, nothing rounded
    (the Swin variant's q scaled in f32 first, as its kernel and the
    reference block scale it): the yardstick of the f32 instances."""
    h, w = hw
    c = qkv.shape[1] // 3
    hd, n = c // heads, win * win
    hp, wp = -(-h // win) * win, -(-w // win) * win
    grid = qkv_bias.double().expand(b, hp, wp, 3 * c).clone()
    grid[:, :h, :w] = qkv.double().reshape(b, h, w, 3 * c)
    if shift:
        grid = torch.roll(grid, (-shift, -shift), dims=(1, 2))
    nw = (hp // win) * (wp // win)
    t = (grid.reshape(b, hp // win, win, wp // win, win, 3 * c)
         .permute(0, 1, 3, 2, 4, 5).reshape(b * nw, n, 3, heads, hd)
         .permute(2, 0, 3, 1, 4))
    q = t[0] if msa else (t[0].float() * hd ** -0.5).double()
    s = q @ t[1].transpose(-1, -2)
    if msa:
        s = s * hd ** -0.5
    bias = rel.double()[None]
    mask = kswin.shift_mask(hw, win, shift, qkv.device)
    if mask is not None:
        bias = (bias + mask.double()[:, None]).repeat(b, 1, 1, 1)
    o = torch.softmax(s + bias, dim=-1) @ t[2]
    o = o.transpose(1, 2).reshape(b, nw, n, c)
    return kswin.merge_windows(o, hw, win, shift).reshape(b * h * w, c)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("c,heads,hw", [
    (192, 3, (125, 125)),  # stage-0 grid of the flagship, pad tokens
    (1536, 24, (16, 16)),  # stage-3 grid: 24 heads, bias of all heads > smem
])
def test_window_attention_kernel(dev, shifted, c, heads, hw):
    """The Swin chain's attention launch alone (win 10, hd 64) against the
    plain attention on the same qkv: both round the same f32 softmax to
    bf16 and sum in another order, so within 1e-2 of the largest value."""
    win, b = 10, 2
    p = _block_weights(dev, c, heads, win, False, seed=17)
    g = torch.Generator().manual_seed(18)
    qkv = torch.randn(b * hw[0] * hw[1], 3 * c, generator=g).to(
        dev, torch.bfloat16)
    shift = kswin.effective_shift(hw, win, shifted)
    kb.reset_launches()
    got = kswin.window_attention(qkv, p, b, hw, heads, win, shift)
    want = _window_attention_plain(qkv, p, b, hw, heads, win, shift)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-2
    assert kb.LAUNCHES["swin_block"] == 1
    assert kb.INSTANCES == {"swin_block/attn_bf16": 1}
    # the module's plain version of the launch is the same function
    same = kswin.window_attention_plain(qkv, p.qkv.bias, p.rel_bias, b, hw,
                                        heads, win, shift, msa=False)
    assert torch.equal(same, want)


# sha256 of the bf16 Swin attention's output bytes, as the kernel before
# the window-attention template (swin_window_attn_kernel) gave them on the
# H100 for test_window_attention_kernel's inputs: the template's Swin
# variant in bf16 is the same arithmetic in the same order
SWIN_ATTN_BF16_SHA256 = {
    (192, 3, (125, 125), False):
        "263eacda11002256e0178c21a03c726f83a83148007c3be2f5e36bb21f7d42cf",
    (192, 3, (125, 125), True):
        "920e57768452bc8d799b517907626a1dee0c456f83e77156562a48456b132fc7",
    (1536, 24, (16, 16), False):
        "95f3e7bd8470f9b4e2276228d70bccb360b69514668b3a1021ec46dd95a06d42",
    (1536, 24, (16, 16), True):
        "2d8c85d10a174603f6416f233660268f0d80905cdb3acd95ae63ab6b6d7500a5",
}


@pytest.mark.parametrize("key", list(SWIN_ATTN_BF16_SHA256),
                         ids=lambda k: f"{k[0]}-{k[3]}")
def test_window_attention_bf16_keeps_its_output(dev, key):
    """The bf16 Swin attention gives its output of before the template bit
    for bit."""
    import hashlib

    c, heads, hw, shifted = key
    win, b = 10, 2
    p = _block_weights(dev, c, heads, win, False, seed=17)
    g = torch.Generator().manual_seed(18)
    qkv = torch.randn(b * hw[0] * hw[1], 3 * c, generator=g).to(
        dev, torch.bfloat16)
    shift = kswin.effective_shift(hw, win, shifted)
    got = kswin.window_attention(qkv, p, b, hw, heads, win, shift)
    digest = hashlib.sha256(
        got.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    print(f"swin attention bf16 {key}: sha256 {digest}")
    assert digest == SWIN_ATTN_BF16_SHA256[key]


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


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("c,heads,hw", [
    (192, 3, (23, 27)),  # KITTI stage-0 widths, pad tokens on both axes
    (1536, 24, (7, 7)),  # stage-3 widths: Wqkv far beyond shared memory
    (96, 3, (23, 27)),   # head width 32: the scale 32^-0.5 is inexact
])
def test_window_msa_kernel(dev, shifted, c, heads, hw):
    """Kernel 7 on the token grid (the attention's index math pads, shifts
    and partitions) against partition -> plain -> merge; its attention
    launch alone against the plain attention (MSA variant) on the same
    qkv, within 1e-2 as the Swin chain's."""
    win = 5 if c == 1536 else 10
    p = _block_weights(dev, c, heads, win, False, seed=11)
    g = torch.Generator().manual_seed(12)
    y = torch.randn(2, hw[0] * hw[1], c, generator=g).to(dev, torch.bfloat16)
    shift = kswin.effective_shift(hw, win, shifted)
    args = (y, hw, win, shift, p.rel_bias, p.qkv, p.proj, heads)
    kb.reset_launches()
    got = kwmsa.window_msa(*args)
    want = kwmsa.window_msa_grid_plain(*args)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["window_msa"] == 3
    assert kb.INSTANCES == {"window_msa/gemm_bf16": 2,
                            "window_msa/attn_bf16": 1}
    assert got.shape == y.shape and got.dtype == y.dtype
    assert _rel(got, want) <= 2e-2
    qkv = kswin.gemm("window_msa", y.reshape(-1, c), p.qkv, kswin.EPI_BIAS)
    o = kswin.attention("window_msa", qkv, p.qkv.bias, p.rel_bias, 2, hw,
                        heads, win, shift, msa=True)
    o_plain = kswin.window_attention_plain(qkv, p.qkv.bias, p.rel_bias, 2,
                                           hw, heads, win, shift, msa=True)
    torch.cuda.synchronize()
    assert _rel(o, o_plain) <= 1e-2
    with pytest.raises(ValueError, match="bf16 or f32"):
        kwmsa.window_msa(y.half(), *args[1:])


@pytest.mark.parametrize("b,h,w,c,e", [
    (2, 64, 48, 128, 192), (1, 16, 24, 64, 64),
    (2, 32, 48, 128, 64), (2, 32, 48, 128, 128), (2, 32, 48, 128, 256),
    (2, 40, 280, 64, 192),   # gw 70: tiles that end inside a token row
    (1, 40, 280, 128, 256),  # one sample, an odd number of tiles
])
def test_patch_embed_kernel(dev, b, h, w, c, e):
    g = torch.Generator().manual_seed(13)
    canvas = torch.randn(b, h, w, c, generator=g).to(dev, torch.bfloat16)
    weight = (torch.randn(e, c, 4, 4, generator=g) / (16 * c) ** 0.5).to(
        dev, torch.bfloat16)
    vecs = [(base + 0.1 * torch.randn(e, generator=g)).to(dev, torch.bfloat16)
            for base in (0.0, 1.0, 0.0)]
    wm = kpe.embed_matrix(weight)
    kb.reset_launches()
    got = kpe.patch_embed(canvas, wm, *vecs, 4)
    want = kpe.patch_embed_plain(canvas, wm, *vecs, 4)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["patch_embed"] == 1
    assert got.shape == (b, (h // 4) * (w // 4), e)
    assert _rel(got, want) <= 1e-2
    with pytest.raises(ValueError, match="bf16 or f32"):
        kpe.patch_embed(canvas.half(), wm, *vecs, 4)


@pytest.mark.parametrize("c", [192, 384, 768, 1536])
def test_layer_norm_kernel(dev, c):
    g = torch.Generator().manual_seed(14)
    x = (0.5 + torch.randn(3, 517, c, generator=g)).to(dev, torch.bfloat16)
    w = (1 + 0.1 * torch.randn(c, generator=g)).to(dev, torch.bfloat16)
    b = (0.1 * torch.randn(c, generator=g)).to(dev, torch.bfloat16)
    kb.reset_launches()
    got = kln.layer_norm(x, w, b)
    want = kln.layer_norm_plain(x, w, b)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["layer_norm"] == 1 and got.dtype == torch.bfloat16
    assert _rel(got, want) <= 1e-2
    with pytest.raises(ValueError, match="bf16 or f32"):
        kln.layer_norm(x.half(), w, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (8, 125 * 125, 192), (8, 63 * 63, 384), (8, 32 * 32, 768),
    (8, 16 * 16, 1536),                       # path E's calls
    (3, 37, 8), (2, 33, 2048), (2, 21, 200),  # the widths' ends, 25 words
    (1, 1, 192), (1, 67, 384), (1, 3, 1536),  # a partial group and block
], ids=lambda s: "x".join(map(str, s)))
def test_layer_norm_kernel_plan(dev, dtype, shape):
    """Kernel 9 in both instances at path E's shapes, at C = 8 and 2048, at
    a word count no power of two divides, and at token counts that leave a
    group's step and the grid's last block partly empty
    (``ops/layer_norm.py::plan``): within 1e-2 (bf16) or 1e-4 (f32) of the
    plain version's largest value."""
    g = torch.Generator().manual_seed(shape[-1] + shape[1])
    c = shape[-1]
    x = (0.5 + torch.randn(shape, generator=g)).to(dev, dtype)
    w = (1 + 0.1 * torch.randn(c, generator=g)).to(dev, dtype)
    b = (0.1 * torch.randn(c, generator=g)).to(dev, dtype)
    kb.reset_launches()
    got = kln.layer_norm(x, w, b)
    want = kln.layer_norm_plain(x, w, b)
    torch.cuda.synchronize()
    inst = "bf16" if dtype == torch.bfloat16 else "f32"
    assert kb.INSTANCES == {f"layer_norm/{inst}": 1}
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel(got, want) <= (1e-2 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("cap", [256, 8192])
def test_stream_pfn_kernel(dev, cap):
    """Kernel 10 on a capped stream: the cap binds (256) or not (8192)."""
    rng = np.random.default_rng(15)
    pts = rng.uniform(-9.9, 9.9, (2, 8192, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(-3, 3, (2, 8192))
    pts[0, :500, :2] = 1.1 + rng.uniform(0, 0.2, (500, 2))
    msk = np.ones((2, 8192), bool)
    msk[1, 6000:] = False
    sp = pillarize_stream(torch.as_tensor(pts, device=dev).to(torch.bfloat16),
                          torch.as_tensor(msk, device=dev),
                          max_points_per_pillar=32, max_pillars=cap, **GEO)
    nv = sp.valid.sum(1).to(torch.int32)
    wts = _pfn_weights(dev)
    kw = dict(k=32, with_distance=True, grid_w=W,
              voxel_size=GEO["voxel_size"], x0=GEO["x_range"][0],
              y0=GEO["y_range"][0], out_dtype=torch.bfloat16)
    kb.reset_launches()
    table, stats = kpfn.stream_pfn(sp, wts, num_valid=nv, **kw)
    want, wstats = kpfn.stream_pfn_plain(sp, wts, **kw)
    torch.cuda.synchronize()
    assert kb.LAUNCHES["stream_pfn"] == 2
    assert (table.shape == want.shape == (2, cap, 128))
    assert _rel(table, want) <= 1e-2
    np.testing.assert_allclose(stats.cpu().numpy(), wstats.cpu().numpy(),
                               rtol=1e-3)
    with pytest.raises(ValueError, match="weights' dtype"):
        kpfn.stream_pfn(sp._replace(pts=sp.pts.float()), wts, num_valid=nv,
                        **kw)
