"""Kernel 7's plain version (``ops/window_msa.py``) against the TPU kernel
``fused_window_msa(interpret=True)`` (at head widths 16 and 32: at 32 the
place of the scale changes the rounding) and against the JAX XLA
``ShiftWindowMSA(use_pallas=False)``, shifted and unshifted; its grid form
(the block's tokens in and out) against the partition, the window form and
the merge; the attention kernel's index math (windows, padding, shift,
region labels) against the partition and the shift mask; and the port's
unfused eval block with kernel 7 against the JAX XLA block.

Tolerances, relative to the reference's largest magnitude: f32 1e-5 (the
same f32 arithmetic; the XLA form scales q before its product and adds the
qkv bias in the product's dtype, the kernel scales after it and adds the
bias in f32, which in f32 differs by rounding only); bf16 2e-2 (the
kernel's and XLA's bf16 roundings sit at different places).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.models.swin import (  # noqa: E402
    ShiftWindowMSA as JaxShiftMSA, SwinBlock as JaxBlock)
from mask_bev_tpu.ops.pallas_window_msa import fused_window_msa  # noqa: E402
from mask_bev_tpu_torch.models.convert import load_flax  # noqa: E402
from mask_bev_tpu_torch.models.swin import SwinBlock  # noqa: E402
from mask_bev_tpu_torch.ops.swin_block import (  # noqa: E402
    attention, make_dense, merge_windows, partition_windows,
    rel_bias_from_table, shift_attn_mask, shift_mask)
from mask_bev_tpu_torch.ops.window_msa import (  # noqa: E402
    _project, window_msa, window_msa_grid_plain, window_msa_plain)

C, HEADS, WIN, HW = 48, 3, 5, (7, 9)  # pads to 10 x 10: pad tokens
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _msa_params(seed=0, c=C, heads=HEADS):
    rng = np.random.default_rng(seed)
    wqkv = rng.normal(size=(c, 3 * c)).astype(np.float32) / np.sqrt(c)
    bqkv = (0.1 * rng.normal(size=3 * c)).astype(np.float32)
    wproj = rng.normal(size=(c, c)).astype(np.float32) / np.sqrt(c)
    bproj = (0.1 * rng.normal(size=c)).astype(np.float32)
    table = (0.1 * rng.normal(size=((2 * WIN - 1) ** 2, heads))).astype(
        np.float32)
    return wqkv, bqkv, wproj, bproj, table


def _port_dense(w, b, td):
    # flax kernel (in, out) -> torch Linear weight (out, in)
    return make_dense(torch.as_tensor(w.T).to(td), torch.as_tensor(b), False)


def _plain_against_pallas(shift, dtype, c, heads):
    jd, td = _DT[dtype]
    wqkv, bqkv, wproj, bproj, table = _msa_params(c=c, heads=heads)
    rng = np.random.default_rng(1)
    y = rng.normal(size=(2, HW[0] * HW[1], c)).astype(np.float32)
    yt = torch.as_tensor(y).to(td)
    xw = partition_windows(yt, HW, WIN, shift)  # (B, nW, n, C)
    rel = rel_bias_from_table(torch.as_tensor(table).to(td), WIN)
    mask = shift_mask(HW, WIN, shift, "cpu")
    got = window_msa_plain(xw, rel, mask, _port_dense(wqkv, bqkv, td),
                           _port_dense(wproj, bproj, td), heads)
    assert got.dtype == td and got.shape == xw.shape
    # the wrapper takes the plain version (on the token grid) for CPU
    # tensors
    torch.testing.assert_close(
        window_msa(yt, HW, WIN, shift, rel, _port_dense(wqkv, bqkv, td),
                   _port_dense(wproj, bproj, td), heads),
        merge_windows(got, HW, WIN, shift), rtol=0, atol=0)

    nw = xw.shape[1]
    bias = np.broadcast_to(rel.numpy()[None], (nw,) + rel.shape)
    if shift:
        hp, wp = -(-HW[0] // WIN) * WIN, -(-HW[1] // WIN) * WIN
        bias = bias + shift_attn_mask(hp, wp, WIN, shift)[:, None]
    want = fused_window_msa(
        jnp.asarray(xw.float().numpy()).astype(jd), jnp.asarray(bias),
        jnp.asarray(wqkv).astype(jd), jnp.asarray(bqkv).astype(jd),
        jnp.asarray(wproj).astype(jd), jnp.asarray(bproj).astype(jd),
        num_heads=heads, group=4, interpret=True)
    assert want.dtype == jd
    assert _rel(got.float().numpy(), want) <= (
        2e-2 if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 2])
def test_plain_matches_pallas_kernel(shift, dtype):
    _plain_against_pallas(shift, dtype, C, HEADS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 2])
def test_plain_matches_pallas_kernel_hd32(shift, dtype):
    """Head width 32 (C 96, 3 heads): the scale 32^-0.5 is inexact, so
    scaling the score (the TPU kernel) and scaling q (the XLA block) round
    differently; the plain version must scale as the kernel does."""
    _plain_against_pallas(shift, dtype, 96, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 2])
def test_plain_matches_xla_shift_window_msa(shift, dtype):
    jd, td = _DT[dtype]
    wqkv, bqkv, wproj, bproj, table = _msa_params(2)
    rng = np.random.default_rng(3)
    y = rng.normal(size=(2, HW[0] * HW[1], C)).astype(np.float32)
    jm = JaxShiftMSA(C, HEADS, WIN, shift=shift, use_pallas=False)
    v = {"params": {"w_msa": {
        "qkv": {"kernel": jnp.asarray(wqkv).astype(jd),
                "bias": jnp.asarray(bqkv).astype(jd)},
        "proj": {"kernel": jnp.asarray(wproj).astype(jd),
                 "bias": jnp.asarray(bproj).astype(jd)},
        "rel_pos_bias_table": jnp.asarray(table).astype(jd)}}}
    want = jm.apply(v, jnp.asarray(y).astype(jd), HW, train=False)
    yt = torch.as_tensor(y).to(td)
    # the port bf16-rounds the biases as the model's bf16 cast does
    qkv = _port_dense(wqkv, torch.as_tensor(bqkv).to(td).float().numpy(), td)
    proj = _port_dense(wproj, torch.as_tensor(bproj).to(td).float().numpy(),
                       td)
    rel = rel_bias_from_table(torch.as_tensor(table).to(td), WIN)
    xw = window_msa_plain(partition_windows(yt, HW, WIN, shift), rel,
                          shift_mask(HW, WIN, shift, "cpu"), qkv, proj,
                          HEADS)
    got = merge_windows(xw, HW, WIN, shift)
    assert got.shape == tuple(want.shape)
    assert _rel(got.float().numpy(), want) <= (
        2e-2 if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("shift", [False, True])
def test_unfused_block_with_kernel7_matches_xla_block(shift):
    """The port's eval block off the fused path, its attention on kernel 7
    (``use_pallas_attention``), against the JAX XLA block (f32)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, HW[0] * HW[1], C)).astype(np.float32)
    jb = JaxBlock(C, HEADS, WIN, shift=shift, use_pallas=True)
    v = jax.device_get(jb.init(jax.random.PRNGKey(0), jnp.asarray(x), HW,
                               train=False))
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(
            np.float32), v)
    want = np.asarray(jb.apply(v, jnp.asarray(x), HW, train=False))
    blk = load_flax(SwinBlock(C, HEADS, WIN, shift=shift), v)
    with torch.no_grad():
        got = blk(torch.as_tensor(x), HW, fused=False,
                  fused_attention=True).numpy()
    assert _rel(got, want) <= 1e-5


def _kernel_windows(hw, win, shift):
    """The attention kernel's index math (``csrc/window_attn.cuh``), per
    window of the rolled, padded grid and token of the window: the token's
    row in the (H*W) grid (-1 for a pad token) and its shift-region label."""
    h, w = hw
    hp, wp = -(-h // win) * win, -(-w // win) * win

    def region(r, size):
        return 0 if r < size - win else (1 if r < size - shift else 2)

    tok, lab = [], []
    for wi in range((hp // win) * (wp // win)):
        wy, wx = divmod(wi, wp // win)
        tr, lr = [], []
        for r in range(win * win):
            gy, gx = wy * win + r // win, wx * win + r % win
            ro, co = (gy + shift) % hp, (gx + shift) % wp
            tr.append(ro * w + co if ro < h and co < w else -1)
            lr.append(region(gy, hp) * 3 + region(gx, wp) if shift else 0)
        tok.append(tr)
        lab.append(lr)
    return np.array(tok), np.array(lab)


@pytest.mark.parametrize("hw,win,shift", [
    ((7, 9), 5, 0), ((7, 9), 5, 2), ((23, 27), 10, 5), ((12, 12), 4, 2)])
def test_kernel_index_math_matches_partition(hw, win, shift):
    """The kernel's windows, padding and shift equal
    ``partition_windows`` of the token indices (pad tokens: zero rows),
    and its region labels give ``shift_attn_mask``."""
    h, w = hw
    tok, lab = _kernel_windows(hw, win, shift)
    ids = torch.arange(1, h * w + 1, dtype=torch.float64)[None, :, None]
    want = partition_windows(ids, hw, win, shift)[0, :, :, 0].long() - 1
    np.testing.assert_array_equal(tok, want.numpy())
    hp, wp = -(-h // win) * win, -(-w // win) * win
    mask = np.where(lab[:, :, None] != lab[:, None, :], -100.0, 0.0)
    want_mask = (shift_attn_mask(hp, wp, win, shift) if shift
                 else np.zeros_like(mask))
    np.testing.assert_array_equal(mask, want_mask)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 2])
def test_grid_plain_is_partition_plain_merge(shift, dtype):
    """Kernel 7's grid form on the CPU (``window_msa`` and its plain
    version) equals partition -> ``window_msa_plain`` -> merge exactly, on
    a grid with pad tokens; and the attention launch's plain version (MSA
    variant) between the plain qkv and proj products gives it too."""
    _, td = _DT[dtype]
    wqkv, bqkv, wproj, bproj, table = _msa_params(5)
    y = torch.as_tensor(np.random.default_rng(6).normal(
        size=(2, HW[0] * HW[1], C)).astype(np.float32)).to(td)
    qkv, proj = _port_dense(wqkv, bqkv, td), _port_dense(wproj, bproj, td)
    rel = rel_bias_from_table(torch.as_tensor(table).to(td), WIN)
    want = merge_windows(
        window_msa_plain(partition_windows(y, HW, WIN, shift), rel,
                         shift_mask(HW, WIN, shift, "cpu"), qkv, proj,
                         HEADS), HW, WIN, shift)
    got = window_msa_grid_plain(y, HW, WIN, shift, rel, qkv, proj, HEADS)
    assert got.shape == y.shape and got.dtype == td
    assert torch.equal(got, want)
    assert torch.equal(window_msa(y, HW, WIN, shift, rel, qkv, proj, HEADS),
                       want)
    t = _project(y.reshape(-1, C), qkv)
    o = attention("window_msa", t, qkv.bias, rel, 2, HW, HEADS, WIN, shift,
                  msa=True)
    got = _project(o, proj).reshape(y.shape)
    assert _rel(got.float().numpy(), want.float().numpy()) <= (
        1e-2 if dtype == "bfloat16" else 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 2])
def test_attention_plain_swin_variant_matches_block_form(shift, dtype):
    """The attention launch's plain version, Swin variant (kernel 3's
    chain: qkv product on the tokens, attention, proj product), against
    the XLA form of the block's window MSA on partitioned windows
    (``ops/swin_block.py::window_msa_plain``), shifted and unshifted, on a
    grid with pad tokens."""
    from mask_bev_tpu_torch.ops.swin_block import dense
    from mask_bev_tpu_torch.ops.swin_block import (
        window_msa_plain as block_msa_plain)

    _, td = _DT[dtype]
    blk = SwinBlock(C, HEADS, WIN, shift=bool(shift))
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for prm in blk.parameters():
            prm.add_(0.05 * torch.randn(prm.shape, generator=g))
    p = blk.to(td).weights()
    y = torch.as_tensor(np.random.default_rng(8).normal(
        size=(2, HW[0] * HW[1], C)).astype(np.float32)).to(td)
    want = block_msa_plain(y, p, HW, WIN, HEADS, shift, False)
    o = attention("swin_block", dense(y, p.qkv, False).reshape(-1, 3 * C),
                  p.qkv.bias, p.rel_bias, 2, HW, HEADS, WIN, shift,
                  msa=False)
    got = dense(o, p.proj, False).reshape(y.shape)
    assert got.dtype == td and got.shape == want.shape
    assert _rel(got.float().numpy(), want.float().numpy()) <= (
        1e-2 if dtype == "bfloat16" else 1e-6)
