"""Kernel 7's plain version (``ops/window_msa.py``) against the TPU kernel
``fused_window_msa(interpret=True)`` and against the JAX XLA
``ShiftWindowMSA(use_pallas=False)``, shifted and unshifted; and the port's
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
    make_dense, merge_windows, partition_windows, rel_bias_from_table,
    shift_attn_mask, shift_mask)
from mask_bev_tpu_torch.ops.window_msa import (  # noqa: E402
    window_msa, window_msa_plain)

C, HEADS, WIN, HW = 48, 3, 5, (7, 9)  # pads to 10 x 10: pad tokens
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _msa_params(seed=0):
    rng = np.random.default_rng(seed)
    wqkv = rng.normal(size=(C, 3 * C)).astype(np.float32) / np.sqrt(C)
    bqkv = (0.1 * rng.normal(size=3 * C)).astype(np.float32)
    wproj = rng.normal(size=(C, C)).astype(np.float32) / np.sqrt(C)
    bproj = (0.1 * rng.normal(size=C)).astype(np.float32)
    table = (0.1 * rng.normal(size=((2 * WIN - 1) ** 2, HEADS))).astype(
        np.float32)
    return wqkv, bqkv, wproj, bproj, table


def _port_dense(w, b, td):
    # flax kernel (in, out) -> torch Linear weight (out, in)
    return make_dense(torch.as_tensor(w.T).to(td), torch.as_tensor(b), False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 2])
def test_plain_matches_pallas_kernel(shift, dtype):
    jd, td = _DT[dtype]
    wqkv, bqkv, wproj, bproj, table = _msa_params()
    rng = np.random.default_rng(1)
    y = rng.normal(size=(2, HW[0] * HW[1], C)).astype(np.float32)
    yt = torch.as_tensor(y).to(td)
    xw = partition_windows(yt, HW, WIN, shift)  # (B, nW, n, C)
    rel = rel_bias_from_table(torch.as_tensor(table).to(td), WIN)
    mask = shift_mask(HW, WIN, shift, "cpu")
    got = window_msa_plain(xw, rel, mask, _port_dense(wqkv, bqkv, td),
                           _port_dense(wproj, bproj, td), HEADS)
    assert got.dtype == td and got.shape == xw.shape
    # the wrapper takes the plain version for CPU tensors
    torch.testing.assert_close(
        window_msa(xw, rel, mask, _port_dense(wqkv, bqkv, td),
                   _port_dense(wproj, bproj, td), HEADS), got, rtol=0, atol=0)

    nw = xw.shape[1]
    bias = np.broadcast_to(rel.numpy()[None], (nw,) + rel.shape)
    if shift:
        hp, wp = -(-HW[0] // WIN) * WIN, -(-HW[1] // WIN) * WIN
        bias = bias + shift_attn_mask(hp, wp, WIN, shift)[:, None]
    want = fused_window_msa(
        jnp.asarray(xw.float().numpy()).astype(jd), jnp.asarray(bias),
        jnp.asarray(wqkv).astype(jd), jnp.asarray(bqkv).astype(jd),
        jnp.asarray(wproj).astype(jd), jnp.asarray(bproj).astype(jd),
        num_heads=HEADS, group=4, interpret=True)
    assert want.dtype == jd
    assert _rel(got.float().numpy(), want) <= (
        2e-2 if dtype == "bfloat16" else 1e-5)


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
