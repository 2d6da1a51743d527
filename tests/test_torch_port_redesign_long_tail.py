"""The host mirrors of the long-window attention's bias index and of the
GEMM's N-tail plan, on the CPU.

* The long-window attention (``csrc/window_attn.cuh::
  window_attn_long_kernel``) stages a head's bias as the compact
  ((2w-1)^2) table, read from the expanded (heads, n, n) bias at one token
  pair an entry (``rel_table_tokens``), and gives the score of tokens i, j
  entry ``ro[i] - co[j]`` (``rel_offsets``). Held exactly against the JAX
  package's own gather (``WindowMSA.rel_bias`` through ``_rel_pos_index``)
  on the same seeded table, at windows 2, 7, 10, 11 (the head-width
  kernel's windows, ``window_attn_width_kernel``), 12, 13 and 16 and every
  head.
* The GEMM's plan (``gemm_tile_plan``): the flagship's 96-wide tiles for
  N % 8 == 0, else tiles fitted to N (``csrc/gemm_ntail.cu::nt_width``):
  N 4, 12, 100, 104 and 260 (one plan for every operand kind).
* The shared memory the attention's long instances take, as the C source
  sizes it, fits the blocks an SM each is built for.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.models.swin import WindowMSA, _rel_pos_index  # noqa: E402
from mask_bev_tpu_torch.ops import swin_block as kswin  # noqa: E402

HEADS = 3


def _jax_rel_bias(table: np.ndarray, win: int) -> np.ndarray:
    """The JAX package's (heads, n, n) bias from ``table`` (its
    ``WindowMSA.rel_bias``)."""
    c = 8 * HEADS
    msa = WindowMSA(dim=c, num_heads=HEADS, window=win)
    n = win * win
    variables = jax.jit(msa.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, n, c), jnp.float32))
    params = dict(variables["params"])
    params["rel_pos_bias_table"] = jnp.asarray(table)
    return np.asarray(msa.apply({"params": params}, n,
                                method=WindowMSA.rel_bias))


@pytest.mark.parametrize("win", [2, 7, 10, 11, 12, 13, 16])
def test_rel_offsets_index_the_jax_table(win):
    """ro[i] - co[j] is the JAX package's ``_rel_pos_index`` (and the
    port's), and the table tokens of each entry sit at that entry."""
    ro, co = kswin.rel_offsets(win)
    idx = ro[:, None] - co[None, :]
    np.testing.assert_array_equal(idx, _rel_pos_index(win, win))
    np.testing.assert_array_equal(idx, kswin.rel_pos_index(win, win))
    ti, tj = kswin.rel_table_tokens(win)
    tw = 2 * win - 1
    assert ti.shape == tj.shape == (tw * tw,)
    assert ti.min() >= 0 and tj.min() >= 0
    assert ti.max() < win * win and tj.max() < win * win
    np.testing.assert_array_equal(idx[ti, tj], np.arange(tw * tw))


@pytest.mark.parametrize("win", [2, 7, 10, 11, 12, 13, 16])
def test_compact_table_reproduces_rel_bias(win):
    """The kernel's compact table, gathered from the expanded bias, is the
    seeded table exactly, and its index gives back every head's expanded
    bias bit for bit, as the JAX package gathers it."""
    tw, n = 2 * win - 1, win * win
    table = np.random.default_rng(win).normal(
        0.0, 0.02, (tw * tw, HEADS)).astype(np.float32)
    rel = kswin.rel_bias_from_table(torch.as_tensor(table), win).numpy()
    np.testing.assert_array_equal(rel, _jax_rel_bias(table, win))
    ti, tj = kswin.rel_table_tokens(win)
    compact = rel[:, ti, tj]                     # (heads, tw^2)
    np.testing.assert_array_equal(compact, table.T)
    ro, co = kswin.rel_offsets(win)
    rebuilt = compact[:, ro[:, None] - co[None, :]]
    assert rebuilt.shape == (HEADS, n, n)
    np.testing.assert_array_equal(rebuilt, rel)


@pytest.mark.parametrize("n,want", [
    (4, ("ntail", 8, 1, "span")),
    (12, ("ntail", 16, 1, "span")),
    (100, ("ntail", 104, 1, "span")),
    (104, ("flagship", 96, 2, "registers")),
    (260, ("ntail", 88, 3, "rows")),
])
def test_gemm_tile_plan(n, want):
    """N 100 computes 104 columns in one tile (the first N-tail version:
    two 96-wide tiles, 192 columns); a tile that spans N stores one
    contiguous span; N 260 takes three tiles of 88."""
    plan = kswin.gemm_tile_plan(n)
    assert tuple(plan) == want
    assert plan.width * plan.tiles >= n
    assert plan.width * (plan.tiles - 1) < n
    if plan.instance == "ntail":
        assert plan.width % 8 == 0
        assert plan.width <= kswin.NTAIL_MAX_WIDTH
        assert plan.width - 8 < -(-n // plan.tiles)


def test_gemm_tile_plan_every_tail():
    """Every N % 8 != 0 up to 600: the fewest tiles of the widest width,
    each at most 7 columns past its share of N."""
    for n in range(1, 601):
        if n % 8 == 0:
            continue
        plan = kswin.gemm_tile_plan(n)
        top = kswin.NTAIL_MAX_WIDTH
        assert plan.tiles == -(-n // top)
        assert plan.width <= top and plan.width % 8 == 0
        assert 0 <= plan.width * plan.tiles - n < 8 * plan.tiles
        assert plan.store == ("span" if plan.tiles == 1 else "rows")


@pytest.mark.parametrize("win", [12, 13, 14, 15, 16])
@pytest.mark.parametrize("hd", kswin.ATTN_HEAD_DIMS)
def test_long_window_smem_fits_its_blocks(win, hd):
    """The long instances' shared memory (rows, token / label /
    column-offset rows, the compact table) as ``window_attn_long_smem``
    sizes it; window 12 in bf16 is built for two blocks an SM and fits
    them, with the 1 KB the card reserves for each."""
    n = win * win
    n_pad = -(-n // 16) * 16
    hs = kswin.attn_staged_dim(hd)
    table = -(-(2 * win - 1) ** 2 // 4) * 4 * 4
    for f32 in (False, True):
        rows = (2 * n_pad * (hs + 4) * 4 if f32
                else 3 * n_pad * (hs + 8) * 2)
        got = kswin.attn_smem_bytes(win, hd, f32)
        assert got == rows + 3 * n_pad * 4 + table
        assert got + 1024 <= 228 * 1024
    if win == 12:
        assert 2 * (kswin.attn_smem_bytes(win, hd) + 1024) <= 228 * 1024
