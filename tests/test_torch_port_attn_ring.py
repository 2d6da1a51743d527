"""The host mirrors of the flagship widths' ring attention
(``csrc/window_attn.cuh::window_attn_ring_kernel``), on the CPU.

* The work walk, a numpy model of the kernel's (``_walk``, ``_item``): a
  persistent grid of ``min(items, resident blocks x SMs)`` blocks, block k
  walking the (head, sample, window) items ``[items k // grid, items (k +
  1) // grid)`` head-major. Each item is covered exactly
  once at the main path's four stage grids (125^2, 63^2, 32^2, 16^2 at
  window 10, 3-24 heads, batch 8), at windows 7 and 11, and at the shapes
  whose outputs the card tests hold by digest; the blocks differ by at most
  one item, and a block gathers its head's table a few times at most.
* The ring's token slots: the slot an item writes is never one that an
  item in flight reads.
* The compact table the kernel gathers (one entry a relative offset,
  ``rel_table_tokens``; the Swin variant rounded to bf16, the MSA variant
  f32) gives back, through ``rel_offsets``, the (n, n) bias of
  ``rel_bias_from_table`` that the first kernel staged (bf16-rounded in
  the Swin variant), bit for bit, at windows 7-11.
* Its shared memory fits the blocks an SM each instance is built for, and
  the host's constants are the source's.

On the card (``cuda`` marker; skipped without one): the ring kernel at the
flagship widths, windows 5, 7, 10 and 11, both variants, against the plain
version (within 1e-2 of the largest value, as the Swin chain's attention),
counted under its instance.
"""
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402
from mask_bev_tpu_torch.ops import swin_block as kswin  # noqa: E402

SMS = 132           # SMs of the H100 SXM
SMEM_SM = 228 * 1024
SMEM_RESERVED = 1024

# (batch, grid, heads, window): the main path's stages, windows 7 and 11
# on its stage-0 grid, and the digest shapes of the card tests
WALKS = [
    (8, (125, 125), 3, 10), (8, (63, 63), 6, 10), (8, (32, 32), 12, 10),
    (8, (16, 16), 24, 10),
    (8, (125, 125), 3, 7), (8, (125, 125), 3, 11),
    (2, (125, 125), 3, 10), (2, (16, 16), 24, 10), (2, (63, 63), 8, 10),
]


def _walk(items: int, grid: int) -> np.ndarray:
    """Block k walks items ``[w[k], w[k + 1])``, ``w[k] = items k //
    grid`` (``window_attn_ring_kernel``'s ``lo`` and ``cnt``)."""
    return np.arange(grid + 1, dtype=np.int64) * items // grid


def _item(it, b: int, nw: int):
    """(head, sample, window) of item ``it`` (``ring_item``): head-major,
    then the sample, then the window in the padded grid's row-major order
    of ``nw`` windows."""
    hb = it // nw
    return hb // b, hb % b, it % nw


def _windows(hw, win):
    hp, wp = -(-hw[0] // win) * win, -(-hw[1] // win) * win
    return (hp // win) * (wp // win)


@pytest.mark.parametrize("per_sm", [1, 2, 3, 4])
@pytest.mark.parametrize("b,hw,heads,win", WALKS)
def test_walk_covers_each_item_once(b, hw, heads, win, per_sm):
    nw = _windows(hw, win)
    items = heads * b * nw
    grid = min(items, per_sm * SMS)
    w = _walk(items, grid)
    sizes = np.diff(w)
    assert w[0] == 0 and w[-1] == items
    assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1
    it = np.concatenate([np.arange(lo, hi) for lo, hi in zip(w[:-1], w[1:])])
    np.testing.assert_array_equal(it, np.arange(items))
    h, s, wi = _item(it, b, nw)
    assert h.min() == 0 and h.max() == heads - 1
    assert s.min() == 0 and s.max() == b - 1
    assert wi.min() == 0 and wi.max() == nw - 1
    key = (h * b + s) * nw + wi
    np.testing.assert_array_equal(np.sort(key), np.arange(items))
    # head-major: a block's items change head at most ceil(size / (b nw))
    # + 1 times, so it gathers its table that many times at most
    for lo, hi in zip(w[:-1], w[1:]):
        hh = _item(np.arange(lo, hi), b, nw)[0]
        gathers = 1 + int((np.diff(hh) != 0).sum())
        assert gathers <= -(-(hi - lo) // (b * nw)) + 1


@pytest.mark.parametrize("b,hw,heads,win", WALKS[:4])
def test_walk_fills_whole_waves(b, hw, heads, win):
    """At the main path's stages every resident block has work (the grid
    is one wave of the blocks the SMs hold at once), where the first
    kernel's grid of (windows / 4, heads, B) blocks left its last wave
    partly empty (stage 2: 1.45 waves; stage 3: 192 blocks for 264)."""
    per_sm = kswin.attn_blocks(False, win, 64)
    items = heads * b * _windows(hw, win)
    grid = min(items, per_sm * SMS)
    assert grid == per_sm * SMS
    sizes = np.diff(_walk(items, grid))
    assert sizes.max() - sizes.min() <= 1
    old = -(-_windows(hw, win) // 4) * heads * b
    assert old / (per_sm * SMS) != int(old / (per_sm * SMS))


def _token_slot_conflicts(slots: int, cnt: int = 20) -> int:
    """The ring kernel's schedule of token slots, item by item: after the
    first barrier of item k it copies k's v rows (reading slot k) and
    writes item k + 2's tokens; after the second it copies item k + 1's q
    and k rows (reading slot k + 1), then stores k's outputs (reading slot
    k). Counts the writes into a slot that an item still in flight reads."""
    bad = 0
    for k in range(cnt):
        if k + 2 < cnt:
            in_use = {k % slots, (k + 1) % slots}
            bad += (k + 2) % slots in in_use
    return bad


def test_token_slots_never_overwrite_items_in_flight():
    """``ATTN_RING_SLOTS`` slots suffice for the kernel's schedule; one
    fewer would overwrite tokens that an item in flight still reads."""
    assert _token_slot_conflicts(kswin.ATTN_RING_SLOTS) == 0
    assert _token_slot_conflicts(kswin.ATTN_RING_SLOTS - 1) > 0


@pytest.mark.parametrize("msa", [False, True])
@pytest.mark.parametrize("win", [7, 8, 9, 10, 11])
def test_compact_table_is_the_staged_bias(win, msa):
    """The ring kernel's table (gathered at ``rel_table_tokens``; the Swin
    variant's entries rounded to bf16 once) read at ``ro[i] - co[j]``
    equals the (n, n) bias the first kernel staged (Swin: each entry
    rounded to bf16; MSA: f32) bit for bit, for every head. The table is
    drawn off the bf16 grid, so the rounding is exercised."""
    heads, tw = 3, 2 * win - 1
    table = torch.as_tensor(np.random.default_rng(win).normal(
        0.0, 0.02, (tw * tw, heads)).astype(np.float32))
    rel = kswin.rel_bias_from_table(table, win)            # (heads, n, n)
    staged = rel.to(torch.bfloat16).float() if not msa else rel
    ti, tj = kswin.rel_table_tokens(win)
    compact = rel[:, ti, tj]
    if not msa:
        compact = compact.to(torch.bfloat16).float()
    ro, co = kswin.rel_offsets(win)
    idx = torch.as_tensor(ro[:, None] - co[None, :])
    got = compact[:, idx]
    assert got.shape == staged.shape
    assert torch.equal(got, staged)
    assert msa or not torch.equal(staged, rel)


@pytest.mark.parametrize("msa", [False, True], ids=["swin", "msa"])
@pytest.mark.parametrize("hd", kswin.ATTN_FLAGSHIP_DIMS)
@pytest.mark.parametrize("win", range(1, 12))
def test_ring_smem_fits(hd, win, msa):
    """The q, k, v rows at an odd number of 16-byte words a row,
    ``ATTN_RING_SLOTS`` token / label slots, the column offsets, the
    compact table and the bias expanded to n rows at stride n_pad + 8
    (bf16 Swin, f32 MSA), as ``window_attn_ring_smem`` sizes them: at
    window 10 the blocks an SM each instance is built for fit; at every
    window up to 11 one block fits (the launch sizes its grid by the
    occupancy the card reports)."""
    n = win * win
    n_pad = -(-n // 16) * 16
    ld = kswin.attn_width_ld(hd, False)
    assert (ld * 2 // 16) % 2 == 1
    slots = kswin.ATTN_RING_SLOTS
    table = 16 * -(-(2 * win - 1) ** 2 // 4)
    want = (3 * n_pad * ld * 2 + slots * 2 * n_pad * 4 + 4 * n_pad
            + table + n * (n_pad + 8) * (4 if msa else 2))
    got = kswin.attn_smem_bytes(win, hd, msa=msa)
    assert got == want
    assert got + SMEM_RESERVED <= SMEM_SM
    if n_pad == 112:
        blocks = kswin.attn_blocks(False, win, hd)
        assert blocks == kswin.ATTN_RING_BLOCKS == 2
        assert blocks * (got + SMEM_RESERVED) <= SMEM_SM


def _source_int(pattern: str) -> int:
    text = (pathlib.Path(kb.CSRC) / "window_attn.cuh").read_text()
    return int(re.search(pattern, text).group(1))


def test_ring_constants_are_the_sources():
    assert kswin.ATTN_RING_SLOTS == _source_int(
        r"constexpr int ATT_RING_SLOTS = (\d+);")
    assert kswin.ATTN_RING_BLOCKS == _source_int(
        r"constexpr int ATT_RING_BLOCKS = (\d+);")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's CUDA kernels (nvcc, sm_90a) "
                    "run only on a card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("win", [5, 7, 10, 11])
@pytest.mark.parametrize("hd", kswin.ATTN_FLAGSHIP_DIMS)
@pytest.mark.parametrize("msa", [False, True], ids=["swin", "msa"])
def test_ring_attention_on_the_card(dev, msa, hd, win, shifted):
    b, hw, heads = 2, (47, 53), 3
    c = hd * heads
    g = torch.Generator().manual_seed(hd + 100 * win + shifted)
    qkv = torch.randn(b * hw[0] * hw[1], 3 * c, generator=g).to(
        dev, torch.bfloat16)
    qb = (0.1 * torch.randn(3 * c, generator=g)).to(dev)
    table = (0.02 * torch.randn((2 * win - 1) ** 2, heads, generator=g)).to(
        dev, torch.bfloat16)
    rel = kswin.rel_bias_from_table(table, win)
    shift = kswin.effective_shift(hw, win, shifted)
    assert bool(shift) == shifted
    name = "window_msa" if msa else "swin_block"
    a = (qkv, qb, rel, b, hw, heads, win, shift)
    kb.reset_launches()
    got = kswin.attention(name, *a, msa=msa)
    torch.cuda.synchronize()
    assert kb.INSTANCES == {f"{name}/attn_bf16": 1}
    want = kswin.window_attention_plain(*a, msa=msa)
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()
                 / want.float().abs().max()) <= 1e-2
