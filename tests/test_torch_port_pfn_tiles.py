"""The PFN kernels' host-side layouts, on the CPU.

Kernels 1 and 10 (``csrc/pfn.cu``) take whole pillars in tiles of the
compacted kept-point order; the tile directory
(``ops/stream_pillars.py::pfn_tiles``), the capped stream's kept counts
(``kept_counts``) and the packed weights (``ops/pfn.py::pack_weights``) are
computed in Python, so they are held here without a card: every pillar in
exactly one tile, no tile over 64 + 31 = 95 rows, the pillars of a tile
contiguous, at ragged counts of 1-32.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from mask_bev_tpu_torch.ops import decoder_stack as kdec  # noqa: E402
from mask_bev_tpu_torch.ops import pfn as kpfn  # noqa: E402
from mask_bev_tpu_torch.ops.stream_pillars import (  # noqa: E402
    PFN_TILE_ROWS, kept_counts, pfn_tiles, pillarize_stream,
    pillarize_stream_packed)

GEO = dict(x_range=(-10.0, 10.0), y_range=(-10.0, 10.0),
           z_range=(-4.0, 4.0), voxel_size=0.25)


def _check_tiles(counts, num, n_rows):
    row0, first = pfn_tiles(counts, num, n_rows)
    b, p = counts.shape
    t = -(-n_rows // PFN_TILE_ROWS)
    assert first.shape == (b, t + 1) and row0.dtype == torch.int32
    for s in range(b):
        n = int(num[s])
        c = counts[s, :n].long()
        r0 = row0[s, :n].long()
        assert torch.equal(r0, torch.cumsum(c, 0) - c)
        f = first[s].long()
        # tiles partition [0, n) in order: every pillar in exactly one tile
        assert int(f[0]) == 0 and int(f[-1]) == n
        assert bool((f[1:] >= f[:-1]).all())
        owner = torch.repeat_interleave(torch.arange(t), f[1:] - f[:-1])
        assert owner.numel() == n
        # a tile owns the pillars whose first row is in [64 t, 64 t + 64)
        assert torch.equal(owner, torch.div(r0, PFN_TILE_ROWS,
                                            rounding_mode="floor"))
        for k in range(t):
            lo, hi = int(f[k]), int(f[k + 1])
            if lo == hi:
                continue
            rows = int(r0[hi - 1] + c[hi - 1] - r0[lo])
            assert 1 <= rows <= PFN_TILE_ROWS + 31
            assert hi - lo <= PFN_TILE_ROWS
    return row0, first


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiles_at_ragged_counts(seed):
    rng = np.random.default_rng(seed)
    b, p = 3, 700
    counts = torch.as_tensor(rng.integers(1, 33, (b, p)), dtype=torch.int32)
    counts[0, :40] = 32  # long pillars straddle tile boundaries
    counts[1, ::7] = 1
    num = torch.tensor([700, 513, 0], dtype=torch.int32)
    _, first = _check_tiles(counts, num, n_rows=32 * p)
    assert int(first[2, -1]) == 0  # no pillar: every tile empty


def test_tiles_reach_the_most_rows():
    """A pillar of 32 points whose first row is the 64th of its tile makes
    the tile 95 rows long."""
    counts = torch.ones((1, 100), dtype=torch.int32)
    counts[0, 63] = 32
    num = torch.tensor([100], dtype=torch.int32)
    row0, first = _check_tiles(counts, num, n_rows=200)
    assert int(first[0, 1]) == 64
    assert int(row0[0, 63] + counts[0, 63] - row0[0, 0]) == 95


def test_tiles_of_a_pillarized_stream():
    """Kernel 1's directory (every occupied cell, first K points kept) and
    kernel 10's (capped slots, kept counts from the stream)."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-9.9, 9.9, (2, 4096, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(-3, 3, (2, 4096))
    pts[0, :700, :2] = 1.1 + rng.uniform(0, 0.2, (700, 2))
    msk = np.ones((2, 4096), bool)
    msk[1, 3000:] = False
    p_t, m_t = torch.as_tensor(pts), torch.as_tensor(msk)
    ps = pillarize_stream_packed(p_t, m_t, max_points_per_pillar=32, **GEO)
    _check_tiles(ps.counts, ps.num_pillars, 4096)
    assert int(ps.counts.max()) == 32
    for cap in (256, 4096):
        sp = pillarize_stream(p_t, m_t, max_points_per_pillar=32,
                              max_pillars=cap, **GEO)
        nv = sp.valid.sum(1).to(torch.int32)
        kc = kept_counts(sp.pid, sp.kept, cap)
        # the kept rows of slot r are [starts, starts + count), each of
        # them kept and of the slot's cell
        for s in range(2):
            for r in range(int(nv[s])):
                st, n = int(sp.starts[s, r]), int(kc[s, r])
                assert 1 <= n <= 32
                assert bool(sp.kept[s, st:st + n].all())
                assert bool((sp.pid[s, st:st + n] == sp.cells[s, r]).all())
            assert int(kc[s, int(nv[s]):].sum()) == 0
            assert int(kc[s].sum()) == int(sp.kept[s].sum())
        _check_tiles(kc, nv, 4096)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("in0", [9, 10])
def test_pack_weights(dtype, in0):
    """Each layer's W is zero-padded to a multiple of 16 rows; bf16 in the
    decoder's m16n8k16 B-fragment order, f32 in m16n8k8 (TF32) B-fragment
    order; g and b f32, padded to a multiple of 4 floats."""
    g = torch.Generator().manual_seed(in0)
    wts, k = [], in0
    for u in (16, 32):
        wts.append((torch.randn(k, u, generator=g).to(dtype),
                    torch.randn(u, generator=g), torch.randn(u, generator=g)))
        k = 2 * u
    wbuf, gb, dims = kpfn.pack_weights(wts, "cpu")
    assert dims == [2, in0, 16, 32, 32]
    assert wbuf.dtype == dtype and gb.dtype == torch.float32
    off = 0
    for (w, _, _) in wts:
        kp = -(-w.shape[0] // 16) * 16
        size = kp * w.shape[1]
        part = wbuf[off:off + size]
        full = (kdec.unpack_fragments(part, kp, w.shape[1])
                if dtype == torch.bfloat16
                else kpfn.unpack_fragments_tf32(part, kp, w.shape[1]))
        assert torch.equal(full[:w.shape[0]], w)
        assert not bool(full[w.shape[0]:].any())
        off += size
    assert off == wbuf.numel()
    want = torch.cat([t for (_, gg, bb) in wts for t in (gg, bb)])
    assert gb.numel() % 4 == 0 and torch.equal(gb[:want.numel()], want)


@pytest.mark.parametrize("k,n", [(16, 64), (128, 64), (128, 128), (8, 8)])
def test_f32_fragment_words(k, n):
    """The f32 weights' words sit where ``mma.sync`` m16n8k8 reads its B
    fragment: word ``(j nks + ks) 32 + 4g + t`` of the packed buffer holds
    (W[8 ks + t, 8j + g], W[8 ks + t + 4, 8j + g]), one 8-byte load a lane;
    unpacking gives W back."""
    w = torch.arange(k * n, dtype=torch.float32).reshape(k, n)
    p = kpfn.pack_fragments_tf32(w)
    assert p.numel() == k * n
    assert torch.equal(kpfn.unpack_fragments_tf32(p, k, n), w)
    words = p.reshape(n // 8, k // 8, 8, 4, 2)  # (j, ks, g, t, half)
    j, ks, g, t, h = (torch.arange(s).reshape(
        [-1 if i == d else 1 for i in range(5)])
        for d, s in enumerate(words.shape))
    want = w[8 * ks + t + 4 * h, 8 * j + g]
    assert torch.equal(words, want)
