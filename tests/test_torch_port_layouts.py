"""Host-side layouts of the port's Hopper kernels, on the CPU.

The decoder stack reads its weights in ``mma.sync`` fragment order and lays
out its shared memory by a formula the host mirrors, as do the Swin
chain's attention launch and the patch embed (kernel 8), whose token tiles
the host plans. These layouts are computed in Python, so they are held
here without a card.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from mask_bev_tpu_torch.ops import decoder_stack as kdec  # noqa: E402
from mask_bev_tpu_torch.ops import patch_embed as kpe  # noqa: E402
from mask_bev_tpu_torch.ops import swin_block as kswin  # noqa: E402

SMEM_LIMIT = 227 * 1024  # a block's shared memory on the H100


@pytest.mark.parametrize("k,n", [(256, 256), (256, 2048), (2048, 256),
                                 (64, 128), (16, 8)])
def test_fragment_pack_round_trip(k, n):
    w = torch.randn(k, n, generator=torch.Generator().manual_seed(k + n))
    p = kdec.pack_fragments(w)
    assert p.shape == (k * n,)
    assert torch.equal(kdec.unpack_fragments(p, k, n), w)


def test_fragment_order():
    """Lane 4g + t of column tile j and row step ks holds W[16 ks + 2t + e]
    and W[16 ks + 8 + 2t + e] of column 8j + g: the B fragment of
    m16n8k16, one 8-byte load."""
    k, n = 48, 24
    w = torch.arange(k * n, dtype=torch.float32).reshape(k, n)
    p = kdec.pack_fragments(w).reshape(n // 8, k // 16, 32, 4)
    for j in range(n // 8):
        for ks in range(k // 16):
            for lane in range(32):
                g, t = divmod(lane, 4)
                col = 8 * j + g
                rows = [16 * ks + 2 * t, 16 * ks + 2 * t + 1,
                        16 * ks + 8 + 2 * t, 16 * ks + 9 + 2 * t]
                assert p[j, ks, lane].tolist() == w[rows, col].tolist()


def test_pack_weights_keeps_every_matrix_in_place():
    """Each matrix keeps its offset in the packed buffer, so the kernel's
    per-layer offsets are those of the plain concatenation."""
    c, f = 32, 64
    g = torch.Generator().manual_seed(1)

    def r(*s):
        return torch.randn(*s, generator=g)

    layers = [kdec.LayerWeights(*[r(c, c) if i % 2 == 0 and i < 16 else r(c)
                                  for i in range(22)],
                                r(c, f), r(f), r(f, c), r(c))
              for _ in range(2)]
    head = kdec.HeadWeights(r(c), r(c), r(c, c), r(c), r(c, c), r(c),
                            r(c, c), r(c))
    wd, wf = kdec.pack_weights(layers, head)
    mats = []
    for lw in layers:
        mats += [lw.wq, lw.wo, lw.sq, lw.sk, lw.sv, lw.so, lw.f1, lw.f2]
    mats += [head.m1, head.m2, head.m3]
    off = 0
    for m in mats:
        size = m.numel()
        assert torch.equal(
            kdec.unpack_fragments(wd[off:off + size], *m.shape), m)
        off += size
    assert off == wd.numel()
    assert wf.numel() == 2 * (13 * c + f) + 5 * c


@pytest.mark.parametrize("c,ffn,heads", [(256, 2048, 8), (64, 128, 2),
                                         (128, 512, 4), (256, 1024, 4)])
def test_shape_check_takes_widths_the_cluster_splits(c, ffn, heads):
    kdec.check_shape(45, c, ffn, heads, 3, 9)


@pytest.mark.parametrize("c,ffn,heads", [(40, 96, 1), (256, 4096, 8),
                                         (64, 120, 2), (256, 2048, 16)])
def test_shape_check_rejects_widths_the_cluster_cannot_split(c, ffn, heads):
    with pytest.raises(ValueError, match="clusters of 8 blocks"):
        kdec.check_shape(45, c, ffn, heads, 3, 9)


def test_decoder_smem_budget():
    """The flagship (45 queries of 256, up to 3969 keys, clusters of 8)
    fits a block; the count grows with the keys a block takes."""
    flag = kdec.smem_bytes(45, 256, 3969)
    assert flag == 225312 and flag <= SMEM_LIMIT
    assert kdec.smem_bytes(45, 256, 2 * 3969) > flag
    assert kdec.smem_bytes(48, 256, 3969) > SMEM_LIMIT
    # a small query count: the bf16 q copy outgrows the f32 XA replica
    q, c = 8, 64
    xa_f32 = q * (c + 4)
    assert kdec.smem_bytes(q, c, 400) > 4 * (4 * xa_f32)


@pytest.mark.parametrize("win,hd,want", [
    (10, 64, 76160), (10, 32, 54656), (5, 16, 7424)])
def test_attention_smem(win, hd, want):
    assert kswin.attn_smem_bytes(win, hd) == want


@pytest.mark.parametrize("hd", kswin.ATTN_HEAD_DIMS)
def test_attention_blocks_share_an_sm(hd):
    """The attention kernel is built for two blocks an SM (its launch
    bounds): at win 10 two blocks' shared memory fits the SM's 228 KB."""
    assert 2 * kswin.attn_smem_bytes(10, hd) <= 228 * 1024


@pytest.mark.parametrize("win,hd,f32,msa,want", [
    (10, 64, True, False, 109824), (10, 64, True, True, 109824),
    (10, 64, False, True, 97280), (10, 32, True, True, 81152),
    (5, 16, True, False, 9376)])
def test_attention_smem_instances(win, hd, f32, msa, want):
    """The f32 instances hold k, v (f32, stride hd + 4) and an f32 bias of
    n rows, q going to registers; the MSA variant's bf16 instance holds its
    bias in f32."""
    assert kswin.attn_smem_bytes(win, hd, f32, msa) == want


@pytest.mark.parametrize("f32,msa", [(False, True), (True, False),
                                     (True, True)])
@pytest.mark.parametrize("hd", kswin.ATTN_HEAD_DIMS)
def test_attention_instances_share_an_sm(hd, f32, msa):
    """Every instance of the attention template is built for two blocks an
    SM: at win 10 two blocks' shared memory, with the 1 KB the card
    reserves for each, fits the SM's 228 KB."""
    assert 2 * (kswin.attn_smem_bytes(10, hd, f32, msa) + 1024) <= (
        228 * 1024)


@pytest.mark.parametrize("c,heads,win", [(96, 2, 10), (192, 3, 17),
                                         (100, 4, 10)])
def test_attention_shape_check(c, heads, win):
    """One check of the attention template's limits (head widths 16, 32,
    64; at most 256 tokens a window) serves kernels 3 and 7."""
    with pytest.raises(ValueError, match="bad shape"):
        kswin.check_attn_shape("window MSA", c, heads, win)
    for w in (10, 12, 16):
        kswin.check_attn_shape("swin block", 192, 3, w)


# ---- kernel 8: the patch embed's token tiles ---------------------------------

# (b, h, w, c, e): the main path's grid (500^2), path K's (800^2), and the
# cuda tests' ragged grid (gw 70) and small ones
EMBED_SHAPES = [(8, 500, 500, 128, 192), (8, 800, 800, 128, 192),
                (2, 40, 280, 64, 192), (1, 40, 280, 128, 256),
                (1, 16, 24, 64, 64), (2, 32, 48, 128, 128)]


def _tile_tokens(pl, gw, rows):
    """Every token each tile stores, as the kernel's epilogue maps its 128
    rows (row r: gx0 + r % tile_x, row0 + r // tile_x), with the pairs'
    copies of the last tile (when the count is odd) stored by no one."""
    tx, ty = pl["tile_x"], pl["tile_y"]
    r = np.arange(kpe.TILE)
    out = []
    for pair in range(pl["pairs"]):
        for rank in (0, 1):
            mine = 2 * pair + rank
            if mine >= pl["tiles"]:
                continue
            gx0 = (mine % pl["tiles_x"]) * tx
            row0 = (mine // pl["tiles_x"]) * ty
            gx, gy = gx0 + r % tx, row0 + r // tx
            ok = (r < tx * ty) & (gx < gw) & (gy < rows)
            out.append(gy[ok] * gw + gx[ok])
    return np.concatenate(out)


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("b,h,w,c,e", EMBED_SHAPES)
def test_patch_embed_tiles_cover_every_token_once(b, h, w, c, e, f32):
    pl = kpe.check_shape(b, h, w, c, e, 4, f32)
    gw, rows = w // 4, b * (h // 4)
    assert pl["tile_x"] * pl["tile_y"] <= kpe.TILE
    assert pl["tile_x"] <= gw and pl["tile_y"] <= rows
    got = _tile_tokens(pl, gw, rows)
    assert len(got) == rows * gw
    np.testing.assert_array_equal(np.sort(got), np.arange(rows * gw))
    assert pl["wasted_rows"] == pytest.approx(
        1 - rows * gw / (pl["tiles"] * kpe.TILE))


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("b,h,w,c,e", EMBED_SHAPES[:2])
def test_patch_embed_plan_at_the_serving_grids(b, h, w, c, e, f32):
    """At the main path's and path K's grids: one block an SM in 227 KB
    with a ring of at least 3 stages, at most 2.5 % of the tile rows
    without a token, and the weight read from L2 about half as often as
    one 128-token tile a read would (52 % at 500^2, where 125 of a tile's
    128 rows hold tokens)."""
    pl = kpe.plan(b, h, w, c, e, 4, f32)
    assert pl["smem_bytes"] <= SMEM_LIMIT and pl["stages"] >= 3
    assert pl["smem_bytes"] > SMEM_LIMIT // 2  # so one block an SM
    assert pl["wasted_rows"] <= 0.025
    tokens = b * (h // 4) * (w // 4)
    weight = e * 16 * c * (8 if f32 else 2)
    assert pl["weight_l2_bytes"] == pl["pairs"] * weight
    assert pl["pairs"] <= 0.52 * -(-tokens // kpe.TILE)
    assert pl["k_steps"] == 16 * c * (4 if f32 else 2) // 128


def test_patch_embed_plan_at_path_k():
    """800^2: tiles of 8 x 16 tokens fill all 128 rows, 2500 tiles in 1250
    pairs; 0.98 GB of bf16 weight reads from L2, half of 2500 reads."""
    bf = kpe.plan(8, 800, 800, 128, 192, 4, False)
    assert (bf["tile_x"], bf["tile_y"], bf["tiles"], bf["pairs"]) == (
        8, 16, 2500, 1250)
    assert bf["wasted_rows"] == 0.0 and bf["stages"] == 5
    assert bf["weight_l2_bytes"] == 1250 * 192 * 2048 * 2
    f32 = kpe.plan(8, 800, 800, 128, 192, 4, True)
    assert f32["stages"] == 3 and f32["k_steps"] == 64
    assert f32["weight_l2_bytes"] == 1250 * 192 * 2048 * 8


@pytest.mark.parametrize("b,h,w,c,e,f32", [
    (2, 32, 48, 100, 192, False),  # p C = 400: no whole 128-byte K slices
    (2, 32, 48, 128, 80, False),   # E not one of the kernel's widths
    (2, 30, 48, 128, 192, True),   # H not a multiple of p
    (2, 32, 48, 20, 192, True),    # p C = 80 f32: no whole slices
])
def test_patch_embed_shape_check(b, h, w, c, e, f32):
    with pytest.raises(ValueError):
        kpe.check_shape(b, h, w, c, e, 4, f32)
