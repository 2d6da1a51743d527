"""The window attention's streaming kernel (windows of 129-576 tokens:
``csrc/window_attn.cuh::window_attn_stream_kernel``) and the ring kernel at
head widths 72-128 (``window_attn_ring_kernel``, bf16 up to 128 tokens a
window).

On the CPU:
* the streaming kernel's query list (``stream_query_rows``, a numpy model
  of the kernel's ``stage_slot``) holds every real token of every window
  exactly once, first and in the window's order, then the pad tokens,
  against ``partition_windows`` on ``.w24``'s four stage grids and the
  144-block stage-1 grid at window 24, shifted and plain; a skipped query
  tile holds pad tokens only, a pulled one a real token;
* the shared memory of the ring kernel at widths 72-128 (q in registers).

On the card (``cuda`` marker; skipped here, the kernels need nvcc and an
sm_90a card): the bf16 outputs bit for bit against sha256 digests recorded
from the kernels these replaced, on the same inputs (also on the stage-1
grid at batch 8, where each block of the persistent grid takes several
items, so that its item slots, its ring of pulled items and the kept bias
table are reused); the ring kernel at
window 11 and the streaming kernel at window 13 (widths over 64) against
the plain version (bf16 within 1e-2, f32 within 1e-4 of its largest
value), counted under their instances.
"""
import hashlib
from typing import Tuple

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402
from mask_bev_tpu_torch.ops import swin_block as kswin  # noqa: E402

BF16 = torch.bfloat16
STREAM_HW = (29, 53)  # window 24: pad tokens on both axes, 2 x 3 windows
WIDE_HW = (23, 27)    # window 10: pad tokens on both axes, 3 x 3 windows
# window 24 on .w24's stage-1 grid at batch 8: 3 x 3 windows, 34 of their
# 45 query tiles pulled a (head, sample), several items a block
MANY_HW, MANY_B = (63, 63), 8


def stream_query_rows(hw: Tuple[int, int], win: int, shift: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The streaming kernel's query list of each window of the padded grid
    rolled by ``-shift`` (``window_attn_stream_kernel``'s ``stage_slot``):
    (nW, win²) window rows, the real tokens first, then the pad tokens,
    each in the window's row-major order; and (nW,) the real tokens a
    window. A tile is :data:`ATTN_QUERY_TILE` consecutive entries; tiles
    from the real count on are skipped."""
    h, w = hw
    hp, wp = -(-h // win) * win, -(-w // win) * win
    nwh, nww = hp // win, wp // win
    i = np.arange(win)
    rows, real = [], []
    for wy in range(nwh):
        yr = (wy * win + i + shift) % hp < h
        for wx in range(nww):
            xr = (wx * win + i + shift) % wp < w
            tok = (yr[:, None] & xr[None, :]).reshape(-1)
            # the kernel's positions: real rows before r, ranks by axis
            ry = np.cumsum(yr) - yr
            rx = np.cumsum(xr) - xr
            cx, n_real = int(xr.sum()), int(yr.sum() * xr.sum())
            r = np.arange(win * win)
            ri, rj = r // win, r % win
            before = ry[ri] * cx + np.where(yr[ri], rx[rj], 0)
            pos = np.where(tok, before, n_real + r - before)
            order = np.empty(win * win, dtype=np.int64)
            order[pos] = r
            rows.append(order)
            real.append(n_real)
    return np.stack(rows), np.asarray(real)




def _inputs(dev, hd, win, hw, seed, heads=2, b=2, dtype=BF16):
    g = torch.Generator().manual_seed(seed)
    c = heads * hd
    qkv = torch.randn(b * hw[0] * hw[1], 3 * c, generator=g).to(dev, dtype)
    qkv_bias = (0.1 * torch.randn(3 * c, generator=g)).to(dev)
    table = (0.02 * torch.randn((2 * win - 1) ** 2, heads, generator=g)).to(
        dev, dtype)
    return (qkv, qkv_bias, kswin.rel_bias_from_table(table, win), b, hw,
            heads, win)


def _digest_inputs(dev, key):
    """Inputs of a digest ``(kind, hd, msa, shifted)``: ``stream`` at window
    24 (2 heads), ``wide`` at window 10 (3 heads); ``many`` (bf16) and
    ``many_f32`` at window 24 on :data:`MANY_HW` at batch 8 (384 channels
    at head width 64, .w24's stage 1; 2 heads at 128, the 144-block
    hold)."""
    kind, hd, msa, shifted = key
    if kind == "stream":
        return _inputs(dev, hd, 24, STREAM_HW, 950 + hd + 2 * msa + shifted)
    if kind.startswith("many"):
        f32 = kind == "many_f32"
        return _inputs(dev, hd, 24, MANY_HW,
                       1000 + hd + 2 * msa + shifted + 500 * f32,
                       heads=384 // hd if hd == 64 else 2, b=MANY_B,
                       dtype=torch.float32 if f32 else BF16)
    return _inputs(dev, hd, 10, WIDE_HW, 900 + hd + 2 * msa + shifted,
                   heads=3)


def _digest(dev, key) -> str:
    qkv, qb, rel, b, hw, heads, win = _digest_inputs(dev, key)
    shift = kswin.effective_shift(hw, win, key[3])
    assert bool(shift) == key[3]
    got = kswin.attention("window_msa" if key[2] else "swin_block", qkv, qb,
                          rel, b, hw, heads, win, shift, key[2])
    bits = torch.int32 if got.dtype == torch.float32 else torch.int16
    return hashlib.sha256(
        got.view(bits).cpu().numpy().tobytes()).hexdigest()


DIGEST_KEYS = ([("stream", hd, msa, sh) for hd in (64, 128)
                for msa in (False, True) for sh in (False, True)]
               + [("wide", hd, msa, sh) for hd in kswin.ATTN_WIDE_DIMS
                  for msa in (False, True) for sh in (False, True)])
MANY_KEYS = ([("many", hd, msa, sh) for hd in (64, 128)
              for msa in (False, True) for sh in (False, True)]
             + [("many_f32", 64, msa, sh) for msa in (False, True)
                for sh in (False, True)])


def attn_digests(keys=DIGEST_KEYS, dev="cuda") -> dict:
    """key -> sha256 of the output bytes, for the package this module
    imported (a checkout put first on ``sys.path``)."""
    with torch.no_grad():
        return {key: _digest(dev, key) for key in keys}


# (grid, window): .w24's four stage grids (semantic_kitti_default()'s
# 500^2 grid over patches of 4, halved three times) and the stage-1 grid at
# 8 x 2 heads, the 144-block hold
QUERY_GRIDS = [((125, 125), 24), ((63, 63), 24), ((32, 32), 24),
               ((16, 16), 24), ((29, 53), 24), ((23, 27), 13)]


@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("hw,win", QUERY_GRIDS)
def test_query_rows_hold_each_real_token_once(hw, win, shifted):
    shift = kswin.effective_shift(hw, win, shifted)
    rows, real = stream_query_rows(hw, win, shift)
    n = win * win
    ids = torch.arange(1, hw[0] * hw[1] + 1, dtype=torch.float64)
    windows = kswin.partition_windows(ids.reshape(1, -1, 1), hw, win,
                                      shift)[0, :, :, 0].numpy()
    assert rows.shape == windows.shape == (len(real), n)
    tiles = kswin.ATTN_QUERY_TILE
    for order, r, tok in zip(rows, real, windows):
        assert sorted(order) == list(range(n))
        assert r == int((tok > 0).sum())
        # the real tokens first, in the window's order, then the pad ones
        assert (tok[order[:r]] > 0).all() and (tok[order[r:]] == 0).all()
        assert (np.diff(order[:r]) > 0).all()
        assert (np.diff(order[r:]) > 0).all()
        # a tile is pulled where it holds a real token, skipped otherwise
        for qt in range(-(-n // tiles)):
            held = tok[order[qt * tiles:(qt + 1) * tiles]]
            assert (qt * tiles < r) == bool((held > 0).any())
    # every token of the grid is a real row of exactly one window
    got = np.concatenate([tok[order[:r]] for order, r, tok
                          in zip(rows, real, windows)])
    assert sorted(got) == list(range(1, hw[0] * hw[1] + 1))


def test_w24_query_rows_skipped():
    """``.w24`` (window 24 at every stage of ``semantic_kitti_default()``,
    depths 2, 2, 6, 2, heads 3, 6, 12, 24): the pad tokens are 40 % of the
    query rows a forward, and the pulled tiles cover the real ones with
    less than 128 rows a window to spare."""
    grids = [((125, 125), 3, 2), ((63, 63), 6, 2), ((32, 32), 12, 6),
             ((16, 16), 24, 2)]
    rows_all = rows_real = rows_tiles = 0
    for hw, heads, depth in grids:
        for blk in range(depth):
            shift = kswin.effective_shift(hw, 24, blk % 2 == 1)
            _, real = stream_query_rows(hw, 24, shift)
            t = kswin.ATTN_QUERY_TILE
            rows_all += heads * len(real) * 576
            rows_real += heads * int(real.sum())
            rows_tiles += heads * int((-(-real // t) * t).sum())
            assert ((-(-real // t) * t - real) < t).all()
    assert 0.39 < 1 - rows_real / rows_all < 0.41
    assert rows_tiles < rows_all


@pytest.mark.parametrize("msa", [False, True], ids=["swin", "msa"])
@pytest.mark.parametrize("hd", kswin.ATTN_WIDE_DIMS)
def test_ring_wide_smem(hd, msa):
    """The ring kernel at head widths over 64 stages k and v only (each
    warp reads q's fragments from device memory; a zero row and the q bias
    row stay in shared memory for the pad rows), so at window 10 two blocks
    share an SM in both variants, which staged q would not allow at 128
    (Swin) and from 96 (MSA); one fits at window 11."""
    n_pad, n = 112, 100
    ld = kswin.attn_width_ld(hd, False)
    table = 16 * -(-19 ** 2 // 4)
    rest = (kswin.ATTN_RING_SLOTS * 8 * n_pad + 4 * n_pad + table
            + n * (n_pad + 8) * (4 if msa else 2))
    assert kswin.attn_ring_q_in_registers(hd)
    got = kswin.attn_smem_bytes(10, hd, False, msa)
    assert got == 2 * n_pad * ld * 2 + rest + 4 * hd
    assert kswin.attn_blocks(False, 10, hd) == 2
    assert 2 * (got + 1024) <= 228 * 1024
    staged = 3 * n_pad * ld * 2 + rest
    assert (2 * (staged + 1024) > 228 * 1024) == (hd >= (96 if msa else 128))
    assert kswin.attn_smem_bytes(11, hd, False, msa) + 1024 <= 228 * 1024
    assert kswin.attn_blocks(False, 11, hd) == 1  # the 8-warp instance


# sha256 of the bf16 outputs (``_digest_inputs``) as the kernels before the
# Hopper redesign gave them on the H100 (NVIDIA H100 80GB HBM3, 700.00 W),
# recorded from a checkout of the parent commit: ``stream`` the first
# streaming kernel (one block a window, head and sample walking 128-row
# query rounds), ``wide`` the head-width kernel (``window_attn_width_kernel``
# at the exact width, 8 warps). Keys (kind, head width, MSA variant,
# shifted)
ATTN_BF16_SHA256 = {
    ("stream", 64, False, False):
        "2572bc59145f9076144b12ebe7d32a4ee5df70432d2fa557c902ce4c2d664fa9",
    ("stream", 64, False, True):
        "35be0bb240258589787c1a2f23a1630e2079e4ea011391d8e4cf7484a6de6812",
    ("stream", 64, True, False):
        "d5928d2dfacc19a36503dac72f35813362cf49fbcb4717dfb7b7ed82543d87a9",
    ("stream", 64, True, True):
        "0a5b0dc8f98d722ddf035cda83a3361529c2ade68137b951fab66c96a5d710f4",
    ("stream", 128, False, False):
        "72b8cff83fafd50fa0b7c12be681354bc85a5b15efd5a0090e4ba7b99655a837",
    ("stream", 128, False, True):
        "83bcd6c3679745fa4e1221c4a6c7e314f7fe726392da4e0aea80b9b3d3fc34f5",
    ("stream", 128, True, False):
        "0f8138ccc8ddda7c846524425a2e8c5ca91006d0128a163410696458d7a9a056",
    ("stream", 128, True, True):
        "8a9107d18ac7776397087386559727042c55d93dd0fd9288e292c65d86b5e363",
    ("wide", 72, False, False):
        "685d97a3ba781adf10a8fbb83c8456e90f6fb087c5308f28ad8600cf8d7907ac",
    ("wide", 72, False, True):
        "545e47925e506405ab208d7eb9d73638a4352e7233c2c71b49cdef1021c25cc2",
    ("wide", 72, True, False):
        "3cd80f104ece66e287f394f78d189c7d86b98e1da449080827840b6852c5a6c7",
    ("wide", 72, True, True):
        "4f6ee69550f1c2287d2bda0f60175dd4f5b111cd4767904fc7c5b2d113133ca1",
    ("wide", 80, False, False):
        "666014b6d9a91bc3c0d5867b1b0b91e7e2817c63118382cb9b86677ec140752b",
    ("wide", 80, False, True):
        "506b9267298ba59503fb03fc56530889ebbb5a0e5f54cae5a57c2230851a1363",
    ("wide", 80, True, False):
        "57afd80729561cf9586f67d00185e57c2d6477d5e9aca646a11d611dadf6701e",
    ("wide", 80, True, True):
        "292c8bd7df30eb944356a47df78768cfa27f75226ffc882b370d9251d209969e",
    ("wide", 88, False, False):
        "6aafa273e26251dec0d32a94dc020f00528e4616dfade76d8cc28eebedbb509f",
    ("wide", 88, False, True):
        "0df528c7005458f5d4a1b11f998d1e113e19a9a2bf40b7e20ab087c9e92d4e8e",
    ("wide", 88, True, False):
        "d71ebc7d63b32471773133666d9262422d496e8a1447582fff309637d524daf7",
    ("wide", 88, True, True):
        "e0972825870324c5bda35969045bb25562f69c05f19ae6b79705874a632cc4ca",
    ("wide", 96, False, False):
        "d8700a21478de29dd36291d78da8205e02adc58bf0a0439f873245956136c9d0",
    ("wide", 96, False, True):
        "473661489d34f00319aed5169d2ff21897c279c606103087ea62fc8d242625be",
    ("wide", 96, True, False):
        "7b2c18559fe4669c6eca906fa75732ebc718e0557625bc510d4c586fe391e87e",
    ("wide", 96, True, True):
        "dc80dc3fa8bd47f613e0f73be99e5770e59e75bcff1a55fdcc47be230fc9d206",
    ("wide", 104, False, False):
        "9e1935a40e43ed244c9ac58a4a9a5f6dc6176ff9a4cde40ac289f3a1fcc8c780",
    ("wide", 104, False, True):
        "53e7709bdef4853af08ac741a157b6d4094f1856710c97875eb3baf7ec00080a",
    ("wide", 104, True, False):
        "3f10987a5be9223012b845ac4d93fca37725a430a8820f8c77800b3bc0396047",
    ("wide", 104, True, True):
        "76cb4388d010cfbf8c73548c1b133c13e188645246e9ad0e2653e1d42564eae9",
    ("wide", 112, False, False):
        "cbc800df78b90ddbc765c5f90dbf83ff4fc0b3f973259dd03ef832a75da766c9",
    ("wide", 112, False, True):
        "6c3068a45827285e070536e85c5e2c17acb7a8d541f571a93bcd5aa0949a7910",
    ("wide", 112, True, False):
        "91acbea1564abefdccad4ecd16445d5f297e09d6e58141b8f575db15136c8be4",
    ("wide", 112, True, True):
        "3f7a4881543d3e6889fe39d596195419f2cd20b0a30da680015bea846985a1df",
    ("wide", 120, False, False):
        "f7bc7f3bf9c6d3592b5b30a90a9a5edd5d1a7e7287e2f84fd968f17fc4a576c0",
    ("wide", 120, False, True):
        "4dbad73bab967d6f420041787c298af762d6ff5392c3289185a3fb08b1623d14",
    ("wide", 120, True, False):
        "e854435874367abdcc89070794aed6a54770533201bc32d1cf17e492deb45148",
    ("wide", 120, True, True):
        "0fa7fad813c789687e829c8f9f276c459a4790e12d0091b00d0128fbaa0a9bc1",
    ("wide", 128, False, False):
        "e83418acbcf203cabc8b6ccfddc42c7c31f7729a72c5893465cf8c501c1037c8",
    ("wide", 128, False, True):
        "ad2d474c8776ff1c93cb1637408790da2c9d373e8dfa5748816e83f0863f12dd",
    ("wide", 128, True, False):
        "a405aefe6e1a7996251e04a2583572ede0fa65a73e137828df3d47967cb42cdd",
    ("wide", 128, True, True):
        "1ee9da5240b147fb3ed4149b5baf19bebf084d33edabc8205e6a8b08e7849de4",
}

# sha256 of the outputs (``_digest_inputs``) on .w24's stage-1 grid at batch
# 8 (``many``: bf16; ``many_f32``), where each block of the persistent grid
# takes several items (its slots, the ring of pulled items and the kept
# bias table reused), as the first streaming kernel (one block a window,
# head and sample) gave them on the H100 (NVIDIA H100 80GB HBM3, 700.00 W),
# recorded from a checkout of the parent commit with
# ``scripts/long_attn_profile.py --stream`` (its ``old`` variant). Keys as
# above
MANY_ITEMS_SHA256 = {
    ("many", 64, False, False):
        "84b068ff472e4166f541862c20658fe29193ef27b249a3e54791f99706714972",
    ("many", 64, False, True):
        "3297b97e034971e5b1141d09e177f86069dc22d885f43a38fb8dcad3482aa7d2",
    ("many", 64, True, False):
        "568e405c4187f4a97468b5d5e0b465ea22856a7ae7669d1a71d27a590a7d9b1d",
    ("many", 64, True, True):
        "36b1b8b99232025b6a48350ecfa4df50c0cc3496e73906a7101e465a6074e131",
    ("many", 128, False, False):
        "a86c66a12a957105d5fe2cbb5aca04d2839e91baa9dbcb968237145c342c52fc",
    ("many", 128, False, True):
        "db33e727c6077c07d218427e8349ac735223ff9409d1d8897572f48158f109e1",
    ("many", 128, True, False):
        "e7b17e3a7c3e0b57659637d9331add62705e923b8a270f330c06762bbce0ce4a",
    ("many", 128, True, True):
        "8d80568b8ef74908626e6124ead51b137ad5412ee7a1ede2e5e79b424a592072",
    ("many_f32", 64, False, False):
        "fa4de69803401a78d6b749887e1edd05f08f3e3b4dc1d0b023fe9fd15c59e810",
    ("many_f32", 64, False, True):
        "bbc3d36175208b7dbd9e3a27aaf489fe31c6c4b0cdba2b00936efefa69fd32d8",
    ("many_f32", 64, True, False):
        "993ead8eaadc63603e383e6ddff490543d2bddbf834afc1eaca25b53bb7d61e7",
    ("many_f32", 64, True, True):
        "9d795d076cd95a3de7b7af09ee4b0d7866dd040474e2c6e28361ef8db16dd470",
}


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's CUDA kernels (nvcc, sm_90a) "
                    "run only on a card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("key", list(ATTN_BF16_SHA256),
                         ids=lambda k: f"{k[0]}-hd{k[1]}-"
                         f"{'msa' if k[2] else 'swin'}-"
                         f"{'shifted' if k[3] else 'plain'}")
def test_attention_bf16_keeps_its_output(dev, key):
    """The redesigned kernels' bf16 outputs are their parents', bit for
    bit: every stored row's sums are taken in the same order."""
    with torch.no_grad():
        digest = _digest(dev, key)
    print(f"attention bf16 {key}: sha256 {digest}")
    assert digest == ATTN_BF16_SHA256[key]


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("msa", [False, True], ids=["swin", "msa"])
@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("win", [11, 13])
@pytest.mark.parametrize("hd", [80, 88, 112, 120])
def test_wide_attention_on_the_card(dev, hd, win, dtype, msa, shifted):
    """Window 11 (the ring kernel's 8-warp instance in bf16) and window 13
    (the streaming kernel) at widths over 64, against the plain version."""
    qkv, qb, rel, b, hw, heads, win = _inputs(dev, hd, win, WIDE_HW,
                                              hd + 3 * win + shifted)
    qkv = qkv.to(dtype)
    shift = kswin.effective_shift(hw, win, shifted)
    name = "window_msa" if msa else "swin_block"
    a = (qkv, qb, rel, b, hw, heads, win, shift)
    kb.reset_launches()
    with torch.no_grad():
        got = kswin.attention(name, *a, msa=msa)
        torch.cuda.synchronize()
        want = kswin.window_attention_plain(*a, msa=msa)
    f32 = dtype == torch.float32
    assert kb.INSTANCES == {f"{name}/{kswin.attn_instance(f32, win, hd)}": 1}
    assert bool(torch.isfinite(got).all())
    err = float((got.double() - want.double()).abs().max()
                / want.double().abs().max())
    assert err <= (1e-4 if f32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("key", list(MANY_ITEMS_SHA256),
                         ids=lambda k: f"{k[0]}-hd{k[1]}-"
                         f"{'msa' if k[2] else 'swin'}-"
                         f"{'shifted' if k[3] else 'plain'}")
def test_stream_many_items_keep_their_output(dev, key):
    """With several items a block (slot reuse, the ring of pulled items
    wrapping, the bias table kept across items of one head) the streaming
    kernel's outputs are the first design's, bit for bit."""
    with torch.no_grad():
        digest = _digest(dev, key)
    print(f"attention {key}: sha256 {digest}")
    assert digest == MANY_ITEMS_SHA256[key]
