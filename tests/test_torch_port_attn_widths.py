"""The window attention's head-width instances (head widths 8, 24, 40, 48
and 56 at windows of at most 128 tokens: ``csrc/window_attn.cuh::
window_attn_width_kernel``).

On the CPU:
* the shared memory of every instance, as ``window_attn_width_smem`` sizes
  it (``kswin.attn_smem_bytes``), fits the blocks an SM it is built for
  (``kswin.attn_width_blocks``; the constants are the C source's own) at
  windows 1 to 11, both dtypes and both variants;
* the exact-width q k^T: an emulation of the tensor cores' sums (bf16
  operands, each k-step's products summed exactly and added to the f32
  accumulator with one rounding) over the kernel's k-steps
  (``kswin.attn_width_steps``: k16 steps, then one k8 step where HD % 16
  == 8) equals the same emulation over the staged layout's k16 steps with
  the columns past the head zero, bit for bit; the f32 chunks
  (``kswin.attn_width_chunks``) and the lanes' k-slots cover every channel
  once, in q and k alike.

On the card (``cuda`` marker; skipped here, the kernels need nvcc and an
sm_90a card): every width, both variants, both dtypes, at windows 7, 10
and 11, shifted and not, on a grid with pad tokens on both axes, against
``window_attention_plain`` (bf16 within 1e-2, f32 within 1e-4 of the plain
version's largest value, as ``chip_smoke.py``'s ``attn_phase`` holds
them); the bf16 outputs at window 10 bit for bit against the sha256
digests of the first head-width version (``window_attn_kernel`` with the
rows staged at the next flagship width) on the same inputs.
"""
import hashlib
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402
from mask_bev_tpu_torch.ops import swin_block as kswin  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
WIDTHS = (8, 24, 40, 48, 56)
SMEM_SM = 228 * 1024      # an H100 SM's shared memory
SMEM_RESERVED = 1024      # reserved by the card for each block


def _define(name: str) -> int:
    text = (pathlib.Path(kb.CSRC) / "window_attn.cuh").read_text()
    return int(re.search(rf"#define {name} (\d+)", text).group(1))


def test_width_constants_are_the_sources():
    assert kswin.ATTN_WIDTH_BLOCKS == (
        _define("ATT_WIDTH_BLOCKS_BF16_NPT7"),
        _define("ATT_WIDTH_BLOCKS_BF16_NPT8"), _define("ATT_WIDTH_BLOCKS_F32"))
    assert set(WIDTHS) == set(kswin.ATTN_HEAD_DIMS) - set(
        kswin.ATTN_FLAGSHIP_DIMS)


@pytest.mark.parametrize("win", range(1, 12))
@pytest.mark.parametrize("hd", WIDTHS)
def test_width_smem_fits_its_blocks(hd, win):
    """Rows at ``attn_width_ld`` (an odd number of 16-byte words in bf16),
    the token, label and column-offset rows and the compact table: the
    blocks an SM the instance is built for fit the SM, in both dtypes and
    both variants (the variant does not change the layout)."""
    n_pad = -(-win * win // 16) * 16
    table = 16 * -(-(2 * win - 1) ** 2 // 4)
    for f32 in (False, True):
        ld = kswin.attn_width_ld(hd, f32)
        if not f32:
            assert (ld * 2 // 16) % 2 == 1 and ld - hd in (0, 8)
        rows = 2 * n_pad * ld * 4 if f32 else 3 * n_pad * ld * 2
        want = rows + 12 * n_pad + table
        blocks = kswin.attn_width_blocks(f32, win)
        assert blocks >= 2
        for msa in (False, True):
            got = kswin.attn_smem_bytes(win, hd, f32, msa)
            assert got == want
            assert blocks * (got + SMEM_RESERVED) <= SMEM_SM


def _qk_steps(q: torch.Tensor, k: torch.Tensor, steps) -> torch.Tensor:
    """q k^T summed as an mma step sums: each step's products (exact for
    bf16 operands) summed in float64 and added to the f32 accumulator,
    rounded once a step."""
    acc = torch.zeros(q.shape[0], k.shape[0], dtype=torch.float32)
    for c0, w in steps:
        part = q[:, c0:c0 + w].double() @ k[:, c0:c0 + w].double().T
        acc = (acc.double() + part).float()
    return acc


@pytest.mark.parametrize("msa", [False, True], ids=["swin", "msa"])
@pytest.mark.parametrize("hd", WIDTHS)
def test_exact_width_qk_equals_the_staged(hd, msa):
    """The kernel's k-steps at the exact width give the staged product bit
    for bit: the staged layout's extra terms are exact zeros (a k16 step
    half zero, or all zero)."""
    steps = kswin.attn_width_steps(hd)
    assert [w for _, w in steps] == [16] * (hd // 16) + [8] * (hd % 16 // 8)
    assert sum(w for _, w in steps) == hd
    hs = kswin.attn_staged_dim(hd)
    rng = np.random.default_rng(hd + msa)
    q = torch.as_tensor(rng.normal(size=(16, hd)), dtype=BF16)
    k = torch.as_tensor(rng.normal(size=(112, hd)), dtype=BF16)
    if not msa:  # the Swin variant: q scaled and rounded before the product
        q = (q.float() * hd ** -0.5).to(BF16)
    exact = _qk_steps(q.float(), k.float(), steps)
    qs = torch.zeros(16, hs)
    ks = torch.zeros(112, hs)
    qs[:, :hd], ks[:, :hd] = q.float(), k.float()
    staged = _qk_steps(qs, ks, [(16 * i, 16) for i in range(hs // 16)])
    assert torch.equal(exact, staged)
    # and it is q k^T to f32 rounding
    ref = q.double() @ k.double().T
    assert float((exact.double() - ref).abs().max()) <= 1e-5 * float(
        ref.abs().max())


@pytest.mark.parametrize("hd", WIDTHS)
def test_f32_chunks_cover_the_head(hd):
    """The f32 q k^T's chunks (32, then 16, then 8 channels) tile the head,
    and in each chunk the lanes' k-slots (lane t's k-step st: channels PER t
    + st as slot t, PER t + KS + st as slot t + 4) take every channel once,
    from the values the lane holds (PER contiguous channels from PER t)."""
    chunks = kswin.attn_width_chunks(hd)
    assert [kc for _, kc in chunks] == sorted(
        (kc for _, kc in chunks), reverse=True)
    assert all(kc in (32, 16, 8) for _, kc in chunks)
    seen = []
    for off, kc in chunks:
        assert off == sum(c for o, c in chunks if o < off)
        per, ks = kc // 4, kc // 8
        for t in range(4):
            held = set(range(off + per * t, off + per * (t + 1)))
            for st in range(ks):
                for ch in (off + per * t + st, off + per * t + ks + st):
                    assert ch in held
                    seen.append(ch)
    assert sorted(seen) == list(range(hd))


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's CUDA kernels (nvcc, sm_90a) "
                    "run only on a card")
    return torch.device("cuda")


HW = (23, 27)  # pad tokens on both axes at windows 7, 10 and 11


def _inputs(dev, dtype, hd, win, seed, heads=3, b=2, hw=HW):
    g = torch.Generator().manual_seed(seed)
    c = heads * hd
    qkv = torch.randn(b * hw[0] * hw[1], 3 * c, generator=g).to(dev, dtype)
    qkv_bias = (0.1 * torch.randn(3 * c, generator=g)).to(dev)
    table = (0.02 * torch.randn((2 * win - 1) ** 2, heads, generator=g)).to(
        dev, dtype)
    return (qkv, qkv_bias, kswin.rel_bias_from_table(table, win), b, hw,
            heads, win)


def _rel_err(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("win", [7, 10, 11])
@pytest.mark.parametrize("hd", WIDTHS)
@pytest.mark.parametrize("msa", [False, True], ids=["swin", "msa"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_width_attention_on_the_card(dev, dtype, msa, hd, win, shifted):
    qkv, qb, rel, b, hw, heads, win = _inputs(dev, dtype, hd, win,
                                              hd + 100 * win + shifted)
    shift = kswin.effective_shift(hw, win, shifted)
    assert bool(shift) == shifted
    name = "window_msa" if msa else "swin_block"
    a = (qkv, qb, rel, b, hw, heads, win, shift)
    kb.reset_launches()
    got = kswin.attention(name, *a, msa=msa)
    torch.cuda.synchronize()
    assert kb.INSTANCES == {
        f"{name}/{kswin.attn_instance(dtype == F32, win, hd)}": 1}
    want = kswin.window_attention_plain(*a, msa=msa)
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= (1e-4 if dtype == F32 else 1e-2)


# sha256 of the bf16 outputs at window 10 (``_digest_inputs``), as the first
# head-width version (``window_attn_kernel`` with the rows staged at the next
# flagship width) gave them on the H100
WIDTH_ATTN_BF16_SHA256 = {
    (8, False, False):
        "983c6b5451880d824bcf381870a49eccf03c7c52bed9ee98af5d2008deac6867",
    (8, False, True):
        "f0d5170891dcc4b5b4ce12cd3596a5e0650cf93a009d62dd19f5818c94394e1d",
    (8, True, False):
        "528e1e69abb4f074c983f62adb32d397a516a3ad0f34073b1a1c94961919bd93",
    (8, True, True):
        "d20864733c8aa9fcd5b40cbbc3ab3d7415a535b9b51e9050a7c071a1eb7ce83a",
    (24, False, False):
        "b21999997e0240503394ddc3aa533ff34946d5055ebefe014836df266cede746",
    (24, False, True):
        "599a8a6991ca51a8aff0294cd408be217ba5be6d43571b6e2caa44b28f89fb9d",
    (24, True, False):
        "b2fbe2f71a40a93ec399e7529a86f9cfc2e8c3f3a7ee58771a8e4ebd3311b4c9",
    (24, True, True):
        "1d6d2265110ab4d7579ae314296c45194157e04b5284b8a8a6bc7086411c90c8",
    (40, False, False):
        "cfbe9b1c93056b4bfa5a26cc0ca4acb237faeef98e326f719e1d769d459e2443",
    (40, False, True):
        "47b6d0c35eaf91cd2070e70d29da77c9e1c177b9cf8893fb51d68164ec89c1e7",
    (40, True, False):
        "b2c8d77eab1e2807c7aac2a5679f91c550161ebccc533d800fc2031c7a4d66c0",
    (40, True, True):
        "f8aeba545bfb166b77e40b2eb9eb12ee52e0a5d08e4913367f1273e4373379a2",
    (48, False, False):
        "fb0f16a923ff2dbedf72361c11f65ced67911a5d73ce16eb275fa4b4482646f5",
    (48, False, True):
        "f4f5689d0403b8bc75338f16fd7eb55b01bb4bf70aa63221295878d8709bd1be",
    (48, True, False):
        "5525d4a23493ee97026b9f63d912808de295dc45aeda3a279cced5cda03dccfc",
    (48, True, True):
        "e5a4ea07e55d79b22fd38a9f9b5acad1f6b38cf019ae28e81e2ef244afa65a0f",
    (56, False, False):
        "47d1f706dcbdef09c74636bacb65d04b6a854ed6ee05d887cde5bbe86bae7169",
    (56, False, True):
        "18b952003884b2a0caae7ded313194c88c45dfa5d809d81bc58f0057f5633781",
    (56, True, False):
        "6ed7a9757a8b192f91cd97acbf87a07f2966167213cb4170ff09a78d9230fd0b",
    (56, True, True):
        "11f5d15f30380e5663d6db66f0520986128ccbacb768445c70082e7da842f654",
}


def _digest_inputs(dev, hd, msa, shifted):
    return _inputs(dev, BF16, hd, 10, 700 + hd + 2 * msa + shifted)


def width_digests(dev="cuda") -> dict:
    """(hd, msa, shifted) -> sha256 of the bf16 output bytes, for the
    package this module imported (a checkout put first on ``sys.path``)."""
    out = {}
    with torch.no_grad():
        for hd in WIDTHS:
            for msa in (False, True):
                for shifted in (False, True):
                    qkv, qb, rel, b, hw, heads, win = _digest_inputs(
                        dev, hd, msa, shifted)
                    shift = kswin.effective_shift(hw, win, shifted)
                    got = kswin.attention(
                        "window_msa" if msa else "swin_block", qkv, qb, rel,
                        b, hw, heads, win, shift, msa)
                    out[(hd, msa, shifted)] = hashlib.sha256(
                        got.view(torch.int16).cpu().numpy().tobytes()
                    ).hexdigest()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("key", list(WIDTH_ATTN_BF16_SHA256),
                         ids=lambda k: f"hd{k[0]}-{'msa' if k[1] else 'swin'}"
                         f"-{'shifted' if k[2] else 'plain'}")
def test_width_attention_bf16_keeps_its_output(dev, key):
    """The redesign's bf16 outputs are the first version's, bit for bit:
    only exact zero terms left the sums."""
    hd, msa, shifted = key
    qkv, qb, rel, b, hw, heads, win = _digest_inputs(dev, hd, msa, shifted)
    shift = kswin.effective_shift(hw, win, shifted)
    got = kswin.attention("window_msa" if msa else "swin_block", qkv, qb,
                          rel, b, hw, heads, win, shift, msa)
    digest = hashlib.sha256(
        got.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    print(f"width attention bf16 {key}: sha256 {digest}")
    assert digest == WIDTH_ATTN_BF16_SHA256[key]
