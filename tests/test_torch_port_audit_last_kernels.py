"""The refusal audit's decoder and attention entries on the card: the
decoder stack at a mask embedding of any width, the split instance at head
widths 128 and 256, one head of C 512 and up to 1024 queries, the window
attention at head widths that are no multiple of 8, at 136-256 and at
windows 25-32.

Marked ``cuda``; each test skips, from a fixture, where there is no CUDA
device (the kernels build with nvcc for sm_90a and have no CPU mode). Run on
the card with
``python -m pytest -m cuda tests/test_torch_port_audit_last_kernels.py``.

* The decoder held as ``test_torch_port_f32_kernels.py::
  test_decoder_split`` holds the shipped widths: the ``m < 0`` decisions
  against the plain version's (at most 5 % of a layer's entries free-running;
  on the kernel's own decisions at most 1 % beyond rounding,
  ``decoder_stack.decision_flips``: a decision outside its logit's rounding
  band, a row whose every-key-blocked rule turns over counted once), the
  output on the kernel's own
  decisions within 2e-2 (bf16) and 1e-3 (f32) of the largest value; each
  call's instance counted.
* The attention (Swin and MSA variants, shifted) against
  ``window_attention_plain`` on the true qkv (bf16 within 1e-2, f32 within
  1e-4 of the largest value, ``test_torch_port_attn_stream.py``'s), the
  padded kernel's true columns.
"""
import pytest

torch = pytest.importorskip("torch")

from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402
from mask_bev_tpu_torch.ops import decoder_stack as kdec  # noqa: E402
from mask_bev_tpu_torch.ops import swin_block as kswin  # noqa: E402

pytestmark = pytest.mark.cuda
BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's CUDA kernels (nvcc, sm_90a) "
                    "run only on a card")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp(min=1e-12))


def _decoder_inputs(dev, dtype, q, c, heads, d, f, hws, seed):
    """Decoder-stack inputs at these widths, a mask embedding of ``d``
    columns: (out0, emb0, qpos, mems, pes, feats, layers, head)."""
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
        for _ in range(3)]
    head = kdec.HeadWeights(vec(c, 1.0), vec(c), mat(c, c), vec(c),
                            mat(c, c), vec(c), mat(c, d), vec(d))
    out0 = r(2, q, c).to(dev, dtype)
    emb0 = kdec.mask_embed(out0.float(), head, dtype)
    qpos = r(q, c).to(dev, dtype)
    mems = [r(2, h * w, c).to(dev, dtype) for (h, w) in hws]
    pes = [r(h * w, c).to(dev, dtype) for (h, w) in hws]
    feats = [r(2, h * w, d).to(dev) for (h, w) in hws]
    return out0, emb0, qpos, mems, pes, feats, layers, head


DECODER = {"d1": (45, 256, 8, 1, 2048), "d64": (45, 256, 8, 64, 2048),
           "d257": (45, 256, 8, 257, 2048), "d512": (45, 256, 8, 512, 2048),
           "2x128": (45, 256, 2, 256, 512), "2x128-d384": (45, 256, 2, 384,
                                                           512),
           "8x256": (45, 2048, 8, 2048, 2048), "1x384": (45, 384, 1, 384, 512),
           "1x512": (45, 512, 1, 512, 512), "q513": (513, 256, 8, 256, 512),
           "q1024": (1024, 256, 8, 256, 512), "c96-d300": (45, 96, 8, 300,
                                                          300)}


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", list(DECODER))
def test_decoder_audit_last(dev, shape, dtype):
    q, c, heads, d, f = DECODER[shape]
    hws = [(8, 8), (16, 16), (32, 31)]
    t_max = 32 * 31
    args = _decoder_inputs(dev, dtype, q, c, heads, d, f, hws,
                           seed=q + c + heads + d)
    kb.reset_launches()
    got, bits = kdec.decoder_stack(*args, num_heads=heads, return_bits=True)
    torch.cuda.synchronize()
    if kdec.flagship_takes(q, c, f, heads, 3, 3, t_max, dtype, d):
        inst = "flagship" + ("_embpad" if d < c else "")
    else:
        inst = kdec.split_instance(q, heads, dtype == F32, c, f, t_max, d)
    assert kb.INSTANCES[f"decoder_stack/{inst}"] == 1
    assert got.dtype == dtype and got.shape == (2, q, c)
    _, logits = kdec.decoder_stack_plain(*args, num_heads=heads,
                                         return_logits=True)
    flips = [int((kb_ != kdec.blocked_positions(m)).sum())
             for kb_, m in zip(bits, logits)]
    same, same_logits, bands = kdec.decoder_stack_plain(
        *args, num_heads=heads, blocked=bits, return_logits=True,
        return_bands=True)
    own = kdec.decision_flips(bits, same_logits, bands)
    own_all = [int((kb_ != kdec.blocked_positions(m)).sum())
               for kb_, m in zip(bits, same_logits)]
    print(f"decoder {inst} Q {q} C {c} heads {heads} D {d}: flips per "
          f"layer {flips}, on its own decisions {own_all}, of which beyond "
          f"rounding {own}, of {[m.numel() for m in logits]}")
    for li, m in enumerate(logits):
        assert flips[li] <= 0.05 * m.numel(), (li, flips)
        assert own[li] <= 0.01 * m.numel(), (li, own)
    assert _rel(got, same) <= (2e-2 if dtype == BF16 else 1e-3)


def test_decoder_wide_embedding_keeps_emb0(dev):
    """The split instance overwrites its embedding buffer: a caller's
    (B, Q, De) f32 emb0 is copied first, not written."""
    args = _decoder_inputs(dev, F32, 45, 256, 8, 288, 512,
                           [(4, 4), (8, 8), (16, 15)], seed=9)
    emb0 = args[1].float().contiguous()
    keep = emb0.clone()
    kdec.decoder_stack(args[0], emb0, *args[2:], num_heads=8)
    torch.cuda.synchronize()
    assert torch.equal(emb0, keep)


ATTN = {"hd4": (4, 7, (20, 23)), "hd12": (12, 10, (25, 27)),
        "hd36": (36, 7, (20, 23)), "hd100": (100, 10, (25, 27)),
        "hd136": (136, 7, (20, 23)), "hd144-w10": (144, 10, (25, 27)),
        "hd192-w12": (192, 12, (30, 26)), "hd256-w17": (256, 17, (20, 30)),
        "hd44-w20": (44, 20, (45, 41)), "w25": (32, 25, (40, 30)),
        "w32": (64, 32, (40, 33)), "hd200-w32": (200, 32, (33, 31))}


@pytest.mark.parametrize("msa", [False, True], ids=["swin", "msa"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(ATTN))
def test_attention_audit_last(dev, case, dtype, msa):
    hd, win, hw = ATTN[case]
    heads, b = 2, 2
    c = heads * hd
    g = torch.Generator().manual_seed(hd + win)
    qkv = torch.randn(b * hw[0] * hw[1], 3 * c, generator=g).to(dev, dtype)
    qb = (0.1 * torch.randn(3 * c, generator=g)).to(dev)
    table = (0.02 * torch.randn((2 * win - 1) ** 2, heads,
                                generator=g)).to(dev, dtype)
    rel = kswin.rel_bias_from_table(table, win)
    shift = kswin.effective_shift(hw, win, True)
    qp, bp, cols = kswin.padded_qkv(qkv, qb, heads)
    kb.reset_launches()
    kname = "window_msa" if msa else "swin_block"
    got = kswin.attention(kname, qp, bp, rel, b, hw, heads, win, shift, msa,
                          hd=hd)
    torch.cuda.synchronize()
    assert kb.INSTANCES == {
        f"{kname}/{kswin.attn_instance(dtype == F32, win, hd)}": 1}
    want = kswin.window_attention_plain(qkv, qb, rel, b, hw, heads, win,
                                        shift, msa)
    assert _rel(got[:, cols], want) <= (1e-4 if dtype == F32 else 1e-2)
