"""The row walk's redesign above C 2048 (kernel 9's wide instance and the
Swin LN's wide kernel), on the CPU.

* Kernel 9's plain version at C 2056, 3072 and 4096 against
  ``mask_bev_tpu/ops/pallas_layer_norm.py::fused_layer_norm`` in interpret
  mode, as ``tests/test_pallas_layer_norm.py`` runs it (f32 1e-5, bf16
  2e-2 absolute on unit-scale outputs: ``test_torch_port_layer_norm.py``'s
  tolerances), and the Swin LN's plain version (``layer_norm_p``) against
  the JAX package's ``LayerNormP`` there (the same tolerances).
* ``plan`` gives every C % 8 == 0 of 2056 ... 4096 a split the C entry
  takes (``csrc/layer_norm.cu::launch_ln_wide_t``'s checks: four warps a
  token, the fewest words a lane, at most 64 registers of data), the C
  source's constants are the host's, and the walk keeps C % 8 != 0 and C
  over 4096.
* The wide kernels' word order: lane l of warp s holds words l + 32 (s W
  + i); run warp after warp, each lane's words are the walk's (lane l of
  32: l, l + 32, ...), every word once, so the sums (each warp continuing
  the one before) are the walk's, bit for bit; an emulation of the f32
  sums in that order equals the walk's sums.
* On the card the route is the kernel: with a tensor whose ``is_cuda``
  reads True and the launch recorded, kernel 9 launches its wide instance
  with the plan's split, and the Swin LN its wide kernel (int8 rows at a
  padded pitch among them).
"""
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.models.swin import LayerNormP  # noqa: E402
from mask_bev_tpu.ops.pallas_layer_norm import fused_layer_norm  # noqa: E402
from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402
from mask_bev_tpu_torch.ops import layer_norm as kln  # noqa: E402
from mask_bev_tpu_torch.ops import swin_block as kswin  # noqa: E402
from test_torch_port_shapes import on_card  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
CSRC = pathlib.Path(kb.CSRC)
_DT = {"float32": (jnp.float32, F32), "bfloat16": (jnp.bfloat16, BF16)}
WIDE = (2056, 3072, 4096)


def _define(source: str, name: str) -> int:
    m = re.search(rf"#define {name} (\d+)", (CSRC / source).read_text())
    return int(m.group(1))


def _inputs(c, dtype, rows=18, seed=0):
    rng = np.random.default_rng(seed + c)
    x = (0.5 + rng.normal(size=(2, rows // 2, c))).astype(np.float32)
    w = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    b = (0.1 * rng.normal(size=c)).astype(np.float32)
    jd, td = _DT[dtype]
    return ([jnp.asarray(a).astype(jd) for a in (x, w, b)],
            [torch.as_tensor(a).to(td) for a in (x, w, b)])


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", WIDE)
def test_layer_norm_plain_matches_pallas_kernel(c, dtype):
    (jx, jw, jb), (tx, tw, tb) = _inputs(c, dtype)
    want = np.asarray(fused_layer_norm(jx, jw, jb, block_rows=8,
                                       interpret=True), np.float32)
    got = kln.layer_norm_plain(tx, tw, tb)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", WIDE)
def test_swin_ln_plain_matches_layer_norm_p(c, dtype):
    (jx, jw, jb), (tx, tw, tb) = _inputs(c, dtype, seed=1)
    want = np.asarray(LayerNormP(c).apply(
        {"params": {"scale": jw, "bias": jb}}, jx), np.float32)
    got = kswin.layer_norm_p(tx, tw, tb)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_tol(dtype))


def _check_wide_plan(c, f32):
    """``launch_ln_wide``'s checks on ``plan(c, f32)``."""
    g, w, r = kln.plan(c, f32)
    s = kln.WIDE_WARPS  # warps a token
    words = c // 8
    assert c % 8 == 0 and 2048 < c <= kln.WIDE_C
    assert (g, r) == (32 * s, 1) and 1 <= w <= 16 // s
    assert g * w >= words > g * (w - 1)
    assert w * 8 * (4 if f32 else 2) // 16 * 4 <= 64  # registers of data
    return g, w, r


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("c,want", [(2056, ((128, 3, 1), (128, 3, 1))),
                                    (3072, ((128, 3, 1), (128, 3, 1))),
                                    (4096, ((128, 4, 1), (128, 4, 1)))])
def test_wide_plan(c, want, f32):
    assert _check_wide_plan(c, f32) == want[f32]
    assert kln.instance_suffix(c) == "_wide"


def test_wide_plan_every_width():
    for c in range(2056, kln.WIDE_C + 1, 8):
        for f32 in (False, True):
            _check_wide_plan(c, f32)
    # the walk keeps rows not in whole words and rows over the wide limit
    for c in (2049, 3071, 4100, 4104, 8192):
        assert kln.plan(c, False)[1:] == (0, 1)
        assert kln.instance_suffix(c) == "_walk"
    assert kln.plan(2048, False) == (32, 8, 2)  # the register tiles


def test_wide_limits_are_the_sources():
    assert kln.WIDE_C == _define("layer_norm.cu", "LN_WIDE_C") == 4096
    assert kswin.SWIN_LN_WIDE_C == _define("swin_block.cu",
                                           "SWIN_LN_WIDE_C") == 4096
    # each wide kernel's one warp count a row, in both dtypes
    assert kln.WIDE_WARPS == _define("layer_norm.cu", "LN_WIDE_WARPS") == 4
    assert _define("swin_block.cu", "SWIN_LN_WIDE_WARPS") == 2


def _words(c, s, w):
    """Lane -> the words it holds, warp after warp, as the wide kernels
    lay them out (``common.cuh::RowRegs``)."""
    words = c // 8
    return [[x for sw in range(s) for i in range(w)
             for x in [lane + 32 * (sw * w + i)] if x < words]
            for lane in range(32)]


@pytest.mark.parametrize("c", WIDE)
@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
def test_wide_word_order_is_the_walks(c, f32):
    """Each lane's words, warp after warp, are the walk's at G = 32, and
    every word is held once; the f32 sums in that order (warp 1 continuing
    warp 0's per-lane sums, then the xor shuffles) equal the walk's bit for
    bit."""
    g, w, _ = kln.plan(c, f32)
    got = _words(c, g // 32, w)
    walk = [list(range(lane, c // 8, 32)) for lane in range(32)]
    assert got == walk
    assert sorted(x for lane in got for x in lane) == list(range(c // 8))
    rng = np.random.default_rng(c)
    x = rng.normal(size=c).astype(np.float32)

    def lane_sums(order):
        out = []
        for words in order:
            s = np.float32(0)
            for wd in words:
                for v in x[8 * wd:8 * wd + 8]:
                    s = np.float32(s + v)
            out.append(s)
        return out

    def shuffle(vals):
        vals = list(vals)
        for o in (16, 8, 4, 2, 1):
            vals = [np.float32(vals[i] + vals[i ^ o]) for i in range(32)]
        return vals[0]

    assert shuffle(lane_sums(got)).tobytes() == \
        shuffle(lane_sums(walk)).tobytes()


# ---- the route on the card -------------------------------------------------


@pytest.fixture
def launches(monkeypatch):
    """Record each launch (C function, instance, int arguments) instead of
    making it; there is no card here."""
    made = []

    def launch(name, fn, *args, instance=None):
        made.append((fn, instance, [a.value for a in args
                                    if isinstance(a, type(kb.ci(0)))]))
    monkeypatch.setattr(kb, "launch", launch)
    monkeypatch.setattr(kb, "stream", lambda: kb.ptr(None))
    return made


@pytest.mark.parametrize("dt", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("c", WIDE)
def test_wide_route_on_the_card(launches, c, dt):
    x = on_card(torch.ones(3, 5, c, dtype=dt))
    w = on_card(torch.ones(c, dtype=dt))
    kln.layer_norm(x, w, w)
    kswin._ln(on_card(torch.ones(4, c, dtype=dt)), w, w, False)
    q8, _ = kswin._ln(on_card(torch.ones(4, c, dtype=dt)), w, w, True)
    name = "f32" if dt == F32 else "bf16"
    assert q8.stride(0) == kswin.row_pitch(c, 1)  # 2056: a pitch of 2064
    assert [(fn, inst) for fn, inst, _ in launches] == [
        ("token_layernorm", name + "_wide"),
        ("swin_layernorm", name + "_wide"), ("swin_layernorm", name + "_wide")]
    assert launches[0][2][2:5] == list(kln.plan(c, dt == F32))
    assert launches[2][2][-2] == kswin.row_pitch(c, 1)  # ldq
