"""3xTF32 and the port's f32 precision, on the CPU.

* ``split_tf32`` (``ops/swin_block.py``), which ``make_dense`` applies to
  every f32 weight of the 3xTF32 GEMM, against the rounding the kernels
  take on the card (``cvt.rna.tf32.f32``: 10 explicit mantissa bits,
  nearest, ties away from zero) computed here in float64: the low 13 bits
  of hi are zero, x = hi + lo to within 2^-22 |x|, and zeros, denormals,
  infinities and NaN pass through.
* A plain 3xTF32 product (hi.hi + hi.lo + lo.hi, each in f32) at the f32
  products' shapes of phase W (the Swin stages' K = 192 ... 1536, fc2's
  K = 768 at stage 0) and of the decoder (K = 256, the FFN's 2048): within
  the ``cuda`` tests' 1e-5 of a float64 product, which shows on the CPU
  that the scheme can meet them (and that one TF32 pass cannot).
* The f32 entry points' precision: a float32 configuration serves (and
  trains) with TF32 off whatever flags the caller has set, and gives the
  caller's flags back; a bf16 configuration leaves them alone.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.datasets.synthetic import make_batch  # noqa: E402
from mask_bev_tpu_torch.inference import MaskBevPredictor  # noqa: E402
from mask_bev_tpu_torch.models.maskbev import MaskBev  # noqa: E402
from mask_bev_tpu_torch.ops.swin_block import (  # noqa: E402
    make_dense, split_tf32, tf32_rna)
from mask_bev_tpu_torch.train.step import (  # noqa: E402
    create_train_state, loss_and_grads)
from mask_bev_tpu_torch.utils.precision import full_f32  # noqa: E402

LOW13 = 0x1FFF


def _rna_ref(x: np.ndarray) -> np.ndarray:
    """Round f32 values to 10 explicit mantissa bits, nearest, ties away
    from zero, in float64 (normal and denormal f32 alike)."""
    x64 = x.astype(np.float64)
    ax = np.abs(x64)
    # the f32 exponent of each value (denormals share the smallest)
    e = np.floor(np.log2(np.where(ax > 0, ax, 1.0)))
    e = np.maximum(e, -126.0)
    step = np.exp2(e - 10)
    return np.sign(x64) * np.floor(ax / step + 0.5) * step


def _values(seed=0, n=20000):
    rng = np.random.default_rng(seed)
    mant = rng.uniform(1.0, 2.0, n)
    exp = rng.integers(-100, 100, n)
    sign = rng.choice([-1.0, 1.0], n)
    return (sign * mant * np.exp2(exp)).astype(np.float32)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def test_split_hi_is_tf32_rounded_to_nearest_away():
    x = _values()
    hi, lo = split_tf32(torch.from_numpy(x))
    assert not (_bits(hi) & LOW13).any()
    assert not (_bits(lo) & LOW13).any()
    np.testing.assert_array_equal(hi.numpy().astype(np.float64), _rna_ref(x))


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),      # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),   # a tie, odd below: still up
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),      # just below the tie: down
    (2.0 - 2.0 ** -12, 2.0),                   # carries into the exponent
])
def test_split_ties_go_away_from_zero(x, want):
    hi = tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert float(hi[0]) == want


def test_split_error_is_within_2_to_the_minus_22():
    x = _values(1)
    hi, lo = split_tf32(torch.from_numpy(x))
    err = np.abs(x.astype(np.float64) - hi.numpy().astype(np.float64)
                 - lo.numpy().astype(np.float64))
    assert (err <= 2.0 ** -22 * np.abs(x.astype(np.float64))).all()
    # hi alone (one TF32 pass) keeps only ~2^-11
    rel = np.abs(x - hi.numpy()) / np.abs(x)
    assert rel.max() > 2.0 ** -14


def test_split_special_values_pass_through():
    tiny = np.float32(2.0 ** -126)
    den = np.array([tiny * 0.75, -tiny * 0.3, np.float32(1e-44),
                    np.float32(2.0 ** -140)], np.float32)
    assert (np.abs(den) < tiny).all() and (den != 0).all()
    x = np.concatenate([np.array([0.0, -0.0, np.inf, -np.inf, np.nan],
                                 np.float32), den])
    hi, lo = split_tf32(torch.from_numpy(x))
    h, lo_ = hi.numpy(), lo.numpy()
    # zeros keep their sign and split into zeros
    assert _bits(hi)[0] == 0 and _bits(hi)[1] == np.int32(-2 ** 31)
    assert (lo_[:2] == 0).all()
    # infinities: hi is the infinity, lo 0 (so hi + lo is not NaN)
    assert h[2] == np.inf and h[3] == -np.inf and (lo_[2:4] == 0).all()
    # NaN stays NaN in hi
    assert np.isnan(h[4]) and lo_[4] == 0
    # denormals: TF32 values, rounded as the normals are, the remainder in
    # lo to within half a TF32 step at the denormal scale
    d64, hd, ld = (den.astype(np.float64), h[5:].astype(np.float64),
                   lo_[5:].astype(np.float64))
    assert not (_bits(hi)[5:] & LOW13).any()
    np.testing.assert_array_equal(hd, _rna_ref(den))
    assert (np.abs(d64 - hd - ld) <= 2.0 ** -137).all()


def test_make_dense_splits_only_f32_weights_on_the_card(monkeypatch):
    """The TF32 halves are made for f32 weights on a CUDA device only (the
    CPU's plain version does not read them); seen here through a tensor
    that reports itself as a CUDA one."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(48, 32, generator=g)
    b = torch.randn(48, generator=g)
    cpu = make_dense(w, b, False)
    assert cpu.hi is None and cpu.lo is None and torch.equal(cpu.wt, w)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    d = make_dense(w, b, False)
    hi, lo = split_tf32(w)
    assert torch.equal(d.hi, hi) and torch.equal(d.lo, lo)
    assert torch.equal(d.wt, w) and d.q8 is None
    for dense in (make_dense(w.bfloat16(), b, False), make_dense(w, b, True)):
        assert dense.hi is None and dense.lo is None


def _three_pass(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 3xTF32 product as the kernels form it, each term an f32 product
    with f32 sums: lo.hi + hi.lo, then hi.hi."""
    ah, al = split_tf32(a)
    wh, wl = split_tf32(w)
    return (al @ wh.t() + ah @ wl.t()) + ah @ wh.t()


@pytest.mark.parametrize("k,n", [
    (192, 576),    # stage 0: qkv
    (768, 192),    # stage 0: fc2 (K = 4 C)
    (384, 1536),   # stage 1: fc1
    (768, 768),    # stage 2: proj
    (1536, 1536),  # stage 3: proj (the widest K of the Swin chain)
    (256, 256),    # decoder: k/v projections, dense products
    (256, 2048),   # decoder: FFN first product
    (2048, 256),   # decoder: FFN second product
    (2048, 192),   # patch embed at path K: K = p p C = 4 x 4 x 128, E 192
])
def test_three_pass_product_meets_the_card_bound(k, n):
    rng = np.random.default_rng(k + n)
    a = torch.from_numpy(rng.standard_normal((96, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((n, k))
                          / np.sqrt(k)).astype(np.float32))
    ref = a.double() @ w.double().t()
    scale = float(ref.abs().max())
    err3 = float((_three_pass(a, w).double() - ref).abs().max()) / scale
    hi_a, hi_w = tf32_rna(a), tf32_rna(w)
    err1 = float(((hi_a @ hi_w.t()).double() - ref).abs().max()) / scale
    assert err3 <= 1e-5, err3       # test_gemm_f32's bound on the card
    assert err3 <= 4e-6, err3       # ~1e-6 expected
    assert err1 > 1e-4, err1        # one TF32 pass cannot meet it


# ---- the f32 entry points' precision ---------------------------------------


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def caller_tf32():
    """The caller's flags set to TF32 (cuDNN's default on a card; the
    matmul flag turned on too), restored after the test."""
    saved = _flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield (True, True)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
        saved)


def _scan(cfg, b=1, seed=0):
    rng = np.random.default_rng(seed)
    n = cfg.max_points_per_scan
    pts = np.stack([rng.uniform(-9.9, 9.9, (b, n)),
                    rng.uniform(-9.9, 9.9, (b, n)),
                    rng.uniform(-3, 3, (b, n)), rng.uniform(0, 1, (b, n))],
                   -1).astype(np.float32)
    return torch.as_tensor(pts), torch.ones((b, n), dtype=torch.bool)


def _spy(conv, seen):
    conv.register_forward_pre_hook(lambda mod, args: seen.append(_flags()))


@pytest.mark.parametrize("dtype,inside", [("float32", (False, False)),
                                          ("bfloat16", (True, True))])
def test_predictor_sets_its_own_precision(caller_tf32, dtype, inside):
    cfg = tiny_test_config().replace(compute_dtype=dtype)
    sd = MaskBev(cfg).random_state_dict(0)
    pred = MaskBevPredictor(cfg, sd, device="cpu")
    seen = []
    for name in ("lateral0", "output3", "mask_feature"):
        _spy(getattr(pred.model.pixel_decoder, name), seen)
    pred.forward(*_scan(cfg))
    assert seen == [inside] * 3
    assert _flags() == caller_tf32


def test_full_f32_restores_the_flags_on_error(caller_tf32):
    with pytest.raises(RuntimeError, match="inside"):
        with full_f32(torch.float32):
            assert _flags() == (False, False)
            raise RuntimeError("inside")
    assert _flags() == caller_tf32
    with full_f32(torch.bfloat16):
        assert _flags() == caller_tf32


def test_f32_train_step_backward_runs_in_full_f32(caller_tf32):
    """The f32 training step: its forward and its backward (a conv's
    gradient) see TF32 off; the caller's flags come back."""
    cfg = tiny_test_config().replace(compute_dtype="float32")
    st = create_train_state(cfg, seed=0, device="cpu")
    conv = st.model.pixel_decoder.mask_feature
    fwd, bwd = [], []
    conv.register_forward_pre_hook(lambda mod, args: fwd.append(_flags()))
    conv.register_full_backward_pre_hook(
        lambda mod, grad_out: bwd.append(_flags()))
    batch = make_batch(np.random.default_rng(0), cfg, batch_size=1)
    loss_and_grads(st, batch, torch.Generator().manual_seed(0))
    assert fwd and bwd
    assert set(fwd) == set(bwd) == {(False, False)}
    assert _flags() == caller_tf32
