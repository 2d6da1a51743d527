"""Kernel 3: one whole Swin block, for every stage.

Replaces ``mask_bev_tpu/ops/pallas_swin_block.py::fused_swin_block_col``
(stages 0-1) and ``::fused_swin_block`` (stages 2-3): the two TPU layouts
are Mosaic workarounds, so one Hopper kernel chain serves both. One block
computes ``x + proj(W-MSA(LN1 x))`` and then ``+ fc2(gelu(fc1(LN2 .)))`` on
the unpadded (B, H*W, C) token grid:

* windows, padding and the cyclic shift by ``win // 2`` are index math on
  the (hp, wp) padded grid; the shift applies only when ``min(hp, wp) !=
  win``. Pad tokens are zero after LN1 and still take part as keys and
  values (k = b_k, v = b_v), exactly as ``jnp.pad`` after ``norm1`` does;
* the relative-position bias and the -100 shift-region mask are added to
  the f32 scores; LayerNorms are two-pass f32 with eps 1e-6 (the JAX
  block's ``LayerNormP`` and its TPU kernel's form); GELU is the
  exact erf GELU that the reference XLA path computes;
* with ``quant`` the four dense products (qkv, proj, fc1, fc2) follow
  ``int8_sim_dense`` bit for bit: per-token activation scale
  ``max|x| / 127`` floored at 1e-6, per-output-channel weight scale floored
  at 1e-8, round half to even, clip to +-127, int32 accumulation, f32
  dequantisation plus bias. XLA computes ``/ 127.0`` as a product with the
  f32 reciprocal of 127 (``INV127``), so both scales are taken that way.

Rounding follows the reference XLA block in the model dtype D: LN outputs,
qkv, attention probabilities and outputs, projections and residual sums are
rounded to D where XLA rounds them.

The CUDA chain (``csrc/swin_block.cu``): LN1 (+quantise) -> qkv GEMM ->
window attention -> (quantise) -> proj GEMM + residual -> LN2 (+quantise)
-> fc1 GEMM + GELU -> (quantise) -> fc2 GEMM + residual. The GEMMs are the
persistent wgmma kernel of ``csrc/gemm.cuh`` (TMA loads, int8, bf16 or f32
as 3xTF32); the attention (``csrc/window_attn.cuh``, shared with kernel 7)
keeps its scores in registers on ``mma.sync`` (f32 as 3xTF32). f32
activations (the shipped configurations' dtype) take every launch's f32
instance: the int8 GEMM with f32 epilogues, or the 3xTF32 GEMM (its weight
split once into TF32 halves by :func:`make_dense`); f32 LN, quantisation
and attention. Every launch counts under ``swin_block``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mask_bev_tpu_torch.kernels import build as kb

EPI_BIAS, EPI_GELU, EPI_RESIDUAL = 0, 1, 2
EPI_ROUND_ACC = 16  # round the raw product to D before the bias (XLA order)
# XLA rewrites a division by the constant 127 into a product with its f32
# reciprocal; the int8 scales use that product to match it bit for bit
INV127 = float(np.float32(1.0) / np.float32(127.0))


class Dense(NamedTuple):
    """A prepared dense layer: ``wt`` (N, K) in D, ``bias`` (N,) f32 holding
    D values, for int8 the quantised ``q8`` (N, K) with ``sw`` (N,), and for
    an f32 ``wt`` its TF32 halves ``hi``, ``lo`` (:func:`split_tf32`), which
    the 3xTF32 GEMM reads."""

    wt: torch.Tensor
    bias: torch.Tensor
    q8: Optional[torch.Tensor] = None
    sw: Optional[torch.Tensor] = None
    hi: Optional[torch.Tensor] = None
    lo: Optional[torch.Tensor] = None


class BlockWeights(NamedTuple):
    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    qkv: Dense
    proj: Dense
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    fc1: Dense
    fc2: Dense
    rel_bias: torch.Tensor  # (heads, win², win²) f32 holding D values


def quantize_weight(wt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, K) weight -> per-output-channel int8 (N, K) and scale (N,) f32,
    as ``int8_sim_dense`` quantises the (K, N) kernel along K."""
    w32 = wt.float()
    sw = torch.clamp(w32.abs().amax(dim=1), min=1e-8) * INV127
    q = torch.clamp(torch.round(w32 / sw[:, None]), -127, 127)
    return q.to(torch.int8).contiguous(), sw.contiguous()


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 explicit mantissa bits; the low 13
    bits of the word zero), ties away from zero: ``cvt.rna.tf32.f32``.
    Adding half a TF32 step to the magnitude's bit pattern and clearing the
    low bits rounds so, denormals included; a value beyond the largest TF32
    value becomes an infinity, and NaN stays NaN."""
    bits = x.float().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(x), x.float(), r)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo), both TF32 values, x = hi + lo to within 2^-22 |x|
    (normal x): hi = rna(x), lo = rna(x - hi) (``csrc/common.cuh::
    split_tf32``). lo is 0 where hi is not finite, so infinities pass
    through."""
    hi = tf32_rna(x)
    lo = torch.where(torch.isfinite(hi), tf32_rna(x.float() - hi),
                     torch.zeros_like(hi))
    return hi, lo


def make_dense(weight: torch.Tensor, bias: Optional[torch.Tensor],
               quant: bool) -> Dense:
    """From a torch Linear ``weight`` (N, K) and ``bias``; an f32 weight on
    a CUDA device also gets its TF32 halves (for the 3xTF32 GEMM: twice the
    weight's bytes more on the device; the CPU's plain version does not
    read them)."""
    wt = weight.detach().contiguous()
    b = (torch.zeros(wt.shape[0], device=wt.device) if bias is None
         else bias.detach().float().contiguous())
    if quant:
        q8, sw = quantize_weight(wt)
        return Dense(wt, b, q8, sw)
    if wt.dtype == torch.float32 and wt.is_cuda:
        hi, lo = split_tf32(wt)
        return Dense(wt, b, hi=hi, lo=lo)
    return Dense(wt, b)


def quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8 quantisation (values as f32) and scale (..., 1)."""
    x32 = x.float()
    sx = torch.clamp(x32.abs().amax(dim=-1, keepdim=True), min=1e-6) * INV127
    return torch.clamp(torch.round(x32 / sx), -127.0, 127.0), sx


def int8_sim_dense(x: torch.Tensor, d: Dense) -> torch.Tensor:
    """``mask_bev_tpu.models.swin.int8_sim_dense``: int8 x int8 products
    summed exactly (float64 holds every int32 sum), f32 dequant + bias."""
    q, sx = quant_rows(x)
    acc = (q.double() @ d.q8.double().t()).float()
    return (acc * sx * d.sw + d.bias).to(x.dtype)


def dense(x: torch.Tensor, d: Dense, quant: bool) -> torch.Tensor:
    """``x @ kernel + bias`` in D (XLA order), or its int8 form."""
    if quant:
        return int8_sim_dense(x, d)
    return x @ d.wt.t().to(x.dtype) + d.bias.to(x.dtype)


def layer_norm_p(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """The JAX package's ``LayerNormP`` (``models/swin.py:71-92``; the
    Swin blocks' and the decoder's norms, and the TPU block kernel's): f32
    statistics, two-pass variance ``E[(x - E[x])^2]``, output in D. The
    backbone's other norms are flax ``nn.LayerNorm``, whose fast-variance
    form is ``ops/layer_norm.py::layer_norm_plain``."""
    x32 = x.float()
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * w.float() + b.float()
    return y.to(x.dtype)


def rel_pos_index(wh: int, ww: int) -> np.ndarray:
    """Static (wh*ww, wh*ww) index into the (2wh-1)*(2ww-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def shift_attn_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """Static additive mask (nW, w², w²) for shifted-window attention."""
    img_mask = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift),
               slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    mw = img_mask.reshape(hp // window, window, wp // window, window)
    mw = mw.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = mw[:, None, :] != mw[:, :, None]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


def rel_bias_from_table(table: torch.Tensor, win: int) -> torch.Tensor:
    """((2w-1)², heads) table -> (heads, w², w²) f32 bias."""
    n = win * win
    idx = torch.as_tensor(rel_pos_index(win, win).reshape(-1),
                          device=table.device)
    return (table[idx].reshape(n, n, -1).permute(2, 0, 1).float()
            .contiguous())


def effective_shift(hw: Tuple[int, int], win: int, shifted: bool) -> int:
    hp = -(-hw[0] // win) * win
    wp = -(-hw[1] // win) * win
    return 0 if (not shifted or min(hp, wp) == win) else win // 2


def partition_windows(y: torch.Tensor, hw, win: int, shift: int
                      ) -> torch.Tensor:
    """(B, H*W, C) tokens -> (B, nW, win², C) windows of the zero-padded
    grid, rolled by ``-shift`` first (``ShiftWindowMSA``'s partition)."""
    h, w = hw
    b, _, c = y.shape
    hp, wp = -(-h // win) * win, -(-w // win) * win
    x = F.pad(y.reshape(b, h, w, c), (0, 0, 0, wp - w, 0, hp - h))
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    nwh, nww = hp // win, wp // win
    return (x.reshape(b, nwh, win, nww, win, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, nwh * nww, win * win, c))


def merge_windows(xw: torch.Tensor, hw, win: int, shift: int
                  ) -> torch.Tensor:
    """Inverse of :func:`partition_windows`: (B, nW, win², C) -> (B, H*W,
    C), rolled back by ``shift`` and cropped to the grid."""
    h, w = hw
    b, _, _, c = xw.shape
    hp, wp = -(-h // win) * win, -(-w // win) * win
    nwh, nww = hp // win, wp // win
    x = (xw.reshape(b, nwh, nww, win, win, c).permute(0, 1, 3, 2, 4, 5)
         .reshape(b, hp, wp, c))
    if shift:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    return x[:, :h, :w].reshape(b, h * w, c)


def shift_mask(hw, win: int, shift: int, device) -> Optional[torch.Tensor]:
    """The (nW, win², win²) f32 shift-region mask, or None unshifted."""
    if not shift:
        return None
    hp, wp = -(-hw[0] // win) * win, -(-hw[1] // win) * win
    return torch.as_tensor(shift_attn_mask(hp, wp, win, shift),
                           device=device)


def window_msa_plain(y: torch.Tensor, p: BlockWeights, hw, win: int,
                     heads: int, shift: int, quant: bool) -> torch.Tensor:
    """Port of ``ShiftWindowMSA`` + ``WindowMSA`` (the XLA form) on LN1's
    output: q scaled before its product, bf16 qkv and projection in XLA
    order, or their int8 form."""
    xw = partition_windows(y, hw, win, shift)
    b, nw, n, c = xw.shape
    hd = c // heads
    qkv = dense(xw.reshape(b * nw, n, c), p.qkv, quant)
    qkv = qkv.reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = (q * hd ** -0.5).float() @ k.float().transpose(-1, -2)
    bias = p.rel_bias[None]
    mask = shift_mask(hw, win, shift, y.device)
    if mask is not None:
        bias = (bias + mask[:, None]).repeat(b, 1, 1, 1)
    attn = torch.softmax(attn + bias, dim=-1).to(y.dtype)
    out = (attn.float() @ v.float()).to(y.dtype)
    out = dense(out.transpose(1, 2).reshape(-1, n, c), p.proj, quant)
    return merge_windows(out.reshape(b, nw, n, c), hw, win, shift)


def swin_block_plain(x: torch.Tensor, p: BlockWeights, hw, win: int,
                     heads: int, shift: int, quant: bool) -> torch.Tensor:
    """Plain PyTorch version of one block on (B, H*W, C) tokens in D."""
    y = layer_norm_p(x, p.ln1_w, p.ln1_b)
    x = x + window_msa_plain(y, p, hw, win, heads, shift, quant)
    y = layer_norm_p(x, p.ln2_w, p.ln2_b)
    y = F.gelu(dense(y, p.fc1, quant), approximate="none")
    return x + dense(y, p.fc2, quant)


# --------------------------------------------------------------- CUDA chain


def _f32(t: torch.Tensor) -> bool:
    """The instance a launch takes: f32 for f32 activations, else bf16."""
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the Swin chain kernels take bf16 or f32 "
                         f"activations; got {t.dtype}")
    return t.dtype == torch.float32


def _ln(x2, w, b, quant):
    m, c = x2.shape
    # the kernel reads rows and the affine in 16-byte words
    if c % 8 or x2.data_ptr() % 16:
        raise ValueError(f"swin layernorm kernel: C={c} must be a multiple "
                         "of 8 and the rows 16-byte aligned")
    f32 = _f32(x2)
    w, b = (t.to(x2.dtype) for t in (w, b))
    w, b = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (w, b))
    if quant:
        q8 = torch.empty((m, c), dtype=torch.int8, device=x2.device)
        sx = torch.empty((m,), dtype=torch.float32, device=x2.device)
        out = None
    else:
        q8 = sx = None
        out = torch.empty_like(x2)
    kb.launch("swin_block", "swin_layernorm", kb.ptr(x2), kb.ptr(w),
              kb.ptr(b), kb.ptr(out), kb.ptr(q8), kb.ptr(sx), kb.ci(m),
              kb.ci(c), kb.cf(1e-6), kb.ci(f32), kb.stream(),
              instance="f32" if f32 else "bf16")
    return (q8, sx) if quant else out


def _quant(x2):
    m, k = x2.shape
    f32 = _f32(x2)
    q8 = torch.empty((m, k), dtype=torch.int8, device=x2.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x2.device)
    kb.launch("swin_block", "swin_quant_rows", kb.ptr(x2), kb.ptr(q8),
              kb.ptr(sx), kb.ci(m), kb.ci(k), kb.ci(f32), kb.stream(),
              instance="f32" if f32 else "bf16")
    return q8, sx


def gemm_refusal(k: int, n: int) -> Optional[str]:
    """Why the GEMM does not take a (K -> N) product, or None where it
    does: K % 16 == 0 (16-deep k-steps) and N % 8 == 0."""
    if k % 16 or n % 8:
        return (f"gemm kernel needs K % 16 == 0 and N % 8 == 0, got K={k}, "
                f"N={n}")
    return None


def gemm(name: str, a, d: Dense, mode: int, residual=None, sx=None,
         out_dtype=torch.bfloat16):
    """out (M, N) = epilogue(a @ d^T): ``a`` is bf16 (M, K) with a bf16
    out, f32 with an f32 out (the 3xTF32 instance, ``d.hi``/``d.lo`` from
    :func:`make_dense`), or int8 with per-row scale ``sx`` (then
    ``d.q8``/``d.sw`` are used) and an ``out_dtype`` (bf16 or f32) out and
    residual. Counted under ``name`` and ``name/gemm_bf16``,
    ``gemm_s8_bf16``, ``gemm_s8_f32`` or ``gemm_f32_3xtf32``."""
    m, k = a.shape
    n = d.wt.shape[0]
    reason = gemm_refusal(k, n)
    if reason:
        raise ValueError(reason)
    if sx is None:
        out_dtype = a.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gemm kernel writes bf16 or f32, not {out_dtype}")
    f32 = out_dtype == torch.float32
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if residual is not None:
        kb.check_cuda(residual, "residual", out_dtype, (m, n))
    kb.check_cuda(d.bias, "bias", torch.float32, (n,))
    if sx is not None:
        kb.check_cuda(a, "a", torch.int8)
        kb.check_cuda(d.q8, "w8", torch.int8, (n, k))
        ws = (d.q8, d.sw)
    elif f32:
        kb.check_cuda(a, "a", torch.float32)
        if d.hi is None or d.lo is None:
            raise ValueError("gemm kernel: an f32 weight needs its TF32 "
                             "halves (prepare it with make_dense)")
        kb.check_cuda(d.hi, "w_hi", torch.float32, (n, k))
        kb.check_cuda(d.lo, "w_lo", torch.float32, (n, k))
        ws = (d.hi, d.lo)
    else:
        kb.check_cuda(a, "a", out_dtype)
        kb.check_cuda(d.wt, "w", out_dtype, (n, k))
        ws = (d.wt,)
    # TMA reads both operands, the epilogue reads 16-byte vectors
    for t, what in ((a, "a"), *((w, "w") for w in ws), (d.bias, "bias"),
                    (residual, "residual")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"gemm kernel: {what} must be 16-byte aligned")
    if sx is not None:
        kb.launch(name, "gemm_s8", kb.ptr(a), kb.ptr(sx), kb.ptr(d.q8),
                  kb.ptr(d.sw), kb.ptr(d.bias), kb.ptr(residual),
                  kb.ptr(out), kb.ci(m), kb.ci(n), kb.ci(k), kb.ci(mode),
                  kb.ci(f32), kb.stream(),
                  instance="gemm_s8_" + ("f32" if f32 else "bf16"))
    elif f32:
        kb.launch(name, "gemm_f32_3xtf32", kb.ptr(a), kb.ptr(d.hi),
                  kb.ptr(d.lo), kb.ptr(d.bias), kb.ptr(residual),
                  kb.ptr(out), kb.ci(m), kb.ci(n), kb.ci(k), kb.ci(mode),
                  kb.stream(), instance="gemm_f32_3xtf32")
    else:
        kb.launch(name, "gemm_bf16", kb.ptr(a), kb.ptr(d.wt),
                  kb.ptr(d.bias), kb.ptr(residual), kb.ptr(out), kb.ci(m),
                  kb.ci(n), kb.ci(k), kb.ci(mode), kb.stream(),
                  instance="gemm_bf16")
    return out


# the window attention's limits (``csrc/window_attn.cuh``, every instance):
# up to 128 tokens a window in one pass over whole score rows
# (``window_attn_kernel``), up to 256 in 64-key chunks with a running max and
# sum (``window_attn_long_kernel``: windows 12 to 16)
ATTN_HEAD_DIMS = (16, 32, 64)
ATTN_ONE_PASS_TOKENS = 128
ATTN_MAX_TOKENS = 256


def attn_refusal(what: str, c: int, heads: int, win: int) -> Optional[str]:
    """Why the window attention kernel (of kernel ``what``) does not take C
    channels over ``heads`` heads in ``win`` x ``win`` windows, or None
    where it does: a head width of :data:`ATTN_HEAD_DIMS` and at most
    :data:`ATTN_MAX_TOKENS` tokens a window."""
    if (c % heads or c // heads not in ATTN_HEAD_DIMS
            or win * win > ATTN_MAX_TOKENS):
        return (f"{what} kernel: bad shape, C={c} over {heads} heads in "
                f"windows of {win}x{win}: the attention takes head widths "
                f"{ATTN_HEAD_DIMS} and at most {ATTN_MAX_TOKENS} tokens a "
                f"window")
    return None


def attn_instance(f32: bool, win: int) -> str:
    """The instance a window attention launch counts under: ``attn_bf16``
    or ``attn_f32``, with ``_long`` for windows of more than
    :data:`ATTN_ONE_PASS_TOKENS` tokens (``window_attn_long_kernel``)."""
    pad = -(-win * win // 16) * 16
    return ("attn_f32" if f32 else "attn_bf16") + (
        "_long" if pad > ATTN_ONE_PASS_TOKENS else "")


def check_attn_shape(what: str, c: int, heads: int, win: int) -> None:
    """Raise with :func:`attn_refusal`'s reason, if any."""
    reason = attn_refusal(what, c, heads, win)
    if reason:
        raise ValueError(reason)


def swin_block_refusal(c: int, heads: int, win: int, hidden: int,
                       dtype) -> Optional[str]:
    """Why the Swin chain (kernel 3) does not take a block of C channels
    over ``heads`` heads in ``win`` x ``win`` windows with ``hidden`` MLP
    units on tokens of ``dtype``, or None where it does: bf16 or f32,
    :func:`attn_refusal` and :func:`gemm_refusal` of every product."""
    if dtype not in (torch.bfloat16, torch.float32):
        return (f"the Swin chain kernels take bf16 or f32 activations; got "
                f"{dtype}")
    reason = attn_refusal("swin block", c, heads, win)
    for k, n in ((c, 3 * c), (c, c), (c, hidden), (hidden, c)):
        reason = reason or gemm_refusal(k, n)
    return reason


def attn_smem_bytes(win: int, hd: int, f32: bool = False,
                    msa: bool = False) -> int:
    """Shared memory of one attention block (``csrc/window_attn.cuh::
    window_attn_smem``, ``window_attn_long_smem`` above
    :data:`ATTN_ONE_PASS_TOKENS`): q, k, v rows of the padded window (bf16,
    stride hd + 8) or k, v rows (f32, stride hd + 4); up to 128 tokens the
    relative bias of its head (stride NP + 8) as bf16 over NP rows (the
    Swin variant in bf16) or as f32 over n rows (longer windows read it
    from device memory); the token and label rows. A block takes one head
    over 4 windows, so it reads the bias once for them."""
    n = win * win
    n_pad = -(-n // 16) * 16
    rows = 2 * n_pad * (hd + 4) * 4 if f32 else 3 * n_pad * (hd + 8) * 2
    bias = n * (n_pad + 8) * 4 if (f32 or msa) else n_pad * (n_pad + 8) * 2
    if n_pad > ATTN_ONE_PASS_TOKENS:
        bias = 0
    return rows + bias + 8 * n_pad


def qkv_windows(qkv: torch.Tensor, qkv_bias: torch.Tensor, b: int,
                hw: Tuple[int, int], heads: int, win: int, shift: int
                ) -> torch.Tensor:
    """(B*H*W, 3C) qkv -> (3, B*nW, heads, n, hd) q, k, v windows of the
    padded grid rolled by ``-shift``; pad tokens take the qkv bias rounded
    to the dtype (a zero row through the qkv product)."""
    h, w = hw
    c = qkv.shape[1] // 3
    hp, wp = -(-h // win) * win, -(-w // win) * win
    grid = qkv_bias.to(qkv.dtype).expand(b, hp, wp, 3 * c).clone()
    grid[:, :h, :w] = qkv.reshape(b, h, w, 3 * c)
    if shift:
        grid = torch.roll(grid, (-shift, -shift), dims=(1, 2))
    nw = (hp // win) * (wp // win)
    return (grid.reshape(b, hp // win, win, wp // win, win, 3 * c)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(b * nw, win * win, 3, heads, c // heads)
            .permute(2, 0, 3, 1, 4))


def window_attention_plain(qkv: torch.Tensor, qkv_bias: torch.Tensor,
                           rel: torch.Tensor, b: int, hw: Tuple[int, int],
                           heads: int, win: int, shift: int, msa: bool
                           ) -> torch.Tensor:
    """Plain version of the attention launch: (B*H*W, 3C) qkv -> (B*H*W,
    C) on :func:`qkv_windows`. The Swin variant scales q before the
    product and rounds it, the MSA variant scales the f32 score; rel plus
    the shift mask summed first; f32 softmax rounded to the dtype; f32
    ``p v``."""
    c = qkv.shape[1] // 3
    hd, n = c // heads, win * win
    t = qkv_windows(qkv, qkv_bias, b, hw, heads, win, shift)
    if msa:
        attn = (t[0].float() @ t[1].float().transpose(-1, -2)) * hd ** -0.5
    else:
        attn = (t[0] * hd ** -0.5).float() @ t[1].float().transpose(-1, -2)
    bias = rel.float()[None]
    mask = shift_mask(hw, win, shift, qkv.device)
    if mask is not None:
        bias = (bias + mask[:, None]).repeat(b, 1, 1, 1)
    attn = torch.softmax(attn + bias, dim=-1).to(qkv.dtype)
    o = (attn.float() @ t[2].float()).to(qkv.dtype)
    o = o.transpose(1, 2).reshape(b, -1, n, c)
    return merge_windows(o, hw, win, shift).reshape(qkv.shape[0], c)


def attention(name: str, qkv: torch.Tensor, qkv_bias: torch.Tensor,
              rel: torch.Tensor, b: int, hw: Tuple[int, int], heads: int,
              win: int, shift: int, msa: bool) -> torch.Tensor:
    """The window attention launch (``csrc/window_attn.cuh``) of kernel 3
    (``msa=False``) or kernel 7 (``msa=True``): (B*H*W, 3C) qkv of bf16 or
    f32 -> (B*H*W, C) of the same dtype; windows, padding and the shift
    are its index math. Counted under ``name`` and ``name/``
    :func:`attn_instance`; the plain version for CPU tensors."""
    if not qkv.is_cuda:
        return window_attention_plain(qkv, qkv_bias, rel, b, hw, heads, win,
                                      shift, msa)
    c = qkv.shape[1] // 3
    f32 = _f32(qkv)
    check_attn_shape(name, c, heads, win)
    kb.check_cuda(qkv, "qkv", qkv.dtype, (b * hw[0] * hw[1], 3 * c))
    kb.check_cuda(qkv_bias, "qkv_bias", torch.float32, (3 * c,))
    kb.check_cuda(rel, "rel", torch.float32, (heads, win * win, win * win))
    # rows arrive in 16-byte copies
    if qkv.data_ptr() % 16 or qkv_bias.data_ptr() % 16 or c % 8:
        raise ValueError(f"{name} attention kernel: qkv and its bias must "
                         f"be 16-byte aligned and C a multiple of 8")
    o = torch.empty((qkv.shape[0], c), dtype=qkv.dtype, device=qkv.device)
    kb.launch(name, "window_msa_attn" if msa else "swin_window_attn",
              kb.ptr(qkv), kb.ptr(qkv_bias), kb.ptr(rel), kb.ptr(o),
              kb.ci(b), kb.ci(hw[0]), kb.ci(hw[1]), kb.ci(c), kb.ci(heads),
              kb.ci(win), kb.ci(shift), kb.cf((c // heads) ** -0.5),
              kb.ci(f32), kb.stream(), instance=attn_instance(f32, win))
    return o


def window_attention(qkv: torch.Tensor, p: BlockWeights, b: int,
                     hw: Tuple[int, int], heads: int, win: int, shift: int
                     ) -> torch.Tensor:
    """The Swin chain's attention (one launch, counted under
    ``swin_block``): (B*H*W, 3C) qkv -> (B*H*W, C) of the same dtype."""
    return attention("swin_block", qkv, p.qkv.bias, p.rel_bias, b, hw,
                     heads, win, shift, msa=False)


def swin_block(x: torch.Tensor, p: BlockWeights, hw: Tuple[int, int],
               win: int, heads: int, shift: int, quant: bool
               ) -> torch.Tensor:
    """One Swin block on (B, H*W, C): the CUDA chain for CUDA tensors, the
    plain version for CPU tensors."""
    if not x.is_cuda:
        return swin_block_plain(x, p, hw, win, heads, shift, quant)
    b, l, c = x.shape
    h, w = hw
    if l != h * w:
        raise ValueError(f"swin block kernel: bad shape {x.shape} for "
                         f"hw={hw}")
    reason = swin_block_refusal(c, heads, win, p.fc1.wt.shape[0], x.dtype)
    if reason:
        raise ValueError(reason)
    kb.check_cuda(x, "x", x.dtype)
    x2 = x.reshape(b * l, c)
    dt = x.dtype
    mode_d = EPI_BIAS if quant else EPI_BIAS | EPI_ROUND_ACC
    if quant:
        q8, sx = _ln(x2, p.ln1_w, p.ln1_b, True)
        qkv = gemm("swin_block", q8, p.qkv, mode_d, sx=sx, out_dtype=dt)
    else:
        qkv = gemm("swin_block", _ln(x2, p.ln1_w, p.ln1_b, False), p.qkv,
                   mode_d)
    o = window_attention(qkv, p, b, hw, heads, win, shift)
    res = EPI_RESIDUAL | (0 if quant else EPI_ROUND_ACC)
    gelu = EPI_GELU | (0 if quant else EPI_ROUND_ACC)
    if quant:
        q8, sx = _quant(o)
        x1 = gemm("swin_block", q8, p.proj, res, residual=x2, sx=sx,
                  out_dtype=dt)
        q8, sx = _ln(x1, p.ln2_w, p.ln2_b, True)
        hmid = gemm("swin_block", q8, p.fc1, gelu, sx=sx, out_dtype=dt)
        q8, sx = _quant(hmid)
        out = gemm("swin_block", q8, p.fc2, res, residual=x1, sx=sx,
                   out_dtype=dt)
    else:
        x1 = gemm("swin_block", o, p.proj, res, residual=x2)
        hmid = gemm("swin_block", _ln(x1, p.ln2_w, p.ln2_b, False), p.fc1,
                    gelu)
        out = gemm("swin_block", hmid, p.fc2, res, residual=x1)
    return out.reshape(b, l, c)
