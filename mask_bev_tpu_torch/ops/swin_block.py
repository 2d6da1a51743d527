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

from typing import List, NamedTuple, Optional, Tuple

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
    # the kernels' qkv and projection where the heads' width is no multiple
    # of 8 (:func:`padded_heads`), made once with the weights; None: made
    # by the call
    qkv_k: Optional[Dense] = None
    proj_k: Optional[Dense] = None


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


def row_pitch(k: int, esz: int) -> int:
    """Elements between the rows of a GEMM operand of ``k`` values of
    ``esz`` bytes: ``k`` rounded up to whole 16-byte steps, the only row
    pitches TMA takes (``cuTensorMapEncodeTiled``'s global strides)."""
    step = 16 // esz
    return -(-k // step) * step


def pitched(t: torch.Tensor) -> torch.Tensor:
    """``t`` (rows, K) as the GEMM reads it: itself where its rows are whole
    16-byte steps apart, else an (rows, K) view of a copy whose rows are
    :func:`row_pitch` apart, the padding zero. Used once, when weights are
    packed; the activations' producers write their rows at that pitch."""
    rows, k = t.shape
    kp = row_pitch(k, t.element_size())
    if kp == k:
        return t
    buf = torch.zeros((rows, kp), dtype=t.dtype, device=t.device)
    buf[:, :k] = t
    return buf[:, :k]


def make_dense(weight: torch.Tensor, bias: Optional[torch.Tensor],
               quant: bool) -> Dense:
    """From a torch Linear ``weight`` (N, K) and ``bias``; an f32 weight on
    a CUDA device also gets its TF32 halves (for the 3xTF32 GEMM: twice the
    weight's bytes more on the device; the CPU's plain version does not
    read them). Each weight the GEMM reads is :func:`pitched` (padded only
    where its rows are not whole 16-byte steps: an int8 K % 16 != 0)."""
    wt = weight.detach().contiguous()
    b = (torch.zeros(wt.shape[0], device=wt.device) if bias is None
         else bias.detach().float().contiguous())
    if quant:
        q8, sw = quantize_weight(wt)
        return Dense(wt, b, pitched(q8), sw)
    if wt.dtype == torch.float32 and wt.is_cuda:
        hi, lo = split_tf32(wt)
        return Dense(wt, b, hi=pitched(hi), lo=pitched(lo))
    return Dense(pitched(wt), b)


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


def rel_offsets(win: int) -> Tuple[np.ndarray, np.ndarray]:
    """The compact bias table's index (``csrc/window_attn.cuh::
    window_attn_long_kernel`` and ``window_attn_width_kernel``): the score of query token i and key token j
    takes entry ``ro[i] - co[j]`` of the compact ((2w-1)²) table, ``co[j] =
    (j // w)(2w-1) + j % w`` and ``ro[i] = co[i] + (w-1)(2w)``; equal to
    :func:`rel_pos_index`."""
    tw = 2 * win - 1
    j = np.arange(win * win)
    co = (j // win) * tw + j % win
    return co + (win - 1) * (tw + 1), co


def rel_table_tokens(win: int) -> Tuple[np.ndarray, np.ndarray]:
    """The token pair (i, j) the long-window and head-width attentions read
    each compact table entry from in the expanded (heads, w², w²) bias: entry (dy, dx)
    (offsets -(w-1)..w-1, row-major) at i = (max(dy, 0), max(dx, 0)) and
    j = i - (dy, dx), whose :func:`rel_offsets` index is the entry."""
    tw = 2 * win - 1
    e = np.arange(tw * tw)
    dy, dx = e // tw - (win - 1), e % tw - (win - 1)
    ry, rx = np.maximum(dy, 0), np.maximum(dx, 0)
    return ry * win + rx, (ry - dy) * win + (rx - dx)


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


# csrc/swin_block.cu: the widest row the LN's register tile holds
# (SWIN_LN_TILE_C = 8 channels x 32 lanes x SWIN_LN_MAX_WORDS); wider rows
# up to SWIN_LN_WIDE_C take its wide kernel (swin_rows_wide_kernel: the row
# held in registers by SWIN_LN_WIDE_WARPS = 2 warps), wider ones, and int8
# rows of at most SWIN_LN_TILE_C values at a padded pitch, its walk
# (swin_rows_walk_kernel)
SWIN_LN_MAX_WORDS = 8
SWIN_LN_TILE_C = 8 * 32 * SWIN_LN_MAX_WORDS
SWIN_LN_WIDE_C = 4096


def _int8_rows(m: int, k: int, device) -> torch.Tensor:
    """(m, k) int8 rows at the GEMM's pitch (:func:`row_pitch`): a view of
    an (m, pitch) buffer where k % 16 != 0 (the kernel zeroes the
    padding)."""
    buf = torch.empty((m, row_pitch(k, 1)), dtype=torch.int8, device=device)
    return buf[:, :k]


def ln_instance(c: int, f32: bool, quant: bool) -> str:
    """The instance a Swin LN launch counts under: ``bf16``/``f32`` (the
    register tile), with ``_wide`` for rows over :data:`SWIN_LN_TILE_C` up
    to :data:`SWIN_LN_WIDE_C`, ``_walk`` for wider rows and for int8 rows
    of at most :data:`SWIN_LN_TILE_C` values at a padded pitch."""
    if SWIN_LN_TILE_C < c <= SWIN_LN_WIDE_C:
        kind = "_wide"
    elif c > SWIN_LN_TILE_C or (quant and row_pitch(c, 1) != c):
        kind = "_walk"
    else:
        kind = ""
    return ("f32" if f32 else "bf16") + kind


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
        q8 = _int8_rows(m, c, x2.device)
        sx = torch.empty((m,), dtype=torch.float32, device=x2.device)
        out = None
    else:
        q8 = sx = None
        out = torch.empty_like(x2)
    kb.launch("swin_block", "swin_layernorm", kb.ptr(x2), kb.ptr(w),
              kb.ptr(b), kb.ptr(out), kb.ptr(q8), kb.ptr(sx), kb.ci(m),
              kb.ci(c), kb.ci(q8.stride(0) if quant else c), kb.cf(1e-6),
              kb.ci(f32), kb.stream(), instance=ln_instance(c, f32, quant))
    return (q8, sx) if quant else out


def _quant(x2):
    m, k = x2.shape
    f32 = _f32(x2)
    q8 = _int8_rows(m, k, x2.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x2.device)
    walk = k % 8 or q8.stride(0) != k
    kb.launch("swin_block", "swin_quant_rows", kb.ptr(x2), kb.ptr(q8),
              kb.ptr(sx), kb.ci(m), kb.ci(k), kb.ci(q8.stride(0)),
              kb.ci(f32), kb.stream(),
              instance=("f32" if f32 else "bf16") + ("_walk" if walk else ""))
    return q8, sx


def gemm_refusal(k: int, n: int) -> Optional[str]:
    """Why the GEMM does not take a (K -> N) product, or None where it
    does: any K >= 1 (operands at :func:`row_pitch`; TMA reads the k past
    K as zeros) and any N >= 1 (N % 8 != 0: the N-tail instance)."""
    if k < 1 or n < 1:
        return f"gemm kernel needs K >= 1 and N >= 1, got K={k}, N={n}"
    return None


# csrc/gemm.cuh: the flagship instances' tile width (N % 8 == 0, 16-byte
# epilogue from the registers); csrc/gemm_ntail.cu: the N-tail instances'
# widest tile (NT_MAXW), every operand kind
GEMM_BN = 96
NTAIL_MAX_WIDTH = 112


class TilePlan(NamedTuple):
    """How the GEMM covers N: the instance (``flagship`` or ``ntail``), the
    tile width, the tiles across N and how a tile's output is stored:
    ``registers`` (the flagship's 16-byte stores from the accumulators),
    ``span`` (one N-tail tile spans N: its rows are one contiguous run of
    rows x N values, staged and stored in 16-byte words) or ``rows`` (each
    row segment's aligned interior in 16-byte words, its ends value by
    value)."""

    instance: str
    width: int
    tiles: int
    store: str


def gemm_tile_plan(n: int) -> TilePlan:
    """The GEMM's plan for N output columns, every operand kind, as
    ``csrc/gemm_ntail.cu::nt_width`` computes it for N % 8 != 0: N over
    ceil(N / :data:`NTAIL_MAX_WIDTH`) tiles, rounded up to 8 (wgmma slices
    of n 8, valid for .s8 too)."""
    if n % 8 == 0:
        return TilePlan("flagship", GEMM_BN, -(-n // GEMM_BN), "registers")
    tiles = -(-n // NTAIL_MAX_WIDTH)
    width = -(-(-(-n // tiles)) // 8) * 8
    return TilePlan("ntail", width, tiles, "span" if tiles == 1 else "rows")


def _operand(t: torch.Tensor, what: str, dtype, shape) -> int:
    """Check a GEMM operand read by TMA (device, dtype, shape, K-contiguous
    rows at a pitch of whole 16-byte steps, a 16-byte aligned start) and
    return its pitch in elements."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {t.dtype} {tuple(t.shape)}, expected "
                         f"{dtype} {tuple(shape)}")
    ld = t.stride(0) if t.shape[0] > 1 else row_pitch(t.shape[1],
                                                      t.element_size())
    if (t.stride(1) != 1 or ld < t.shape[1]
            or (ld * t.element_size()) % 16 or t.data_ptr() % 16):
        raise ValueError(f"gemm kernel: {what} must have K-contiguous rows "
                         f"whole 16-byte steps apart from a 16-byte aligned "
                         f"start (ops/swin_block.py::row_pitch), got strides "
                         f"{t.stride()}")
    return ld


def gemm(name: str, a, d: Dense, mode: int, residual=None, sx=None,
         out_dtype=torch.bfloat16):
    """out (M, N) = epilogue(a @ d^T): ``a`` is bf16 (M, K) with a bf16
    out, f32 with an f32 out (the 3xTF32 instance, ``d.hi``/``d.lo`` from
    :func:`make_dense`), or int8 with per-row scale ``sx`` (then
    ``d.q8``/``d.sw`` are used) and an ``out_dtype`` (bf16 or f32) out and
    residual. ``a`` and the weights are read at their row pitch
    (:func:`_operand`): a producer writes rows whose bytes are not whole
    16-byte steps at :func:`row_pitch` (``_ln``, ``_quant``), and
    :func:`make_dense` pads such weights once. N % 8 != 0 takes the
    N-tail instances (:func:`gemm_tile_plan`). Counted under ``name`` and
    ``name/gemm_bf16``, ``gemm_s8_bf16``, ``gemm_s8_f32`` or
    ``gemm_f32_3xtf32``, with ``_ntail`` for N % 8 != 0."""
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
        lda = _operand(a, "a", torch.int8, (m, k))
        ldb = _operand(d.q8, "w8", torch.int8, (n, k))
    elif f32:
        lda = _operand(a, "a", torch.float32, (m, k))
        if d.hi is None or d.lo is None:
            raise ValueError("gemm kernel: an f32 weight needs its TF32 "
                             "halves (prepare it with make_dense)")
        ldb = _operand(d.hi, "w_hi", torch.float32, (n, k))
        if _operand(d.lo, "w_lo", torch.float32, (n, k)) != ldb:
            raise ValueError("gemm kernel: w_hi and w_lo differ in pitch")
    else:
        lda = _operand(a, "a", out_dtype, (m, k))
        ldb = _operand(d.wt, "w", out_dtype, (n, k))
    # the epilogue reads 16-byte vectors of the bias and residual rows
    # (the N tail: whole 16-byte words of its output and residual spans)
    for t, what in ((d.bias, "bias"), (residual, "residual")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"gemm kernel: {what} must be 16-byte aligned")
    tail = "" if n % 8 == 0 else "_ntail"
    if sx is not None:
        kb.launch(name, "gemm_s8", kb.ptr(a), kb.ptr(sx), kb.ptr(d.q8),
                  kb.ptr(d.sw), kb.ptr(d.bias), kb.ptr(residual),
                  kb.ptr(out), kb.ci(m), kb.ci(n), kb.ci(k), kb.ci(lda),
                  kb.ci(ldb), kb.ci(mode), kb.ci(f32), kb.stream(),
                  instance="gemm_s8_" + ("f32" if f32 else "bf16") + tail)
    elif f32:
        kb.launch(name, "gemm_f32_3xtf32", kb.ptr(a), kb.ptr(d.hi),
                  kb.ptr(d.lo), kb.ptr(d.bias), kb.ptr(residual),
                  kb.ptr(out), kb.ci(m), kb.ci(n), kb.ci(k), kb.ci(lda),
                  kb.ci(ldb), kb.ci(mode), kb.stream(),
                  instance="gemm_f32_3xtf32" + tail)
    else:
        kb.launch(name, "gemm_bf16", kb.ptr(a), kb.ptr(d.wt),
                  kb.ptr(d.bias), kb.ptr(residual), kb.ptr(out), kb.ci(m),
                  kb.ci(n), kb.ci(k), kb.ci(lda), kb.ci(ldb), kb.ci(mode),
                  kb.stream(), instance="gemm_bf16" + tail)
    return out


# the window attention's limits (``csrc/window_attn.cuh``, every instance):
# up to 128 tokens a window in one pass over whole score rows, up to 256 in
# 64-key chunks with a running max and sum and the compact bias table in
# shared memory (``window_attn_long_kernel``: windows 12 to 16, head widths
# up to 64), up to 576 (window 24) with the keys and values streamed
# through shared memory in those chunks, in a ring of two buffers, by a
# persistent grid pulling 128-row query tiles of the windows' real tokens
# from a counter (wgmma in bf16 at staged widths 64 and 128:
# :data:`ATTN_STREAM_WGMMA`; ``window_attn_stream_kernel``,
# also for windows over 128 tokens at head widths over 64: the rows staged
# at :func:`attn_stream_dim`); head widths 16, 32 and 64 in the flagship
# sources (``swin_window_attn``, ``window_msa_attn``), the others of
# ATTN_HEAD_DIMS in ``csrc/attn_widths_*.cu`` and those of ATTN_WIDE_DIMS in
# ``csrc/attn_wide_*.cu``; one pass in bf16 at the flagship widths and those
# of ATTN_WIDE_DIMS: ``window_attn_ring_kernel``, a persistent grid walking
# (head, sample, window) items, one window buffer whose parts are refilled
# in turn (over 64 q read from device memory:
# :func:`attn_ring_q_in_registers`); otherwise, and in
# f32, ``window_attn_width_kernel``, the rows at the exact width; long
# windows staged at the next flagship width, its columns past the head zero
# (:func:`attn_staged_dim`); the streaming kernel in
# ``csrc/attn_stream_*.cu`` (``swin_window_attn_stream``,
# ``window_msa_attn_stream``). Every kernel
# reads the compact table (:func:`rel_offsets`), so ``rel`` must be a
# relative-position bias, as :func:`rel_bias_from_table` builds it. Head
# widths 136 to 256 take the streaming kernel at every window (staged at
# 256, one q buffer and one k / v stage: ``stream_single``), windows up to
# 32 (1024 tokens) too; a head width that is no multiple of 8 runs on the
# instance of the next multiple of 8, its heads' q, k and v columns and the
# projection's rows zero-padded (:func:`padded_heads`), at the true width's
# scale.
ATTN_HEAD_DIMS = (8, 16, 24, 32, 40, 48, 56, 64)
ATTN_WIDE_DIMS = (72, 80, 88, 96, 104, 112, 120, 128)
ATTN_FLAGSHIP_DIMS = (16, 32, 64)
ATTN_MAX_HEAD_DIM = 256
ATTN_ONE_PASS_TOKENS = 128
ATTN_LONG_TOKENS = 256
ATTN_MAX_TOKENS = 1024
ATTN_STREAM_WARPS = 8  # ``ATT_STREAM_WARPS``: 16 query rows each a tile
ATTN_QUERY_TILE = 16 * ATTN_STREAM_WARPS  # query rows an item
ATTN_KEY_CHUNK = 64    # ``16 ATT_KCH``: keys a chunk
ATTN_STREAM_STAGES = 2  # ``ATT_STREAM_STAGES``: k and v chunk buffers
ATTN_STREAM_SLOTS = 2   # ``ATT_STREAM_SLOTS``: item slots
# ``ATT_STREAM_WGMMA``: the bf16 streaming instances at staged widths 64 and
# 128 take wgmma, their rows unpadded in its 128-byte swizzle
ATTN_STREAM_WGMMA = True
# the head-width instances' blocks an SM: bf16 at 7 warps (windows of
# 97-112 tokens), bf16 at 8 warps, f32 (``csrc/window_attn.cuh``:
# ATT_WIDTH_BLOCKS_BF16_NPT7, ATT_WIDTH_BLOCKS_BF16_NPT8, ATT_WIDTH_BLOCKS_F32);
# at head widths over 64 (f32 only: bf16 runs the ring kernel there),
# ATT_WIDTH_BLOCKS_WIDE_F32
ATTN_WIDTH_BLOCKS = (4, 3, 2)
ATTN_WIDE_F32_BLOCKS = 1
# the bf16 ring kernel (the flagship widths and those over 64): token and
# label slots a block (``ATT_RING_SLOTS``) and the blocks an SM it is built
# for (``ATT_RING_BLOCKS``)
ATTN_RING_SLOTS = 3
ATTN_RING_BLOCKS = 2


def attn_staged_dim(hd: int) -> int:
    """The width a head of ``hd`` channels is staged at: the least of
    :data:`ATTN_FLAGSHIP_DIMS` that holds it."""
    return next(d for d in ATTN_FLAGSHIP_DIMS if d >= hd)


def attn_width_ld(hd: int, f32: bool) -> int:
    """Row stride (values) of the head-width kernel's staged rows
    (``width_ld``): f32 hd + 4; bf16 an odd number of 16-byte words (hd
    where hd / 8 is odd, else hd + 8), so an ldmatrix's 8 rows fall in 8
    distinct bank groups."""
    if f32:
        return hd + 4
    return hd if (hd // 8) % 2 else hd + 8


def attn_stream_dim(hd: int) -> int:
    """The width the streaming kernel stages a head of ``hd`` channels at
    (``stream_dim``): 16, 32, 64, 128 or 256."""
    return next(d for d in (16, 32, 64, 128, 256) if d >= hd)


def attn_kernel_dim(hd: int) -> int:
    """The head width the attention kernels run a head of ``hd`` channels
    at: ``hd`` rounded up to a multiple of 8 (:func:`padded_heads`)."""
    return -(-hd // 8) * 8


def attn_route(win: int, hd: int) -> str:
    """The kernel a window attention of ``win`` x ``win`` windows at head
    width ``hd`` runs (``launch_window_attn_hd``): ``one_pass`` (up to
    :data:`ATTN_ONE_PASS_TOKENS` tokens, the flagship or the head-width
    kernel), ``long`` (up to :data:`ATTN_LONG_TOKENS` at head widths up to
    64) or ``stream`` (every window at head widths over 128)."""
    pad = -(-win * win // 16) * 16
    if (pad > ATTN_LONG_TOKENS or hd > 128
            or (hd > 64 and pad > ATTN_ONE_PASS_TOKENS)):
        return "stream"
    return "long" if pad > ATTN_ONE_PASS_TOKENS else "one_pass"


def attn_width_blocks(f32: bool, win: int, hd: int = 8) -> int:
    """Blocks an SM the head-width instance of ``win`` x ``win`` windows
    at head width ``hd`` is built for (``width_blocks``, its launch
    bounds): the window-10 instance (7 warps) and the 8-warp one differ in
    bf16; head widths over 64 have one f32 instance of 8 warps."""
    if hd > 64:
        return ATTN_WIDE_F32_BLOCKS
    if f32:
        return ATTN_WIDTH_BLOCKS[2]
    return ATTN_WIDTH_BLOCKS[0 if -(-win * win // 16) == 7 else 1]


def attn_width_steps(hd: int) -> List[Tuple[int, int]]:
    """The bf16 q k^T k-steps of the head-width kernel, (first channel,
    width): ``hd // 16`` m16n8k16 steps, then one m16n8k8 step where hd %
    16 == 8."""
    return [(16 * i, 16) for i in range(hd // 16)] + (
        [(hd - 8, 8)] if hd % 16 else [])


def attn_width_chunks(hd: int) -> List[Tuple[int, int]]:
    """The f32 q k^T chunks of the head-width kernel, (first channel,
    width): chunks of 32 channels, then one of 16 and one of 8 where the
    rest holds them; a lane holds width / 4 contiguous channels of each."""
    sizes = [32] * (hd // 32) + [16] * (hd % 32 // 16) + [8] * (hd % 16 // 8)
    return [(sum(sizes[:i]), kc) for i, kc in enumerate(sizes)]


def attn_refusal(what: str, c: int, heads: int, win: int) -> Optional[str]:
    """Why the window attention kernel (of kernel ``what``) does not take C
    channels over ``heads`` heads in ``win`` x ``win`` windows, or None
    where it does: a head width from 1 to :data:`ATTN_MAX_HEAD_DIM` (one
    that is no multiple of 8 zero-padded to the next, :func:`padded_heads`)
    and at most :data:`ATTN_MAX_TOKENS` tokens a window (window 32)."""
    if (heads < 1 or c < 1 or c % heads
            or not 1 <= c // heads <= ATTN_MAX_HEAD_DIM or win < 1
            or win * win > ATTN_MAX_TOKENS):
        return (f"{what} kernel: bad shape, C={c} over {heads} heads in "
                f"windows of {win}x{win}: the attention takes head widths "
                f"from 1 to {ATTN_MAX_HEAD_DIM} and at most "
                f"{ATTN_MAX_TOKENS} tokens a window")
    return None


def attn_instance(f32: bool, win: int, hd: int = 32) -> str:
    """The instance a window attention launch at head width ``hd`` counts
    under: ``attn_bf16`` or ``attn_f32``, with ``_long`` or ``_stream`` for
    windows the long-window or the streaming kernel takes
    (:func:`attn_route`), ``_hd<w>`` for a kernel width w
    (:func:`attn_kernel_dim`) outside :data:`ATTN_FLAGSHIP_DIMS`, and
    ``_padded`` where ``hd`` is no multiple of 8."""
    w = attn_kernel_dim(hd)
    route = attn_route(win, w)
    return ("attn_f32" if f32 else "attn_bf16") + (
        "" if route == "one_pass" else "_" + route) + (
        "" if w in ATTN_FLAGSHIP_DIMS else f"_hd{w}") + (
        "_padded" if w != hd else "")


def padded_columns(c: int, heads: int, hdp: int,
                   device=None) -> torch.Tensor:
    """(C,) int64: the padded column of each true column j of C over
    ``heads`` heads, head j // hd's column j % hd in a head of width
    ``hdp`` (the kernels' padded heads here and in the decoder stack)."""
    hd = c // heads
    j = torch.arange(c, device=device)
    return (j // hd) * hdp + j % hd


def padded_qkv(qkv: torch.Tensor, qkv_bias: torch.Tensor, heads: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(qkv, bias, columns) at the kernels' head width: each head's q, k
    and v columns of an (N, 3C) qkv activation and of its bias zero-padded
    to :func:`attn_kernel_dim` (the layout :func:`padded_heads` gives the
    weights), and the padded attention output's columns that hold the
    true ones; the inputs as they are where the width is a multiple of
    8."""
    c = qkv.shape[1] // 3
    hd = c // heads
    w = attn_kernel_dim(hd)
    cols = padded_columns(c, heads, w, qkv.device)
    if w == hd:
        return qkv, qkv_bias, cols
    rows = torch.cat([cols + part * heads * w for part in range(3)])
    qp = qkv.new_zeros(qkv.shape[0], 3 * heads * w)
    qp[:, rows] = qkv
    bp = qkv_bias.new_zeros(3 * heads * w)
    bp[rows] = qkv_bias
    return qp, bp, cols


def padded_heads(qkv: Dense, proj: Dense, heads: int
                 ) -> Tuple[Dense, Dense]:
    """The qkv and projection layers of C channels over ``heads`` heads at
    the kernels' head width (:func:`attn_kernel_dim`): each head's q, k and
    v output columns of qkv at the padded width (zero rows of the (3C', C)
    weight and zero bias between), the projection's input rows alike (its
    (C, C') weight zero on the padded columns). The padded q, k and v
    columns are exact zeros, so every score, softmax and output column of
    the true widths is unchanged (the kernel takes the true width's scale);
    int8 layers are quantised again (a zero row's scale is the floor, its
    values 0; a row's absolute maximum is its true part's). Layers whose
    width is a multiple of 8 are returned as they are."""
    c = proj.wt.shape[0]
    hd = c // heads
    w = attn_kernel_dim(hd)
    if w == hd:
        return qkv, proj
    cp = heads * w
    col = padded_columns(c, heads, w, qkv.wt.device)
    rows = torch.cat([col + part * cp for part in range(3)])
    quant = qkv.q8 is not None
    wq = qkv.wt.new_zeros(3 * cp, qkv.wt.shape[1])
    wq[rows] = qkv.wt
    bq = qkv.bias.new_zeros(3 * cp)
    bq[rows] = qkv.bias
    wp = proj.wt.new_zeros(c, cp)
    wp[:, col] = proj.wt
    return make_dense(wq, bq, quant), make_dense(wp, proj.bias, quant)


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
    """Shared memory of one attention block (``csrc/window_attn.cuh``).
    The ring kernel (the flagship widths in bf16 up to
    :data:`ATTN_ONE_PASS_TOKENS` tokens, ``window_attn_ring_smem``): the
    q, k, v rows at stride :func:`attn_width_ld`, :data:`ATTN_RING_SLOTS`
    slots of token and label rows, the column offsets, the compact (2w-1)²
    f32 table (16-byte padded) and the bias expanded to n rows at stride
    n_pad + 8 (bf16 in the Swin variant, f32 in the MSA variant). The
    head-width kernel (every other width, and the flagship widths in f32,
    ``window_attn_width_smem``): its rows at stride :func:`attn_width_ld`
    (bf16 q, k, v or f32 k, v), the token, label and column-offset rows,
    the compact table. Above: the long-window kernel
    (``window_attn_long_smem``: q, k, v rows (bf16, stride hs + 8) or k, v
    rows (f32, stride hs + 4) at :func:`attn_staged_dim`, the three rows,
    the table) and the streaming kernel (two tiles' q rows (bf16,
    :data:`ATTN_QUERY_TILE` each) and :data:`ATTN_STREAM_STAGES` chunks
    of k and v rows (64 each) at :func:`attn_stream_dim` (+ 8 bf16, + 4
    f32; unpadded where :data:`ATTN_STREAM_WGMMA` takes the instance, with
    1024 bytes to align them; at 256 one q tile and one chunk), the column
    offsets,
    :data:`ATTN_STREAM_SLOTS` slots of token, label and query rows and a
    table, 16 bytes for the pulled items);
    ``msa`` changes only the ring kernel's, which stages no q rows where
    :func:`attn_ring_q_in_registers` (but a zero row and the q bias row,
    bf16)."""
    n = win * win
    n_pad = -(-n // 16) * 16
    table = 16 * -(-(2 * win - 1) ** 2 // 4)
    route = attn_route(win, hd)
    if route == "stream":
        hs = attn_stream_dim(hd)
        wg = ATTN_STREAM_WGMMA and not f32 and 64 <= hs <= 128
        one = hs > 128  # ``stream_single``: one q buffer, one k / v stage
        ld, esz = (hs + 4, 4) if f32 else (hs if wg else hs + 8, 2)
        q = 0 if f32 else (1 if one else 2) * ATTN_QUERY_TILE * ld * esz
        stages = 1 if one else ATTN_STREAM_STAGES
        return (q + stages * 2 * ATTN_KEY_CHUNK * ld * esz
                + 4 * n_pad + ATTN_STREAM_SLOTS * (12 * n_pad + table) + 16
                + (1024 if wg else 0))
    if route == "long":
        hs = attn_staged_dim(hd)
        rows = 2 * n_pad * (hs + 4) * 4 if f32 else 3 * n_pad * (hs + 8) * 2
        return rows + 12 * n_pad + table
    ld = attn_width_ld(hd, f32)
    if attn_ring(f32, hd):
        qreg = attn_ring_q_in_registers(hd)
        return ((2 if qreg else 3) * n_pad * ld * 2
                + ATTN_RING_SLOTS * 8 * n_pad + 4 * n_pad + table
                + n * (n_pad + 8) * (4 if msa else 2)
                + (4 * hd if qreg else 0))
    rows = 2 * n_pad * ld * 4 if f32 else 3 * n_pad * ld * 2
    return rows + 12 * n_pad + table


def attn_ring(f32: bool, hd: int) -> bool:
    """Whether a one-pass window attention at head width ``hd`` runs the
    ring kernel (bf16 at the flagship widths and those over 64) rather than
    the head-width kernel."""
    return not f32 and (hd in ATTN_FLAGSHIP_DIMS or hd > 64)


def attn_ring_q_in_registers(hd: int) -> bool:
    """Whether the bf16 ring kernel at head width ``hd`` reads q's
    fragments from device memory rather than staging q's rows
    (``ring_q_in_registers``): over 64."""
    return hd > 64


def attn_blocks(f32: bool, win: int, hd: int) -> int:
    """Blocks an SM the one-pass instance of ``win`` x ``win`` windows at
    head width ``hd`` is built for (its launch bounds): the ring kernel's
    :data:`ATTN_RING_BLOCKS` (:func:`attn_ring`; ``ring_blocks``: one for
    its 8-warp instances, every window but 10, that read q from device
    memory), else the head-width kernel's :func:`attn_width_blocks`."""
    if attn_ring(f32, hd):
        eight = -(-win * win // 16) != 7
        return (1 if eight and attn_ring_q_in_registers(hd)
                else ATTN_RING_BLOCKS)
    return attn_width_blocks(f32, win, hd)


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
                           heads: int, win: int, shift: int, msa: bool,
                           hd: Optional[int] = None) -> torch.Tensor:
    """Plain version of the attention launch: (B*H*W, 3C) qkv -> (B*H*W,
    C) on :func:`qkv_windows`. The Swin variant scales q before the
    product and rounds it, the MSA variant scales the f32 score; rel plus
    the shift mask summed first; f32 softmax rounded to the dtype; f32
    ``p v``. ``hd``: the heads' true width where ``qkv`` holds them padded
    (the scale's; default C / heads)."""
    c = qkv.shape[1] // 3
    n = win * win
    hd = c // heads if hd is None else hd
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
              win: int, shift: int, msa: bool,
              hd: Optional[int] = None) -> torch.Tensor:
    """The window attention launch (``csrc/window_attn.cuh``) of kernel 3
    (``msa=False``) or kernel 7 (``msa=True``): (B*H*W, 3C) qkv of bf16 or
    f32 -> (B*H*W, C) of the same dtype; windows, padding and the shift
    are its index math. ``rel`` (heads, n, n) f32 is the relative-position
    bias (:func:`rel_bias_from_table`): on every route the kernel reads
    one entry a relative offset (:func:`rel_table_tokens`) into its compact
    table. ``hd``: the heads' true width where ``qkv`` holds them padded to
    :func:`attn_kernel_dim` (:func:`padded_heads`; its scale is the true
    width's); default C / heads. Counted under ``name`` and ``name/``
    :func:`attn_instance`; the plain version for CPU tensors."""
    if not qkv.is_cuda:
        return window_attention_plain(qkv, qkv_bias, rel, b, hw, heads, win,
                                      shift, msa, hd)
    c = qkv.shape[1] // 3
    f32 = _f32(qkv)
    kd = c // heads
    hd = kd if hd is None else hd
    check_attn_shape(name, heads * hd, heads, win)
    if c % heads or kd != attn_kernel_dim(hd):
        raise ValueError(f"{name} attention kernel: qkv holds heads of "
                         f"{kd} columns; a head of {hd} runs at "
                         f"{attn_kernel_dim(hd)}")
    kb.check_cuda(qkv, "qkv", qkv.dtype, (b * hw[0] * hw[1], 3 * c))
    kb.check_cuda(qkv_bias, "qkv_bias", torch.float32, (3 * c,))
    kb.check_cuda(rel, "rel", torch.float32, (heads, win * win, win * win))
    # rows arrive in 16-byte copies
    if qkv.data_ptr() % 16 or qkv_bias.data_ptr() % 16 or c % 8:
        raise ValueError(f"{name} attention kernel: qkv and its bias must "
                         f"be 16-byte aligned and C a multiple of 8")
    o = torch.empty((qkv.shape[0], c), dtype=qkv.dtype, device=qkv.device)
    fn = "window_msa_attn" if msa else "swin_window_attn"
    scratch = ()
    if attn_route(win, kd) == "stream":
        fn += "_stream"
        # the item counter, zeroed by the launch on the stream (the name
        # keeps the tensor alive through the launch)
        counter = torch.empty(1, dtype=torch.int32, device=qkv.device)
        scratch = (kb.ptr(counter),)
    elif kd in ATTN_WIDE_DIMS:
        fn += "_wide"
    elif kd not in ATTN_FLAGSHIP_DIMS:
        fn += "_widths"
    kb.launch(name, fn, kb.ptr(qkv), kb.ptr(qkv_bias), kb.ptr(rel),
              kb.ptr(o), *scratch, kb.ci(b), kb.ci(hw[0]), kb.ci(hw[1]),
              kb.ci(c), kb.ci(heads), kb.ci(win), kb.ci(shift),
              kb.cf(hd ** -0.5), kb.ci(f32), kb.stream(),
              instance=attn_instance(f32, win, hd))
    return o


def window_attention(qkv: torch.Tensor, p: BlockWeights, b: int,
                     hw: Tuple[int, int], heads: int, win: int, shift: int,
                     hd: Optional[int] = None) -> torch.Tensor:
    """The Swin chain's attention (one launch, counted under
    ``swin_block``): (B*H*W, 3C) qkv -> (B*H*W, C) of the same dtype (at
    the heads' true width ``hd``, :func:`attention`)."""
    return attention("swin_block", qkv, p.qkv.bias, p.rel_bias, b, hw,
                     heads, win, shift, msa=False, hd=hd)


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
    hd = c // heads
    qkv_d, proj_d = ((p.qkv_k, p.proj_k) if p.qkv_k is not None
                     else padded_heads(p.qkv, p.proj, heads))
    p = p._replace(qkv=qkv_d, proj=proj_d)
    x2 = x.reshape(b * l, c)
    dt = x.dtype
    mode_d = EPI_BIAS if quant else EPI_BIAS | EPI_ROUND_ACC
    if quant:
        q8, sx = _ln(x2, p.ln1_w, p.ln1_b, True)
        qkv = gemm("swin_block", q8, p.qkv, mode_d, sx=sx, out_dtype=dt)
    else:
        qkv = gemm("swin_block", _ln(x2, p.ln1_w, p.ln1_b, False), p.qkv,
                   mode_d)
    o = window_attention(qkv, p, b, hw, heads, win, shift, hd)
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
