"""Kernel 9: token LayerNorm over the last axis.

Replaces ``mask_bev_tpu/ops/pallas_layer_norm.py::fused_layer_norm``, the
opt-in kernel of the backbone's ``patch_norm`` and ``out_norm{i}`` on the
fused eval path (``mask_bev_tpu/models/swin.py:516-527``). The function is
flax ``nn.LayerNorm``'s: f32 statistics in the fast-variance form
``var = max(0, E[x^2] - E[x]^2)``, eps 1e-6, ``(x - mean) * (rsqrt(var +
eps) * scale) + bias`` in f32, output in the input dtype.

Output dtype: the TPU kernel returns the input dtype. flax promotes to the
result type of the input and the parameters, which is the input dtype
whenever the parameters are in the model dtype, as they are in both
packages' bf16 and f32 runs; the port returns the input dtype.

The CUDA kernel (``csrc/layer_norm.cu``) takes bf16 or f32 tokens and a
scale and bias of the same dtype (widened to f32 in the kernel); it counts
under ``layer_norm``. A group of G lanes takes a token and R tokens at a
step, each lane W 8-channel words of each (:func:`plan`), every load of a
step issued before its reductions, on a grid sized to the SMs. Rows of
2048 < C <= 4096 in whole words take its wide instance
(``token_layernorm_wide_kernel``, plan ``(32 S, W, 1)``: S =
:data:`WIDE_WARPS` warps a token, each lane holding W words of the row in
registers, the row read once; counted under ``layer_norm/bf16_wide`` or
``layer_norm/f32_wide``). Rows of any other width (C % 8 != 0 or C > 4096)
take its walk instance (``token_layernorm_walk_kernel``, plan ``(G, 0,
1)``): the same arithmetic over the row in 8-value words, the last one
partial, two passes over it; it counts under ``layer_norm/bf16_walk`` or
``layer_norm/f32_walk``. The wide instance sums in the walk's order, so
both give the same bits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from mask_bev_tpu_torch.kernels import build as kb

MAX_WORDS = 8  # 8-channel words a lane (``LN_MAX_WORDS``): C <= 2048
WIDE_C = 4096  # the wide instance's widest row (``LN_WIDE_C``)
# the wide instance's warps a token in bf16 and f32 (``LN_WIDE_WARPS``), a
# lane holding at most 16 / S words of the row
WIDE_WARPS = 4


def plan(c: int, f32: bool) -> Tuple[int, int, int]:
    """Kernel 9's split of a row of ``c`` channels into 8-channel words:
    (G lanes a token, a power of two up to 32; W words a lane; R tokens a
    group takes at a step). For c % 8 == 0 and 8 <= c <= 2048 (the register
    tiles): G is the largest power of two dividing the words (so every lane
    holds W of them), unless that leaves more than 8 a lane; then the fewest
    lanes that hold them all. R keeps about 12 16-byte vectors in flight a
    lane (a word is one in bf16, two in f32), at least two tokens while that
    holds (``csrc/layer_norm.cu::ln_tokens``). Path E's rows in bf16: 192 ->
    (8, 3, 4), 384 -> (16, 3, 4), 768 -> (32, 3, 4), 1536 -> (32, 6, 2); in
    f32 R = 2 at all four. For c % 8 == 0 and 2048 < c <= 4096 (the wide
    instance): (32 S, W, 1), S = :data:`WIDE_WARPS` warps a token, W the
    fewest words a lane that hold the row (2056 -> (128, 3, 1), 3072 ->
    (128, 3, 1), 4096 -> (128, 4, 1)). Any other
    c >= 1: the walk, (G, 0, 1) with G the fewest lanes, a power of two up
    to 32, that give each lane one of the ceil(c / 8) words (12 -> 2, 100
    -> 16, 4104 -> 32)."""
    if c % 8 == 0 and MAX_WORDS * 8 * 32 < c <= WIDE_C:
        g = 32 * WIDE_WARPS
        return g, -(-(c // 8) // g), 1
    if c % 8 or c > MAX_WORDS * 8 * 32:
        words = -(-c // 8)
        return min(32, 1 << (words - 1).bit_length()), 0, 1
    words = c // 8
    g = min(32, words & -words)
    if -(-words // g) > MAX_WORDS:
        g = min(32, 1 << (-(-words // MAX_WORDS) - 1).bit_length())
    w = -(-words // g)
    vecs = w * (2 if f32 else 1)
    r = 1 if vecs > 12 else max(2, 12 // vecs)
    return g, w, r


def instance_suffix(c: int) -> str:
    """The suffix of the instance a row of ``c`` values takes: ``""`` (the
    register tiles), ``"_wide"`` or ``"_walk"``."""
    if c % 8 == 0 and c <= MAX_WORDS * 8 * 32:
        return ""
    return "_wide" if c % 8 == 0 and c <= WIDE_C else "_walk"


def layer_norm_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """flax ``nn.LayerNorm``: f32 fast-variance statistics, clamped at 0,
    f32 affine, output in the input dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    mul = torch.rsqrt(var + eps) * w.float()
    return ((x32 - mean) * mul + b.float()).to(x.dtype)


def layer_norm_refusal(c: int, dtype) -> Optional[str]:
    """Why kernel 9 does not take rows of C values of ``dtype``, or None
    where it does: bf16 or f32 and C >= 1 (the register tiles up to 2048
    channels in whole words, the walk for every other width)."""
    if dtype not in (torch.bfloat16, torch.float32):
        return f"the layer norm kernel takes bf16 or f32 tokens; got {dtype}"
    if c < 1:
        return f"layer norm kernel needs C >= 1, got {c}"
    return None


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Token LayerNorm of (..., C): the CUDA kernel for CUDA tensors (its
    bf16 or f32 instance), the plain version for CPU tensors."""
    if not x.is_cuda:
        return layer_norm_plain(x, w, b, eps)
    dt = x.dtype
    c = x.shape[-1]
    reason = layer_norm_refusal(c, dt)
    if reason:
        raise ValueError(reason)
    x2 = x.contiguous().reshape(-1, c)
    kb.check_cuda(x2, "x", dt)
    kb.check_cuda(w, "scale", dt, (c,))
    kb.check_cuda(b, "bias", dt, (c,))
    out = torch.empty_like(x2)
    f32 = dt == torch.float32
    g, words, r = plan(c, f32)
    kb.launch("layer_norm", "token_layernorm", kb.ptr(x2), kb.ptr(w),
              kb.ptr(b), kb.ptr(out), kb.ci(x2.shape[0]), kb.ci(c), kb.ci(g),
              kb.ci(words), kb.ci(r), kb.cf(eps), kb.ci(f32), kb.stream(),
              instance=("f32" if f32 else "bf16") + instance_suffix(c))
    return out.reshape(x.shape)
