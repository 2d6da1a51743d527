"""Kernel 7: window multi-head self-attention.

Replaces ``mask_bev_tpu/ops/pallas_window_msa.py::fused_window_msa``, which
the JAX package's unfused eval ``ShiftWindowMSA`` reaches with
``use_pallas_attention`` when the block is not int8
(``mask_bev_tpu/models/swin.py:222-240``). On (B, nW, n, C) windows
already padded, rolled and partitioned (``ops/swin_block.py::
partition_windows``) the TPU kernel computes:

* ``qkv = x . Wqkv`` with f32 accumulation, the bias added in f32, rounded
  to the activation dtype D;
* per head, f32 scores ``q k^T`` scaled after the product, plus the
  relative-position bias and, shifted, the -100 region mask (both f32,
  summed before they are added), f32 softmax rounded to D, ``p v`` in f32;
* the heads' outputs rounded to D, then ``o . Wproj`` with f32
  accumulation and f32 bias, rounded to D.

:func:`window_msa_plain` is that function on partitioned windows (the
counterpart the CPU tests hold against the TPU kernel);
:func:`window_msa_grid_plain` wraps it in the partition and the merge, so
it takes the block's (B, H*W, C) tokens as :func:`window_msa` does.

The CUDA chain (``csrc/window_msa.cu``) works on the (B, H*W, C) tokens:
qkv GEMM on the B*H*W real rows (``csrc/gemm.cuh``, f32 bias epilogue) ->
attention (``csrc/window_attn.cuh``, its MSA variant), whose index math
does the padding, the cyclic shift and the window partition, pad tokens
taking the qkv bias -> proj GEMM. No padded, rolled or partitioned copy of
the grid is made. Its three launches count under ``window_msa``; bf16
tokens take the bf16 instances, f32 tokens the f32 ones (the 3xTF32 GEMM
and attention: nothing rounded below f32 outside the 3xTF32 split).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from mask_bev_tpu_torch.ops.swin_block import (
    EPI_BIAS, Dense, attention, attn_kernel_dim, attn_refusal, gemm,
    merge_windows, partition_windows, pitched, shift_mask)


def _project(x: torch.Tensor, d: Dense) -> torch.Tensor:
    """``x . W + b`` with f32 accumulation and f32 bias, rounded to D."""
    return (x.float() @ d.wt.float().t() + d.bias.float()).to(x.dtype)


def window_msa_plain(xw: torch.Tensor, rel: torch.Tensor,
                     mask: Optional[torch.Tensor], qkv: Dense, proj: Dense,
                     heads: int) -> torch.Tensor:
    """Plain PyTorch version: (B, nW, n, C) windows -> (B, nW, n, C)."""
    b, nw, n, c = xw.shape
    hd = c // heads
    t = _project(xw.reshape(b * nw * n, c), qkv)
    t = t.reshape(b, nw, n, 3, heads, hd).permute(3, 0, 1, 4, 2, 5)
    q, k, v = t[0].float(), t[1].float(), t[2].float()  # (B, nW, h, n, hd)
    bias = rel.float()[None]
    if mask is not None:
        bias = bias + mask.float()[:, None]
    s = (q @ k.transpose(-1, -2)) * hd ** -0.5 + bias
    p = torch.softmax(s, dim=-1).to(xw.dtype)
    o = (p.float() @ v).to(xw.dtype)  # (B, nW, h, n, hd)
    o = o.permute(0, 1, 3, 2, 4).reshape(b * nw * n, c)
    return _project(o, proj).reshape(b, nw, n, c)


def window_msa_grid_plain(y: torch.Tensor, hw: Tuple[int, int], win: int,
                          shift: int, rel: torch.Tensor, qkv: Dense,
                          proj: Dense, heads: int) -> torch.Tensor:
    """Plain PyTorch version on the block's tokens: (B, H*W, C) -> (B,
    H*W, C) through :func:`partition_windows`, :func:`window_msa_plain`
    and :func:`merge_windows`."""
    xw = window_msa_plain(partition_windows(y, hw, win, shift), rel,
                          shift_mask(hw, win, shift, y.device), qkv, proj,
                          heads)
    return merge_windows(xw, hw, win, shift)


def window_msa_refusal(c: int, heads: int, win: int,
                       dtype) -> Optional[str]:
    """Why kernel 7 does not take C channels over ``heads`` heads in
    ``win`` x ``win`` windows on tokens of ``dtype``, or None where it
    does: bf16 or f32 and :func:`~mask_bev_tpu_torch.ops.swin_block.
    attn_refusal` (a head width that is no multiple of 8 runs padded,
    :func:`~mask_bev_tpu_torch.ops.swin_block.padded_heads`)."""
    if dtype not in (torch.bfloat16, torch.float32):
        return f"the window MSA kernels take bf16 or f32 tokens; got {dtype}"
    return attn_refusal("window MSA", c, heads, win)


def window_msa(y: torch.Tensor, hw: Tuple[int, int], win: int, shift: int,
               rel: torch.Tensor, qkv: Dense, proj: Dense, heads: int,
               padded: Optional[Tuple[Dense, Dense]] = None
               ) -> torch.Tensor:
    """Window MSA of an unfused Swin block on its LN1 output ``y`` (B,
    H*W, C): the CUDA chain for CUDA tensors (its bf16 or f32 instance),
    the plain version for CPU tensors. ``rel`` (h, n, n) f32, ``shift``
    the cyclic shift (0 unshifted), ``qkv``/``proj`` with (N, K) weights
    and f32 biases. ``padded``: where the head width is no multiple of 8,
    the layers the kernels run, ``padded_heads(qkv, proj, heads)``, made
    once by the caller with its weights (the CUDA chain raises without
    them)."""
    if not y.is_cuda:
        return window_msa_grid_plain(y, hw, win, shift, rel, qkv, proj,
                                     heads)
    b, l, c = y.shape
    reason = window_msa_refusal(c, heads, win, y.dtype)
    if reason:
        raise ValueError(reason)
    if l != hw[0] * hw[1]:
        raise ValueError(f"window MSA kernel: {l} tokens for a grid {hw}")
    # (rows whose bytes are no whole 16-byte steps: at the GEMM's pitch)
    y2 = pitched(y.contiguous().reshape(b * l, c))
    if attn_kernel_dim(c // heads) != c // heads:
        if padded is None:
            raise ValueError(
                f"window MSA kernel: head width {c // heads} runs on the "
                "layers padded_heads(qkv, proj, heads) gives; pass them as "
                "padded=")
        qkv, proj = padded
    t = gemm("window_msa", y2, qkv, EPI_BIAS)
    o = attention("window_msa", t, qkv.bias, rel, b, hw, heads, win, shift,
                  msa=True, hd=c // heads)
    return gemm("window_msa", o, proj, EPI_BIAS).reshape(b, l, c)
