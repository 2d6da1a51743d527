"""Kernel 7: window multi-head self-attention on partitioned windows.

Replaces ``mask_bev_tpu/ops/pallas_window_msa.py::fused_window_msa``, which
the JAX package's unfused eval ``ShiftWindowMSA`` reaches with
``use_pallas_attention`` when the block is not int8
(``mask_bev_tpu/models/swin.py:222-240``). On (B, nW, n, C) windows
already padded, rolled and partitioned (``ops/swin_block.py::
partition_windows``) it computes the TPU kernel's function:

* ``qkv = x . Wqkv`` with f32 accumulation, the bias added in f32, rounded
  to the activation dtype D;
* per head, f32 scores ``q k^T`` scaled after the product, plus the
  relative-position bias and, shifted, the -100 region mask (both f32,
  summed before they are added), f32 softmax rounded to D, ``p v`` in f32;
* the heads' outputs rounded to D, then ``o . Wproj`` with f32
  accumulation and f32 bias, rounded to D.

The TPU kernel reads one (nW, h, n, n) bias; this port reads the (h, n, n)
relative-position bias and the (nW, n, n) shift mask and adds them per
score, so nothing of size nW x h x n x n is built.

The CUDA chain (``csrc/window_msa.cu``): qkv GEMM (``csrc/gemm.cuh``, f32
bias epilogue) -> attention, one block per (window, head, sample) -> proj
GEMM; its three launches count under ``window_msa``. bf16 windows take the
tensor-core instance, f32 windows the f32 instance (f32 GEMMs and f32
attention, nothing rounded below f32).
"""
from __future__ import annotations

from typing import Optional

import torch

from mask_bev_tpu_torch.kernels import build as kb
from mask_bev_tpu_torch.ops.swin_block import EPI_BIAS, Dense, gemm


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


def window_msa(xw: torch.Tensor, rel: torch.Tensor,
               mask: Optional[torch.Tensor], qkv: Dense, proj: Dense,
               heads: int) -> torch.Tensor:
    """Window MSA on (B, nW, n, C): the CUDA chain for CUDA tensors (its
    bf16 or f32 instance), the plain version for CPU tensors. ``rel``
    (h, n, n) f32, ``mask`` (nW, n, n) f32 or None, ``qkv``/``proj`` with
    (N, K) weights and f32 biases."""
    if not xw.is_cuda:
        return window_msa_plain(xw, rel, mask, qkv, proj, heads)
    dt = xw.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the window MSA kernels take bf16 or f32 windows; "
                         f"got {dt}")
    f32 = dt == torch.float32
    b, nw, n, c = xw.shape
    hd, n_pad = c // heads, -(-n // 16) * 16
    if c % heads or n > 128 or (hd not in (16, 32, 64) if f32 else
                                (hd % 16 or n_pad > 2 * hd + 8)):
        raise ValueError(f"window MSA kernel: bad shape {tuple(xw.shape)} "
                         f"for {heads} heads")
    x2 = xw.contiguous().reshape(b * nw * n, c)
    kb.check_cuda(x2, "xw", dt)
    kb.check_cuda(rel, "rel", torch.float32, (heads, n, n))
    if mask is not None:
        kb.check_cuda(mask, "mask", torch.float32, (nw, n, n))
    t = gemm("window_msa", x2, qkv, EPI_BIAS)
    o = torch.empty((b * nw * n, c), dtype=dt, device=xw.device)
    kb.launch("window_msa", "window_msa_attn_f32" if f32
              else "window_msa_attn", kb.ptr(t), kb.ptr(rel),
              kb.ptr(mask), kb.ptr(o), kb.ci(b), kb.ci(nw), kb.ci(n),
              kb.ci(c), kb.ci(heads), kb.cf(hd ** -0.5), kb.stream(),
              instance="f32" if f32 else "bf16")
    return gemm("window_msa", o, proj, EPI_BIAS).reshape(b, nw, n, c)
