"""Kernel 8: the stride-p patch-embed conv and its token LayerNorm.

Replaces ``mask_bev_tpu/ops/pallas_patch_embed.py::fused_patch_embed``. The
JAX kernel reads the canvas in a batch-minor flat (H*W, B*C) form, a TPU
layout; this one reads kernel 2's (B, H, W, C) canvas as it is. With
stride == patch and no padding the conv is one product per token:

    y[b, t] = patch(b, t) . Wm + bias          (f32 accumulation, f32 bias)
    out[b, t] = (y - E[y]) * rsqrt(var + eps) * scale + ln_bias

with ``patch(b, t)`` the p rows of p*C contiguous channels under token
``t = gy * gw + gx`` (row index ``dh * p * C + dw * C + c``, the order of
``Wm``), statistics in the fast-variance form ``var = max(0, E[y^2] -
E[y]^2)`` (eps 1e-6) and the LN affine in f32, rounded once to the canvas
dtype, as the TPU kernel computes it.

The CUDA kernel (``csrc/patch_embed.cu``) is an implicit GEMM that holds all
E outputs of its tokens and runs the LayerNorm in its epilogue, on the
tensor cores for a bf16 canvas, as f32 FMAs for an f32 canvas (its f32
instance); it counts under ``patch_embed``.
"""
from __future__ import annotations

import torch

from mask_bev_tpu_torch.kernels import build as kb


def embed_matrix(weight: torch.Tensor) -> torch.Tensor:
    """Conv weight (E, C, p, p) -> (E, p*p*C), K-contiguous rows in the
    (dh, dw, c) order of a token's canvas rows."""
    e = weight.shape[0]
    return weight.detach().permute(0, 2, 3, 1).reshape(e, -1).contiguous()


def patch_embed_plain(canvas: torch.Tensor, wm: torch.Tensor,
                      bias: torch.Tensor, ln_w: torch.Tensor,
                      ln_b: torch.Tensor, patch: int, eps: float = 1e-6
                      ) -> torch.Tensor:
    """Plain PyTorch version: (B, H, W, C) canvas -> (B, gh*gw, E)."""
    b, h, w, c = canvas.shape
    p = patch
    gh, gw = h // p, w // p
    t = (canvas.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
         .reshape(b * gh * gw, p * p * c))
    y = t.float() @ wm.float().t() + bias.float()
    mean = y.mean(dim=-1, keepdim=True)
    var = torch.clamp((y * y).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    out = (y - mean) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()
    return out.to(canvas.dtype).reshape(b, gh * gw, -1)


def patch_embed(canvas: torch.Tensor, wm: torch.Tensor, bias: torch.Tensor,
                ln_w: torch.Tensor, ln_b: torch.Tensor, patch: int,
                eps: float = 1e-6) -> torch.Tensor:
    """Patch embed + LN of a (B, H, W, C) canvas: the CUDA kernel for CUDA
    tensors (its bf16 or f32 instance), the plain version for CPU tensors.
    ``wm`` from :func:`embed_matrix`; H and W multiples of ``patch``."""
    b, h, w, c = canvas.shape
    p = patch
    if h % p or w % p:
        raise ValueError(f"patch embed needs H, W multiples of {p}; got "
                         f"{(h, w)}")
    if not canvas.is_cuda:
        return patch_embed_plain(canvas, wm, bias, ln_w, ln_b, p, eps)
    dt = canvas.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the patch embed kernel takes a bf16 or f32 "
                         f"canvas; got {dt}")
    f32 = dt == torch.float32
    e = wm.shape[0]
    if (c % 8 or (p * p * c) % 32 or (f32 and (p * c) % 16)
            or e not in (64, 128, 192, 256)):
        raise ValueError(f"patch embed kernel needs C % 8 == 0, p*p*C % 32 "
                         f"== 0 (f32: p*C % 16 == 0) and E in (64, 128, "
                         f"192, 256); got C={c}, p={p}, E={e}")
    kb.check_cuda(canvas, "canvas", dt)
    kb.check_cuda(wm, "wm", dt, (e, p * p * c))
    vecs = [t.float().contiguous() for t in (bias, ln_w, ln_b)]
    for t, name in zip(vecs, ("bias", "ln_w", "ln_b")):
        kb.check_cuda(t, name, torch.float32, (e,))
    gh, gw = h // p, w // p
    out = torch.empty((b, gh * gw, e), dtype=dt, device=canvas.device)
    kb.launch("patch_embed", "patch_embed_f32_forward" if f32
              else "patch_embed_forward", kb.ptr(canvas),
              kb.ptr(wm), *(kb.ptr(t) for t in vecs), kb.ptr(out), kb.ci(b),
              kb.ci(h), kb.ci(w), kb.ci(c), kb.ci(e), kb.ci(p), kb.cf(eps),
              kb.stream(), instance="f32" if f32 else "bf16")
    return out
