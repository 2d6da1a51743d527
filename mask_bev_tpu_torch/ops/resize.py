"""Bicubic resize as ``jax.image.resize(x, shape, "bicubic")`` computes it.

The JAX package resizes the Swin relative-position bias tables and the
absolute position embedding with ``jax.image.resize(..., "bicubic")``
(``mask_bev_tpu/models/swin.py:566``, ``models/convert.py:44, 94``). That
function is not ``F.interpolate(mode="bicubic")``:

* the Keys cubic kernel with a = -0.5 (torch's bicubic takes a = -0.75);
* half-pixel centres, sample points outside the input zeroed, and each
  output's weights divided by their sum;
* antialiasing when downscaling: the kernel is stretched by the inverse
  scale, so every input pixel under it contributes;
* one separable pass per resized axis, in axis order; axes whose size does
  not change are left as they are.

:func:`resize_bicubic` builds each axis's (in, out) weight matrix in f32 by
the same operations, casts it to the input's dtype and contracts it with
that axis. The kernel polynomial is rounded once per multiply-add
(:func:`_fma`), as XLA's CPU backend contracts it. Without it the cases
of ``tests/test_torch_port_reference_convert.py`` miss their 1e-6 of the
largest magnitude: with plain f32 products the 19 x 19 -> 13 x 13
downscale is 2.03e-6 from ``jax.image.resize`` at a largest magnitude of
1.93 (1.05e-6 of it); with the weights in float64 the 20 x 20 -> 32 x 24
upscale is 4.77e-6 at 3.88 (1.23e-6).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _fma(a: torch.Tensor, b: torch.Tensor, c: float) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, as XLA's CPU backend contracts
    the kernel's polynomial into fused multiply-adds (the product of two
    f32 values is exact in float64)."""
    return (a.double() * b.double() + c).float()


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel (a = -0.5) at f32 distances ``x >= 0``."""
    out = _fma((1.5 * x - 2.5) * x, x, 1.0)
    far = _fma(_fma(_fma(torch.full_like(x, -0.5), x, 2.5), x, -4.0), x,
               2.0)
    out = torch.where(x >= 1.0, far, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_weights(n_in: int, n_out: int, antialias: bool = True,
                  device=None) -> torch.Tensor:
    """(n_in, n_out) f32 weights of one axis resized from ``n_in`` to
    ``n_out`` samples."""
    f32 = torch.float32
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0)) if antialias else 1.0
    sample = ((torch.arange(n_out, dtype=f32, device=device) + 0.5)
              * float(inv_scale) - 0.5)
    x = (sample[None, :] - torch.arange(n_in, dtype=f32, device=device)[
        :, None]).abs() / float(kernel_scale)
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bicubic(x: torch.Tensor, shape: Sequence[int],
                   antialias: bool = True) -> torch.Tensor:
    """``x`` resized to ``shape`` (one entry per axis; an axis of the same
    size is not touched), in ``x``'s dtype; differentiable in ``x``."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"resize to {shape}: the input has {x.ndim} axes")
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = cubic_weights(n_in, n_out, antialias, x.device).to(x.dtype)
        x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x
