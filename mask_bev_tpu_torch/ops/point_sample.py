"""Bilinear point sampling and PointRend uncertainty sampling.

Port of ``mask_bev_tpu/ops/point_sample.py``: bilinear samples of (..., H,
W) images at normalised (x, y) points in [0, 1]² with ``align_corners=False``
and zero padding (``mmcv.ops.point_sample``), in a gather form
(:func:`point_sample`) and a dense matrix form built from hat weights
``max(0, 1 - |t - i|)`` (:func:`point_sample_dense`,
:func:`point_sample_dense_per`), whose values are the same. The dense form
takes its product operands in ``mm_dtype`` with f32 accumulation: with bf16
both the hat weights and the image are rounded to bf16 and their products
summed in f32 (a product of two bf16 values is exact in f32, so the f32
product of the rounded operands is that sum). The dense forms run in chunks
whose intermediates stay bounded, and each chunk is recomputed in the
backward pass (``torch.utils.checkpoint``, as ``jax.checkpoint`` there), so
the hat matrices are never kept for it.

:func:`uncertain_point_coords` is the importance sampling of the loss: draw
``num_points * oversample_ratio`` uniform points per mask, keep the
``importance_sample_ratio`` share whose sampled logit is closest to 0 (a
stable sort on |logit| carrying the coords, ties to the lower index), fill
the rest with fresh uniform points. The two uniform draws are arguments, or
are drawn from the caller's ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.utils.checkpoint


def _bilinear(img_at, h: int, w: int, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples at (..., P, 2) points; ``img_at(iy, ix)`` reads the
    image(s) at integer positions."""
    x = coords[..., 0] * w - 0.5
    y = coords[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0

    def gather(ix, iy):
        inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        vals = img_at(iy.clamp(0, h - 1).long(), ix.clamp(0, w - 1).long())
        return torch.where(inb, vals, 0.0)

    v00 = gather(x0, y0)
    v01 = gather(x0 + 1, y0)
    v10 = gather(x0, y0 + 1)
    v11 = gather(x0 + 1, y0 + 1)
    top = v00 * (1 - wx1) + v01 * wx1
    bot = v10 * (1 - wx1) + v11 * wx1
    return top * (1 - wy1) + bot * wy1


def point_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """(..., H, W) images at shared (P, 2) points -> (..., P), gather form."""
    h, w = img.shape[-2:]
    return _bilinear(lambda iy, ix: img[..., iy, ix], h, w, coords)


def point_sample_per(imgs: torch.Tensor, coords: torch.Tensor
                     ) -> torch.Tensor:
    """(N, H, W) images at per-image (N, P, 2) points -> (N, P), gather
    form (``jax.vmap(point_sample)``)."""
    n, h, w = imgs.shape
    rows = torch.arange(n, device=imgs.device)[:, None]
    return _bilinear(lambda iy, ix: imgs[rows, iy, ix], h, w, coords)


def hat_weights(t: torch.Tensor, n: int, dtype: torch.dtype
                ) -> torch.Tensor:
    """(..., P) continuous grid coords -> (..., P, n) bilinear hat weights
    ``max(0, 1 - |t - i|)``, rounded to ``dtype``."""
    idx = torch.arange(n, dtype=torch.float32, device=t.device)
    return torch.clamp(1.0 - (t[..., None] - idx).abs(), min=0.0).to(dtype)


# Each operand of an f32-accumulated product in ``mm_dtype`` is rounded to
# ``mm_dtype`` and held in f32.


def _dense_shared(imgs, pts, mm_dtype):
    h, w = imgs.shape[-2:]
    ry = hat_weights(pts[:, 1] * h - 0.5, h, mm_dtype).float()
    cx = hat_weights(pts[:, 0] * w - 0.5, w, mm_dtype).float()
    t = torch.einsum("ph,nhw->npw", ry, imgs.to(mm_dtype).float())
    return torch.einsum("npw,pw->np", t, cx)


def _dense_per(imgs, pts, mm_dtype):
    h, w = imgs.shape[-2:]
    ry = hat_weights(pts[..., 1] * h - 0.5, h, mm_dtype).float()
    cx = hat_weights(pts[..., 0] * w - 0.5, w, mm_dtype).float()
    t = torch.bmm(ry, imgs.to(mm_dtype).float())  # (n, P, W)
    return (t * cx).sum(-1)


def _call(fn, *args):
    """``fn(*args)``, recomputed in the backward pass when it is taken."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in args
                                       if torch.is_tensor(a)):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def point_sample_dense(imgs: torch.Tensor, coords: torch.Tensor,
                       mm_dtype: torch.dtype = torch.float32,
                       chunk: Optional[int] = None) -> torch.Tensor:
    """(N, H, W) images at shared (P, 2) points -> (N, P) f32, dense form;
    ``chunk`` points at a time (it must divide P, else one chunk)."""
    p = coords.shape[0]
    if not chunk or chunk >= p or p % chunk:
        chunk = p
    return torch.cat([_call(_dense_shared, imgs, coords[i:i + chunk],
                            mm_dtype) for i in range(0, p, chunk)], dim=1)


def point_sample_dense_per(imgs: torch.Tensor, coords: torch.Tensor,
                           mm_dtype: torch.dtype = torch.float32,
                           chunk: Optional[int] = None) -> torch.Tensor:
    """(N, H, W) images at per-image (N, P, 2) points -> (N, P) f32, dense
    form; ``chunk`` images at a time (it must divide N, else one chunk)."""
    n = imgs.shape[0]
    if not chunk or chunk >= n or n % chunk:
        chunk = n
    return torch.cat([_call(_dense_per, imgs[i:i + chunk],
                            coords[i:i + chunk], mm_dtype)
                      for i in range(0, n, chunk)], dim=0)


def uniform_draws(m: int, num_points: int, oversample_ratio: float,
                  importance_sample_ratio: float, generator=None,
                  device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """The two uniform draws of :func:`uncertain_point_coords`: (M,
    n_sampled, 2) candidates and (M, n_random, 2) fill points."""
    n_sampled = int(num_points * oversample_ratio)
    n_random = num_points - int(importance_sample_ratio * num_points)
    u1 = torch.rand((m, n_sampled, 2), generator=generator, device=device)
    u2 = torch.rand((m, n_random, 2), generator=generator, device=device)
    return u1, u2


def uncertain_point_coords(mask_logits: torch.Tensor, num_points: int,
                           oversample_ratio: float = 3.0,
                           importance_sample_ratio: float = 0.75,
                           dense: bool = False,
                           mm_dtype: torch.dtype = torch.float32,
                           chunk: Optional[int] = None, *,
                           draws=None, generator=None) -> torch.Tensor:
    """(M, H, W) mask logits -> (M, num_points, 2) coords in [0, 1]² (x,
    y), biased toward logits near 0. ``draws``: the two uniform draws of
    :func:`uniform_draws`; otherwise they come from ``generator``."""
    m = mask_logits.shape[0]
    n_uncertain = int(importance_sample_ratio * num_points)
    if draws is None:
        draws = uniform_draws(m, num_points, oversample_ratio,
                              importance_sample_ratio, generator,
                              mask_logits.device)
    coords, rand = draws
    with torch.no_grad():
        if dense:
            logits = point_sample_dense_per(mask_logits, coords,
                                            mm_dtype=mm_dtype, chunk=chunk)
        else:
            logits = point_sample_per(mask_logits, coords)
        order = torch.sort(logits.abs(), dim=-1, stable=True).indices
        picked = torch.gather(coords, 1, order[:, :n_uncertain, None]
                              .expand(m, n_uncertain, 2))
    if rand.shape[1] > 0:
        picked = torch.cat([picked, rand.to(picked.dtype)], dim=1)
    return picked
