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

The CUDA kernel (``csrc/patch_embed.cuh``) is an implicit GEMM on wgmma fed
by TMA straight from the canvas, in 128-token tiles of ``plan``'s shape,
with the LayerNorm on its accumulators: bf16 products for a bf16 canvas,
3xTF32 for an f32 canvas (its f32 instance, with the weight's TF32 halves,
``split``); it counts under ``patch_embed``. Each width of
:data:`EMBED_DIMS` is an instance of its own; any other E from 1 to
:data:`MAX_EMBED` runs on the next one up (:func:`instance_width`), its
weight rows, bias and LN affine padded with zeros (:func:`padded_embed`:
a padded column's y is exactly 0, so it adds nothing to the fast-variance
sums), the statistics divided by the true E and only its columns stored.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from mask_bev_tpu_torch.kernels import build as kb
from mask_bev_tpu_torch.ops.swin_block import split_tf32


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


# csrc/patch_embed.cuh: a tile's token rows, the bytes of K a stage (one
# 128-byte swizzle row), a block's shared memory, the widths it takes
TILE = 128
STAGE_K_BYTES = 128
SMEM_LIMIT = 232448
# (each E its own wgmma m64nEk16 instruction and kernel instance: 48 the
# narrow backbones', 96 Swin-T's and Swin-S's); every other E up to
# MAX_EMBED is padded to the next (wgmma's N ends at 256, and the LN needs a
# token's columns in one warpgroup's accumulators)
EMBED_DIMS = (48, 64, 96, 128, 192, 256)
MAX_EMBED = 256


def instance_width(e: int) -> int:
    """The width of the instance that runs E: the narrowest of
    :data:`EMBED_DIMS` that holds it (``csrc/patch_embed.cuh::
    pe_instance_width``)."""
    return next(w for w in EMBED_DIMS if w >= e)


def padded_embed(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Tensors of E leading rows (the weight matrix, its halves, the bias
    and LN affine) at the instance width of E: zero rows appended (as they
    are where E has its own instance)."""
    e = ts[0].shape[0]
    ep = instance_width(e)
    if ep == e:
        return ts
    return tuple(torch.cat([t, t.new_zeros((ep - e,) + tuple(t.shape[1:]))])
                 for t in ts)


def tile_shape(gw: int, rows: int) -> Tuple[int, int]:
    """The kernel's token tile, ``tile_x`` tokens along gx times ``tile_y``
    token rows (b, gy) with ``tile_x * tile_y <= 128``: the shape that needs
    the fewest tiles for a (rows, gw) token grid (the larger ``tile_x`` on a
    tie). A tile never wraps past a row's end, so a grid whose gw is no
    multiple of ``tile_x`` pads its last tiles with rows that are computed
    and not stored."""
    best = None
    for tx in range(1, min(gw, TILE) + 1):
        ty = min(TILE // tx, rows)
        n = -(-gw // tx) * -(-rows // ty)
        if best is None or n < best[0] or (n == best[0] and tx > best[1]):
            best = (n, tx, ty)
    return best[1], best[2]


def plan(b: int, h: int, w: int, c: int, e: int, patch: int,
         f32: bool) -> Dict[str, float]:
    """The CUDA kernel's plan for a (b, h, w, c) canvas and width ``e``,
    as ``csrc/patch_embed.cuh`` computes it (at the instance width of
    ``e``): the tile shape, tile count and
    pairs (a cluster of two blocks takes a pair and reads the weight once
    for both), k-steps and ring stages, a block's shared memory, the share
    of tile rows that hold no token, and the weight bytes read from L2."""
    p = patch
    gh, gw = h // p, w // p
    rows = b * gh
    e = instance_width(e)
    esz = 4 if f32 else 2
    tx, ty = tile_shape(gw, rows)
    tiles_x = -(-gw // tx)
    tiles = tiles_x * -(-rows // ty)
    pairs = -(-tiles // 2)
    stage = TILE * STAGE_K_BYTES + (2 if f32 else 1) * e * STAGE_K_BYTES
    stages = min(6, (SMEM_LIMIT - 1024 - 256) // stage)
    k = p * p * c
    return dict(tile_x=tx, tile_y=ty, tiles_x=tiles_x, tiles=tiles,
                pairs=pairs, k_steps=k * esz // STAGE_K_BYTES, stages=stages,
                smem_bytes=stages * stage + 1024 + 16 * stages,
                wasted_rows=1.0 - rows * gw / (tiles * TILE),
                weight_l2_bytes=pairs * e * k * esz * (2 if f32 else 1))


def patch_embed_refusal(b: int, h: int, w: int, c: int, e: int,
                        patch: int, dtype) -> Optional[str]:
    """Why kernel 8 does not take a (B, H, W, C) canvas of ``dtype`` into E
    channels by ``patch`` x ``patch`` patches, or None where it does: bf16
    or f32, H and W whole multiples of the patch, whole 128-byte K slices
    (p C), E from 1 to :data:`MAX_EMBED`, and a ring of at least two stages
    in shared memory. The K slices cannot be missed by a model: the port
    (``models/maskbev.py::MaskBev.flat_embed_ok``), as the JAX package,
    fuses the patch embed only on the slot path, whose canvas is a
    multiple of 128 channels."""
    if dtype not in (torch.bfloat16, torch.float32):
        return (f"the patch embed kernel takes a bf16 or f32 canvas; got "
                f"{dtype}")
    f32 = dtype == torch.float32
    p = patch
    bk = STAGE_K_BYTES // (4 if f32 else 2)
    if h % p or w % p or h < p or w < p or b < 1:
        return (f"patch embed needs H, W whole multiples of {p}; got "
                f"{(h, w)}")
    if (p * c) % bk or not 1 <= e <= MAX_EMBED:
        return (f"patch embed kernel needs p*C % {bk} == 0 and E from 1 "
                f"to {MAX_EMBED}; got C={c}, p={p}, E={e}")
    pl = plan(b, h, w, c, e, p, f32)
    if pl["smem_bytes"] > SMEM_LIMIT or pl["stages"] < 2:
        return f"patch embed ring does not fit: {pl}"
    return None


def instance(f32: bool, e: int) -> str:
    """The instance name a launch at width E counts under: ``bf16`` or
    ``f32``, with ``_e<EP>`` where E runs padded on the instance of width
    EP."""
    ep = instance_width(e)
    return ("f32" if f32 else "bf16") + ("" if ep == e else f"_e{ep}")


def check_shape(b: int, h: int, w: int, c: int, e: int, patch: int,
                f32: bool) -> Dict[str, float]:
    """Raise ``ValueError`` with :func:`patch_embed_refusal`'s reason for a
    shape the CUDA kernel does not take; return its plan."""
    reason = patch_embed_refusal(b, h, w, c, e, patch,
                                 torch.float32 if f32 else torch.bfloat16)
    if reason:
        raise ValueError(reason)
    return plan(b, h, w, c, e, patch, f32)


def patch_embed(canvas: torch.Tensor, wm: torch.Tensor, bias: torch.Tensor,
                ln_w: torch.Tensor, ln_b: torch.Tensor, patch: int,
                eps: float = 1e-6,
                split: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """Patch embed + LN of a (B, H, W, C) canvas: the CUDA kernel for CUDA
    tensors (its bf16 or f32 instance), the plain version for CPU tensors.
    ``wm`` from :func:`embed_matrix`; H and W multiples of ``patch``.
    ``split``: ``wm``'s TF32 halves (hi, lo) for an f32 canvas on the card,
    as ``SwinTransformer.embed_weights`` makes them once; split here on
    each call where not given."""
    b, h, w, c = canvas.shape
    p = patch
    if h % p or w % p:
        raise ValueError(f"patch embed needs H, W multiples of {p}; got "
                         f"{(h, w)}")
    if not canvas.is_cuda:
        return patch_embed_plain(canvas, wm, bias, ln_w, ln_b, p, eps)
    dt = canvas.dtype
    e = wm.shape[0]
    reason = patch_embed_refusal(b, h, w, c, e, p, dt)
    if reason:
        raise ValueError(reason)
    f32 = dt == torch.float32
    pl = plan(b, h, w, c, e, p, f32)
    ep = instance_width(e)
    kb.check_cuda(canvas, "canvas", dt)
    kb.check_cuda(wm, "wm", dt, (e, p * p * c))
    hi = lo = None
    if f32:
        hi, lo = split if split is not None else split_tf32(wm)
        kb.check_cuda(hi, "wm hi", dt, (e, p * p * c))
        kb.check_cuda(lo, "wm lo", dt, (e, p * p * c))
        hi, lo = padded_embed(hi, lo)
    else:
        wm, = padded_embed(wm)
    vecs = [t.contiguous() for t in padded_embed(
        *(t.float() for t in (bias, ln_w, ln_b)))]
    for t, name in zip(vecs, ("bias", "ln_w", "ln_b")):
        kb.check_cuda(t, name, torch.float32, (ep,))
    gh, gw = h // p, w // p
    out = torch.empty((b, gh * gw, e), dtype=dt, device=canvas.device)
    kb.launch("patch_embed", "patch_embed_forward", kb.ptr(canvas),
              kb.ptr(hi if f32 else wm), kb.ptr(lo),
              *(kb.ptr(t) for t in vecs), kb.ptr(out), kb.ci(b), kb.ci(h),
              kb.ci(w), kb.ci(c), kb.ci(e), kb.ci(p), kb.ci(pl["tile_x"]),
              kb.ci(pl["tile_y"]), kb.cf(eps), kb.ci(f32), kb.stream(),
              instance=instance(f32, e))
    return out
