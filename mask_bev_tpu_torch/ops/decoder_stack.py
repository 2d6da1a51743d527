"""Kernel 4: all Mask2Former decoder layers of the ``final_only`` path.

Replaces ``mask_bev_tpu/ops/pallas_decoder_stack.py::fused_decoder_stack``.
Per batch element and layer ``li = 3g + lvl`` (level ``lvl`` of the
/32, /16, /8 memories):

1. ``m = emb . feat_lvl^T`` in f32; the bias is -1e9 where ``m < 0``, except
   on query rows where every position is blocked, which get 0;
2. cross-attention: q from ``x + qpos``, k from ``mem + pe``, v from
   ``mem``, ``heads`` heads with scale ``hd^-0.5``, then ``out``; LN1 of
   ``x + y``;
3. self-attention: q and k from ``x + qpos``, v from ``x``; LN2;
4. ReLU FFN; LN3;
5. the next mask embedding: decoder norm, then the 3-layer mask MLP,
   rounded to the model dtype D.

The query state stays in f32; every product takes D-rounded operands with
f32 accumulation and an f32 bias, as the TPU kernel's ``_dot`` does.

The CUDA counterpart is a short chain: the k and v projections of each
level's memory do not depend on the queries, so one GEMM per level and
projection computes them for all of that level's layers (``csrc/gemm.cuh``),
and one cluster of 8 thread blocks per batch element
(``csrc/decoder_stack.cu``) then runs every layer with the query state
held in shared memory throughout. Two instances:

* the flagship (bf16, Q <= 48, the widths :func:`check_shape` takes): each
  block a replica of the state, the work split between them, its products
  on the tensor cores with the weights in fragment order
  (:func:`pack_fragments`);
* the split-query instance (everything else: f32, the shipped
  configurations' dtype, Waymo's 170 queries, up to 1024): block r owns
  rows [r ceil(Q/cs), (r+1) ceil(Q/cs)) of the state and every
  intermediate (in shared memory, or where they do not fit in a
  device-memory workspace, :func:`split_plan`), the products run on the
  tensor cores (3xTF32 in f32: both operands split into TF32 halves,
  ``csrc/common.cuh::split_tf32``; m16n8k16 in bf16) with the weights
  stored (N, K) and the block's rows on the MMA's 8-wide side, and
  self-attention reads the other blocks' k and v through distributed
  shared memory (:func:`check_shape_split`, :func:`smem_bytes_split`). A
  width it has no instance for runs padded (:func:`split_padding`,
  :func:`padded_split`): a head's width to the next instance with zero q,
  k and v columns and zero out-projection rows (the scale stays the true
  width's), the heads to a count its warps split with all-zero heads, the
  FFN to whole chunks of C with zero weights and bias; the LNs walk the
  true columns only.

The mask embedding may have any width D (``head_out_channels``): D < C
runs zero-padded to C on either instance (the mask MLP's last layer and
bias, the initial embedding and the resized features: the padded terms of
``emb . feat^T`` are exact zeros, :func:`embed_padding`); D > C runs on the
split instance with the embedding at :func:`embed_width` columns in a
device-memory buffer.

Every launch counts under ``decoder_stack`` (and its instance under
``decoder_stack/flagship``, ``decoder_stack/split_tc_bf16`` or
``decoder_stack/split_tc_f32``, with the suffixes of :func:`split_instance`
and ``_embpad`` for D < C).
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from mask_bev_tpu_torch.kernels import build as kb
from mask_bev_tpu_torch.ops.swin_block import (
    EPI_BIAS, Dense, gemm, make_dense, padded_columns)

NEG = -1e9


class LayerWeights(NamedTuple):
    """One decoder layer; matrices (in, out) in D, vectors f32."""

    wq: torch.Tensor
    bq: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    sq: torch.Tensor
    sbq: torch.Tensor
    sk: torch.Tensor
    sbk: torch.Tensor
    sv: torch.Tensor
    sbv: torch.Tensor
    so: torch.Tensor
    sbo: torch.Tensor
    n1w: torch.Tensor
    n1b: torch.Tensor
    n2w: torch.Tensor
    n2b: torch.Tensor
    n3w: torch.Tensor
    n3b: torch.Tensor
    f1: torch.Tensor
    fb1: torch.Tensor
    f2: torch.Tensor
    fb2: torch.Tensor


class HeadWeights(NamedTuple):
    """Decoder norm and mask MLP (shared by every layer)."""

    dnw: torch.Tensor
    dnb: torch.Tensor
    m1: torch.Tensor
    mb1: torch.Tensor
    m2: torch.Tensor
    mb2: torch.Tensor
    m3: torch.Tensor
    mb3: torch.Tensor


def _ln(x32, w, b):
    xc = x32 - x32.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + 1e-6) * w + b


def _dot(a, w, b=None):
    y = a.to(w.dtype).float() @ w.float()
    return y if b is None else y + b


def _attend(q, k, v, wo, bo, heads: int, bias, dtype):
    b, nq, c = q.shape
    hd = c // heads

    def split(t):
        return t.to(dtype).float().reshape(b, -1, heads, hd).transpose(1, 2)

    attn = split(q * hd ** -0.5) @ split(k).transpose(-1, -2)
    if bias is not None:
        attn = attn + bias[:, None]
    attn = torch.softmax(attn, dim=-1).to(dtype).float()
    o = (attn @ split(v)).transpose(1, 2).reshape(b, nq, c)
    return _dot(o.to(dtype), wo, bo)


def blocked_positions(m: torch.Tensor) -> torch.Tensor:
    """(B, Q, T) mask logits -> positions the bias blocks: ``m < 0``, except
    on rows where every position is blocked."""
    blocked = m < 0.0
    return blocked & ~blocked.all(dim=-1, keepdim=True)


def mask_embed(x32: torch.Tensor, hw: HeadWeights, dtype,
               magnitude: bool = False):
    """Decoder norm + 3-layer mask MLP on the f32 query state -> D values
    (with ``magnitude``, also each value's size beside its terms: ``|e|``
    plus the root-sum-square of its product's terms, sqrt(sum_j (z_j
    W3_ji)^2), z the last layer's input)."""
    z = _ln(x32, hw.dnw, hw.dnb).to(dtype)
    z = torch.relu(_dot(z, hw.m1, hw.mb1)).to(dtype)
    z = torch.relu(_dot(z, hw.m2, hw.mb2)).to(dtype)
    e = _dot(z, hw.m3, hw.mb3).to(dtype)
    if not magnitude:
        return e
    size = (z.double() ** 2 @ hw.m3.double() ** 2).sqrt().float() + e.float(
        ).abs()
    return e, size


# A logit m = emb . feat decides m < 0 within rounding of 0 where |m| is at
# most BAND_ROUNDINGS roundings of the operand type (``BAND_UNIT``: bf16
# 2^-8; f32 2^-21, 3xTF32) of sqrt(sum_i (M_i f_i)^2), M the embedding's
# size (:func:`mask_embed`'s ``magnitude``; the first layer's emb0 |emb0|):
# the size of the difference that independent roundings of the embedding's
# terms give the logit. An embedding value that is near 0 beside its terms
# (at D 1, a whole row's sign) so lies in the band.
BAND_ROUNDINGS = 4
BAND_UNIT = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -21}


def logit_band(size: torch.Tensor, feat: torch.Tensor, dtype) -> torch.Tensor:
    """(B, Q, T) rounding band of the logits ``emb . feat^T`` given the
    embedding's (B, Q, D) magnitude ``size`` and the (B, T, D) features."""
    sq = (size.double() ** 2) @ (feat.double() ** 2).transpose(-1, -2)
    return (BAND_ROUNDINGS * BAND_UNIT[dtype] * sq.sqrt()).float()


def decision_flips(bits, logits, bands) -> List[int]:
    """Per layer, how far the kernel's blocked positions ``bits`` (B, Q, T)
    stray from the plain version's ``logits`` beyond rounding: the raw
    ``m < 0`` decisions that differ where |m| passes its ``band``
    (:func:`logit_band`), plus one for each row whose every-key-blocked
    rule (:func:`blocked_positions`) the two sides apply differently, in
    place of the whole row that the rule turns over. A kernel row with no
    blocked position was either open or blocked at every key (and
    cleared): it is read as whichever differs less from the plain row
    outside the band (on a tie, as the plain row's rule)."""
    out = []
    for kb_, m, band in zip(bits, logits, bands):
        raw = m < 0.0
        far = m.abs() > band
        blocked_all = raw.all(dim=-1)
        miss_open = (raw & far).sum(dim=-1)
        miss_blocked = (~raw & far).sum(dim=-1)
        cleared = ~kb_.any(dim=-1) & ((miss_blocked < miss_open) | (
            (miss_blocked == miss_open) & blocked_all))
        k_raw = kb_ | cleared[..., None]
        out.append(int(((k_raw != raw) & far).sum())
                   + int((cleared != blocked_all).sum()))
    return out


def decoder_stack_plain(out0, emb0, qpos, mems: Sequence[torch.Tensor],
                        pes: Sequence[torch.Tensor],
                        feats: Sequence[torch.Tensor],
                        layers: Sequence[LayerWeights], head: HeadWeights,
                        *, num_heads: int, return_logits: bool = False,
                        blocked=None, return_bands: bool = False):
    """Plain PyTorch version: final (B, Q, C) query state in D (and, with
    ``return_logits``, every layer's f32 mask logits ``emb . feat^T``; with
    ``return_bands`` too, every layer's :func:`logit_band`).
    ``blocked``: per-layer (B, Q, T) positions to block instead of the ones
    the logits give (to hold the kernel's arithmetic against this version
    apart from its threshold decisions)."""
    dtype = out0.dtype
    nl = len(mems)
    x32 = out0.float()
    emb = emb0.float()
    size = emb.abs()
    qp = qpos.float()
    logits, bands = [], []
    for li, lw in enumerate(layers):
        lvl = li % nl
        m = emb @ feats[lvl].float().transpose(-1, -2)
        logits.append(m)
        if return_bands:
            bands.append(logit_band(size, feats[lvl], dtype))
        bias = torch.where(blocked_positions(m) if blocked is None
                           else blocked[li], NEG, 0.0)
        mem = mems[lvl]
        q = _dot(x32 + qp, lw.wq, lw.bq)
        k = _dot(mem + pes[lvl].to(dtype), lw.wk, lw.bk)
        v = _dot(mem, lw.wv, lw.bv)
        y = _attend(q, k, v, lw.wo, lw.bo, num_heads, bias, dtype)
        x32 = _ln(x32 + y, lw.n1w, lw.n1b)
        xq = x32 + qp
        y = _attend(_dot(xq, lw.sq, lw.sbq), _dot(xq, lw.sk, lw.sbk),
                    _dot(x32, lw.sv, lw.sbv), lw.so, lw.sbo, num_heads,
                    None, dtype)
        x32 = _ln(x32 + y, lw.n2w, lw.n2b)
        y = _dot(torch.relu(_dot(x32, lw.f1, lw.fb1)), lw.f2, lw.fb2)
        x32 = _ln(x32 + y, lw.n3w, lw.n3b)
        if return_bands:
            emb, size = mask_embed(x32, head, dtype, magnitude=True)
            emb = emb.float()
        else:
            emb = mask_embed(x32, head, dtype).float()
    out = x32.to(dtype)
    if return_bands:
        return out, logits, bands
    return (out, logits) if return_logits else out


# --------------------------------------------------------------- CUDA chain

_THREADS = 384
_WARPS = _THREADS // 32
_TK = 32  # keys per cross-attention tile (bf16)
_SLOTS = 2  # cross-attention tasks a warp holds
# blocks per cluster, one cluster per batch element (``DS_CS`` in
# ``csrc/decoder_stack.cu``): at the flagship's shared memory a block, the
# H100 holds 15 clusters of 8 at once but 7 of 16, so 8 runs a batch of 8
# in one wave (``PERF.md`` §6)
CLUSTER = 8


def pack_fragments(w: torch.Tensor) -> torch.Tensor:
    """(K, N) weight -> the same values, flat, in ``mma.sync`` m16n8k16 B
    fragment order: for each 8-column tile j and 16-row step ks, lane
    ``4g + t`` holds rows ``16 ks + 2t, +1, +8, +9`` of column ``8j + g``
    (one 8-byte load a lane). K % 16 == 0 and N % 8 == 0."""
    k, n = w.shape
    return (w.reshape(k // 16, 2, 4, 2, n // 8, 8)
            .permute(4, 0, 5, 2, 1, 3).reshape(-1))


def unpack_fragments(p: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_fragments`."""
    return (p.reshape(n // 8, k // 16, 8, 4, 2, 2)
            .permute(1, 4, 3, 5, 0, 2).reshape(k, n))


def pack_weights(layers: Sequence[LayerWeights], head: HeadWeights,
                 fragments: bool = True):
    """Query-side weights as one D buffer (per layer wq, wo, sq, sk, sv,
    so, f1, f2; then m1, m2, m3; each matrix in fragment order,
    :func:`pack_fragments`, for the flagship instance, or transposed, (N,
    K) row-major, for the split instance) and one f32 buffer (per layer bq,
    bo, sbq, sbk, sbv, sbo, n1w, n1b, n2w, n2b, n3w, n3b, fb1, fb2; then
    dnw, dnb, mb1, mb2, mb3). Order fixed by ``csrc/decoder_stack.cu``."""
    pack = pack_fragments if fragments else (lambda t: t.t().reshape(-1))
    wd, wf = [], []
    for lw in layers:
        wd += [lw.wq, lw.wo, lw.sq, lw.sk, lw.sv, lw.so, lw.f1, lw.f2]
        wf += [lw.bq, lw.bo, lw.sbq, lw.sbk, lw.sbv, lw.sbo, lw.n1w, lw.n1b,
               lw.n2w, lw.n2b, lw.n3w, lw.n3b, lw.fb1, lw.fb2]
    wd += [head.m1, head.m2, head.m3]
    wf += [head.dnw, head.dnb, head.mb1, head.mb2, head.mb3]
    return (torch.cat([pack(t) for t in wd]).contiguous(),
            torch.cat([t.float().reshape(-1) for t in wf]).contiguous())


def kv_weights(layers: Sequence[LayerWeights], nl: int) -> List[Dense]:
    """Per level: the k and v projections of all that level's layers as
    two (G*C, C) GEMM weights (layer 3g + lvl at rows g*C; f32 weights with
    their TF32 halves, :func:`~mask_bev_tpu_torch.ops.swin_block.
    make_dense`)."""
    out = []
    for lvl in range(nl):
        ls = layers[lvl::nl]
        out.append(tuple(
            make_dense(torch.cat([w.t() for w in ws]),
                       torch.cat(bs), False)
            for ws, bs in (([lw.wk for lw in ls], [lw.bk for lw in ls]),
                           ([lw.wv for lw in ls], [lw.bv for lw in ls]))))
    return out


def check_shape(q: int, c: int, ffn: int, heads: int, nl: int,
                n_layers: int) -> None:
    """Raise unless the kernel takes these widths (the C entry point's own
    check): C splits into 8-column tiles per block of the cluster and the
    FFN's hidden units into 16-row steps per block; the cross-attention
    tasks (head, 16 queries) fit the warps' slots, the self-attention
    scores the key-tile area."""
    cs, mtq = CLUSTER, -(-q // 16)
    if (c % (8 * cs) or ffn % (16 * cs) or ffn // cs > c
            or n_layers % nl or nl > 3 or q > 48 or c % heads
            or c // heads not in (32, 64) or heads * mtq > _WARPS * _SLOTS
            or mtq * c // cs // 8 > _WARPS or 2 * cs * heads > c + 4
            or -(-heads // cs) * q * q > _TK * (c + 8)):
        raise ValueError(f"decoder stack kernel: unsupported shape Q={q} "
                         f"C={c} FFN={ffn} heads={heads} levels={nl} "
                         f"layers={n_layers} for clusters of {cs} blocks")


def smem_bytes(q: int, c: int, t_max: int) -> int:
    """Shared memory of one block, as ``csrc/decoder_stack.cu`` lays it
    out (4-byte words, every part 16-byte aligned): the f32 replicas X, QB,
    OB (row stride C + 4) and XA (or the bf16 q copy, 16 ceil(Q/16) rows
    of C + 8), the mask bits of its key slice, the cluster's row flags and
    two bf16 key tiles (k and v, rows of C + 8)."""
    words_loc = (-(-t_max // CLUSTER) + 31) // 32
    qx = q * (c + 4)
    xa = max(qx, 16 * -(-q // 16) * (c + 8) // 2)

    def al(n):
        return -(-n // 4) * 4
    return 4 * (3 * qx + xa + al(q * words_loc) + al(CLUSTER * q)
                + _TK * (c + 8))


SPLIT_WARPS = 8  # ``DS2_WARPS`` of the split instance
SPLIT_RG = 32  # ``DS2_RG``: rows a group (and a block of a cluster of 8)
SPLIT_MAXR = 64  # ``DS2_MAXR``: rows a block of the split instance owns
SPLIT_MAXQ = 16 * SPLIT_MAXR  # queries the split instance takes
SPLIT_TK = 32  # keys a tile of the split instance
SMEM_LIMIT = 227 * 1024  # shared memory a block may use on the H100


def split_cluster(q: int) -> int:
    """Blocks of a cluster of the split instance (``ds2_cluster``): 8 while
    a block's ceil(Q/8) rows fit :data:`SPLIT_RG`, else 16 (Q up to
    :data:`SPLIT_MAXQ`)."""
    return 8 if -(-q // 8) <= SPLIT_RG else 16


def column_slices(heads: int, hd: int) -> bool:
    """Whether the split instance's cross-attention splits a head's output
    columns over its 8 warps, a head a round (``ds2_column_slices``): one
    head, or head widths over 64."""
    return heads == 1 or hd > 64


class SplitLayout(NamedTuple):
    """One block of the split instance (``ds2_layout``): its shared memory
    in bytes, the self-attention's keys a chunk, and whether its row
    buffers live in the device-memory workspace."""

    nbytes: int
    qc: int
    glob: bool


def split_plan(q: int, c: int, heads: int, t_max: int,
               f32: bool = True) -> SplitLayout:
    """The split instance's layout, as ``csrc/decoder_split.cuh::
    ds2_layout`` lays it out (4-byte words, every part 16-byte aligned): its
    R = ceil(Q/cs) rows of X, XA, QB and OB (row stride C + 16), the mask
    bits of its rows against all keys, its row flags, then one area that
    holds in turn the cross-attention's key-tile slots (k or v of 32 keys
    at the staged width SW, C or a head's width where
    :func:`column_slices`: f32 at stride SW + 16, bf16 SW + 8; two buffers
    of k and v where they fit in 227 KB, else one), the bf16 q copy
    (ceil(RG/16) 16-row tiles, RG = min(R, 32)) and the (max, sum) exchange
    of 8 warps x the padded rows, and the self-attention's own k rows, one
    head's k (then v) of QC rows and the (R, QC) scores: QC = Q where that
    fits, else the most keys, a multiple of 32, that do (two sweeps over
    the chunks). Where that passes 227 KB, or R > 32, the four row buffers
    and the own k rows move to the workspace (``glob``), and shared memory
    keeps the rest."""
    def al(n):
        return -(-n // 4) * 4
    r, ld, hd = -(-q // split_cluster(q)), c + 16, c // heads
    rg = min(r, SPLIT_RG)
    rp = 16 * -(-rg // 16)
    rx = r * ld
    sw = hd if column_slices(heads, hd) else c
    slot = SPLIT_TK * (sw + 16) if f32 else SPLIT_TK * (sw + 8) // 2
    qt = 0 if f32 else rp * (c + 8) // 2
    for glob in ((False, True) if r <= SPLIT_RG else (True,)):
        kown = 0 if glob else rx
        area = (0 if glob else 4 * rx) + al(r * -(-t_max // 32)) + al(r)
        self_attn = kown + q * (hd + 1) + r * q
        for buffers in (2, 1):
            cross = 2 * buffers * slot + qt + 2 * SPLIT_WARPS * rp
            total = 4 * (area + al(max(cross, self_attn)))
            if total <= SMEM_LIMIT:
                break
        qc = q
        if total > SMEM_LIMIT:
            chunk = (SMEM_LIMIT // 4 - area - kown) // (hd + 1 + r) // 32 * 32
            if 32 <= chunk < q:
                qc = chunk
                total = 4 * (area + al(max(cross, kown + qc * (hd + 1)
                                           + r * qc)))
        if total <= SMEM_LIMIT:
            break
    return SplitLayout(total, qc, glob)


def split_workspace(b: int, q: int, c: int) -> int:
    """f32 values of the workspace a launch of B elements needs where
    ``split_plan(...).glob``: 5 R (C + 16) a block."""
    cs = split_cluster(q)
    return b * cs * 5 * -(-q // cs) * (c + 16)


def smem_bytes_split(q: int, c: int, heads: int, t_max: int,
                     f32: bool = True) -> int:
    """Shared memory of one block of the split instance
    (:func:`split_plan`)."""
    return split_plan(q, c, heads, t_max, f32).nbytes


SPLIT_HEAD_DIMS = (8, 16, 32, 64, 128, 256)  # the split kernel's HD instances
SPLIT_ONE_HEAD_DIMS = (64, 128, 256, 512)  # its one-head instances (HD = C)


def _heads_taken(heads: int, hd: int = 8) -> bool:
    """2, 4 or 8 heads (a head's warps split each key tile) or a multiple
    of 8 (rounds of 8 heads); any count at head widths over 64 (a head a
    round, :func:`column_slices`)."""
    if hd > 64:
        return heads >= 1
    return heads > 1 and not (SPLIT_WARPS % heads and heads % 8)


def split_padding(c: int, heads: int, ffn: int
                  ) -> Optional[Tuple[int, int, int]]:
    """(heads, head width, FFN) the split instance runs C over ``heads``
    heads with an FFN of ``ffn`` units as: one head at the narrowest of
    :data:`SPLIT_ONE_HEAD_DIMS` that holds C; else the head width at the
    narrowest of :data:`SPLIT_HEAD_DIMS` that holds it and, up to width 64,
    the fewest heads at least ``heads`` that the warps split
    (:func:`_heads_taken`) and that make the padded C a multiple of 64
    (32-deep product chunks, 16 output columns a warp); the FFN in whole
    chunks of the padded C. None where no instance holds the head: a width
    over 256 at more than one head, or one head over C 512. Shapes the
    instances take are their own padding."""
    if heads < 1 or c < 1 or ffn < 1 or c % heads:
        return None
    if heads == 1:
        hp, widths, hd = 1, SPLIT_ONE_HEAD_DIMS, c
    else:
        hp, widths, hd = heads, SPLIT_HEAD_DIMS, c // heads
    hdp = next((w for w in widths if w >= hd), None)
    if hdp is None:
        return None
    while heads > 1 and (not _heads_taken(hp, hdp) or hp * hdp % 64):
        hp += 1
    cp = hp * hdp
    return hp, hdp, -(-ffn // cp) * cp


def embed_width(c: int, d: int) -> int:
    """The columns the stack holds a mask embedding of width ``d`` at, for
    a decoder of C columns: C where d <= C (zero-padded), else d rounded up
    to a multiple of 32 (the split instance's 32-deep product chunks)."""
    return c if d <= c else -(-d // 32) * 32


def split_refusal(q: int, c: int, ffn: int, heads: int, nl: int,
                  n_layers: int, t_max: int,
                  f32: bool = True, d: Optional[int] = None
                  ) -> Optional[str]:
    """Why the split instance does not take these shapes (the C entry
    point's own check on the padded shapes), or None where it does: a head
    an instance holds (:func:`split_padding`: one head up to C 512, else a
    head width up to 256, any FFN), at most 64 rows a block in clusters of
    8 or 16 (Q <= 1024), the shared memory of :func:`split_plan` at the
    padded width (the rows in the workspace where they do not fit beside
    the rest), and a mask embedding of ``d`` >= 1 columns (any width: a
    wider one than C lives in device memory)."""
    pad = split_padding(c, heads, ffn)
    smem = (smem_bytes_split(q, pad[0] * pad[1], pad[0], t_max, f32)
            if pad and q >= 1 else 0)
    if (q < 1 or pad is None or n_layers % nl or nl > 3
            or -(-q // split_cluster(q)) > SPLIT_MAXR
            or smem > SMEM_LIMIT or (d is not None and d < 1)):
        return (f"decoder stack split instance: unsupported shape Q={q} "
                f"C={c} FFN={ffn} heads={heads} levels={nl} "
                f"layers={n_layers} keys={t_max} embedding={d} (one head "
                f"up to C 512, else head widths up to 256; Q up to "
                f"{SPLIT_MAXQ}; {smem} B of shared memory a block, limit "
                f"{SMEM_LIMIT})")
    return None


def embed_padding(head: HeadWeights, de: int) -> HeadWeights:
    """``head`` with the mask MLP's last layer (C, D) and its bias at ``de``
    >= D output columns, zeros past D (the embedding's padded columns are
    exact zeros)."""
    d = head.m3.shape[1]
    if d == de:
        return head
    m3 = head.m3.new_zeros(head.m3.shape[0], de)
    m3[:, :d] = head.m3
    mb3 = head.mb3.new_zeros(de)
    mb3[:d] = head.mb3
    return head._replace(m3=m3, mb3=mb3)


def padded_split(layers: Sequence[LayerWeights], head: HeadWeights,
                 c: int, heads: int, ffn: int
                 ) -> Tuple[List[LayerWeights], HeadWeights]:
    """The weights of the padded model :func:`split_padding` gives: every
    C axis at the padded width (the true columns at
    :func:`padded_columns`, zeros elsewhere: matrices, biases and LN
    affine; the cross-attention's k and v projections only on their
    output axis, as their GEMM reads the memory at its true width), the
    FFN's hidden units at the padded FFN (zero rows of W1's output, of its
    bias and of W2's input). A mask embedding wider than C
    (:func:`embed_padding` to :func:`embed_width`) keeps its columns: the
    last mask-MLP layer is padded on its input axis only."""
    hp, hdp, fp = split_padding(c, heads, ffn)
    cp = hp * hdp
    col = padded_columns(c, heads, hdp)

    def vec(t, n=cp, idx=col):
        out = t.new_zeros(n)
        out[idx.to(t.device)] = t
        return out

    def mat(t, rows, cols, nr, nc):
        out = t.new_zeros(nr, nc)
        out[rows.to(t.device)[:, None], cols.to(t.device)[None]] = t
        return out

    hid = torch.arange(ffn)
    out = []
    for lw in layers:
        d = {}
        for name, t in lw._asdict().items():
            if name == "f1":
                d[name] = mat(t, col, hid, cp, fp)
            elif name == "fb1":
                d[name] = vec(t, fp, hid)
            elif name == "f2":
                d[name] = mat(t, hid, col, fp, cp)
            elif name in ("wk", "wv"):  # their GEMM reads the true memory
                d[name] = mat(t, torch.arange(c), col, c, cp)
            elif t.dim() == 2:
                d[name] = mat(t, col, col, cp, cp)
            else:
                d[name] = vec(t)
        out.append(LayerWeights(**d))
    de = head.m3.shape[1]
    wide = torch.arange(de)
    hw = {}
    for name, t in head._asdict().items():
        if de > c and name == "m3":
            hw[name] = mat(t, col, wide, cp, de)
        elif de > c and name == "mb3":
            hw[name] = t
        else:
            hw[name] = mat(t, col, col, cp, cp) if t.dim() == 2 else vec(t)
    return out, HeadWeights(**hw)


def check_shape_split(q: int, c: int, ffn: int, heads: int, nl: int,
                      n_layers: int, t_max: int, f32: bool = True) -> None:
    """Raise with :func:`split_refusal`'s reason, if any."""
    reason = split_refusal(q, c, ffn, heads, nl, n_layers, t_max, f32)
    if reason:
        raise ValueError(reason)


def flagship_takes(q: int, c: int, ffn: int, heads: int, nl: int,
                   n_layers: int, t_max: int, dtype,
                   d: Optional[int] = None) -> bool:
    """True iff the flagship instance takes this call: bf16, the widths of
    :func:`check_shape`, its shared memory and a mask embedding of ``d``
    <= C columns (default C; a narrower one zero-padded). Every other call
    goes to the split instance."""
    if dtype != torch.bfloat16 or (d is not None and not 1 <= d <= c):
        return False
    try:
        check_shape(q, c, ffn, heads, nl, n_layers)
    except ValueError:
        return False
    return smem_bytes(q, c, t_max) <= SMEM_LIMIT


def decoder_stack_refusal(q: int, c: int, ffn: int, heads: int, nl: int,
                          n_layers: int, t_max: int, dtype,
                          d: Optional[int] = None) -> Optional[str]:
    """Why :func:`decoder_stack` launches no kernel for these shapes on a
    CUDA device, or None where it launches one: bf16 or f32, and the
    flagship instance (:func:`flagship_takes`) or the split instance
    (:func:`split_refusal`) takes them; ``d`` the mask embedding's width
    (default C)."""
    if dtype not in (torch.bfloat16, torch.float32):
        return f"the decoder stack kernels take bf16 or f32; got {dtype}"
    if flagship_takes(q, c, ffn, heads, nl, n_layers, t_max, dtype, d):
        return None
    return split_refusal(q, c, ffn, heads, nl, n_layers, t_max,
                         dtype == torch.float32, d)


def split_instance(q: int, heads: int, f32: bool, c: Optional[int] = None,
                   ffn: Optional[int] = None, t_max: Optional[int] = None,
                   d: Optional[int] = None) -> str:
    """The name a split launch counts under: ``split_tc_f32`` or
    ``split_tc_bf16``, with ``_cs16`` in clusters of 16 (Q > 256),
    ``_heads1`` for one head (its columns split over the warps),
    ``_heads<n>`` for rounds of 8 heads (more than 8) and ``_hd<w>`` for
    head widths over 64 at more than one head (a head a round), of the
    heads the kernel runs; given C and the FFN, ``_padded`` where the model
    runs padded (:func:`split_padding`); given the keys, ``_glob`` where the
    rows live in the workspace (:func:`split_plan`); given the
    embedding's width ``d``, ``_embpad`` where it is narrower than C and
    ``_embwide`` where it is wider."""
    padded, hdp = False, None
    if c is not None:
        hp, hdp, fp = split_padding(c, heads, ffn)
        padded = (hp, hp * hdp, fp) != (heads, c, ffn)
        heads = hp
    name = "split_tc_" + ("f32" if f32 else "bf16")
    if split_cluster(q) > 8:
        name += "_cs16"
    if heads == 1 or (heads > SPLIT_WARPS and not (hdp or 0) > 64):
        name += f"_heads{heads}"
    if heads > 1 and (hdp or 0) > 64:
        name += f"_hd{hdp}"
    if t_max is not None and split_plan(q, heads * hdp, heads, t_max,
                                        f32).glob:
        name += "_glob"
    if d is not None and d != c:
        name += "_embpad" if d < c else "_embwide"
    return name + ("_padded" if padded else "")


SPLIT_PARTS = ("mask bits", "q projection", "cross-attention",
               "out projection + LN1", "self-attention + LN2", "FFN + LN3",
               "mask MLP")  # the parts ``profile`` times, in its order


def decoder_stack(out0, emb0, qpos, mems, pes, feats,
                  layers: Sequence[LayerWeights], head: HeadWeights, *,
                  num_heads: int, packed=None, return_bits: bool = False,
                  profile=None):
    """Final (B, Q, C) query state: the CUDA chain for CUDA tensors (the
    flagship instance where :func:`flagship_takes`, else the split
    instance), the plain version for CPU tensors. ``emb0`` and ``feats``
    hold the mask embedding's D columns (any D >= 1: narrower than C
    zero-padded to C, wider on the split instance at :func:`embed_width`).
    ``packed``: cached ``({}, kv_weights(...))``, its dict filled with each
    instance's ``pack_weights`` at first use. ``return_bits`` (CUDA only):
    also return the kernel's effective blocked positions, (B, L, Q, T_l)
    bool per layer, to count disagreements with the plain version.
    ``profile`` (split instance only): a zeroed (B * split_cluster(Q), 7)
    int64 CUDA tensor to which each block adds the ns it spent in each of
    :data:`SPLIT_PARTS`, summed over the layers."""
    if not out0.is_cuda:
        return decoder_stack_plain(out0, emb0, qpos, mems, pes, feats,
                                   layers, head, num_heads=num_heads)
    b, q, c = out0.shape
    nl = len(mems)
    n_layers = len(layers)
    dt = out0.dtype
    hd = c // num_heads
    ffn = layers[0].f1.shape[1]
    d = emb0.shape[-1]
    t = [m.shape[1] for m in mems]
    reason = decoder_stack_refusal(q, c, ffn, num_heads, nl, n_layers,
                                   max(t), dt, d)
    if reason:
        raise ValueError(reason)
    if head.m3.shape[1] != d or head.mb3.shape[0] != d:
        raise ValueError(f"decoder stack kernel: emb0 width {d} is not the "
                         f"mask MLP's {tuple(head.m3.shape)}")
    flagship = flagship_takes(q, c, ffn, num_heads, nl, n_layers, max(t),
                              dt, d)
    if profile is not None:
        if flagship:
            raise ValueError("profile: only the split instance is timed")
        kb.check_cuda(profile, "profile", torch.int64,
                      (b * split_cluster(q), len(SPLIT_PARTS)))
    de = embed_width(c, d)
    heads, cp, fp, pad, glob = num_heads, c, ffn, None, False
    if flagship:
        smem = smem_bytes(q, c, max(t))
    else:
        f32 = dt == torch.float32
        heads, hdp, fp = split_padding(c, num_heads, ffn)
        cp = heads * hdp
        if (heads, cp, fp) != (num_heads, c, ffn):
            pad = padded_columns(c, num_heads, hdp).to(out0.device)
        plan = split_plan(q, cp, heads, max(t), f32)
        smem, glob = plan.nbytes, plan.glob
    kind = "flagship" if flagship else "split"
    if packed is None:
        packed = ({}, kv_weights(layers, nl))
    wpacks, kvw = packed
    if kind not in wpacks:
        head = embed_padding(head, de)
        if pad is not None:
            layers, head = padded_split(layers, head, c, num_heads, ffn)
            wpacks["split_kv"] = kv_weights(layers, nl)
        wpacks[kind] = pack_weights(layers, head, fragments=flagship)
    wd, wf = wpacks[kind]
    if pad is not None:
        kvw = wpacks["split_kv"]

    def widen(x, emb=False):
        """x's last axis (C, or the embedding's D) at the kernel's width:
        the embedding's D zero-padded to :func:`embed_width` (and, where it
        is C, then as C), C at the padded columns (zeros elsewhere)."""
        if emb and x.shape[-1] != de:
            x = torch.nn.functional.pad(x, (0, de - x.shape[-1]))
        if pad is None or (emb and de > c):
            return x
        out = x.new_zeros(*x.shape[:-1], cp)
        out[..., pad] = x
        return out
    kb.check_cuda(wd, "wd", dt)
    kb.check_cuda(wf, "wf", torch.float32)
    groups = n_layers // nl
    ks, vs = [], []
    for lvl in range(nl):
        mem = mems[lvl]
        kb.check_cuda(mem, f"mems[{lvl}]", dt, (b, t[lvl], c))
        kin = (mem + pes[lvl].to(mem.dtype)).reshape(b * t[lvl], c)
        ks.append(gemm("decoder_stack", kin, kvw[lvl][0], EPI_BIAS))
        vs.append(gemm("decoder_stack", mem.reshape(b * t[lvl], c),
                       kvw[lvl][1], EPI_BIAS))
    fw = de if de > c else cp
    feats = [widen(f.float(), emb=True).contiguous() for f in feats]
    for lvl, f in enumerate(feats):
        kb.check_cuda(f, f"feats[{lvl}]", torch.float32, (b, t[lvl], fw))
    x0 = widen(out0.float()).contiguous()
    e0 = widen(emb0.float(), emb=True).contiguous()
    if de > c and e0.data_ptr() == emb0.data_ptr():
        e0 = e0.clone()  # the kernel's own (B, Q, De) buffer, emb0 in it
    qp = widen(qpos.float()).contiguous()
    out = torch.empty((b, q, cp), dtype=dt, device=out0.device)
    words = (max(t) + 31) // 32
    bits = (torch.empty((b, n_layers, q, words), dtype=torch.int32,
                        device=out0.device) if return_bits else None)
    ptrs = (ctypes.c_void_p * 9)(*(
        [k.data_ptr() for k in ks] + [0] * (3 - nl)
        + [v.data_ptr() for v in vs] + [0] * (3 - nl)
        + [f.data_ptr() for f in feats] + [0] * (3 - nl)))
    tarr = (ctypes.c_int * 3)(*(t + [0] * (3 - nl)))
    emb_inst = "" if d == c else "_embpad"
    if flagship:
        kb.launch("decoder_stack", "decoder_stack_forward", kb.ptr(x0),
                  kb.ptr(e0), kb.ptr(qp), ptrs, tarr, kb.ci(nl),
                  kb.ci(groups), kb.ptr(wd), kb.ptr(wf), kb.ptr(out),
                  kb.ptr(bits), kb.ci(b), kb.ci(q), kb.ci(c), kb.ci(ffn),
                  kb.ci(num_heads), kb.ci(smem), kb.cf(hd ** -0.5),
                  kb.stream(), instance="flagship" + emb_inst)
    else:
        ws = (torch.empty(split_workspace(b, q, cp), dtype=torch.float32,
                          device=out0.device) if glob else None)
        kb.launch("decoder_stack", "decoder_split_forward", kb.ptr(x0),
                  kb.ptr(e0 if de <= c else None), kb.ptr(qp), ptrs, tarr,
                  kb.ci(nl), kb.ci(groups), kb.ptr(wd), kb.ptr(wf),
                  kb.ptr(out), kb.ptr(bits), kb.ptr(profile), kb.ptr(ws),
                  kb.ptr(e0 if de > c else None), kb.ci(de if de > c else cp),
                  kb.ci(b), kb.ci(q), kb.ci(cp), kb.ci(fp), kb.ci(heads),
                  kb.ci(smem), kb.cf(hd ** -0.5), kb.ci(hd),
                  kb.ci(num_heads), kb.ci(f32), kb.stream(),
                  instance=split_instance(q, num_heads, f32, c, ffn, max(t),
                                          d))
        if pad is not None:
            out = out[..., pad].contiguous()
    if not return_bits:
        return out
    shifts = torch.arange(32, device=out0.device, dtype=torch.int32)
    unpacked = ((bits[..., None] >> shifts) & 1).bool().reshape(
        b, n_layers, q, words * 32)
    return out, [unpacked[:, li, :, :t[li % nl]] for li in range(n_layers)]
