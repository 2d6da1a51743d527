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
  configurations' dtype, and Waymo's 170 queries): block r owns rows
  [r ceil(Q/8), (r+1) ceil(Q/8)) of the state and every intermediate, the
  products run on the tensor cores (3xTF32 in f32: both operands split into
  TF32 halves, ``csrc/common.cuh::split_tf32``; m16n8k16 in bf16) with the
  weights stored (N, K) and the block's rows on the MMA's 8-wide side, and
  self-attention reads the other blocks' k and v through distributed
  shared memory (:func:`check_shape_split`, :func:`smem_bytes_split`).

Every launch counts under ``decoder_stack`` (and its instance under
``decoder_stack/flagship``, ``decoder_stack/split_tc_bf16`` or
``decoder_stack/split_tc_f32``).
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from mask_bev_tpu_torch.kernels import build as kb
from mask_bev_tpu_torch.ops.swin_block import (
    EPI_BIAS, Dense, gemm, make_dense)

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


def mask_embed(x32: torch.Tensor, hw: HeadWeights, dtype) -> torch.Tensor:
    """Decoder norm + 3-layer mask MLP on the f32 query state -> D values."""
    z = _ln(x32, hw.dnw, hw.dnb).to(dtype)
    z = torch.relu(_dot(z, hw.m1, hw.mb1)).to(dtype)
    z = torch.relu(_dot(z, hw.m2, hw.mb2)).to(dtype)
    return _dot(z, hw.m3, hw.mb3).to(dtype)


def decoder_stack_plain(out0, emb0, qpos, mems: Sequence[torch.Tensor],
                        pes: Sequence[torch.Tensor],
                        feats: Sequence[torch.Tensor],
                        layers: Sequence[LayerWeights], head: HeadWeights,
                        *, num_heads: int, return_logits: bool = False,
                        blocked=None):
    """Plain PyTorch version: final (B, Q, C) query state in D (and, with
    ``return_logits``, every layer's f32 mask logits ``emb . feat^T``).
    ``blocked``: per-layer (B, Q, T) positions to block instead of the ones
    the logits give (to hold the kernel's arithmetic against this version
    apart from its threshold decisions)."""
    dtype = out0.dtype
    nl = len(mems)
    x32 = out0.float()
    emb = emb0.float()
    qp = qpos.float()
    logits = []
    for li, lw in enumerate(layers):
        lvl = li % nl
        m = emb @ feats[lvl].float().transpose(-1, -2)
        logits.append(m)
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
        emb = mask_embed(x32, head, dtype).float()
    out = x32.to(dtype)
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
SPLIT_MAXR = 32  # rows a block of the split instance owns at most
SPLIT_TK = 32  # keys a tile of the split instance
SMEM_LIMIT = 227 * 1024  # shared memory a block may use on the H100


def split_cluster(q: int) -> int:
    """Blocks of a cluster of the split instance (``ds2_cluster``): 8 while
    a block's ceil(Q/8) rows fit :data:`SPLIT_MAXR`, else 16 (Q up to
    512)."""
    return 8 if -(-q // 8) <= SPLIT_MAXR else 16


def split_layout(q: int, c: int, heads: int, t_max: int,
                 f32: bool = True) -> Tuple[int, int]:
    """(bytes, QC): the shared memory of one block of the split instance
    and the self-attention's keys a chunk, as ``csrc/decoder_split.cu::
    ds2_layout`` lays it out (4-byte words, every part 16-byte aligned):
    its R = ceil(Q/cs) rows of X, XA, QB and OB (row stride C + 16), the
    mask bits of its rows against all keys, its row flags, then one area
    that holds in turn the cross-attention's key-tile slots (k or v of 32
    keys: f32 at stride C + 16, bf16 C + 8; two buffers of k and v where
    they fit in 227 KB, else one), the bf16 q copy (ceil(R/16) 16-row
    tiles) and the (max, sum) exchange of 8 warps x the padded rows, and
    the self-attention's own k rows, one head's k (then v) of QC rows and
    the (R, QC) scores: QC = Q where that fits, else the most keys, a
    multiple of 32, that do (two sweeps over the chunks)."""
    def al(n):
        return -(-n // 4) * 4
    r, ld, hd = -(-q // split_cluster(q)), c + 16, c // heads
    rp = 16 * -(-r // 16)
    rx = r * ld
    area = 4 * rx + al(r * -(-t_max // 32)) + al(r)
    slot = SPLIT_TK * (c + 16) if f32 else SPLIT_TK * (c + 8) // 2
    qt = 0 if f32 else rp * (c + 8) // 2
    self_attn = rx + q * (hd + 1) + r * q
    for buffers in (2, 1):
        cross = 2 * buffers * slot + qt + 2 * SPLIT_WARPS * rp
        total = 4 * (area + al(max(cross, self_attn)))
        if total <= SMEM_LIMIT:
            return total, q
    qc = (SMEM_LIMIT // 4 - area - rx) // (hd + 1 + r) // 32 * 32
    if 32 <= qc < q:
        total = 4 * (area + al(max(cross, rx + qc * (hd + 1) + r * qc)))
        return total, qc
    return total, q


def smem_bytes_split(q: int, c: int, heads: int, t_max: int,
                     f32: bool = True) -> int:
    """Shared memory of one block of the split instance
    (:func:`split_layout`)."""
    return split_layout(q, c, heads, t_max, f32)[0]


SPLIT_HEAD_DIMS = (8, 16, 32, 64)  # the split kernel's HD instances
SPLIT_ONE_HEAD_DIMS = (64, 128, 256)  # its one-head instances (HD = C)


def split_refusal(q: int, c: int, ffn: int, heads: int, nl: int,
                  n_layers: int, t_max: int,
                  f32: bool = True) -> Optional[str]:
    """Why the split instance does not take these shapes (the C entry
    point's own check), or None where it does: C a multiple of 64 (32-deep
    product chunks, 16 output columns a warp), the FFN's hidden units in
    chunks of C, one head of a width in :data:`SPLIT_ONE_HEAD_DIMS` (the 8
    warps split its output columns), or 2, 4 or 8 heads (a head's warps
    split each key tile) or a multiple of 8 (rounds of 8 heads) of a width
    in :data:`SPLIT_HEAD_DIMS`, at most 32 rows a block in clusters of 8
    or 16 (Q <= 512), and the shared memory of :func:`split_layout`."""
    smem = smem_bytes_split(q, c, heads, t_max, f32) if heads >= 1 else 0
    if heads == 1:
        width_ok = c in SPLIT_ONE_HEAD_DIMS
    else:
        width_ok = (heads > 1 and not (SPLIT_WARPS % heads and heads % 8)
                    and c % heads == 0 and c // heads in SPLIT_HEAD_DIMS)
    if (q < 1 or c % 64 or ffn % c or not width_ok
            or n_layers % nl or nl > 3
            or -(-q // split_cluster(q)) > SPLIT_MAXR
            or smem > SMEM_LIMIT):
        return (f"decoder stack split instance: unsupported shape Q={q} "
                f"C={c} FFN={ffn} heads={heads} levels={nl} "
                f"layers={n_layers} keys={t_max} ({smem} B of shared memory "
                f"a block, limit {SMEM_LIMIT})")
    return None


def check_shape_split(q: int, c: int, ffn: int, heads: int, nl: int,
                      n_layers: int, t_max: int, f32: bool = True) -> None:
    """Raise with :func:`split_refusal`'s reason, if any."""
    reason = split_refusal(q, c, ffn, heads, nl, n_layers, t_max, f32)
    if reason:
        raise ValueError(reason)


def flagship_takes(q: int, c: int, ffn: int, heads: int, nl: int,
                   n_layers: int, t_max: int, dtype) -> bool:
    """True iff the flagship instance takes this call: bf16, the widths of
    :func:`check_shape` and its shared memory. Every other call goes to
    the split instance."""
    if dtype != torch.bfloat16:
        return False
    try:
        check_shape(q, c, ffn, heads, nl, n_layers)
    except ValueError:
        return False
    return smem_bytes(q, c, t_max) <= SMEM_LIMIT


def decoder_stack_refusal(q: int, c: int, ffn: int, heads: int, nl: int,
                          n_layers: int, t_max: int, dtype) -> Optional[str]:
    """Why :func:`decoder_stack` launches no kernel for these shapes on a
    CUDA device, or None where it launches one: bf16 or f32, and the
    flagship instance (:func:`flagship_takes`) or the split instance
    (:func:`split_refusal`) takes them."""
    if dtype not in (torch.bfloat16, torch.float32):
        return f"the decoder stack kernels take bf16 or f32; got {dtype}"
    if flagship_takes(q, c, ffn, heads, nl, n_layers, t_max, dtype):
        return None
    return split_refusal(q, c, ffn, heads, nl, n_layers, t_max,
                         dtype == torch.float32)


def split_instance(q: int, heads: int, f32: bool) -> str:
    """The name a split launch counts under: ``split_tc_f32`` or
    ``split_tc_bf16``, with ``_cs16`` in clusters of 16 (Q > 256),
    ``_heads1`` for one head (its columns split over the warps) and
    ``_heads<n>`` for rounds of 8 heads (more than 8)."""
    name = "split_tc_" + ("f32" if f32 else "bf16")
    if split_cluster(q) > 8:
        name += "_cs16"
    if heads == 1 or heads > SPLIT_WARPS:
        name += f"_heads{heads}"
    return name


SPLIT_PARTS = ("mask bits", "q projection", "cross-attention",
               "out projection + LN1", "self-attention + LN2", "FFN + LN3",
               "mask MLP")  # the parts ``profile`` times, in its order


def decoder_stack(out0, emb0, qpos, mems, pes, feats,
                  layers: Sequence[LayerWeights], head: HeadWeights, *,
                  num_heads: int, packed=None, return_bits: bool = False,
                  profile=None):
    """Final (B, Q, C) query state: the CUDA chain for CUDA tensors (the
    flagship instance where :func:`flagship_takes`, else the split
    instance), the plain version for CPU tensors. ``packed``: cached
    ``({}, kv_weights(...))``, its dict filled with each instance's
    ``pack_weights`` at first use. ``return_bits`` (CUDA only):
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
    if emb0.shape[-1] != c:
        raise ValueError(f"decoder stack kernel: emb0 width "
                         f"{emb0.shape[-1]} != C={c}")
    t = [m.shape[1] for m in mems]
    reason = decoder_stack_refusal(q, c, ffn, num_heads, nl, n_layers,
                                   max(t), dt)
    if reason:
        raise ValueError(reason)
    flagship = flagship_takes(q, c, ffn, num_heads, nl, n_layers, max(t), dt)
    if profile is not None:
        if flagship:
            raise ValueError("profile: only the split instance is timed")
        kb.check_cuda(profile, "profile", torch.int64,
                      (b * split_cluster(q), len(SPLIT_PARTS)))
    if flagship:
        smem = smem_bytes(q, c, max(t))
    else:
        f32 = dt == torch.float32
        smem = smem_bytes_split(q, c, num_heads, max(t), f32)
    kind = "flagship" if flagship else "split"
    if packed is None:
        packed = ({}, kv_weights(layers, nl))
    wpacks, kvw = packed
    if kind not in wpacks:
        wpacks[kind] = pack_weights(layers, head, fragments=flagship)
    wd, wf = wpacks[kind]
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
    feats = [f.float().contiguous() for f in feats]
    for lvl, f in enumerate(feats):
        kb.check_cuda(f, f"feats[{lvl}]", torch.float32, (b, t[lvl], c))
    x0 = out0.float().contiguous()
    e0 = emb0.float().contiguous()
    qp = qpos.float().contiguous()
    out = torch.empty((b, q, c), dtype=dt, device=out0.device)
    words = (max(t) + 31) // 32
    bits = (torch.empty((b, n_layers, q, words), dtype=torch.int32,
                        device=out0.device) if return_bits else None)
    ptrs = (ctypes.c_void_p * 9)(*(
        [k.data_ptr() for k in ks] + [0] * (3 - nl)
        + [v.data_ptr() for v in vs] + [0] * (3 - nl)
        + [f.data_ptr() for f in feats] + [0] * (3 - nl)))
    tarr = (ctypes.c_int * 3)(*(t + [0] * (3 - nl)))
    if flagship:
        kb.launch("decoder_stack", "decoder_stack_forward", kb.ptr(x0),
                  kb.ptr(e0), kb.ptr(qp), ptrs, tarr, kb.ci(nl),
                  kb.ci(groups), kb.ptr(wd), kb.ptr(wf), kb.ptr(out),
                  kb.ptr(bits), kb.ci(b), kb.ci(q), kb.ci(c), kb.ci(ffn),
                  kb.ci(num_heads), kb.ci(smem), kb.cf(hd ** -0.5),
                  kb.stream(), instance="flagship")
    else:
        kb.launch("decoder_stack", "decoder_split_forward", kb.ptr(x0),
                  kb.ptr(e0), kb.ptr(qp), ptrs, tarr, kb.ci(nl),
                  kb.ci(groups), kb.ptr(wd), kb.ptr(wf), kb.ptr(out),
                  kb.ptr(bits), kb.ptr(profile), kb.ci(b), kb.ci(q),
                  kb.ci(c), kb.ci(ffn), kb.ci(num_heads), kb.ci(smem),
                  kb.cf(hd ** -0.5), kb.ci(f32), kb.stream(),
                  instance=split_instance(q, num_heads, f32))
    if not return_bits:
        return out
    shifts = torch.arange(32, device=out0.device, dtype=torch.int32)
    unpacked = ((bits[..., None] >> shifts) & 1).bool().reshape(
        b, n_layers, q, words * 32)
    return out, [unpacked[:, li, :, :t[li % nl]] for li in range(n_layers)]
