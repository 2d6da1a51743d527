"""The refusal audit's last reachable entries (kernel 8's embed widths,
kernels 1 and 10 past 128 points a pillar and past a block's shared memory,
the decoder's split instance at any C, FFN and head count), on the CPU.

* The rules take the new domain and refuse the rest, each with its reason:
  E from 1 to 256 (not 257); any K from 1 (the tiles up to 128 points a
  pillar, the layered route beside them or alone) and two layers of 256
  units (not 257 units or 9 layers); the split instance at C 32 to 256 in
  steps of 32 over every head count up to a head width of 64, and one head
  (not 513 queries, a head width of 128 at 2 heads, or C 288 at one head).
* The padded layouts give the true function in float64, within 1e-12:
  kernel 8's weight, bias and LN affine padded to the next instance (the
  statistics over the true E); the decoder's heads, head width and FFN
  padded (its LNs over the true columns, its scale the true width's); the
  layered route's row plan (``layered_directory``: each pillar's first K
  sorted points, in order, at rows of their own).
* The plain route against the JAX package in f32, on the same variables
  (``load_flax``) and inputs drawn from a seed with numpy: the encoder at
  K 129 and 256 and at two layers of 256 units (feat channels 512, 256)
  against the JAX XLA encoder (1e-5 absolute on the normalised canvas,
  ``test_torch_port_encoder.py``'s tolerance); the patch embed at E 72
  against ``fused_patch_embed(interpret=True)`` (1e-5 of the largest
  value); the ``final_only`` decoder at C 96 over 8 heads with an FFN of
  2048 and at C 192 over 6 heads against the JAX decoder (1e-4 absolute on
  the final logits, ``test_torch_port_heads.py``'s).
* ``chip_smoke.py``'s ``.rest`` row passes every rule at full width.
* A canvas of 100 channels with ``fuse_patch_embed`` goes to kernel 8 in
  neither package (the slot path needs a multiple of 128 channels), so
  kernel 8's whole-K-slice condition cannot be reached.
"""
import importlib.util
import pathlib
import unittest.mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.config import (  # noqa: E402
    semantic_kitti_default as jax_semantic_kitti)
from mask_bev_tpu.models.encoder import (  # noqa: E402
    MaskBevEncoder as JaxEncoder)
from mask_bev_tpu.models.mask2former import (  # noqa: E402
    Mask2FormerDecoder as JaxDecoder)
from mask_bev_tpu.models.maskbev import MaskBev as JaxMaskBev  # noqa: E402
from mask_bev_tpu.ops.pallas_patch_embed import (  # noqa: E402
    fused_patch_embed)
from mask_bev_tpu_torch.config import semantic_kitti_default  # noqa: E402
from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402
from mask_bev_tpu_torch.models.convert import load_flax  # noqa: E402
from mask_bev_tpu_torch.models.encoder import MaskBevEncoder  # noqa: E402
from mask_bev_tpu_torch.models.mask2former import (  # noqa: E402
    Mask2FormerDecoder)
from mask_bev_tpu_torch.models.maskbev import MaskBev  # noqa: E402
from mask_bev_tpu_torch.ops import decoder_stack as kdec  # noqa: E402
from mask_bev_tpu_torch.ops import patch_embed as kpe  # noqa: E402
from mask_bev_tpu_torch.ops import pfn as kpfn  # noqa: E402
from mask_bev_tpu_torch.ops.stream_pillars import (  # noqa: E402
    pillarize_stream_packed)
from test_torch_port_shapes import refusals  # noqa: E402
from test_torch_port_shapes_wide import _variables, long_pillars  # noqa: E402

BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64


def _dims(units, in0=10):
    out, d = [], in0
    for u in units:
        out.append((d, u))
        d = 2 * u
    return out


FLAGSHIP_PFN = _dims((64, 64, 128))


# ---- (a) the rules ----------------------------------------------------------


def test_patch_embed_takes_every_width_to_256():
    for dt in (BF16, F32):
        for e in range(1, 257):
            assert kpe.patch_embed_refusal(2, 32, 48, 128, e, 4, dt) is None
        reason = kpe.patch_embed_refusal(2, 32, 48, 128, 257, 4, dt)
        assert "E from 1 to 256" in reason
    assert [kpe.instance_width(e) for e in (1, 48, 49, 72, 97, 193, 256)] == \
        [48, 48, 64, 96, 128, 256, 256]
    assert kpe.instance(False, 72) == "bf16_e96"
    assert kpe.instance(True, 192) == "f32"
    # the padded instance's ring is the instance width's
    assert kpe.plan(8, 500, 500, 128, 72, 4, False) == kpe.plan(
        8, 500, 500, 128, 96, 4, False)


@pytest.mark.parametrize("k", [1, 32, 128, 129, 256, 1024, 4096])
def test_pfn_takes_any_points_a_pillar(k):
    for dt in (BF16, F32):
        for dims in (FLAGSHIP_PFN, _dims((256, 256))):
            assert kpfn.pfn_refusal(k, dims, 10, dt, dt) is None
            assert kpfn.stream_pfn_refusal(k, 4, dims, True, dt, dt,
                                           dt) is None
        tiles, layered = kpfn.route(k, FLAGSHIP_PFN, dt)
        assert (tiles, layered) == (min(k, 128), k > 128)
        # two layers of 256 units: the layered route alone
        assert kpfn.route(k, _dims((256, 256)), dt) == (None, True)


@pytest.mark.parametrize("dims,why", [
    (_dims((64, 257)), "1 to 256 units"), (_dims((32,) * 9), "1 to 8 layers"),
    (FLAGSHIP_PFN, "at least 1 point")], ids=["257-units", "9-layers", "k0"])
def test_pfn_still_refuses_the_rest(dims, why):
    k = 0 if why.startswith("at least") else 129
    assert why in kpfn.pfn_refusal(k, dims, 10, BF16, BF16)
    assert why in kpfn.stream_pfn_refusal(k, 4, dims, True, BF16, BF16,
                                          BF16)


def _split_domain():
    for c in range(32, 257, 32):
        yield c, 1
        for heads in range(2, c + 1):
            if c % heads == 0 and c // heads <= 64:
                yield c, heads


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
def test_split_takes_every_c_and_head_count(f32):
    """C 32 to 256 in steps of 32, over one head and every head count up to
    a head width of 64, at the main path's queries and memories, with the
    default FFN of 2048 and one that is no multiple of C: all taken but
    where the shared memory rule refuses the padded shape even with the rows
    in the device-memory workspace, head widths of 1 and 2 at 112 heads or
    more (padded to width 8: key tiles of 32 keys at C 896 to 2048 in f32,
    1536 to 2048 in bf16); the rows move to the workspace only at widths of
    1 and 2 at 80 heads or more."""
    taken = 0
    for c, heads in _split_domain():
        hp, hdp, fp = kdec.split_padding(c, heads, 1000)
        assert hp * hdp % 64 == 0 and fp % (hp * hdp) == 0 and fp >= 1000
        assert hp >= heads and hdp >= c // heads
        for ffn in (2048, 1000):
            reason = kdec.split_refusal(45, c, ffn, heads, 3, 9, 3969, f32)
            if reason is None:
                taken += 1
                continue
            assert "B of shared memory" in reason
            assert c // heads <= 2 and heads >= 112
            assert hp * hdp >= (896 if f32 else 1536)
        if kdec.split_plan(45, hp * hdp, hp, 3969, f32).glob:
            assert c // heads <= 2 and heads >= 80 and hp * hdp >= 640
    assert taken == 2 * 76 - 2 * (7 if f32 else 3)


@pytest.mark.parametrize("shape,why", [
    (dict(q=513, c=256, heads=8), None),
    (dict(q=45, c=256, heads=2), None),
    (dict(q=45, c=288, heads=1), None),
    (dict(q=1025, c=256, heads=8), "Q=1025"),
    (dict(q=45, c=528, heads=2), "heads=2"),
    (dict(q=45, c=576, heads=1), "C=576")],
    ids=["q513", "hd128", "c288", "q1025", "hd264", "c576"])
def test_split_still_refuses_the_rest(shape, why):
    """513 queries, a head width of 128 at 2 heads and one head of C 288
    (the refusals of the first audit) are taken; 1025 queries, a head width
    of 264 at 2 heads and one head of C 576 are still refused, each with
    the rule's reason."""
    reason = kdec.split_refusal(ffn=2048, nl=3, n_layers=9, t_max=3969,
                                **shape)
    if why is None:
        assert reason is None
        return
    assert "split instance" in reason and why in reason
    assert "one head up to C 512, else head widths up to 256" in reason
    assert "Q up to 1024" in reason


def test_split_keeps_the_shapes_it_took():
    """Shapes the instances take are not padded: the same instance."""
    for c, heads, ffn in ((256, 8, 2048), (64, 8, 128), (256, 1, 2048),
                          (256, 16, 2048), (128, 4, 512)):
        assert kdec.split_padding(c, heads, ffn) == (heads, c // heads, ffn)
        assert not kdec.split_instance(45, heads, True, c, ffn).endswith(
            "_padded")
    assert kdec.split_instance(45, 8, False, 96, 2048) == \
        "split_tc_bf16_padded"
    assert kdec.split_instance(45, 1, True, 96, 2048) == \
        "split_tc_f32_heads1_padded"
    assert kdec.split_padding(192, 6, 2048) == (8, 32, 2048)
    assert kdec.split_padding(96, 8, 2048) == (8, 16, 2048)


# ---- (b) the padded layouts in float64 --------------------------------------


def _embed64(canvas, wm, bias, ln_w, ln_b, p, n=None, eps=1e-6):
    """Patch embed + LN in float64, the statistics over ``n`` columns (all
    where None): the padded instance's arithmetic."""
    b, h, w, c = canvas.shape
    gh, gw = h // p, w // p
    t = (canvas.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
         .reshape(b * gh * gw, p * p * c))
    y = t @ wm.t() + bias
    n = y.shape[-1] if n is None else n
    mean = y.sum(-1, keepdim=True) / n
    var = ((y * y).sum(-1, keepdim=True) / n - mean * mean).clamp(min=0)
    return y, (y - mean) * torch.rsqrt(var + eps) * ln_w + ln_b


@pytest.mark.parametrize("e", [1, 8, 72, 120, 168, 200])
def test_padded_embed_is_the_embed(e):
    rng = np.random.default_rng(e)
    canvas = torch.as_tensor(rng.normal(size=(2, 16, 24, 32)))
    wm = torch.as_tensor(rng.normal(size=(e, 16 * 32)) / 16)
    vecs = [torch.as_tensor(base + 0.1 * rng.normal(size=e))
            for base in (0.0, 1.0, 0.0)]
    _, want = _embed64(canvas, wm, *vecs, 4)
    padded = kpe.padded_embed(wm, *vecs)
    ep = kpe.instance_width(e)
    assert all(t.shape[0] == ep and bool((t[e:] == 0).all()) for t in padded)
    y, got = _embed64(canvas, *padded, 4, n=e)
    assert bool((y[:, e:] == 0).all())  # a padded column adds nothing
    np.testing.assert_allclose(got[:, :e].numpy(), want.numpy(), rtol=0,
                               atol=1e-12)


def _decoder64(out0, emb0, qpos, mems, pes, feats, layers, head, heads,
               scale, cols=None):
    """The final-only decoder in float64 with no rounding: its LNs over
    ``cols`` (every column where None), attention scaled by ``scale``."""
    def ln(x, w, b):
        xs = x if cols is None else x[..., cols]
        mean = xs.mean(-1, keepdim=True)
        var = ((xs - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-6) * w + b

    def attend(q, k, v, wo, bo, bias):
        b, nq, c = q.shape
        hd = c // heads

        def split(t):
            return t.reshape(b, -1, heads, hd).transpose(1, 2)
        s = split(q) * scale @ split(k).transpose(-1, -2)
        if bias is not None:
            s = s + bias[:, None]
        o = torch.softmax(s, dim=-1) @ split(v)
        return o.transpose(1, 2).reshape(b, nq, c) @ wo + bo

    x, emb, nl = out0, emb0, len(mems)
    for li, lw in enumerate(layers):
        lvl = li % nl
        m = emb @ feats[lvl].transpose(-1, -2)
        bias = torch.where(kdec.blocked_positions(m), kdec.NEG, 0.0)
        mem, pe = mems[lvl], pes[lvl]
        y = attend((x + qpos) @ lw.wq + lw.bq, (mem + pe) @ lw.wk + lw.bk,
                   mem @ lw.wv + lw.bv, lw.wo, lw.bo, bias)
        x = ln(x + y, lw.n1w, lw.n1b)
        xq = x + qpos
        y = attend(xq @ lw.sq + lw.sbq, xq @ lw.sk + lw.sbk,
                   x @ lw.sv + lw.sbv, lw.so, lw.sbo, None)
        x = ln(x + y, lw.n2w, lw.n2b)
        y = torch.relu(x @ lw.f1 + lw.fb1) @ lw.f2 + lw.fb2
        x = ln(x + y, lw.n3w, lw.n3b)
        z = ln(x, head.dnw, head.dnb)
        z = torch.relu(z @ head.m1 + head.mb1)
        z = torch.relu(z @ head.m2 + head.mb2)
        emb = z @ head.m3 + head.mb3
    return x


@pytest.mark.parametrize("c,heads,ffn", [(96, 8, 2048), (192, 6, 200),
                                         (96, 1, 300), (64, 16, 100),
                                         (160, 5, 500), (32, 32, 64)],
                         ids=["c96-8", "c192-6", "c96-1", "c64-16", "c160-5",
                              "c32-32"])
def test_padded_split_is_the_decoder(c, heads, ffn):
    """The padded model the split instance runs (``padded_split``: zero
    q/k/v columns, out-projection rows, heads and hidden units; LNs over
    the true columns, the true width's scale) gives the true decoder's
    final state in float64; its padded columns stay exact zeros."""
    from test_torch_port_kernels import _decoder_inputs

    hws = [(2, 2), (4, 4), (8, 7)]
    out0, emb0, qpos, mems, pes, feats, layers, head = _decoder_inputs(
        "cpu", F64, 10, c, heads, ffn, hws, b=2, n_layers=3, seed=c + heads)
    feats = [f.double() for f in feats]
    layers = [kdec.LayerWeights(*(t.double() for t in lw)) for lw in layers]
    head = kdec.HeadWeights(*(t.double() for t in head))
    scale = (c // heads) ** -0.5
    want = _decoder64(out0, emb0, qpos, mems, pes, feats, layers, head,
                      heads, scale)
    hp, hdp, fp = kdec.split_padding(c, heads, ffn)
    cp = hp * hdp
    col = kdec.padded_columns(c, heads, hdp)
    lp, hw = kdec.padded_split(layers, head, c, heads, ffn)
    assert lp[0].f1.shape == (cp, fp) and lp[0].wk.shape == (c, cp)

    def widen(x):
        out = x.new_zeros(*x.shape[:-1], cp)
        out[..., col] = x
        return out
    got = _decoder64(widen(out0), widen(emb0), widen(qpos), mems, pes,
                     [widen(f) for f in feats], lp, hw, hp, scale, cols=col)
    pad = torch.ones(cp, dtype=torch.bool)
    pad[col] = False
    assert bool((got[..., pad] == 0).all())
    np.testing.assert_allclose(got[..., col].numpy(), want.numpy(), rtol=0,
                               atol=1e-12)


GEO = dict(x_range=(-10.0, 10.0), y_range=(-10.0, 10.0),
           z_range=(-4.0, 4.0), voxel_size=0.5)
H = W = 40
PFN_KW = dict(point_dim=4, with_distance=True, grid_w=W, voxel_size=0.5,
              x0=-10.0, y0=-10.0)


def _layered64(ps, weights, all_pillars):
    """The layered route's function in float64, row by row on its own
    directory: a pillar's rows are gathered from ``starts`` in order into
    the rows ``lrow0`` gives, each layer's product on those rows, the max
    over each pillar's rows (the kernels' plan, on the CPU)."""
    x = kpfn.decorate(ps, point_dim=4, with_distance=True, grid_w=W,
                      voxel_size=0.5, x0=-10.0, y0=-10.0).double()
    lc, lrow0, tot = kpfn.layered_directory(ps.counts, ps.num_pillars,
                                            all_pillars)
    out = {}
    for b in range(x.shape[0]):
        pil = torch.nonzero(lc[b] > 0).flatten()
        n = lc[b, pil].long()
        seg = torch.repeat_interleave(torch.arange(len(pil)), n)
        first = torch.repeat_interleave(lrow0[b, pil].long(), n)
        offs = torch.arange(int(n.sum())) - first
        dest = first + offs
        src = torch.repeat_interleave(ps.starts[b, pil].long(), n) + offs
        assert int(tot[b]) == len(dest)
        assert torch.equal(torch.sort(dest).values, torch.arange(len(dest)))
        # every row on the route is a kept point of its own pillar
        assert bool(ps.kept[b, src].all())
        assert torch.equal(ps.seg[b, src], pil[seg])
        rows = torch.zeros(len(dest), x.shape[-1], dtype=F64)
        rows[dest] = x[b, src]
        seg_of = torch.zeros(len(dest), dtype=torch.long)
        seg_of[dest] = seg
        for li, (w, g, bb) in enumerate(weights):
            z = torch.relu(rows @ w.double() * g.double() + bb.double())
            pooled = torch.zeros(len(pil), z.shape[-1], dtype=F64)
            pooled.scatter_reduce_(0, seg_of[:, None].expand_as(z), z,
                                   reduce="amax", include_self=True)
            rows = (pooled if li == len(weights) - 1
                    else torch.cat([z, pooled[seg_of]], -1))
        out[b] = (pil, rows)
    return out


@pytest.mark.parametrize("k,all_pillars", [(129, False), (256, False),
                                           (32, True), (300, True)])
def test_layered_row_plan_is_the_pfn(k, all_pillars):
    """The layered route's directory (alone, or beside the tiles: only the
    pillars of more than 128 kept points) gives ``pfn_plain``'s rows in
    float64; the tiles beside it see each such pillar as one point."""
    pts, msk = long_pillars(k)
    ps = pillarize_stream_packed(torch.as_tensor(pts), torch.as_tensor(msk),
                                 max_points_per_pillar=k, **GEO)
    rng = np.random.default_rng(k)
    weights, d = [], 10
    for u in (12, 136):
        weights.append((torch.as_tensor(rng.normal(size=(d, u)) / d ** 0.5),
                        torch.as_tensor(1 + 0.1 * rng.normal(size=u)),
                        torch.as_tensor(0.1 * rng.normal(size=u))))
        d = 2 * u
    want, _ = kpfn.pfn_plain(ps, weights, out_dtype=F64, **PFN_KW)
    got = _layered64(ps, weights, all_pillars)
    n_route = 0
    for b, (pil, rows) in got.items():
        n_route += len(pil)
        np.testing.assert_allclose(rows.numpy(), want[b, pil].numpy(),
                                   rtol=0, atol=1e-12)
    assert n_route > 0
    if not all_pillars:
        assert n_route == int((ps.counts > 128).sum())
        tc = kpfn.tile_counts(ps.counts)
        assert int(tc.max()) <= 128
        assert bool((tc[ps.counts > 128] == 1).all())


# ---- (c) the plain route against the JAX package ----------------------------


def _encoders(fc, k, pts, msk):
    enc = JaxEncoder(feat_channels=fc, max_points_per_pillar=k,
                     max_pillars=H * W, pseudo_image_norm="full", **GEO)
    v = _variables(lambda: enc.init(jax.random.PRNGKey(1), jnp.asarray(pts),
                                    jnp.asarray(msk), train=False), k)
    port = load_flax(MaskBevEncoder(
        GEO["x_range"], GEO["y_range"], GEO["z_range"], GEO["voxel_size"],
        feat_channels=fc, max_points_per_pillar=k,
        pseudo_image_norm="full", max_pillars=H * W), v)
    return enc, v, port


@pytest.mark.parametrize("fc,k", [((16, 32), 129), ((16, 32), 256),
                                  ((512, 256), 32)],
                         ids=["k129", "k256", "u256x2"])
def test_encoder_matches_xla(fc, k):
    """The port's eval encoder on the CPU (the plain PFN on the capped
    stream: every cell kept) against the JAX XLA encoder, on scans whose
    pillars hold up to hundreds of points."""
    pts, msk = long_pillars(k + 1)
    enc, v, port = _encoders(fc, k, pts, msk)
    want = np.asarray(jax.jit(lambda v_, p_, m_: enc.apply(
        v_, p_, m_, train=False))(v, jnp.asarray(pts), jnp.asarray(msk)))
    tp, tm = torch.as_tensor(pts), torch.as_tensor(msk)
    ps = pillarize_stream_packed(tp, tm, max_points_per_pillar=k, **GEO)
    assert int((ps.counts > min(k - 1, 128)).sum()) >= 1
    with torch.no_grad():
        got = port(tp, tm).numpy()
    assert got.shape == want.shape == (2, H, W, fc[-1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_patch_embed_e72_matches_pallas():
    """Kernel 8's plain version at E 72 against the TPU kernel in
    interpret mode (the batch-minor flat canvas)."""
    b, h, w, c, e, p = 2, 16, 24, 16, 72, 4
    rng = np.random.default_rng(72)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    kern = (rng.normal(size=(p, p, c, e)) / np.sqrt(p * p * c)).astype(
        np.float32)
    vecs = [(base + 0.1 * rng.normal(size=e)).astype(np.float32)
            for base in (0.0, 1.0, 0.0)]
    flat = jnp.transpose(jnp.asarray(x), (1, 2, 0, 3)).reshape(h * w, b * c)
    want = np.asarray(fused_patch_embed(
        flat, jnp.asarray(kern), *(jnp.asarray(a) for a in vecs), h=h, w=w,
        bsz=b, patch=p, out_dtype=jnp.float32, interpret=True))
    wm = kpe.embed_matrix(torch.as_tensor(kern).permute(3, 2, 0, 1))
    got = kpe.patch_embed_plain(torch.as_tensor(x), wm,
                                *(torch.as_tensor(a) for a in vecs), p)
    assert tuple(got.shape) == want.shape == (b, (h // p) * (w // p), e)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("c,heads", [(96, 8), (192, 6)],
                         ids=["c96-8heads", "c192-6heads"])
def test_decoder_matches_xla(c, heads):
    """The decoder's plain final-only stack (the split instance's plain
    version) at C 96 over 8 heads (head width 12) and C 192 over 6, FFN
    2048, against the JAX decoder's XLA path."""
    rng = np.random.default_rng(c + heads)
    b, q = 2, 12
    mf = rng.normal(size=(b, 16, 16, c)).astype(np.float32)
    mems = [rng.normal(size=(b, hh, ww, c)).astype(np.float32)
            for (hh, ww) in [(2, 2), (4, 4), (8, 8)]]
    kw = dict(num_queries=q, num_classes=1, num_layers=3, feat_channels=c,
              out_channels=c, num_heads=heads, ffn_dim=2048)
    jd = JaxDecoder(**kw)
    v = _variables(lambda: jd.init(jax.random.PRNGKey(c), jnp.asarray(mf),
                                   [jnp.asarray(m) for m in mems],
                                   train=False), heads)
    want = jax.jit(lambda v_, mf_, ms_: jd.apply(
        v_, mf_, ms_, train=False, final_only=True))(
            v, jnp.asarray(mf), [jnp.asarray(m) for m in mems])
    dec = load_flax(Mask2FormerDecoder(**kw), v)
    with torch.no_grad():
        got = dec(torch.as_tensor(mf), [torch.as_tensor(m) for m in mems],
                  final_only=True)
    np.testing.assert_allclose(got.cls_logits.numpy(),
                               np.asarray(want.cls_logits), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.mask_logits.numpy(),
                               np.asarray(want.mask_logits), rtol=0,
                               atol=1e-4)


# ---- (d) the served row -----------------------------------------------------


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(kb.CSRC).parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rest_row_takes_every_kernel():
    """``.rest`` at full width and batch 8 (the models on the meta
    device): kernel 1 past 128 points a pillar, kernel 8 at E 72, the
    decoder at C 96 over 8 heads; every rule takes it, in bf16 and f32."""
    over = _smoke().REST
    assert over["max_num_points"] == 129 and over["head_feat_channels"] == 96
    cfg = semantic_kitti_default().replace(**over)
    assert (cfg.backbone_embed_dim, cfg.fuse_patch_embed) == (72, True)
    for dt in (BF16, F32):
        got = refusals(cfg, 8, dt)
        assert set(got) == {"pfn", "canvas_norm", "patch_embed",
                            "swin_block", "decoder_stack"}
        assert all(r is None for r in got.values()), got
    assert kpfn.route(129, FLAGSHIP_PFN, BF16) == (128, True)
    assert kpe.instance(False, 72) == "bf16_e96"
    assert kdec.split_instance(45, 8, False, 96, 2048).endswith("_padded")


# ---- (e) kernel 8's K-slice condition cannot be reached ---------------------


@pytest.mark.parametrize("channels", [100, 128])
def test_flat_embed_needs_128_channel_canvas(channels):
    """With ``fuse_patch_embed``, a canvas of 100 channels takes the
    plain conv in both packages (the JAX gate read as on a TPU); 128 takes
    kernel 8."""
    over = dict(fuse_patch_embed=True,
                encoder_feat_channels=(128, 128, channels))
    with torch.device("meta"):
        port = MaskBev(semantic_kitti_default().replace(**over))
    jm = JaxMaskBev(jax_semantic_kitti().replace(**over)).bind({})
    with unittest.mock.patch.object(jax, "default_backend", lambda: "tpu"):
        ref = jm._flat_embed_ok(False)
    assert port.flat_embed_ok(False) == ref == (channels % 128 == 0)
