"""The shipped configurations' shapes on the port, on the CPU.

* The whole model against the JAX package at more than 48 queries (the
  flagship decoder instance's limit) and 3 point columns, as Waymo's
  ``waymo_default()`` has (170 queries, x/y/z), at tiny widths in f32:
  1e-3 absolute on the final logits (the same f32 arithmetic in another
  order), with the decoder stack kernel's path (``use_pallas_head=True``)
  and with the per-layer decoder (``use_pallas_head=False``), which must
  then be the path taken.
* The split decoder instance's shape check and shared-memory budget
  (``ops/decoder_stack.py``), at Waymo's and the flagship's shapes, in the
  manner of ``test_torch_port_layouts.py``: the wrapper's choice of
  instance is made in Python, so it is held here without a card.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from mask_bev_tpu.models.maskbev import MaskBev as JaxMaskBev  # noqa: E402
from mask_bev_tpu.utils.precision import apply_compute_dtype  # noqa: E402
from mask_bev_tpu_torch.config import (  # noqa: E402
    semantic_kitti_default, tiny_test_config, waymo_default)
from mask_bev_tpu_torch.models import mask2former as m2f  # noqa: E402
from mask_bev_tpu_torch.models.convert import load_flax  # noqa: E402
from mask_bev_tpu_torch.models.maskbev import MaskBev  # noqa: E402
from mask_bev_tpu_torch.ops import decoder_stack as kdec  # noqa: E402
from test_torch_port_model import _scans, _variables  # noqa: E402

WIDE = dict(num_queries=64, pc_point_dim=3)


def _counting(monkeypatch, calls):
    stack = m2f.decoder_stack
    layer_fwd = m2f.DecoderLayer.forward

    def count_stack(*a, **kw):
        calls["stack"] = calls.get("stack", 0) + 1
        return stack(*a, **kw)

    def count_layer(self, *a, **kw):
        calls["layer"] = calls.get("layer", 0) + 1
        return layer_fwd(self, *a, **kw)
    monkeypatch.setattr(m2f, "decoder_stack", count_stack)
    monkeypatch.setattr(m2f.DecoderLayer, "forward", count_layer)


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["decoder_stack", "per_layer"])
def test_wide_queries_three_columns_match_jax(monkeypatch, use_kernel):
    kw = dict(WIDE, use_pallas_head=use_kernel)
    jcfg = jax_tiny().replace(**kw)
    h, w = jcfg.grid_hw
    jcfg = jcfg.replace(max_num_pillars=h * w)
    pts, mask = _scans(jcfg)
    pts = np.ascontiguousarray(pts[..., :3])
    v = _variables(jcfg, pts, mask)
    want = JaxMaskBev(jcfg).apply(
        apply_compute_dtype(v, jcfg), jnp.asarray(pts), jnp.asarray(mask),
        train=False, final_only=True)
    cfg = tiny_test_config().replace(max_num_pillars=h * w, **kw)
    model = load_flax(MaskBev(cfg), v)
    calls = {}
    _counting(monkeypatch, calls)
    with torch.no_grad():
        got = model(torch.as_tensor(pts), torch.as_tensor(mask))
    n_layers = cfg.head_num_decoder_layers
    if use_kernel:
        assert calls == {"stack": 1}
    else:
        assert calls == {"layer": n_layers}
    gc = got.cls_logits.float().numpy()
    gm = got.mask_logits.float().numpy()
    wc = np.asarray(want.cls_logits, np.float32)
    wm = np.asarray(want.mask_logits, np.float32)
    assert gc.shape == wc.shape == (1, 2, 64, cfg.head_num_classes + 1)
    assert gm.shape == wm.shape
    np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-3)
    np.testing.assert_allclose(gm, wm, rtol=0, atol=1e-3)


def test_per_layer_path_equals_the_stack_plain_version():
    """The per-layer decoder and the stack's plain version compute the same
    function (the stack's plain version rounds in the kernel's places, the
    per-layer decoder in XLA's; equal in f32 within f32 rounding)."""
    cfg = tiny_test_config().replace(**WIDE)
    sd = MaskBev(cfg).random_state_dict(3)
    dec = MaskBev(cfg).decoder
    dec.load_state_dict({k[len("decoder."):]: t for k, t in sd.items()
                         if k.startswith("decoder.")})
    g = torch.Generator().manual_seed(4)
    c = cfg.head_feat_channels
    mf = torch.randn(2, 20, 20, c, generator=g)
    mems = [torch.randn(2, s, s, c, generator=g) for s in (3, 5, 10)]
    with torch.no_grad():
        a = dec(mf, mems, final_only=True)
        dec.use_kernel = False
        b = dec(mf, mems, final_only=True)
    np.testing.assert_allclose(a.cls_logits.numpy(), b.cls_logits.numpy(),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(a.mask_logits.numpy(), b.mask_logits.numpy(),
                               rtol=0, atol=1e-4)


# ---- the split instance's shapes and shared memory -------------------------

WAYMO = dict(q=170, c=256, ffn=2048, heads=8, nl=3, n_layers=9, t_max=3969)
FLAG = dict(WAYMO, q=45)


def test_shipped_configs_have_the_shapes_checked_here():
    for cfg, q in ((waymo_default(), 170), (semantic_kitti_default(), 45)):
        assert cfg.num_queries == q and cfg.compute_dtype == "float32"
        assert (cfg.head_feat_channels, cfg.head_num_attn_heads,
                cfg.head_ffn_dim, cfg.head_num_decoder_layers) == (
                    256, 8, 2048, 9)
        # the /8 memory of a 500x500 grid: 63 x 63 keys
        h, w = cfg.grid_hw
        assert -(-h // 8) * -(-w // 8) == WAYMO["t_max"]
        # both fit the split instance's layout, in f32 and in bf16
        for f32 in (True, False):
            kdec.check_shape_split(q, 256, 2048, 8, 3, 9, WAYMO["t_max"],
                                   f32=f32)
            assert kdec.smem_bytes_split(q, 256, 8, WAYMO["t_max"],
                                         f32) <= kdec.SMEM_LIMIT


@pytest.mark.parametrize("dtype,q,want", [
    (torch.bfloat16, 45, True),    # the bf16 main path keeps PR 5's instance
    (torch.float32, 45, False),    # the shipped dtype: split
    (torch.bfloat16, 170, False),  # Waymo's queries: split in either dtype
    (torch.float32, 170, False),
])
def test_instance_choice(dtype, q, want):
    s = dict(WAYMO, q=q)
    assert kdec.flagship_takes(s["q"], s["c"], s["ffn"], s["heads"], s["nl"],
                               s["n_layers"], s["t_max"], dtype) is want


# the wider shapes: 300 and 512 queries (clusters of 16; 512 with the
# self-attention in key chunks), one head, 16 heads
WIDER_SHAPES = [dict(WAYMO, q=300), dict(WAYMO, q=512),
               dict(FLAG, heads=1), dict(FLAG, heads=16)]
WIDER_IDS = ["q300", "q512", "heads1", "heads16"]


@pytest.mark.parametrize("shape", [WAYMO, FLAG,
                                   dict(WAYMO, c=128, heads=4, ffn=512),
                                   dict(WAYMO, heads=4),  # head width 64
                                   dict(WAYMO, q=8, c=64, heads=2, ffn=128,
                                        n_layers=3, t_max=100)] + WIDER_SHAPES,
                         ids=["waymo", "flagship", "c128", "hd64",
                              "tiny"] + WIDER_IDS)
def test_split_shape_check_takes(shape):
    kdec.check_shape_split(**shape)


@pytest.mark.parametrize("shape", [WAYMO, FLAG,
                                   dict(WAYMO, c=128, heads=4, ffn=512),
                                   dict(WAYMO, heads=4),
                                   dict(WAYMO, q=8, c=64, heads=2, ffn=128,
                                        n_layers=3, t_max=100)] + WIDER_SHAPES,
                         ids=["waymo", "flagship", "c128", "hd64",
                              "tiny"] + WIDER_IDS)
def test_split_shape_check_takes_bf16(shape):
    """The bf16 instance (Waymo's queries in bf16) takes the same shapes."""
    kdec.check_shape_split(**shape, f32=False)


@pytest.mark.parametrize("shape", [
    # 8 heads of C 4096: width 512 (16 heads of C 2048, width 128, and 16
    # of C 4096, width 256, are taken)
    dict(WAYMO, c=4096, heads=8),
    dict(WAYMO, q=1025),             # 65 rows a block in clusters of 16
    # 16 heads of 64 at C 1024: the f32 key tiles of 32 keys x C (one
    # buffer of k and v) pass 227 KB even with the rows in the workspace
    dict(WAYMO, c=1024, heads=16),
    # no hidden unit (any other FFN runs padded to whole chunks of C)
    dict(WAYMO, ffn=0),
    dict(WAYMO, q=256, t_max=16 * 3969),  # mask bits of 32 rows: > 227 KB
], ids=["hd16", "rows", "width", "ffn", "smem"])
def test_split_shape_check_rejects(shape):
    with pytest.raises(ValueError, match="split instance"):
        kdec.check_shape_split(**shape)


def test_split_smem_budget():
    """Waymo fits a block: 4 replicas of 22 rows at stride C + 16 (95,744
    B), the mask bits of 22 rows x 125 words (11,008 B, aligned to 16), the
    row flags, and the cross-attention area: one buffer of f32 k and v
    tiles (two 32-key slots at stride C + 16, 69,632 B; two buffers would
    pass 227 KB) and the (max, sum) exchange of 8 warps x 32 padded rows,
    which is larger than the self-attention's (own k, one head's k then v
    of all 170 rows, 22 x 170 scores: 61,336 B)."""
    s = WAYMO
    got = kdec.smem_bytes_split(s["q"], s["c"], s["heads"], s["t_max"])
    rx = 22 * 272
    area = 4 * rx + 2752 + 24
    slot = 32 * 272
    self_area = rx + 170 * 33 + 22 * 170
    assert self_area < 2 * slot + 512
    assert 4 * (area + 4 * slot + 512) > kdec.SMEM_LIMIT
    assert got == 4 * (area + 2 * slot + 512) == 178528
    # the bf16 instance at Waymo's shapes: two buffers of bf16 k and v
    # tiles, the bf16 q copy and the exchange
    bf = kdec.smem_bytes_split(170, 256, 8, 3969, f32=False)
    assert bf == 4 * (area + 4 * 32 * 132 + 32 * 132 + 512) == 193376
    assert bf <= kdec.SMEM_LIMIT
    # head width 64 at Waymo's shapes: the self-attention area is larger
    hd64 = kdec.smem_bytes_split(170, 256, 4, 3969)
    assert hd64 == 4 * (area + rx + 170 * 65 + 22 * 170 + 2)
    assert hd64 <= kdec.SMEM_LIMIT
    # the flagship's shapes in f32 take the split instance with two buffers
    flag = kdec.smem_bytes_split(45, 256, 8, 3969)
    assert flag == 4 * (4 * 6 * 272 + 752 + 8 + 4 * slot + 2 * 8 * 16)
    assert flag <= kdec.SMEM_LIMIT
    # the bits grow with the keys
    assert kdec.smem_bytes_split(170, 256, 8, 2 * 3969) > got
