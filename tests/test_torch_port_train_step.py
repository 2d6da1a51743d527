"""The port's training step against the JAX package's: the whole training
forward (all L+1 head passes), the loss with every random draw pinned, its
gradients, the running statistics, one AdamW step, and the synthetic data.

Both packages run ``tiny_test_config()`` with a pillar cap that cuts
occupied cells, on the same weights (``models/convert.py::from_flax``) and
the same batch. Tolerances:
* f32: logits to 1e-4 absolute (values up to ~12: the same f32 arithmetic
  in another order through ~20 layers), the loss to 1e-5 relative, each
  gradient leaf to 1e-4 of its largest magnitude, the running statistics
  to 1e-4 relative;
* bf16 forward: the two frameworks round to bf16 at different places and
  the difference grows through the layers, and a mask logit near 0 can
  flip an attention-bias decision: mean mask-logit error 10 % of the mean
  magnitude, 95 % of signs agree, class logits to 0.5;
* AdamW and Adam against optax in f32: 1e-6 of each leaf's magnitude (the
  same f32 operations; the bias corrections' powers may round apart);
* the synthetic batches bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from mask_bev_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from mask_bev_tpu.datasets.synthetic import (  # noqa: E402
    make_batch as jax_make_batch)
from mask_bev_tpu.losses import layer_losses  # noqa: E402
from mask_bev_tpu.models.maskbev import MaskBev as JaxMaskBev  # noqa: E402
from mask_bev_tpu.utils.precision import cast_float_leaves  # noqa: E402
from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.datasets.synthetic import make_batch  # noqa: E402
from mask_bev_tpu_torch.models.convert import from_flax  # noqa: E402
from mask_bev_tpu_torch.ops.stream_pillars import fuse_pid  # noqa: E402
from mask_bev_tpu_torch.train.optim import Adam  # noqa: E402
from mask_bev_tpu_torch.train.step import (  # noqa: E402
    create_train_state, loss_and_grads, train_step)
from mask_bev_tpu_torch.utils.precision import cast_parameters  # noqa: E402

KW = dict(max_num_pillars=256, head_num_points=64, loss_gt_crop=48)
B = 2


def _variables(cfg, pts, mask, seed=1):
    """Random flax variables of the right tree (shapes from ``eval_shape``,
    values from numpy), at trained-model scales."""
    shapes = jax.eval_shape(lambda: JaxMaskBev(cfg).init(
        jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask),
        train=False))
    rng = np.random.default_rng(seed)

    def value(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        r = rng.normal(size=s.shape).astype(np.float32)
        if name == "var":
            return (0.5 + rng.uniform(size=s.shape)).astype(np.float32)
        if name in ("mean", "bias"):
            return 0.05 * r
        if name == "scale":
            return 1.0 + 0.1 * r
        if name == "kernel":
            return r / np.sqrt(np.prod(s.shape[:-1]))
        if name == "rel_pos_bias_table":
            return 0.02 * r
        return r
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(value(p, s), np.float32), shapes)


@pytest.fixture(scope="module")
def case():
    jcfg = jax_tiny().replace(**KW)
    tcfg = tiny_test_config().replace(**KW)
    batch = jax_make_batch(np.random.default_rng(0), jcfg, batch_size=B,
                           noise_points=1200)
    v = _variables(jcfg, batch["points"], batch["point_mask"])
    pid = fuse_pid(torch.as_tensor(batch["points"]),
                   torch.as_tensor(batch["point_mask"]),
                   x_range=tcfg.x_range, y_range=tcfg.y_range,
                   z_range=tcfg.z_range, voxel_size=tcfg.voxel_size)
    h, w = tcfg.grid_hw
    assert all(len(set(r.tolist()) - {h * w}) > KW["max_num_pillars"]
               for r in pid)  # the cap cuts occupied cells
    n_l = jcfg.num_decoder_outputs
    rng = np.random.default_rng(2)
    p = jcfg.head_num_points
    mcs = rng.uniform(size=(n_l, B, p, 2)).astype(np.float32)
    lcs = rng.uniform(size=(n_l, B * jcfg.num_queries, p, 2)).astype(
        np.float32)
    return jcfg, tcfg, batch, v, mcs, lcs


@pytest.fixture(scope="module")
def jax_f32(case):
    """JAX loss with the pinned points, its gradients, outputs and updated
    running statistics (one compile)."""
    jcfg, _, batch, v, mcs, lcs = case
    model = JaxMaskBev(jcfg)

    def loss_fn(params):
        out, mut = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(batch["points"]), jnp.asarray(batch["point_mask"]),
            train=True, mutable=["batch_stats"])
        per = [layer_losses(
            jax.random.PRNGKey(0), out.cls_logits[li], out.mask_logits[li],
            None, jnp.asarray(batch["gt_labels"]),
            jnp.asarray(batch["gt_masks"]), jnp.asarray(batch["gt_valid"]),
            None, jcfg, match_coords=jnp.asarray(mcs[li]),
            loss_coords=jnp.asarray(lcs[li]))[0]
            for li in range(len(mcs))]
        total = sum(jnp.stack([d[k] for d in per]).sum()
                    for k in ("loss_cls", "loss_mask", "loss_dice"))
        return total, (out, mut["batch_stats"])

    (total, (out, bs)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    return (float(total), jax.device_get(out), jax.device_get(bs),
            jax.device_get(grads))


@pytest.fixture(scope="module")
def port_f32(case):
    _, tcfg, batch, v, mcs, lcs = case
    st = create_train_state(tcfg, from_flax(v), device="cpu")
    logs, out, grads = loss_and_grads(
        st, batch, coords=[(torch.as_tensor(m), torch.as_tensor(c))
                           for m, c in zip(mcs, lcs)])
    return st, logs, out, grads


def test_train_forward_matches_jax_f32(jax_f32, port_f32):
    _, want, _, _ = jax_f32
    _, _, got, _ = port_f32
    wc, wm = np.asarray(want.cls_logits), np.asarray(want.mask_logits)
    assert got.cls_logits.shape == wc.shape == (4, B, 8, 2)
    assert got.mask_logits.shape == wm.shape == (4, B, 8, 20, 20)
    np.testing.assert_allclose(got.cls_logits.numpy(), wc, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.mask_logits.numpy(), wm, rtol=0,
                               atol=1e-4)


def test_loss_and_running_stats_match_jax(jax_f32, port_f32):
    want_total, _, want_bs, _ = jax_f32
    st, logs, _, _ = port_f32
    np.testing.assert_allclose(float(logs["loss"]), want_total, rtol=1e-5)
    sd = st.model.state_dict()
    pfn = want_bs["encoder"]["pillar_feature_net"]
    for i in range(2):
        for jn, tn in (("mean", "running_mean"), ("var", "running_var")):
            got = sd[f"encoder.pillar_feature_net.pfn_{i}.norm.{tn}"]
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(pfn[f"pfn_{i}"]["norm"][jn]),
                                       rtol=1e-4, atol=1e-6)


LEAVES = ["encoder.pillar_feature_net.pfn_0.linear.weight",
          "encoder.pillar_feature_net.pfn_1.norm.weight",
          "encoder.norm.weight",
          "backbone.patch_embed.weight",
          "backbone.stage0_block0.attn.w_msa.qkv.weight",
          "backbone.stage2_block1.ffn_2.bias",
          "pixel_decoder.mask_feature.weight",
          "decoder.query_feat",
          "decoder.layer0.cross.q.weight",
          "decoder.layer2.ffn.fc1.weight",
          "decoder.heads.cls_embed.weight",
          "decoder.heads.mask_mlp3.bias"]


@pytest.mark.parametrize("leaf", LEAVES)
def test_gradients_match_jax(jax_f32, port_f32, leaf):
    want = from_flax({"params": jax_f32[3]})[leaf].numpy()
    got = port_f32[3][leaf].numpy()
    assert got.shape == want.shape
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_train_forward_matches_jax_bf16(case):
    jcfg, tcfg, batch, v, _, _ = case
    jcfg = jcfg.replace(compute_dtype="bfloat16")
    tcfg = tcfg.replace(compute_dtype="bfloat16")
    want, _ = JaxMaskBev(jcfg).apply(
        {"params": cast_float_leaves(v["params"], jnp.bfloat16),
         "batch_stats": v["batch_stats"]},
        jnp.asarray(batch["points"], jnp.bfloat16),
        jnp.asarray(batch["point_mask"]), train=True,
        mutable=["batch_stats"])
    st = create_train_state(tcfg, from_flax(v), device="cpu")
    with torch.no_grad(), cast_parameters(st.model, torch.bfloat16):
        got = st.model(torch.as_tensor(batch["points"]).to(torch.bfloat16),
                       torch.as_tensor(batch["point_mask"]), train=True,
                       final_only=False)
    assert got.mask_logits.dtype == torch.bfloat16
    gc, gm = got.cls_logits.float().numpy(), got.mask_logits.float().numpy()
    wc = np.asarray(want.cls_logits.astype(jnp.float32))
    wm = np.asarray(want.mask_logits.astype(jnp.float32))
    assert gc.shape == wc.shape and gm.shape == wm.shape
    assert np.abs(gc - wc).max() <= 0.5
    assert np.abs(gm - wm).mean() <= 0.1 * np.abs(wm).mean()
    assert ((gm > 0) == (wm > 0)).mean() >= 0.95
    # the masters stay f32 outside the cast
    assert all(p.dtype == torch.float32 for p in st.model.parameters())


@pytest.mark.parametrize("wd", [None, 1e-2])
def test_adam_step_matches_optax(wd):
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(size=(5, 7)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    tx = (optax.adam(1e-3) if wd is None
          else optax.adamw(1e-3, weight_decay=wd))
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    opt = Adam(1e-3, weight_decay=wd)
    tp = {k: torch.as_tensor(a.copy()) for k, a in params.items()}
    ts = opt.init(tp)
    for step in range(3):
        g = {k: rng.normal(size=a.shape).astype(np.float32)
             for k, a in params.items()}
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = opt.step(tp, {k: torch.as_tensor(a) for k, a in g.items()}, ts)
        for k in params:
            want = np.asarray(jp[k])
            np.testing.assert_allclose(tp[k].numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
    assert ts.count == 3


def test_synthetic_batch_is_the_jax_packages():
    jcfg, tcfg = jax_tiny(), tiny_test_config()
    for kw in ({}, {"noise_points": 900, "points_per_instance": 50,
                    "max_instances": 3}):
        want = jax_make_batch(np.random.default_rng(7), jcfg, batch_size=3,
                              **kw)
        got = make_batch(np.random.default_rng(7), tcfg, batch_size=3, **kw)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_train_step_updates_parameters_and_statistics(case):
    _, tcfg, batch, v, _, _ = case
    tcfg = tcfg.replace(compute_dtype="bfloat16")
    st = create_train_state(tcfg, from_flax(v), device="cpu")
    before = {k: t.clone() for k, t in st.model.state_dict().items()}
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(2):
        st, logs, out = train_step(st, batch, gen)
        losses.append(float(logs["loss"]))
    assert st.step == 2 and st.opt_state.count == 2
    assert np.isfinite(losses).all()
    assert logs["loss_mask_layers"].shape == (tcfg.num_decoder_outputs,)
    after = st.model.state_dict()
    for k, t in after.items():
        assert t.dtype == torch.float32
        if k.endswith(("running_mean", "running_var")) and "pfn" in k:
            assert not torch.equal(t, before[k])
    assert not torch.equal(after["decoder.query_feat"],
                           before["decoder.query_feat"])
    assert out.mask_logits.shape[0] == tcfg.num_decoder_outputs


def test_remat_and_drop_path(case):
    """Recomputing blocks in the backward pass gives the same gradients; a
    drop-path rate draws per-sample masks from the generator."""
    _, tcfg, batch, v, mcs, lcs = case
    coords = [(torch.as_tensor(m), torch.as_tensor(c))
              for m, c in zip(mcs, lcs)]
    grads = []
    for remat in (False, True):
        cfg = tcfg.replace(remat_backbone=remat, compute_dtype="bfloat16")
        st = create_train_state(cfg, from_flax(v), device="cpu")
        grads.append(loss_and_grads(st, batch, coords=coords)[2])
    for k in ("backbone.stage0_block0.ffn_1.weight", "decoder.query_feat"):
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=0, atol=0)
    st = create_train_state(tcfg.replace(backbone_drop_path_rate=0.5),
                            from_flax(v), device="cpu")
    drops = st.model.backbone.drop_factors(
        64, "cpu", torch.Generator().manual_seed(0))
    assert drops[0] is None and len(drops) == sum(tcfg.backbone_depths)
    last = drops[-1]  # rate 0.5: factors 0 or 2
    assert set(last.unique().tolist()) == {0.0, 2.0}
    assert 0.3 < float((last > 0).float().mean()) < 0.7
