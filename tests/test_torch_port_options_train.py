"""The training entry points with every model option on, port against the
JAX package: ``train_step`` and ``eval_step`` (the height head's loss from
the batch's ``gt_heights``), and the CLI ``train_mask_bev_torch.py --device
cpu --train --test`` on a YAML that sets the options (``Trainer`` logs
``loss_height``).

Both packages run ``tiny_test_config()`` with the height head, the absolute
position embedding swapped, two refinement layers, the Fourier encoding and
5 point columns, a pillar cap that cuts occupied cells, on the same weights
(``models/convert.py::from_flax``) and the same batch. The JAX package's
loss draws its points from its PRNG, so its step is composed here as
``mask_bev_tpu/train/step.py::make_train_step`` and ``make_eval_step``
compose it (the training or eval forward, then every head pass's loss with
``gt_heights`` since ``predict_height`` is set), with the points pinned on
both sides (``layer_losses(match_coords=, loss_coords=)``, the port's
``coords=``). Tolerances, those of ``test_torch_port_train_step.py`` (f32):
every head pass's logits, height logits included, 1e-4 absolute; each loss
term 1e-5 relative; each gradient leaf 1e-4 of its largest magnitude.
"""
import json
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from mask_bev_tpu.datasets.synthetic import (  # noqa: E402
    make_batch as jax_make_batch)
from mask_bev_tpu.losses import layer_losses  # noqa: E402
from mask_bev_tpu.models.maskbev import MaskBev as JaxMaskBev  # noqa: E402
from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.models.convert import from_flax  # noqa: E402
from mask_bev_tpu_torch.ops.stream_pillars import fuse_pid  # noqa: E402
from mask_bev_tpu_torch.train.step import (  # noqa: E402
    create_train_state, eval_step, loss_and_grads, train_step)

ROOT = pathlib.Path(__file__).resolve().parent.parent
OPTIONS = dict(predict_height=True, backbone_use_abs_emb=True,
               backbone_swap_dims=True, pixel_decoder_num_attn_layers=2,
               encoder_encoding_type="fourier", pc_point_dim=5)
KW = dict(OPTIONS, max_num_pillars=256, head_num_points=64, loss_gt_crop=48)
B = 2
TERMS = ("loss_cls", "loss_mask", "loss_dice", "loss_height")


def _value(name, shape, rng):
    r = rng.normal(size=shape).astype(np.float32)
    if name == "var":
        return (0.5 + rng.uniform(size=shape)).astype(np.float32)
    if name in ("mean", "bias"):
        return 0.05 * r
    if name == "scale":
        return 1.0 + 0.1 * r
    if name == "kernel":
        return r / np.sqrt(np.prod(shape[:-1]))
    if name in ("rel_pos_bias_table", "absolute_pos_embed"):
        return 0.02 * r
    return r


@pytest.fixture(scope="module")
def case():
    jcfg = jax_tiny().replace(**KW)
    tcfg = tiny_test_config().replace(**KW)
    rng = np.random.default_rng(0)
    # the synthetic scenes have 4 columns: a fifth drawn from the seed
    batch = jax_make_batch(rng, jcfg.replace(pc_point_dim=4), batch_size=B,
                           noise_points=1200)
    fifth = np.where(batch["point_mask"],
                     rng.uniform(size=batch["point_mask"].shape), 0)
    batch["points"] = np.concatenate(
        [batch["points"], fifth[..., None].astype(np.float32)], -1)
    # heights on and beside the bins' .5 boundaries (1.3 m rounds to even)
    batch["gt_heights"][:, :3] = np.float32([1.3, 1.5, 2.1])
    assert batch["gt_valid"][:, :3].all()
    shapes = jax.eval_shape(lambda: JaxMaskBev(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(batch["points"]),
        jnp.asarray(batch["point_mask"]), train=False))
    vrng = np.random.default_rng(1)
    v = jax.tree_util.tree_map_with_path(
        lambda p, s: _value(str(getattr(p[-1], "key", p[-1])), s.shape,
                            vrng), shapes)
    pid = fuse_pid(torch.as_tensor(batch["points"]),
                   torch.as_tensor(batch["point_mask"]),
                   x_range=tcfg.x_range, y_range=tcfg.y_range,
                   z_range=tcfg.z_range, voxel_size=tcfg.voxel_size)
    h, w = tcfg.grid_hw
    assert all(len(set(r.tolist()) - {h * w}) > KW["max_num_pillars"]
               for r in pid)  # the cap cuts occupied cells
    n_l = jcfg.num_decoder_outputs
    # matching at every cell centre of the GT grid: random points can miss
    # small instances, whose cost columns are then equal, and the Hungarian
    # solve breaks such exact ties by the last bits of each package's costs
    cy, cx = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                         indexing="ij")
    centres = np.stack([cx.ravel(), cy.ravel()], -1).astype(np.float32)
    mcs = np.broadcast_to(centres, (n_l, B) + centres.shape).copy()
    crng = np.random.default_rng(2)
    lcs = crng.uniform(size=(n_l, B * jcfg.num_queries, jcfg.head_num_points,
                             2)).astype(np.float32)
    coords = [(torch.as_tensor(m), torch.as_tensor(c))
              for m, c in zip(mcs, lcs)]
    return jcfg, tcfg, batch, v, mcs, lcs, coords


def _jax_terms(jcfg, out, batch, mcs, lcs):
    """Each loss term summed over the head passes, as ``maskbev_loss``."""
    per = [layer_losses(
        jax.random.PRNGKey(0), out.cls_logits[li], out.mask_logits[li],
        out.height_logits[li], jnp.asarray(batch["gt_labels"]),
        jnp.asarray(batch["gt_masks"]), jnp.asarray(batch["gt_valid"]),
        jnp.asarray(batch["gt_heights"]), jcfg,
        match_coords=jnp.asarray(mcs[li]),
        loss_coords=jnp.asarray(lcs[li]))[0] for li in range(len(mcs))]
    return {k: jnp.stack([d[k] for d in per]).sum() for k in TERMS}


@pytest.fixture(scope="module")
def jax_train(case):
    """The JAX training forward, loss terms and gradients (one compile)."""
    jcfg, _, batch, v, mcs, lcs, _ = case
    model = JaxMaskBev(jcfg)

    def loss_fn(params):
        out, _ = model.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(batch["points"]), jnp.asarray(batch["point_mask"]),
            train=True, mutable=["batch_stats"])
        terms = _jax_terms(jcfg, out, batch, mcs, lcs)
        return sum(terms.values()), (terms, out)

    (_, (terms, out)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    return jax.device_get(terms), jax.device_get(out), jax.device_get(grads)


@pytest.fixture(scope="module")
def jax_eval(case):
    jcfg, _, batch, v, mcs, lcs, _ = case

    @jax.jit
    def run(v):
        out = JaxMaskBev(jcfg).apply(
            v, jnp.asarray(batch["points"]),
            jnp.asarray(batch["point_mask"]), train=False)
        return _jax_terms(jcfg, out, batch, mcs, lcs), out
    return jax.device_get(run(v))


def _outputs_close(got, want):
    assert got.height_logits is not None and want.height_logits is not None
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=1e-4)


def _terms_close(logs, want):
    for k in TERMS:
        np.testing.assert_allclose(float(logs[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    assert float(want["loss_height"]) > 0
    np.testing.assert_allclose(float(logs["loss"]),
                               sum(float(want[k]) for k in TERMS), rtol=1e-5)


def test_train_step_with_options_matches_jax(case, jax_train):
    """``train_step`` passes ``gt_heights`` to the loss: its logs and every
    head pass's outputs equal the JAX step's, and the step moves the height
    head, the embedding and the refinement blocks."""
    _, tcfg, batch, v, _, _, coords = case
    want_terms, want_out, _ = jax_train
    st = create_train_state(tcfg, from_flax(v), device="cpu")
    before = {k: t.clone() for k, t in st.model.state_dict().items()}
    st, logs, out = train_step(st, batch, coords=coords)
    _terms_close(logs, want_terms)
    assert logs["loss_height_layers"].shape == (tcfg.num_decoder_outputs,)
    _outputs_close(out, want_out)
    after = st.model.state_dict()
    for k in ("decoder.heads.height_embed.weight",
              "backbone.absolute_pos_embed",
              "pixel_decoder.refine1_1.attn.w_msa.qkv.weight",
              "encoder.pillar_feature_net.fourier_pe.w_r.weight"):
        assert not torch.equal(after[k], before[k]), k


LEAVES = ["decoder.heads.height_embed.weight",
          "decoder.heads.height_embed.bias",
          "backbone.absolute_pos_embed",
          "pixel_decoder.refine1_0.attn.w_msa.qkv.weight",
          "pixel_decoder.refine3_1.attn.w_msa.rel_pos_bias_table",
          "pixel_decoder.refine2_1.ffn_2.weight",
          "encoder.pillar_feature_net.fourier_pe.w_r.weight",
          "encoder.pillar_feature_net.fourier_pe.mlp_out.weight",
          "encoder.pillar_feature_net.pfn_0.linear.weight",
          "decoder.query_feat"]


@pytest.fixture(scope="module")
def port_grads(case):
    """The gradients the step applies (``loss_and_grads``, which
    ``train_step`` calls)."""
    _, tcfg, batch, v, _, _, coords = case
    st = create_train_state(tcfg, from_flax(v), device="cpu")
    return loss_and_grads(st, batch, coords=coords)[2]


@pytest.mark.parametrize("leaf", LEAVES)
def test_gradients_with_options_match_jax(jax_train, port_grads, leaf):
    """The gradients at the options' own parameters and at two others."""
    want = from_flax({"params": jax_train[2]})[leaf].numpy()
    got = port_grads[leaf].numpy()
    assert got.shape == want.shape
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_eval_step_with_options_matches_jax(case, jax_eval):
    _, tcfg, batch, v, _, _, coords = case
    st = create_train_state(tcfg, from_flax(v), device="cpu")
    logs, out = eval_step(st, batch, coords=coords)
    want_terms, want_out = jax_eval
    _terms_close(logs, want_terms)
    assert out.height_logits.shape == (
        tcfg.num_decoder_outputs, B, tcfg.num_queries,
        tcfg.head_num_height_bins)
    _outputs_close(out, want_out)


def test_cli_trains_and_tests_with_options(tmp_path):
    """``train_mask_bev_torch.py`` on the quick-test YAML with every model
    option set (its synthetic scenes have 4 point columns, in both packages,
    so ``pc_point_dim`` stays 4): it trains, validates and tests, and
    ``Trainer`` logs ``loss_height`` at every training step."""
    base = (ROOT / "configs/training/semantic_kitti/00_quick_test.yml"
            ).read_text()
    opts = "".join(f"{k}: {json.dumps(v)}\n" for k, v in OPTIONS.items()
                   if k != "pc_point_dim")
    cfg = tmp_path / "options_quick_test.yml"
    cfg.write_text(base + opts)
    res = subprocess.run(
        [sys.executable, str(ROOT / "train_mask_bev_torch.py"), "--config",
         str(cfg), "--train", "--test", "--max-epochs", "1", "--device",
         "cpu", "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "test results:" in res.stdout
    metrics = list(tmp_path.glob("*/*.metrics.jsonl"))
    assert len(metrics) == 1
    train = [json.loads(ln) for ln in metrics[0].read_text().splitlines()
             if '"phase": "train"' in ln]
    assert train and all(np.isfinite(ln["loss_height"]) and
                         ln["loss_height"] > 0 for ln in train)
