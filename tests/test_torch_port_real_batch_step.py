"""One training step of the port against the JAX package's on a batch read
from a SemanticKITTI tree on disk, in the datasets' own GT layout: every GT
row is valid, instance rows carry label 1 (``CAR``) and padding rows label
0 with an empty mask (synthetic batches mark padding invalid instead).

``tiny_test_config()`` widths on a 12.8 m square at 0.16 m (80x80 cells,
the tiny config's grid), the pillar cap, loss points and weights pinned as
``test_torch_port_train_step.py`` pins them (``models/convert.py::
from_flax``), one JAX compile of the loss and its gradients. Tolerances
are that file's: the loss to 1e-5 relative, logits to 1e-4 absolute, each
gradient leaf to 1e-4 of its largest magnitude; the batch itself bit for
bit.

The JAX side runs in float64 (``jax.enable_x64``): on this batch, whose
scans reach past the grid as real scans do, the JAX package's own f32
gradient departs from its float64 gradient in one PFN channel (the
``pfn_1`` norm bias of channel 8 by 0.0057 of 0.30, and ``pfn_0`` through
it), while the port's f32 gradient stays within 1.2e-6 of the float64 one
in every PFN leaf. The same comparison at the JAX package's f32 passes
once the points beyond the grid are masked out.
"""
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from mask_bev_tpu.datasets.semantic_kitti.mask_data import (  # noqa: E402
    SemanticKittiMaskDataModule as JaxModule)
from mask_bev_tpu.losses import layer_losses  # noqa: E402
from mask_bev_tpu.models.maskbev import MaskBev as JaxMaskBev  # noqa: E402
from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.datasets.disk_trees import (  # noqa: E402
    write_semantic_kitti_tree)
from mask_bev_tpu_torch.datasets.semantic_kitti.mask_data import (  # noqa: E402
    SemanticKittiMaskDataModule)
from mask_bev_tpu_torch.models.convert import from_flax  # noqa: E402
from mask_bev_tpu_torch.train.step import (  # noqa: E402
    create_train_state, loss_and_grads)
from test_torch_port_train_step import LEAVES, _variables  # noqa: E402

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None,
    reason="g++ not found on PATH: the port's host core cannot be built")

KW = dict(dataset="semantic_kitti", x_range=(-6.4, 6.4),
          y_range=(-6.4, 6.4), z_range=(-4, 4), voxel_size=0.16,
          max_num_pillars=256, head_num_points=64, loss_gt_crop=48,
          augmentations=[{"name": "flip", "prob_flip_x": 0.5,
                          "prob_flip_y": 0.5},
                         {"name": "rotate", "rotate_prob": 1.0,
                          "rotation_range": 5}])


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = write_semantic_kitti_tree(
        tmp_path_factory.mktemp("sk"), seed=11, train_scans=4,
        valid_scans=2, points=1800, radius=9.0, spacing=5.0,
        lanes=(-3.0, 3.0), car_points=1500.0)
    jcfg, tcfg = jax_tiny().replace(**KW), tiny_test_config().replace(**KW)
    batch = next(iter(SemanticKittiMaskDataModule(
        str(root), tcfg, use_cache=False).train_batches(3)))
    want = next(iter(JaxModule(str(root), jcfg,
                               use_cache=False).train_batches(3)))
    v = _variables(jcfg, batch["points"], batch["point_mask"])
    rng = np.random.default_rng(2)
    n_l, p = jcfg.num_decoder_outputs, jcfg.head_num_points
    mcs = rng.uniform(size=(n_l, 2, p, 2)).astype(np.float32)
    lcs = rng.uniform(size=(n_l, 2 * jcfg.num_queries, p, 2)).astype(
        np.float32)
    return jcfg, tcfg, batch, want, v, mcs, lcs


def test_batch_is_real_format_and_the_jax_packages(case):
    _, _, batch, want, _, _, _ = case
    assert set(batch) == set(want)
    for k in want:
        assert batch[k].dtype == want[k].dtype
        np.testing.assert_array_equal(batch[k], want[k])
    n = batch["num_instances"]
    assert batch["gt_masks"].shape == (2, 8, 80, 80)
    assert batch["gt_valid"].all() and (n >= 1).all() and (n < 8).all()
    for b in range(2):
        assert (batch["gt_labels"][b, :n[b]] == 1).all()
        assert (batch["gt_labels"][b, n[b]:] == 0).all()
        assert batch["gt_masks"][b, :n[b]].any(axis=(1, 2)).all()
        assert not batch["gt_masks"][b, n[b]:].any()


@pytest.fixture(scope="module")
def results(case):
    """The JAX package's loss, outputs and gradients in float64, the
    port's in f32."""
    jcfg, tcfg, batch, _, v, mcs, lcs = case
    model = JaxMaskBev(jcfg)
    f64 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731

    def loss_fn(params, batch_stats):
        out, _ = model.apply(
            {"params": params, "batch_stats": batch_stats},
            f64(batch["points"]), jnp.asarray(batch["point_mask"]),
            train=True, mutable=["batch_stats"])
        per = [layer_losses(
            jax.random.PRNGKey(0), out.cls_logits[li], out.mask_logits[li],
            None, jnp.asarray(batch["gt_labels"]),
            jnp.asarray(batch["gt_masks"]), jnp.asarray(batch["gt_valid"]),
            None, jcfg, match_coords=f64(mcs[li]),
            loss_coords=f64(lcs[li]))[0]
            for li in range(len(mcs))]
        total = sum(jnp.stack([d[k] for d in per]).sum()
                    for k in ("loss_cls", "loss_mask", "loss_dice"))
        return total, out

    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        (total, out), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v64["params"], v64["batch_stats"])
        total, out, grads = float(total), jax.device_get(out), \
            jax.device_get(grads)
    assert np.asarray(out.mask_logits).dtype == np.float64
    st = create_train_state(tcfg, from_flax(v), device="cpu")
    logs, got_out, got_grads = loss_and_grads(
        st, batch, coords=[(torch.as_tensor(m), torch.as_tensor(c))
                           for m, c in zip(mcs, lcs)])
    return total, out, grads, logs, got_out, got_grads


def test_loss_and_logits_match_jax(results):
    want_total, want_out, _, logs, got_out, _ = results
    assert np.isfinite(want_total)
    np.testing.assert_allclose(float(logs["loss"]), want_total, rtol=1e-5)
    np.testing.assert_allclose(got_out.cls_logits.numpy(),
                               np.asarray(want_out.cls_logits), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got_out.mask_logits.numpy(),
                               np.asarray(want_out.mask_logits), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("leaf", LEAVES)
def test_gradients_match_jax(results, leaf):
    want = from_flax({"params": results[2]})[leaf].numpy()
    got = results[5][leaf].numpy()
    assert got.dtype == np.float32
    assert got.shape == want.shape
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
