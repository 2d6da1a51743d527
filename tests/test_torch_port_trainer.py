"""The port's training entry point on the CPU: ``Trainer`` (epochs,
validation with the per-layer metrics, plateau scale, best and last
checkpoints, image dumps), a resume, ``MaskBevPredictor.from_checkpoint``,
the CLI ``train_mask_bev_torch.py``, and the eval step against the JAX
package's.

``tiny_test_config()`` at batch 2, 2 training batches and 1 validation
batch an epoch, 2 epochs. Exact checks: a run resumed from ``last`` after
epoch 0 ends with parameters, running statistics and optimizer moments
bitwise equal to an unbroken run's (the epoch's draws are derived from
``(seed + 1, epoch)``, never stored); the predictor served from ``best``
gives the trainer state's own outputs bit for bit. The eval step's loss on
the first validation batch against the JAX package's eval forward and
per-layer losses, on the same weights (``models/convert.py::from_flax``)
and the same pinned points: 1e-5 relative, the tolerance of
``test_torch_port_train_step.py`` for the f32 loss.
"""
import importlib.util
import json
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.datasets.synthetic import make_batch  # noqa: E402
from mask_bev_tpu_torch.inference import MaskBevPredictor  # noqa: E402
from mask_bev_tpu_torch.models.convert import from_flax  # noqa: E402
from mask_bev_tpu_torch.train.loop import Trainer  # noqa: E402
from mask_bev_tpu_torch.train.step import eval_step, predict_step  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
KW = dict(batch_size=2, limit_train_batches=2, limit_val_batches=1,
          max_epochs=2, log_every_n_step=1, head_num_points=64,
          max_points_per_scan=1024, loss_gt_crop=48, max_num_pillars=256)


def _cfg(**kw):
    return tiny_test_config().replace(**{**KW, **kw})


def _batches(cfg):
    def train(seed):
        rng = np.random.default_rng(seed)
        for _ in range(cfg.limit_train_batches):
            yield make_batch(rng, cfg, noise_points=600)

    def val(seed):
        rng = np.random.default_rng(seed + 10_000)
        for _ in range(cfg.limit_val_batches):
            yield make_batch(rng, cfg, noise_points=600)
    return train, val


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    """Two epochs straight through, image dumps on."""
    cfg = _cfg(log_images=True)
    work = tmp_path_factory.mktemp("unbroken")
    tr = Trainer(cfg, workdir=str(work), device="cpu")
    last = tr.fit(*_batches(cfg))
    return cfg, work, tr, last


def test_fit_writes_checkpoints_and_metrics(unbroken):
    cfg, work, tr, last = unbroken
    run = work / cfg.name
    ckpt = run / "checkpoints"
    index = json.loads((ckpt / "index.json").read_text())
    assert (ckpt / "last.pt").exists() and (ckpt / "best.pt").exists()
    assert index["last_step"] == 4 and index["last_epoch"] == 1
    assert index["best_epoch"] in (0, 1)
    assert np.isfinite(index["best_val_loss"])
    assert set(index["last_meta"]) == {
        "epoch", "plateau_best", "plateau_bad_epochs", "plateau_scale",
        "early_stop_bad_epochs"}
    assert tr.state.step == 4 and tr.epoch == 2
    assert np.isfinite(last["val_loss"])
    n_l = cfg.num_decoder_outputs
    for i in range(n_l):
        for k in (f"val_mAP_cls_{i}", f"val_mIoU_{i}", f"val_mAP_{i}_map"):
            assert k in last and np.isfinite(last[k])
    lines = [json.loads(ln) for ln in
             (run / f"{cfg.name}.metrics.jsonl").read_text().splitlines()]
    phases = [ln["phase"] for ln in lines]
    assert phases.count("train") == 4 and phases.count("val") == 2
    assert phases.count("train_metrics") == 2
    assert all(np.isfinite(ln["loss"]) for ln in lines
               if ln["phase"] == "train")
    assert (run / "images" / "epoch0000_encoded.png").exists()
    assert (run / "images" / "epoch0001_gt.png").exists()


def test_resume_is_bitwise_equal(unbroken, tmp_path):
    cfg, _, whole, _ = unbroken
    first = Trainer(cfg, workdir=str(tmp_path), device="cpu")
    first.fit(*_batches(cfg), max_epochs=1)
    assert first.epoch == 1 and first.state.step == 2
    second = Trainer(cfg.replace(checkpoint="last"), workdir=str(tmp_path),
                     device="cpu")
    assert second.epoch == 1 and second.state.step == 2
    second.fit(*_batches(cfg))
    assert second.state.step == whole.state.step == 4
    got, want = second.state.model.state_dict(), whole.state.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for mom in ("mu", "nu"):
        for k, v in getattr(whole.state.opt_state, mom).items():
            assert torch.equal(getattr(second.state.opt_state, mom)[k], v), k
    assert second.state.lr_scale == whole.state.lr_scale
    assert second.plateau == whole.plateau


def test_from_checkpoint_serves_the_trainers_state(unbroken):
    cfg, work, tr, _ = unbroken
    ckpt_dir = work / cfg.name / "checkpoints"
    best = tr.ckpt.restore("best")
    pred = MaskBevPredictor.from_checkpoint(cfg, str(ckpt_dir), "best",
                                            device="cpu")
    batch = make_batch(np.random.default_rng(9), cfg, noise_points=600)
    got = pred.forward(torch.as_tensor(batch["points"]),
                       torch.as_tensor(batch["point_mask"]))
    tr.state.model.load_state_dict(best["model"])
    want = predict_step(tr.state, batch["points"], batch["point_mask"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    scans = pred.predict_batch(batch["points"], batch["point_mask"],
                               score_threshold=0.0)
    assert len(scans) == 2 and all(s.boxes.shape[1] == 5 for s in scans)
    with pytest.raises(FileNotFoundError):
        MaskBevPredictor.from_checkpoint(cfg, str(ckpt_dir / "none"), "best",
                                         device="cpu")


def test_cli_trains_and_tests(tmp_path):
    res = subprocess.run(
        [sys.executable, str(ROOT / "train_mask_bev_torch.py"), "--config",
         str(ROOT / "configs/training/semantic_kitti/00_quick_test.yml"),
         "--train", "--test", "--max-epochs", "1", "--device", "cpu",
         "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "restored best checkpoint" in res.stdout
    assert "test results:" in res.stdout
    ckpt = tmp_path / "00_quick_test" / "checkpoints"
    assert json.loads((ckpt / "index.json").read_text())["last_epoch"] == 0


@pytest.mark.parametrize("dataset", ["kitti", "semantic_kitti", "waymo"])
def test_cli_refuses_unported_datasets(tmp_path, dataset):
    """No shipped dataset is refused any more: KITTI, SemanticKITTI and
    Waymo (a root of converted frames) build their data modules; an unknown
    dataset name still raises."""
    spec = importlib.util.spec_from_file_location(
        "train_mask_bev_torch", ROOT / "train_mask_bev_torch.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cfg = tmp_path / f"{dataset}.yml"
    cfg.write_text(f"dataset: {dataset}\n")
    from mask_bev_tpu_torch.config import MaskBevConfig
    from mask_bev_tpu_torch.datasets.disk_trees import (
        write_kitti_tree, write_semantic_kitti_tree, write_waymo_tree)

    root = tmp_path / "tree"
    if dataset == "kitti":
        write_kitti_tree(root, frames=2, train=1, points=500, boxes=(1, 2))
    elif dataset == "waymo":
        write_waymo_tree(root, frames=2, train=1, points=500,
                         vehicles=(1, 2), others=(1, 1), grid=10.0,
                         radius=15.0)
    else:
        write_semantic_kitti_tree(root, train_scans=1, valid_scans=1,
                                  points=500)
    dm = cli.build_datamodule(MaskBevConfig.from_yaml(cfg), str(root))
    assert callable(dm.train_batches) and callable(dm.val_batches)
    with pytest.raises(ValueError, match="unknown dataset"):
        cli.build_datamodule(MaskBevConfig.from_yaml(cfg).replace(
            dataset="nuscenes"), str(root))


def _variables(cfg, pts, mask, seed=1):
    import jax
    import jax.numpy as jnp

    from mask_bev_tpu.models.maskbev import MaskBev as JaxMaskBev

    shapes = jax.eval_shape(lambda: JaxMaskBev(cfg).init(
        jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask),
        train=False))
    rng = np.random.default_rng(seed)

    def value(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        r = rng.normal(size=s.shape).astype(np.float32)
        if name == "var":
            return 0.5 + rng.uniform(size=s.shape)
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


def test_eval_step_loss_matches_jax(tmp_path):
    # the JAX package only here: the card's tests of this file need no JAX
    import jax
    import jax.numpy as jnp

    from mask_bev_tpu.config import tiny_test_config as jax_tiny
    from mask_bev_tpu.losses import layer_losses
    from mask_bev_tpu.models.maskbev import MaskBev as JaxMaskBev

    cfg = _cfg()
    jcfg = jax_tiny().replace(**KW)
    _, val = _batches(cfg)
    batch = next(val(0))
    v = _variables(jcfg, batch["points"], batch["point_mask"])
    n_l = jcfg.num_decoder_outputs
    rng = np.random.default_rng(2)
    p, b, q = jcfg.head_num_points, 2, jcfg.num_queries
    mcs = rng.uniform(size=(n_l, b, p, 2)).astype(np.float32)
    lcs = rng.uniform(size=(n_l, b * q, p, 2)).astype(np.float32)

    @jax.jit
    def jax_eval_loss(v, pts, pmask, labels, masks, valid, mcs, lcs):
        out = JaxMaskBev(jcfg).apply(v, pts, pmask, train=False)
        per = [layer_losses(
            jax.random.PRNGKey(0), out.cls_logits[li], out.mask_logits[li],
            None, labels, masks, valid, None, jcfg, match_coords=mcs[li],
            loss_coords=lcs[li])[0] for li in range(n_l)]
        return sum(jnp.stack([d[k] for d in per]).sum()
                   for k in ("loss_cls", "loss_mask", "loss_dice"))

    want = float(jax_eval_loss(
        v, *(jnp.asarray(batch[k]) for k in (
            "points", "point_mask", "gt_labels", "gt_masks", "gt_valid")),
        jnp.asarray(mcs), jnp.asarray(lcs)))

    tr = Trainer(cfg, workdir=str(tmp_path), device="cpu")
    tr.state.model.load_state_dict(from_flax(v))
    logs, outputs = eval_step(tr.state, batch, coords=[
        (torch.as_tensor(m), torch.as_tensor(c)) for m, c in zip(mcs, lcs)])
    assert outputs.mask_logits.shape[0] == n_l
    np.testing.assert_allclose(float(logs["loss"]), want, rtol=1e-5)
    # the validation pass runs the same step with drawn points
    res = tr.validate(val(0), tr.generator(1))
    assert np.isfinite(res["val_loss"]) and "val_mIoU_0" in res


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's CUDA kernels (nvcc, sm_90a) "
                    "run only on a card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fit_one_epoch_on_the_card(dev, tmp_path):
    """One epoch of the tiny config on the card (its 8 heads): the training
    kernels (A, B, C) launch, the losses are finite, the checkpoints are
    written."""
    from mask_bev_tpu_torch.kernels import build as kb

    cfg = _cfg(compute_dtype="bfloat16", log_images=False)
    tr = Trainer(cfg, workdir=str(tmp_path), device="cuda")
    kb.reset_launches()
    last = tr.fit(*_batches(cfg), max_epochs=1)
    torch.cuda.synchronize()
    for k in ("canvas_scatter", "canvas_scatter_bwd", "hungarian"):
        assert kb.LAUNCHES[k] > 0, (k, kb.LAUNCHES)
    assert np.isfinite(last["val_loss"]) and tr.state.step == 2
    index = json.loads((tmp_path / cfg.name / "checkpoints" /
                        "index.json").read_text())
    assert index["last_epoch"] == 0 and np.isfinite(index["best_val_loss"])
