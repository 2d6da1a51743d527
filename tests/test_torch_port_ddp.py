"""The port's data parallelism (``mask_bev_tpu_torch/parallel/``) on CPU
processes over gloo, against the JAX package's sharded step and against the
port's own one-process step.

One module fixture spawns two ranks once (``distributed.spawn``: the
``MASKBEV_*`` variables, as a user would launch them) and, while they run,
computes the references in this process: the JAX package's step over a
2-device mesh of the virtual CPU devices (``shard_batch``, as
``tests/test_parallel.py``), the port's one-process steps and fits, and
``python -m mask_bev_tpu_torch.parallel.dryrun 2``. The ranks run, in
order: the step with the loss points pinned (the pattern of
``tests/test_torch_port_train_step.py``), the step with every draw
unpinned and drop path on, the draw functions alone, a 2-epoch
``Trainer.fit``, a fit of 1 epoch resumed from ``last`` for the second, a
fit that stops early, and the CLI ``train_mask_bev_torch.py`` (which ends
the process group).

Tolerances:
* against JAX (the same weights through ``from_flax``, the same pinned
  points): the loss to 1e-5 relative, each gradient to 1e-4 of its
  largest magnitude, the running statistics to 1e-4 relative, those of
  the one-process comparison in ``test_torch_port_train_step.py``; that
  holds 12 chosen leaves, this every leaf, so gradients that are zero up
  to rounding (an attention key bias's, by the softmax's shift
  invariance) get a floor of 1e-7 of the largest gradient of all;
* against the port's one process: the loss to 1e-5 relative, each gradient
  to 2e-4 relative plus 5e-6 of its largest magnitude, as
  ``tests/test_parallel.py`` holds JAX's sharded step to its unsharded
  one (float sums in another order); the running statistics equal on both
  ranks and within 1e-5 of the one-process ones;
* the draws of the two ranks bit for bit the rows of the one-process draws;
* the fits: every parameter within 2 x lr a step (an Adam step moves a
  parameter by at most ~lr, and gradients that are zero up to rounding,
  such as an attention key bias's, take steps of either sign), the running
  statistics to 1e-4 relative, the validation loss to 1e-5 relative and
  the validation metrics to 1e-4; the resume bitwise.
"""
import json
import os
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
from mask_bev_tpu.parallel.mesh import (  # noqa: E402
    make_mesh, replicate_state)
from mask_bev_tpu.parallel.mesh import shard_batch as jax_shard  # noqa: E402
from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.models.convert import from_flax  # noqa: E402
from mask_bev_tpu_torch.parallel import distributed  # noqa: E402
from mask_bev_tpu_torch.train.step import (  # noqa: E402
    create_train_state, loss_and_grads)

ROOT = pathlib.Path(__file__).resolve().parent.parent
KW = dict(max_num_pillars=256, head_num_points=64, loss_gt_crop=48)
B = 2
# the fits: tiny widths, 2 training batches and 1 validation batch an epoch
FIT = dict(batch_size=2, limit_train_batches=2, limit_val_batches=1,
           max_epochs=2, log_every_n_step=1, head_num_points=64,
           max_points_per_scan=1024, loss_gt_crop=48, max_num_pillars=256,
           log_images=False)
DROP = dict(backbone_drop_path_rate=0.3)
# an early stop after epoch 1: at lr 0 epoch 1's validation loss (other
# loss points) is above epoch 0's
STOP = dict(lr=0.0, early_stop_patience=0, max_epochs=3,
            compute_train_metrics=False)
SEED = 5

CHILD = r'''
import json, os, sys
import numpy as np
import torch

from mask_bev_tpu_torch.parallel import distributed

work = sys.argv[1]
distributed.init_from_env("cpu")
r, n = distributed.rank(), distributed.world_size()
assert n == 2, n

from mask_bev_tpu_torch.config import tiny_test_config
from mask_bev_tpu_torch.datasets.synthetic import make_batch
from mask_bev_tpu_torch.losses import _draw_match_coords
from mask_bev_tpu_torch.models.maskbev import MaskBev
from mask_bev_tpu_torch.ops.point_sample import uniform_draws
from mask_bev_tpu_torch.train import checkpoint
from mask_bev_tpu_torch.train.loop import Trainer
from mask_bev_tpu_torch.train.step import create_train_state, loss_and_grads

case = np.load(os.path.join(work, "case.npz"))
kw = json.loads(open(os.path.join(work, "kw.json")).read())
sd = torch.load(os.path.join(work, "sd.pt"))
batch = distributed.shard_batch({k: case[k] for k in
    ("points", "point_mask", "gt_labels", "gt_masks", "gt_valid")})
out = {}

def stats(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if "running" in k}

# the step with the loss points pinned: this rank's rows of them
cfg = tiny_test_config().replace(**kw["KW"])
st = create_train_state(cfg, sd, device="cpu")
coords = [tuple(torch.as_tensor(distributed.shard_batch({"c": c})["c"])
                for c in (m, l)) for m, l in zip(case["mcs"], case["lcs"])]
logs, _, grads = loss_and_grads(st, batch, coords=coords)
out["pinned"] = dict(loss=float(logs["loss"]), grads=grads,
                     stats=stats(st.model))

# every draw unpinned, drop path on
cfg_d = cfg.replace(**kw["DROP"])
st = create_train_state(cfg_d, sd, device="cpu")
gen = torch.Generator().manual_seed(kw["SEED"])
logs, _, grads = loss_and_grads(st, batch, gen)
out["drawn"] = dict(loss=float(logs["loss"]), grads=grads,
                    stats=stats(st.model))

# the draw functions alone, from one generator in this order
b = batch["points"].shape[0]
gen = torch.Generator().manual_seed(kw["SEED"])
mb = MaskBev(cfg_d)
out["draws"] = dict(
    match=_draw_match_coords(b, cfg_d, gen, "cpu"),
    loss=uniform_draws(b * cfg_d.num_queries, cfg_d.head_num_points,
                       cfg_d.head_oversample_ratio,
                       cfg_d.head_importance_sample_ratio, gen),
    drop=[f for f in mb.backbone.drop_factors(b, "cpu", gen)
          if f is not None])
torch.save(out, os.path.join(work, f"steps{r}.pt"))

# Trainer: a 2-epoch fit, then 1 epoch and a resume from last
fcfg = tiny_test_config().replace(**kw["FIT"])

def batches(c):
    def train(seed):
        rng = np.random.default_rng(seed)
        for _ in range(c.limit_train_batches):
            yield distributed.shard_batch(make_batch(rng, c, noise_points=600))
    def val(seed):
        rng = np.random.default_rng(seed + 10_000)
        for _ in range(c.limit_val_batches):
            yield distributed.shard_batch(make_batch(rng, c, noise_points=600))
    return train, val

saves = []
orig_save = checkpoint.torch.save
def counted(obj, path, *a, **k):
    saves.append(str(path))
    return orig_save(obj, path, *a, **k)
checkpoint.torch.save = counted
tr = Trainer(fcfg, workdir=os.path.join(work, "fit"), device="cpu")
last = tr.fit(*batches(fcfg))
fit = dict(epoch=tr.epoch, val=last, saves=list(saves),
           model=tr.state.model.state_dict())
first = Trainer(fcfg, workdir=os.path.join(work, "resume"), device="cpu")
first.fit(*batches(fcfg), max_epochs=1)
second = Trainer(fcfg.replace(checkpoint="last"),
                 workdir=os.path.join(work, "resume"), device="cpu")
resumed_from = (second.epoch, second.state.step)
second.fit(*batches(fcfg))
st = second.state
fit["resume"] = dict(
    resumed_from=resumed_from, epoch=second.epoch,
    equal=all(torch.equal(v, fit["model"][k])
              for k, v in st.model.state_dict().items())
    and all(torch.equal(st.opt_state.mu[k], tr.state.opt_state.mu[k])
            for k in st.opt_state.mu))
checkpoint.torch.save = orig_save
# the early stop: no learning, so the validation loss stops improving
stop = Trainer(fcfg.replace(**kw["STOP"]), workdir=os.path.join(work, "stop"),
               device="cpu")
stop.fit(*batches(fcfg))
fit["stop_epoch"] = stop.epoch
torch.save(fit, os.path.join(work, f"fit{r}.pt"))

# the CLI under the same MASKBEV_* variables (it ends the process group)
sys.path.insert(0, kw["ROOT"])
from train_mask_bev_torch import main
main(["--config", os.path.join(kw["ROOT"], "configs", "training",
      "semantic_kitti", "00_quick_test.yml"), "--train", "--test",
      "--max-epochs", "1", "--device", "cpu",
      "--workdir", os.path.join(work, "cli")])
print(f"rank {r} done", flush=True)
'''


def _variables(cfg, pts, mask, seed=1):
    """Random flax variables of the right tree at trained-model scales."""
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


def _jax_sharded(jcfg, batch, v, mcs, lcs):
    """JAX loss with the pinned points over a 2-device mesh: loss,
    gradients (as port names) and updated running statistics."""
    model = JaxMaskBev(jcfg)
    mesh = make_mesh(jax.devices("cpu")[:2])
    n_l = len(mcs)

    @jax.jit
    def step(params, bstats, b, mc, lc):
        def loss_fn(p):
            out, mut = model.apply(
                {"params": p, "batch_stats": bstats}, b["points"],
                b["point_mask"], train=True, mutable=["batch_stats"])
            per = [layer_losses(
                jax.random.PRNGKey(0), out.cls_logits[li],
                out.mask_logits[li], None, b["gt_labels"], b["gt_masks"],
                b["gt_valid"], None, jcfg, match_coords=mc[li],
                loss_coords=lc[li])[0] for li in range(n_l)]
            total = sum(jnp.stack([d[k] for d in per]).sum()
                        for k in ("loss_cls", "loss_mask", "loss_dice"))
            return total, mut["batch_stats"]
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    rep = replicate_state({"p": v["params"], "b": v["batch_stats"]}, mesh)
    jb = jax_shard({k: jnp.asarray(batch[k]) for k in
                    ("points", "point_mask", "gt_labels", "gt_masks",
                     "gt_valid")}, mesh)
    # the pinned points sharded along their batch rows, as the data
    sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
        None, "data"))
    (total, bs), grads = step(rep["p"], rep["b"], jb,
                              jax.device_put(jnp.asarray(mcs), sh),
                              jax.device_put(jnp.asarray(lcs), sh))
    assert len(jb["points"].sharding.device_set) == 2
    grads = from_flax({"params": jax.device_get(grads)})
    stats = from_flax({"params": {}, "batch_stats": jax.device_get(bs)})
    return float(total), grads, stats


def _fit_batches(cfg):
    from mask_bev_tpu_torch.datasets.synthetic import make_batch

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
def ddp(tmp_path_factory):
    from mask_bev_tpu_torch.train.loop import Trainer

    work = tmp_path_factory.mktemp("ddp")
    jcfg = jax_tiny().replace(**KW)
    tcfg = tiny_test_config().replace(**KW)
    batch = jax_make_batch(np.random.default_rng(0), jcfg, batch_size=B,
                           noise_points=1200)
    v = _variables(jcfg, batch["points"], batch["point_mask"])
    rng = np.random.default_rng(2)
    n_l, p = jcfg.num_decoder_outputs, jcfg.head_num_points
    mcs = rng.uniform(size=(n_l, B, p, 2)).astype(np.float32)
    lcs = rng.uniform(size=(n_l, B * jcfg.num_queries, p, 2)).astype(
        np.float32)
    sd = from_flax(v)
    np.savez(work / "case.npz", mcs=mcs, lcs=lcs, **batch)
    torch.save(sd, work / "sd.pt")
    (work / "kw.json").write_text(json.dumps(dict(
        KW=KW, DROP=DROP, FIT=FIT, STOP=STOP, SEED=SEED, ROOT=str(ROOT))))
    (work / "child.py").write_text(CHILD)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [q for q in env.get("PYTHONPATH", "").split(os.pathsep)
                       if q])
    env["OMP_NUM_THREADS"] = "2"
    procs = distributed.spawn([str(work / "child.py"), str(work)], 2,
                              env=env, cwd=str(work))
    dry = subprocess.Popen(
        [sys.executable, "-m", "mask_bev_tpu_torch.parallel.dryrun", "2"],
        env=env, cwd=str(ROOT), text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    # five processes share the host's cores while this one works
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ref = {"jax": _jax_sharded(jcfg, batch, v, mcs, lcs)}
        # the port's one process on the global batch
        st = create_train_state(tcfg, sd, device="cpu")
        logs, _, grads = loss_and_grads(
            st, batch, coords=[(torch.as_tensor(m), torch.as_tensor(c))
                               for m, c in zip(mcs, lcs)])
        ref["pinned"] = (float(logs["loss"]), grads, st.model.state_dict())
        st = create_train_state(tcfg.replace(**DROP), sd, device="cpu")
        gen = torch.Generator().manual_seed(SEED)
        logs, _, grads = loss_and_grads(st, batch, gen)
        ref["drawn"] = (float(logs["loss"]), grads, st.model.state_dict())
        fcfg = tiny_test_config().replace(**FIT)
        tr = Trainer(fcfg, workdir=str(work / "one"), device="cpu")
        last = tr.fit(*_fit_batches(fcfg))
        ref["fit"] = (tr.epoch, last, tr.state.model.state_dict(), tr)
        stop = Trainer(fcfg.replace(**STOP), workdir=str(work / "stop1"),
                       device="cpu")
        stop.fit(*_fit_batches(fcfg))
        ref["stop_epoch"] = stop.epoch
        outs = distributed.wait(procs, timeout=600)
        dry_out = dry.communicate(timeout=600)[0]
    finally:
        torch.set_num_threads(threads)
        for q in procs + [dry]:
            if q.poll() is None:
                q.kill()
                q.wait()
    ranks = [dict(steps=torch.load(work / f"steps{r}.pt"),
                  fit=torch.load(work / f"fit{r}.pt"), out=outs[r])
             for r in range(2)]
    return dict(work=work, ref=ref, ranks=ranks, sd=sd, tcfg=tcfg,
                dry=(dry.returncode, dry_out))


def _close(got, want, rtol, atol_rel):
    for k in want:
        a, w = got[k].numpy(), want[k].numpy()
        np.testing.assert_allclose(
            a, w, rtol=rtol, atol=atol_rel * max(1.0, np.abs(w).max()),
            err_msg=k)


def test_two_ranks_match_the_jax_sharded_step(ddp):
    want_loss, want_g, want_stats = ddp["ref"]["jax"]
    for r in ddp["ranks"]:
        got = r["steps"]["pinned"]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
        assert set(got["grads"]) == set(want_g)
        top = max(float(w.abs().max()) for w in want_g.values())
        for k, w in want_g.items():
            w = w.numpy()
            np.testing.assert_allclose(
                got["grads"][k].numpy(), w, rtol=0,
                atol=max(1e-4 * np.abs(w).max(), 1e-7 * top), err_msg=k)
        assert want_stats and set(want_stats) == set(got["stats"])
        for k, w in want_stats.items():
            np.testing.assert_allclose(got["stats"][k].numpy(), w.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", ["pinned", "drawn"])
def test_two_ranks_match_one_process(ddp, case):
    """Loss and every gradient: summed over the ranks, not averaged (a mean
    would halve every gradient here); the running statistics of the whole
    batch on both ranks."""
    want_loss, want_g, want_sd = ddp["ref"][case]
    a, b = (r["steps"][case] for r in ddp["ranks"])
    for got in (a, b):
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5,
                                   atol=1e-7)
        _close(got["grads"], want_g, 2e-4, 5e-6)
        for k, v in got["stats"].items():
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    for k in a["stats"]:
        assert torch.equal(a["stats"][k], b["stats"][k]), k
    for k in a["grads"]:
        assert torch.equal(a["grads"][k], b["grads"][k]), k


def test_draws_do_not_depend_on_the_world_size(ddp):
    from mask_bev_tpu_torch.losses import _draw_match_coords
    from mask_bev_tpu_torch.models.maskbev import MaskBev
    from mask_bev_tpu_torch.ops.point_sample import uniform_draws

    cfg = ddp["tcfg"].replace(**DROP)
    gen = torch.Generator().manual_seed(SEED)
    q = cfg.num_queries
    want = dict(
        match=_draw_match_coords(B, cfg, gen, "cpu"),
        loss=uniform_draws(B * q, cfg.head_num_points,
                           cfg.head_oversample_ratio,
                           cfg.head_importance_sample_ratio, gen),
        drop=[f for f in MaskBev(cfg).backbone.drop_factors(B, "cpu", gen)
              if f is not None])
    assert want["drop"]
    for r, rk in enumerate(ddp["ranks"]):
        got = rk["steps"]["draws"]
        assert torch.equal(got["match"], want["match"][r:r + 1])
        for g, w in zip(got["loss"], want["loss"]):
            assert torch.equal(g, w[r * q:(r + 1) * q])
        assert len(got["drop"]) == len(want["drop"])
        for g, w in zip(got["drop"], want["drop"]):
            assert torch.equal(g, w[:, r:r + 1])


def test_two_rank_fit_matches_one_process(ddp):
    epoch, last, want_sd, tr = ddp["ref"]["fit"]
    cfg = tr.cfg
    steps = tr.state.step
    a, b = (r["fit"] for r in ddp["ranks"])
    assert a["epoch"] == b["epoch"] == epoch
    for got in (a, b):
        np.testing.assert_allclose(got["val"]["val_loss"], last["val_loss"],
                                   rtol=1e-5)
        assert set(got["val"]) == set(last)
        for k, v in last.items():
            np.testing.assert_allclose(got["val"][k], v, rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        for k, v in want_sd.items():
            g = got["model"][k]
            if "running" in k:
                np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=k)
            elif v.is_floating_point():
                np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=0,
                                           atol=2 * cfg.lr * steps,
                                           err_msg=k)
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k


def test_every_rank_stops_at_the_same_epoch(ddp):
    """The early stop decides on the global validation loss, alike on every
    rank and as the one process does."""
    want = ddp["ref"]["stop_epoch"]
    assert want == 1 < STOP["max_epochs"] - 1
    assert [r["fit"]["stop_epoch"] for r in ddp["ranks"]] == [want, want]


def test_only_rank_zero_writes(ddp):
    a, b = (r["fit"] for r in ddp["ranks"])
    assert b["saves"] == []
    assert len(a["saves"]) >= 2  # last and best, each epoch
    run = ddp["work"] / "fit" / ddp["ref"]["fit"][3].cfg.name
    index = json.loads((run / "checkpoints" / "index.json").read_text())
    assert index["last_epoch"] == 1 and index["last_step"] == 4
    # one log line an event: the second rank logs nothing
    lines = (run / f"{ddp['ref']['fit'][3].cfg.name}.metrics.jsonl"
             ).read_text().splitlines()
    one = (ddp["work"] / "one" / ddp["ref"]["fit"][3].cfg.name
           / f"{ddp['ref']['fit'][3].cfg.name}.metrics.jsonl"
           ).read_text().splitlines()
    assert len(lines) == len(one)


def test_two_rank_resume_is_bitwise(ddp):
    for r in ddp["ranks"]:
        res = r["fit"]["resume"]
        assert tuple(res["resumed_from"]) == (1, 2)
        assert res["epoch"] == r["fit"]["epoch"]
        assert res["equal"]


def test_cli_under_maskbev_variables(ddp):
    for r, rk in enumerate(ddp["ranks"]):
        assert f"multi-host: process {r}/2" in rk["out"]
        assert "restored best checkpoint" in rk["out"]
        assert "test results:" in rk["out"]
        assert f"rank {r} done" in rk["out"]
    ckpt = ddp["work"] / "cli" / "00_quick_test" / "checkpoints"
    assert json.loads((ckpt / "index.json").read_text())["last_epoch"] == 0


def test_dryrun_multichip_two_ranks(ddp):
    rc, out = ddp["dry"]
    assert rc == 0, out[-3000:]
    assert "dryrun_multichip(2): ok, sharded loss=" in out


def test_shard_batch_rows_and_error():
    batch = {"x": np.arange(12).reshape(4, 3), "n": 3}
    got = [distributed.shard_batch(batch, r, 2) for r in range(2)]
    np.testing.assert_array_equal(got[1]["x"], batch["x"][2:])
    assert got[0]["n"] == 3
    with pytest.raises(ValueError, match="not divisible by the 3-rank"):
        distributed.shard_batch(batch, 0, 3)
    with pytest.raises(ValueError, match="not divisible"):
        distributed.rank_positions(10, 4, 0, 3)
    pos, rows = distributed.rank_positions(10, 4, 1, 2)
    assert rows == 2 and pos == [2, 3, 6, 7]


@pytest.mark.parametrize("dataset", ["semantic_kitti", "kitti", "waymo",
                                     "synthetic"])
def test_data_modules_load_the_ranks_rows(tmp_path, monkeypatch, dataset):
    """Each rank's data module loads only its rows of every global batch,
    and they equal the rows ``shard_batch`` cuts from the one-process
    batch."""
    import importlib.util

    from mask_bev_tpu_torch.config import MaskBevConfig
    from mask_bev_tpu_torch.datasets.disk_trees import (
        write_kitti_tree, write_semantic_kitti_tree, write_waymo_tree)

    spec = importlib.util.spec_from_file_location(
        "train_mask_bev_torch", ROOT / "train_mask_bev_torch.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    root = tmp_path / "tree"
    if dataset == "kitti":
        write_kitti_tree(root, frames=6, train=4, points=400, boxes=(1, 2))
    elif dataset == "waymo":
        write_waymo_tree(root, frames=6, train=4, points=400,
                         vehicles=(1, 2), others=(1, 1), grid=10.0,
                         radius=15.0)
    elif dataset == "semantic_kitti":
        write_semantic_kitti_tree(root, train_scans=4, valid_scans=2,
                                  points=400)
    cfg = MaskBevConfig.from_dict(dict(
        dataset=dataset, batch_size=2,
        pc_point_dim=3 if dataset == "waymo" else 4, x_range=(-10, 10),
        y_range=(-10, 10), z_range=(-4, 4), voxel_size=0.5, num_queries=8,
        max_points_per_scan=512, limit_train_batches=2,
        limit_val_batches=1))

    def epoch(fn):
        return list(fn(cli.build_datamodule(cfg, str(root)), 3))

    whole = epoch(lambda dm, s: dm.train_batches(s))
    assert len(whole) == 2
    for r in range(2):
        monkeypatch.setattr(distributed, "rank", lambda r=r: r)
        monkeypatch.setattr(distributed, "world_size", lambda: 2)
        part = epoch(lambda dm, s: dm.train_batches(s))
        assert len(part) == len(whole)
        for g, w in zip(part, whole):
            want = distributed.shard_batch(w, r, 2)
            assert set(g) == set(want)
            for k in want:
                np.testing.assert_array_equal(g[k], want[k], err_msg=k)
