"""A data-parallel dry run of the training step on CPU processes.

The counterpart of ``__graft_entry__.py::dryrun_multichip``: n gloo ranks
on this host, each one process, run one training step of
``tiny_test_config()`` at a global batch of n (one row a rank) and check
that the sharded loss equals the one-process loss on the same global
batch (rtol 1e-4, atol 1e-6, as there):

    python -m mask_bev_tpu_torch.parallel.dryrun 8

or ``dryrun_multichip(n)`` from Python. The ranks start with
``MASKBEV_COORDINATOR``/``MASKBEV_NUM_PROCESSES``/``MASKBEV_PROCESS_ID``
(``distributed.spawn``); the parent computes the one-process loss and
prints one line.
"""
from __future__ import annotations

import os
import sys

import numpy as np


def _step(n: int, sharded: bool) -> float:
    """The loss of one ``train_step`` at batch n: the whole batch, or this
    rank's row of it under the process group."""
    import torch

    from mask_bev_tpu_torch.config import tiny_test_config
    from mask_bev_tpu_torch.datasets.synthetic import make_batch
    from mask_bev_tpu_torch.parallel import distributed
    from mask_bev_tpu_torch.train.step import create_train_state, train_step

    cfg = tiny_test_config().replace(max_points_per_scan=512, batch_size=n)
    state = create_train_state(cfg, seed=0, device="cpu")
    batch = make_batch(np.random.default_rng(0), cfg, batch_size=n)
    if sharded:
        batch = distributed.shard_batch(batch)
    gen = torch.Generator().manual_seed(1)
    _, logs, _ = train_step(state, batch, gen)
    return float(logs["loss"])


def _child() -> None:
    from mask_bev_tpu_torch.parallel import distributed

    distributed.init_from_env("cpu")
    try:
        loss = _step(distributed.world_size(), sharded=True)
        print(f"rank {distributed.rank()} loss={loss!r}", flush=True)
    finally:
        distributed.shutdown()


def dryrun_multichip(n_devices: int, timeout: float = 900.0) -> None:
    """Run the n-rank step and the one-process step; raise where the losses
    differ, else print ``dryrun_multichip(n): ok, ...``."""
    from mask_bev_tpu_torch.parallel import distributed

    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    # n processes share the host's cores
    env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // n_devices))
    procs = distributed.spawn(
        ["-m", "mask_bev_tpu_torch.parallel.dryrun", "--child"], n_devices,
        env=env, cwd=here)
    loss1 = _step(n_devices, sharded=False)
    outs = distributed.wait(procs, timeout)
    losses = [float(o.split("loss=")[-1].split()[0]) for o in outs]
    loss = losses[0]
    assert all(v == loss for v in losses), f"ranks disagree: {losses}"
    assert np.isfinite(loss), f"non-finite loss {loss}"
    assert np.isclose(loss, loss1, rtol=1e-4, atol=1e-6), (
        f"sharded loss {loss} != single-device loss {loss1}")
    print(f"dryrun_multichip({n_devices}): ok, sharded loss={loss:.6f} == "
          f"single-device loss={loss1:.6f}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        _child()
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
