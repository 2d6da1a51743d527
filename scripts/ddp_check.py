#!/usr/bin/env python3
"""``chip_smoke.py``'s ``[ddp]`` and ``[modules]`` phases alone, then the
readings behind ``[ddp]`` (a)'s gradient tolerances.

    python3 scripts/ddp_check.py [--noise]

Builds the kernels from this checkout, runs ``ddp_phase`` (two gloo
ranks of the card against one process, and the times), ``ddp_nccl_phase``
(the trainer under a world-size-1 NCCL group against no group) and
``modules_phase``, then measures ``01_semantic_kitti.yml``'s gradient
(f32, global batch 4, the loss points pinned) three ways: one process
twice (its run-to-run change) and two gloo ranks (``chip_smoke.py
--ddp-rank``) against one process. For each it prints the change's norm
over the whole gradient's (``chip_smoke.GRAD_TOL``), over each module's,
the leaves furthest by the change's norm over the leaf's
(``chip_smoke.GRAD_LEAF_TOL``) and by the largest element over the leaf's
largest. ``--noise`` skips the phases and measures, against the one
process as it is, what changes only the card's algorithms or the last bit
of the input: the process repeated, cuDNN off
(``torch.backends.cudnn.enabled = False``), every real point's
coordinates moved up by one ulp, and the two ranks. Needs one CUDA card;
exits 1 when a phase failed.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402
from mask_bev_tpu_torch.parallel import distributed  # noqa: E402
from mask_bev_tpu_torch.train.step import (  # noqa: E402
    create_train_state, loss_and_grads)


def measures(a, b, name: str) -> None:
    tops = {k: float(w.abs().max()) for k, w in a.items()}
    norms = {k: float(w.double().norm()) for k, w in a.items()}
    ftop, fnorm = 1e-4 * max(tops.values()), 1e-4 * max(norms.values())
    by_norm, by_top, groups = [], [], {}
    for k, w in a.items():
        d = (b[k] - w).double()
        dn = float(d.norm())
        by_norm.append((dn / max(norms[k], fnorm), k))
        by_top.append((float(d.abs().max()) / max(tops[k], ftop), k))
        g, c = groups.get(k.split(".")[0], (0.0, 0.0))
        groups[k.split(".")[0]] = (g + norms[k] ** 2, c + dn * dn)
    whole = (sum(c for _, c in groups.values())
             / sum(g for g, _ in groups.values())) ** 0.5
    print(f"[{name}] the change's norm over the gradient's {whole:.3g}; by "
          f"module " + "; ".join(f"{t} {(c / g) ** 0.5:.3g}"
                                 for t, (g, c) in groups.items()))
    for label, rows in (("norm", by_norm), ("largest element", by_top)):
        rows.sort(reverse=True)
        print(f"[{name}] leaves furthest by {label}: " + "; ".join(
            f"{k} {v:.3g}" for v, k in rows[:6]), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("scripts/ddp_check.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    kb.build()
    kb.lib()
    failures = []
    noise = "--noise" in sys.argv[1:]
    if not noise:
        for name, phase in (("ddp", cs.ddp_phase),
                            ("nccl", cs.ddp_nccl_phase)):
            t0 = time.time()
            phase(np, torch, card, failures, ROOT)
            print(f"phase {name} took {time.time() - t0:.1f} s", flush=True)
        cs.modules_phase(np, torch, card, failures)

    cfg, batch, mcs, lcs = cs.ddp_case(np, ROOT, {})
    state = create_train_state(cfg, seed=cs.SEED, device="cuda")
    coords = [(torch.as_tensor(m, device="cuda"),
               torch.as_tensor(c, device="cuda")) for m, c in zip(mcs, lcs)]

    def grads(b):
        _, _, g = loss_and_grads(state, b, coords=coords)
        return {k: v.cpu() for k, v in g.items()}

    ones = [grads(batch) for _ in range(2)]
    variants = []
    if noise:
        torch.backends.cudnn.enabled = False
        variants.append(("cuDNN off", grads(batch)))
        torch.backends.cudnn.enabled = True
        pts = np.asarray(batch["points"], np.float32)
        real = np.asarray(batch["point_mask"], bool)[..., None]
        moved = dict(batch, points=np.where(
            real, np.nextafter(pts, np.float32(np.inf)), pts))
        print(f"one ulp: {int(real.sum())} points moved, largest step "
              f"{float(np.abs(moved['points'] - pts).max()):.3g}",
              flush=True)
        variants.append(("input + 1 ulp", grads(moved)))
    del state, coords
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "runs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="ddp_check_", dir=os.path.join(ROOT,
                                                                  "runs"))
    try:
        with open(os.path.join(work, "args.json"), "w") as f:
            json.dump(dict(device="cuda", overrides={}), f)
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT
        distributed.wait(distributed.spawn(
            [os.path.join(ROOT, "chip_smoke.py"), "--ddp-rank", work], 2,
            env=env, cwd=ROOT), 900)
        ranks = torch.load(os.path.join(work, "grads.pt"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    measures(ones[0], ones[1], f"one process repeated, {card}")
    for name, g in variants:
        measures(ones[0], g, f"{name} vs one process, {card}")
    measures(ones[0], ranks, f"two ranks vs one process, {card}")
    print("failures", failures, flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
