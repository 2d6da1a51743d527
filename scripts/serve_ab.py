#!/usr/bin/env python3
"""Serve phases of ``chip_smoke.py`` with one checkout, for A/B runs.

    python3 scripts/serve_ab.py <checkout root> [phase ...]

Imports ``chip_smoke.py`` and the port from the checkout given (its own
sources, built at first use) and runs the phases named (default ``K F``)
on the card:

* ``main``: the main path (``semantic_kitti_default()`` in bf16 with the
  int8 backbone, kernels 1-5, as ``chip_smoke.py`` serves it);
* ``w12``: the main path with Swin-B at 384 px (window 12: the long-window
  attention), as ``chip_smoke.py``'s ``[shapes wide]`` ``.w12``;
* ``hd8``, ``hd40``: the main path at embed 72 over head width 8 and at
  embed 120 over head width 40 (the window attention's head-width
  instances), as ``chip_smoke.py``'s ``[shapes tail]`` ``.hd8`` and
  ``.hd40``;
* ``K``: path K (``kitti_default()`` with the unfused backbone, kernels 7
  and 8, bf16);
* ``F``: phase F (``semantic_kitti_default()`` as shipped, f32);
* ``Ef32``: path E in f32 (the capped eval encoder, kernels 10 and 9);
* ``ln``: kernel 9 alone at path E's five shapes, bf16 and f32, beside
  ``F.layer_norm``: event time over back-to-back wrapper calls, the
  device time of the kernels alone (``torch.profiler``) and the host's
  time a call (the clock around calls that do not wait for the device).

Each serving phase prints its ``[e2e ...]`` request times, its
``[profile ...]`` trace and an ``[ab]`` line per kernel it holds (error
and times). To compare two commits on one card, unpack both and run this
script on each in turns (parent, change, change, parent), one process a
run.
"""
import os
import sys
import time

# kernel 9's calls on path E (patch_norm, out_norm0-3): (B, L, C) tokens
LN_SHAPES = [(8, 125 * 125, 192), (8, 125 * 125, 192), (8, 63 * 63, 384),
             (8, 32 * 32, 768), (8, 16 * 16, 1536)]


def device_ms(torch, fn, reps):
    """Device time of the kernels ``fn`` launches, per call: the profiler's
    CUDA kernel rows over ``reps`` calls (no host time in it). The
    checkout's ``chip_smoke.py`` may predate its own ``device_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps


def host_ms(torch, fn, reps):
    """Host time of one call: the clock around ``reps`` calls that end in
    no synchronise (the device keeps up at the small shapes, so the queue
    never fills), per call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def ln_times(torch, cs, root, card):
    """Kernel 9 and ``F.layer_norm`` at ``LN_SHAPES`` in bf16 and f32: the
    CUDA-event time of back-to-back calls (``cs.cuda_ms``, host included),
    the device time and the host's time a call; per shape and summed."""
    import torch.nn.functional as F

    from mask_bev_tpu_torch.ops import layer_norm as kln

    for dtype in (torch.bfloat16, torch.float32):
        tot = dict.fromkeys(("kernel event", "kernel device", "kernel host",
                             "F.layer_norm event", "F.layer_norm device",
                             "F.layer_norm host"), 0.0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        for shape in LN_SHAPES:
            c = shape[-1]
            x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            w = (1 + 0.1 * torch.randn(c, device="cuda",
                                       generator=gen)).to(dtype)
            b = (0.1 * torch.randn(c, device="cuda", generator=gen)).to(dtype)
            run_k = lambda: kln.layer_norm(x, w, b)  # noqa: E731
            run_l = lambda: F.layer_norm(x, (c,), w, b, 1e-6)  # noqa: E731
            row = (cs.cuda_ms(torch, run_k, 20), device_ms(torch, run_k, 20),
                   host_ms(torch, run_k, 200), cs.cuda_ms(torch, run_l, 20),
                   device_ms(torch, run_l, 20), host_ms(torch, run_l, 200))
            for k, v in zip(tot, row):
                tot[k] += v
            print(f"[ab ln] {root} {dtype} {shape}: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in zip(tot, row))
                  + f" [{card}]", flush=True)
        print(f"[ab ln] {root} {dtype} five calls summed: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in tot.items())
              + f" [{card}]", flush=True)


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    phases = sys.argv[2:] or ["K", "F"]
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from mask_bev_tpu_torch.config import semantic_kitti_default
    from mask_bev_tpu_torch.kernels import build as kb

    if not torch.cuda.is_available():
        sys.exit("serve_ab: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    kb.build()
    kb.lib()
    card = torch.cuda.get_device_name(0)
    print(f"serve_ab {root}: kernels built in {time.time() - t0:.1f} s",
          flush=True)
    results, failures = {}, []

    def record(name, source, replaces, err, tol, ms, plain_ms, *a, **kw):
        results[name] = {"launches": 0}
        print(f"[ab] {root} {name}: max_abs_err {err:.6g} kernel {ms:.4f} "
              f"ms plain {plain_ms:.4f} ms [{card}]", flush=True)

    bf16 = semantic_kitti_default().replace(
        max_points_per_scan=131072, pseudo_image_norm="full",
        compute_dtype="bfloat16")
    for phase in phases:
        if phase == "main":
            cs.serve_phase(np, torch, card, results, failures, record, bf16,
                           "", cs.WARM, cs.TIMED, main_path=True)
        elif phase == "w12":
            cs.serve_phase(np, torch, card, results, failures, record,
                           bf16.replace(**cs.SWIN_B_384), ".w12",
                           cs.PATH_WARM, cs.PATH_TIMED)
        elif phase in ("hd8", "hd40"):
            cs.serve_phase(np, torch, card, results, failures, record,
                           bf16.replace(**getattr(cs, phase.upper())),
                           "." + phase, cs.PATH_WARM, cs.PATH_TIMED)
        elif phase == "K":
            cs.path_phase(np, torch, card, results, failures, record, "K")
        elif phase == "F":
            cs.serve_phase(np, torch, card, results, failures, record,
                           semantic_kitti_default().replace(
                               max_points_per_scan=131072),
                           ".f32", cs.PATH_WARM, cs.PATH_TIMED)
        elif phase == "Ef32":
            cs.path_phase(np, torch, card, results, failures, record, "E",
                          f32=True)
        elif phase == "ln":
            ln_times(torch, cs, root, card)
        else:
            sys.exit(f"serve_ab: unknown phase {phase}")
    print(f"serve_ab {root}: failures {failures}", flush=True)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
