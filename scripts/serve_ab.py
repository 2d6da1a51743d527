#!/usr/bin/env python3
"""Serve path K (bf16) and phase F of ``chip_smoke.py`` with one checkout.

    python3 scripts/serve_ab.py <checkout root>

Imports ``chip_smoke.py`` and the port from the checkout given (its own
sources, built at first use) and runs two of its serving phases on the
card: path K (``kitti_default()`` with the unfused backbone, kernels 7 and
8) and phase F (``semantic_kitti_default()`` as shipped, f32). Each prints
its ``[e2e ...]`` request times and its ``[profile ...]`` trace. To compare
two commits on one card, unpack both and run this script on each in turns
(parent, change, change, parent), one process a run.
"""
import os
import sys


def main() -> None:
    root = os.path.abspath(sys.argv[1])
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
    kb.build()
    kb.lib()
    card = torch.cuda.get_device_name(0)
    results, failures = {}, []

    def record(name, *a, **kw):
        results[name] = {"launches": 0}

    cs.path_phase(np, torch, card, results, failures, record, "K")
    cs.serve_phase(np, torch, card, results, failures, record,
                   semantic_kitti_default().replace(
                       max_points_per_scan=131072),
                   ".f32", cs.PATH_WARM, cs.PATH_TIMED)
    print(f"serve_ab {root}: failures {failures}", flush=True)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
