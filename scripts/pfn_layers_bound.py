#!/usr/bin/env python3
"""Where kernel 1's bf16 hold at 8 layers should sit, read on the card:
the kernel's error against its plain version over seeds, beside the error
of faults planted in the weights the kernel is given.

    python3 scripts/pfn_layers_bound.py [--seeds N] [--out DIR]

The case is ``chip_smoke.py``'s ``pfn.l8``: ``feat_channels`` (64,) * 7 +
(32,), i.e. 8 layers of 32 units, each fed [z, pooled] of the one before,
on ``semantic_kitti_default`` at 131072 point slots a scan, the main
path's batch of scans (``chip_smoke.scans``), the encoder's weights drawn
from ``torch.manual_seed`` and its batch norms' running statistics and
affine from the next seed (``chip_smoke.draw_pfn_norms``: each layer's
folded affine far from the identity, so a fault in it shows). The error
is ``chip_smoke.py``'s: the
largest absolute difference over the occupied rows of the pillar table,
over the largest absolute value of the plain version's.

* seeds: the weights of seeds ``chip_smoke.SEED + 96`` (the smoke's) and
  N - 1 more (default N = 16) on the smoke's scans, and the smoke's
  weights on two other draws of scans;
* faults, each on the smoke's weights and scans, the plain version given
  the true weights: ``affine3`` (layer 3's folded affine dropped: scale 1,
  bias 0), ``unit3`` (layer 3's first unit's weight column zeroed),
  ``scale7_6`` / ``scale7_8`` (the last layer's scale times 1 + 2^-6 /
  1 + 2^-8), ``pooled3`` (the pooled half of layer 3's input dropped: the
  next layer's weight rows for it zeroed).

``csrc/pfn.cu`` and ``errors.cu`` are built alone into DIR (default
``_checkout/pfn_bound_build``; ``long_attn_profile.py``'s builder) and
loaded into the checkout's ``mask_bev_tpu_torch``. Prints one JSON line a
reading, the card's name and power limit, and a summary: the largest
error over the seeds and the smallest over the faults.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
LAYERS = (64,) * 7 + (32,)


def _module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plant(weights, fault: str):
    """The weights with ``fault`` planted (a new list; the tensors the
    fault touches cloned)."""
    out = [list(t) for t in weights]
    if fault == "affine3":
        w, g, b = out[3]
        out[3] = [w, g.clone().fill_(1.0), b.clone().zero_()]
    elif fault == "unit3":
        w = out[3][0].clone()
        w[:, 0] = 0
        out[3][0] = w
    elif fault.startswith("scale7_"):
        out[7][1] = out[7][1] * (1.0 + 2.0 ** -int(fault[-1]))
    elif fault == "pooled3":
        w = out[4][0].clone()
        w[w.shape[0] // 2:] = 0  # layer 4's input: [z, pooled] of layer 3
        out[4][0] = w
    else:
        raise ValueError(fault)
    return [tuple(t) for t in out]


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the reading runs on the card")
    n_seeds = (int(sys.argv[sys.argv.index("--seeds") + 1])
               if "--seeds" in sys.argv else 16)
    out = pathlib.Path(sys.argv[sys.argv.index("--out") + 1]
                       if "--out" in sys.argv
                       else "_checkout/pfn_bound_build").resolve()
    out.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(ROOT))
    smoke = _module(ROOT / "chip_smoke.py", "chip_smoke")
    lap = _module(HERE / "long_attn_profile.py", "long_attn_profile")
    srcs = ("pfn.cu", "errors.cu")
    d, procs = lap.prepare(ROOT, "pfn", out, srcs, "common.cuh", {})
    if any(p.wait() for p in procs):
        logs = "".join(p.read_text() for p in d.glob("*.log"))
        raise SystemExit(f"build failed\n{logs[-4000:]}")
    from mask_bev_tpu_torch.config import semantic_kitti_default
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.models.encoder import MaskBevEncoder
    from mask_bev_tpu_torch.ops import pfn as kpfn

    kb._lib = ctypes.CDLL(str(lap.link(d, srcs)))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    cfg = semantic_kitti_default().replace(max_points_per_scan=131072)
    dev, dt = "cuda", torch.bfloat16

    def reading(wseed: int, sseed: int, fault=None) -> dict:
        torch.manual_seed(wseed)
        enc = MaskBevEncoder(
            cfg.x_range, cfg.y_range, cfg.z_range, cfg.voxel_size,
            feat_channels=LAYERS, max_points_per_pillar=cfg.max_num_points,
            max_pillars=cfg.max_num_pillars)
        smoke.draw_pfn_norms(torch, enc, wseed + 1)
        enc = enc.to(dev, dt).eval()
        pts_np, mask_np = smoke.scans(np, smoke.BATCH,
                                      cfg.max_points_per_scan, sseed)
        pts = torch.as_tensor(pts_np).to(dev, dt)
        msk = torch.as_tensor(mask_np).to(dev)
        net = enc.pillar_feature_net
        weights = net.folded_weights()
        kw = dict(with_distance=net.with_distance, grid_w=enc.grid_hw[1],
                  voxel_size=enc.voxel_size, x0=enc.x_range[0],
                  y0=enc.y_range[0], point_dim=net.point_dim)
        ps, _, _ = enc.pillar_table(pts, msk)  # the stream (and one launch)
        given = plant(weights, fault) if fault else weights
        table, _ = kpfn.pfn(ps, given, max_points_per_pillar=enc.k,
                            out_dtype=dt, **kw)
        want, _ = kpfn.pfn_plain(ps, weights, out_dtype=dt, **kw)
        rows = (torch.arange(table.shape[1], device=dev)[None]
                < ps.num_pillars.long()[:, None])
        err = float((table.double() - want.double()).abs()[rows].max())
        scale = float(want.double().abs()[rows].max())
        res = {"weights_seed": wseed, "scans_seed": sseed, "fault": fault,
               "err": err, "scale": scale, "rel": err / scale}
        print(json.dumps(res), flush=True)
        return res

    base_w, base_s = smoke.SEED + 96, smoke.SEED + 95
    with torch.no_grad():
        seeds = [reading(base_w + i, base_s) for i in range(n_seeds)]
        seeds += [reading(base_w, base_s + 100 + i) for i in range(2)]
        faults = [reading(base_w, base_s, f) for f in
                  ("affine3", "unit3", "scale7_6", "scale7_8", "pooled3")]
    worst = max(seeds, key=lambda r: r["rel"])
    print(json.dumps({
        "seeds": len(seeds), "seeds_max_rel": worst["rel"],
        "seeds_max_at": [worst["weights_seed"], worst["scans_seed"]],
        "faults_rel": {r["fault"]: r["rel"] for r in faults}}), flush=True)


if __name__ == "__main__":
    main()
