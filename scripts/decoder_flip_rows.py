#!/usr/bin/env python3
"""Where the decoder stack's bf16 decisions part from its plain version's,
row by row.

    python3 scripts/decoder_flip_rows.py <checkout root> [D:seed ...]

For each mask-embedding width D and model seed (default ``257:138 257:20
512:20 64:20 1:20``) it captures one forward's decoder-stack arguments of
the main path's configuration at that D (``chip_smoke.decoder_call``: bf16,
45 queries, C 256 over 8 heads, random weights from ``chip_smoke.SEED +
seed``), runs the kernel with its effective blocked positions, runs the
plain version on those positions, and prints per layer the entries the
plain version's own logits decide otherwise (``chip_smoke.decoder_hold``'s
"on the kernel's own decisions"), the rows they fall in, and the rows that
differ in over half their keys: how many of those the kernel cleared
(every key blocked) and how many the plain version's raw logits block
entirely, with the plain rows' open keys; then the disagreements beyond
rounding that the holds count (``decoder_stack.decision_flips``: a
decision outside its logit's ``logit_band``, a row the every-key-blocked
rule turns over once) and the share of the layer's entries inside the
band.
"""
import sys

root = sys.argv[1]
sys.path.insert(0, root)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mask_bev_tpu_torch.config import semantic_kitti_default  # noqa: E402
from mask_bev_tpu_torch.ops import decoder_stack as kdec  # noqa: E402

cases = [tuple(int(v) for v in a.split(":")) for a in sys.argv[2:]] or [
    (257, 138), (257, 20), (512, 20), (64, 20), (1, 20)]
base = semantic_kitti_default().replace(max_points_per_scan=131072)
for d, seed in cases:
    dcfg = base.replace(num_queries=45, head_feat_channels=256,
                        head_out_channels=d, head_num_attn_heads=8,
                        pseudo_image_norm="full", compute_dtype="bfloat16")
    dargs, dkw = cs.decoder_call(np, torch, dcfg, cs.SEED + seed)
    with torch.no_grad():
        out_k, kbits = kdec.decoder_stack(*dargs, **dkw, return_bits=True)
        same, same_logits, bands = kdec.decoder_stack_plain(
            *dargs[:8], num_heads=8, blocked=kbits, return_logits=True,
            return_bands=True)
    beyond = kdec.decision_flips(kbits, same_logits, bands)
    for li, (kb_, m) in enumerate(zip(kbits, same_logits)):
        raw = m < 0
        rows = (kb_ != kdec.blocked_positions(m)).sum(-1)  # (B, Q)
        n = int(rows.sum())
        big = rows > 0.5 * m.shape[-1]
        print(f"D {d} seed {seed} layer {li}: T {m.shape[-1]} own flips {n} "
              f"({100 * n / m.numel():.3f} %), rows with flips "
              f"{int((rows > 0).sum())}, rows over half the keys "
              f"{int(big.sum())}: kernel cleared "
              f"{int((big & ~kb_.any(-1)).sum())}, plain all-blocked "
              f"{int((big & raw.all(-1)).sum())}, plain open keys in those "
              f"rows {(~raw).sum(-1)[big].tolist()[:8]}, row flips "
              f"{sorted(rows[rows > 0].tolist(), reverse=True)[:8]}; beyond "
              f"rounding {beyond[li]} ({100 * beyond[li] / m.numel():.3f} "
              f"%), in the band "
              f"{100 * float((m.abs() <= bands[li]).float().mean()):.3f} %",
              flush=True)
