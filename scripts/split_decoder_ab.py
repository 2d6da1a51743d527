#!/usr/bin/env python3
"""Time the decoder stack of one checkout at the split instance's shipped
shapes, for A/B runs.

    python3 scripts/split_decoder_ab.py <checkout root>

Imports ``chip_smoke.py`` and the port from the checkout given (its own
sources, built at first use) and times ``decoder_stack`` on the card at Q
45 and 170, C 256 over 8 heads, an FFN of 2048 and the main path's three
memory levels (16^2, 32^2, 63^2 keys), batch 8, bf16 and f32 (Q 45 in bf16
is the flagship instance, the rest the split instance; arguments drawn on
the device from a seed, the same in every checkout): event ms over
back-to-back calls and device ms (``chip_smoke.queued_ms``). To compare two
commits on one card, unpack the parent with ``git archive`` and run this
script on each in turns (parent, change, change, parent), one process a
run."""
import sys
import time

root = sys.argv[1]
sys.path.insert(0, root)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mask_bev_tpu_torch.kernels import build as kb  # noqa: E402
from mask_bev_tpu_torch.ops import decoder_stack as kdec  # noqa: E402

kb.lib()
LEV = (256, 1024, 3969)


def args(q, c, heads, f, dt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*s, sc=1.0, base=0.0):
        return base + sc * torch.randn(*s, generator=g, device="cuda")

    def mat(i, o):
        return rn(i, o, sc=i ** -0.5).to(dt)

    def vec(n, base=0.0):
        return rn(n, sc=0.05, base=base).to(dt).float()
    layers = [kdec.LayerWeights(
        mat(c, c), vec(c), mat(c, c), vec(c), mat(c, c), vec(c), mat(c, c),
        vec(c), mat(c, c), vec(c), mat(c, c), vec(c), mat(c, c), vec(c),
        mat(c, c), vec(c), vec(c, 1.0), vec(c), vec(c, 1.0), vec(c),
        vec(c, 1.0), vec(c), mat(c, f), vec(f), mat(f, c), vec(c))
        for _ in range(9)]
    head = kdec.HeadWeights(vec(c, 1.0), vec(c), mat(c, c), vec(c),
                            mat(c, c), vec(c), mat(c, c), vec(c))
    out0 = rn(8, q, c).to(dt)
    return (out0, rn(8, q, c).to(dt), rn(q, c).to(dt),
            [rn(8, t, c).to(dt) for t in LEV],
            [rn(t, c).to(dt) for t in LEV],
            [rn(8, t, c) for t in LEV], layers, head)


for q, dt in ((45, torch.bfloat16), (45, torch.float32),
              (170, torch.bfloat16), (170, torch.float32)):
    a = args(q, 256, 8, 2048, dt, q)
    packed = ({}, kdec.kv_weights(a[6], 3))
    run = lambda: kdec.decoder_stack(*a, num_heads=8, packed=packed)  # noqa
    run()
    torch.cuda.synchronize()
    kb.reset_launches()
    run()
    inst = [k for k in kb.INSTANCES if "gemm" not in k]
    ev = cs.cuda_ms(torch, run, 5)
    dev = cs.queued_ms(torch, run, 5)
    print(f"[split_ab {root}] Q {q} {str(dt)[6:]} {inst}: event {ev:.4f} "
          f"ms, device {dev:.4f} ms", flush=True)
