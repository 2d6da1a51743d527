#!/usr/bin/env python3
"""Run the PyTorch port of MaskBEV on one CUDA card and check its kernels.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernels from ``mask_bev_tpu_torch/csrc`` (nvcc, sm_90a);
2. drives the inference path once at the inputs a user would give it,
   ``semantic_kitti_default()`` (500x500 BEV grid, Swin-T embed 192 with
   int8 backbone products, 45 queries, 9 decoder layers) in bf16 at batch
   8 with 131072 point slots and ~120k real points per scan, random weights
   from a seed, and captures each kernel's inputs on the way;
3. holds every kernel against its plain PyTorch version on those inputs
   (stated tolerances; CUDA-event times of both);
4. serves warm and timed requests through ``MaskBevPredictor`` with the
   launch counters reset just before and read just after: every kernel must
   have launched; outputs must be finite and of the expected shapes;
5. checks a small model on the card against the same model run by the plain
   PyTorch path on the CPU;
6. prints one JSON line with every kernel's numbers, then, last, the device
   line ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when there is no CUDA device, when the
port cannot be imported, or when any phase fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SEED = 0
BATCH = 8
WARM, TIMED = 3, 10
HBM_BYTES_PER_S = 3.35e12
PEAK = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, reps: int, warm: int = 1) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, op_seconds: float):
    """(bound_ms, bound_by): the larger of the memory and operation times."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    return (max(t_bytes, op_seconds) * 1e3,
            "bytes" if t_bytes >= op_seconds else "operations")


def scans(np, batch: int, n: int, seed: int):
    """Synthetic scans as the JAX bench draws them: a disc of points out to
    50 m (out-of-grid points included), ~120k real points per scan."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(2, 50, (batch, n)) * np.sqrt(rng.uniform(0.1, 1, (batch, n)))
    th = rng.uniform(-np.pi, np.pi, (batch, n))
    pts = np.stack([r * np.cos(th), r * np.sin(th),
                    rng.uniform(-2, 1, (batch, n)),
                    rng.uniform(0, 1, (batch, n))], -1).astype(np.float32)
    mask = np.ones((batch, n), bool)
    mask[:, min(120_000, n):] = False
    return pts, mask


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA card to run on")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from mask_bev_tpu_torch.config import (
            semantic_kitti_default, tiny_test_config)
        from mask_bev_tpu_torch.inference import MaskBevPredictor
        from mask_bev_tpu_torch.kernels import build as kb
        from mask_bev_tpu_torch.models import mask2former as m2f
        from mask_bev_tpu_torch.models import swin as msw
        from mask_bev_tpu_torch.models.maskbev import MaskBev
        from mask_bev_tpu_torch.ops import canvas as kcanvas
        from mask_bev_tpu_torch.ops import decoder_stack as kdec
        from mask_bev_tpu_torch.ops import pfn as kpfn
        from mask_bev_tpu_torch.ops import swin_block as kswin
    except ImportError as e:
        fail(f"the port cannot be imported from {here}: {e}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(card, flush=True)

    t0 = time.time()
    lib = kb.build()
    kb.lib()
    print(f"kernels built in {time.time() - t0:.1f} s ({lib})", flush=True)
    for log in sorted(lib.parent.glob("*.log")):
        regs = [ln.strip() for ln in log.read_text().splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[ptxas {log.stem}] " + " | ".join(regs[-6:]), flush=True)

    cfg = semantic_kitti_default().replace(
        max_points_per_scan=131072, pseudo_image_norm="full",
        compute_dtype="bfloat16")
    sd = MaskBev(cfg).random_state_dict(SEED)
    pred = MaskBevPredictor(cfg, sd, device="cuda")
    model = pred.model
    pts_np, mask_np = scans(np, BATCH, cfg.max_points_per_scan, SEED)
    pts = torch.as_tensor(pts_np).cuda().to(torch.bfloat16)
    msk = torch.as_tensor(mask_np).cuda()
    results = {}
    failures = []

    def record(name, source, replaces, err, tol, ms, plain_ms, bnd, extra="",
               ok=None):
        ok = err <= tol if ok is None else ok
        tol_s = f"tolerance {tol:.6g}" if tol == tol else "see below"
        print(f"[{name}] max_abs_err {err:.6g} ({tol_s}) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}) {extra} -> "
              f"{'ok' if ok else 'FAIL'} [{card}]", flush=True)
        if not ok:
            failures.append(name)
        results[name] = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=0, max_abs_err=float(err), ms=float(ms),
            plain_ms=float(plain_ms), bound_ms=float(bnd[0]),
            bound_by=bnd[1], library_ms=None)

    # ---- capture every kernel's main-path inputs (one forward) ----------
    captured_blocks, captured_dec = [], []
    orig_block, orig_dec = msw.swin_block, m2f.decoder_stack

    def rec_block(x, *args):
        captured_blocks.append((x.clone(), *args))
        return orig_block(x, *args)

    def rec_dec(*args, **kw):
        captured_dec.append((args, kw))
        return orig_dec(*args, **kw)

    msw.swin_block, m2f.decoder_stack = rec_block, rec_dec
    try:
        with torch.no_grad():
            enc = model.encoder
            ps, table, stats = enc.pillar_table(pts, msk)
            model(pts, msk)
    finally:
        msw.swin_block, m2f.decoder_stack = orig_block, orig_dec
    torch.cuda.synchronize()

    with torch.no_grad():
        # ---- kernel 1: PFN -----------------------------------------------
        pfn_net = enc.pillar_feature_net
        weights = pfn_net.folded_weights()
        kw = dict(point_dim=pfn_net.point_dim,
                  with_distance=pfn_net.with_distance, grid_w=enc.grid_hw[1],
                  voxel_size=enc.voxel_size, x0=enc.x_range[0],
                  y0=enc.y_range[0])
        t_plain, s_plain = kpfn.pfn_plain(ps, weights, out_dtype=pts.dtype,
                                          **kw)
        P = ps.num_pillars.long()
        rows = torch.arange(table.shape[1], device=pts.device)[None] < P[:, None]
        diff = (table.float() - t_plain.float()).abs()[rows]
        err = float(diff.max())
        scale = float(t_plain.float().abs().max())
        st_err = float(((stats - s_plain).abs() / s_plain.abs().clamp(min=1))
                       .max())
        packed = kpfn.pack_weights(weights, pts.device)
        run_k = lambda: kpfn.pfn(ps, weights, max_points_per_pillar=enc.k,  # noqa: E731
                                 out_dtype=pts.dtype, packed=packed, **kw)
        run_p = lambda: kpfn.pfn_plain(ps, weights, out_dtype=pts.dtype, **kw)  # noqa: E731
        ms_k = cuda_ms(torch, run_k, 10)
        ms_p = cuda_ms(torch, run_p, 3)
        kept = float(ps.counts.sum())
        n_pil = float(P.sum())
        macs = sum(w.shape[0] * w.shape[1] for (w, _, _) in weights)
        c_out = table.shape[-1]
        # the products' type is the weights' (bf16 here: the kernel takes no
        # other), with f32 accumulation
        w_type = "bf16" if weights[0][0].dtype == torch.bfloat16 else "f32"
        bnd = bound(BATCH * cfg.max_points_per_scan * 16 + n_pil * 12
                    + n_pil * c_out * 2 + 8 * BATCH,
                    2 * kept * macs / PEAK[w_type])
        record("pfn", "mask_bev_tpu_torch/csrc/pfn.cu",
               "mask_bev_tpu/ops/pallas_pfn.py:384", err, 2e-2 * scale,
               ms_k, ms_p, bnd,
               f"stats rel err {st_err:.3g}; pillars {int(n_pil)} kept "
               f"points {int(kept)}")
        if st_err > 1e-3:
            failures.append("pfn stats")

        # ---- kernel 2: canvas + pseudo-image norm ------------------------
        h, w = enc.grid_hw
        elems = float(h * w * c_out)
        mean = stats[:, 0] / elems
        var = stats[:, 1] / elems - mean * mean
        args = (table, ps.cells, ps.num_pillars, mean, var,
                enc.norm.weight.detach(), enc.norm.bias.detach(), (h, w),
                enc.norm.eps)
        got = kcanvas.canvas_norm(*args)
        want = kcanvas.canvas_norm_plain(table, ps.cells, mean, var,
                                         *args[5:])
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        ms_k = cuda_ms(torch, lambda: kcanvas.canvas_norm(*args), 10)
        ms_p = cuda_ms(torch, lambda: kcanvas.canvas_norm_plain(
            table, ps.cells, mean, var, *args[5:]), 3)
        bnd = bound(BATCH * h * w * c_out * 2 + 2 * h * w * c_out * 2
                    + n_pil * (c_out * 2 + 4),
                    4.0 * BATCH * h * w * c_out / PEAK["f32"])
        record("canvas_norm", "mask_bev_tpu_torch/csrc/canvas.cu",
               "mask_bev_tpu/ops/pallas_canvas.py:244", err, 1e-2 * scale,
               ms_k, ms_p, bnd)

        # ---- kernel 3: Swin block (all 12 blocks of the backbone) --------
        err_abs, err_rel, ms_k, ms_p, b_ops, b_bytes = (0.0,) * 6
        for (x, p, hw, win, heads, shift, quant) in captured_blocks:
            a = (x, p, hw, win, heads, shift, quant)
            got = kswin.swin_block(*a)
            want = kswin.swin_block_plain(*a)
            e = float((got.float() - want.float()).abs().max())
            err_abs = max(err_abs, e)
            err_rel = max(err_rel, e / float(want.float().abs().max()))
            ms_k += cuda_ms(torch, lambda: kswin.swin_block(*a), 3)
            ms_p += cuda_ms(torch, lambda: kswin.swin_block_plain(*a), 1)
            b_, l_, c_ = x.shape
            hp, wp = -(-hw[0] // win) * win, -(-hw[1] // win) * win
            gemm_ops = 2.0 * b_ * l_ * 12 * c_ * c_
            attn_ops = 4.0 * b_ * hp * wp * win * win * c_
            b_ops += (gemm_ops / PEAK["int8" if quant else "bf16"]
                      + attn_ops / PEAK["bf16"])
            b_bytes += 2 * b_ * l_ * c_ * 2 + 12 * c_ * c_
        record("swin_block", "mask_bev_tpu_torch/csrc/swin_block.cu",
               "mask_bev_tpu/ops/pallas_swin_block.py:584", err_abs,
               float("nan"), ms_k, ms_p, bound(b_bytes, b_ops),
               f"largest error relative to its block's max-abs {err_rel:.4g} "
               f"(tolerance 0.02); {len(captured_blocks)} blocks summed",
               ok=err_rel <= 2e-2)

        # ---- kernel 4: decoder stack -------------------------------------
        (dargs, dkw) = captured_dec[0]
        out_k, kbits = kdec.decoder_stack(*dargs, **dkw, return_bits=True)
        layers, head = dargs[6], dargs[7]
        out_p, plogits = kdec.decoder_stack_plain(
            *dargs[:8], num_heads=dkw["num_heads"], return_logits=True)
        flips = [int((kb_ != kdec.blocked_positions(m)).sum())
                 for kb_, m in zip(kbits, plogits)]
        total = sum(m.numel() for m in plogits)
        err = float((out_k.float() - out_p.float()).abs().max())
        scale = float(out_p.float().abs().max())
        same, same_logits = kdec.decoder_stack_plain(
            *dargs[:8], num_heads=dkw["num_heads"], blocked=kbits,
            return_logits=True)
        err_same = float((out_k.float() - same.float()).abs().max())
        if err_same > 2e-2 * scale:
            failures.append("decoder_stack on its own blocked positions")
        # given the kernel's decisions, the plain version's own logits (its
        # decoder norm and mask MLP) may decide otherwise only within
        # rounding of 0; free-running flips compound, bounded more loosely
        own = [int((kb_ != kdec.blocked_positions(m)).sum())
               for kb_, m in zip(kbits, same_logits)]
        for li, m in enumerate(plogits):
            if flips[li] > 0.05 * m.numel() or own[li] > 0.01 * m.numel():
                failures.append(f"decoder_stack bias flips in layer {li}")
        ms_k = cuda_ms(torch, lambda: kdec.decoder_stack(*dargs, **dkw), 5)
        ms_p = cuda_ms(torch, lambda: kdec.decoder_stack_plain(
            *dargs[:8], num_heads=dkw["num_heads"]), 2)
        q_, c_ = dargs[0].shape[1], dargs[0].shape[2]
        ts = [m.shape[1] for m in dargs[3]]
        f_ = layers[0].f1.shape[1]
        n_l = len(layers)
        ops = 0.0
        for li in range(n_l):
            t_ = ts[li % len(ts)]
            ops += BATCH * (2 * q_ * c_ * c_ * 9 + 4 * q_ * c_ * f_
                            + 6 * q_ * t_ * c_ + 4 * q_ * q_ * c_)
        ops += 2 * 2 * BATCH * sum(ts) * c_ * c_ * (n_l // len(ts))
        byts = (BATCH * sum(ts) * c_ * (2 + 4) + sum(ts) * c_ * 2
                + n_l * (8 * c_ * c_ + 2 * c_ * f_) * 2 + BATCH * q_ * c_ * 2)
        record("decoder_stack", "mask_bev_tpu_torch/csrc/decoder_stack.cu",
               "mask_bev_tpu/ops/pallas_decoder_stack.py:200", err,
               5e-2 * scale, ms_k, ms_p, bound(byts, ops / PEAK["bf16"]),
               f"bias entries that differ: {sum(flips)} of {total}, per "
               f"layer {flips} (tolerance 5 % a layer), on the kernel's own "
               f"decisions {own} (tolerance 1 % a layer); max_abs_err on "
               f"the kernel's own blocked positions {err_same:.6g} "
               f"(tolerance {2e-2 * scale:.6g})")

    # ---- the main path: serve requests through the predictor -------------
    staged = []
    for s in range(4):
        p_np, m_np = scans(np, BATCH, cfg.max_points_per_scan, 100 + s)
        staged.append((torch.as_tensor(p_np).cuda(),
                       torch.as_tensor(m_np).cuda()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    for i in range(WARM):
        cls_p, mask_p = pred.forward(*staged[i % 4])
    torch.cuda.synchronize()
    times = []
    for i in range(TIMED):
        t1 = time.perf_counter()
        cls_p, mask_p = pred.forward(*staged[i % 4])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches = dict(kb.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    requests = WARM + TIMED
    ms_batch = float(np.median(times) * 1e3)
    print(f"[e2e] {requests} requests of batch {BATCH}: median "
          f"{ms_batch:.3f} ms/batch, mean {np.mean(times) * 1e3:.3f} ms, "
          f"{BATCH / (ms_batch / 1e3):.2f} scans/s, peak memory "
          f"{peak_gb:.2f} GiB [{card}]", flush=True)
    print(f"[e2e] launches over the {requests} requests: {launches}",
          flush=True)
    for k in results:
        results[k]["launches"] = launches.get(k, 0)
        if launches.get(k, 0) <= 0:
            failures.append(f"{k} never launched on the main path")
    hg, wg = cfg.grid_hw
    exp_cls = (BATCH, cfg.num_queries, cfg.head_num_classes + 1)
    exp_mask = (BATCH, cfg.num_queries, hg // 4, wg // 4)
    if tuple(cls_p.shape) != exp_cls or tuple(mask_p.shape) != exp_mask:
        failures.append(f"output shapes {tuple(cls_p.shape)} "
                        f"{tuple(mask_p.shape)}")
    if not (torch.isfinite(cls_p).all() and torch.isfinite(mask_p).all()):
        failures.append("non-finite outputs")
    print(f"[e2e] class probs {tuple(cls_p.shape)} mask probs "
          f"{tuple(mask_p.shape)}; mean mask prob "
          f"{float(mask_p.mean()):.4f}", flush=True)

    # ---- where the time goes: one traced request --------------------------
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        pred.forward(*staged[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    from torch.autograd import DeviceType

    # kernel rows only: an operator's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[profile] one request: device busy {busy_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall (idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}) [{card}]", flush=True)
    for e in events[:16]:
        print(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)

    # ---- small model: the card against the plain CPU path -----------------
    small = tiny_test_config().replace(
        head_num_attn_heads=2, compute_dtype="bfloat16",
        backbone_quantize="int8")
    ssd = MaskBev(small).random_state_dict(SEED + 1)
    sp, sm = scans(np, 2, small.max_points_per_scan, SEED + 2)
    sp[..., :2] *= 0.25  # into the 20 m grid
    sm[:, 1800:] = False
    c_gpu, m_gpu = MaskBevPredictor(small, ssd, device="cuda").forward(
        torch.as_tensor(sp), torch.as_tensor(sm))
    c_cpu, m_cpu = MaskBevPredictor(small, ssd, device="cpu").forward(
        torch.as_tensor(sp), torch.as_tensor(sm))
    d_cls = float((c_gpu.cpu() - c_cpu).abs().max())
    d_mask = float((m_gpu.cpu() - m_cpu).abs().mean())
    ok = d_cls <= 0.1 and d_mask <= 0.02
    print(f"[small] card vs CPU plain path: class probs max diff {d_cls:.4g} "
          f"(tolerance 0.1), mask probs mean diff {d_mask:.4g} (tolerance "
          f"0.02) -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("small model card vs CPU")

    print(json.dumps({"kernels": [results[k] for k in (
        "pfn", "canvas_norm", "swin_block", "decoder_stack")]}), flush=True)
    if failures:
        fail("; ".join(failures))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
