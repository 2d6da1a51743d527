#!/usr/bin/env python3
"""Run the PyTorch port of MaskBEV on one CUDA card and check its kernels.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernels from ``mask_bev_tpu_torch/csrc`` (nvcc, sm_90a);
2. drives the inference path once at the inputs a user would give it
   (``serve_phase``), ``semantic_kitti_default()`` (500x500 BEV grid,
   Swin-T embed 192 with int8 backbone products, 45 queries, 9 decoder
   layers) in bf16 at batch 8 with 131072 point slots and ~120k real
   points per scan, random weights from a seed, and captures each kernel's
   inputs on the way;
3. holds every kernel against its plain PyTorch version on those inputs
   (stated tolerances; CUDA-event times of both); for the Swin chain also
   the times of its launches by kind and of ``torch._int_mm`` on one
   stage-0 product (a yardstick for the
   product alone), its window attention alone (``attn_phase``: held
   against its plain version, timed beside
   ``F.scaled_dot_product_attention`` on the same windows), and for the
   decoder stack the number of clusters of 8, 12 and 16 blocks the card
   holds at once;
4. serves warm and timed requests through ``MaskBevPredictor`` with the
   launch counters reset just before and read just after: every kernel must
   have launched; outputs must be finite and of the expected shapes;
5. checks a small model on the card against the same model run by the plain
   PyTorch path on the CPU;
5b. drives the two serving paths of kernels 7-10 (``path_phase``): path K,
   ``kitti_default()`` (800x800 grid, 3 classes) with the unfused backbone
   (window MSA, kernel 7, on the token grid: its attention alone with the
   SDPA yardstick too, and no ``roll`` in the traced request), the
   fused patch embed (kernel 8: f32 held against float64, the bound as
   3xTF32 and as f32 FMAs, ``F.conv2d`` on the same canvas timed beside it
   as a yardstick for the product alone) and the canvas (kernel 2) at
   its 800x800 grid with a full-mode affine, and path E,
   ``semantic_kitti_default()`` with the capped eval encoder (kernel 10)
   and the backbone's fused token LN (kernel 9: its event time over
   back-to-back wrapper calls and its device time alone from the
   profiler, ``F.layer_norm`` beside it both ways); each captures its new
   kernels' inputs in one forward, holds them against their plain versions,
   serves 3 warm and 5 timed requests with the counters reset just before
   and traces one request; then both paths again in f32 (the f32 instances
   of kernels 7-10, kernel 10's 3xTF32 also against float64, 1 warm and 2
   timed requests);
5c. phase F: ``semantic_kitti_default()`` as shipped (f32, int8 backbone)
   and phase W: ``waymo_default()`` as shipped (f32, 170 queries on the
   decoder's split instance, 3 point columns), each like step 2-4: kernels
   1-5 captured and held in f32 (kernel 1's 3xTF32 also against float64,
   the Swin chain's f32 attention alone,
   the decoder with its flip counters and its time by part,
   ``split_breakdown``), 3 warm and 5 timed requests
   whose instance counters must show the f32 instances (the 3xTF32 GEMM,
   the tensor-core split decoder) and no removed design, one traced
   request; phase W also holds the 3xTF32 GEMM alone at a stage-0 and a
   stage-3 fc1 product against a float64 product and times
   ``torch.addmm`` in full f32 beside it (``gemm_yardstick``);
6. drives the training step (``train_step``) at the training envelope of
   the JAX bench: the same configuration with ``max_num_pillars=32768``, a
   bf16 forward over f32 master weights, batch 4, AdamW, synthetic scans of
   ~120k points (``datasets/synthetic.py``), random weights from a seed;
   captures the inputs of the training kernels (A: canvas scatter, B: its
   gradient, C: the matcher) in one step and holds each against its plain
   version (A and B exactly, C with equal assignments); then 2 warm and 5
   timed steps with the launch counters reset just before and read just
   after: every training kernel must have launched, losses and gradients
   must be finite and the parameters must change; then one traced step;
7. checks one small training step on the card against the same step on the
   plain CPU path (same weights, batch and pinned loss points), in f32 and
   in bf16;
8. ``[shapes]`` (``shapes_phase``): ``tiny_test_config()`` with its own 8
   heads (head width 8: the decoder stack's split instance) on the card
   against the CPU; the canvas at B = 184 (over one launch's 183: two
   launches) against its plain version, bit for bit; a shape a kernel
   refuses raises on the card (there is no plain route there), so every
   flagship phase above ran on its kernels;
9. ``[trainer]`` (``trainer_phase``): ``Trainer.fit`` at the widths of
   ``configs/training/semantic_kitti/02_train_smoke_tpu.yml`` (3 training
   and 2 validation batches an epoch, 2 epochs), the ``--test`` restore of
   ``best`` with a validation and the per-layer metrics, then
   ``MaskBevPredictor.from_checkpoint`` serving 8 scans with ``boxes``
   (and again from random weights with the class head biased to class 1,
   so that every query predicts an object, the boxes held against
   ``mask_to_boxes`` on the card's probabilities):
   step, validation and checkpoint times, peak memory, and the launches
   of kernels A-C and 1-5;
10. ``[resume]`` (``resume_phase``): the tiny config fitted 2 epochs
   unbroken against 1 epoch plus a resume from ``last``, compared bitwise
   (or within a stated tolerance where the card's kernels are not
   deterministic);
11. ``[data]`` (``data_phase``): SemanticKITTI and KITTI trees written
   in the datasets' on-disk formats from the seed at real scale
   (``datasets/disk_trees.py``: ~120k points a scan), the C++ host core
   against its numpy twins at 500x500 and 800x800, host ms a sample (cache
   miss, hit, augmentations, KITTI's GT paste), one epoch's batches with 0
   and 4 worker processes (bitwise equal, batches/s), ``Trainer.fit`` on
   ``01_semantic_kitti.yml`` and ``01_kitti.yml`` as shipped (f32, batch 4,
   the shipped augmentations, 4 workers; one cut epoch, then the
   ``--test`` restore of ``best``): step, validation, host-to-device and
   prefetch-wait times, peak memory, the card's idle share over the
   training steps, the launches of kernels A-C and 1-3, finite losses,
   changed parameters and no live worker process; then the CLI
   ``train_mask_bev_torch.py --train --test`` on the SemanticKITTI tree;
12. prints one JSON line with every kernel's numbers, then, last, the
   device line ``{"ok": true, "device": {...}}``.

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
TRAIN_BATCH = 4
TRAIN_WARM, TRAIN_TIMED = 2, 5
# the canvas at a batch over one launch's limit: (B, H, W, C, table rows);
# the fault is in B, so the grid is 200x200 (the main path's 500x500 at B =
# 184 would need ~12 GB of bf16 canvas before the plain version's f32 copy)
CANVAS_B184 = (184, 200, 200, 128, 16384)
PATH_WARM, PATH_TIMED = 3, 5
HBM_BYTES_PER_S = 3.35e12
# f32 products on the tensor cores as 3xTF32 (three TF32 products a
# multiply-add) take 3 x ops / 495 TFLOP/s: a third of the TF32 rate
PEAK = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12,
        "tf32x3": 495e12 / 3}
# instances of designs that later slices removed: no path may launch them
# (kernel 7's attention on partitioned windows, "window_msa/bf16" and
# "window_msa/f32", gave way to the window-attention template; the PFNs'
# f32 FMA instances, "pfn/f32" and "stream_pfn/f32", to 3xTF32)
REMOVED = ("swin_block/gemm_f32", "window_msa/gemm_f32",
           "decoder_stack/gemm_f32", "decoder_stack/split_f32",
           "decoder_stack/split_bf16", "window_msa/bf16", "window_msa/f32",
           "pfn/f32", "stream_pfn/f32")
ATTN_SOURCE = "mask_bev_tpu_torch/csrc/window_attn.cuh"


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


def device_ms(torch, fn, reps: int) -> float:
    """Device time of the kernels ``fn`` launches, per call: the profiler's
    CUDA kernel rows over ``reps`` back-to-back calls, without the host's
    time between them (which ``cuda_ms`` includes)."""
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
            semantic_kitti_default, tiny_test_config, waymo_default)
        from mask_bev_tpu_torch.inference import MaskBevPredictor
        from mask_bev_tpu_torch.kernels import build as kb
        from mask_bev_tpu_torch.models.maskbev import MaskBev
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

    results = {}
    failures = []

    def record(name, source, replaces, err, tol, ms, plain_ms, bnd, extra="",
               ok=None, library_ms=None):
        ok = err <= tol if ok is None else ok
        tol_s = f"tolerance {tol:.6g}" if tol == tol else "see below"
        lib_s = "" if library_ms is None else f" library {library_ms:.4f} ms"
        print(f"[{name}] max_abs_err {err:.6g} ({tol_s}) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms{lib_s} bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}) {extra} -> "
              f"{'ok' if ok else 'FAIL'} [{card}]", flush=True)
        if not ok:
            failures.append(name)
        results[name] = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=0, max_abs_err=float(err), ms=float(ms),
            plain_ms=float(plain_ms), bound_ms=float(bnd[0]),
            bound_by=bnd[1],
            library_ms=None if library_ms is None else float(library_ms))

    # ---- the main path: the bf16 serving path, kernels 1-5 ----------------
    cfg = semantic_kitti_default().replace(
        max_points_per_scan=131072, pseudo_image_norm="full",
        compute_dtype="bfloat16")
    serve_phase(np, torch, card, results, failures, record, cfg, "", WARM,
                TIMED, main_path=True)

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
    torch.cuda.empty_cache()

    path_phase(np, torch, card, results, failures, record, "K")
    path_phase(np, torch, card, results, failures, record, "E")
    # kernels 7-10 at f32: the same paths in the shipped dtype
    path_phase(np, torch, card, results, failures, record, "K", f32=True)
    path_phase(np, torch, card, results, failures, record, "E", f32=True)
    # phase F: the shipped flagship configuration (f32, int8 backbone)
    serve_phase(np, torch, card, results, failures, record,
                semantic_kitti_default().replace(max_points_per_scan=131072),
                ".f32", PATH_WARM, PATH_TIMED)
    # phase W: Waymo as shipped (f32, 170 queries, 3 point columns)
    serve_phase(np, torch, card, results, failures, record,
                waymo_default().replace(max_points_per_scan=131072),
                ".waymo", PATH_WARM, PATH_TIMED)
    train_phase(np, torch, card, results, failures, record)
    shapes_phase(np, torch, card, failures)
    trainer_phase(np, torch, card, failures, here)
    resume_phase(np, torch, card, failures, here)
    data_phase(np, torch, card, failures, here)

    print(json.dumps({"kernels": list(results.values())}), flush=True)
    if failures:
        fail("; ".join(failures))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


# kernel -> (source, TPU function it replaces)
SOURCES = {
    "pfn": ("mask_bev_tpu_torch/csrc/pfn.cu",
            "mask_bev_tpu/ops/pallas_pfn.py:384"),
    "canvas_norm": ("mask_bev_tpu_torch/csrc/canvas.cu",
                    "mask_bev_tpu/ops/pallas_canvas.py:244"),
    "swin_block": ("mask_bev_tpu_torch/csrc/swin_block.cu",
                   "mask_bev_tpu/ops/pallas_swin_block.py:584"),
    "decoder_stack": ("mask_bev_tpu_torch/csrc/decoder_stack.cu",
                      "mask_bev_tpu/ops/pallas_decoder_stack.py:200"),
}


def serve_phase(np, torch, card, results, failures, record, cfg, suffix,
                warm, timed, main_path=False):
    """One serving configuration at full width through ``MaskBevPredictor``
    at batch 8: the inputs of kernels 1-5 captured in one forward and held
    against their plain versions in the configuration's dtype, then
    ``warm`` + ``timed`` requests with the launch counters reset just
    before and read just after, then one traced request. The main path
    (bf16) also times the Swin chain's launches by kind and prints the
    decoder's cluster occupancy; the f32 phases check the instance
    counters, which must show the f32 instances."""
    from mask_bev_tpu_torch.inference import MaskBevPredictor
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.models import mask2former as m2f
    from mask_bev_tpu_torch.models import swin as msw
    from mask_bev_tpu_torch.models.maskbev import MaskBev
    from mask_bev_tpu_torch.ops import canvas as kcanvas
    from mask_bev_tpu_torch.ops import decoder_stack as kdec
    from mask_bev_tpu_torch.ops import pfn as kpfn
    from mask_bev_tpu_torch.ops import swin_block as kswin

    label = "e2e" + {"": "", ".f32": " f32", ".waymo": " waymo"}[suffix]
    f32 = cfg.compute_dtype == "float32"
    esz = 4 if f32 else 2
    work = "f32" if f32 else "bf16"  # the products' type, off the int8 GEMM
    prod = "tf32x3" if f32 else "bf16"  # the tensor cores' route for them
    t0 = time.time()
    sd = MaskBev(cfg).random_state_dict(SEED + (0 if main_path else 20))
    pred = MaskBevPredictor(cfg, sd, device="cuda")
    model = pred.model
    dcol = cfg.pc_point_dim
    pts_np, mask_np = scans(np, BATCH, cfg.max_points_per_scan, SEED)
    pts = torch.as_tensor(pts_np[..., :dcol]).cuda().to(pred.dtype)
    msk = torch.as_tensor(mask_np).cuda()

    # ---- capture every kernel's inputs (one forward) ----------------------
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
    print(f"[{label}] {cfg.name} ({cfg.compute_dtype}, int8 backbone: "
          f"{cfg.backbone_quantize == 'int8'}, {cfg.num_queries} queries, "
          f"{dcol} point columns): captured {len(captured_blocks)} blocks "
          f"in {time.time() - t0:.1f} s [{card}]", flush=True)

    def rec(name, *a, **kw):
        record(name + suffix, *SOURCES[name], *a, **kw)

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
        n_differ = int((diff > 0).any(-1).sum())
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
        # the products: bf16 on the tensor cores, or f32 weights as 3xTF32,
        # with f32 accumulation
        byts = (BATCH * cfg.max_points_per_scan * 16 + n_pil * 12
                + n_pil * c_out * esz + 8 * BATCH)
        bnd = bound(byts, 2 * kept * macs / PEAK[prod])
        # bf16: two bf16 steps at the largest value (the tensor cores sum in
        # another order, and every layer rounds to bf16 again); f32: 1e-4
        tol = (2 ** -7 if not f32 else 1e-4) * scale
        extra = ""
        if f32:
            # the f32 instance against the same layers in float64
            exact, _ = kpfn.pfn_plain(ps, weights, out_dtype=torch.float64,
                                      **kw)
            e64 = float((table.double() - exact).abs()[rows].max()
                        / exact[rows].abs().max())
            del exact
            extra = (f"; 3xTF32, error relative to float64 {e64:.3g} "
                     f"(tolerance 1e-5); bound as f32 FMAs "
                     f"{bound(byts, 2 * kept * macs / PEAK['f32'])[0]:.4f} ms")
            if e64 > 1e-5:
                failures.append(f"pfn{suffix} against float64")
        rec("pfn", err, tol, ms_k, ms_p, bnd,
            f"rows that differ {n_differ} of {int(n_pil)}; stats rel err "
            f"{st_err:.3g} (tolerance 1e-3); pillars {int(n_pil)} kept "
            f"points {int(kept)}{extra}")
        if st_err > 1e-3:
            failures.append(f"pfn{suffix} stats")
        pfn_breakdown(torch, kpfn, lambda prof: kpfn.pfn(
            ps, weights, max_points_per_pillar=enc.k, out_dtype=pts.dtype,
            packed=packed, profile=prof, **kw), f"{label} pfn", card)

        # ---- kernel 2: canvas + pseudo-image norm ------------------------
        h, w = enc.grid_hw
        elems = float(h * w * c_out)
        mean = stats[:, 0] / elems
        var = stats[:, 1] / elems - mean * mean
        canvas_phase(torch, kcanvas, rec, "canvas_norm",
                     (table, ps.cells, ps.num_pillars, mean, var,
                      enc.norm.weight.detach(), enc.norm.bias.detach(),
                      (h, w), enc.norm.eps))

        # ---- kernels 3/4: Swin block (all blocks of the backbone) --------
        err_abs, err_rel, ms_k, ms_p, b_ops, b_bytes, fma_ops = (0.0,) * 7
        quant = False
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
            b_ops += (gemm_ops / PEAK["int8" if quant else prod]
                      + attn_ops / PEAK[work])
            fma_ops += gemm_ops / PEAK["int8" if quant else work] + (
                attn_ops / PEAK[work])
            b_bytes += (2 * b_ * l_ * c_ * esz
                        + 12 * c_ * c_ * (1 if quant else esz))
        # int8: rounding boundaries move by a step between two LayerNorms
        # summed in another order (0.02 of each block's max-abs, as in bf16);
        # bf16: the same; f32 products: 1e-3
        blk_tol = 2e-2 if (quant or not f32) else 1e-3
        rec("swin_block", err_abs, float("nan"), ms_k, ms_p,
            bound(b_bytes, b_ops),
            f"largest error relative to its block's max-abs {err_rel:.4g} "
            f"(tolerance {blk_tol}); {len(captured_blocks)} blocks summed; "
            f"bound with every product as f32 FMAs "
            f"{bound(b_bytes, fma_ops)[0]:.4f} ms",
            ok=err_rel <= blk_tol)
        if f32 and not quant:
            # the f32 GEMM alone, against torch.addmm in full f32, at a
            # stage-0 and a stage-3 fc1 product of the captured blocks
            shapes = []
            for label_s, blk in (("stage-0 fc1", captured_blocks[0]),
                                 ("stage-3 fc1", captured_blocks[-1])):
                xb, pb = blk[0], blk[1]
                shapes.append((label_s, xb.reshape(-1, xb.shape[-1]),
                               pb.fc1))
            g_err, g_ms, g_lib, g_ops = gemm_yardstick(torch, kswin, shapes,
                                                       card)
            g_plain = sum(cuda_ms(torch, lambda a=a_, d=d_: kswin.dense(
                a, d, False), 5) for _, a_, d_ in shapes)
            g_bytes = sum(4.0 * (a_.numel() + 3 * d_.wt.numel()
                                 + a_.shape[0] * d_.wt.shape[0])
                          for _, a_, d_ in shapes)
            record("gemm_f32_3xtf32", "mask_bev_tpu_torch/csrc/gemm.cuh",
                   "mask_bev_tpu/ops/pallas_swin_block.py:208", g_err, 1e-5,
                   g_ms, g_plain, bound(g_bytes, g_ops / PEAK["tf32x3"]),
                   f"stage-0 and stage-3 fc1 products summed, error "
                   f"relative to a float64 product; bound as f32 FMAs "
                   f"{bound(g_bytes, g_ops / PEAK['f32'])[0]:.4f} ms",
                   library_ms=g_lib)
            del shapes
        if main_path:
            swin_parts(torch, kswin, captured_blocks, card)
        # ---- the Swin chain's attention alone, with an SDPA yardstick ----
        calls = [(block_qkv(kswin, x, p, q_), p.qkv.bias, p.rel_bias,
                  x.shape[0], hw, heads, win, shift)
                 for (x, p, hw, win, heads, shift, q_) in captured_blocks]
        attn_phase(torch, kswin, record, "swin_attn" + suffix,
                   "mask_bev_tpu/ops/pallas_swin_block.py:584", calls,
                   False, f32, card)
        del calls

        # ---- kernel 5: decoder stack -------------------------------------
        (dargs, dkw) = captured_dec[0]
        kb.reset_launches()
        out_k, kbits = kdec.decoder_stack(*dargs, **dkw, return_bits=True)
        instance = [k for k in kb.INSTANCES if k.startswith("decoder_stack/")
                    and "gemm" not in k]
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
        same_tol = (1e-3 if f32 else 2e-2) * scale
        if err_same > same_tol:
            failures.append(f"decoder_stack{suffix} on its own blocked "
                            "positions")
        # given the kernel's decisions, the plain version's own logits (its
        # decoder norm and mask MLP) may decide otherwise only within
        # rounding of 0; free-running flips compound, bounded more loosely
        own = [int((kb_ != kdec.blocked_positions(m)).sum())
               for kb_, m in zip(kbits, same_logits)]
        for li, m in enumerate(plogits):
            if flips[li] > 0.05 * m.numel() or own[li] > 0.01 * m.numel():
                failures.append(f"decoder_stack{suffix} bias flips in layer "
                                f"{li}")
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
        byts = (BATCH * sum(ts) * c_ * (esz + 4) + sum(ts) * c_ * esz
                + n_l * (8 * c_ * c_ + 2 * c_ * f_) * esz
                + BATCH * q_ * c_ * esz)
        if main_path:
            decoder_clusters(kb, kdec, dargs, card)
        if f32:
            split_breakdown(torch, kdec, dargs, dkw, card, label)
        rec("decoder_stack", err, 5e-2 * scale, ms_k, ms_p,
            bound(byts, ops / PEAK[prod]),
            f"instance {instance}, Q={q_}; bias entries that differ: "
            f"{sum(flips)} of {total}, per layer {flips} (tolerance 5 % a "
            f"layer), on the kernel's own decisions {own} (tolerance 1 % a "
            f"layer); max_abs_err on the kernel's own blocked positions "
            f"{err_same:.6g} (tolerance {same_tol:.6g}); bound as "
            f"{work} FMAs {bound(byts, ops / PEAK[work])[0]:.4f} ms")
    del captured_blocks, captured_dec, table, ps, dargs, out_k, out_p, same

    # ---- serve requests through the predictor -----------------------------
    staged = []
    for s in range(4):
        p_np, m_np = scans(np, BATCH, cfg.max_points_per_scan, 100 + s)
        staged.append((torch.as_tensor(p_np[..., :dcol]).cuda(),
                       torch.as_tensor(m_np).cuda()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    for i in range(warm):
        cls_p, mask_p = pred.forward(*staged[i % 4])
    torch.cuda.synchronize()
    times = []
    for i in range(timed):
        t1 = time.perf_counter()
        cls_p, mask_p = pred.forward(*staged[i % 4])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches = dict(kb.LAUNCHES)
    instances = dict(kb.INSTANCES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    requests = warm + timed
    ms_batch = float(np.median(times) * 1e3)
    print(f"[{label}] {requests} requests of batch {BATCH}: median "
          f"{ms_batch:.3f} ms/batch, mean {np.mean(times) * 1e3:.3f} ms, "
          f"{BATCH / (ms_batch / 1e3):.2f} scans/s, peak memory "
          f"{peak_gb:.2f} GiB [{card}]", flush=True)
    print(f"[{label}] launches over the {requests} requests: {launches}; "
          f"by instance: {instances}", flush=True)
    for k in SOURCES:
        results[k + suffix]["launches"] = launches.get(k, 0)
        if launches.get(k, 0) <= 0:
            failures.append(f"{k} never launched on [{label}]")
    attn_inst = "swin_block/attn_" + ("f32" if f32 else "bf16")
    results["swin_attn" + suffix]["launches"] = instances.get(attn_inst, 0)
    if instances.get(attn_inst, 0) <= 0:
        failures.append(f"{attn_inst} never launched on [{label}]")
    if f32:
        need = ["pfn/f32_3xtf32", "canvas_norm/f32", "swin_block/f32",
                "decoder_stack/split_tc_f32", "decoder_stack/gemm_f32_3xtf32",
                "swin_block/gemm_s8_f32" if quant
                else "swin_block/gemm_f32_3xtf32"]
        missing = [k for k in need if instances.get(k, 0) <= 0]
        if missing:
            failures.append(f"[{label}] f32 instances never launched: "
                            f"{missing}")
        if "gemm_f32_3xtf32" in results:
            results["gemm_f32_3xtf32"]["launches"] = sum(
                v for k, v in instances.items()
                if k.endswith("/gemm_f32_3xtf32"))
        print(f"[{label}] TF32 halves of the f32 weights (the 3xTF32 GEMM's "
              f"operands, beside the f32 weights): "
              f"{tf32_halves_mib(model):.1f} MiB on the device [{card}]",
              flush=True)
    removed = [k for k in instances if k in REMOVED]
    if removed:
        failures.append(f"[{label}] removed designs launched: {removed}")
    hg, wg = cfg.grid_hw
    exp_cls = (BATCH, cfg.num_queries, cfg.head_num_classes + 1)
    exp_mask = (BATCH, cfg.num_queries, hg // 4, wg // 4)
    if tuple(cls_p.shape) != exp_cls or tuple(mask_p.shape) != exp_mask:
        failures.append(f"[{label}] output shapes {tuple(cls_p.shape)} "
                        f"{tuple(mask_p.shape)}")
    if not (torch.isfinite(cls_p).all() and torch.isfinite(mask_p).all()):
        failures.append(f"[{label}] non-finite outputs")
    print(f"[{label}] class probs {tuple(cls_p.shape)} mask probs "
          f"{tuple(mask_p.shape)}; mean mask prob "
          f"{float(mask_p.mean()):.4f}", flush=True)

    # ---- where the time goes: one traced request --------------------------
    traced(torch, lambda: pred.forward(*staged[0]),
           "profile" + label[3:], "request", card, 16 if main_path else 12)
    del pred, model, staged, cls_p, mask_p
    torch.cuda.empty_cache()


def swin_parts(torch, kswin, blocks, card) -> None:
    """Time the Swin chain's launches by kind over the captured blocks
    (GEMM, attention, LayerNorm, int8 quantisation) and, as a yardstick
    for one stage-0 product alone (no epilogue), ``torch._int_mm`` on the
    fc1 product's int8 operands."""
    ms = {"gemm": 0.0, "attention": 0.0, "layernorm": 0.0, "quantise": 0.0}
    count = dict.fromkeys(ms, 0)

    def timed(kind, fn, reps=5):
        ms[kind] += cuda_ms(torch, fn, reps)
        count[kind] += 1
        return fn()

    for (x, p, hw, win, heads, shift, quant) in blocks:
        b, l, c = x.shape
        x2 = x.reshape(b * l, c)
        res = kswin.EPI_RESIDUAL | (0 if quant else kswin.EPI_ROUND_ACC)
        gelu = kswin.EPI_GELU | (0 if quant else kswin.EPI_ROUND_ACC)
        mode_d = kswin.EPI_BIAS | (0 if quant else kswin.EPI_ROUND_ACC)

        def prod(a, d, mode, residual=None):
            if quant:
                q8, sx = a
                return timed("gemm", lambda: kswin.gemm(
                    "swin_block", q8, d, mode, residual=residual, sx=sx))
            return timed("gemm", lambda: kswin.gemm(
                "swin_block", a, d, mode, residual=residual))

        def quantise(y):
            return (timed("quantise", lambda: kswin._quant(y)) if quant
                    else y)

        y = timed("layernorm", lambda: kswin._ln(x2, p.ln1_w, p.ln1_b,
                                                 quant))
        qkv = prod(y, p.qkv, mode_d)
        o = timed("attention", lambda: kswin.window_attention(
            qkv, p, b, hw, heads, win, shift))
        x1 = prod(quantise(o), p.proj, res, x2)
        y = timed("layernorm", lambda: kswin._ln(x1, p.ln2_w, p.ln2_b,
                                                 quant))
        hmid = prod(y, p.fc1, gelu)
        prod(quantise(hmid), p.fc2, res, x1)
    print("[swin_block] launches by kind, summed over the blocks: "
          + ", ".join(f"{k} {v:.4f} ms ({count[k]} launches)"
                      for k, v in ms.items()) + f" [{card}]", flush=True)

    x, p, hw, win, heads, shift, quant = blocks[0]
    if quant:
        b, l, c = x.shape
        q8, sx = kswin._ln(x.reshape(b * l, c), p.ln2_w, p.ln2_b, True)
        w8 = p.fc1.q8.t()  # (K, N) view of the (N, K) int8 weight
        lib = cuda_ms(torch, lambda: torch._int_mm(q8, w8), 10)
        own = cuda_ms(torch, lambda: kswin.gemm(
            "swin_block", q8, p.fc1, kswin.EPI_GELU, sx=sx), 10)
        print(f"[swin_block] yardstick, stage-0 fc1 product alone: "
              f"torch._int_mm ({b * l} x {c}) . ({c} x {4 * c}) int8 -> "
              f"int32 {lib:.4f} ms; the port's GEMM with its dequantise + "
              f"bias + GELU epilogue and bf16 output {own:.4f} ms [{card}]",
              flush=True)


def gemm_yardstick(torch, kswin, shapes, card):
    """The f32 GEMM (3xTF32 on the tensor cores) against ``torch.addmm`` in
    full f32 (TF32 off: cuBLAS SGEMM) on the same operands, per (label, a,
    Dense) in ``shapes``: ``x @ wt^T + bias``, the error relative to a
    float64 product (tolerance 1e-5 of the largest value, as
    ``test_gemm_f32``). Returns (worst relative error, kernel ms, addmm ms,
    ops) summed over the shapes."""
    assert not torch.backends.cuda.matmul.allow_tf32
    err, ms_k, ms_l, ops = 0.0, 0.0, 0.0, 0.0
    for label, a, d in shapes:
        m, k = a.shape
        n = d.wt.shape[0]
        got = kswin.gemm("swin_block", a, d, kswin.EPI_BIAS)
        ref = (a.double() @ d.wt.double().t() + d.bias.double()).float()
        e = float((got - ref).abs().max() / ref.abs().max())
        own = cuda_ms(torch, lambda: kswin.gemm("swin_block", a, d,
                                                kswin.EPI_BIAS), 10)
        lib = cuda_ms(torch, lambda: torch.addmm(d.bias, a, d.wt.t()), 10)
        flop = 2.0 * m * n * k
        print(f"[gemm f32] {label} ({m} x {k}) . ({k} x {n}): 3xTF32 GEMM "
              f"{own:.4f} ms ({flop / own / 1e9:.1f} TFLOP/s), torch.addmm "
              f"f32 {lib:.4f} ms ({flop / lib / 1e9:.1f} TFLOP/s); error "
              f"relative to a float64 product {e:.3g} (tolerance 1e-5) "
              f"[{card}]", flush=True)
        err, ms_k, ms_l, ops = max(err, e), ms_k + own, ms_l + lib, ops + flop
        del got, ref
    return err, ms_k, ms_l, ops


def split_breakdown(torch, kdec, dargs, dkw, card, label, reps=3):
    """Where the decoder's split instance spends its time, per part of a
    layer (``kdec.SPLIT_PARTS``): each block adds the ns of %globaltimer
    between the part's boundaries, summed over the layers; printed as the
    mean over the blocks of ``reps`` runs, in ms and as a share."""
    b = dargs[0].shape[0]
    prof = torch.zeros((b * kdec.CLUSTER, len(kdec.SPLIT_PARTS)),
                       dtype=torch.int64, device="cuda")
    kdec.decoder_stack(*dargs, **dkw)
    for _ in range(reps):
        kdec.decoder_stack(*dargs, **dkw, profile=prof)
    torch.cuda.synchronize()
    ns = prof.double().mean(0) / reps
    total = float(ns.sum())
    parts = ", ".join(f"{name} {float(v) / 1e6:.4f} ms "
                      f"({100 * float(v) / total:.1f} %)"
                      for name, v in zip(kdec.SPLIT_PARTS, ns))
    print(f"[{label}] split decoder by part, Q={dargs[0].shape[1]}, mean "
          f"of the {b * kdec.CLUSTER} blocks: {parts}; all layers "
          f"{total / 1e6:.4f} ms [{card}]", flush=True)
    return ns


def pfn_breakdown(torch, kpfn, run, label, card, reps=3) -> None:
    """Where a PFN kernel's tile walk spends its time, per part
    (``kpfn.PFN_PARTS``): each tile group's first thread adds the ns of
    %globaltimer between the part's closing barriers; printed as the mean
    over the groups of ``reps`` runs of ``run(profile)``, in ms and as a
    share."""
    prof = torch.zeros(len(kpfn.PFN_PARTS) + 1, dtype=torch.int64,
                       device="cuda")
    run(None)
    for _ in range(reps):
        run(prof)
    torch.cuda.synchronize()
    ns = prof[:-1].double() / float(prof[-1])
    total = float(ns.sum())
    parts = ", ".join(f"{name} {float(v) / 1e6:.4f} ms "
                      f"({100 * float(v) / total:.1f} %)"
                      for name, v in zip(kpfn.PFN_PARTS, ns))
    print(f"[{label}] tile walk by part, mean of the "
          f"{int(prof[-1]) // reps} tile groups: {parts}; all "
          f"{total / 1e6:.4f} ms [{card}]", flush=True)


def tf32_halves_mib(model) -> float:
    """Device memory of the TF32 halves (``Dense.hi``, ``Dense.lo``) that the
    model's prepared f32 dense layers hold beside their f32 weights: the
    Swin blocks' four products and the decoder's k/v projections."""
    total = 0
    for mod in model.modules():
        packed = getattr(mod, "_packed", None)
        if packed is None:
            continue
        if hasattr(packed, "qkv"):  # a Swin block's BlockWeights
            denses = [packed.qkv, packed.proj, packed.fc1, packed.fc2]
        elif (isinstance(packed, tuple) and len(packed) == 3
              and isinstance(packed[2], tuple)):  # the decoder's
            denses = [d for pair in packed[2][1] for d in pair]
        else:
            continue
        for d in denses:
            for t in (d.hi, d.lo):
                if t is not None:
                    total += t.numel() * t.element_size()
    return total / 2 ** 20


def decoder_clusters(kb, kdec, dargs, card) -> None:
    """Print how many clusters of 8, 12 and 16 blocks the decoder stack's
    kernel can hold at once at these shapes (the size that runs the batch
    in one wave is the one built)."""
    import ctypes

    q_, c_ = dargs[0].shape[1], dargs[0].shape[2]
    t_max = max(m.shape[1] for m in dargs[3])
    cs = kdec.CLUSTER
    smem = kdec.smem_bytes(q_, c_, t_max)
    active = {}
    for size in (8, 12, 16):
        n = ctypes.c_int(-1)
        rc = kb.lib().decoder_stack_max_clusters(
            ctypes.c_int(size), ctypes.c_int(smem), ctypes.byref(n))
        active[size] = n.value if rc == 0 else f"error {rc}"
    print(f"[decoder_stack] clusters of {cs} blocks ({smem} B of shared "
          f"memory a block) for batch {dargs[0].shape[0]}; most clusters "
          f"resident at once, by cluster size: {active} [{card}]",
          flush=True)


def path_phase(np, torch, card, results, failures, record, path: str,
               f32: bool = False):
    """Path K (KITTI, unfused backbone: kernels 7 and 8 with the PFN, the
    canvas and the decoder stack) or path E (the capped eval encoder with
    the fused token LN: kernels 10 and 9 with the canvas, the Swin blocks
    and the decoder stack) at full width: inputs of the path's new kernels
    captured in one forward and held against their plain versions, then 3
    warm and 5 timed requests with the launch counters reset just before.
    ``f32``: the path in f32 (every kernel's f32 instance), 1 warm and 2
    timed requests, no trace."""
    import torch.nn.functional as F

    from mask_bev_tpu_torch.config import kitti_default, semantic_kitti_default
    from mask_bev_tpu_torch.inference import MaskBevPredictor
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.models import encoder as menc
    from mask_bev_tpu_torch.models import swin as msw
    from mask_bev_tpu_torch.models.maskbev import MaskBev
    from mask_bev_tpu_torch.ops import canvas as kcanvas
    from mask_bev_tpu_torch.ops import layer_norm as kln
    from mask_bev_tpu_torch.ops import patch_embed as kpe
    from mask_bev_tpu_torch.ops import pfn as kpfn
    from mask_bev_tpu_torch.ops import swin_block as kswin
    from mask_bev_tpu_torch.ops import window_msa as kwmsa

    dtype = "float32" if f32 else "bfloat16"
    sfx = ".f32" if f32 else ""
    esz = 4 if f32 else 2
    work = "f32" if f32 else "bf16"
    if path == "K":
        cfg = kitti_default().replace(
            max_points_per_scan=131072, compute_dtype=dtype,
            use_pallas_backbone=False, use_pallas_attention=True,
            fuse_patch_embed=True)
        names = ("window_msa", "patch_embed", "canvas_norm")
        path_kernels = ("pfn", "decoder_stack") + names
    else:
        cfg = semantic_kitti_default().replace(
            max_points_per_scan=131072, compute_dtype=dtype,
            use_pallas_encoder=False)
        names = ("layer_norm", "stream_pfn")
        path_kernels = ("canvas_norm", "swin_block", "decoder_stack") + names
    label = f"path {path}" + (" f32" if f32 else "")
    t0 = time.time()
    pred = MaskBevPredictor(cfg, MaskBev(cfg).random_state_dict(SEED + 10),
                            device="cuda")
    model = pred.model
    if path == "E":
        model.backbone.fuse_ln = True  # as the JAX SwinTransformer attribute
    pts_np, mask_np = scans(np, BATCH, cfg.max_points_per_scan, SEED + 11)
    pts = torch.as_tensor(pts_np).cuda().to(pred.dtype)
    msk = torch.as_tensor(mask_np).cuda()

    # ---- capture the new kernels' inputs in one forward -------------------
    cap = {n: [] for n in names}
    orig = {"window_msa": (msw, msw.window_msa),
            "patch_embed": (msw, msw.patch_embed),
            "layer_norm": (msw, msw.layer_norm),
            "stream_pfn": (menc, menc.stream_pfn),
            "canvas_norm": (menc, menc.canvas_norm)}
    # path K's kernel 2 records under its own name (the main path's and
    # phase F's are "canvas_norm" and "canvas_norm.f32")
    rec_name = {"canvas_norm": "canvas_norm.K"}

    def recorder(name):
        mod, fn = orig[name]

        def rec(*a, **kw):
            cap[name].append((tuple(t.clone() if torch.is_tensor(t) else t
                                    for t in a), kw))
            return fn(*a, **kw)
        return rec

    for n in names:
        setattr(orig[n][0], n, recorder(n))
    try:
        with torch.no_grad():
            model(pts, msk)
    finally:
        for n in names:
            setattr(orig[n][0], n, orig[n][1])
    torch.cuda.synchronize()
    print(f"[{label}] {cfg.name}: grid {cfg.grid_hw}, captured "
          f"{ {n: len(v) for n, v in cap.items()} } in "
          f"{time.time() - t0:.1f} s [{card}]", flush=True)

    with torch.no_grad():
        if path == "K":
            # ---- kernel 7: window MSA on the token grid, all blocks -------
            err_abs = err_rel = ms_k = ms_p = ops = byts = g_ops = 0.0
            calls = []
            for (a, kw) in cap["window_msa"]:
                got = kwmsa.window_msa(*a, **kw)
                want = kwmsa.window_msa_grid_plain(*a, **kw)
                e = float((got.float() - want.float()).abs().max())
                err_abs = max(err_abs, e)
                err_rel = max(err_rel, e / float(want.float().abs().max()))
                ms_k += cuda_ms(torch, lambda: kwmsa.window_msa(*a, **kw), 5)
                ms_p += cuda_ms(torch, lambda: kwmsa.window_msa_grid_plain(
                    *a, **kw), 1)
                y, hw, win, shift, rel, qkv, proj, heads = a
                b_, l_, c_ = y.shape
                hp = -(-hw[0] // win) * win
                wp = -(-hw[1] // win) * win
                g_ops += 2.0 * b_ * l_ * 4 * c_ * c_
                ops += 4.0 * b_ * hp * wp * win * win * c_
                byts += 2 * b_ * l_ * c_ * esz + 4 * c_ * c_ * esz
                calls.append((kswin.gemm("window_msa", y.reshape(-1, c_), qkv,
                                         kswin.EPI_BIAS), qkv.bias, rel, b_,
                              hw, heads, win, shift))
            # bf16: both sides round qkv, probabilities and heads to bf16;
            # f32: the same f32 operations in another order
            tol = 1e-3 if f32 else 2e-2
            record("window_msa" + sfx, "mask_bev_tpu_torch/csrc/window_msa.cu",
                   "mask_bev_tpu/ops/pallas_window_msa.py:71", err_abs,
                   float("nan"), ms_k, ms_p,
                   bound(byts, g_ops / PEAK["tf32x3" if f32 else work]
                         + ops / PEAK["tf32x3" if f32 else work]),
                   f"largest error relative to its block's max-abs "
                   f"{err_rel:.4g} (tolerance {tol}); "
                   f"{len(cap['window_msa'])} blocks summed",
                   ok=err_rel <= tol)
            # ---- kernel 7's attention alone, with an SDPA yardstick --------
            attn_phase(torch, kswin, record, "window_msa_attn" + sfx,
                       "mask_bev_tpu/ops/pallas_window_msa.py:71", calls,
                       True, f32, card)
            del calls
            # ---- kernel 8: patch embed + patch_norm --------------------------
            (a, kw), = cap["patch_embed"]
            got = kpe.patch_embed(*a, **kw)
            want = kpe.patch_embed_plain(*a)
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            canvas, wm, p_ = a[0], a[1], a[5]
            b_, h_, w_, c_ = canvas.shape
            e_ = wm.shape[0]
            if f32:
                # f32: against a float64 product + LN (the cuda tests' 1e-5)
                w64 = wm.double()
                t64 = (canvas.double().reshape(b_, h_ // p_, p_, w_ // p_, p_,
                                               c_).permute(0, 1, 3, 2, 4, 5)
                       .reshape(-1, p_ * p_ * c_))
                y = t64 @ w64.t() + a[2].double()
                del t64
                mu = y.mean(-1, keepdim=True)
                var = ((y * y).mean(-1, keepdim=True) - mu * mu).clamp(min=0)
                y = ((y - mu) * torch.rsqrt(var + a[6]) * a[3].double()
                     + a[4].double())
                err = float((got.double() - y.reshape(got.shape)).abs()
                            .max())
                scale = float(y.abs().max())
                del y, mu, var, w64
            del got, want
            ms_k = cuda_ms(torch, lambda: kpe.patch_embed(*a, **kw), 10)
            ms_p = cuda_ms(torch, lambda: kpe.patch_embed_plain(*a), 2)
            # the conv alone on the same channels-last canvas (cuDNN, TF32
            # off): a yardstick for the product, not the same function
            x_cl = canvas.permute(0, 3, 1, 2)
            w_cl = (wm.reshape(e_, p_, p_, c_).permute(0, 3, 1, 2)
                    .contiguous(memory_format=torch.channels_last))
            b_conv = a[2].to(canvas.dtype)
            ms_c = cuda_ms(torch, lambda: F.conv2d(x_cl, w_cl, b_conv,
                                                   stride=p_), 10)
            m_ = b_ * (h_ // p_) * (w_ // p_)
            ops = 2.0 * m_ * p_ * p_ * c_ * e_
            byts = (canvas.numel() + m_ * e_ + wm.numel()) * esz
            pl = kpe.plan(b_, h_, w_, c_, e_, p_, f32)
            record("patch_embed" + sfx,
                   "mask_bev_tpu_torch/csrc/patch_embed.cu",
                   "mask_bev_tpu/ops/pallas_patch_embed.py:67", err,
                   (1e-5 if f32 else 1e-2) * scale, ms_k, ms_p,
                   bound(byts, ops / PEAK["tf32x3" if f32 else work]),
                   f"canvas {tuple(canvas.shape)} -> ({b_}, {m_ // b_}, "
                   f"{e_}); {'3xTF32, error against float64; bound as f32 '
                   f'FMAs {bound(byts, ops / PEAK[work])[0]:.4f} ms; '
                   if f32 else ''}tiles {pl['tile_x']}x{pl['tile_y']} "
                   f"tokens, {pl['tiles']} in {pl['pairs']} pairs, "
                   f"{pl['stages']} stages, weight read from L2 "
                   f"{pl['weight_l2_bytes'] / 1e9:.3f} GB; F.conv2d alone "
                   f"on the same channels-last canvas (not the same "
                   f"function: no LayerNorm) {ms_c:.4f} ms")
            del x_cl, w_cl
            # ---- kernel 2 at path K's grid --------------------------------
            (a, kw), = cap["canvas_norm"]
            canvas_phase(torch, kcanvas, lambda n, *r, **k: record(
                n + sfx, *SOURCES["canvas_norm"], *r, **k),
                "canvas_norm.K", a)
        else:
            # ---- kernel 9: token LayerNorm, patch_norm + out_norm0-3 ---------
            err = scale = ms_k = ms_p = ms_l = dev_k = dev_l = byts = 0.0
            plans = []
            for (a, kw) in cap["layer_norm"]:
                got = kln.layer_norm(*a, **kw)
                want = kln.layer_norm_plain(*a, **kw)
                err = max(err, float((got.float() - want.float()).abs().max()))
                scale = max(scale, float(want.float().abs().max()))
                x_, w_, bb_ = a[:3]
                run_k = lambda: kln.layer_norm(*a, **kw)  # noqa: E731
                run_l = lambda: F.layer_norm(  # noqa: E731
                    x_, (x_.shape[-1],), w_, bb_, 1e-6)
                ms_k += cuda_ms(torch, run_k, 20)
                ms_p += cuda_ms(torch, lambda: kln.layer_norm_plain(*a, **kw),
                                5)
                ms_l += cuda_ms(torch, run_l, 20)
                dev_k += device_ms(torch, run_k, 20)
                dev_l += device_ms(torch, run_l, 20)
                byts += 2 * x_.numel() * esz
                plans.append(kln.plan(x_.shape[-1], f32))
            record("layer_norm" + sfx, "mask_bev_tpu_torch/csrc/layer_norm.cu",
                   "mask_bev_tpu/ops/pallas_layer_norm.py:33", err,
                   (1e-4 if f32 else 1e-2) * scale, ms_k, ms_p,
                   bound(byts, 0.0),
                   f"{len(cap['layer_norm'])} calls summed: "
                   f"{[tuple(a[0].shape) for a, _ in cap['layer_norm']]}, "
                   f"(lanes, words, tokens) {plans}; device time (profiler, "
                   f"no host): kernel {dev_k:.4f} ms, F.layer_norm "
                   f"{dev_l:.4f} ms (kernel and library above: CUDA events "
                   f"over back-to-back calls, host included)",
                   library_ms=ms_l)
            # ---- kernel 10: v1 PFN on the capped stream ----------------------
            (a, kw), = cap["stream_pfn"]
            sp, weights = a[0], a[1]
            plain_kw = {k: v for k, v in kw.items()
                        if k not in ("num_valid", "packed")}
            table, stats = kpfn.stream_pfn(*a, **kw)
            want, wstats = kpfn.stream_pfn_plain(*a, **plain_kw)
            diff = (table.float() - want.float()).abs()
            err = float(diff.max())
            n_differ = int((diff > 0).any(-1).sum())
            scale = float(want.float().abs().max())
            st_err = float(((stats - wstats).abs()
                            / wstats.abs().clamp(min=1)).max())
            ms_k = cuda_ms(torch, lambda: kpfn.stream_pfn(*a, **kw), 10)
            ms_p = cuda_ms(torch, lambda: kpfn.stream_pfn_plain(*a, **plain_kw),
                           2)
            kept = float(sp.kept.sum())
            macs = sum(w.shape[0] * w.shape[1] for (w, _, _) in weights)
            b_, n_, d_ = sp.pts.shape
            p_, c_ = table.shape[1], table.shape[2]
            byts = (b_ * n_ * (d_ * esz + 4 + 1)
                    + b_ * p_ * (8 + c_ * esz + 8))
            ops = 2 * kept * macs
            extra = ""
            if f32:
                # the f32 instance (3xTF32) against the layers in float64
                exact, _ = kpfn.stream_pfn_plain(
                    *a, **{**plain_kw, "out_dtype": torch.float64})
                e64 = float((table.double() - exact).abs().max()
                            / exact.abs().max())
                del exact
                extra = (f"; 3xTF32, error relative to float64 {e64:.3g} "
                         f"(tolerance 1e-5); bound as f32 FMAs "
                         f"{bound(byts, ops / PEAK['f32'])[0]:.4f} ms")
                if e64 > 1e-5:
                    failures.append(f"stream_pfn{sfx} against float64")
            record("stream_pfn" + sfx, "mask_bev_tpu_torch/csrc/pfn.cu",
                   "mask_bev_tpu/ops/pallas_pfn.py:168", err,
                   (1e-4 if f32 else 1e-2) * scale, ms_k, ms_p,
                   bound(byts, ops / PEAK["tf32x3" if f32 else work]),
                   f"rows that differ {n_differ} of {p_ * b_} slots; stats "
                   f"rel err {st_err:.3g} (tolerance 1e-3); slots {p_}, "
                   f"occupied {kw['num_valid'].tolist()}, kept points "
                   f"{int(kept)}{extra}")
            if st_err > 1e-3:
                failures.append(f"stream_pfn{sfx} stats")
            pfn_breakdown(torch, kpfn, lambda prof: kpfn.stream_pfn(
                *a, **kw, profile=prof), f"{label} stream_pfn", card)
    del cap

    # ---- the path: warm and timed requests ---------------------------------
    staged = []
    for s in range(4):
        p_np, m_np = scans(np, BATCH, cfg.max_points_per_scan, 300 + s)
        staged.append((torch.as_tensor(p_np).cuda(),
                       torch.as_tensor(m_np).cuda()))
    n_warm, n_timed = (1, 2) if f32 else (PATH_WARM, PATH_TIMED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    for i in range(n_warm):
        cls_p, mask_p = pred.forward(*staged[i % 4])
    torch.cuda.synchronize()
    times = []
    for i in range(n_timed):
        t1 = time.perf_counter()
        cls_p, mask_p = pred.forward(*staged[i % 4])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches = dict(kb.LAUNCHES)
    instances = dict(kb.INSTANCES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    requests = n_warm + n_timed
    ms_batch = float(np.median(times) * 1e3)
    print(f"[e2e {label}] {requests} requests of batch {BATCH}: median "
          f"{ms_batch:.3f} ms/batch, mean {np.mean(times) * 1e3:.3f} ms, "
          f"{BATCH / (ms_batch / 1e3):.2f} scans/s, peak memory "
          f"{peak_gb:.2f} GiB [{card}]", flush=True)
    print(f"[e2e {label}] launches over the {requests} requests: "
          f"{launches}; by instance: {instances}", flush=True)
    for k in names:
        results[rec_name.get(k, k) + sfx]["launches"] = launches.get(k, 0)
    if path == "K":
        attn_inst = "window_msa/attn_" + ("f32" if f32 else "bf16")
        results["window_msa_attn" + sfx]["launches"] = instances.get(
            attn_inst, 0)
        if instances.get(attn_inst, 0) <= 0:
            failures.append(f"{attn_inst} never launched on {label}")
    for k in path_kernels:
        if launches.get(k, 0) <= 0:
            failures.append(f"{k} never launched on {label}")
        if f32 and not any(i.startswith(k + "/") and "f32" in i
                           for i in instances):
            failures.append(f"{k}: no f32 instance launched on {label}")
    if f32:
        need = ["decoder_stack/split_tc_f32", "decoder_stack/gemm_f32_3xtf32"]
        if path == "K":
            need.append("window_msa/gemm_f32_3xtf32")
        missing = [k for k in need if instances.get(k, 0) <= 0]
        if missing:
            failures.append(f"{label}: instances never launched: {missing}")
    removed = [k for k in instances if k in REMOVED]
    if removed:
        failures.append(f"{label}: removed designs launched: {removed}")
    hg, wg = cfg.grid_hw
    exp_cls = (BATCH, cfg.num_queries, cfg.head_num_classes + 1)
    exp_mask = (BATCH, cfg.num_queries, hg // 4, wg // 4)
    if tuple(cls_p.shape) != exp_cls or tuple(mask_p.shape) != exp_mask:
        failures.append(f"{label} output shapes {tuple(cls_p.shape)} "
                        f"{tuple(mask_p.shape)}")
    if not (torch.isfinite(cls_p).all() and torch.isfinite(mask_p).all()):
        failures.append(f"{label}: non-finite outputs")
    print(f"[e2e {label}] class probs {tuple(cls_p.shape)} mask probs "
          f"{tuple(mask_p.shape)}; mean mask prob "
          f"{float(mask_p.mean()):.4f}", flush=True)
    if not f32:
        keys = traced(torch, lambda: pred.forward(*staged[0]),
                      f"profile {label}", "request", card, 12)
        # kernel 7's index math pads, shifts and partitions: no roll
        rolls = [k for k in keys if k == "aten::roll" or "roll_cuda" in k]
        if path == "K" and rolls:
            failures.append(f"{label}: the traced request rolled: {rolls}")
    del pred, model, staged, cls_p, mask_p
    torch.cuda.empty_cache()


def traced(torch, run, label: str, unit: str, card: str, top: int):
    """Trace one call of ``run`` and print the device's busy time against
    the wall time, then the ``top`` kernels by device time. Returns the
    names of every operator and kernel of the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    # kernel rows only: an operator's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[{label}] one {unit}: device busy {busy_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall (idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}) [{card}]", flush=True)
    for e in events[:top]:
        print(f"[{label}] {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)
    return [e.key for e in prof.key_averages()]


def block_qkv(kswin, x, p, quant):
    """A captured Swin block's qkv, as its chain computes it (LN1, then the
    qkv product: int8, or in the activation dtype in XLA order)."""
    b, l, c = x.shape
    x2 = x.reshape(b * l, c)
    if quant:
        q8, sx = kswin._ln(x2, p.ln1_w, p.ln1_b, True)
        return kswin.gemm("swin_block", q8, p.qkv, kswin.EPI_BIAS, sx=sx,
                          out_dtype=x.dtype)
    return kswin.gemm("swin_block", kswin._ln(x2, p.ln1_w, p.ln1_b, False),
                      p.qkv, kswin.EPI_BIAS | kswin.EPI_ROUND_ACC)


def canvas_phase(torch, kcanvas, rec, name, args) -> None:
    """Kernel 2 alone on inputs captured from a forward (table, cells,
    num_pillars, mean, var, scale, bias, grid, eps): held against its plain
    version (bf16 1e-2, f32 1e-4 of the largest value), both timed. Bound:
    the canvas written once, the affine read once (H W C values in full
    mode), the occupied table rows and their cell ids read once."""
    table, cells, num_p, mean, var, scale, bias, (h, w), eps = args
    got = kcanvas.canvas_norm(*args)
    want = kcanvas.canvas_norm_plain(table, cells, mean, var, scale, bias,
                                     (h, w), eps)
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    del got, want
    ms_k = cuda_ms(torch, lambda: kcanvas.canvas_norm(*args), 10)
    ms_p = cuda_ms(torch, lambda: kcanvas.canvas_norm_plain(
        table, cells, mean, var, scale, bias, (h, w), eps), 3)
    b, _, c = table.shape
    esz = table.element_size()
    n_pil = float(num_p.sum())
    f32 = table.dtype == torch.float32
    byts = (b * h * w * c * esz + 2 * scale.numel() * esz
            + n_pil * (c * esz + 4))
    rec(name, err, (1e-4 if f32 else 1e-2) * top, ms_k, ms_p,
        bound(byts, 4.0 * b * h * w * c / PEAK["f32"]),
        f"grid {h}x{w}, C {c}, {'full' if scale.numel() > c else 'channel'}"
        f"-mode affine, {int(n_pil)} pillars of {b * h * w} cells")


def sdpa_windows(torch, kswin, qkv, qkv_bias, rel, b, hw, heads, win, shift):
    """The windows of the attention as ``F.scaled_dot_product_attention``
    takes them: q, k, v (B*nW, h, n, hd) (``kswin.qkv_windows``) and the
    float mask rel + shift mask, (1, h, n, n) or, shifted, (B*nW, h, n, n),
    in qkv's dtype."""
    q, k, v = (t.contiguous() for t in kswin.qkv_windows(
        qkv, qkv_bias, b, hw, heads, win, shift))
    mask = rel.float()[None]
    sm = kswin.shift_mask(hw, win, shift, qkv.device)
    if sm is not None:
        mask = (mask + sm[:, None]).repeat(b, 1, 1, 1)
    return q, k, v, mask.to(qkv.dtype).contiguous()


def attn_phase(torch, kswin, record, name, replaces, calls, msa, f32,
               card) -> None:
    """The window attention launch alone (``kswin.attention``, the Swin or
    the MSA variant) on each captured block's qkv: held against its plain
    version (bf16 1e-2, f32 1e-4 of the block's largest value), timed
    beside it and beside ``F.scaled_dot_product_attention`` on the same
    windows (the library yardstick: q, k, v (B*nW, h, n, hd) and a float
    mask rel + shift mask; used on no path). Bound: qkv read and the
    output written once, the bias read once a head, against the products
    (4 n C a padded token) at the bf16 or 3xTF32 rate."""
    import torch.nn.functional as F

    err_rel = err_abs = ms_k = ms_p = ms_l = byts = ops = 0.0
    kname = "window_msa" if msa else "swin_block"
    for (qkv, qb, rel, b, hw, heads, win, shift) in calls:
        a = (qkv, qb, rel, b, hw, heads, win, shift)
        got = kswin.attention(kname, *a, msa=msa)
        want = kswin.window_attention_plain(*a, msa=msa)
        e = float((got.float() - want.float()).abs().max())
        err_abs = max(err_abs, e)
        err_rel = max(err_rel, e / float(want.float().abs().max()))
        ms_k += cuda_ms(torch, lambda: kswin.attention(kname, *a, msa=msa),
                        5)
        ms_p += cuda_ms(torch, lambda: kswin.window_attention_plain(
            *a, msa=msa), 1)
        q, k, v, mask = sdpa_windows(torch, kswin, *a)
        hd = q.shape[-1]
        ms_l += cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=hd ** -0.5), 5)
        del q, k, v, mask, got, want
        c = qkv.shape[1] // 3
        hp, wp = -(-hw[0] // win) * win, -(-hw[1] // win) * win
        byts += 4 * qkv.shape[0] * c * qkv.element_size() + rel.numel() * 4
        ops += 4.0 * b * hp * wp * win * win * c
    tol = 1e-4 if f32 else 1e-2
    record(name, ATTN_SOURCE, replaces, err_abs, float("nan"), ms_k, ms_p,
           bound(byts, ops / PEAK["tf32x3" if f32 else "bf16"]),
           f"{'MSA' if msa else 'Swin'} variant, "
           f"{'f32 (3xTF32)' if f32 else 'bf16'}; largest error relative "
           f"to its block's max-abs {err_rel:.4g} (tolerance {tol}); "
           f"{len(calls)} blocks summed; library = "
           f"F.scaled_dot_product_attention on the same windows",
           ok=err_rel <= tol, library_ms=ms_l)


def grad_norms(grads):
    """L2 norm of the gradients of each top-level module."""
    out = {}
    for k, g in grads.items():
        top = k.split(".")[0]
        out[top] = out.get(top, 0.0) + float(g.float().square().sum())
    return {k: v ** 0.5 for k, v in out.items()}


def train_phase(np, torch, card, results, failures, record):
    from mask_bev_tpu_torch.config import (
        semantic_kitti_default, tiny_test_config)
    from mask_bev_tpu_torch.datasets.synthetic import make_batch
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.ops import canvas as kcanvas
    from mask_bev_tpu_torch.ops import hungarian as khung
    from mask_bev_tpu_torch.train.step import (
        create_train_state, loss_and_grads, train_step)

    cfg = semantic_kitti_default().replace(
        max_points_per_scan=131072, max_num_pillars=32768,
        pseudo_image_norm="full", compute_dtype="bfloat16",
        batch_size=TRAIN_BATCH)
    t0 = time.time()
    state = create_train_state(cfg, seed=SEED, device="cuda")
    batches = [make_batch(np.random.default_rng(200 + i), cfg,
                          batch_size=TRAIN_BATCH, noise_points=115_000,
                          points_per_instance=1500) for i in range(3)]
    n_pts = [int(b["point_mask"].sum(1).mean()) for b in batches]
    print(f"[train] state and 3 batches in {time.time() - t0:.1f} s; mean "
          f"points per scan {n_pts}; GT instances per batch "
          f"{[int(b['gt_valid'].sum()) for b in batches]}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    # ---- one step with the training kernels' inputs captured ------------
    cap = {}
    orig = (kcanvas.canvas_scatter_forward, kcanvas.canvas_scatter_backward,
            khung.hungarian_rows)

    def rec_fwd(table, cells, grid_hw):
        cap["fwd"] = (table.detach().clone(), cells.clone(), grid_hw)
        return orig[0](table, cells, grid_hw)

    def rec_bwd(d_canvas, cells, grid_hw):
        cap["bwd"] = (d_canvas.detach().contiguous().clone(), cells.clone(),
                      grid_hw)
        return orig[1](d_canvas, cells, grid_hw)

    def rec_hung(cost, n_rows):
        cap["hung"] = (cost.clone(), n_rows.clone())
        return orig[2](cost, n_rows)

    (kcanvas.canvas_scatter_forward, kcanvas.canvas_scatter_backward,
     khung.hungarian_rows) = rec_fwd, rec_bwd, rec_hung
    try:
        t1 = time.perf_counter()
        logs, _, grads = loss_and_grads(state, batches[0], gen)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t1) * 1e3
    finally:
        (kcanvas.canvas_scatter_forward, kcanvas.canvas_scatter_backward,
         khung.hungarian_rows) = orig
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    if bad or not np.isfinite(float(logs["loss"])):
        failures.append(f"train: non-finite loss {float(logs['loss'])} or "
                        f"gradients {bad[:5]}")
    print(f"[train] first forward+backward {first_ms:.1f} ms, loss "
          f"{float(logs['loss']):.4f}, {len(grads)} gradients finite: "
          f"{not bad}; gradient norms {grad_norms(grads)}", flush=True)
    state.opt_state = state.optimizer.step(
        dict(state.model.named_parameters()), grads, state.opt_state)
    state.step += 1
    del grads

    with torch.no_grad():
        # ---- kernel A: canvas scatter ------------------------------------
        table, cells, hw = cap["fwd"]
        b, p, c = table.shape
        got = kcanvas.canvas_scatter_forward(table, cells, hw)
        want = kcanvas.canvas_scatter_plain(table, cells, hw)
        err = float((got.float() - want.float()).abs().max())
        same = torch.equal(got, want)
        ms_k = cuda_ms(torch, lambda: kcanvas.canvas_scatter_forward(
            table, cells, hw), 20)
        ms_p = cuda_ms(torch, lambda: kcanvas.canvas_scatter_plain(
            table, cells, hw), 5)
        n_valid = int((cells < hw[0] * hw[1]).sum())
        esz = table.element_size()
        bnd = bound(b * hw[0] * hw[1] * c * esz + b * p * (c * esz + 4), 0.0)
        # library: Tensor.scatter_ into a zeroed (B, H*W + 1, C) canvas (the
        # zero fill is part of the function: every cell is written)
        lib_canvas = torch.empty((b, hw[0] * hw[1] + 1, c),
                                 dtype=table.dtype, device=table.device)
        lib_idx = cells.long()[..., None].expand(b, p, c)
        lib_a = cuda_ms(torch, lambda: lib_canvas.zero_().scatter_(
            1, lib_idx, table), 20)
        del lib_canvas
        record("canvas_scatter", "mask_bev_tpu_torch/csrc/canvas.cu",
               "mask_bev_tpu/ops/pallas_canvas.py:216", err, 0.0, ms_k, ms_p,
               bnd, f"table {tuple(table.shape)} {table.dtype}, {n_valid} "
               f"valid pillars of {b * p} slots; library: zero_ + "
               f"scatter_", ok=same, library_ms=lib_a)
        # ---- kernel B: its gradient --------------------------------------
        d_canvas, cells_b, hw = cap["bwd"]
        got = kcanvas.canvas_scatter_backward(d_canvas, cells_b, hw)
        want = kcanvas.canvas_gather_plain(d_canvas, cells_b, hw)
        err = float((got.float() - want.float()).abs().max())
        same = torch.equal(got, want)
        ms_k = cuda_ms(torch, lambda: kcanvas.canvas_scatter_backward(
            d_canvas, cells_b, hw), 20)
        ms_p = cuda_ms(torch, lambda: kcanvas.canvas_gather_plain(
            d_canvas, cells_b, hw), 5)
        # the rows this run gathers (valid pillars), the table written, cells
        bnd = bound(n_valid * c * esz + b * p * (c * esz + 4), 0.0)
        # library: torch.gather of the gradient at the cells (clamped
        # index; it leaves unused slots holding a row, not 0)
        gf = d_canvas.reshape(b, hw[0] * hw[1], c)
        lib_idx = cells_b.long().clamp(max=hw[0] * hw[1] - 1)[..., None] \
            .expand(b, p, c)
        lib_b = cuda_ms(torch, lambda: torch.gather(gf, 1, lib_idx), 20)
        record("canvas_scatter_bwd", "mask_bev_tpu_torch/csrc/canvas.cu",
               "mask_bev_tpu/ops/pallas_canvas.py:230", err, 0.0, ms_k,
               ms_p, bnd, f"d_canvas {tuple(d_canvas.shape)} "
               f"{d_canvas.dtype}; library: gather", ok=same,
               library_ms=lib_b)
        del gf, lib_idx
        # ---- kernel C: the matcher ---------------------------------------
        cost, n_rows = cap["hung"]
        got = khung.hungarian_rows(cost, n_rows)
        want = khung.hungarian_rows_plain(cost, n_rows)
        n_diff = int((got != want).sum())
        err = float((got - want).abs().max())
        ms_k = cuda_ms(torch, lambda: khung.hungarian_rows(cost, n_rows), 20)
        ms_p = cuda_ms(torch, lambda: khung.hungarian_rows_plain(
            cost, n_rows), 1, warm=0)
        # bytes: the cost matrices read once, the assignment written; the
        # operations (a few per column and tree step) take less time
        bnd = bound(cost.numel() * 4 + n_rows.numel() * 4
                    + cost.shape[0] * cost.shape[2] * 4, 0.0)
        record("hungarian", "mask_bev_tpu_torch/csrc/hungarian.cu",
               "mask_bev_tpu/ops/hungarian.py:95 (XLA while_loop, not a "
               "TPU kernel)", err, 0.0, ms_k, ms_p, bnd,
               f"{cost.shape[0]} problems of {tuple(cost.shape[1:])}, rows "
               f"{n_rows.tolist()}; assignments that differ: {n_diff}",
               ok=n_diff == 0)
    del cap, table, cells, d_canvas, cells_b, got, want

    # ---- the main path: warm and timed steps -------------------------------
    before = {k: t.detach().clone()
              for k, t in state.model.named_parameters()}
    for i in range(TRAIN_WARM):
        state, logs, _ = train_step(state, batches[(i + 1) % 3], gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    times, losses = [], []
    for i in range(TRAIN_TIMED):
        t1 = time.perf_counter()
        state, logs, out = train_step(state, batches[i % 3], gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(logs["loss"]))
    launches = dict(kb.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_step = float(np.median(times) * 1e3)
    changed = sum(not torch.equal(t, before[k])
                  for k, t in state.model.named_parameters())
    print(f"[train] {TRAIN_TIMED} timed steps of batch {TRAIN_BATCH}: median "
          f"{ms_step:.3f} ms/step, mean {np.mean(times) * 1e3:.3f} ms, "
          f"{TRAIN_BATCH / (ms_step / 1e3):.3f} scans/s, peak memory "
          f"{peak_gb:.2f} GiB [{card}]", flush=True)
    print(f"[train] losses {[round(x, 4) for x in losses]}; "
          f"gt_crop_truncated {float(logs['gt_crop_truncated'])}; "
          f"parameters changed {changed} of {len(before)}", flush=True)
    print(f"[train] launches over the {TRAIN_TIMED} timed steps: "
          f"{launches}", flush=True)
    if not np.isfinite(losses).all():
        failures.append(f"train: non-finite losses {losses}")
    if changed == 0:
        failures.append("train: no parameter changed")
    exp = (cfg.num_decoder_outputs, TRAIN_BATCH, cfg.num_queries,
           cfg.grid_hw[0] // 4, cfg.grid_hw[1] // 4)
    if tuple(out.mask_logits.shape) != exp:
        failures.append(f"train: mask logits {tuple(out.mask_logits.shape)}")
    for k in ("canvas_scatter", "canvas_scatter_bwd", "hungarian"):
        results[k]["launches"] = launches.get(k, 0)
        if launches.get(k, 0) <= 0:
            failures.append(f"{k} never launched in the timed train steps")
    del before

    # ---- where the time goes: one traced step -----------------------------
    traced(torch, lambda: train_step(state, batches[0], gen),
           "train profile", "step", card, 20)
    del state, batches, out, logs
    torch.cuda.empty_cache()

    # ---- small training step: the card against the plain CPU path ---------
    for dtype, tol_loss, tol_norm in (("float32", 1e-3, 1e-2),
                                      ("bfloat16", 5e-2, 1e-1)):
        small = tiny_test_config().replace(
            head_num_attn_heads=2, compute_dtype=dtype, loss_gt_crop=48,
            max_num_pillars=256)
        batch = make_batch(np.random.default_rng(SEED + 3), small,
                           noise_points=1200)
        rng = np.random.default_rng(SEED + 4)
        n_l, pts_n = small.num_decoder_outputs, small.head_num_points
        mcs = rng.uniform(size=(n_l, small.batch_size, pts_n, 2))
        lcs = rng.uniform(size=(n_l, small.batch_size * small.num_queries,
                                pts_n, 2))
        res = {}
        for dev in ("cuda", "cpu"):
            st = create_train_state(small, seed=SEED + 5, device=dev)
            coords = [(torch.as_tensor(m, dtype=torch.float32, device=dev),
                       torch.as_tensor(c, dtype=torch.float32, device=dev))
                      for m, c in zip(mcs, lcs)]
            kb.reset_launches()
            lg, _, gr = loss_and_grads(st, batch, coords=coords)
            res[dev] = (float(lg["loss"]), grad_norms(gr),
                        dict(kb.LAUNCHES))
        (l_g, n_g, launch_g), (l_c, n_c, _) = res["cuda"], res["cpu"]
        d_loss = abs(l_g - l_c) / abs(l_c)
        d_norm = max(abs(n_g[k] - n_c[k]) / n_c[k] for k in n_c)
        ok = (d_loss <= tol_loss and d_norm <= tol_norm and all(
            launch_g[k] > 0 for k in ("canvas_scatter", "canvas_scatter_bwd",
                                      "hungarian")))
        print(f"[small train {dtype}] card vs CPU plain path: loss "
              f"{l_g:.6f} vs {l_c:.6f} (relative diff {d_loss:.3g}, "
              f"tolerance {tol_loss}), gradient norms per module, largest "
              f"relative diff {d_norm:.3g} (tolerance {tol_norm}); card "
              f"launches {launch_g} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"small train step {dtype} card vs CPU")


def shapes_phase(np, torch, card, failures) -> None:
    """The shapes the kernels refused before: ``tiny_test_config()`` with
    its own 8 heads (head width 8: the decoder stack's split instance)
    served on the card against the CPU, and the canvas (kernel 2) at B =
    184 (two launches of 92 samples) against its plain version, bit for
    bit, on a 200x200 grid of 128 channels."""
    from mask_bev_tpu_torch.config import tiny_test_config
    from mask_bev_tpu_torch.inference import MaskBevPredictor
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.models.maskbev import MaskBev
    from mask_bev_tpu_torch.ops import canvas as kcanvas

    small = tiny_test_config().replace(compute_dtype="bfloat16",
                                       backbone_quantize="int8")
    ssd = MaskBev(small).random_state_dict(SEED + 1)
    sp, sm = scans(np, 2, small.max_points_per_scan, SEED + 2)
    sp[..., :2] *= 0.25  # into the 20 m grid
    sm[:, 1800:] = False
    kb.reset_launches()
    c_gpu, m_gpu = MaskBevPredictor(small, ssd, device="cuda").forward(
        torch.as_tensor(sp), torch.as_tensor(sm))
    torch.cuda.synchronize()
    launches, inst = dict(kb.LAUNCHES), dict(kb.INSTANCES)
    c_cpu, m_cpu = MaskBevPredictor(small, ssd, device="cpu").forward(
        torch.as_tensor(sp), torch.as_tensor(sm))
    d_cls = float((c_gpu.cpu() - c_cpu).abs().max())
    d_mask = float((m_gpu.cpu() - m_cpu).abs().mean())
    ok = (d_cls <= 0.1 and d_mask <= 0.02
          and inst.get("decoder_stack/split_tc_bf16", 0) > 0
          and all(launches[k] > 0 for k in ("stream_pfn", "canvas_norm",
                                            "swin_block", "decoder_stack")))
    print(f"[shapes] tiny config with its {small.head_num_attn_heads} heads "
          f"(head width {small.head_feat_channels // small.head_num_attn_heads}"
          f") on the card vs CPU: class probs max diff {d_cls:.4g} "
          f"(tolerance 0.1), mask probs mean diff {d_mask:.4g} (tolerance "
          f"0.02); launches {launches}, decoder instances "
          f"{ {k: v for k, v in inst.items() if 'split' in k} } -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("[shapes] tiny config with 8 heads on the card")
    del c_gpu, m_gpu

    # ---- the canvas at B = 184 ---------------------------------------------
    b, h, w, c, n = CANVAS_B184
    hw = h * w
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    cells = torch.sort(torch.rand((b, hw), generator=g, device="cuda")
                       .argsort(dim=1)[:, :n].to(torch.int32), dim=1).values
    pillars = torch.randint(0, n + 1, (b,), generator=g, device="cuda",
                            dtype=torch.int32)
    rows = torch.arange(n, device="cuda")[None]
    cells = torch.where(rows < pillars[:, None], cells, hw).contiguous()
    table = torch.randn((b, n, c), generator=g, device="cuda").to(
        torch.bfloat16)
    mean = 0.3 * torch.randn((b,), generator=g, device="cuda")
    var = 0.5 + 1.5 * torch.rand((b,), generator=g, device="cuda")
    scale = (1 + 0.1 * torch.randn((h, w, c), generator=g, device="cuda")
             ).to(torch.bfloat16)
    bias = (0.1 * torch.randn((h, w, c), generator=g, device="cuda")).to(
        torch.bfloat16)
    args = (mean, var, scale, bias, (h, w))
    kb.reset_launches()
    with torch.no_grad():
        got = kcanvas.canvas_norm(table, cells, pillars, *args)
        torch.cuda.synchronize()
        inst = dict(kb.INSTANCES)
        ms_k = cuda_ms(torch, lambda: kcanvas.canvas_norm(
            table, cells, pillars, *args), 3)
        want = kcanvas.canvas_norm_plain(table, cells, *args)
        # each sample's arithmetic is its own and the same as the plain
        # version's (one rounding of the same f32 expression): bit for bit
        same = torch.equal(got, want)
        err = float((got.float() - want.float()).abs().max())
        del want
        ms_p = cuda_ms(torch, lambda: kcanvas.canvas_norm_plain(
            table, cells, *args), 1)
    ok = same and inst == {"canvas_norm/bf16": len(kcanvas.canvas_chunks(b))}
    print(f"[shapes] canvas at B={b} ({h}x{w}, C {c}, bf16): launches "
          f"{inst} for chunks {kcanvas.canvas_chunks(b)}; bit for bit "
          f"against the plain version over all {b} samples: {same} "
          f"(max_abs_err {err:.6g}); kernel {ms_k:.3f} ms plain {ms_p:.3f} "
          f"ms -> {'ok' if ok else 'FAIL'} [{card}]", flush=True)
    if not ok:
        failures.append("[shapes] canvas at B = 184")
    del got, table, cells, scale, bias
    torch.cuda.empty_cache()
    # a kernel that refuses a shape raises on the card (no plain route), so
    # the flagship phases above, which completed, ran on their kernels
    print("[shapes] flagship refusals 0: a shape a kernel refuses raises on "
          "the card, and every flagship phase ran to its end", flush=True)


def trainer_phase(np, torch, card, failures, here) -> None:
    """``Trainer.fit`` at the widths of ``configs/training/semantic_kitti/
    02_train_smoke_tpu.yml`` (bf16, AdamW, plateau, batch 4, 131072 point
    slots, a 128-channel PFN, Swin embed 192, 45 queries) on its synthetic
    scenes, cut to 3 training and 2 validation batches an epoch and 2
    epochs; then the ``--test`` restore of ``best`` with a validation and
    the per-layer metrics; then ``MaskBevPredictor.from_checkpoint`` serving
    8 scans with ``boxes``, and again from random weights with the class
    head's class-1 bias raised by 20 (every query then predicts an object
    with a mask of about half the grid; six steps of training leave every
    query background with an empty mask), its boxes held against
    ``mask_to_boxes`` on the probabilities of the same scans through the
    card's forward. Times each step, validation epoch and checkpoint
    write (synchronised), and counts the launches of kernels A, B, C (the
    training steps), 1-3 (validation) and 1-5 (serving)."""
    import shutil
    import tempfile

    from mask_bev_tpu_torch.config import MaskBevConfig
    from mask_bev_tpu_torch.datasets.synthetic import make_batch
    from mask_bev_tpu_torch.evaluation.kitti_eval import mask_to_boxes
    from mask_bev_tpu_torch.inference import MaskBevPredictor
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.models.maskbev import MaskBev
    from mask_bev_tpu_torch.train import loop
    from mask_bev_tpu_torch.train.checkpoint import CheckpointManager
    from train_mask_bev_torch import build_datamodule

    yml = os.path.join(here, "configs", "training", "semantic_kitti",
                       "02_train_smoke_tpu.yml")
    # image dumps off: they need matplotlib, which the card's machine lacks
    cfg = MaskBevConfig.from_yaml(yml).replace(
        limit_train_batches=3, limit_val_batches=2, max_epochs=2,
        log_images=False)
    dm = build_datamodule(cfg, None)  # the CLI's synthetic data
    train_b, val_b = dm.train_batches, dm.val_batches
    os.makedirs(os.path.join(here, "runs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(here,
                                                                 "runs"))
    steps, vals, saves, losses = [], [], [], []
    orig = (loop.train_step, loop.Trainer.validate, CheckpointManager._save)

    def synced(store, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            store.append(time.perf_counter() - t1)
            if fn is orig[0]:  # a training step: (state, logs, outputs)
                losses.append(float(out[1]["loss"]))
            return out
        return run

    loop.train_step = synced(steps, orig[0])
    loop.Trainer.validate = synced(vals, orig[1])
    CheckpointManager._save = synced(saves, orig[2])
    try:
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats()
        kb.reset_launches()
        tr = loop.Trainer(cfg, workdir=work, device="cuda")
        last = tr.fit(train_b, val_b)
        fit_launch = dict(kb.LAUNCHES)
        fit_s = time.time() - t0
        kb.reset_launches()
        loop.load_ckpt_state(tr.state, tr.ckpt.restore("best"))
        test = tr.validate(val_b(0), tr.generator(0))
        test_launch = dict(kb.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        ckpt_dir = str(tr.ckpt.dir)
        index = dict(tr.ckpt.index)
        ckpt_bytes = os.path.getsize(tr.ckpt.path("last"))
        tr.logger.close()
        del tr
        torch.cuda.empty_cache()
        kb.reset_launches()
        pred = MaskBevPredictor.from_checkpoint(cfg, ckpt_dir, "best",
                                                device="cuda")
        batch = make_batch(np.random.default_rng(SEED + 7), cfg,
                           batch_size=BATCH)
        t1 = time.perf_counter()
        served = pred.predict_batch(batch["points"], batch["point_mask"],
                                    score_threshold=0.0)
        serve_s = time.perf_counter() - t1
        serve_launch = dict(kb.LAUNCHES)
        # the box path on predictions that are objects: random weights
        # (mask probabilities around 0.5) with class 1 raised
        del pred
        sd = MaskBev(cfg).random_state_dict(SEED + 8)
        sd["decoder.heads.cls_embed.bias"][1] += 20.0
        pred = MaskBevPredictor(cfg, sd, device="cuda")
        forced = pred.predict_batch(batch["points"], batch["point_mask"],
                                    score_threshold=0.0)
        del pred
    finally:
        (loop.train_step, loop.Trainer.validate,
         CheckpointManager._save) = orig
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # the boxes again from each scan's kept queries (every query at
    # threshold 0 with class 1 raised): their labels and scores, and the
    # card's mask probabilities
    want_boxes = []
    for s in forced:
        cls_kept = np.zeros((len(s.labels), cfg.head_num_classes + 1),
                            np.float32)
        cls_kept[np.arange(len(s.labels)), s.labels] = s.scores
        want_boxes.append(mask_to_boxes(cls_kept, s.mask_probs, cfg,
                                        score_threshold=0.0)[0])

    n_l = cfg.num_decoder_outputs
    metric_keys = [f"val_{k}_{i}" for i in range(n_l)
                   for k in ("mAP_cls", "mIoU")] + [
        f"val_mAP_{i}_map" for i in range(n_l)]
    index_ok = (index.get("last_step") == 6 and index.get("last_epoch") == 1
                and isinstance(index.get("best_step"), int)
                and np.isfinite(index.get("best_val_loss") or np.nan)
                and set(index.get("last_meta", {})) >= {
                    "epoch", "plateau_scale", "early_stop_bad_epochs"})
    finite = (len(losses) == 6 and np.isfinite(losses).all()
              and np.isfinite(last["val_loss"])
              and np.isfinite(test["val_loss"])
              and all(np.isfinite(test[k]) for k in metric_keys))
    n_boxes = [len(s.boxes) for s in served]
    n_forced = [len(s.boxes) for s in forced]
    same_shape = all(np.shape(s.boxes) == np.shape(w)
                     for s, w in zip(forced, want_boxes))
    box_err = max((float(np.abs(s.boxes - w).max()) for s, w in
                   zip(forced, want_boxes) if len(w)), default=0.0) \
        if same_shape else float("inf")
    boxes_ok = sum(n_forced) > 0 and box_err <= 1e-6
    print(f"[trainer] {cfg.name} at its widths (embed "
          f"{cfg.backbone_embed_dim}, head {cfg.head_feat_channels}, "
          f"{cfg.num_queries} queries, PFN {cfg.encoder_feat_channels}, "
          f"{cfg.max_points_per_scan} point slots, batch {cfg.batch_size}, "
          f"{cfg.compute_dtype}, {cfg.optimiser_type}, "
          f"{cfg.lr_schedulers_type}); 3 train + 2 val batches x 2 epochs, "
          f"images off (no matplotlib on the card's machine): fit "
          f"{fit_s:.1f} s [{card}]", flush=True)
    print(f"[trainer] train step median {np.median(steps):.4f} s (of "
          f"{len(steps)}: {[round(x, 4) for x in steps]}); validation epoch "
          f"median {np.median(vals[:2]):.4f} s ({[round(x, 4) for x in vals]}"
          f", the last is the --test pass); checkpoint {ckpt_bytes} bytes, "
          f"write median {np.median(saves):.4f} s ({len(saves)} writes); "
          f"peak memory {peak_gb:.2f} GiB [{card}]", flush=True)
    print(f"[trainer] losses {[round(x, 4) for x in losses]}; val_loss "
          f"{last['val_loss']:.4f}; --test restore of best (epoch "
          f"{index.get('best_epoch')}, val_loss "
          f"{float(index.get('best_val_loss') or np.nan):.4f}): val_loss "
          f"{test['val_loss']:.4f}, val_mIoU_{n_l - 1} "
          f"{test[f'val_mIoU_{n_l - 1}']:.4f}, val_mAP_cls_{n_l - 1} "
          f"{test[f'val_mAP_cls_{n_l - 1}']:.4f}; index.json well formed: "
          f"{index_ok}", flush=True)
    print(f"[trainer] served {len(served)} scans from best in "
          f"{serve_s:.3f} s, boxes per scan {n_boxes}; random weights with "
          f"class 1 raised by 20: boxes per scan {n_forced}, against "
          f"mask_to_boxes on the card's probabilities max diff "
          f"{box_err:.3g} (tolerance 1e-6) -> "
          f"{'ok' if boxes_ok else 'FAIL'}", flush=True)
    print(f"[trainer] launches: fit {fit_launch}; --test validation "
          f"{test_launch}; serving {serve_launch}", flush=True)
    need = ([("fit", fit_launch, k) for k in
             ("canvas_scatter", "canvas_scatter_bwd", "hungarian", "pfn",
              "canvas_norm", "swin_block")]
            + [("test", test_launch, k) for k in
               ("pfn", "canvas_norm", "swin_block")]
            + [("serving", serve_launch, k) for k in
               ("pfn", "canvas_norm", "swin_block", "decoder_stack")])
    missing = [f"{k} ({where})" for where, got, k in need if got[k] <= 0]
    if missing:
        failures.append(f"[trainer] never launched: {missing}")
    if not boxes_ok:
        failures.append("[trainer] boxes of the served predictions")
    if not (finite and index_ok) or len(served) != BATCH or any(
            s.boxes.shape[1:] != (5,) for s in served):
        failures.append(f"[trainer] losses finite {finite}, index.json "
                        f"{index_ok}, served {len(served)} scans")


def resume_phase(np, torch, card, failures, here) -> None:
    """A resumed run against an unbroken one on the card: the tiny config
    (its 8 heads, bf16) fits 2 epochs straight through, twice, and 1 epoch
    then a new ``Trainer(checkpoint="last")`` for the second. Parameters,
    running statistics and optimizer moments compared bitwise; should the
    card's reductions not be deterministic (atomic adds), parameters within
    2 x lr a step after the resume, the most an Adam step moves one, with
    the difference of the two unbroken runs printed beside it."""
    import shutil
    import tempfile

    from mask_bev_tpu_torch.config import tiny_test_config
    from mask_bev_tpu_torch.train.loop import Trainer
    from train_mask_bev_torch import build_datamodule

    cfg = tiny_test_config().replace(
        compute_dtype="bfloat16", batch_size=2, limit_train_batches=2,
        limit_val_batches=1, max_epochs=2, log_images=False,
        loss_gt_crop=48, max_num_pillars=256, head_num_points=64)
    dm = build_datamodule(cfg, None)
    train_b, val_b = dm.train_batches, dm.val_batches
    os.makedirs(os.path.join(here, "runs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(here,
                                                                 "runs"))

    def tensors(tr):
        st = tr.state
        out = {f"model.{k}": v for k, v in st.model.state_dict().items()}
        out.update({f"mu.{k}": v for k, v in st.opt_state.mu.items()})
        out.update({f"nu.{k}": v for k, v in st.opt_state.nu.items()})
        return out

    def diff(a, b):
        return max(float((a[k].float() - b[k].float()).abs().max())
                   for k in a)

    try:
        runs = []
        for i in range(2):
            tr = Trainer(cfg, workdir=os.path.join(work, f"whole{i}"),
                         device="cuda")
            tr.fit(train_b, val_b)
            runs.append(tensors(tr))
        first = Trainer(cfg, workdir=os.path.join(work, "resumed"),
                        device="cuda")
        first.fit(train_b, val_b, max_epochs=1)
        second = Trainer(cfg.replace(checkpoint="last"),
                         workdir=os.path.join(work, "resumed"),
                         device="cuda")
        resumed_from = (second.epoch, second.state.step)
        second.fit(train_b, val_b)
        got = tensors(second)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    params = [k for k in got if k.startswith("model.")]
    bitwise = all(torch.equal(got[k], runs[0][k]) for k in got)
    d_resume = diff(got, runs[0])
    d_param = diff({k: got[k] for k in params},
                   {k: runs[0][k] for k in params})
    d_whole = diff(runs[1], runs[0])
    tol = 2 * cfg.lr * cfg.limit_train_batches
    ok = resumed_from == (1, 2) and (bitwise or d_param <= tol)
    print(f"[resume] tiny config ({cfg.head_num_attn_heads} heads, "
          f"{cfg.compute_dtype}) on the card: 2 epochs unbroken vs 1 epoch "
          f"+ resume from last (epoch {resumed_from[0]}, step "
          f"{resumed_from[1]}): bitwise equal {bitwise}; largest difference "
          f"{d_resume:.3g} (parameters {d_param:.3g}, tolerance {tol:.3g} "
          f"where not bitwise); two unbroken runs differ by {d_whole:.3g} "
          f"-> {'ok' if ok else 'FAIL'} [{card}]", flush=True)
    if not ok:
        failures.append("[resume] resumed run differs from the unbroken one")


# ---- [data]: training on real on-disk scans --------------------------------
# the trees (datasets/disk_trees.py): SemanticKITTI sequence 00 (train) and
# 08 (valid), KITTI training frames (train / val ids), points a scan
DATA_SK_SCANS = (32, 8)
DATA_KITTI_FRAMES = (16, 12)
DATA_POINTS = 120_000
DATA_WORKERS = 4
# the fits' cuts: (training batches, validation batches) of one epoch
DATA_LIMITS = {"semantic_kitti": (3, 2), "kitti": (2, 1)}
DATA_YML = {"semantic_kitti": "semantic_kitti/01_semantic_kitti.yml",
            "kitti": "kitti/01_kitti.yml"}


def live_children() -> list:
    """Process ids whose parent is this process (from /proc)."""
    me = str(os.getpid())
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[1] == me and fields[0] != "Z":
            out.append(int(pid))
    return out


def median_ms(fn, args_list) -> float:
    """Median host ms of ``fn(*args)`` over ``args_list``."""
    import statistics

    times = []
    for args in args_list:
        t1 = time.perf_counter()
        fn(*args)
        times.append((time.perf_counter() - t1) * 1e3)
    return statistics.median(times)


def data_cfg(here, dataset: str, tree: str, **kw):
    """The shipped YAML of ``dataset`` with the phase's cuts (epoch limits,
    workers, images off); ``object_sample`` reads the written tree."""
    from mask_bev_tpu_torch.config import MaskBevConfig

    n_train, n_val = DATA_LIMITS[dataset]
    cfg = MaskBevConfig.from_yaml(os.path.join(
        here, "configs", "training", DATA_YML[dataset]))
    augs = [dict(a, dataset_root=tree) if a["name"] == "object_sample"
            else a for a in cfg.augmentations]
    return cfg.replace(limit_train_batches=n_train,
                       limit_val_batches=n_val, max_epochs=1,
                       num_workers=DATA_WORKERS, log_images=False,
                       augmentations=augs, **kw)


def data_phase(np, torch, card, failures, here) -> None:
    """``[data]``: the port trained on scans read from disk. Writes a
    SemanticKITTI tree (sequence 00: 32 scans 1 m apart, 08: 8 scans, about
    120k points a scan, 12-20 parked cars in view with world-stable
    instance ids) and a KITTI tree (16 frames of about 120k points with
    8-15 Car, Pedestrian and Cyclist boxes, 12 train / 4 val, its
    ``samples.pkl``) from the seed (``datasets/disk_trees.py``), then:
    the C++ host core against its numpy twins at 500x500 and 800x800;
    host ms a sample (SemanticKITTI cache miss, hit, hit with the shipped
    augmentations; KITTI with ``object_sample`` and the other shipped
    transforms); one epoch's batches of each dataset with 0 and 4 worker
    processes, bitwise equal; ``Trainer.fit`` on ``01_semantic_kitti.yml``
    and ``01_kitti.yml`` as shipped (f32, batch 4; a batch the card cannot
    hold is cut and printed) with the ``--test`` restore of ``best``; and
    the CLI ``train_mask_bev_torch.py --train --test`` on the SemanticKITTI
    tree."""
    import pickle
    import shutil
    import tempfile

    from mask_bev_tpu_torch.datasets.disk_trees import (
        write_kitti_tree, write_semantic_kitti_tree)
    from mask_bev_tpu_torch.datasets.kitti.object_sampler import (
        write_samples)
    from mask_bev_tpu_torch.datasets.semantic_kitti import mask_data

    torch.cuda.empty_cache()
    os.makedirs(os.path.join(here, "runs"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_",
                           dir=os.path.join(here, "runs"))
    try:
        t1 = time.perf_counter()
        sk = str(write_semantic_kitti_tree(
            os.path.join(tmp, "sk"), seed=SEED, train_scans=DATA_SK_SCANS[0],
            valid_scans=DATA_SK_SCANS[1], points=DATA_POINTS))
        kitti = str(write_kitti_tree(
            os.path.join(tmp, "kitti"), seed=SEED,
            frames=DATA_KITTI_FRAMES[0], train=DATA_KITTI_FRAMES[1],
            points=DATA_POINTS))
        bank = write_samples(kitti, log_every=0)
        with open(bank, "rb") as f:
            n_bank = len(pickle.load(f))
        print(f"[data] trees written in {time.perf_counter() - t1:.2f} s: "
              f"SemanticKITTI sequences 00 ({DATA_SK_SCANS[0]} scans) and 08 "
              f"({DATA_SK_SCANS[1]}), KITTI {DATA_KITTI_FRAMES[0]} frames "
              f"({DATA_KITTI_FRAMES[1]} train), {DATA_POINTS} points a scan; "
              f"samples.pkl {n_bank} objects", flush=True)
        data_host_core(np, card, failures, sk)
        data_host_samples(np, card, here, sk, kitti)
        c = data_cfg(here, "semantic_kitti", sk)
        grid = ["--x-range", *map(str, c.x_range), "--y-range",
                *map(str, c.y_range), "--z-range", *map(str, c.z_range),
                "--voxel-size", str(c.voxel_size), "--min-points",
                str(c.min_num_points)]
        for split in ("train", "valid"):
            t1 = time.perf_counter()
            mask_data.main(["--root", sk, "--split", split, "--processes",
                            "8", *grid])
            print(f"[data] SemanticKITTI {split} mask cache warmed on 8 "
                  f"processes in {time.perf_counter() - t1:.2f} s [{card}]",
                  flush=True)
        data_epochs(np, card, failures, here, sk, kitti)
        for dataset, tree in (("semantic_kitti", sk), ("kitti", kitti)):
            data_fit(np, torch, card, failures, here, dataset, tree)
        data_cli(card, failures, here, sk, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def data_host_core(np, card, failures, sk: str) -> None:
    """The host core's three entry points against their numpy twins on a
    SemanticKITTI-like mask and KITTI-like boxes, at 500x500 (0.16 m) and
    800x800 (0.1 m), with the median ms of each side."""
    from mask_bev_tpu_torch import native
    from mask_bev_tpu_torch.datasets.kitti.kitti_dataset import BoxArray
    from mask_bev_tpu_torch.datasets.kitti.kitti_rasterizer import (
        fill_rotated_boxes_img, points_in_boxes_count)
    from mask_bev_tpu_torch.ops.morphology import close_then_open

    t1 = time.perf_counter()
    native.lib()
    print(f"[data] host core built and loaded in "
          f"{time.perf_counter() - t1:.2f} s ({native.build()})", flush=True)
    rng = np.random.default_rng(SEED + 20)
    pts = np.fromfile(os.path.join(sk, "dataset", "sequences", "00",
                                   "velodyne", "000000.bin"),
                      np.float32).reshape(-1, 4)
    n = 15
    centers = np.stack([rng.uniform(5, 60, n), rng.uniform(-30, 30, n),
                        np.full(n, -1.73)], 1).astype(np.float32)
    dims = np.tile(np.float32([4.2, 1.8, 1.6]), (n, 1))
    yaws = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    keep = np.ones(n, np.uint8)
    for hw, voxel, x0, y0 in ((500, 0.16, -40.0, -40.0),
                              (800, 0.1, 0.0, -40.0)):
        mask = rng.random((hw, hw)) < 0.02
        for r, c in rng.integers(0, hw - 40, (12, 2)):
            mask[r:r + 28, c:c + 12] = True  # car-sized blobs
        reps = [(mask,)] * 5
        ok_m = np.array_equal(native.close_then_open(mask),
                              close_then_open(mask))
        ms_m = (median_ms(native.close_then_open, reps),
                median_ms(close_then_open, reps))
        fill_args = [(hw, hw, centers[:, :2], dims[:, :2], yaws, keep, x0,
                      y0, voxel)] * 5
        ok_f = np.array_equal(native.fill_rotated_boxes_img(*fill_args[0]),
                              fill_rotated_boxes_img(*fill_args[0]))
        ms_f = (median_ms(native.fill_rotated_boxes_img, fill_args),
                median_ms(fill_rotated_boxes_img, fill_args))
        print(f"[data] host core {hw}x{hw}: close_then_open equal {ok_m} "
              f"(C++ {ms_m[0]:.3f} ms, numpy {ms_m[1]:.3f} ms); "
              f"fill_rotated_boxes_img of {n} boxes equal {ok_f} (C++ "
              f"{ms_f[0]:.3f} ms, numpy {ms_f[1]:.3f} ms) [{card}]",
              flush=True)
        if not (ok_m and ok_f):
            failures.append(f"[data] host core against numpy at {hw}x{hw}")
    boxes = BoxArray(centers, dims, yaws, *([np.zeros(n)] * 7))
    got = native.points_in_boxes_count(pts, centers, dims, yaws)
    ok_c = np.array_equal(got, points_in_boxes_count(pts, boxes))
    ms_c = (median_ms(native.points_in_boxes_count,
                      [(pts, centers, dims, yaws)] * 5),
            median_ms(points_in_boxes_count, [(pts, boxes)] * 5))
    print(f"[data] host core points_in_boxes_count of {len(pts)} points in "
          f"{n} boxes equal {ok_c} (C++ {ms_c[0]:.3f} ms, numpy "
          f"{ms_c[1]:.3f} ms) [{card}]", flush=True)
    if not ok_c:
        failures.append("[data] points_in_boxes_count against numpy")


def data_host_samples(np, card, here, sk: str, kitti: str) -> None:
    """Host ms a sample (median): SemanticKITTI on a cache miss (the 2x
    window accumulates the sequence), on a hit, on a hit with the shipped
    augmentations; KITTI with the shipped transforms, ``object_sample``
    included, and without them."""
    from mask_bev_tpu_torch.datasets.kitti.kitti_data import (
        KittiMaskDataModule)
    from mask_bev_tpu_torch.datasets.semantic_kitti.mask_data import (
        SemanticKittiMaskDataModule, mask_scan_to_sample)

    cfg = data_cfg(here, "semantic_kitti", sk)
    dm = SemanticKittiMaskDataModule(sk, cfg)
    ds = dm._mask_dataset("train")
    miss_idx = [int(i) for i in np.linspace(0, len(ds) - 1, 4)]
    miss = median_ms(lambda i: mask_scan_to_sample(ds[i], cfg),
                     [(i,) for i in miss_idx])  # writes their cache files
    scene = len(ds._valid_scan_numbers(ds._scan_dataset[miss_idx[0]]))
    hit = median_ms(lambda i: mask_scan_to_sample(ds[i], cfg),
                    [(i,) for i in miss_idx * 2])
    aug = median_ms(lambda i: mask_scan_to_sample(
        ds[i], cfg, dm.augmentations, np.random.default_rng([SEED, i])),
        [(i,) for i in miss_idx * 2])
    print(f"[data] SemanticKITTI host ms a sample: cache miss {miss:.1f} "
          f"(median of 4; the 2x window accumulates {scene} scans), cache "
          f"hit {hit:.1f}, hit with the shipped augmentations {aug:.1f} "
          f"(median of 8) [{card}]", flush=True)
    kcfg = data_cfg(here, "kitti", kitti)
    kdm = KittiMaskDataModule(kitti, kcfg)
    idx = list(range(8))
    with_aug = median_ms(lambda i: kdm.sample(
        i, True, np.random.default_rng([SEED, i])), [(i,) for i in idx])
    plain = median_ms(lambda i: kdm.sample(i, False), [(i,) for i in idx])
    print(f"[data] KITTI host ms a sample: {with_aug:.1f} with the shipped "
          f"transforms ({', '.join(a['name'] for a in kcfg.augmentations)}),"
          f" {plain:.1f} without (median of 8) [{card}]", flush=True)


def data_epochs(np, card, failures, here, sk: str, kitti: str) -> None:
    """One training epoch's batches of each data module with 0 and
    ``DATA_WORKERS`` worker processes: the two streams bitwise equal (a
    sha256 a batch), batches/s of each (the time spent waiting for the
    next batch)."""
    import hashlib
    import multiprocessing as mp

    from train_mask_bev_torch import build_datamodule

    for dataset, tree in (("semantic_kitti", sk), ("kitti", kitti)):
        rates, digests = [], []
        for workers in (0, DATA_WORKERS):
            cfg = data_cfg(here, dataset, tree).replace(num_workers=workers)
            it = build_datamodule(cfg, tree).train_batches(SEED + 1)
            wait, got = 0.0, []
            while True:
                t1 = time.perf_counter()
                batch = next(it, None)
                wait += time.perf_counter() - t1
                if batch is None:
                    break
                h = hashlib.sha256()
                for k in sorted(batch):
                    h.update(k.encode())
                    h.update(np.ascontiguousarray(batch[k]).tobytes())
                got.append(h.hexdigest())
            rates.append(len(got) / wait)
            digests.append(got)
        ok = digests[0] == digests[1] and len(digests[0]) > 0 \
            and not mp.active_children()
        print(f"[data] {dataset} epoch of {len(digests[0])} batches of "
              f"{cfg.batch_size}: {rates[0]:.3f} batches/s with 0 workers, "
              f"{rates[1]:.3f} with {DATA_WORKERS}; streams bitwise equal "
              f"{digests[0] == digests[1]} -> {'ok' if ok else 'FAIL'} "
              f"[{card}]", flush=True)
        if not ok:
            failures.append(f"[data] {dataset} epoch with 0 and "
                            f"{DATA_WORKERS} workers")


def data_fit(np, torch, card, failures, here, dataset: str, tree: str
             ) -> None:
    """``Trainer.fit`` on the shipped YAML (one epoch cut to
    ``DATA_LIMITS``, ``DATA_WORKERS`` workers, images off), then the
    ``--test`` restore of ``best`` with a validation. Times every step and
    validation (synchronised), the host-to-device copy of each batch, the
    step loop's wait on the prefetch; traces the training epoch for the
    card's idle share; counts the launches of kernels A, B, C and 1-3."""
    import gc
    import multiprocessing as mp
    import shutil
    import tempfile

    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.train import loop, step
    from train_mask_bev_torch import build_datamodule
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = data_cfg(here, dataset, tree)
    dm = build_datamodule(cfg, tree)
    rec = {"steps": [], "vals": [], "h2d": [], "wait": [], "losses": [],
           "busy": [], "wall": []}
    orig = (loop.train_step, loop.Trainer.validate, step._device_batch,
            loop.prefetch, loop.Trainer.train_epoch)

    def synced(store, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            rec[store].append(time.perf_counter() - t1)
            if fn is orig[0]:
                rec["losses"].append(float(out[1]["loss"]))
            return out
        return run

    def timed_prefetch(batches, depth=2):
        inner = orig[3](batches, depth)
        try:
            while True:
                t1 = time.perf_counter()
                item = next(inner, None)
                rec["wait"].append(time.perf_counter() - t1)
                if item is None:
                    return
                yield item
        finally:
            inner.close()

    def traced_epoch(self, *a, **k):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = orig[4](self, *a, **k)
            torch.cuda.synchronize()
            rec["wall"].append(time.perf_counter() - t1)
        rec["busy"].append(sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA) / 1e6)
        return out

    os.makedirs(os.path.join(here, "runs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_fit_",
                            dir=os.path.join(here, "runs"))
    loop.train_step = synced("steps", orig[0])
    loop.Trainer.validate = synced("vals", orig[1])
    step._device_batch = synced("h2d", orig[2])
    loop.prefetch = timed_prefetch
    loop.Trainer.train_epoch = traced_epoch
    cut = None
    try:
        while True:
            for v in rec.values():
                v.clear()
            try:
                torch.cuda.reset_peak_memory_stats()
                kb.reset_launches()
                t0 = time.time()
                tr = loop.Trainer(cfg, workdir=work, device="cuda")
                before = tr.state.model.decoder.query_feat.detach().clone()
                last = tr.fit(dm.train_batches, dm.val_batches)
                fit_launch = dict(kb.LAUNCHES)
                fit_s = time.time() - t0
                break
            except torch.cuda.OutOfMemoryError as e:
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                print(f"[data] {dataset} at batch {cfg.batch_size}: out of "
                      f"memory at a peak of {peak:.2f} GiB: "
                      f"{str(e).splitlines()[0]} [{card}]", flush=True)
                tr = None
                gc.collect()
                torch.cuda.empty_cache()
                if cfg.batch_size <= 1:
                    raise
                cut = cfg.batch_size
                cfg = cfg.replace(batch_size=cfg.batch_size // 2)
                dm = build_datamodule(cfg, tree)
                shutil.rmtree(work, ignore_errors=True)
                os.makedirs(work)
        changed = not torch.equal(before,
                                  tr.state.model.decoder.query_feat.detach())
        loop.Trainer.train_epoch = orig[4]
        kb.reset_launches()
        loop.load_ckpt_state(tr.state, tr.ckpt.restore("best"))
        test = tr.validate(dm.val_batches(0), tr.generator(0))
        test_launch = dict(kb.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        tr.logger.close()
        del tr
        gc.collect()
    finally:
        (loop.train_step, loop.Trainer.validate, step._device_batch,
         loop.prefetch, loop.Trainer.train_epoch) = orig
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    n_train, n_val = DATA_LIMITS[dataset]
    steps = rec["steps"]
    h2d = rec["h2d"][:len(steps)]  # the training steps' copies
    # the prefetch is drawn once a step and once more to see the limit
    wait = rec["wait"][:len(steps)]
    idle = 1 - sum(rec["busy"]) / sum(rec["wall"])
    children = live_children()
    finite = (len(rec["losses"]) == n_train
              and np.isfinite(rec["losses"]).all()
              and np.isfinite(last["val_loss"])
              and np.isfinite(test["val_loss"]))
    h, w = cfg.grid_hw
    print(f"[data] fit {cfg.name} as shipped ({cfg.compute_dtype}, "
          f"{h}x{w}, {cfg.head_num_classes} classes, batch "
          f"{cfg.batch_size}{f' (cut from {cut})' if cut else ''}, "
          f"{cfg.num_workers} workers, {len(cfg.augmentations)} "
          f"augmentations, remove_unseen {cfg.remove_unseen}); "
          f"{n_train} train + {n_val} val batches, images off: fit "
          f"{fit_s:.1f} s [{card}]", flush=True)
    print(f"[data] fit {cfg.name}: train step median {np.median(steps):.4f}"
          f" s ({[round(x, 4) for x in steps]}); validation epoch "
          f"{rec['vals'][0]:.4f} s, --test validation {rec['vals'][-1]:.4f} "
          f"s; peak memory {peak_gb:.2f} GiB; host->device copy of a batch "
          f"median {np.median(h2d) * 1e3:.2f} ms "
          f"({[round(x * 1e3, 2) for x in h2d]}); the step loop's wait on "
          f"the prefetch a step median {np.median(wait) * 1e3:.2f} ms "
          f"({[round(x * 1e3, 2) for x in wait]}); card idle over the "
          f"training epoch {idle:.3f} (busy {sum(rec['busy']):.3f} s of "
          f"{sum(rec['wall']):.3f} s wall) [{card}]", flush=True)
    print(f"[data] fit {cfg.name}: losses "
          f"{[round(x, 4) for x in rec['losses']]}; val_loss "
          f"{last['val_loss']:.4f}; --test val_loss {test['val_loss']:.4f}; "
          f"parameters changed {changed}; live child processes after the "
          f"fit {children}; launches: fit {fit_launch}, --test {test_launch}"
          f" [{card}]", flush=True)
    need = ([("fit", fit_launch, k) for k in
             ("canvas_scatter", "canvas_scatter_bwd", "hungarian", "pfn",
              "canvas_norm", "swin_block")]
            + [("test", test_launch, k) for k in
               ("pfn", "canvas_norm", "swin_block")])
    missing = [f"{k} ({where})" for where, got, k in need if got[k] <= 0]
    if missing:
        failures.append(f"[data] {cfg.name} never launched: {missing}")
    if not (finite and changed) or children or mp.active_children():
        failures.append(f"[data] {cfg.name}: losses finite {finite}, "
                        f"parameters changed {changed}, live children "
                        f"{children}")


def data_cli(card, failures, here, sk: str, tmp: str) -> None:
    """``train_mask_bev_torch.py --train --test`` on the SemanticKITTI tree
    with ``01_semantic_kitti.yml`` and the fit's cuts (written to a YAML
    beside the tree); it must exit 0 and print its test results."""
    import yaml

    n_train, n_val = DATA_LIMITS["semantic_kitti"]
    with open(os.path.join(here, "configs", "training",
                           DATA_YML["semantic_kitti"])) as f:
        d = yaml.safe_load(f)
    d.update(limit_train_batches=n_train, limit_val_batches=n_val,
             max_epochs=1, num_workers=DATA_WORKERS, log_images=False)
    yml = os.path.join(tmp, "01_semantic_kitti.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(d, f)
    t1 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, os.path.join(here, "train_mask_bev_torch.py"),
         "--config", yml, "--data-root", sk, "--train", "--test",
         "--workdir", os.path.join(tmp, "cli_runs")],
        capture_output=True, text=True, timeout=600, cwd=here)
    ok = res.returncode == 0 and "test results:" in res.stdout
    print(f"[data] CLI train_mask_bev_torch.py --train --test on the "
          f"SemanticKITTI tree ({n_train} train + {n_val} val batches, "
          f"{DATA_WORKERS} workers): rc {res.returncode} in "
          f"{time.perf_counter() - t1:.1f} s -> {'ok' if ok else 'FAIL'} "
          f"[{card}]", flush=True)
    if not ok:
        print(res.stdout[-2000:], res.stderr[-4000:], sep="\n", flush=True)
        failures.append(f"[data] CLI exited {res.returncode}")


if __name__ == "__main__":
    main()
