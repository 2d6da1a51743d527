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
   PyTorch path on the CPU (``small_phase``), and again with every model
   option on (height head, absolute embedding with ``swap_dims``, two
   refinement blocks a pixel-decoder level, the Fourier encoding) in f32
   and in bf16 (``[small options ...]``);
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
5d. phase O (``[e2e options]``): the main path's configuration with the
   height head, the absolute position embedding with ``swap_dims`` and two
   refinement blocks a pixel-decoder level, like steps 2-4 (kernels 1-5
   held, 3 warm and 5 timed requests, one traced request), plus kernel 7
   at the refinement blocks (C 256, 8 heads, grids 63, 32 and 16: held
   against its plain version as ``window_msa.refine``, its attention with
   SDPA beside it, its launches counted over the requests) and finite
   height logits; then a training step at batch 4 with GT heights and 2
   timed steps (``options_train_phase``: loss terms, gradients through
   the new parameters, peak memory);
5e. the encodings phase (``[e2e encodings]``, ``encodings_phase``): the
   main path's configuration with the Fourier encoding, the cosine
   encoding and a fifth point column: the capped stream with the plain
   pillar feature net (the JAX package's XLA route there), kernel 2 on its
   table held against its plain version, the plain PFN's ms, one warm and
   one timed request; kernels 1 and 10 must not launch, 2-5 must;
6. drives the training step (``train_step``) at the training envelope of
   the JAX bench: the same configuration with ``max_num_pillars=32768``, a
   bf16 forward over f32 master weights, batch 4, AdamW, synthetic scans of
   ~120k points (``datasets/synthetic.py``), random weights from a seed;
   captures the inputs of the training kernels (A: canvas scatter, B: its
   gradient, C: the matcher) in one step and holds each against its plain
   version (A and B exactly, C with equal assignments); then 1 warm and 3
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
8b. ``[shapes wide]`` (``shapes_wide_phase``): wider shapes the JAX
   package serves than the shipped configurations have, as four served paths
   at full width and batch 8, each like step 2-4 (kernels captured and
   held, 3 warm and 5 timed requests, the instance counters, one traced
   request): Swin-T (embed 96, window 7) with the fused patch embed
   (kernel 8 at E 96); Swin-B at 384 px (embed 128, depths (2, 2, 18, 2),
   window 12: kernels 3/4 at 144 tokens), then path K at window 12
   (kernel 7 at 144 tokens, one timed request); 100 points a pillar on
   scans with long pillars (``scans_long``; kernel 1, then path E's kernel
   10; the pillars over 32 kept points counted); 300 queries in bf16 and
   in f32 (the decoder's split instance in clusters of 16); then, at the
   kernel level (``wide_kernel_holds``), kernel 5 at Q = 512 and with 1
   and 16 heads (inputs captured from a forward), kernels 3/4 and 7 at
   window 16, kernel 8 at E = 48, kernels 1 and 10 at 64 and 128 points a
   pillar;
8c. ``[shapes tail]`` (``shapes_tail_phase``): ``.e384``, ``.hd8``,
   ``.hd40``, ``.c100`` served, then ``tail_kernel_holds``: kernel 9 at C
   12, 100 (the walk) and 2056, 3072, 4096 (the wide instance) and the
   Swin LN at C 2056-4096 (the wide kernel; bf16 / f32 out and int8 rows),
   each beside ``F.layer_norm``'s device time and bit for bit against the
   walk they replaced (``WALK_SHA256``), the narrow canvas and scatter,
   the GEMM's N tail, the head-width attention;
8d. ``[shapes audit]`` (``shapes_audit_phase``): the refusal audit's
   entries 1 and 3 served at full width and batch 8 like step 2-4:
   ``.u100`` (path E, PFN layers of 64, 64 and 100 units: kernel 10 at
   units that are not a multiple of 8), ``.hd96`` (head width 96 at every
   stage) and ``.w24`` (window 24: the streaming attention), and the
   audit's last entries as ``.rest`` (129 points a pillar on long-pillar
   scans: kernel 1's layered route beside its tiles; kernel 8 at E 72,
   padded to 96; the decoder's split instance at C 96 over 8 heads, padded
   to head width 16; the instance counters must show all three); then, at
   the kernel level (``audit_kernel_holds``), the attention at head widths
   72-128 at windows 10 and 24 (bf16, f32; Swin, and the MSA variant at
   72 and 128; SDPA beside it) and kernels 1
   and 10 at 256 units and 8 layers, and (``rest_kernel_holds``) kernel 8
   at E 72, 120 and 168, kernels 1 and 10 at 129, 256 and 1024 points a
   pillar and kernel 1 at two layers of 256 units (the layered route), the
   split decoder at C 96 over 8 heads, C 192 over 6 and C 96 over one;
9. ``[trainer]`` (``trainer_phase``): ``Trainer.fit`` at the widths of
   ``configs/training/semantic_kitti/02_train_smoke_tpu.yml`` (2 training
   and 1 validation batch, one epoch), the ``--test`` restore of
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
11. ``[data]`` (``data_phase``): SemanticKITTI, KITTI and converted Waymo
   trees written in the datasets' on-disk formats from the seed at real
   scale (``datasets/disk_trees.py``: ~120k points a scan, Waymo 150-190k
   x/y/z points a frame with 20-80 vehicles), the C++ host core against
   its numpy twins at 500x500 and 800x800 and the torch morphology on the
   card against the host core (bit for bit), host ms a sample (cache miss,
   hit, augmentations, KITTI's GT paste, Waymo with and without its
   augmentations), one epoch's batches with 0 and 4 worker processes
   (bitwise equal, batches/s), ``Trainer.fit`` on ``01_semantic_kitti.yml``,
   ``01_kitti.yml`` and ``01_waymo.yml`` as shipped (f32, batch 4, the
   shipped augmentations, 4 workers, Waymo with 170 queries; one cut epoch,
   then the ``--test`` restore of ``best``): step, validation,
   host-to-device and prefetch-wait times, peak memory, the card's idle
   share over the training steps, the launches of kernels A-C and 1-3,
   finite losses, changed parameters and no live worker process; after the
   Waymo fit the matcher (kernel C) on its first step's 170 x 170 problems
   against its plain version; then the CLI ``train_mask_bev_torch.py
   --train --test`` on the SemanticKITTI tree;
12. ``[eval]`` (``eval_phase``): the KITTI fit's validation predictions
   from the card through ``mask_to_boxes``, the official KITTI evaluation
   (bbox, bev, 3d) and its COCO sweep against the frames' labels, with
   their seconds; the official evaluation timed on a synthetic split at
   the full val split's scale (4071 frames, car class); the batched
   ``rotated_iou_matrix`` on the card against ``rotate_iou_eval`` on the
   host (4096 box pairs);
13. prints one JSON line with every kernel's numbers, then, last, the
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
TRAIN_WARM, TRAIN_TIMED = 1, 3
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


def queued_ms(torch, fn, reps: int) -> float:
    """Device time of the kernels ``fn`` launches, per call, without the
    host's time between calls: the ``reps`` calls are queued behind a sleep
    kernel that outlasts their launch, so the device runs them back to back
    between the two events. The sleep is doubled until the start event is
    still pending when the last call is queued (at most 6 tries; the last
    reading is kept). The profiler's CUDA kernel rows read 0 for some of
    these launches on the H100's machine."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    # SM cycles for twice the calls' wall time with the device's (an upper
    # bound of the host's), at most 2 GHz; at least 2 ms
    cycles = int(2e9 * max(2e-3, 2 * reps * (time.perf_counter() - t0)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(6):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            break
        cycles *= 2
    return start.elapsed_time(end) / reps


# the row walks held bit for bit: kernel 9 at (C, rows) and the Swin LN at
# C over 2048 on the .e384 stage 3's 2048 rows (8 x 16 x 16)
WALK_LN_CASES = ((12, 31752), (100, 31752), (2056, 3969), (3072, 3969),
                 (4096, 3969))
WALK_SWIN_CASES = ((2056, 2048), (3072, 2048), (4096, 2048))


def walk_inputs(torch, c: int, rows: int, f32: bool, dev="cuda"):
    """(x (rows, c), scale (c,), bias (c,)) of one row-walk case, drawn
    from a seed of its own (so its digest does not depend on what ran
    before), in bf16 or f32."""
    g = torch.Generator().manual_seed(9000 + 2 * c + int(f32))
    dt = torch.float32 if f32 else torch.bfloat16
    x = (0.5 + torch.randn(rows, c, generator=g)).to(dev, dt)
    w = (1 + 0.1 * torch.randn(c, generator=g)).to(dev, dt)
    b = (0.1 * torch.randn(c, generator=g)).to(dev, dt)
    return x, w, b


def digest(torch, *ts) -> str:
    """sha256 of the tensors' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


# the first 16 hex digits of the sha256 of each row walk's output on
# walk_inputs (walk_digests' keys), as the walk gave them before its
# redesign (csrc/common.cuh::row_walk, two passes over the row) on the H100
WALK_SHA256 = {
    ('ln', 12, False): "f39c536b612f2eef",
    ('ln', 12, True): "ac9752812e956b29",
    ('ln', 100, False): "bc8acd87ac01359a",
    ('ln', 100, True): "9d7eaf3d613ca328",
    ('ln', 2056, False): "65704cdf9218eedf",
    ('ln', 2056, True): "30b35af02e8d6f88",
    ('ln', 3072, False): "697341a35cfa2e7e",
    ('ln', 3072, True): "f9ef5385d2bafdca",
    ('ln', 4096, False): "216d5b30b3e138c4",
    ('ln', 4096, True): "d4c76671d12d5448",
    ('swin', 2056, False, False): "90c7a46d503ed56c",
    ('swin', 2056, False, True): "597c798ad4d1d0b8",
    ('swin', 2056, True, False): "5be0b83bdc150c09",
    ('swin', 2056, True, True): "5a68c1bb5d2d0487",
    ('swin', 3072, False, False): "6c5ce113783ed38c",
    ('swin', 3072, False, True): "8145e6f23e442ce9",
    ('swin', 3072, True, False): "8161029ef5728e42",
    ('swin', 3072, True, True): "27e07f8e86e1abb3",
    ('swin', 4096, False, False): "2e4ee943a5e14d1c",
    ('swin', 4096, False, True): "91afa67287273803",
    ('swin', 4096, True, False): "c64dbf1ae4899f45",
    ('swin', 4096, True, True): "7b73e3cc9dfa680a",
}


def walk_digests(torch, dev="cuda") -> dict:
    """The row walks' output digests (the first 16 hex digits of the
    sha256) on :func:`walk_inputs`: ``("ln", C, f32)`` kernel 9's output,
    ``("swin", C, f32, quant)`` the Swin LN's output (``quant`` False) or
    its int8 rows and scales (True), for the port this process
    imported."""
    from mask_bev_tpu_torch.ops import layer_norm as kln
    from mask_bev_tpu_torch.ops import swin_block as kswin

    out = {}
    with torch.no_grad():
        for c, rows in WALK_LN_CASES:
            for f32 in (False, True):
                x, w, b = walk_inputs(torch, c, rows, f32, dev)
                out[("ln", c, f32)] = digest(
                    torch, kln.layer_norm(x, w, b))[:16]
        for c, rows in WALK_SWIN_CASES:
            for f32 in (False, True):
                x, w, b = walk_inputs(torch, c, rows, f32, dev)
                for quant in (False, True):
                    got = kswin._ln(x, w, b, quant)
                    out[("swin", c, f32, quant)] = digest(
                        torch, *(got if quant else (got,)))[:16]
    return out


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


def scans_long(np, batch: int, n: int, seed: int):
    """``scans`` with long pillars, as the ground near the sensor gives
    them: in each scan 6000 of the ~120k real points move into four dense
    patches 2-5 m from the sensor, 1500 points over 0.4 m x 0.4 m each (a
    few 0.16 m cells of ~100-250 points), 4000 into four of 1000 over
    1.2 m x 1.2 m (~18 a cell), and 4000 into one patch over 0.1 m x 0.1 m
    (one to four cells of ~1000-4000: a pole or a wall at the sensor); so
    some pillars hold 33 to K kept points and many hold more than K (cut
    to their first K), some more than 1024."""
    pts, mask = scans(np, batch, n, seed)
    rng = np.random.default_rng(seed + 1000)
    i = 0
    for size, side in ((1500, 0.4), (1500, 0.4), (1500, 0.4), (1500, 0.4),
                       (1000, 1.2), (1000, 1.2), (1000, 1.2), (1000, 1.2),
                       (4000, 0.1)):
        r = rng.uniform(2, 5, batch)
        th = rng.uniform(-np.pi, np.pi, batch)
        for b in range(batch):
            pts[b, i:i + size, 0] = r[b] * np.cos(th[b]) + rng.uniform(
                0, side, size)
            pts[b, i:i + size, 1] = r[b] * np.sin(th[b]) + rng.uniform(
                0, side, size)
        i += size
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
        from mask_bev_tpu_torch.kernels import build as kb
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
        lines = log.read_text().splitlines()
        regs = [ln.strip() for ln in lines
                if "registers" in ln or "spill" in ln]
        took = [ln for ln in lines if ln.startswith("compiled in")]
        print(f"[ptxas {log.stem}] {took[-1] if took else ''}: "
              + " | ".join(regs[-6:]), flush=True)

    results = {}
    failures = []

    def record(name, source, replaces, err, tol, ms, plain_ms, bnd, extra="",
               ok=None, library_ms=None, **keys):
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
            library_ms=None if library_ms is None else float(library_ms),
            **{k: float(v) for k, v in keys.items()})

    def timed(label, fn, *args, **kw):
        """Run one phase and print its seconds."""
        t1 = time.time()
        fn(np, torch, card, *args, **kw)
        print(f"[{label}] the phase took {time.time() - t1:.1f} s [{card}]",
              flush=True)

    serving = (results, failures, record)
    # ---- the main path: the bf16 serving path, kernels 1-5 ----------------
    cfg = semantic_kitti_default().replace(
        max_points_per_scan=131072, pseudo_image_norm="full",
        compute_dtype="bfloat16")
    timed("e2e", serve_phase, *serving, cfg, "", WARM, TIMED, main_path=True)

    # ---- small model: the card against the plain CPU path -----------------
    small = tiny_test_config().replace(
        head_num_attn_heads=2, compute_dtype="bfloat16",
        backbone_quantize="int8")
    small_phase(np, torch, failures, "small", small)
    # every option on: height head, absolute embedding with swap_dims, two
    # refinement blocks a level (C 128 over their 8 heads: kernel 7 takes
    # head widths 16, 32 and 64) and the Fourier encoding; without int8,
    # whose rounding steps would pass small differences on to the heads
    # (the int8 backbone with the options is phase O's)
    for dtype in ("float32", "bfloat16"):
        small_phase(np, torch, failures, f"small options {dtype}",
                    small.replace(**OPTIONS, encoder_encoding_type="fourier",
                                  head_feat_channels=128,
                                  head_out_channels=128,
                                  head_num_attn_heads=4,
                                  backbone_quantize="none",
                                  compute_dtype=dtype))

    timed("path K", path_phase, *serving, "K")
    timed("path E", path_phase, *serving, "E")
    # kernels 7-10 at f32: the same paths in the shipped dtype
    timed("path K f32", path_phase, *serving, "K", f32=True)
    timed("path E f32", path_phase, *serving, "E", f32=True)
    # phase F: the shipped flagship configuration (f32, int8 backbone)
    timed("e2e f32", serve_phase, *serving,
          semantic_kitti_default().replace(max_points_per_scan=131072),
          ".f32", PATH_WARM, PATH_TIMED)
    # phase W: Waymo as shipped (f32, 170 queries, 3 point columns)
    timed("e2e waymo", serve_phase, *serving,
          waymo_default().replace(max_points_per_scan=131072), ".waymo",
          PATH_WARM, PATH_TIMED)
    # phase O: the model options on the main path's configuration
    options = cfg.replace(**OPTIONS)
    timed("e2e options", serve_phase, *serving, options, ".options",
          PATH_WARM, PATH_TIMED)
    timed("train options", options_train_phase, failures, options)
    timed("e2e encodings", encodings_phase, *serving, cfg)
    timed("train", train_phase, *serving)
    timed("shapes", shapes_phase, failures)
    timed("shapes wide", shapes_wide_phase, *serving)
    timed("shapes tail", shapes_tail_phase, *serving)
    timed("shapes audit", shapes_audit_phase, *serving)
    timed("shapes last", shapes_last_phase, *serving)
    timed("trainer", trainer_phase, failures, here)
    timed("resume", resume_phase, failures, here)
    timed("data", data_phase, failures, here)
    timed("ddp", ddp_phase, failures, here)
    timed("ddp nccl", ddp_nccl_phase, failures, here)
    timed("modules", modules_phase, failures)

    print(f"chip_smoke: all phases took {time.time() - t0:.1f} s, the "
          f"build included [{card}]", flush=True)
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    if failures:
        fail("; ".join(failures))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


# phase O and the options of ``[small options]``: the height head, the
# absolute position embedding with swap_dims, two refinement blocks a
# pixel-decoder level
OPTIONS = dict(predict_height=True, backbone_use_abs_emb=True,
               backbone_swap_dims=True, pixel_decoder_num_attn_layers=2)
# ``[small options]``: the card's final height logits against the CPU's,
# the largest difference over the CPU logits' largest magnitude (set from
# the readings of ``scripts/small_options_tolerance.py``)
HEIGHT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# the encodings phase: each variant on the main path's configuration
ENCODINGS = (("fourier", dict(encoder_encoding_type="fourier")),
             ("cosine", dict(encoder_encoding_type="cosine")),
             ("point_dim5", dict(pc_point_dim=5)))


def small_phase(np, torch, failures, label, small) -> None:
    """A small model on the card against the same model run by the plain
    PyTorch path on the CPU (same weights and scans): class probabilities
    to 0.1, mean mask probability to 0.02 and, with the height head, the
    final height logits: their largest difference over the CPU logits'
    largest magnitude to ``HEIGHT_TOL`` of the dtype; every launch counted
    on the card."""
    from mask_bev_tpu_torch.inference import MaskBevPredictor
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.models.maskbev import MaskBev

    ssd = MaskBev(small).random_state_dict(SEED + 1)
    sp, sm = scans(np, 2, small.max_points_per_scan, SEED + 2)
    sp[..., :2] *= 0.25  # into the 20 m grid
    sm[:, 1800:] = False
    sp, sm = torch.as_tensor(sp[..., :small.pc_point_dim]), torch.as_tensor(sm)
    out = {}
    for dev in ("cuda", "cpu"):
        pred = MaskBevPredictor(small, ssd, device=dev)
        kb.reset_launches()
        c_, m_ = pred.forward(sp, sm)
        h_ = None
        if small.predict_height:
            with torch.no_grad():
                h_ = pred.model(
                    sp.to(pred.device, pred.dtype), sm.to(pred.device)
                ).height_logits[-1].float().cpu()
        out[dev] = (c_.cpu(), m_.cpu(), h_, dict(kb.LAUNCHES))
    (c_gpu, m_gpu, h_gpu, launched), (c_cpu, m_cpu, h_cpu, _) = (
        out["cuda"], out["cpu"])
    d_cls = float((c_gpu - c_cpu).abs().max())
    d_mask = float((m_gpu - m_cpu).abs().mean())
    ok = d_cls <= 0.1 and d_mask <= 0.02
    height = ""
    if h_gpu is not None:
        h_tol = HEIGHT_TOL[small.compute_dtype]
        d_h = float((h_gpu - h_cpu).abs().max() / h_cpu.abs().max())
        d_hm = float((h_gpu - h_cpu).abs().mean() / h_cpu.abs().mean())
        ok = ok and d_h <= h_tol
        height = (f", height logits max diff {d_h:.4g} of their largest "
                  f"magnitude {float(h_cpu.abs().max()):.4g} (tolerance "
                  f"{h_tol}), mean diff {d_hm:.4g} of their mean magnitude")
    print(f"[{label}] card vs CPU plain path: class probs max diff "
          f"{d_cls:.4g} (tolerance 0.1), mask probs mean diff {d_mask:.4g} "
          f"(tolerance 0.02){height}; card launches {launched} -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(f"[{label}] card vs CPU")
    if small.pixel_decoder_num_attn_layers and not launched.get("window_msa"):
        failures.append(f"[{label}] kernel 7 never launched")
    torch.cuda.empty_cache()


def options_train_phase(np, torch, card, failures, cfg) -> None:
    """Phase O's training step: the options' configuration with the
    training envelope of ``train_phase`` (batch 4, ``max_num_pillars``
    32768, bf16 over f32 masters), synthetic batches with GT heights: one
    step, then 2 timed steps; the loss terms (``loss_height`` among them),
    finite gradients through the height head, the absolute embedding and
    the refinement blocks, every head pass's height logits, peak memory,
    and the training kernels' launches."""
    from mask_bev_tpu_torch.datasets.synthetic import make_batch
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.train.step import (
        create_train_state, loss_and_grads, train_step)

    cfg = cfg.replace(max_num_pillars=32768, batch_size=TRAIN_BATCH)
    t0 = time.time()
    state = create_train_state(cfg, seed=SEED + 40, device="cuda")
    batches = [make_batch(np.random.default_rng(400 + i), cfg,
                          batch_size=TRAIN_BATCH, noise_points=115_000,
                          points_per_instance=1500) for i in range(2)]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    logs, out, grads = loss_and_grads(state, batches[0], gen)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    watch = ("decoder.heads.height_embed.weight",
             "backbone.absolute_pos_embed",
             "pixel_decoder.refine3_1.attn.w_msa.qkv.weight")
    norms = {k: float(grads[k].float().norm()) for k in watch}
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    if bad or not all(v > 0 for v in norms.values()):
        failures.append(f"[train options] gradients: non-finite {bad[:5]}, "
                        f"norms {norms}")
    exp_h = (cfg.num_decoder_outputs, TRAIN_BATCH, cfg.num_queries,
             cfg.head_num_height_bins)
    if out.height_logits is None or tuple(out.height_logits.shape) != exp_h:
        failures.append(f"[train options] height logits "
                        f"{None if out.height_logits is None else tuple(out.height_logits.shape)}")
    del grads
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    times = []
    for i in range(2):
        t1 = time.perf_counter()
        state, logs, _ = train_step(state, batches[i % 2], gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches = dict(kb.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    terms = {k: round(float(v), 4) for k, v in logs.items()
             if k.startswith("loss") and not k.endswith("_layers")}
    print(f"[train options] {cfg.name} with the options, batch "
          f"{TRAIN_BATCH}: state and first forward+backward {first_s:.1f} "
          f"s; 2 timed steps {[round(t * 1e3, 3) for t in times]} ms; loss "
          f"terms {terms}; gradient norms {norms}; peak memory "
          f"{peak_gb:.2f} GiB [{card}]", flush=True)
    print(f"[train options] launches over the 2 timed steps: {launches}",
          flush=True)
    if "loss_height" not in terms or not np.isfinite(
            list(terms.values())).all() or terms["loss_height"] <= 0:
        failures.append(f"[train options] loss terms {terms}")
    for k in ("canvas_scatter", "canvas_scatter_bwd", "hungarian"):
        if launches.get(k, 0) <= 0:
            failures.append(f"{k} never launched in [train options]")
    del state, batches, out, logs
    torch.cuda.empty_cache()


def encodings_phase(np, torch, card, results, failures, record,
                    base) -> None:
    """The encodings phase: ``base`` (the main path's configuration) with
    the Fourier encoding, the cosine encoding, and a fifth point column
    (drawn from the seed). The kernels take only the vanilla decoration of
    at most 4 columns, so the eval encoder runs the capped stream with the
    plain pillar feature net, as the JAX package runs its XLA stream PFN
    there; kernel 2 then reads that table. For each: kernel 2 captured in
    one forward and held against its plain version
    (``canvas_norm.<variant>``), the plain PFN timed alone, one warm and
    one timed request with the counters reset just before: kernels 1 and
    10 must not launch, kernels 2-5 must."""
    from mask_bev_tpu_torch.inference import MaskBevPredictor
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.models import encoder as menc
    from mask_bev_tpu_torch.models.maskbev import MaskBev
    from mask_bev_tpu_torch.ops import canvas as kcanvas
    from mask_bev_tpu_torch.ops.stream_pillars import pillarize_stream

    for name, kw in ENCODINGS:
        cfg = base.replace(**kw)
        d = cfg.pc_point_dim
        pred = MaskBevPredictor(cfg, MaskBev(cfg).random_state_dict(
            SEED + 30), device="cuda")
        enc = pred.model.encoder
        staged = []
        for s in range(2):
            p_np, m_np = scans(np, BATCH, cfg.max_points_per_scan, 500 + s)
            extra = np.random.default_rng(600 + s).uniform(
                0, 1, p_np.shape[:2] + (max(d - 4, 0),)).astype(np.float32)
            p_np = np.concatenate([p_np, extra], -1)[..., :d]
            staged.append((torch.as_tensor(p_np).cuda().to(pred.dtype),
                           torch.as_tensor(m_np).cuda()))
        pts, msk = staged[0]
        cap = []
        orig = menc.canvas_norm

        def rec_canvas(*a):
            cap.append(tuple(t.clone() if torch.is_tensor(t) else t
                             for t in a))
            return orig(*a)

        menc.canvas_norm = rec_canvas
        try:
            with torch.no_grad():
                pred.model(pts, msk)
        finally:
            menc.canvas_norm = orig
        with torch.no_grad():
            canvas_phase(torch, kcanvas, lambda n, *r, **k: record(
                n, *SOURCES["canvas_norm"], *r, **k),
                f"canvas_norm.{name}", cap[0])
            sp = pillarize_stream(
                pts, msk, x_range=enc.x_range, y_range=enc.y_range,
                z_range=enc.z_range, voxel_size=enc.voxel_size,
                max_points_per_pillar=enc.k, max_pillars=enc.max_pillars)
            ms_pfn = cuda_ms(torch, lambda: enc.plain_table(sp), 3)
            ms_capped = cuda_ms(torch, lambda: enc.capped_table(pts, msk), 3)
        occupied = sp.valid.sum(1).tolist()
        del cap, sp
        torch.cuda.synchronize()
        kb.reset_launches()
        pred.forward(*staged[1])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cls_p, mask_p = pred.forward(*staged[0])
        torch.cuda.synchronize()
        ms_req = (time.perf_counter() - t1) * 1e3
        launches = dict(kb.LAUNCHES)
        results[f"canvas_norm.{name}"]["launches"] = launches.get(
            "canvas_norm", 0)
        print(f"[e2e encodings] {name} ({d} point columns, "
              f"{cfg.compute_dtype}, int8 backbone): one request of batch "
              f"{BATCH} {ms_req:.3f} ms; the plain pillar feature net alone "
              f"{ms_pfn:.3f} ms, with the capped stream's pillarize "
              f"{ms_capped:.3f} ms; occupied slots {occupied} of "
              f"{cfg.max_num_pillars}; launches over 2 requests "
              f"{launches} [{card}]", flush=True)
        for k in ("pfn", "stream_pfn"):
            if launches.get(k, 0):
                failures.append(f"[e2e encodings] {name}: {k} launched "
                                f"{launches[k]} times")
        for k in ("canvas_norm", "swin_block", "decoder_stack"):
            if launches.get(k, 0) <= 0:
                failures.append(f"[e2e encodings] {name}: {k} never "
                                f"launched")
        if not (torch.isfinite(cls_p).all() and torch.isfinite(mask_p).all()):
            failures.append(f"[e2e encodings] {name}: non-finite outputs")
        del pred, staged, pts, msk, cls_p, mask_p
        torch.cuda.empty_cache()


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
                warm, timed, main_path=False, points=scans):
    """One serving configuration at full width through ``MaskBevPredictor``
    at batch 8: the inputs of kernels 1-5 captured in one forward and held
    against their plain versions in the configuration's dtype, then
    ``warm`` + ``timed`` requests with the launch counters reset just
    before and read just after, then one traced request. The main path
    (bf16) also times the Swin chain's launches by kind and prints the
    decoder's cluster occupancy; the f32 phases check the instance
    counters, which must show the f32 instances. Phase O (``.options``:
    the height head, the absolute embedding with ``swap_dims`` and two
    refinement blocks a pixel-decoder level) also captures kernel 7's
    inputs at the refinement blocks (``window_msa_phase``, recorded as
    ``window_msa.refine``), checks the height logits, and counts kernel
    7's launches over the requests. The ``[shapes wide]`` rows (suffixes
    ``.swin_t``, ``.w12``, ``.k100``, ``.q300``, ``.q300.f32``) also hold
    kernel 8 where the configuration fuses the patch embed and count the
    pillars over 32 kept points; ``points`` draws the scans."""
    from mask_bev_tpu_torch.inference import MaskBevPredictor
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.models import mask2former as m2f
    from mask_bev_tpu_torch.models import swin as msw
    from mask_bev_tpu_torch.models.maskbev import MaskBev
    from mask_bev_tpu_torch.ops import canvas as kcanvas
    from mask_bev_tpu_torch.ops import decoder_stack as kdec
    from mask_bev_tpu_torch.ops import pfn as kpfn
    from mask_bev_tpu_torch.ops import swin_block as kswin

    label = "e2e" + suffix.replace(".", " ")
    refine = cfg.pixel_decoder_num_attn_layers > 0
    f32 = cfg.compute_dtype == "float32"
    esz = 4 if f32 else 2
    work = "f32" if f32 else "bf16"  # the products' type, off the int8 GEMM
    prod = "tf32x3" if f32 else "bf16"  # the tensor cores' route for them
    t0 = time.time()
    sd = MaskBev(cfg).random_state_dict(SEED + (0 if main_path else 20))
    pred = MaskBevPredictor(cfg, sd, device="cuda")
    model = pred.model
    dcol = cfg.pc_point_dim
    pts_np, mask_np = points(np, BATCH, cfg.max_points_per_scan, SEED)
    pts = torch.as_tensor(pts_np[..., :dcol]).cuda().to(pred.dtype)
    msk = torch.as_tensor(mask_np).cuda()

    # ---- capture every kernel's inputs (one forward) ----------------------
    captured_blocks, captured_dec, captured_msa = [], [], []
    captured_pe = []
    orig_block, orig_dec = msw.swin_block, m2f.decoder_stack
    orig_msa, orig_pe = msw.window_msa, msw.patch_embed

    def rec_block(x, *args):
        captured_blocks.append((x.clone(), *args))
        return orig_block(x, *args)

    def rec_dec(*args, **kw):
        captured_dec.append((args, kw))
        return orig_dec(*args, **kw)

    def rec_msa(*a, **kw):
        captured_msa.append((tuple(t.clone() if torch.is_tensor(t) else t
                                   for t in a), kw))
        return orig_msa(*a, **kw)

    def rec_pe(*a, **kw):
        captured_pe.append((a, kw))
        return orig_pe(*a, **kw)

    msw.swin_block, m2f.decoder_stack, msw.window_msa = (rec_block, rec_dec,
                                                         rec_msa)
    msw.patch_embed = rec_pe
    try:
        with torch.no_grad():
            enc = model.encoder
            ps, table, stats = enc.pillar_table(pts, msk)
            fwd = model(pts, msk)
    finally:
        msw.swin_block, m2f.decoder_stack, msw.window_msa = (
            orig_block, orig_dec, orig_msa)
        msw.patch_embed = orig_pe
    if cfg.predict_height:
        hl = fwd.height_logits
        exp_h = (1, BATCH, cfg.num_queries, cfg.head_num_height_bins)
        ok_h = (hl is not None and tuple(hl.shape) == exp_h
                and bool(torch.isfinite(hl).all()))
        print(f"[{label}] height logits "
              f"{None if hl is None else tuple(hl.shape)} (expected "
              f"{exp_h}), finite: {ok_h}", flush=True)
        if not ok_h:
            failures.append(f"[{label}] height logits")
    if refine and len(captured_msa) != 3 * cfg.pixel_decoder_num_attn_layers:
        failures.append(f"[{label}] {len(captured_msa)} refinement window "
                        f"MSA calls in one forward")
    del fwd
    torch.cuda.synchronize()
    print(f"[{label}] {cfg.name} ({cfg.compute_dtype}, int8 backbone: "
          f"{cfg.backbone_quantize == 'int8'}, {cfg.num_queries} queries, "
          f"{dcol} point columns): captured {len(captured_blocks)} blocks "
          f"in {time.time() - t0:.1f} s [{card}]", flush=True)
    if enc.k > 32:
        n_long = int((ps.counts > 32).sum())
        print(f"[{label}] pillars with more than 32 kept points: {n_long} "
              f"(at most {enc.k} kept a pillar; "
              f"{int((ps.counts == enc.k).sum())} pillars cut to {enc.k}) "
              f"of {int(ps.num_pillars.sum())} [{card}]", flush=True)
        if n_long <= 0:
            failures.append(f"[{label}] no pillar over 32 kept points")
    if model.flat_embed_ok(False) and len(captured_pe) != 1:
        failures.append(f"[{label}] {len(captured_pe)} patch embed calls")

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
        quant = block_hold(torch, kswin, rec, captured_blocks, f32)
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
        decoder_hold(torch, record, failures, card, dargs, dkw, f32, suffix,
                     label, main_path)
        if refine:
            # ---- kernel 7 at the refinement blocks (C 256, 8 heads) -----
            window_msa_phase(torch, record, card, ".refine", captured_msa,
                             f32, what="refinement blocks")
        held_pe = bool(captured_pe)
        if held_pe:
            # ---- kernel 8: the fused patch embed + patch_norm ------------
            (a, kw), = captured_pe
            patch_embed_hold(torch, record, suffix, a, kw, f32)
    del captured_blocks, captured_dec, captured_msa, table, ps, dargs
    del captured_pe

    # ---- serve requests through the predictor -----------------------------
    staged = []
    for s in range(4):
        p_np, m_np = points(np, BATCH, cfg.max_points_per_scan, 100 + s)
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
    if held_pe:
        results["patch_embed" + suffix]["launches"] = launches.get(
            "patch_embed", 0)
        if launches.get("patch_embed", 0) <= 0:
            failures.append(f"patch_embed never launched on [{label}]")
    attn_inst = "swin_block/" + kswin.attn_instance(
        f32, cfg.backbone_window_size,
        cfg.backbone_embed_dim // cfg.backbone_num_heads[0])
    results["swin_attn" + suffix]["launches"] = instances.get(attn_inst, 0)
    if instances.get(attn_inst, 0) <= 0:
        failures.append(f"{attn_inst} never launched on [{label}]")
    if refine:
        msa_inst = "window_msa/attn_" + ("f32" if f32 else "bf16")
        results["window_msa.refine"]["launches"] = launches.get(
            "window_msa", 0)
        results["window_msa_attn.refine"]["launches"] = instances.get(
            msa_inst, 0)
        print(f"[{label}] kernel 7 at the refinement blocks: "
              f"{launches.get('window_msa', 0)} launches over {requests} "
              f"requests ({launches.get('window_msa', 0) // requests} a "
              f"forward), {instances.get(msa_inst, 0)} of them "
              f"{msa_inst}", flush=True)
        if instances.get(msa_inst, 0) <= 0:
            failures.append(f"{msa_inst} never launched on [{label}]")
    if f32:
        need = ["pfn/" + kpfn.instance(True, enc.k), "canvas_norm/f32",
                "swin_block/f32", "decoder_stack/" + kdec.split_instance(
                    cfg.num_queries, cfg.head_num_attn_heads, True),
                "decoder_stack/gemm_f32_3xtf32",
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


def block_hold(torch, kswin, rec, blocks, f32) -> bool:
    """Kernels 3/4 on every captured block's inputs (x, weights, grid,
    window, heads, shift, quant) against the plain block, both timed and
    summed; recorded through ``rec("swin_block", ...)``. Returns whether
    the blocks are int8."""
    esz = 4 if f32 else 2
    work = "f32" if f32 else "bf16"
    prod = "tf32x3" if f32 else "bf16"
    err_abs, err_rel, ms_k, ms_p, b_ops, b_bytes, fma_ops = (0.0,) * 7
    quant = False
    for (x, p, hw, win, heads, shift, quant) in blocks:
        a = (x, p, hw, win, heads, shift, quant)
        got = kswin.swin_block(*a)
        want = kswin.swin_block_plain(*a)
        e = float((got.float() - want.float()).abs().max())
        err_abs = max(err_abs, e)
        err_rel = max(err_rel, e / float(want.float().abs().max()))
        del got, want
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
        f"(tolerance {blk_tol}); {len(blocks)} blocks summed; "
        f"widths {sorted({x.shape[-1] for x, *_ in blocks})}; "
        f"bound with every product as f32 FMAs "
        f"{bound(b_bytes, fma_ops)[0]:.4f} ms",
        ok=err_rel <= blk_tol)
    return quant


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


def decoder_hold(torch, record, failures, card, dargs, dkw, f32, suffix,
                 label, main_path=False) -> None:
    """Kernel 5 on one call's arguments (``dargs``, ``dkw``): its
    ``m < 0`` decisions against the plain version's (at most 5 % of a
    layer's entries differ free-running; on the kernel's own decisions at
    most 1 % stray beyond rounding, ``kdec.decision_flips``: a decision
    outside its logit's rounding band, a row whose every-key-blocked rule
    turns over counted once), its output on its own decisions (bf16 2e-2, f32 1e-3 of the
    largest value) and against the plain version (5e-2), both timed;
    recorded as ``decoder_stack{suffix}``. The main path also prints the
    clusters the card holds, the f32 calls the split instance's time by
    part."""
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.ops import decoder_stack as kdec

    esz = 4 if f32 else 2
    work = "f32" if f32 else "bf16"
    prod = "tf32x3" if f32 else "bf16"
    kb.reset_launches()
    out_k, kbits = kdec.decoder_stack(*dargs, **dkw, return_bits=True)
    instance = [k for k in kb.INSTANCES if k.startswith("decoder_stack/")
                and "gemm" not in k]
    out_p, plogits = kdec.decoder_stack_plain(
        *dargs[:8], num_heads=dkw["num_heads"], return_logits=True)
    flips = [int((kb_ != kdec.blocked_positions(m)).sum())
             for kb_, m in zip(kbits, plogits)]
    total = sum(m.numel() for m in plogits)
    err = float((out_k.float() - out_p.float()).abs().max())
    scale = float(out_p.float().abs().max())
    same, same_logits, bands = kdec.decoder_stack_plain(
        *dargs[:8], num_heads=dkw["num_heads"], blocked=kbits,
        return_logits=True, return_bands=True)
    err_same = float((out_k.float() - same.float()).abs().max())
    same_tol = (1e-3 if f32 else 2e-2) * scale
    if err_same > same_tol:
        failures.append(f"decoder_stack{suffix} on its own blocked "
                        "positions")
    # given the kernel's decisions, the plain version's own logits (its
    # decoder norm and mask MLP) may decide otherwise only within
    # rounding of 0; free-running flips compound, bounded more loosely
    own = kdec.decision_flips(kbits, same_logits, bands)
    own_all = [int((kb_ != kdec.blocked_positions(m)).sum())
               for kb_, m in zip(kbits, same_logits)]
    for li, m in enumerate(plogits):
        if flips[li] > 0.05 * m.numel() or own[li] > 0.01 * m.numel():
            failures.append(f"decoder_stack{suffix} bias flips in layer "
                            f"{li}")
    ms_k = cuda_ms(torch, lambda: kdec.decoder_stack(*dargs, **dkw), 5)
    ms_p = cuda_ms(torch, lambda: kdec.decoder_stack_plain(
        *dargs[:8], num_heads=dkw["num_heads"]), 2)
    q_ = dargs[0].shape[1]
    ops, byts = decoder_work(dargs, esz)
    if main_path:
        decoder_clusters(kb, kdec, dargs, card)
    if f32:
        split_breakdown(torch, kdec, dargs, dkw, card, label)
    record("decoder_stack" + suffix, *SOURCES["decoder_stack"], err,
           5e-2 * scale, ms_k, ms_p, bound(byts, ops / PEAK[prod]),
           f"instance {instance}, Q={q_}, heads {dkw['num_heads']}; bias "
           f"entries that differ: {sum(flips)} of {total}, per layer "
           f"{flips} (tolerance 5 % a layer), on the kernel's own decisions "
           f"{own_all}, of which beyond rounding (a turned-over row once) "
           f"{own} (tolerance 1 % a layer); max_abs_err on the kernel's own "
           f"blocked positions {err_same:.6g} (tolerance {same_tol:.6g}); "
           f"bound as {work} FMAs {bound(byts, ops / PEAK[work])[0]:.4f} ms")


def decoder_work(dargs, esz):
    """(operations, bytes) of a decoder-stack call on ``dargs``: the
    query-side products of every layer (8 C x C products and the mask
    MLP's last, C x D, the FFN, the mask bits over D and cross-attention
    over the level's keys, self-attention) and the k and v projections of
    the levels; the levels' memories, features and k/v read once, the
    weights once (the mask MLP's too), the output written once."""
    layers = dargs[6]
    b_, q_, c_ = dargs[0].shape
    d_ = dargs[1].shape[-1]  # the mask embedding's width
    ts = [m.shape[1] for m in dargs[3]]
    f_ = layers[0].f1.shape[1]
    n_l = len(layers)
    ops = 0.0
    for li in range(n_l):
        t_ = ts[li % len(ts)]
        ops += b_ * (2 * q_ * c_ * (8 * c_ + d_) + 4 * q_ * c_ * f_
                     + 2 * q_ * t_ * d_ + 4 * q_ * t_ * c_
                     + 4 * q_ * q_ * c_)
    ops += 2 * 2 * b_ * sum(ts) * c_ * c_ * (n_l // len(ts))
    byts = (b_ * sum(ts) * (c_ * esz + d_ * 4) + sum(ts) * c_ * esz
            + n_l * (8 * c_ * c_ + 2 * c_ * f_) * esz
            + c_ * (2 * c_ + d_) * esz + b_ * q_ * c_ * esz)
    return ops, byts


def split_breakdown(torch, kdec, dargs, dkw, card, label, reps=3):
    """Where the decoder's split instance spends its time, per part of a
    layer (``kdec.SPLIT_PARTS``): each block adds the ns of %globaltimer
    between the part's boundaries, summed over the layers; printed as the
    mean over the blocks of ``reps`` runs, in ms and as a share."""
    b = dargs[0].shape[0]
    cs = kdec.split_cluster(dargs[0].shape[1])
    prof = torch.zeros((b * cs, len(kdec.SPLIT_PARTS)),
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
          f"of the {b * cs} blocks: {parts}; all layers "
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
               f32: bool = False, overrides=None, tag: str = "",
               points=scans, requests=None, blocks=False):
    """Path K (KITTI, unfused backbone: kernels 7 and 8 with the PFN, the
    canvas and the decoder stack) or path E (the capped eval encoder with
    the fused token LN: kernels 10 and 9 with the canvas, the Swin blocks
    and the decoder stack) at full width: inputs of the path's new kernels
    captured in one forward and held against their plain versions, then 3
    warm and 5 timed requests with the launch counters reset just before.
    ``f32``: the path in f32 (every kernel's f32 instance), 1 warm and 2
    timed requests, no trace. ``overrides`` change the configuration (the
    ``[shapes wide]`` rows: window 12, 100 points a pillar), recorded
    under the suffix ``tag``; ``points`` draws the scans; ``requests``:
    (warm, timed) in place of the defaults; ``blocks`` (path E): the Swin
    blocks' inputs captured and held too (``block_hold``)."""
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

    dtype = "float32" if f32 else "bfloat16"
    sfx = tag + (".f32" if f32 else "")
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
        names = ("layer_norm", "stream_pfn") + (
            ("swin_block",) if blocks else ())
        path_kernels = ("canvas_norm", "decoder_stack") + names + (
            () if blocks else ("swin_block",))
    cfg = cfg.replace(**(overrides or {}))
    label = f"path {path}" + sfx.replace(".", " ")
    t0 = time.time()
    pred = MaskBevPredictor(cfg, MaskBev(cfg).random_state_dict(SEED + 10),
                            device="cuda")
    model = pred.model
    if path == "E":
        model.backbone.fuse_ln = True  # as the JAX SwinTransformer attribute
    pts_np, mask_np = points(np, BATCH, cfg.max_points_per_scan, SEED + 11)
    pts = torch.as_tensor(pts_np).cuda().to(pred.dtype)
    msk = torch.as_tensor(mask_np).cuda()

    # ---- capture the new kernels' inputs in one forward -------------------
    cap = {n: [] for n in names}
    orig = {"window_msa": (msw, msw.window_msa),
            "patch_embed": (msw, msw.patch_embed),
            "layer_norm": (msw, msw.layer_norm),
            "stream_pfn": (menc, menc.stream_pfn),
            "canvas_norm": (menc, menc.canvas_norm),
            "swin_block": (msw, msw.swin_block)}
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
            window_msa_phase(torch, record, card, sfx, cap["window_msa"],
                             f32)
            # ---- kernel 8: patch embed + patch_norm --------------------------
            (a, kw), = cap["patch_embed"]
            patch_embed_hold(torch, record, sfx, a, kw, f32)
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
                dev_k += queued_ms(torch, run_k, 20)
                dev_l += queued_ms(torch, run_l, 20)
                byts += 2 * x_.numel() * esz
                plans.append(kln.plan(x_.shape[-1], f32))
            record("layer_norm" + sfx, "mask_bev_tpu_torch/csrc/layer_norm.cu",
                   "mask_bev_tpu/ops/pallas_layer_norm.py:33", err,
                   (1e-4 if f32 else 1e-2) * scale, ms_k, ms_p,
                   bound(byts, 0.0),
                   f"{len(cap['layer_norm'])} calls summed: "
                   f"{[tuple(a[0].shape) for a, _ in cap['layer_norm']]}, "
                   f"(lanes, words, tokens) {plans}; device time (calls "
                   f"queued, no host): kernel {dev_k:.4f} ms, F.layer_norm "
                   f"{dev_l:.4f} ms (kernel and library above: CUDA events "
                   f"over back-to-back calls, host included)",
                   library_ms=ms_l, device_ms=dev_k,
                   library_device_ms=dev_l)
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
            if kw["k"] > 32:
                from mask_bev_tpu_torch.ops.stream_pillars import kept_counts

                n_long = int((kept_counts(sp.pid, sp.kept, p_) > 32).sum())
                extra += (f"; slots with more than 32 kept points {n_long} "
                          f"(at most {kw['k']})")
                if n_long <= 0:
                    failures.append(f"[{label}] no slot over 32 kept points")
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
            if blocks:
                # ---- kernels 3/4 at the path's widths ---------------------
                block_hold(torch, kswin, lambda n, *r, **k: record(
                    n + sfx, *SOURCES[n], *r, **k),
                    [a for a, _ in cap["swin_block"]], f32)
    del cap

    # ---- the path: warm and timed requests ---------------------------------
    staged = []
    for s in range(4):
        p_np, m_np = points(np, BATCH, cfg.max_points_per_scan, 300 + s)
        staged.append((torch.as_tensor(p_np).cuda(),
                       torch.as_tensor(m_np).cuda()))
    n_warm, n_timed = requests or ((1, 2) if f32 else (PATH_WARM,
                                                       PATH_TIMED))
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
        attn_inst = "window_msa/" + kswin.attn_instance(
            f32, cfg.backbone_window_size)
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


def patch_embed_hold(torch, record, sfx, a, kw, f32) -> None:
    """Kernel 8 on one captured call's arguments (``a``, ``kw``): held
    against its plain version (bf16 1e-2 of the largest value) or, in f32,
    against a float64 product + LN (1e-5), both timed, with ``F.conv2d``
    alone on the same channels-last canvas beside it as a yardstick for
    the product (not the same function: no LayerNorm); recorded as
    ``patch_embed{sfx}``."""
    import torch.nn.functional as F

    from mask_bev_tpu_torch.ops import patch_embed as kpe

    esz = 4 if f32 else 2
    work = "f32" if f32 else "bf16"
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
           "mask_bev_tpu_torch/csrc/patch_embed.cuh",
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


def window_msa_phase(torch, record, card, sfx, captured, f32,
                     what="blocks") -> None:
    """Kernel 7 on each captured call's inputs (``window_msa``'s arguments
    from a forward): the chain held against ``window_msa_grid_plain``
    (bf16 2e-2, f32 1e-3 of the block's largest value) and recorded as
    ``window_msa{sfx}``, then its attention alone with the SDPA yardstick
    (``attn_phase``) as ``window_msa_attn{sfx}``. Bound: the tokens read
    and written once and the qkv and projection weights read once, against
    the products (4 C^2 a token) and the attention (4 n C a token: the
    window's n tokens, padding included, as keys, the real tokens alone as
    queries) at the bf16 or 3xTF32 rate."""
    from mask_bev_tpu_torch.ops import swin_block as kswin
    from mask_bev_tpu_torch.ops import window_msa as kwmsa

    esz = 4 if f32 else 2
    rate = PEAK["tf32x3" if f32 else "bf16"]
    err_abs = err_rel = ms_k = ms_p = ops = byts = g_ops = 0.0
    calls, shapes = [], []
    for (a, kw) in captured:
        got = kwmsa.window_msa(*a, **kw)
        # the plain version on the true layers (not the kernels' padded)
        pkw = {k: v for k, v in kw.items() if k != "padded"}
        want = kwmsa.window_msa_grid_plain(*a, **pkw)
        e = float((got.float() - want.float()).abs().max())
        err_abs = max(err_abs, e)
        err_rel = max(err_rel, e / float(want.float().abs().max()))
        ms_k += cuda_ms(torch, lambda: kwmsa.window_msa(*a, **kw), 5)
        ms_p += cuda_ms(torch, lambda: kwmsa.window_msa_grid_plain(
            *a, **pkw), 1)
        y, hw, win, shift, rel, qkv, proj, heads = a
        b_, l_, c_ = y.shape
        g_ops += 2.0 * b_ * l_ * 4 * c_ * c_
        ops += 4.0 * b_ * l_ * win * win * c_
        byts += 2 * b_ * l_ * c_ * esz + 4 * c_ * c_ * esz
        shapes.append(f"{hw[0]}x{hw[1]} C{c_} h{heads} shift {shift}")
        calls.append((kswin.gemm("window_msa", y.reshape(-1, c_), qkv,
                                 kswin.EPI_BIAS), qkv.bias, rel, b_,
                      hw, heads, win, shift))
    # bf16: both sides round qkv, probabilities and heads to bf16;
    # f32: the same f32 operations in another order
    tol = 1e-3 if f32 else 2e-2
    record("window_msa" + sfx, "mask_bev_tpu_torch/csrc/window_msa.cu",
           "mask_bev_tpu/ops/pallas_window_msa.py:71", err_abs,
           float("nan"), ms_k, ms_p, bound(byts, g_ops / rate + ops / rate),
           f"largest error relative to its block's max-abs "
           f"{err_rel:.4g} (tolerance {tol}); {len(captured)} {what} "
           f"summed: {shapes}", ok=err_rel <= tol)
    # ---- kernel 7's attention alone, with an SDPA yardstick ------------
    attn_phase(torch, kswin, record, "window_msa_attn" + sfx,
               "mask_bev_tpu/ops/pallas_window_msa.py:71", calls, True, f32,
               card)


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
    (4 n C a real token; the padded tokens are keys only) at the bf16 or
    3xTF32 rate. Also the device time of the kernel and of SDPA
    (``queued_ms``: without the host's time between calls)."""
    import torch.nn.functional as F

    err_rel = err_abs = ms_k = ms_p = ms_l = byts = ops = 0.0
    dev_k = dev_l = 0.0
    kname = "window_msa" if msa else "swin_block"
    for (qkv, qb, rel, b, hw, heads, win, shift) in calls:
        a = (qkv, qb, rel, b, hw, heads, win, shift)
        # a head width that is no multiple of 8: the kernel on the heads'
        # columns zero-padded to the next (kswin.padded_heads' layout), at
        # the true width's scale; its output's true columns held
        hd = qkv.shape[1] // 3 // heads
        qkv_k, qb_k, cols = kswin.padded_qkv(qkv, qb, heads)
        ak = (qkv_k, qb_k, rel, b, hw, heads, win, shift)

        def run(ak=ak, hd=hd):
            return kswin.attention(kname, *ak, msa=msa, hd=hd)
        got = run()[:, cols]
        want = kswin.window_attention_plain(*a, msa=msa)
        e = float((got.float() - want.float()).abs().max())
        err_abs = max(err_abs, e)
        err_rel = max(err_rel, e / float(want.float().abs().max()))
        ms_k += cuda_ms(torch, run, 5)
        ms_p += cuda_ms(torch, lambda: kswin.window_attention_plain(
            *a, msa=msa), 1)
        q, k, v, mask = sdpa_windows(torch, kswin, *a)
        ms_l += cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=hd ** -0.5), 5)
        dev_k += queued_ms(torch, run, 5)
        dev_l += queued_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=hd ** -0.5), 5)
        del q, k, v, mask, got, want, qkv_k, qb_k, ak
        c = qkv.shape[1] // 3
        byts += 4 * qkv.shape[0] * c * qkv.element_size() + rel.numel() * 4
        ops += 4.0 * b * hw[0] * hw[1] * win * win * c
    tol = 1e-4 if f32 else 1e-2
    record(name, ATTN_SOURCE, replaces, err_abs, float("nan"), ms_k, ms_p,
           bound(byts, ops / PEAK["tf32x3" if f32 else "bf16"]),
           f"{'MSA' if msa else 'Swin'} variant, "
           f"{'f32 (3xTF32)' if f32 else 'bf16'}; largest error relative "
           f"to its block's max-abs {err_rel:.4g} (tolerance {tol}); "
           f"{len(calls)} blocks summed; library = "
           f"F.scaled_dot_product_attention on the same windows; device "
           f"kernel {dev_k:.4f} ms, SDPA {dev_l:.4f} ms",
           ok=err_rel <= tol, library_ms=ms_l, device_ms=dev_k,
           library_device_ms=dev_l)


def grad_norms(grads):
    """L2 norm of the gradients of each top-level module."""
    out = {}
    for k, g in grads.items():
        top = k.split(".")[0]
        out[top] = out.get(top, 0.0) + float(g.float().square().sum())
    return {k: v ** 0.5 for k, v in out.items()}


def scatter_holds(torch, kcanvas, record, cap, suffix="") -> None:
    """Kernels A and B on the inputs one training step passed them
    (``cap["fwd"]``, ``cap["bwd"]``): held exactly against their plain
    versions, timed beside them and beside one library call each."""
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
    record("canvas_scatter" + suffix, "mask_bev_tpu_torch/csrc/canvas.cu",
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
    record("canvas_scatter_bwd" + suffix, "mask_bev_tpu_torch/csrc/canvas.cu",
           "mask_bev_tpu/ops/pallas_canvas.py:230", err, 0.0, ms_k,
           ms_p, bnd, f"d_canvas {tuple(d_canvas.shape)} "
           f"{d_canvas.dtype}; library: gather", ok=same,
           library_ms=lib_b)
    del gf, lib_idx


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
        scatter_holds(torch, kcanvas, record, cap)
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
    del cap, got, want

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


# [shapes wide]: the shapes the JAX package serves that the port's kernels
# refused on the card before (published backbones and encoders), each row
# a served path at full width: Swin-T (embed 96, window 7), Swin-B at 384
# px (embed 128, depths (2, 2, 18, 2), window 12), mmdet3d's / the
# PointPillars paper's long pillars (100 points), Deformable DETR's 300
# queries
SWIN_T = dict(backbone_embed_dim=96, backbone_depths=(2, 2, 6, 2),
              backbone_num_heads=(3, 6, 12, 24), backbone_window_size=7,
              fuse_patch_embed=True)
SWIN_B_384 = dict(backbone_embed_dim=128, backbone_depths=(2, 2, 18, 2),
                  backbone_num_heads=(4, 8, 16, 32), backbone_window_size=12)


def shapes_wide_phase(np, torch, card, results, failures, record) -> None:
    """``[shapes wide]``: four served paths at full width and batch 8 (bf16
    with int8 backbone products unless stated), each with its kernels'
    inputs captured in one forward and held against their plain versions
    (the main path's tolerances), 3 warm and 5 timed requests, the instance
    counters and one traced request: Swin-T with the fused patch embed
    (kernel 8 at E 96; kernels 3/4 at 49 tokens, head width 32); window 12
    (kernels 3/4 at 144 tokens; then path K at window 12: kernel 7 at 144
    tokens, one timed request); 100 points a pillar on scans with long
    pillars (kernel 1; then path E: kernel 10); 300 queries in bf16 and in
    f32 (kernel 5's split instance in clusters of 16). Then, at the
    kernel level, on inputs drawn at the paths' widths: kernel 5 at Q = 512
    and with 1 and 16 heads, kernels 3/4 and 7 at window 16, kernel 8 at
    E = 48, kernels 1 and 10 at 64 and 128 points a pillar."""
    from mask_bev_tpu_torch.config import semantic_kitti_default

    base = semantic_kitti_default().replace(
        max_points_per_scan=131072, pseudo_image_norm="full",
        compute_dtype="bfloat16")
    serve_phase(np, torch, card, results, failures, record,
                base.replace(**SWIN_T), ".swin_t", PATH_WARM, PATH_TIMED)
    serve_phase(np, torch, card, results, failures, record,
                base.replace(**SWIN_B_384), ".w12", PATH_WARM, PATH_TIMED)
    path_phase(np, torch, card, results, failures, record, "K",
               overrides=dict(backbone_window_size=12), tag=".w12",
               requests=(1, 1))
    serve_phase(np, torch, card, results, failures, record,
                base.replace(max_num_points=100), ".k100", PATH_WARM,
                PATH_TIMED, points=scans_long)
    path_phase(np, torch, card, results, failures, record, "E",
               overrides=dict(max_num_points=100), tag=".k100",
               points=scans_long)
    serve_phase(np, torch, card, results, failures, record,
                base.replace(num_queries=300), ".q300", PATH_WARM,
                PATH_TIMED)
    serve_phase(np, torch, card, results, failures, record,
                semantic_kitti_default().replace(max_points_per_scan=131072,
                                                 num_queries=300),
                ".q300.f32", PATH_WARM, PATH_TIMED)
    wide_kernel_holds(np, torch, card, results, failures, record)


def decoder_call(np, torch, cfg, seed):
    """The decoder stack's arguments (args, keywords) as one forward of
    ``cfg``'s model (random weights from ``seed``, batch 8 of scans) passes
    them: the widths, levels and conditioning of a served path."""
    from mask_bev_tpu_torch.inference import MaskBevPredictor
    from mask_bev_tpu_torch.models import mask2former as m2f
    from mask_bev_tpu_torch.models.maskbev import MaskBev

    pred = MaskBevPredictor(cfg, MaskBev(cfg).random_state_dict(seed),
                            device="cuda")
    pts, msk = scans(np, BATCH, cfg.max_points_per_scan, seed)
    captured, orig = [], m2f.decoder_stack

    def rec(*a, **kw):
        captured.append((a, kw))
        return orig(*a, **kw)

    m2f.decoder_stack = rec
    try:
        pred.forward(torch.as_tensor(pts), torch.as_tensor(msk))
    finally:
        m2f.decoder_stack = orig
    (a, kw), = captured
    return a, kw


def launched(kb, results, failures, name, instance) -> None:
    """A kernel-level entry's launches: those of ``instance`` since the
    last reset (its hold's calls; no served path runs it). None fails."""
    results[name]["launches"] = kb.INSTANCES.get(instance, 0)
    if results[name]["launches"] <= 0:
        failures.append(f"[{name}] {instance} never launched")


def wide_kernel_holds(np, torch, card, results, failures, record,
                      dev="cuda") -> None:
    """The ``[shapes wide]`` instances no served row reaches, each held
    against its plain version at the main path's widths: the decoder's
    split instance at Q = 512 (8 heads) and with 1 and 16 heads (Q 45), in
    bf16 and f32, on the arguments one forward of the main path's
    configuration so changed passes it (``decoder_call``; drawn weights
    leave many mask logits near the ``m < 0`` threshold, so the
    free-running comparison would measure their flips, not the kernel);
    the window attention of kernels 3 and 7 and both chains
    at window 16 (Swin-B's stage-0 grid, C 128 over 4 heads, shifted);
    kernel 8 at E = 48 on the main path's canvas; kernels 1 and 10 at 64
    and 128 points a pillar on scans with long pillars."""
    from mask_bev_tpu_torch.config import semantic_kitti_default
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.models.maskbev import MaskBev
    from mask_bev_tpu_torch.models.swin import SwinBlock
    from mask_bev_tpu_torch.ops import decoder_stack as kdec
    from mask_bev_tpu_torch.ops import pfn as kpfn
    from mask_bev_tpu_torch.ops import stream_pillars as ksp
    from mask_bev_tpu_torch.ops import swin_block as kswin

    bf16 = torch.bfloat16
    gh, gw = semantic_kitti_default().grid_hw
    with torch.no_grad():
        # ---- kernel 5: Q = 512, one head, 16 heads -------------------------
        for tag, q, heads in ((".q512", 512, 8), (".heads1", 45, 1),
                              (".heads16", 45, 16)):
            for f32 in (False, True):
                sfx = tag + (".f32" if f32 else "")
                cfg = semantic_kitti_default().replace(
                    max_points_per_scan=131072, num_queries=q,
                    head_num_attn_heads=heads,
                    **({} if f32 else dict(pseudo_image_norm="full",
                                           compute_dtype="bfloat16")))
                dargs, dkw = decoder_call(np, torch, cfg, SEED + 60 + q)
                kb.reset_launches()
                decoder_hold(torch, record, failures, card, dargs, dkw, f32,
                             sfx, "shapes wide" + sfx.replace(".", " "))
                launched(kb, results, failures, "decoder_stack" + sfx,
                         "decoder_stack/" + kdec.split_instance(q, heads,
                                                                f32))
                del dargs

        # ---- kernels 3/4 and 7 at window 16 --------------------------------
        b, hw, c, heads, win = BATCH, (gh // 4, gw // 4), 128, 4, 16
        shift = kswin.effective_shift(hw, win, True)
        g = torch.Generator().manual_seed(70)
        x = torch.randn(b, hw[0] * hw[1], c, generator=g).to(dev, bf16)
        blocks = []
        for quant in (True, False):
            blk = SwinBlock(c, heads, win, shift=True, quantize=quant)
            blk.attn.w_msa.rel_pos_bias_table.normal_(0.0, 0.02,
                                                      generator=g)
            blocks.append(blk.to(dev, bf16).eval())
        p8, p16 = blocks[0].weights(), blocks[1].weights()
        kb.reset_launches()
        got = kswin.swin_block(x, p8, hw, win, heads, shift, True)
        want = kswin.swin_block_plain(x, p8, hw, win, heads, shift, True)
        err = float((got.float() - want.float()).abs().max())
        err_rel = err / float(want.float().abs().max())
        ms_k = cuda_ms(torch, lambda: kswin.swin_block(
            x, p8, hw, win, heads, shift, True), 3)
        ms_p = cuda_ms(torch, lambda: kswin.swin_block_plain(
            x, p8, hw, win, heads, shift, True), 1)
        gemm_ops = 2.0 * b * hw[0] * hw[1] * 12 * c * c
        hp = -(-hw[0] // win) * win
        attn_ops = 4.0 * b * hp * hp * win * win * c
        byts = 2 * b * hw[0] * hw[1] * c * 2 + 12 * c * c
        record("swin_block.w16", *SOURCES["swin_block"], err, float("nan"),
               ms_k, ms_p, bound(byts, gemm_ops / PEAK["int8"]
                                 + attn_ops / PEAK["bf16"]),
               f"one block, int8 products, {hw} grid, C {c} over {heads} "
               f"heads, window {win} shifted {shift}; largest error "
               f"relative to its max-abs {err_rel:.4g} (tolerance 2e-2)",
               ok=err_rel <= 2e-2)
        launched(kb, results, failures, "swin_block.w16",
                 "swin_block/attn_bf16_long")
        del got, want
        kb.reset_launches()
        attn_phase(torch, kswin, record, "swin_attn.w16",
                   "mask_bev_tpu/ops/pallas_swin_block.py:208",
                   [(block_qkv(kswin, x, p8, True), p8.qkv.bias, p8.rel_bias,
                     b, hw, heads, win, shift)], False, False, card)
        launched(kb, results, failures, "swin_attn.w16",
                 "swin_block/attn_bf16_long")
        kb.reset_launches()
        window_msa_phase(torch, record, card, ".w16",
                         [((x, hw, win, shift, p16.rel_bias, p16.qkv,
                            p16.proj, heads), {})], False,
                         what="blocks drawn at window 16")
        results["window_msa.w16"]["launches"] = kb.LAUNCHES["window_msa"]
        launched(kb, results, failures, "window_msa_attn.w16",
                 "window_msa/attn_bf16_long")
        del x, blocks, p8, p16

        # ---- kernel 8 at E = 48 on the main path's canvas ------------------
        g = torch.Generator().manual_seed(71)
        e = 48
        canvas = torch.randn(BATCH, gh, gw, 128, generator=g).to(dev, bf16)
        wm = (torch.randn(e, 4 * 4 * 128, generator=g) / 2048 ** 0.5).to(
            dev, bf16)
        vecs = [(base_ + 0.1 * torch.randn(e, generator=g)).to(dev, bf16)
                for base_ in (0.0, 1.0, 0.0)]
        kb.reset_launches()
        patch_embed_hold(torch, record, ".e48",
                         (canvas, wm, *vecs, 4, 1e-6), {}, False)
        launched(kb, results, failures, "patch_embed.e48",
                 "patch_embed/bf16")
        del canvas, wm, vecs

        # ---- kernels 1 and 10 at 64 and 128 points a pillar ----------------
        for k in (64, 128):
            cfg = semantic_kitti_default().replace(
                max_points_per_scan=131072, compute_dtype="bfloat16",
                max_num_points=k)
            model = MaskBev(cfg)
            model.load_state_dict(model.random_state_dict(SEED + 72))
            enc = model.to(dev, bf16).encoder.eval()
            pts_np, mask_np = scans_long(np, BATCH, cfg.max_points_per_scan,
                                         SEED + k)
            pts = torch.as_tensor(pts_np).to(dev, bf16)
            msk = torch.as_tensor(mask_np).to(dev)
            net = enc.pillar_feature_net
            weights, packed = enc._weights(pts.device)
            kw = dict(with_distance=net.with_distance, grid_w=enc.grid_hw[1],
                      voxel_size=enc.voxel_size, x0=enc.x_range[0],
                      y0=enc.y_range[0], out_dtype=bf16)
            macs = sum(w_.shape[0] * w_.shape[1] for (w_, _, _) in weights)
            # kernel 1: every occupied cell
            kb.reset_launches()
            ps, table, stats = enc.pillar_table(pts, msk)
            t_plain, s_plain = kpfn.pfn_plain(ps, weights,
                                              point_dim=net.point_dim, **kw)
            n_pil = ps.num_pillars.long()
            rows = (torch.arange(table.shape[1], device=dev)[None]
                    < n_pil[:, None])
            err = float((table.float() - t_plain.float()).abs()[rows].max())
            scale = float(t_plain.float().abs().max())
            st_err = float(((stats - s_plain).abs()
                            / s_plain.abs().clamp(min=1)).max())
            ms_k = cuda_ms(torch, lambda: kpfn.pfn(
                ps, weights, point_dim=net.point_dim,
                max_points_per_pillar=k, packed=packed, **kw), 5)
            ms_p = cuda_ms(torch, lambda: kpfn.pfn_plain(
                ps, weights, point_dim=net.point_dim, **kw), 2)
            kept = float(ps.counts.sum())
            n_long = int((ps.counts > 32).sum())
            byts = (BATCH * cfg.max_points_per_scan * 16
                    + float(n_pil.sum()) * (12 + table.shape[-1] * 2))
            record(f"pfn.k{k}", *SOURCES["pfn"], err, 2 ** -7 * scale, ms_k,
                   ms_p, bound(byts, 2 * kept * macs / PEAK["bf16"]),
                   f"{k} points a pillar: pillars over 32 kept points "
                   f"{n_long} of {int(n_pil.sum())}, kept points "
                   f"{int(kept)}; stats rel err {st_err:.3g} (tolerance "
                   f"1e-3)")
            if st_err > 1e-3 or n_long <= 0:
                failures.append(f"pfn.k{k}: stats or no long pillar")
            launched(kb, results, failures, f"pfn.k{k}",
                     "pfn/" + kpfn.instance(False, k))
            del ps, table, t_plain
            # kernel 10: the capped stream of the same scans
            kb.reset_launches()
            sp, table, stats, nv = enc.capped_table(pts, msk)
            want, wstats = kpfn.stream_pfn_plain(sp, weights, k=k, **kw)
            err = float((table.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            st_err = float(((stats - wstats).abs()
                            / wstats.abs().clamp(min=1)).max())
            counts = ksp.kept_counts(sp.pid, sp.kept, sp.starts.shape[1])
            ms_k = cuda_ms(torch, lambda: kpfn.stream_pfn(
                sp, weights, k=k, num_valid=nv, packed=packed, **kw), 5)
            ms_p = cuda_ms(torch, lambda: kpfn.stream_pfn_plain(
                sp, weights, k=k, **kw), 2)
            kept = float(sp.kept.sum())
            b_, n_, d_ = sp.pts.shape
            p_, c_ = table.shape[1], table.shape[2]
            byts = b_ * n_ * (d_ * 2 + 4 + 1) + b_ * p_ * (8 + c_ * 2 + 8)
            record(f"stream_pfn.k{k}", "mask_bev_tpu_torch/csrc/pfn.cu",
                   "mask_bev_tpu/ops/pallas_pfn.py:168", err, 1e-2 * scale,
                   ms_k, ms_p, bound(byts, 2 * kept * macs / PEAK["bf16"]),
                   f"{k} points a pillar, {p_} slots (occupied "
                   f"{nv.tolist()}): slots over 32 kept points "
                   f"{int((counts > 32).sum())}; stats rel err "
                   f"{st_err:.3g} (tolerance 1e-3)")
            if st_err > 1e-3 or int((counts > 32).sum()) <= 0:
                failures.append(f"stream_pfn.k{k}: stats or no long pillar")
            launched(kb, results, failures, f"stream_pfn.k{k}",
                     "stream_pfn/" + kpfn.instance(False, k))
            del sp, table, want, model, enc, pts, msk
    torch.cuda.empty_cache()


# ``[shapes tail]``: the last shape gaps, served at full width
E384 = dict(backbone_embed_dim=384, backbone_num_heads=(6, 12, 24, 48))
HD8 = dict(backbone_embed_dim=72, backbone_num_heads=(9, 18, 36, 72))
HD40 = dict(backbone_embed_dim=120, backbone_num_heads=(3, 6, 12, 24))
C100 = dict(encoder_encoding_type="fourier",
            encoder_feat_channels=(128, 128, 100))
# (1 warm + 2 timed: cut from 2 + 3 to pay for ``[shapes last]``'s rows)
TAIL_REQUESTS = (1, 2)
# ``[shapes audit]``: the refusal audit's PFN and attention entries, served
U100 = dict(encoder_feat_channels=(128, 128, 100))
HD96 = dict(backbone_num_heads=(2, 4, 8, 16))
W24 = dict(backbone_window_size=24)
# ``.rest``: the audit's last entries served: kernel 1 past 128 points a
# pillar (the layered route beside the tiles), kernel 8 at E 72 (padded to
# 96) over ``.hd8``'s backbone, the decoder at C 96 over 8 heads (head width
# 12, padded to 16); the mask embedding at C (the decoder stack's memory
# width, as in the JAX package's fused stack)
REST = dict(max_num_points=129, fuse_patch_embed=True, **HD8,
            head_feat_channels=96, head_out_channels=96)


def shapes_tail_phase(np, torch, card, results, failures, record) -> None:
    """``[shapes tail]``: the shapes the last slice widened, served at full
    width and batch 8 (bf16, int8 backbone products), each row's kernels
    held against their plain versions on inputs captured in one forward,
    then 1 warm and 2 timed requests with the instance counters and one
    traced request: ``.e384`` path E at embed 384 (kernel 9 at C 384 to
    3072, the walk above 2048; the Swin LN at C 3072, the walk), ``.hd8``
    embed 72 over (9, 18, 36, 72) heads (head width 8 at every stage, the
    int8 GEMM at K = 72 from rows at a 80-byte pitch), ``.hd40`` embed 120
    over (3, 6, 12, 24) heads (head width 40, K = 120), ``.c100`` the
    Fourier encoding with a 100-channel table (kernel 2 at C = 100, then a
    training step: kernels A and B at C = 100). Then the kernel-level
    holds (``tail_kernel_holds``)."""
    from mask_bev_tpu_torch.config import semantic_kitti_default

    base = semantic_kitti_default().replace(
        max_points_per_scan=131072, pseudo_image_norm="full",
        compute_dtype="bfloat16")
    path_phase(np, torch, card, results, failures, record, "E",
               overrides=E384, tag=".e384", requests=TAIL_REQUESTS,
               blocks=True)
    serve_phase(np, torch, card, results, failures, record,
                base.replace(**HD8), ".hd8", *TAIL_REQUESTS)
    serve_phase(np, torch, card, results, failures, record,
                base.replace(**HD40), ".hd40", *TAIL_REQUESTS)
    c100_phase(np, torch, card, results, failures, record,
               base.replace(**C100))
    tail_kernel_holds(np, torch, card, results, failures, record)


def c100_phase(np, torch, card, results, failures, record, cfg) -> None:
    """``.c100``: ``cfg`` (the Fourier encoding, a 100-channel pillar
    table: the capped stream and the plain pillar feature net, as the JAX
    package's XLA route) served at batch 8: kernels 2 (at C = 100, 200-byte
    rows), 3/4 and 5 captured in one forward and held, 1 warm and 2 timed
    requests (kernels 2-5 must launch, kernel 2 as its 8-byte instance; 1
    and 10 must not), one traced request; then the training step of the
    same configuration (``train_phase``'s envelope): kernels A and B at C =
    100 captured in one step and held exactly, 2 timed steps."""
    from mask_bev_tpu_torch.datasets.synthetic import make_batch
    from mask_bev_tpu_torch.inference import MaskBevPredictor
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.models import encoder as menc
    from mask_bev_tpu_torch.models import mask2former as m2f
    from mask_bev_tpu_torch.models import swin as msw
    from mask_bev_tpu_torch.models.maskbev import MaskBev
    from mask_bev_tpu_torch.ops import canvas as kcanvas
    from mask_bev_tpu_torch.ops import swin_block as kswin
    from mask_bev_tpu_torch.train.step import (
        create_train_state, loss_and_grads, train_step)

    sfx, label = ".c100", "e2e c100"
    pred = MaskBevPredictor(cfg, MaskBev(cfg).random_state_dict(SEED + 80),
                            device="cuda")
    staged = []
    for s in range(4):
        p_np, m_np = scans(np, BATCH, cfg.max_points_per_scan, 800 + s)
        staged.append((torch.as_tensor(p_np).cuda().to(pred.dtype),
                       torch.as_tensor(m_np).cuda()))
    cap = {"canvas_norm": [], "swin_block": [], "decoder_stack": []}
    mods = {"canvas_norm": menc, "swin_block": msw, "decoder_stack": m2f}
    orig = {n: getattr(m, n) for n, m in mods.items()}

    def recorder(name):
        def rec(*a, **kw):
            cap[name].append((tuple(t.clone() if torch.is_tensor(t) else t
                                    for t in a), kw))
            return orig[name](*a, **kw)
        return rec

    for n, m in mods.items():
        setattr(m, n, recorder(n))
    try:
        with torch.no_grad():
            pred.model(*staged[0])
    finally:
        for n, m in mods.items():
            setattr(m, n, orig[n])
    (a_canvas, _), = cap["canvas_norm"]
    (dargs, dkw), = cap["decoder_stack"]
    with torch.no_grad():
        canvas_phase(torch, kcanvas, lambda n, *r, **k: record(
            n, *SOURCES["canvas_norm"], *r, **k), "canvas_norm" + sfx,
            a_canvas)
        block_hold(torch, kswin, lambda n, *r, **k: record(
            n + sfx, *SOURCES[n], *r, **k),
            [a for a, _ in cap["swin_block"]], False)
        decoder_hold(torch, record, failures, card, dargs, dkw, False, sfx,
                     label)
    del cap, a_canvas, dargs, dkw
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    warm, timed = TAIL_REQUESTS
    for i in range(warm):
        pred.forward(*staged[i % 4])
    torch.cuda.synchronize()
    times = []
    for i in range(timed):
        t1 = time.perf_counter()
        cls_p, mask_p = pred.forward(*staged[i % 4])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches, instances = dict(kb.LAUNCHES), dict(kb.INSTANCES)
    ms_batch = float(np.median(times) * 1e3)
    print(f"[{label}] {warm + timed} requests of batch {BATCH}: median "
          f"{ms_batch:.3f} ms/batch, {BATCH / (ms_batch / 1e3):.2f} scans/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB; launches {launches}; by instance {instances} [{card}]",
          flush=True)
    for k in ("canvas_norm", "swin_block", "decoder_stack"):
        results[k + sfx]["launches"] = launches.get(k, 0)
        if launches.get(k, 0) <= 0:
            failures.append(f"{k} never launched on [{label}]")
    for k in ("pfn", "stream_pfn"):
        if launches.get(k, 0):
            failures.append(f"[{label}] {k} launched {launches[k]} times")
    if instances.get("canvas_norm/bf16_w8", 0) <= 0:
        failures.append(f"[{label}] canvas_norm/bf16_w8 never launched")
    if not (torch.isfinite(cls_p).all() and torch.isfinite(mask_p).all()):
        failures.append(f"[{label}] non-finite outputs")
    traced(torch, lambda: pred.forward(*staged[0]), "profile c100",
           "request", card, 12)
    del pred, staged, cls_p, mask_p
    torch.cuda.empty_cache()

    # ---- the training step of the same configuration ----------------------
    tcfg = cfg.replace(max_num_pillars=32768, batch_size=TRAIN_BATCH)
    state = create_train_state(tcfg, seed=SEED + 81, device="cuda")
    batches = [make_batch(np.random.default_rng(810 + i), tcfg,
                          batch_size=TRAIN_BATCH, noise_points=115_000,
                          points_per_instance=1500) for i in range(2)]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 81)
    cap = {}
    orig_ab = (kcanvas.canvas_scatter_forward,
               kcanvas.canvas_scatter_backward)

    def rec_fwd(table, cells, grid_hw):
        cap["fwd"] = (table.detach().clone(), cells.clone(), grid_hw)
        return orig_ab[0](table, cells, grid_hw)

    def rec_bwd(d_canvas, cells, grid_hw):
        cap["bwd"] = (d_canvas.detach().contiguous().clone(), cells.clone(),
                      grid_hw)
        return orig_ab[1](d_canvas, cells, grid_hw)

    kcanvas.canvas_scatter_forward, kcanvas.canvas_scatter_backward = (
        rec_fwd, rec_bwd)
    try:
        logs, _, grads = loss_and_grads(state, batches[0], gen)
        torch.cuda.synchronize()
    finally:
        kcanvas.canvas_scatter_forward, kcanvas.canvas_scatter_backward = (
            orig_ab)
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    if bad or not np.isfinite(float(logs["loss"])):
        failures.append(f"[train c100] non-finite loss or gradients "
                        f"{bad[:5]}")
    del grads
    with torch.no_grad():
        scatter_holds(torch, kcanvas, record, cap, sfx)
    del cap
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    times = []
    for i in range(2):
        t1 = time.perf_counter()
        state, logs, _ = train_step(state, batches[i % 2], gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches, instances = dict(kb.LAUNCHES), dict(kb.INSTANCES)
    print(f"[train c100] batch {TRAIN_BATCH}, table of "
          f"{tcfg.encoder_feat_channels[-1]} channels: 2 timed steps "
          f"{[round(t * 1e3, 3) for t in times]} ms, loss "
          f"{float(logs['loss']):.4f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"launches {launches}; by instance {instances} [{card}]",
          flush=True)
    for k in ("canvas_scatter", "canvas_scatter_bwd"):
        results[k + sfx]["launches"] = launches.get(k, 0)
        if instances.get(f"{k}/w8", 0) <= 0:
            failures.append(f"[train c100] {k}/w8 never launched")
    if not np.isfinite(float(logs["loss"])):
        failures.append("[train c100] non-finite loss")
    del state, batches, logs
    torch.cuda.empty_cache()


def tail_kernel_holds(np, torch, card, results, failures, record,
                      dev="cuda") -> None:
    """The ``[shapes tail]`` instances no served row reaches, each held
    against its plain version with the tolerance its flagship instance is
    held to, and timed beside one library call where one computes the
    same function: kernel 9 at ``WALK_LN_CASES`` (C 12 and 100 on the
    stage-1 grid's tokens, the walk; 2056, 3072 and 4096 on an eighth of
    them, the wide instance) and the Swin LN at ``WALK_SWIN_CASES`` (the
    wide kernel: bf16 / f32 out, int8 rows), bf16 and f32, each beside
    ``F.layer_norm`` (event and device times), then every output's digest
    against ``WALK_SHA256``; kernels 2 (the main path's grid, ~45k pillars a sample) and
    A/B (the training envelope) at C = 100 in bf16 and C = 101 in f32; the
    GEMM at K = 24 and 40, N = 100 (bf16, int8, 3xTF32; ``torch.addmm``,
    ``torch._int_mm`` where it takes the shape) on the stage-0 tokens; the
    attention on the stage-0 grid (bf16 and f32; SDPA; event and device
    times) at head widths 8, 24, 40, 48 and 56 at window 10 (the head-width
    kernel's instance of 7 warps), 8 and 48 at window 7 in both variants
    (its instance of 8 warps, which serves the other windows up to 11),
    and 24, 48 and 56 at window 12 (the long-window kernel);
    kernel 7 at head width 8 (C 72, 9 heads, the stage-0 grid)."""
    import torch.nn.functional as F

    from mask_bev_tpu_torch.config import semantic_kitti_default
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.models.swin import SwinBlock
    from mask_bev_tpu_torch.ops import canvas as kcanvas
    from mask_bev_tpu_torch.ops import layer_norm as kln
    from mask_bev_tpu_torch.ops import swin_block as kswin

    gh, gw = semantic_kitti_default().grid_hw
    hw0 = (gh // 4, gw // 4)                    # stage 0: 125 x 125
    m1 = BATCH * (-(-hw0[0] // 2)) * (-(-hw0[1] // 2))  # stage 1 tokens
    m0 = BATCH * hw0[0] * hw0[1]
    g = torch.Generator().manual_seed(90)
    with torch.no_grad():
        # ---- kernel 9 at any C: the walk, and the wide instance above 2048 -
        for c, rows in WALK_LN_CASES:
            for f32 in (False, True):
                sfx = f".c{c}" + (".f32" if f32 else "")
                x, w, b = walk_inputs(torch, c, rows, f32, dev)
                kb.reset_launches()
                got = kln.layer_norm(x, w, b)
                want = kln.layer_norm_plain(x, w, b)
                err = float((got.float() - want.float()).abs().max())
                top = float(want.float().abs().max())
                del got, want
                ms_k = cuda_ms(torch, lambda: kln.layer_norm(x, w, b), 20)
                ms_p = cuda_ms(torch, lambda: kln.layer_norm_plain(x, w, b),
                               5)
                ms_l = cuda_ms(torch, lambda: F.layer_norm(
                    x, (c,), w, b, 1e-6), 20)
                # the device's time alone: the event times above include
                # the host's time a call between back-to-back launches
                dev_k = queued_ms(torch, lambda: kln.layer_norm(x, w, b), 20)
                dev_l = queued_ms(torch, lambda: F.layer_norm(
                    x, (c,), w, b, 1e-6), 20)
                bnd = bound(2 * x.numel() * x.element_size(), 0.0)
                inst = kln.instance_suffix(c)[1:]
                record("layer_norm" + sfx,
                       "mask_bev_tpu_torch/csrc/layer_norm.cu",
                       "mask_bev_tpu/ops/pallas_layer_norm.py:33", err,
                       (1e-4 if f32 else 1e-2) * top, ms_k, ms_p, bnd,
                       f"{rows} tokens of C {c}, plan {kln.plan(c, f32)} "
                       f"(the {inst}); library F.layer_norm; device kernel "
                       f"{dev_k:.4f} ms ({bnd[0] / dev_k:.0%} of the bound), "
                       f"F.layer_norm {dev_l:.4f} ms",
                       library_ms=ms_l, device_ms=dev_k,
                       library_device_ms=dev_l)
                launched(kb, results, failures, "layer_norm" + sfx,
                         "layer_norm/" + ("f32" if f32 else "bf16")
                         + kln.instance_suffix(c))
                del x, w, b

        # ---- the Swin LN above C 2048: the wide kernel -------------------
        for c, rows in WALK_SWIN_CASES:
            for f32 in (False, True):
                x, w, b = walk_inputs(torch, c, rows, f32, dev)
                esz = x.element_size()
                for quant in (False, True):
                    sfx = f".c{c}" + (".f32" if f32 else "") + (
                        ".int8" if quant else "")
                    kb.reset_launches()
                    got = kswin._ln(x, w, b, quant)
                    want = kswin.layer_norm_p(x, w, b)
                    top = float(want.float().abs().max())
                    if quant:
                        # the int8 rows of the plain output: within one
                        # step (an f32 LayerNorm summed in another order
                        # can cross a rounding boundary), the scales 1e-4
                        q, sq = kswin.quant_rows(want)
                        steps = float((got[0].float() - q).abs().max())
                        err = float((got[1] - sq.reshape(-1)).abs().max()
                                    / sq.abs().max())
                        ok, tol = steps <= 1.0 and err <= 1e-4, 1e-4
                        out_b = rows * (kswin.row_pitch(c, 1) + 4)
                        what = (f"int8 rows at a pitch of "
                                f"{got[0].stride(0)}: largest step "
                                f"{steps:g} (tolerance 1), scales relative "
                                f"error {err:.3g}")
                    else:
                        err = float((got.float() - want.float()).abs().max())
                        tol, ok = (1e-4 if f32 else 1e-2) * top, None
                        out_b = rows * c * esz
                        what = "the normalised rows"
                    del got, want
                    run = lambda: kswin._ln(x, w, b, quant)  # noqa: E731
                    ms_k = cuda_ms(torch, run, 20)
                    ms_p = cuda_ms(torch, lambda: kswin.layer_norm_p(
                        x, w, b), 5)
                    dev_k = queued_ms(torch, run, 20)
                    ms_l = dev_l = None
                    if not quant:
                        ms_l = cuda_ms(torch, lambda: F.layer_norm(
                            x, (c,), w, b, 1e-6), 20)
                        dev_l = queued_ms(torch, lambda: F.layer_norm(
                            x, (c,), w, b, 1e-6), 20)
                    bnd = bound(rows * c * esz + out_b, 0.0)
                    lib_s = ("" if dev_l is None else
                             f", F.layer_norm {dev_l:.4f} ms (bf16 / f32 "
                             f"out)")
                    record("swin_ln" + sfx, SOURCES["swin_block"][0],
                           SOURCES["swin_block"][1], err, tol, ms_k, ms_p,
                           bnd,
                           f"{rows} rows of C {c} (the .e384 stage 3), "
                           f"{what}; the wide kernel; device kernel "
                           f"{dev_k:.4f} ms ({bnd[0] / dev_k:.0%} of the "
                           f"bound){lib_s}", ok=ok, library_ms=ms_l,
                           device_ms=dev_k,
                           **({} if dev_l is None else
                              dict(library_device_ms=dev_l)))
                    launched(kb, results, failures, "swin_ln" + sfx,
                             "swin_block/" + kswin.ln_instance(c, f32, quant))
                del x, w, b

        # ---- both walks bit for bit against the walk they replaced -------
        got = walk_digests(torch, dev)
        differ = sorted(str(k) for k in WALK_SHA256 if got.get(k)
                        != WALK_SHA256[k])
        print(f"[walk digests] {len(WALK_SHA256)} outputs (kernel 9 at C "
              f"{[c for c, _ in WALK_LN_CASES]}, the Swin LN at "
              f"{[c for c, _ in WALK_SWIN_CASES]}, bf16 and f32, int8): "
              f"sha256 equal to the walk's (before its redesign) "
              f"{len(WALK_SHA256) - len(differ)}; differ {differ} -> "
              f"{'ok' if not differ else 'FAIL'} [{card}]", flush=True)
        if differ:
            failures.append(f"[walk digests] differ: {differ}")

        # ---- kernels 2, A and B at C = 100 (bf16) and 101 (f32) ----------
        rng = np.random.default_rng(91)
        for c, dt in ((100, torch.bfloat16), (101, torch.float32)):
            f32 = dt == torch.float32
            # ".held": the served .c100 row records kernels 2, A and B too
            sfx = f".c{c}" + (".f32" if f32 else "") + ".held"
            h_, w_ = gh, gw
            for train, b_, n_ in ((False, BATCH, 48000),
                                  (True, TRAIN_BATCH, 32768)):
                hw_ = h_ * w_
                n_ = min(n_, hw_ // 2)
                cells = np.full((b_, n_), hw_, np.int32)
                npil = rng.integers(n_ * 3 // 4, n_ + 1, b_).astype(np.int32)
                for s_, p_ in enumerate(npil):
                    cells[s_, :p_] = np.sort(rng.choice(hw_, p_,
                                                        replace=False))
                cells_t = torch.as_tensor(cells, device=dev)
                table = torch.randn(b_, n_, c, generator=g).to(dev, dt)
                if not train:
                    mean = torch.randn(b_, generator=g).to(dev) * 0.1
                    var = torch.rand(b_, generator=g).to(dev) + 0.5
                    scale = (1 + 0.1 * torch.randn(h_, w_, c, generator=g)
                             ).to(dev, dt)
                    bias = (0.1 * torch.randn(h_, w_, c, generator=g)).to(
                        dev, dt)
                    kb.reset_launches()
                    canvas_phase(torch, kcanvas, lambda n, *r, **k: record(
                        n, *SOURCES["canvas_norm"], *r, **k),
                        "canvas_norm" + sfx,
                        (table, cells_t, torch.as_tensor(npil, device=dev),
                         mean, var, scale, bias, (h_, w_), 1e-3))
                    launched(kb, results, failures, "canvas_norm" + sfx,
                             "canvas_norm/" + ("f32" if f32 else "bf16")
                             + f"_w{4 if f32 else 8}")
                    del scale, bias
                else:
                    d_canvas = torch.randn(b_, h_, w_, c, generator=g).to(
                        dev, dt)
                    kb.reset_launches()
                    scatter_holds(torch, kcanvas, record, {
                        "fwd": (table, cells_t, (h_, w_)),
                        "bwd": (d_canvas, cells_t, (h_, w_))}, sfx)
                    wb = f"w{4 if f32 else 8}"
                    launched(kb, results, failures, "canvas_scatter" + sfx,
                             f"canvas_scatter/{wb}")
                    launched(kb, results, failures,
                             "canvas_scatter_bwd" + sfx,
                             f"canvas_scatter_bwd/{wb}")
                    del d_canvas
                del table, cells_t

        # ---- the GEMM at K = 24 and 40, N = 100 --------------------------
        for k in (24, 40):
            n = 100
            a32 = torch.randn(m0, k, generator=g).to(dev)
            w32 = (torch.randn(n, k, generator=g) / k ** 0.5).to(dev)
            bias = (0.1 * torch.randn(n, generator=g)).to(dev)
            gemm_split(torch, kswin, a32, k)
            for kind in ("bf16", "int8", "f32"):
                sfx = f".k{k}.n{n}.{kind}"
                dt = torch.float32 if kind == "f32" else torch.bfloat16
                d = kswin.make_dense(w32.to(dt), bias, kind == "int8")
                lib_ms = None
                if kind == "int8":
                    q, sx = kswin.quant_rows(a32.to(dt))
                    a = kswin.pitched(q.to(torch.int8))
                    sx = sx.reshape(-1).contiguous()
                    run = lambda: kswin.gemm(  # noqa: E731
                        "swin_block", a, d, kswin.EPI_BIAS, sx=sx)
                    want = ((a.double() @ d.q8.double().t()).float()
                            * sx[:, None] * d.sw[None] + d.bias).to(dt)
                    plain = lambda: kswin.int8_sim_dense(  # noqa: E731
                        a32.to(dt), d)
                    tol = 0.0
                    try:  # N % 8 != 0: not every torch build takes it
                        a_c = a.contiguous()
                        lib_ms = cuda_ms(torch, lambda: torch._int_mm(
                            a_c, d.q8.t()), 10)
                    except RuntimeError as e:
                        print(f"[gemm{sfx}] torch._int_mm refuses the "
                              f"shape: {str(e)[:120]}", flush=True)
                    ops = 2.0 * m0 * n * k / PEAK["int8"]
                    esz = 1
                else:
                    a = kswin.pitched(a32.to(dt))
                    mode = kswin.EPI_BIAS | (
                        0 if kind == "f32" else kswin.EPI_ROUND_ACC)
                    run = lambda: kswin.gemm(  # noqa: E731
                        "swin_block", a, d, mode)
                    if kind == "f32":
                        want = (a.double() @ w32.double().t() + bias).float()
                    else:
                        want = ((a.float() @ d.wt.float().t()).to(dt).float()
                                + d.bias).to(dt)
                    plain = lambda: kswin.dense(a, d, False)  # noqa: E731
                    tol = 1e-5 if kind == "f32" else 2 ** -7
                    wl = d.wt.t()
                    bl = bias.to(dt)
                    lib_ms = cuda_ms(torch, lambda: torch.addmm(bl, a, wl), 10)
                    ops = 2.0 * m0 * n * k / PEAK[
                        "tf32x3" if kind == "f32" else "bf16"]
                    esz = 4 if kind == "f32" else 2
                kb.reset_launches()
                got = run()
                err = float((got.float() - want.float()).abs().max())
                top = float(want.float().abs().max())
                del got, want
                ms_k = cuda_ms(torch, run, 10)
                ms_p = cuda_ms(torch, plain, 3)
                out_esz = 4 if kind == "f32" else 2
                byts = m0 * k * esz + n * k * esz + m0 * n * out_esz
                inst = {"bf16": "gemm_bf16", "int8": "gemm_s8_bf16",
                        "f32": "gemm_f32_3xtf32"}[kind] + "_ntail"
                record("gemm" + sfx, "mask_bev_tpu_torch/csrc/gemm_ntail.cu",
                       "mask_bev_tpu/ops/pallas_swin_block.py:584", err,
                       tol * top, ms_k, ms_p, bound(byts, ops),
                       f"({m0} x {k}) . ({k} x {n}) {kind}, A at a pitch of "
                       f"{a.stride(0)} values, bias epilogue; library "
                       + ("torch._int_mm (the product only)" if kind == "int8"
                          else "torch.addmm"), library_ms=lib_ms)
                launched(kb, results, failures, "gemm" + sfx,
                         "swin_block/" + inst)
                del a, d
            del a32, w32, bias

        # ---- the attention at head widths 8, 24, 40, 48 and 56 ----------
        for hd, heads in ((8, 9), (24, 8), (40, 3), (48, 4), (56, 3)):
            c = hd * heads
            # 8 and 40 are served at window 10 (.hd8, .hd40); window 7 is
            # the instance of 8 warps, held at 8 and 48 in both variants;
            # window 12 is the long-window kernel, held at 24, 48 and 56
            wins = {8: (10, 7), 40: (10,), 48: (10, 7, 12)}.get(hd, (10, 12))
            for win, msa in [(w, m) for w in wins
                             for m in ((False, True) if w == 7 else (False,))]:
                for dt in (torch.bfloat16, torch.float32):
                    f32 = dt == torch.float32
                    what = "window_msa" if msa else "swin_block"
                    name = ("window_msa_attn" if msa else "swin_attn") + (
                        f".hd{hd}.w{win}" + (".f32" if f32 else ""))
                    qkv = torch.randn(m0, 3 * c, generator=g).to(dev, dt)
                    qb = (0.1 * torch.randn(3 * c, generator=g)).to(dev)
                    table = (0.02 * torch.randn((2 * win - 1) ** 2, heads,
                                                generator=g)).to(dev, dt)
                    rel = kswin.rel_bias_from_table(table, win)
                    shift = kswin.effective_shift(hw0, win, True)
                    kb.reset_launches()
                    attn_phase(torch, kswin, record, name,
                               "mask_bev_tpu/ops/pallas_window_msa.py:71"
                               if msa else
                               "mask_bev_tpu/ops/pallas_swin_block.py:584",
                               [(qkv, qb, rel, BATCH, hw0, heads, win,
                                 shift)], msa, f32, card)
                    launched(kb, results, failures, name, what + "/"
                             + kswin.attn_instance(f32, win, hd))
                    del qkv, qb, rel

        # ---- kernel 7 at head width 8 (C 72, 9 heads) --------------------
        c, heads, win = 72, 9, 10
        blk = SwinBlock(c, heads, win, shift=True)
        blk.attn.w_msa.rel_pos_bias_table.normal_(0.0, 0.02, generator=g)
        p = blk.to(dev, torch.bfloat16).eval().weights()
        y = torch.randn(BATCH, m0 // BATCH, c, generator=g).to(
            dev, torch.bfloat16)
        shift = kswin.effective_shift(hw0, win, True)
        kb.reset_launches()
        window_msa_phase(torch, record, card, ".hd8",
                         [((y, hw0, win, shift, p.rel_bias, p.qkv, p.proj,
                            heads), {})], False, what="a block drawn at "
                         "head width 8")
        results["window_msa.hd8"]["launches"] = kb.LAUNCHES["window_msa"]
        launched(kb, results, failures, "window_msa_attn.hd8",
                 "window_msa/" + kswin.attn_instance(False, win, 8))
        del blk, p, y
    torch.cuda.empty_cache()


def shapes_audit_phase(np, torch, card, results, failures, record) -> None:
    """``[shapes audit]``: the refusal audit's entries 1 and 3 served at
    full width and batch 8 (bf16, int8 backbone products), each row's
    kernels held against their plain versions on inputs captured in one
    forward, then 1 warm and 2 timed requests with the instance counters
    and one traced request: ``.u100`` path E with PFN layers of 64, 64 and
    100 units (kernel 10 at units that are not a multiple of 8, its table
    100 channels wide; kernel 2 at C 100), ``.hd96`` heads (2, 4, 8, 16)
    at embed 192 (head width 96 at every stage: the ring kernel),
    ``.w24`` window 24 (576 tokens: the streaming kernel). Then the
    kernel-level holds (``audit_kernel_holds``)."""
    from mask_bev_tpu_torch.config import semantic_kitti_default

    base = semantic_kitti_default().replace(
        max_points_per_scan=131072, pseudo_image_norm="full",
        compute_dtype="bfloat16")
    path_phase(np, torch, card, results, failures, record, "E",
               overrides=U100, tag=".u100", requests=TAIL_REQUESTS)
    serve_phase(np, torch, card, results, failures, record,
                base.replace(**HD96), ".hd96", *TAIL_REQUESTS)
    serve_phase(np, torch, card, results, failures, record,
                base.replace(**W24), ".w24", *TAIL_REQUESTS)
    rest_row(np, torch, card, results, failures, record, base)
    audit_kernel_holds(np, torch, card, results, failures, record)
    rest_kernel_holds(np, torch, card, results, failures, record)


def rest_row(np, torch, card, results, failures, record, base) -> None:
    """``.rest``: ``base`` with the audit's last entries (``REST``) served
    on long-pillar scans like the other rows; the requests' instance
    counters must show kernel 1's layered route, kernel 8's padded
    instance of width 96 and the split decoder's padded instance."""
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.ops import decoder_stack as kdec
    from mask_bev_tpu_torch.ops import patch_embed as kpe
    from mask_bev_tpu_torch.ops import pfn as kpfn

    cfg = base.replace(**REST)
    serve_phase(np, torch, card, results, failures, record, cfg, ".rest",
                *TAIL_REQUESTS, points=scans_long)
    need = ["pfn/" + kpfn.layered_instance(False),
            "patch_embed/" + kpe.instance(False, cfg.backbone_embed_dim),
            "decoder_stack/" + kdec.split_instance(
                cfg.num_queries, cfg.head_num_attn_heads, False,
                cfg.head_feat_channels, cfg.head_ffn_dim)]
    got = {k: kb.INSTANCES.get(k, 0) for k in need}
    print(f"[e2e rest] the audit's new instances over the requests: {got} "
          f"[{card}]", flush=True)
    missing = [k for k, v in got.items() if v <= 0]
    if missing:
        failures.append(f"[e2e rest] never launched: {missing}")


def audit_kernel_holds(np, torch, card, results, failures, record,
                       dev="cuda") -> None:
    """The audit's instances no served row reaches, held against their
    plain versions at their flagship instances' tolerances and timed beside
    one library call where one computes the same function: the window
    attention (Swin variant, shifted) at head widths 72-128 over 2 heads
    at window 10 on the stage-0 grid (8 x 125^2: the ring kernel in bf16,
    the head-width kernel in f32) and at window 24 on the stage-1 grid (8 x
    63^2: the streaming kernel), bf16 and f32, and the MSA variant at head
    widths 72 and 128 (window 10 in bf16, window 24 in bf16 and f32),
    beside SDPA (event and device times); kernel 1 at one
    layer of 256 units (the wide instance) and at 8 layers of 32 units,
    bf16 and f32 (f32 against float64 within 1e-5; bf16 within 2^-7 of the
    largest value at one layer, as the flagship, and 1e-2 at 8 layers:
    each of the 8 layers rounds to bf16 values the tensor cores summed in
    another order, and a step moves every later layer.
    ``scripts/pfn_layers_bound.py``, with the batch norms drawn, read
    0.0032-0.0083 over 18 draws of weights and scans on the H100, and 0.052
    for the planted fault of a layer's folded affine dropped; the bound sits
    between the two; a last layer's scale off by 2^-6, 0.0094, is within
    the draws' spread, and no bound tells it apart), and kernel 10 at 256
    units in bf16, on the main path's scans, the encoders' weights and
    batch norms (``draw_pfn_norms``) drawn from a seed."""
    from mask_bev_tpu_torch.config import semantic_kitti_default
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.ops import swin_block as kswin

    cfg = semantic_kitti_default().replace(max_points_per_scan=131072)
    gh, gw = cfg.grid_hw
    hw0 = (gh // 4, gw // 4)
    hw1 = (-(-hw0[0] // 2), -(-hw0[1] // 2))
    g = torch.Generator().manual_seed(95)
    with torch.no_grad():
        # ---- the attention at head widths 72-128, windows 10 and 24 -------
        # (Swin at every width; the MSA variant's instances at 72 and 128:
        # the ring kernel in bf16 at window 10, the streaming kernel at 24)
        holds = [(hd, win, hw, dt, False) for hd in kswin.ATTN_WIDE_DIMS
                 for win, hw in ((10, hw0), (24, hw1))
                 for dt in (torch.bfloat16, torch.float32)]
        holds += [(hd, win, hw, dt, True) for hd in (72, 128)
                  for win, hw in ((10, hw0), (24, hw1))
                  for dt in (torch.bfloat16, torch.float32)
                  if win == 24 or dt == torch.bfloat16]
        # (qkv drawn on the device: up to 96 M values a hold, which the
        # host's generator took seconds to draw)
        gd = torch.Generator(device=dev).manual_seed(96)
        for hd, win, hw, dt, msa in holds:
            heads = 2
            c = hd * heads
            f32 = dt == torch.float32
            kname = "window_msa" if msa else "swin_block"
            name = (f"{'window_msa' if msa else 'swin'}_attn.hd{hd}.w{win}"
                    + (".f32" if f32 else ""))
            qkv = torch.randn(BATCH * hw[0] * hw[1], 3 * c, generator=gd,
                              device=dev).to(dt)
            qb = (0.1 * torch.randn(3 * c, generator=g)).to(dev)
            table = (0.02 * torch.randn((2 * win - 1) ** 2, heads,
                                        generator=g)).to(dev, dt)
            rel = kswin.rel_bias_from_table(table, win)
            shift = kswin.effective_shift(hw, win, True)
            kb.reset_launches()
            attn_phase(torch, kswin, record, name,
                       "mask_bev_tpu/ops/pallas_window_msa.py:71" if msa else
                       "mask_bev_tpu/ops/pallas_swin_block.py:584",
                       [(qkv, qb, rel, BATCH, hw, heads, win, shift)], msa,
                       f32, card)
            launched(kb, results, failures, name,
                     f"{kname}/" + kswin.attn_instance(f32, win, hd))
            del qkv, qb, rel

        # ---- kernels 1 and 10 at 256 units and at 8 layers ---------------
        scans_np = scans(np, BATCH, cfg.max_points_per_scan, SEED + 95)
        for label, fc in (("u256", (256,)), ("l8", (64,) * 7 + (32,))):
            for f32 in (False, True):
                encoder_holds(
                    np, torch, card, results, failures, record, cfg,
                    label, cfg.max_num_points, fc, scans_np, f32,
                    2 ** -7 if len(fc) == 1 else 1e-2, layered=False,
                    stream=label == "u256" and not f32)
    torch.cuda.empty_cache()


def encoder_holds(np, torch, card, results, failures, record, cfg, label,
                  k, fc, scans_np, f32, tol, layered, stream,
                  seeds=(SEED + 96, SEED + 97), count_cells=False,
                  dev="cuda") -> None:
    """Kernel 1 on an encoder of ``fc`` feat channels at ``k`` points a
    pillar (its weights from ``seeds[0]``, its batch norms drawn from
    ``seeds[1]``, ``draw_pfn_norms``) on the batch ``scans_np``, held
    against its plain version (bf16 within ``tol`` of the largest value;
    f32 within 1e-5 of float64; statistics 1e-3) and timed, recorded as
    ``pfn.<label>``; with ``stream``, kernel 10 on the capped stream of the
    same scans (bf16 within 1e-2, its flagship's), as ``stream_pfn.<label>``.
    Each must have launched the layered route's instance (``layered``) or
    the tiles'. ``count_cells``: the cells of over 128, 256 and 1024 points
    are printed and each count must be positive."""
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.models.encoder import MaskBevEncoder
    from mask_bev_tpu_torch.ops import pfn as kpfn

    dt = torch.float32 if f32 else torch.bfloat16
    sfx = f".{label}" + (".f32" if f32 else "")
    esz = 4 if f32 else 2
    prod = PEAK["tf32x3" if f32 else "bf16"]
    torch.manual_seed(seeds[0])
    enc = MaskBevEncoder(
        cfg.x_range, cfg.y_range, cfg.z_range, cfg.voxel_size,
        feat_channels=fc, max_points_per_pillar=k,
        max_pillars=cfg.max_num_pillars)
    draw_pfn_norms(torch, enc, seeds[1])
    enc = enc.to(dev, dt).eval()
    pts = torch.as_tensor(scans_np[0]).to(dev, dt)
    msk = torch.as_tensor(scans_np[1]).to(dev)
    net = enc.pillar_feature_net
    weights, packed = enc._weights(pts.device)
    kw = dict(with_distance=net.with_distance, grid_w=enc.grid_hw[1],
              voxel_size=enc.voxel_size, x0=enc.x_range[0],
              y0=enc.y_range[0])
    shapes = [tuple(w_.shape) for (w_, _, _) in weights]
    macs = sum(a * b for a, b in shapes)
    route = kpfn.route(k, shapes, dt)[0]

    def inst(name):
        return name + "/" + (kpfn.layered_instance(f32) if layered else
                             kpfn.instance(f32, k, kpfn.is_wide(shapes)))

    def errors(table, stats, want, wstats, rows=None):
        d = (table.double() - want.double()).abs()
        big = want.double().abs()
        if rows is not None:
            d, big = d[rows], big[rows]
        st_err = float(((stats.double() - wstats.double()).abs()
                        / wstats.double().abs().clamp(min=1)).max())
        return float(d.max()), float(big.max()), st_err

    kb.reset_launches()
    ps, table, stats = enc.pillar_table(pts, msk)
    if count_cells:
        n_pts = cell_counts(torch, ps.pid, enc.grid_hw[0] * enc.grid_hw[1])
        over = {m: int((n_pts > m).sum()) for m in (128, 256, 1024)}
        print(f"[shapes audit pfn] long-pillar scans: cells of more than "
              f"128 / 256 / 1024 points {over} of {n_pts.numel()} [{card}]",
              flush=True)
        if min(over.values()) <= 0:
            failures.append(f"[pfn{sfx}] a count of long cells is 0: "
                            f"{over}")
    want, wstats = kpfn.pfn_plain(ps, weights, point_dim=net.point_dim,
                                  out_dtype=torch.float64 if f32 else dt,
                                  **kw)
    n_pil = ps.num_pillars.long()
    rows = (torch.arange(table.shape[1], device=dev)[None]
            < n_pil[:, None])
    err, scale, st_err = errors(table, stats, want, wstats, rows)
    del want
    ms_k = cuda_ms(torch, lambda: kpfn.pfn(
        ps, weights, point_dim=net.point_dim, max_points_per_pillar=k,
        out_dtype=dt, packed=packed, **kw), 5)
    ms_p = cuda_ms(torch, lambda: kpfn.pfn_plain(
        ps, weights, point_dim=net.point_dim, out_dtype=dt, **kw), 2)
    kept = float(ps.counts.sum())
    byts = (BATCH * cfg.max_points_per_scan * 16
            + float(n_pil.sum()) * (12 + table.shape[-1] * esz))
    record("pfn" + sfx, *SOURCES["pfn"], err, (1e-5 if f32 else tol) * scale,
           ms_k, ms_p, bound(byts, 2 * kept * macs / prod),
           f"{k} points a pillar, layers {shapes}"
           + (" against float64" if f32 else "")
           + f"; pillars {int(n_pil.sum())}, of more than 128 kept points "
           f"{int((ps.counts > 128).sum())}, kept points {int(kept)}; the "
           f"tiles {'at K ' + str(route) if route else 'not run'}; stats rel "
           f"err {st_err:.3g} (tolerance 1e-3)")
    if st_err > 1e-3:
        failures.append(f"pfn{sfx}: stats")
    launched(kb, results, failures, "pfn" + sfx, inst("pfn"))
    del ps, table
    if stream:
        kb.reset_launches()
        sp, table, stats, nv = enc.capped_table(pts, msk)
        want, wstats = kpfn.stream_pfn_plain(
            sp, weights, k=k, out_dtype=torch.float64 if f32 else dt, **kw)
        err, scale, st_err = errors(table, stats, want, wstats)
        del want
        ms_k = cuda_ms(torch, lambda: kpfn.stream_pfn(
            sp, weights, k=k, out_dtype=dt, num_valid=nv, packed=packed,
            **kw), 5)
        ms_p = cuda_ms(torch, lambda: kpfn.stream_pfn_plain(
            sp, weights, k=k, out_dtype=dt, **kw), 2)
        b_, n_, d_ = sp.pts.shape
        p_, c_ = table.shape[1], table.shape[2]
        byts = b_ * n_ * (d_ * esz + 4 + 1) + b_ * p_ * (8 + c_ * esz + 8)
        record("stream_pfn" + sfx, "mask_bev_tpu_torch/csrc/pfn.cu",
               "mask_bev_tpu/ops/pallas_pfn.py:168", err,
               (1e-5 if f32 else 1e-2) * scale, ms_k, ms_p,
               bound(byts, 2 * float(sp.kept.sum()) * macs / prod),
               f"{k} points a pillar, layers {shapes}, {p_} slots (occupied "
               f"{nv.tolist()})" + (", against float64" if f32 else "")
               + f"; stats rel err {st_err:.3g} (tolerance 1e-3)")
        if st_err > 1e-3:
            failures.append(f"stream_pfn{sfx}: stats")
        launched(kb, results, failures, "stream_pfn" + sfx,
                 inst("stream_pfn"))
        del sp, table


def draw_pfn_norms(torch, enc, seed) -> None:
    """Draw ``enc``'s PFN batch norms from ``seed`` at a trained model's
    scales (running variance 0.5-1.5, mean 0.05 N(0, 1), scale 1 + 0.1
    N(0, 1), bias 0.05 N(0, 1)), so that every layer's folded affine is
    far from the identity a fresh norm folds to: a fault in it shows."""
    g = torch.Generator().manual_seed(seed)
    net = enc.pillar_feature_net
    with torch.no_grad():
        for i in range(net.num_layers):
            bn = getattr(net, f"pfn_{i}").norm
            u = bn.weight.shape[0]
            bn.running_var.copy_(0.5 + torch.rand(u, generator=g))
            bn.running_mean.copy_(0.05 * torch.randn(u, generator=g))
            bn.weight.copy_(1 + 0.1 * torch.randn(u, generator=g))
            bn.bias.copy_(0.05 * torch.randn(u, generator=g))


def cell_counts(torch, ps_pid, sentinel):
    """Points a cell of each sample's sorted pids (its run lengths), the
    sentinel's dropped points left out."""
    counts = []
    for row in ps_pid:
        _, n = torch.unique_consecutive(row[row < sentinel],
                                        return_counts=True)
        counts.append(n)
    return torch.cat(counts)


def rest_kernel_holds(np, torch, card, results, failures, record,
                      dev="cuda") -> None:
    """The audit's last entries at the kernel level, each held against its
    plain version at its flagship instance's tolerance and timed:
    kernel 8 at E 72, 120 and 168 (padded to 96, 128 and 192) on the main
    path's 8 x 500^2 x 128 canvas, bf16 and f32 (``patch_embed_hold``,
    ``F.conv2d`` alone beside it); kernels 1 and 10 at 129, 256 and 1024
    points a pillar on long-pillar scans (``scans_long``: the tiles for
    the pillars of up to 128 kept points, the layered route for the
    longer; the cells of over 128, 256 and 1024 points counted, none of
    them 0) and kernel 1 at two layers of 256 units on the main path's
    scans (the layered route alone; feat channels 512 and 256), bf16 and
    f32 (``encoder_holds``: kernel 1 bf16 within 2^-7 of the largest
    value, kernel 10 bf16 within 1e-2, f32 within 1e-5 of float64;
    statistics 1e-3; the batch norms drawn from a seed); the decoder's split instance at Q 45 at C
    96 over 8 heads (head width 12), C 192 over 6 heads and C 96 over one,
    FFN 2048, bf16 and f32 (``decoder_hold``), on the arguments one
    forward of the main path's configuration so changed passes it in each
    dtype."""
    from mask_bev_tpu_torch.config import semantic_kitti_default
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.ops import decoder_stack as kdec
    from mask_bev_tpu_torch.ops import patch_embed as kpe

    bf16 = torch.bfloat16
    cfg = semantic_kitti_default().replace(max_points_per_scan=131072)
    gh, gw = cfg.grid_hw
    with torch.no_grad():
        # ---- kernel 8 at E 72, 120, 168 -----------------------------------
        g = torch.Generator().manual_seed(73)
        for e in (72, 120, 168):
            for dt in (bf16, torch.float32):
                f32 = dt == torch.float32
                sfx = f".e{e}" + (".f32" if f32 else "")
                canvas = torch.randn(BATCH, gh, gw, 128, generator=g).to(
                    dev, dt)
                wm = (torch.randn(e, 4 * 4 * 128, generator=g)
                      / 2048 ** 0.5).to(dev, dt)
                vecs = [(base_ + 0.1 * torch.randn(e, generator=g)).to(dev,
                                                                      dt)
                        for base_ in (0.0, 1.0, 0.0)]
                kb.reset_launches()
                patch_embed_hold(torch, record, sfx,
                                 (canvas, wm, *vecs, 4, 1e-6), {}, f32)
                launched(kb, results, failures, "patch_embed" + sfx,
                         "patch_embed/" + kpe.instance(f32, e))
                del canvas, wm, vecs
        torch.cuda.empty_cache()

        # ---- kernels 1 and 10 past 128 points a pillar, and at 256 x 2 ----
        long_np = scans_long(np, BATCH, cfg.max_points_per_scan, SEED + 98)
        main_np = scans(np, BATCH, cfg.max_points_per_scan, SEED + 95)
        # two layers of 256 units (feat channels 512, 256: a layer before
        # the last has half its channels' units)
        cases = [(f"k{k}", k, tuple(cfg.encoder_feat_channels), long_np)
                 for k in (129, 256, 1024)]
        cases.append(("u256x2", cfg.max_num_points, (512, 256), main_np))
        for label, k, fc, scans_np in cases:
            for f32 in (False, True):
                encoder_holds(
                    np, torch, card, results, failures, record, cfg, label,
                    k, fc, scans_np, f32, 2 ** -7, layered=True,
                    stream=label != "u256x2", seeds=(SEED + 99, SEED + 100),
                    count_cells=label == "k1024" and not f32)
        torch.cuda.empty_cache()

        # ---- kernel 5's split instance at padded widths --------------------
        for tag, c, heads in ((".c96", 96, 8), (".heads6", 192, 6),
                              (".c96h1", 96, 1)):
            for f32 in (False, True):
                sfx = tag + (".f32" if f32 else "")
                dcfg = cfg.replace(
                    head_feat_channels=c, head_out_channels=c,
                    head_num_attn_heads=heads,
                    **({} if f32 else dict(pseudo_image_norm="full",
                                           compute_dtype="bfloat16")))
                dargs, dkw = decoder_call(np, torch, dcfg,
                                          SEED + 110 + heads)
                kb.reset_launches()
                decoder_hold(torch, record, failures, card, dargs, dkw, f32,
                             sfx, "shapes audit" + sfx.replace(".", " "))
                launched(kb, results, failures, "decoder_stack" + sfx,
                         "decoder_stack/" + kdec.split_instance(
                             dcfg.num_queries, heads, f32, c,
                             dcfg.head_ffn_dim))
                del dargs
    torch.cuda.empty_cache()


# ``[shapes last]``: the refusal audit's decoder and attention entries,
# served at full width: ``.emb128`` the main path with a mask embedding of
# 128 columns (the flagship decoder instance, the embedding zero-padded to
# C 256); ``.audit2`` two decoder heads of 128 and a mask embedding of 384
# columns (the split instance: a head a round, the embedding wider than C in
# device memory) over a backbone of embed 144 and (1, 8, 16, 32) heads
# (head width 144 at stage 0: the streaming attention staged at 256; 36 at
# stages 1-3, padded to 40)
EMB128 = dict(head_out_channels=128)
AUDIT2 = dict(head_num_attn_heads=2, head_out_channels=384,
              backbone_embed_dim=144, backbone_num_heads=(1, 8, 16, 32))
LAST_REQUESTS = (2, 3)
# the decoder's memories on the main path's 500 x 500 grid: /32, /16, /8
LEVEL_TOKENS = (16 * 16, 32 * 32, 63 * 63)


def shapes_last_phase(np, torch, card, results, failures, record) -> None:
    """``[shapes last]``: ``.emb128`` and ``.audit2`` served at batch 8
    (bf16, int8 backbone products), each row's kernels held against their
    plain versions on inputs captured in one forward, then 2 warm and 3
    timed requests with the instance counters (which must show the new
    instances) and one traced request; then the kernel-level holds
    (``last_kernel_holds``)."""
    last_rows(np, torch, card, results, failures, record)
    last_kernel_holds(np, torch, card, results, failures, record)


def last_rows(np, torch, card, results, failures, record) -> None:
    """``.emb128`` and ``.audit2`` through ``serve_phase``; the requests'
    counters must show the flagship decoder at D < C (``.emb128``), the
    split decoder at head width 128 with the wide embedding, the streaming
    attention at head width 144 and the padded attention at 36
    (``.audit2``)."""
    from mask_bev_tpu_torch.config import semantic_kitti_default
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.ops import decoder_stack as kdec
    from mask_bev_tpu_torch.ops import swin_block as kswin

    base = semantic_kitti_default().replace(
        max_points_per_scan=131072, pseudo_image_norm="full",
        compute_dtype="bfloat16")
    for tag, over in ((".emb128", EMB128), (".audit2", AUDIT2)):
        cfg = base.replace(**over)
        serve_phase(np, torch, card, results, failures, record, cfg, tag,
                    *LAST_REQUESTS)
        if tag == ".emb128":
            need = ["decoder_stack/flagship_embpad"]
        else:
            c, heads = cfg.head_feat_channels, cfg.head_num_attn_heads
            need = ["decoder_stack/" + kdec.split_instance(
                cfg.num_queries, heads, False, c, cfg.head_ffn_dim,
                max(LEVEL_TOKENS), cfg.head_out_channels)]
            need += sorted({"swin_block/" + kswin.attn_instance(
                False, cfg.backbone_window_size,
                cfg.backbone_embed_dim * 2 ** i // h)
                for i, h in enumerate(cfg.backbone_num_heads)})
        got = {k: kb.INSTANCES.get(k, 0) for k in need}
        print(f"[e2e {tag[1:]}] the new instances over the requests: {got} "
              f"[{card}]", flush=True)
        missing = [k for k, v in got.items() if v <= 0]
        if missing:
            failures.append(f"[e2e {tag[1:]}] never launched: {missing}")


def synth_decoder(torch, q, c, heads, d, f32, seed, ffn=2048):
    """Decoder-stack arguments (args, keywords) drawn on the device from
    ``seed``: batch 8, ``q`` queries, C ``c`` over ``heads`` heads, a mask
    embedding of ``d`` columns, an FFN of ``ffn`` units, 9 layers over the
    main path's three memory levels (``LEVEL_TOKENS``); weights scaled by
    1 / sqrt(fan-in), LN scales near 1, the initial embedding the mask MLP
    of the queries (``mask_embed``), as a forward computes it."""
    from mask_bev_tpu_torch.ops import decoder_stack as kdec

    dev = "cuda"
    dt = torch.float32 if f32 else torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, s=1.0, base=0.0):
        return base + s * torch.randn(*shape, generator=g, device=dev)

    def mat(k, n):
        return rn(k, n, s=k ** -0.5).to(dt)

    def vec(n, base=0.0):
        return rn(n, s=0.1, base=base).to(dt).float()

    layers = []
    for _ in range(9):
        w = {}
        for nm in kdec.LayerWeights._fields:
            if nm == "f1":
                w[nm] = mat(c, ffn)
            elif nm == "f2":
                w[nm] = mat(ffn, c)
            elif nm == "fb1":
                w[nm] = vec(ffn)
            elif nm in ("n1w", "n2w", "n3w"):
                w[nm] = vec(c, 1.0)
            elif nm[0] in "ws" and len(nm) == 2:
                w[nm] = mat(c, c)
            else:
                w[nm] = vec(c)
        layers.append(kdec.LayerWeights(**w))
    head = kdec.HeadWeights(vec(c, 1.0), vec(c), mat(c, c), vec(c),
                            mat(c, c), vec(c), mat(c, d), vec(d))
    out0 = rn(BATCH, q, c).to(dt)
    mems = [rn(BATCH, t, c).to(dt) for t in LEVEL_TOKENS]
    pes = [rn(t, c, s=0.5).to(dt) for t in LEVEL_TOKENS]
    feats = [rn(BATCH, t, d) for t in LEVEL_TOKENS]
    emb0 = kdec.mask_embed(out0.float(), head, dt)
    return ((out0, emb0, rn(q, c).to(dt), mems, pes, feats, layers, head),
            {"num_heads": heads})


def last_kernel_holds(np, torch, card, results, failures, record,
                      dev="cuda") -> None:
    """The audit's decoder and attention instances no served row reaches,
    each held against its plain version at its flagship instance's
    tolerance and timed, bf16 and f32: the split decoder (``decoder_hold``
    on one forward's arguments, ``decoder_call``, of the main path's
    configuration at Q 45 unless named, C 256 over 8 heads, an FFN of 2048;
    at C 2048 on ``synth_decoder``'s) at Q 513 and 1024
    (the rows in the device-memory workspace, 33 and 64 a block), 2 heads
    of 128, 8 heads of 256 (C 2048), one head of C 384 (padded to 512) and
    512, and a mask embedding of D 1, 64, 257 and 512 (bf16 at D <= C: the
    flagship instance, zero-padded to C; else the split instance); the
    window attention, Swin and MSA variants, shifted, beside SDPA (event
    and device times), at head widths 12, 36, 100 (padded to 16, 40, 104),
    136, 192 and 256 (the streaming kernel at 256) over 2 heads at window
    10 on the stage-0 grid (8 x 125^2), and at windows 25 and 32 at head
    widths 32 and 64 on the stage-1 grid (8 x 63^2, ``.w24``'s)."""
    from mask_bev_tpu_torch.config import semantic_kitti_default
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.ops import decoder_stack as kdec
    from mask_bev_tpu_torch.ops import swin_block as kswin

    base = semantic_kitti_default().replace(max_points_per_scan=131072)
    with torch.no_grad():
        # ---- kernel 5: queries, head widths, embedding widths -------------
        cases = [(".q513", 513, 256, 8, 256), (".q1024", 1024, 256, 8, 256),
                 (".h2x128", 45, 256, 2, 256),
                 (".h8x256", 45, 2048, 8, 2048),
                 (".c384h1", 45, 384, 1, 384), (".c512h1", 45, 512, 1, 512)]
        cases += [(f".d{d}", 45, 256, 8, d) for d in (1, 64, 257, 512)]
        for i, (tag, q, c, heads, d) in enumerate(cases):
            for f32 in (False, True):
                sfx = tag + (".f32" if f32 else "")
                dcfg = base.replace(
                    num_queries=q, head_feat_channels=c,
                    head_out_channels=d, head_num_attn_heads=heads,
                    **({} if f32 else dict(pseudo_image_norm="full",
                                           compute_dtype="bfloat16")))
                # one forward's arguments; C 2048 drawn (its model's pixel
                # decoder at 2048 channels would cost more than the hold)
                seed = SEED + 130 + i
                dargs, dkw = (synth_decoder(torch, q, c, heads, d, f32, seed)
                              if c > 512 else
                              decoder_call(np, torch, dcfg, seed))
                kb.reset_launches()
                decoder_hold(torch, record, failures, card, dargs, dkw, f32,
                             sfx, "shapes last" + sfx.replace(".", " "))
                t_max = max(LEVEL_TOKENS)
                inst = ("flagship" + ("_embpad" if d < c else "")
                        if kdec.flagship_takes(q, c, 2048, heads, 3, 9,
                                               t_max, dargs[0].dtype, d)
                        else kdec.split_instance(q, heads, f32, c, 2048,
                                                 t_max, d))
                launched(kb, results, failures, "decoder_stack" + sfx,
                         "decoder_stack/" + inst)
                del dargs
                torch.cuda.empty_cache()

        # ---- the window attention: head widths 1-256, windows to 32 ------
        cfg = semantic_kitti_default()
        gh, gw = cfg.grid_hw
        hw0 = (gh // 4, gw // 4)
        hw1 = (-(-hw0[0] // 2), -(-hw0[1] // 2))
        holds = [(hd, 10, hw0) for hd in (12, 36, 100, 136, 192, 256)]
        holds += [(hd, win, hw1) for win in (25, 32) for hd in (32, 64)]
        g = torch.Generator().manual_seed(140)
        gd = torch.Generator(device=dev).manual_seed(141)
        for hd, win, hw in holds:
            for msa in (False, True):
                for dt in (torch.bfloat16, torch.float32):
                    heads = 2
                    c = hd * heads
                    f32 = dt == torch.float32
                    kname = "window_msa" if msa else "swin_block"
                    name = (f"{'window_msa' if msa else 'swin'}_attn.hd{hd}"
                            f".w{win}" + (".f32" if f32 else ""))
                    qkv = torch.randn(BATCH * hw[0] * hw[1], 3 * c,
                                      generator=gd, device=dev).to(dt)
                    qb = (0.1 * torch.randn(3 * c, generator=g)).to(dev)
                    table = (0.02 * torch.randn((2 * win - 1) ** 2, heads,
                                                generator=g)).to(dev, dt)
                    rel = kswin.rel_bias_from_table(table, win)
                    shift = kswin.effective_shift(hw, win, True)
                    kb.reset_launches()
                    attn_phase(torch, kswin, record, name,
                               "mask_bev_tpu/ops/pallas_window_msa.py:71"
                               if msa else
                               "mask_bev_tpu/ops/pallas_swin_block.py:584",
                               [(qkv, qb, rel, BATCH, hw, heads, win,
                                 shift)], msa, f32, card)
                    launched(kb, results, failures, name,
                             f"{kname}/" + kswin.attn_instance(f32, win, hd))
                    del qkv, qb, rel
            torch.cuda.empty_cache()


def gemm_split(torch, kswin, a32, k) -> None:
    """The flagship GEMM instances (N % 8 == 0) at N 96 and 104 on the rows
    ``a32`` (M x K, at the N-tail rows' pitch), bias epilogue, bf16 / int8
    / 3xTF32: a small K's own cost beside the N-tail rows' times (N 100),
    printed, not recorded."""
    parts = []
    g = torch.Generator().manual_seed(k)
    for kind in ("bf16", "int8", "f32"):
        dt = torch.float32 if kind == "f32" else torch.bfloat16
        ms = []
        for n in (96, 104):
            w = (torch.randn(n, k, generator=g) / k ** 0.5).to(a32.device)
            d = kswin.make_dense(w.to(dt), torch.zeros(n, device=a32.device),
                                 kind == "int8")
            if kind == "int8":
                q, sx = kswin.quant_rows(a32.to(dt))
                a = kswin.pitched(q.to(torch.int8))
                sx = sx.reshape(-1).contiguous()
                run = lambda: kswin.gemm(  # noqa: E731
                    "swin_block", a, d, kswin.EPI_BIAS, sx=sx)
            else:
                a = kswin.pitched(a32.to(dt))
                run = lambda: kswin.gemm(  # noqa: E731
                    "swin_block", a, d, kswin.EPI_BIAS)
            ms.append(cuda_ms(torch, run, 10))
            del a, d
        parts.append(f"{kind} N 96 {ms[0]:.4f} ms, N 104 {ms[1]:.4f} ms")
    print(f"[gemm split] ({a32.shape[0]} x {k}) flagship instances: "
          + "; ".join(parts), flush=True)


def trainer_phase(np, torch, card, failures, here) -> None:
    """``Trainer.fit`` at the widths of ``configs/training/semantic_kitti/
    02_train_smoke_tpu.yml`` (bf16, AdamW, plateau, batch 4, 131072 point
    slots, a 128-channel PFN, Swin embed 192, 45 queries) on its synthetic
    scenes, cut to 2 training and 1 validation batch and one epoch; then
    the ``--test`` restore of ``best`` with a validation and
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
        limit_train_batches=2, limit_val_batches=1, max_epochs=1,
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
    n_steps = cfg.limit_train_batches * cfg.max_epochs
    index_ok = (index.get("last_step") == n_steps
                and index.get("last_epoch") == cfg.max_epochs - 1
                and isinstance(index.get("best_step"), int)
                and np.isfinite(index.get("best_val_loss") or np.nan)
                and set(index.get("last_meta", {})) >= {
                    "epoch", "plateau_scale", "early_stop_bad_epochs"})
    finite = (len(losses) == n_steps and np.isfinite(losses).all()
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
          f"{cfg.lr_schedulers_type}); {cfg.limit_train_batches} train + "
          f"{cfg.limit_val_batches} val batches x {cfg.max_epochs} epochs, "
          f"images off (no matplotlib on the card's machine): fit "
          f"{fit_s:.1f} s [{card}]", flush=True)
    print(f"[trainer] train step median {np.median(steps):.4f} s (of "
          f"{len(steps)}: {[round(x, 4) for x in steps]}); validation epoch "
          f"median {np.median(vals[:-1]):.4f} s ({[round(x, 4) for x in vals]}"
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
DATA_KITTI_FRAMES = (12, 8)
DATA_POINTS = 120_000
# converted Waymo frames (training, of which the first are training/) and
# TOP-lidar points a frame (within 12 %: 150-190k of 196608 slots)
DATA_WAYMO_FRAMES = (12, 8)
DATA_WAYMO_POINTS = 170_000
DATA_WORKERS = 4
# the fits' cuts: (training batches, validation batches) of one epoch (cut
# from (3, 2) and (3, 1) when [shapes audit] came, and from (2, 1) when
# `.rest` came, to keep the script within ~1000 s of its 1200: the host's
# metrics of a training epoch cost as much again as its steps, and the
# steady step is [train]'s and [trainer]'s measurement)
DATA_LIMITS = {"semantic_kitti": (1, 1), "kitti": (1, 1), "waymo": (1, 1)}
DATA_YML = {"semantic_kitti": "semantic_kitti/01_semantic_kitti.yml",
            "kitti": "kitti/01_kitti.yml", "waymo": "waymo/01_waymo.yml"}


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
    instance ids), a KITTI tree (12 frames of about 120k points with
    8-15 Car, Pedestrian and Cyclist boxes, 8 train / 4 val, its
    ``samples.pkl``) and a converted Waymo root (12 frames, 8 training /
    4 validation, 150-190k x/y/z points out to 75 m, 20-80 vehicles, some
    outside the grid or without a lidar point, and pedestrians, signs and
    cyclists) from the seed (``datasets/disk_trees.py``), then: the C++
    host core against its numpy twins at 500x500 and 800x800, and the torch
    morphology on the card against the host core; host ms a sample
    (SemanticKITTI cache miss, hit, hit with the shipped augmentations;
    KITTI with ``object_sample`` and the other shipped transforms; Waymo
    with and without its shipped augmentations); one epoch's batches of
    each dataset with 0 and 4 worker processes, bitwise equal;
    ``Trainer.fit`` on ``01_semantic_kitti.yml``, ``01_kitti.yml`` and
    ``01_waymo.yml`` as shipped (f32, batch 4, Waymo with 170 queries; a
    batch the card cannot hold is cut and printed) with the ``--test``
    restore of ``best``, the matcher held against its plain version at
    Q = 170 after the Waymo fit; ``[eval]`` (``eval_phase``) on the KITTI
    fit's predictions; and the CLI ``train_mask_bev_torch.py --train
    --test`` on the SemanticKITTI tree."""
    import pickle
    import shutil
    import tempfile

    from mask_bev_tpu_torch.datasets.disk_trees import (
        write_kitti_tree, write_semantic_kitti_tree, write_waymo_tree)
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
        waymo = str(write_waymo_tree(
            os.path.join(tmp, "waymo"), seed=SEED,
            frames=DATA_WAYMO_FRAMES[0], train=DATA_WAYMO_FRAMES[1],
            points=DATA_WAYMO_POINTS))
        print(f"[data] trees written in {time.perf_counter() - t1:.2f} s: "
              f"SemanticKITTI sequences 00 ({DATA_SK_SCANS[0]} scans) and 08 "
              f"({DATA_SK_SCANS[1]}), KITTI {DATA_KITTI_FRAMES[0]} frames "
              f"({DATA_KITTI_FRAMES[1]} train), {DATA_POINTS} points a scan; "
              f"samples.pkl {n_bank} objects; Waymo {DATA_WAYMO_FRAMES[0]} "
              f"converted frames ({DATA_WAYMO_FRAMES[1]} training), about "
              f"{DATA_WAYMO_POINTS} points a frame", flush=True)
        trees = {"semantic_kitti": sk, "kitti": kitti, "waymo": waymo}
        data_host_core(np, torch, card, failures, sk)
        data_host_samples(np, card, here, sk, kitti)
        data_waymo_samples(np, card, here, waymo)
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
        data_epochs(np, card, failures, here, trees)
        preds = {}
        for dataset, tree in trees.items():
            t1 = time.perf_counter()
            preds[dataset] = data_fit(np, torch, card, failures, here,
                                      dataset, tree)
            print(f"[data] {dataset} fit phase {time.perf_counter() - t1:.1f}"
                  f" s [{card}]", flush=True)
        t1 = time.perf_counter()
        eval_phase(np, torch, card, failures, here, kitti, preds["kitti"])
        print(f"[eval] phase {time.perf_counter() - t1:.1f} s [{card}]",
              flush=True)
        data_cli(card, failures, here, sk, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def data_host_core(np, torch, card, failures, sk: str) -> None:
    """The host core's three entry points against their numpy twins on a
    SemanticKITTI-like mask and KITTI-like boxes, at 500x500 (0.16 m) and
    800x800 (0.1 m), with the median ms of each side; and the torch
    morphology (``ops/morphology.py::torch_close_then_open``, max pooling)
    on the card against the host core, bit for bit, with its CUDA-event
    ms."""
    from mask_bev_tpu_torch import native
    from mask_bev_tpu_torch.datasets.kitti.kitti_dataset import BoxArray
    from mask_bev_tpu_torch.datasets.kitti.kitti_rasterizer import (
        fill_rotated_boxes_img, points_in_boxes_count)
    from mask_bev_tpu_torch.ops.morphology import (
        close_then_open, torch_close_then_open)

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
        on_card = torch.as_tensor(mask, device="cuda")
        got = torch_close_then_open(on_card)
        ok_t = got.is_cuda and np.array_equal(got.cpu().numpy(),
                                              native.close_then_open(mask))
        ms_t = cuda_ms(torch, lambda: torch_close_then_open(on_card), 10)
        print(f"[data] torch close_then_open {hw}x{hw} on the card equal to "
              f"the host core {ok_t}: {ms_t:.4f} ms (the host core "
              f"{ms_m[0]:.3f} ms) -> {'ok' if ok_t else 'FAIL'} [{card}]",
              flush=True)
        if not ok_t:
            failures.append(f"[data] torch morphology on the card at "
                            f"{hw}x{hw}")
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


def data_waymo_samples(np, card, here, waymo: str) -> None:
    """Waymo host ms a sample (median of 8 training frames), with and
    without the shipped augmentations of ``01_waymo.yml``, and the GT
    instances each frame fills of the 170 queries."""
    from mask_bev_tpu_torch.datasets.waymo.waymo_data import WaymoDataModule

    cfg = data_cfg(here, "waymo", waymo)
    dm = WaymoDataModule(waymo, cfg)
    idx = list(range(8))
    filled = []
    plain = median_ms(lambda i: filled.append(int(dm.sample(
        dm.train_dataset, i, False)["num_instances"])), [(i,) for i in idx])
    with_aug = median_ms(lambda i: dm.sample(
        dm.train_dataset, i, True, np.random.default_rng([SEED, i])),
        [(i,) for i in idx])
    h, w = cfg.grid_hw
    print(f"[data] Waymo host ms a sample: {plain:.1f} without the shipped "
          f"augmentations, {with_aug:.1f} with them "
          f"({', '.join(a['name'] for a in cfg.augmentations)}; median of "
          f"8); GT instances of {cfg.num_queries} queries {filled}; GT "
          f"masks {cfg.num_queries * h * w / 1e6:.1f} MB a sample [{card}]",
          flush=True)


def data_epochs(np, card, failures, here, trees: dict) -> None:
    """One training epoch's batches of each data module with 0 and
    ``DATA_WORKERS`` worker processes: the two streams bitwise equal (a
    sha256 a batch), batches/s of each (the time spent waiting for the
    next batch)."""
    import hashlib
    import multiprocessing as mp

    from train_mask_bev_torch import build_datamodule

    for dataset, tree in trees.items():
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


def data_fit(np, torch, card, failures, here, dataset: str, tree: str):
    """``Trainer.fit`` on the shipped YAML (one epoch cut to
    ``DATA_LIMITS``, ``DATA_WORKERS`` workers, images off), then the
    ``--test`` restore of ``best`` with a validation. Times every step and
    validation (synchronised), the host-to-device copy of each batch, the
    step loop's wait on the prefetch; traces the training epoch for the
    card's idle share; counts the launches of kernels A, B, C and 1-3 (5
    is printed too: the eval step runs the decoder per layer, so it stays
    at 0). Waymo: the matcher's inputs of the first training step are
    captured and held against its plain version. KITTI: returns the
    restored model's predictions on the validation batches (class and mask
    probabilities, on the host) for ``[eval]``; otherwise None."""
    import gc
    import multiprocessing as mp
    import shutil
    import tempfile

    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.ops import hungarian as khung
    from mask_bev_tpu_torch.train import loop, step
    from train_mask_bev_torch import build_datamodule
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = data_cfg(here, dataset, tree)
    dm = build_datamodule(cfg, tree)
    rec = {"steps": [], "vals": [], "h2d": [], "wait": [], "losses": [],
           "busy": [], "wall": []}
    orig = (loop.train_step, loop.Trainer.validate, step._device_batch,
            loop.prefetch, loop.Trainer.train_epoch, khung.hungarian_rows)
    cap = {}

    def rec_hung(cost, n_rows):
        if "hung" not in cap:
            cap["hung"] = (cost.detach().clone(), n_rows.clone())
        return orig[5](cost, n_rows)

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
    if dataset == "waymo":
        khung.hungarian_rows = rec_hung
    cut = None
    preds = None
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
        if dataset == "kitti":
            preds = predictions(torch, tr.state, dm)
        tr.logger.close()
        del tr
        gc.collect()
    finally:
        (loop.train_step, loop.Trainer.validate, step._device_batch,
         loop.prefetch, loop.Trainer.train_epoch,
         khung.hungarian_rows) = orig
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    if dataset == "waymo":
        if "hung" in cap:
            matcher_check(torch, khung, cap["hung"], card, failures,
                          cfg.name)
        else:
            failures.append(f"[data] {cfg.name}: no matcher input captured")

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
    return preds


def matcher_check(torch, khung, captured, card, failures, name) -> None:
    """Kernel C on the (L * B, G, Q) problems of one training step against
    its plain version on four of them, one from each quarter of the head
    passes (on the host: the plain solve reads every loop condition, ~1.2 s
    a 170 x 170 problem): equal assignments; the kernel's CUDA-event ms for
    the step's problems and the plain version's seconds a problem."""
    cost, n_rows = captured
    n = cost.shape[0]
    held = sorted({0, n // 3, 2 * n // 3, n - 1})
    got = khung.hungarian_rows(cost, n_rows)[held].cpu()
    t1 = time.perf_counter()
    want = khung.hungarian_rows_plain(cost[held].cpu(), n_rows[held].cpu())
    plain_s = (time.perf_counter() - t1) / len(held)
    same = torch.equal(got, want)
    ms = cuda_ms(torch, lambda: khung.hungarian_rows(cost, n_rows), 5)
    print(f"[data] fit {name}: matcher (kernel C) on the first step's "
          f"{n} problems of {tuple(cost.shape[1:])} (rows assigned "
          f"{sorted(set(n_rows.tolist()))}): {ms:.3f} ms; problems {held} "
          f"equal to the plain version {same} (plain on the host "
          f"{plain_s:.3f} s a problem) -> {'ok' if same else 'FAIL'} "
          f"[{card}]", flush=True)
    if not same:
        failures.append(f"[data] {name}: the matcher differs from its plain "
                        f"version at {tuple(cost.shape)}")


def predictions(torch, state, dm) -> list:
    """(class probabilities, mask probabilities) of each validation batch,
    as numpy arrays, from ``predict_step`` on the card."""
    from mask_bev_tpu_torch.train.step import predict_step

    out = []
    for batch in dm.val_batches(0):
        cls, masks = predict_step(state, batch["points"],
                                  batch["point_mask"])
        out.append((cls.cpu().numpy(), masks.cpu().numpy()))
    return out


# the official KITTI eval timed at the full val split's scale (the frames of
# scripts/time_kitti_eval.py), and the rotated-IoU boxes held on the card
EVAL_FRAMES = 4071
EVAL_IOU_BOXES = (64, 64)


def eval_phase(np, torch, card, failures, here, kitti: str, preds) -> None:
    """``[eval]``: the KITTI fit's validation predictions (from the card)
    through ``mask_to_boxes`` and the official KITTI evaluation (bbox, bev,
    3d and, with orientations, aos) and its COCO sweep against the
    frames' labels; the official evaluation timed on the synthetic full
    split (``EVAL_FRAMES`` frames, car class); ``rotated_iou_matrix`` on
    the card against ``rotate_iou_eval`` on the host."""
    from mask_bev_tpu_torch.datasets.kitti.kitti_data import (
        KittiMaskDataModule, object_range_filter)
    from mask_bev_tpu_torch.datasets.kitti.kitti_dataset import KittiType
    from mask_bev_tpu_torch.evaluation.kitti_eval import (
        boxes_to_annos, get_coco_eval_result, get_official_eval_result,
        gt_boxes_to_annos, mask_to_boxes, synthetic_split)
    from mask_bev_tpu_torch.ops.rotated_iou import (
        rotate_iou_eval, rotated_iou_matrix)

    cfg = data_cfg(here, "kitti", kitti)
    dm = KittiMaskDataModule(kitti, cfg)
    frames = [object_range_filter(dm.dataset[i], cfg.x_range,
                                  cfg.y_range).boxes for i in dm.val_ids]
    gts = [gt_boxes_to_annos(
        bx.center, bx.dims, bx.yaw, [KittiType(int(t)).name for t in bx.types],
        occluded=bx.occluded, truncated=bx.truncated, bbox=bx.bbox)
        for bx in frames]
    cls = np.concatenate([c for c, _ in preds])
    masks = np.concatenate([m for _, m in preds])
    t1 = time.perf_counter()
    dts, n_dt = [], 0
    for b in range(len(cls)):
        boxes, scores, labels = mask_to_boxes(cls[b], masks[b], cfg)
        car = labels == 1  # label = type + 1, car-like types are 0
        dts.append(boxes_to_annos(boxes[car], scores[car]))
        n_dt += int(car.sum())
    t_boxes = time.perf_counter() - t1
    gts = gts[:len(dts)]
    n_gt = sum(len(g["name"]) for g in gts)
    t1 = time.perf_counter()
    official = get_official_eval_result(gts, dts, current_classes=(0,))
    t_off = time.perf_counter() - t1
    t1 = time.perf_counter()
    coco = get_coco_eval_result(gts, dts, current_classes=(0,))
    t_coco = time.perf_counter() - t1
    ok = len(dts) > 0 and all(np.isfinite(m).all() for r in (official, coco)
                              for m in r["car"].values())
    objects = int((cls.argmax(-1) > 0).sum())
    print(f"[eval] KITTI fit's predictions on {len(dts)} validation frames "
          f"({n_gt} labels; {objects} of {cls.shape[0] * cls.shape[1]} "
          f"queries predict an object, mask probabilities at most "
          f"{float(masks.max()):.4f}; {n_dt} car boxes from mask_to_boxes in "
          f"{t_boxes:.2f} s): official {json.dumps(official)} in "
          f"{t_off:.3f} s; coco {json.dumps(coco)} in {t_coco:.3f} s -> "
          f"{'ok' if ok else 'FAIL'} [{card}]", flush=True)
    if not ok:
        failures.append("[eval] the official evaluation of the KITTI fit")

    t1 = time.perf_counter()
    gts, dts = synthetic_split(EVAL_FRAMES, seed=SEED)
    t_gen = time.perf_counter() - t1
    t1 = time.perf_counter()
    official = get_official_eval_result(gts, dts, current_classes=(0,))
    t_off = time.perf_counter() - t1
    print(f"[eval] official evaluation at the full split's scale: "
          f"{EVAL_FRAMES} frames, {sum(len(g['name']) for g in gts)} labels, "
          f"{sum(len(d['name']) for d in dts)} detections (drawn in "
          f"{t_gen:.2f} s): car {json.dumps(official['car'])} in "
          f"{t_off:.2f} s on the host [{card}]", flush=True)

    rng = np.random.default_rng(SEED + 30)
    na, nb = EVAL_IOU_BOXES

    def boxes(n):
        return np.column_stack([
            rng.uniform(-6, 6, n), rng.uniform(-6, 6, n),
            rng.uniform(1.4, 2.2, n), rng.uniform(3.2, 5.0, n),
            rng.uniform(-np.pi, np.pi, n)]).astype(np.float32)

    a, b = boxes(na), boxes(nb)
    ta = torch.as_tensor(a, device="cuda")
    tb = torch.as_tensor(b, device="cuda")
    got = rotated_iou_matrix(ta, tb)
    t1 = time.perf_counter()
    want = rotate_iou_eval(a, b)
    host_ms = (time.perf_counter() - t1) * 1e3
    err = float(np.abs(got.cpu().numpy() - want).max())
    ms = cuda_ms(torch, lambda: rotated_iou_matrix(ta, tb), 10)
    ok = got.is_cuda and err <= 1e-5
    print(f"[eval] rotated_iou_matrix on the card, {na} x {nb} = {na * nb} "
          f"pairs ({(want > 0).mean():.3f} overlapping): max_abs_err "
          f"{err:.3g} against rotate_iou_eval on the host (tolerance 1e-5); "
          f"{ms:.4f} ms on the card, {host_ms:.1f} ms on the host -> "
          f"{'ok' if ok else 'FAIL'} [{card}]", flush=True)
    if not ok:
        failures.append("[eval] rotated_iou_matrix on the card")


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


# ---- [ddp]: data parallel over torch.distributed ---------------------------
# (a): 01_semantic_kitti.yml as shipped on two gloo ranks of one card (NCCL
# refuses two ranks on one device) against one process; (b) the trainer at
# 02_train_smoke_tpu.yml's widths under a world-size-1 NCCL group against
# no group; then [modules]
DDP_RANKS = 2
DDP_TIMED = 1
DDP_YML = ("semantic_kitti", "01_semantic_kitti.yml")
# (a)'s gradients, as norms of the change over norms of the gradient: the
# whole gradient's to GRAD_TOL, each leaf's to GRAD_LEAF_TOL (a leaf whose
# gradient is zero up to rounding, an attention key bias's, is measured
# against 1e-4 of the largest leaf norm). On the card the ranks run their
# convolutions and products at batch 2, where cuDNN and cuBLAS choose
# other algorithms than at batch 4, and the decoder's attention masks
# (m < 0) pass small differences on: the two ranks' gradient was 6.5e-5
# of the one process's norm, 1.0e-3 of a leaf's at most, 2.4e-3 of a
# leaf's largest magnitude at most (a decoder fc1 bias), while the one
# process repeated moved it by 8.5e-8 (my chip runs 3-4 of PR 15);
# elementwise, tests/test_parallel.py's rtol 2e-4 and atol 5e-6 max(1,
# max|g|) do not hold here. A fault of the data parallelism moves
# gradients by far more (a mean for the sum halves every one; the CPU
# tests fail on each of four such faults).
GRAD_TOL = 1e-3
GRAD_LEAF_TOL = 1e-2


def _sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def timing_reduce(torch, dev, store: list):
    """``distributed.all_reduce_grads`` that appends its synchronised ms
    to ``store``."""
    from mask_bev_tpu_torch.parallel import distributed

    orig = distributed.all_reduce_grads

    def timed(grads):
        _sync(torch, dev)
        t1 = time.perf_counter()
        out = orig(grads)
        _sync(torch, dev)
        store.append((time.perf_counter() - t1) * 1e3)
        return out
    return timed


def ddp_case(np, here: str, overrides: dict):
    """``01_semantic_kitti.yml`` as shipped (f32, global batch 4), a
    synthetic global batch at its widths (~120k points a scan) and the
    pinned loss points of every head pass, all from the seed: each rank
    builds the same and keeps its rows."""
    from mask_bev_tpu_torch.config import MaskBevConfig
    from mask_bev_tpu_torch.datasets.synthetic import make_batch

    cfg = MaskBevConfig.from_yaml(os.path.join(
        here, "configs", "training", *DDP_YML)).replace(**overrides)
    noise = min(115_000, cfg.max_points_per_scan // 2)
    batch = make_batch(np.random.default_rng(SEED + 40), cfg,
                       noise_points=noise, points_per_instance=1500)
    rng = np.random.default_rng(SEED + 41)
    n_l, p = cfg.num_decoder_outputs, cfg.head_num_points
    mcs = rng.uniform(size=(n_l, cfg.batch_size, p, 2)).astype(np.float32)
    lcs = rng.uniform(size=(n_l, cfg.batch_size * cfg.num_queries, p,
                            2)).astype(np.float32)
    return cfg, batch, mcs, lcs


def ddp_rank(work: str) -> None:
    """One rank of ``[ddp]`` (a), run by :func:`ddp_phase` as
    ``chip_smoke.py --ddp-rank <dir>`` under the ``MASKBEV_*`` variables:
    the step on this rank's rows (loss points pinned), then timed steps;
    its results go to ``<dir>/rank<r>.pt`` (rank 0's gradients to
    ``grads.pt``)."""
    import numpy as np
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.parallel import distributed
    from mask_bev_tpu_torch.train.step import (
        create_train_state, loss_and_grads)

    with open(os.path.join(work, "args.json")) as f:
        args = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.init_from_env(args["device"], backend="gloo")
    r = distributed.rank()
    dev = distributed.device(args["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kb.lib()
    cfg, batch, mcs, lcs = ddp_case(np, here, args["overrides"])

    def rows(a):
        return distributed.shard_batch({"a": a})["a"]

    batch = distributed.shard_batch(batch)
    coords = [(torch.as_tensor(rows(m), device=dev),
               torch.as_tensor(rows(c), device=dev))
              for m, c in zip(mcs, lcs)]
    state = create_train_state(cfg, seed=SEED, device=args["device"])
    distributed.replicate_state(state)
    reduce_ms = []
    distributed.all_reduce_grads = timing_reduce(torch, dev, reduce_ms)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kb.reset_launches()
    logs, _, grads = loss_and_grads(state, batch, coords=coords)
    out = dict(
        loss=float(logs["loss"]), launches=dict(kb.LAUNCHES),
        stats={k: v.detach().cpu().clone()
               for k, v in state.model.state_dict().items()
               if "running" in k},
        digests={k: (float(g.double().sum()), float(g.abs().max()))
                 for k, g in grads.items()},
        buckets=sum(1 for _ in distributed.buckets(
            list(grads.values()), distributed.BUCKET_BYTES)),
        grad_bytes=sum(g.numel() * g.element_size() for g in grads.values()))
    if r == 0:
        torch.save({k: g.cpu() for k, g in grads.items()},
                   os.path.join(work, "grads.pt"))
    del grads, logs
    step_ms = []
    for _ in range(DDP_TIMED):
        distributed.barrier()
        _sync(torch, dev)
        t1 = time.perf_counter()
        loss_and_grads(state, batch, coords=coords)
        _sync(torch, dev)
        step_ms.append((time.perf_counter() - t1) * 1e3)
    out.update(step_ms=step_ms, reduce_ms=reduce_ms,
               peak_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else float("nan")))
    torch.save(out, os.path.join(work, f"rank{r}.pt"))
    distributed.shutdown()
    print(f"rank {r} done", flush=True)


def ddp_phase(np, torch, card, failures, here, device="cuda",
              overrides=None) -> None:
    """``[ddp]`` (a) and (c): ``01_semantic_kitti.yml`` as shipped (f32,
    global batch 4; kernels A, B and C) in one process on the card, then
    on two gloo ranks of the same card, 2 rows each (NCCL refuses two
    ranks on one device), on the same global batch with the loss points
    pinned. Held: the loss (1e-5 relative), the gradients (``GRAD_TOL``,
    ``GRAD_LEAF_TOL``), the two ranks' gradients and running statistics
    equal, those against the one process within 1e-4 relative. Times a step both ways and the gradients' all-reduce a
    step."""
    import shutil
    import tempfile

    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.parallel import distributed
    from mask_bev_tpu_torch.train.step import (
        create_train_state, loss_and_grads)

    overrides = overrides or {}
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cfg, batch, mcs, lcs = ddp_case(np, here, overrides)
    state = create_train_state(cfg, seed=SEED, device=device)
    coords = [(torch.as_tensor(m, device=dev), torch.as_tensor(c, device=dev))
              for m, c in zip(mcs, lcs)]
    kb.reset_launches()
    logs, _, grads = loss_and_grads(state, batch, coords=coords)
    launch1 = dict(kb.LAUNCHES)
    loss1 = float(logs["loss"])
    grads1 = {k: g.cpu() for k, g in grads.items()}
    stats1 = {k: v.detach().cpu().clone()
              for k, v in state.model.state_dict().items()
              if "running" in k}
    del grads, logs
    one_ms = []
    for _ in range(DDP_TIMED):
        _sync(torch, dev)
        t1 = time.perf_counter()
        loss_and_grads(state, batch, coords=coords)
        _sync(torch, dev)
        one_ms.append((time.perf_counter() - t1) * 1e3)
    peak1 = (torch.cuda.max_memory_allocated() / 2 ** 30
             if dev.type == "cuda" else float("nan"))
    del state, coords, batch, mcs, lcs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    os.makedirs(os.path.join(here, "runs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_ddp_",
                            dir=os.path.join(here, "runs"))
    try:
        with open(os.path.join(work, "args.json"), "w") as f:
            json.dump(dict(device=device, overrides=overrides), f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [here] + [q for q in env.get("PYTHONPATH", "").split(os.pathsep)
                      if q])
        t0 = time.time()
        procs = distributed.spawn(
            [os.path.abspath(__file__), "--ddp-rank", work], DDP_RANKS,
            env=env, cwd=here)
        distributed.wait(procs, timeout=900)  # raises when a rank failed
        ranks_s = time.time() - t0
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"))
                 for r in range(DDP_RANKS)]
        grads2 = torch.load(os.path.join(work, "grads.pt"))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    r0 = ranks[0]
    d_loss = max(abs(r["loss"] - loss1) / abs(loss1) for r in ranks)
    norms = {k: float(w.double().norm()) for k, w in grads1.items()}
    floor = 1e-4 * max(norms.values())
    table, num = [], 0.0  # (leaf's change / its norm, leaf, max rel.)
    for k, w in grads1.items():
        d = (grads2[k] - w).double()
        dn = float(d.norm())
        num += dn * dn
        table.append((dn / max(norms[k], floor), k, float(
            d.abs().max()) / max(float(w.abs().max()), 1e-30)))
    table.sort(reverse=True)
    worst = table[0][0]
    whole = num ** 0.5 / sum(v * v for v in norms.values()) ** 0.5
    print("[ddp] (a) gradient leaves furthest from one process (the "
          "change's norm over the leaf's; its largest element over the "
          "leaf's largest): " + "; ".join(
              f"{k} {rel:.3g} ({top:.3g})" for rel, k, top in table[:5]),
          flush=True)
    same_grads = all(r["digests"] == r0["digests"] for r in ranks)
    same_stats = all(torch.equal(r["stats"][k], r0["stats"][k])
                     for r in ranks for k in r0["stats"])
    d_stats = max(float(((r0["stats"][k] - w).abs()
                         / (1e-6 + 1e-4 * w.abs())).max())
                  for k, w in stats1.items())
    need = ("canvas_scatter", "canvas_scatter_bwd", "hungarian")
    launched = all(r["launches"].get(k, 0) > 0 for r in ranks for k in need)
    ok = (d_loss <= 1e-5 and whole <= GRAD_TOL and worst <= GRAD_LEAF_TOL
          and same_grads and same_stats
          and d_stats <= 1.0 and len(grads2) == len(grads1)
          and (launched or dev.type != "cuda"))
    print(f"[ddp] (a) {DDP_YML[1]} as shipped ({cfg.compute_dtype}, global "
          f"batch {cfg.batch_size}, {cfg.num_queries} queries, "
          f"{cfg.max_points_per_scan} point slots, loss points pinned): "
          f"{DDP_RANKS} gloo ranks x {cfg.batch_size // DDP_RANKS} rows on "
          f"one card vs one process: loss {r0['loss']:.6f} vs {loss1:.6f} "
          f"(relative diff {d_loss:.3g}, tolerance 1e-5); {len(grads1)} "
          f"gradients: the change's norm over the gradient's {whole:.3g} "
          f"(tolerance {GRAD_TOL}), over a leaf's at most {worst:.3g} at "
          f"{table[0][1]} (tolerance {GRAD_LEAF_TOL}); "
          f"ranks' gradients "
          f"equal {same_grads}; running statistics equal on both ranks "
          f"{same_stats}, against one process worst |diff| / (1e-6 + 1e-4 "
          f"|s|) {d_stats:.3g} (tolerance 1); launches one process "
          f"{ {k: launch1.get(k, 0) for k in need} }, per rank "
          f"{[{k: r['launches'].get(k, 0) for k in need} for r in ranks]} "
          f"-> {'ok' if ok else 'FAIL'} [{card}]", flush=True)
    step2 = float(np.median([max(r["step_ms"][i] for r in ranks)
                             for i in range(DDP_TIMED)]))
    reduce2 = float(np.median(r0["reduce_ms"][1:] or r0["reduce_ms"]))
    print(f"[ddp] (c) a global step of batch {cfg.batch_size} (forward, "
          f"loss, backward, no optimizer): one process median "
          f"{float(np.median(one_ms)):.1f} ms ({[round(x, 1) for x in one_ms]}"
          f"), peak {peak1:.2f} GiB; {DDP_RANKS} gloo ranks on the same card "
          f"median {step2:.1f} ms (slowest rank a step: "
          f"{[[round(x, 1) for x in r['step_ms']] for r in ranks]}), peak "
          f"{[round(r['peak_gib'], 2) for r in ranks]} GiB a rank; the "
          f"gradients' all-reduce ({r0['grad_bytes'] / 2 ** 20:.0f} MiB of "
          f"f32 in {r0['buckets']} buckets, through the host) "
          f"{reduce2:.1f} ms a step ({[round(x, 1) for x in r0['reduce_ms']]}"
          f"); ranks started, stepped and wrote in {ranks_s:.1f} s "
          f"[{card}]", flush=True)
    if not ok:
        failures.append("[ddp] (a) two ranks against one process")


def ddp_nccl_phase(np, torch, card, failures, here, device="cuda",
                   overrides=None) -> None:
    """``[ddp]`` (b): ``Trainer.fit`` at ``02_train_smoke_tpu.yml``'s widths
    (bf16, batch 4; 2 training and 1 validation batch, one epoch), once
    without a process group and once under a world-size-1 NCCL group (its
    all-reduce an identity, taken every step): the ``last`` checkpoints
    bitwise equal.
    cuDNN runs its deterministic algorithms for both fits, so that two fits
    can be equal at all."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from mask_bev_tpu_torch.config import MaskBevConfig
    from mask_bev_tpu_torch.parallel import distributed
    from mask_bev_tpu_torch.train.loop import Trainer
    from train_mask_bev_torch import build_datamodule

    yml = os.path.join(here, "configs", "training", "semantic_kitti",
                       "02_train_smoke_tpu.yml")
    cfg = MaskBevConfig.from_yaml(yml).replace(
        limit_train_batches=2, limit_val_batches=1, max_epochs=1,
        log_images=False, **(overrides or {}))
    dm = build_datamodule(cfg, None)
    os.makedirs(os.path.join(here, "runs"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_nccl_",
                            dir=os.path.join(here, "runs"))
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    reduce_ms = []
    orig = distributed.all_reduce_grads
    fit_s, backend = [], None
    try:
        for name in ("plain", "nccl"):
            if name == "nccl":
                distributed.init(f"127.0.0.1:{distributed.free_port()}", 1,
                                 0, torch.device(device).type)
                backend = dist.get_backend()
                distributed.all_reduce_grads = timing_reduce(
                    torch, device, reduce_ms)
            t0 = time.time()
            tr = Trainer(cfg, workdir=os.path.join(work, name),
                         device=device)
            tr.fit(dm.train_batches, dm.val_batches)
            _sync(torch, device)
            fit_s.append(time.time() - t0)
            tr.logger.close()
            del tr
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        last = [torch.load(os.path.join(work, n, cfg.name, "checkpoints",
                                        "last.pt"), map_location="cpu",
                           weights_only=True) for n in ("plain", "nccl")]
    finally:
        distributed.all_reduce_grads = orig
        distributed.shutdown()
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(work, ignore_errors=True)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix[:-1], tree

    a, b = dict(leaves(last[0])), dict(leaves(last[1]))
    differ = [k for k in a if not (
        torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k])]
    ok = set(a) == set(b) and not differ and backend == "nccl"
    print(f"[ddp] (b) Trainer.fit at {os.path.basename(yml)}'s widths "
          f"({cfg.compute_dtype}, batch {cfg.batch_size}, "
          f"{cfg.limit_train_batches} train + {cfg.limit_val_batches} val "
          f"batches x {cfg.max_epochs} epoch, cuDNN deterministic): without "
          f"a process "
          f"group {fit_s[0]:.1f} s, under a world-size-1 {backend} group "
          f"{fit_s[1]:.1f} s; the gradients' all-reduce there "
          f"{float(np.median(reduce_ms)):.2f} ms a step (of {len(reduce_ms)}"
          f"); last checkpoints: {len(a)} entries, bitwise equal "
          f"{not differ} (differ: {differ[:5]}) -> {'ok' if ok else 'FAIL'} "
          f"[{card}]", flush=True)
    if not ok:
        failures.append("[ddp] (b) NCCL world-size-1 fit differs")


def modules_phase(np, torch, card, failures) -> None:
    """``[modules]``: the modules MaskBev does not call, on the card against
    the CPU: ``pillarize_batch`` on the main path's batch-8 scans (every
    cell a slot: the reference voxelizer's ``max_voxels``) bit for bit,
    FKAConv (train mode: ``norm_radius`` updated) and DynamicEdgeConv at
    small sizes within 1e-5 of the largest value (DynamicEdgeConv on the
    rows whose neighbour sets agree; f32 products on either side order
    their sums differently, which can swap near-tied neighbours)."""
    import copy

    from mask_bev_tpu_torch.config import semantic_kitti_default
    from mask_bev_tpu_torch.models.dgcnn import DynamicEdgeConv, knn_indices
    from mask_bev_tpu_torch.models.fkaconv import FKAConv
    from mask_bev_tpu_torch.ops.voxelize import pillarize_batch

    cfg = semantic_kitti_default()
    h, w = cfg.grid_hw
    geo = dict(x_range=cfg.x_range, y_range=cfg.y_range, z_range=cfg.z_range,
               voxel_size=cfg.voxel_size,
               max_points_per_pillar=cfg.max_num_points, max_pillars=h * w)
    pts, mask = scans(np, BATCH, 131072, SEED)
    t1 = time.perf_counter()
    want = pillarize_batch(torch.as_tensor(pts), torch.as_tensor(mask), **geo)
    cpu_ms = (time.perf_counter() - t1) * 1e3
    gp, gm = torch.as_tensor(pts).cuda(), torch.as_tensor(mask).cuda()
    got = pillarize_batch(gp, gm, **geo)
    same = all(torch.equal(g.cpu(), wt) for g, wt in zip(got, want))
    occupied = int(want.valid.sum())
    del got
    ms = cuda_ms(torch, lambda: pillarize_batch(gp, gm, **geo), 3)
    del gp, gm, want
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 50)
    fk = FKAConv(32, 64, kernel_size=16)
    with torch.no_grad():
        for p in fk.parameters():
            p.add_(0.1 * torch.as_tensor(rng.normal(size=p.shape),
                                         dtype=p.dtype))
    fk_gpu = copy.deepcopy(fk).cuda()
    feats = torch.as_tensor(rng.normal(size=(2, 256, 16, 32)),
                            dtype=torch.float32)
    rel = torch.as_tensor(rng.normal(size=(2, 256, 16, 3)),
                          dtype=torch.float32)
    with torch.no_grad():
        fw = fk(feats, rel, train=True)
        fg = fk_gpu(feats.cuda(), rel.cuda(), train=True).cpu()
    fk_err = float((fg - fw).abs().max()) / float(fw.abs().max())
    r_err = abs(float(fk_gpu.norm_radius) - float(fk.norm_radius))

    ec = DynamicEdgeConv(16, 64, k=16)
    ec_gpu = copy.deepcopy(ec).cuda()
    x = torch.as_tensor(rng.normal(size=(2, 256, 16)), dtype=torch.float32)
    with torch.no_grad():
        ew = ec(x)
        eg = ec_gpu(x.cuda()).cpu()
        iw = knn_indices(x, 16).sort(-1).values
        ig = knn_indices(x.cuda(), 16).cpu().sort(-1).values
    rows_ok = (iw == ig).all(-1)
    ec_err = float((eg - ew).abs()[rows_ok].max()) / float(ew.abs().max())
    ok = (same and fk_err <= 1e-5 and r_err <= 1e-5 * float(fk.norm_radius)
          and ec_err <= 1e-5 and float(rows_ok.float().mean()) >= 0.99)
    print(f"[modules] pillarize_batch on the main path's {BATCH} scans "
          f"({geo['max_points_per_pillar']} points a pillar, {h * w} slots, "
          f"{occupied} occupied): card == CPU bit for bit {same}; card "
          f"{ms:.2f} ms, CPU {cpu_ms:.0f} ms; FKAConv (2 x 256 "
          f"neighbourhoods of 16, 32 -> 64, kernel 16, train mode) relative "
          f"diff {fk_err:.3g}, norm_radius diff {r_err:.3g}; "
          f"DynamicEdgeConv (2 x 256 points, 16 -> 64, k 16) neighbour sets "
          f"equal in {int(rows_ok.sum())}/{rows_ok.numel()} rows, relative "
          f"diff there {ec_err:.3g} (tolerance 1e-5) -> "
          f"{'ok' if ok else 'FAIL'} [{card}]", flush=True)
    if not ok:
        failures.append("[modules] card against CPU")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:
        ddp_rank(sys.argv[2])
    else:
        main()
