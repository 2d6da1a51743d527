#!/usr/bin/env python3
"""Profile of the long-window attention (``csrc/window_attn.cuh::
window_attn_long_kernel``) on the card: two checkouts and ablations of the
first, timed in turns in one run.

    python3 scripts/long_attn_profile.py <old_root> <new_root> [--out DIR]

(DIR, the variants' builds, defaults to ``_checkout/profile_build``.)

For each variant the attention's sources (``swin_block.cu``,
``window_msa.cu``, ``errors.cu`` with their headers) are built alone with
``nvcc -Xptxas -v`` into ``DIR/<variant>/`` (all variants at once), and a
process of its own loads that library into the checkout's
``mask_bev_tpu_torch`` (``kernels.build._lib``) and times, with CUDA
events over back-to-back launches:

* ``.w12``: the attention launches of one forward of Swin-B at 384 px on
  the main path's grid (batch 8; stages (125^2, C 128, 4 heads), (63^2,
  256, 8), (32^2, 512, 16), (16^2, 1024, 32), head width 32, window 12;
  2, 2, 18, 2 blocks, every other block shifted), bf16, the Swin and the
  MSA variant, summed as one forward launches them (24 launches);
* ``w16``: window 16 at the stage-0 widths (125^2, C 128, 4 heads,
  shifted), both variants;
* ``F.scaled_dot_product_attention`` on the same windows with the float
  mask rel + shift mask (the library call ``chip_smoke.py`` times).

Variants: the old checkout as it is (``old``), the old kernel with its
per-score bias read replaced by 0 (``old_bias0``: what the L2 reads cost;
its outputs are not the attention's), the old kernel with launch bounds for
two blocks of 9 warps an SM (``old_occ2``: window 12 only), and the new
checkout (``new``). Order: old, old_bias0, old_occ2, new, new, old. Each
variant's registers, spills and the blocks an SM they allow at window 12
(288 threads) come from its ptxas log. ``ncu`` does not run on the card's
machine, so stall reasons and achieved occupancy are not measured.
Prints one JSON line a run and the card's name and power limit.

    python3 scripts/long_attn_profile.py --widths <old_root> <new_root> \
        [--variants old,new,...]

profiles the bf16 window attention at head widths 72-128 up to 128 tokens
a window (``attn_wide_swin.cu``, ``attn_wide_msa.cu``: the old checkout's
``window_attn_width_kernel``, the new one's ``window_attn_ring_kernel``;
f32 stays on the width kernel in both): ``w10``, window 10 on the stage-0
grid (8 x 125^2, 2 heads, shifted) at each width, Swin and MSA, bf16 (and
f32 for ``old`` and ``new``); ``hd96``, ``.hd96``'s 12 launches a forward
(heads 2, 4, 8, 16 at embed 192: head width 96 on the four stage grids,
depths 2, 2, 6, 2, every other block shifted), Swin, bf16. Variants:
``old``, ``new``, and ablations of ``new`` (Swin only): ``new_pv1`` (P v
in one pass, not two halves), ``new_mask_all`` (the label compare in every
window of a shifted block), ``new_b1`` (launch bounds of one block an SM).
Default order: old, new, new_pv1, new_mask_all, new_b1, new, old.

    python3 scripts/long_attn_profile.py --stream <old_root> <new_root> \
        [--variants old,new,...] [--cases w24,g144_hd72,...]

profiles the streaming kernel (``attn_stream_swin.cu``,
``attn_stream_msa.cu``): ``w24``, ``.w24``'s 12 launches a forward (window
24 on the four stage grids of ``semantic_kitti_default()``, 125^2, 63^2,
32^2, 16^2 at C 192-1536 over 3-24 heads: head width 64; depths 2, 2, 6,
2, every other block shifted), Swin and MSA, bf16 (and f32 for ``old`` and
``new``); ``g144``, window 24 on the stage-1 grid (8 x 63^2, 2 heads,
shifted: 144 (window, head, sample) blocks in the old kernel) at widths 72,
96, 128 (all of 72-128 for ``old`` and ``new``), Swin, bf16 and f32.
Variants: ``old``, ``new``, ``new_mma`` (mma.sync at every staged width,
not wgmma at 64 and 128; timed as fully as ``old`` and ``new``), and
ablations of ``new`` (Swin, bf16): ``new_noskip`` (every query tile
computed, the pad tokens' rows too), ``new_serial`` (each chunk's copies
awaited before its compute: no overlap), ``new_mask_all`` (the label
compare in every window), ``new_grid`` (a block an item, not a persistent
grid), ``new_b1`` (one block an SM at staged widths up to 64),
``new_resident`` / ``new_mma_resident`` (``w24`` only: an upper bound of k
and v held resident across a window's query tiles: the chunks copied for a
window's first tile only, so the outputs are not the attention's, and the
shared memory of a window's k and v, one block an SM). Default order: old,
new, new_noskip, new_serial, new_mask_all, new_grid, new_b1, new, old.
``--cases`` keeps the cases named. ``old``, ``new`` and ``new_mma`` also
give the sha256 of every streaming digest of
``tests/test_torch_port_attn_stream.py`` (the small grid, and the stage-1
grid at batch 8 where each block takes several items); an ablation that
does not build or run is reported and left out.

    python3 scripts/long_attn_profile.py --routes <root>

holds the two kernels of windows of 129-256 tokens at head widths up to 64
against each other in one checkout: ``long`` (as it is:
``window_attn_long_kernel``) and ``stream`` (the streaming entry's refusal
of those windows taken out of ``window_attn.cuh`` and
``ops/swin_block.py::attn_route`` sending them to it, so they run
``window_attn_stream_kernel``). Each times ``.w12`` (24 launches, as above)
and window 16 at the stage-0 widths (one block plain, one shifted), both
variants, bf16 and f32, event and device time, each call's error against
its plain version beside it. Order: long, stream, stream, long.

Both give each case's event time (CUDA events around 20 back-to-back
calls) and device time (``chip_smoke.py::queued_ms``: the calls queued
behind a sleep kernel), per stage and summed, the largest error against
the plain version relative to its largest value, and a sha256 of the bf16
outputs of every case (the same inputs in every variant, so equal digests
mean outputs equal bit for bit); the first variant run also times
``F.scaled_dot_product_attention`` on the same windows (event and device;
the library yardstick, used on no path). Each variant's registers and
spill bytes come from its ptxas log. One JSON line a variant run, and the
card's name and power limit.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
SOURCES = ("swin_block.cu", "window_msa.cu", "errors.cu")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-lineinfo"]
# (pattern, ablation text) in a checkout's window_attn.cuh: plain text
# (re.escape) or a regular expression, each to match at least once
ABLATIONS = {
    "old_bias0": [(re.escape("bias = __ldg(relh + (size_t)r * n + c);"),
                   "bias = 0.f;")],
    "old_occ2": [(re.escape("__launch_bounds__(32 * ATT_LONG_MAX_NPT, 1)"),
                  "__launch_bounds__(32 * 9, 2)")],
}
# --widths: the sources a variant builds (ablations: the Swin entry only)
WIDE_SOURCES = ("attn_wide_swin.cu", "attn_wide_msa.cu", "errors.cu")
STREAM_SOURCES = ("attn_stream_swin.cu", "attn_stream_msa.cu", "errors.cu")
WIDE_ABLATIONS = {
    "new_pv1": [(re.escape("constexpr int NPASS = HD > 64 ? 2 : 1;"),
                 "constexpr int NPASS = 1;")],
    "new_mask_all": [(re.escape("const bool mixed = shift && (wi / nww == "
                                "nwh - 1 || wi % nww == nww - 1);"),
                      "const bool mixed = shift;")],
    "new_b1": [(r"constexpr int ATT_RING_BLOCKS = \d+;",
                "constexpr int ATT_RING_BLOCKS = 1;")],
}
STREAM_ABLATIONS = {
    "new_noskip": [
        (re.escape("if (qt * QR < __popc(my) * __popc(mx)) return it;"),
         "return it;"),
        (re.escape("16 * warp) <\n             __popc(my) * __popc(mx);"),
         "16 * warp) < n;")],
    "new_serial": [(re.escape("      if (!live) continue;\n"
                              "      const T* ks = kvs"),
                    "      cp_async_wait<0>();\n      if (!live) continue;\n"
                    "      const T* ks = kvs")],
    "new_mask_all": [(re.escape("mixed = shift && (wi / nww == nwh - 1 || "
                                "wi % nww == nww - 1);"),
                      "mixed = shift;")],
    "new_grid": [(re.escape("(long long)per_sm * sms);  // whole waves"),
                  "items);")],
    "new_b1": [(re.escape("return sizeof(T) == 2 && HS <= 64 ? 2 : 1;"),
                "return 1;")],
}
# both products by mma.sync at every staged width (the bf16 instances at 64
# and 128 take wgmma as built)
MMA = [(re.escape("constexpr bool ATT_STREAM_WGMMA = true;"),
        "constexpr bool ATT_STREAM_WGMMA = false;")]
# k and v resident across a window's query tiles, bounded from above: the
# chunks are copied for the window's first tile only (the later tiles read
# whatever the buffers hold, so the outputs are not the attention's), and
# the block takes the shared memory a window's k and v would (576 rows x
# 64 x 2 bytes x 2 = 147456 bytes in place of the two chunk stages, one
# block an SM) at staged widths up to 64
RESIDENT = [
    (re.escape("    stream_rows<T, LD, KSW>(qkv, qkv_bias, ks, tk, nullptr, "
               "1,"),
     "    if (qt == 0) stream_rows<T, LD, KSW>(qkv, qkv_bias, ks, tk, "
     "nullptr, 1,"),
    (re.escape("    stream_rows<T, LD, KSW>(qkv, qkv_bias, ks + KR * LD, tk, "
               "nullptr, 2,"),
     "    if (qt == 0) stream_rows<T, LD, KSW>(qkv, qkv_bias, ks + KR * LD, "
     "tk, nullptr, 2,"),
    (re.escape("const size_t smem = window_attn_stream_smem(win, hd, "
               "sizeof(T) == 4);"),
     "const size_t smem = window_attn_stream_smem(win, hd, sizeof(T) == 4)"
     " + (HS <= 64 ? 147456 - ATT_STREAM_STAGES * 2 * 64 * (HS + 8) * 2 "
     ": 0);")]
STREAM_ABLATIONS.update(new_mma=MMA, new_resident=RESIDENT,
                        new_mma_resident=MMA + RESIDENT)
# variants timed at staged widths up to 64 only (``w24``)
W24_ONLY = ("new_resident", "new_mma_resident")
# variants built from both sources and timed on every case, both variants
# and f32 (the others: Swin and bf16, widths 72, 96 and 128)
FULL = ("old", "new", "new_mma")
# --routes: one checkout's two kernels of windows of 129-256 tokens at head
# widths up to 64; ``stream`` takes the streaming entry's refusal of them out
ROUTE_SOURCES = ("swin_block.cu", "window_msa.cu", "attn_stream_swin.cu",
                 "attn_stream_msa.cu", "errors.cu")
ROUTE_ABLATIONS = {
    "stream": [(re.escape("if (hd % 8 || hd > 128 || (hd <= 64 && NP <= 16 "
                          "* ATT_LONG_MAX_NPT))"),
                "if (hd % 8 || hd > 128)")],
}
WIDE_ORDER = ("old", "new", "new_pv1", "new_mask_all", "new_b1", "new", "old")
STREAM_ORDER = ("old", "new", "new_noskip", "new_serial", "new_mask_all",
                "new_grid", "new_b1", "new", "old")
# .w24 / .hd96: semantic_kitti_default()'s four stage grids, (grid, C,
# blocks); heads C / 64 (.w24) or C / 96 (.hd96)
STAGES = (((125, 125), 192, 2), ((63, 63), 384, 2), ((32, 32), 768, 6),
          ((16, 16), 1536, 2))
# Swin-B at 384 px on the main path's 500 x 500 grid: (grid, C, heads,
# blocks)
W12_STAGES = (((125, 125), 128, 4, 2), ((63, 63), 256, 8, 2),
              ((32, 32), 512, 16, 18), ((16, 16), 1024, 32, 2))
BATCH = 8


def prepare(root: pathlib.Path, variant: str, out: pathlib.Path,
            sources=SOURCES, header="window_attn.cuh", ablations=ABLATIONS):
    """Copy ``root``'s kernel sources into ``out/variant`` with the
    variant's substitutions (in ``header`` unless an entry names its
    file); start nvcc on ``sources``."""
    d = out / variant
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(root / "mask_bev_tpu_torch" / "csrc", d / "csrc")
    # (pattern, text) in ``header``, or (file, pattern, text)
    for item in ablations.get(variant, []):
        name, pat, new = item if len(item) == 3 else (header, *item)
        path = d / "csrc" / name
        text, hits = re.subn(pat, new, path.read_text())
        if not hits:
            raise SystemExit(f"{variant}: {pat!r} not in {path}")
        path.write_text(text)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = []
    for src in sources:
        obj = d / (pathlib.Path(src).stem + ".o")
        log = open(d / (pathlib.Path(src).stem + ".log"), "w")
        procs.append(subprocess.Popen(
            [nvcc, *FLAGS, "-Xptxas", "-v", "-I", str(d / "csrc"), "-c",
             str(d / "csrc" / src), "-o", str(obj)],
            stdout=log, stderr=subprocess.STDOUT))
    return d, procs


def link(d: pathlib.Path, sources=SOURCES) -> pathlib.Path:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = d / "libattn.so"
    objs = [str(d / (pathlib.Path(s).stem + ".o")) for s in sources]
    subprocess.run([nvcc, "-shared", "-gencode",
                    "arch=compute_90a,code=sm_90a", *objs, "-o", str(lib)],
                   check=True)
    return lib


def attn_registers(d: pathlib.Path, pattern: str) -> dict:
    """The kernels of a build whose demangled name matches ``pattern``:
    registers and spill bytes."""
    spec = importlib.util.spec_from_file_location(
        "ptxas_lines", HERE / "ptxas_lines.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = {}
    ks = mod.kernels(d)
    names = mod.demangle(ks)
    for name, (regs, _, st, ld) in ks.items():
        dem = names[name].split("(")[0]
        if regs is not None and re.search(pattern, dem):
            got[dem] = dict(registers=regs, spill_stores=st, spill_loads=ld)
    return got


def registers(d: pathlib.Path) -> dict:
    """The long kernel's bf16 head-width-32 instances: registers, spill
    bytes and the blocks of 288 threads an SM their registers allow."""
    spec = importlib.util.spec_from_file_location(
        "ptxas_lines", HERE / "ptxas_lines.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = {}
    filt = shutil.which("c++filt")
    for name, (regs, _, st, ld) in mod.kernels(d).items():
        dem = (subprocess.run([filt, name], capture_output=True,
                              text=True).stdout.strip() if filt else name)
        if (("window_attn_long_kernel<__nv_bfloat16, 32" in dem
             or "window_attn_long_kernelI13__nv_bfloat16Li32E" in dem)
                and regs is not None):
            # registers are allocated per warp in units of 256
            per_warp = -(-regs * 32 // 256) * 256
            got[dem.split("(")[0]] = dict(
                registers=regs, spill_stores=st, spill_loads=ld,
                blocks_w12=min(65536 // (per_warp * 9), 64 // 9))
    return got


def child(root: str, lib: str, variant: str) -> None:
    """Time the attention of ``root``'s package on ``lib``."""
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.ops import swin_block as kswin

    kb._lib = ctypes.CDLL(lib)
    dev = "cuda"

    def cuda_ms(fn, reps=20, warm=2):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def inputs(hw, c, heads, win, seed):
        g = torch.Generator().manual_seed(seed)
        qkv = torch.randn(BATCH * hw[0] * hw[1], 3 * c, generator=g).to(
            dev, torch.bfloat16)
        qb = (0.1 * torch.randn(3 * c, generator=g)).to(dev)
        table = (0.02 * torch.randn((2 * win - 1) ** 2, heads,
                                    generator=g)).to(dev, torch.bfloat16)
        return qkv, qb, kswin.rel_bias_from_table(table, win)

    def sdpa(qkv, qb, rel, hw, heads, win, shift):
        q, k, v = (t.contiguous() for t in kswin.qkv_windows(
            qkv, qb, BATCH, hw, heads, win, shift))
        mask = rel.float()[None]
        sm = kswin.shift_mask(hw, win, shift, qkv.device)
        if sm is not None:
            mask = (mask + sm[:, None]).repeat(BATCH, 1, 1, 1)
        mask = mask.to(qkv.dtype).contiguous()
        hd = q.shape[-1]
        return cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=hd ** -0.5), reps=5)

    res = {"variant": variant, "root": root}
    with torch.no_grad():
        for msa in (False, True):
            name = "window_msa" if msa else "swin_block"
            key = "msa" if msa else "swin"
            total, lib_total, stages = 0.0, 0.0, []
            for i, (hw, c, heads, blocks) in enumerate(W12_STAGES):
                qkv, qb, rel = inputs(hw, c, heads, 12, 40 + i)
                for shifted in (False, True):
                    shift = kswin.effective_shift(hw, 12, shifted)
                    a = (qkv, qb, rel, BATCH, hw, heads, 12, shift)
                    ms = cuda_ms(lambda: kswin.attention(name, *a, msa=msa))
                    total += ms * blocks / 2
                    stages.append(round(ms, 5))
                    if variant == "new":
                        lib_total += sdpa(qkv, qb, rel, hw, heads, 12,
                                          shift) * blocks / 2
                del qkv, qb, rel
            res[f"w12_{key}_ms"] = round(total, 4)
            res[f"w12_{key}_stages_ms"] = stages
            if variant == "new":
                res[f"w12_{key}_sdpa_ms"] = round(lib_total, 4)
            if variant != "old_occ2":  # its bounds take 288 threads only
                hw, c, heads = (125, 125), 128, 4
                qkv, qb, rel = inputs(hw, c, heads, 16, 50)
                shift = kswin.effective_shift(hw, 16, True)
                a = (qkv, qb, rel, BATCH, hw, heads, 16, shift)
                res[f"w16_{key}_ms"] = round(cuda_ms(
                    lambda: kswin.attention(name, *a, msa=msa)), 4)
                if variant == "new":
                    res[f"w16_{key}_sdpa_ms"] = round(sdpa(
                        qkv, qb, rel, hw, heads, 16, shift), 4)
                del qkv, qb, rel
    print(json.dumps(res), flush=True)


def child_routes(root: str, lib: str, variant: str) -> None:
    """Time ``root``'s attention at windows 12 and 16 on ``lib``, through
    the long-window kernel or (``stream``) the streaming one."""
    sys.path.insert(0, root)
    import torch

    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.ops import swin_block as kswin

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", HERE.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    kb._lib = ctypes.CDLL(lib)
    if variant == "stream":
        route = kswin.attn_route
        kswin.attn_route = lambda win, hd: (
            "stream" if route(win, hd) == "long" else route(win, hd))
    dev = "cuda"

    def cuda_ms(fn, reps=20, warm=2):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def inputs(hw, c, heads, win, seed, dt):
        g = torch.Generator().manual_seed(seed)
        qkv = torch.randn(BATCH * hw[0] * hw[1], 3 * c, generator=g).to(
            dev, dt)
        qb = (0.1 * torch.randn(3 * c, generator=g)).to(dev)
        table = (0.02 * torch.randn((2 * win - 1) ** 2, heads,
                                    generator=g)).to(dev, dt)
        return qkv, qb, kswin.rel_bias_from_table(table, win)

    res = {"variant": variant, "root": root}
    # (label, grid, C, heads, window, blocks): .w12's stages, then two
    # blocks at window 16 on the stage-0 grid
    cases = [("w12", hw, c, heads, 12, blocks)
             for hw, c, heads, blocks in W12_STAGES]
    cases.append(("w16", (125, 125), 128, 4, 16, 2))
    with torch.no_grad():
        for dt in (torch.bfloat16, torch.float32):
            sfx = "_f32" if dt == torch.float32 else ""
            for msa in (False, True):
                name = "window_msa" if msa else "swin_block"
                key = ("msa" if msa else "swin") + sfx
                kb.reset_launches()
                ev = {"w12": 0.0, "w16": 0.0}
                de = dict(ev)
                err = 0.0
                for label, hw, c, heads, win, blocks in cases:
                    qkv, qb, rel = inputs(hw, c, heads, win, 60 + c, dt)
                    for shifted in (False, True):
                        shift = kswin.effective_shift(hw, win, shifted)
                        a = (qkv, qb, rel, BATCH, hw, heads, win, shift)
                        got = kswin.attention(name, *a, msa=msa)
                        want = kswin.window_attention_plain(*a, msa=msa)
                        err = max(err, float(
                            (got.float() - want.float()).abs().max()
                            / want.float().abs().max()))
                        del got, want

                        def run():
                            return kswin.attention(name, *a, msa=msa)
                        ev[label] += cuda_ms(run) * blocks / 2
                        de[label] += smoke.queued_ms(torch, run,
                                                     10) * blocks / 2
                    del qkv, qb, rel
                # the launches of one forward (.w12: 24; w16: one block
                # unshifted, one shifted)
                for label in ev:
                    res[f"{label}_{key}_event_ms"] = round(ev[label], 5)
                    res[f"{label}_{key}_device_ms"] = round(de[label], 5)
                res[f"{key}_err"] = err
                res[f"{key}_instances"] = dict(kb.INSTANCES)
    print(json.dumps(res), flush=True)


def main_routes(root: pathlib.Path, out: pathlib.Path) -> None:
    """``--routes``: the long-window and the streaming kernel on the same
    windows of one checkout, in turns."""
    order = ("long", "stream", "stream", "long")
    started = {v: prepare(root, v, out, ROUTE_SOURCES,
                          ablations=ROUTE_ABLATIONS) for v in set(order)}
    libs = {}
    for v, (d, procs) in started.items():
        if any(p.wait() for p in procs):
            logs = "".join(p.read_text() for p in d.glob("*.log"))
            raise SystemExit(f"{v}: build failed\n{logs[-4000:]}")
        libs[v] = link(d, ROUTE_SOURCES)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    for v in order:
        subprocess.run([sys.executable, __file__, "--child-routes",
                        str(root), str(libs[v]), v], check=True,
                       env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))


def child_pair(mode: str, root: str, lib: str, variant: str, first: str,
               only: str) -> None:
    """Time ``mode``'s cases (``--widths`` or ``--stream``; ``only``, a
    comma-separated list of case labels, or empty for all) with ``root``'s
    package on ``lib``; ``first``, the variant run first, also times
    SDPA."""
    sys.path.insert(0, root)
    import hashlib

    import torch
    import torch.nn.functional as F

    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.ops import swin_block as kswin

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", HERE.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    kb._lib = ctypes.CDLL(lib)
    dev = "cuda"
    first = variant == first
    full = variant in FULL

    def cuda_ms(fn, reps=20, warm=2):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def inputs(hw, c, heads, win, seed, dt):
        g = torch.Generator().manual_seed(seed)
        qkv = torch.randn(BATCH * hw[0] * hw[1], 3 * c, generator=g).to(
            dev, dt)
        qb = (0.1 * torch.randn(3 * c, generator=g)).to(dev)
        table = (0.02 * torch.randn((2 * win - 1) ** 2, heads,
                                    generator=g)).to(dev, dt)
        return qkv, qb, kswin.rel_bias_from_table(table, win)

    # case -> [(grid, C, heads, window, shifted, launches)], variants, dtypes
    if mode == "widths":
        widths = kswin.ATTN_WIDE_DIMS
        cases = {f"w10_hd{hd}": [((125, 125), 2 * hd, 2, 10, True, 1)]
                 for hd in widths}
        cases["hd96"] = [(hw, c, c // 96, 10, sh, blocks / 2)
                         for hw, c, blocks in STAGES for sh in (False, True)]
        msa_cases = [k for k in cases if k.startswith("w10")]
    else:
        widths = kswin.ATTN_WIDE_DIMS if full else (72, 96, 128)
        cases = {"w24": [(hw, c, c // 64, 24, sh, blocks / 2)
                         for hw, c, blocks in STAGES
                         for sh in (False, True)]}
        cases.update({f"g144_hd{hd}": [((63, 63), 2 * hd, 2, 24, True, 1)]
                      for hd in widths})
        msa_cases = ["w24"]
        if variant in W24_ONLY:
            cases = {"w24": cases["w24"]}
    if only:
        cases = {k: v for k, v in cases.items() if k in only.split(",")}
    res = {"variant": variant, "root": root}
    with torch.no_grad():
        for label, stages in cases.items():
            for dt in (torch.bfloat16, torch.float32):
                if dt == torch.float32 and not full:
                    continue
                if dt == torch.float32 and label == "hd96":
                    continue  # .hd96 serves bf16
                for msa in (False, True):
                    if msa and (label not in msa_cases or not full):
                        continue
                    name = "window_msa" if msa else "swin_block"
                    key = label + ("_msa" if msa else "") + (
                        "_f32" if dt == torch.float32 else "")
                    ev = de = lev = lde = err = 0.0
                    digest = hashlib.sha256()
                    kb.reset_launches()
                    for i, (hw, c, heads, win, sh, n) in enumerate(stages):
                        qkv, qb, rel = inputs(hw, c, heads, win, 70 + i + c,
                                              dt)
                        shift = kswin.effective_shift(hw, win, sh)
                        a = (qkv, qb, rel, BATCH, hw, heads, win, shift)
                        got = kswin.attention(name, *a, msa=msa)
                        want = kswin.window_attention_plain(*a, msa=msa)
                        err = max(err, float(
                            (got.float() - want.float()).abs().max()
                            / want.float().abs().max()))
                        digest.update(got.view(torch.int16 if dt ==
                                               torch.bfloat16 else
                                               torch.int32).cpu().numpy()
                                      .tobytes())
                        del got, want
                        run = (lambda: kswin.attention(name, *a, msa=msa))
                        ev += cuda_ms(run) * n
                        de += smoke.queued_ms(torch, run, 10) * n
                        if first:
                            q, k, v = (t.contiguous() for t in
                                       kswin.qkv_windows(qkv, qb, BATCH, hw,
                                                         heads, win, shift))
                            mask = rel.float()[None]
                            sm = kswin.shift_mask(hw, win, shift, dev)
                            if sm is not None:
                                mask = (mask + sm[:, None]).repeat(
                                    BATCH, 1, 1, 1)
                            mask = mask.to(dt).contiguous()
                            hd = c // heads

                            def lib_run():
                                return F.scaled_dot_product_attention(
                                    q, k, v, attn_mask=mask,
                                    scale=hd ** -0.5)
                            lev += cuda_ms(lib_run, reps=5) * n
                            lde += smoke.queued_ms(torch, lib_run, 5) * n
                            del q, k, v, mask
                        del qkv, qb, rel, a
                    res[key] = dict(event_ms=round(ev, 5),
                                    device_ms=round(de, 5), err=err,
                                    sha256=digest.hexdigest()[:16],
                                    instances=dict(kb.INSTANCES))
                    if first:
                        res[key].update(sdpa_event_ms=round(lev, 5),
                                        sdpa_device_ms=round(lde, 5))
        if mode == "stream" and full:
            # the streaming digests of tests/test_torch_port_attn_stream.py
            # (the small grid, and the stage-1 grid at batch 8 where each
            # block takes several items), from this variant's build
            spec = importlib.util.spec_from_file_location(
                "attn_stream_digests",
                HERE.parent / "tests" / "test_torch_port_attn_stream.py")
            dmod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(dmod)
            keys = [k for k in dmod.DIGEST_KEYS if k[0] == "stream"]
            res["digests"] = {"|".join(map(str, k)): v for k, v in
                              dmod.attn_digests(keys + dmod.MANY_KEYS)
                              .items()}
    print(json.dumps(res), flush=True)


def main_pair(mode: str, old: pathlib.Path, new: pathlib.Path,
              out: pathlib.Path, order, only: str = "") -> None:
    """Build every variant of ``order`` at once, then time them in turns
    (``--widths`` or ``--stream``)."""
    sources = WIDE_SOURCES if mode == "widths" else STREAM_SOURCES
    ablations = WIDE_ABLATIONS if mode == "widths" else STREAM_ABLATIONS
    pattern = (r"window_attn_(ring|width)_kernel<[^>]*\b(7[2-9]|[89]\d|"
               r"1[0-2]\d)\b" if mode == "widths"
               else r"window_attn_stream_kernel")
    roots = {v: old if v.startswith("old") else new for v in order}
    srcs = {v: sources if v in FULL else (sources[0], sources[-1])
            for v in roots}
    started = {v: prepare(r, v, out, srcs[v], ablations=ablations)
               for v, r in roots.items()}
    libs = {}
    for v, (d, procs) in started.items():
        if any(p.wait() for p in procs):
            logs = "".join(p.read_text() for p in d.glob("*.log"))
            if v in ("old", "new"):
                raise SystemExit(f"{v}: build failed\n{logs[-4000:]}")
            # an ablation that does not build is left out of the run
            print(json.dumps({"variant": v, "build_failed":
                              logs[-6000:]}), flush=True)
            continue
        libs[v] = link(d, srcs[v])
        # ptxas's warnings (a wgmma serialised, say) beside the registers
        warn = sorted({ln.strip() for f in d.glob("*.log")
                       for ln in f.read_text().splitlines()
                       if "warning" in ln.lower()})
        print(json.dumps({"variant": v, "ptxas": attn_registers(d, pattern),
                          "warnings": warn[:20]}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    for v in order:
        if v not in libs:
            continue
        try:
            rc = subprocess.run(
                [sys.executable, __file__, "--child-pair", mode,
                 str(roots[v]), str(libs[v]), v, order[0], only],
                env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"),
                timeout=900).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc and v in ("old", "new"):
            raise SystemExit(f"{v}: the run failed ({rc})")
        if rc:  # an ablation that fails is reported and left out
            print(json.dumps({"variant": v, "run_failed": rc}), flush=True)


def main() -> None:
    if sys.argv[1] == "--child":
        child(*sys.argv[2:5])
        return
    if sys.argv[1] == "--child-pair":
        child_pair(*sys.argv[2:8])
        return
    if sys.argv[1] == "--child-routes":
        child_routes(*sys.argv[2:5])
        return
    mode = {"--widths": "widths", "--stream": "stream"}.get(sys.argv[1])
    if mode:
        del sys.argv[1]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the profile runs on the card")
    out = pathlib.Path(sys.argv[sys.argv.index("--out") + 1]
                       if "--out" in sys.argv else "_checkout/profile_build")
    out = out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    if sys.argv[1] == "--routes":
        main_routes(pathlib.Path(sys.argv[2]).resolve(), out)
        return
    old, new = (pathlib.Path(a).resolve() for a in sys.argv[1:3])
    if mode:
        order = (sys.argv[sys.argv.index("--variants") + 1].split(",")
                 if "--variants" in sys.argv else
                 WIDE_ORDER if mode == "widths" else STREAM_ORDER)
        only = (sys.argv[sys.argv.index("--cases") + 1]
                if "--cases" in sys.argv else "")
        main_pair(mode, old, new, out, order, only)
        return
    roots = {"old": old, "old_bias0": old, "old_occ2": old, "new": new}
    started = {v: prepare(r, v, out) for v, r in roots.items()}
    libs = {}
    for v, (d, procs) in started.items():
        if any(p.wait() for p in procs):
            logs = "".join(p.read_text() for p in d.glob("*.log"))
            raise SystemExit(f"{v}: build failed\n{logs[-4000:]}")
        libs[v] = link(d)
        print(json.dumps({"variant": v, "ptxas": registers(d)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    for v in ("old", "old_bias0", "old_occ2", "new", "new", "old"):
        subprocess.run([sys.executable, __file__, "--child",
                        str(roots[v]), str(libs[v]), v], check=True,
                       env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))


if __name__ == "__main__":
    main()
