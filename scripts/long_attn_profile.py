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

profiles the head-width instances instead (``attn_widths_swin.cu``: the
old checkout's ``window_attn_kernel`` staged at the next flagship width,
the new one's ``window_attn_width_kernel``): the Swin attention at head
widths 8, 24, 40, 48 and 56 on the stage-0 grid (8 x 125^2, C 72 / 192 /
120 / 192 / 168 over 9 / 8 / 3 / 4 / 3 heads, window 10, shifted), bf16
(and f32 for ``old`` and ``new``), each call's error against its plain
version (ablations are wrong by design), SDPA beside ``new``. Variants:
``old``; ``old_bias0`` (the expanded bias neither staged nor read: what
(a) costs); ``old_exact48`` (head width 48 staged at 48: what (b) costs
there; the other widths have no exact layout in the old kernel);
``old_occ3`` (launch bounds for three blocks an SM: (c)); ``new``;
``new_occ2`` / ``new_occ3`` (the bf16 instances built for two / three
blocks an SM); ``new_npt8_2`` / ``new_npt8_4`` (the 8-warp bf16 instances
for two / four); ``new_wpb2`` / ``new_wpb1`` (2 / 1 windows a block).
Each variant also times the bf16 attention at windows 7 and 11 (the
8-warp instances) at head widths 8 and 48. Order: old, the old ablations,
new, the new variants, new, old (``--variants`` picks some, in order).

    python3 scripts/long_attn_profile.py --stream <root>

holds the two kernels of windows over 128 tokens against each other in
one checkout, where both take the window: ``long`` (as it is: windows of
129-256 tokens at head widths up to 64 run ``window_attn_long_kernel``)
and ``stream`` (the streaming entry's refusal of those windows taken out
of ``window_attn.cuh`` and ``ops/swin_block.py::attn_route`` sending every
window over 128 tokens to it, so they run ``window_attn_stream_kernel``).
Each times ``.w12`` (24 launches, as above) and window 16 at the stage-0
widths, both variants, bf16 and f32, each call's error against its plain
version beside it. Order: long, stream, stream, long.
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
WIDTH_SOURCES = ("attn_widths_swin.cu", "errors.cu")
WIDTH_ABLATIONS = {
    "old_bias0": [
        (re.escape("for (int e = tid; e < n * n; e += nthr) {"),
         "for (int e = tid; e < 0; e += nthr) {"),
        (re.escape("float bias = r < n ? to_f(bs[r * ldb + c]) : 0.f;"),
         "float bias = 0.f;")],
    "old_exact48": [
        (re.escape("return hd <= 16 ? 16 : hd <= 32 ? 32 : 64;"),
         "return hd == 48 ? 48 : hd <= 16 ? 16 : hd <= 32 ? 32 : 64;")],
    "old_occ3": [(re.escape("__launch_bounds__(32 * MAXNPT, 2) "
                            "window_attn_kernel("),
                  "__launch_bounds__(32 * MAXNPT, 3) window_attn_kernel(")],
    "new_occ2": [(r"#define ATT_WIDTH_BLOCKS_BF16_NPT(\d) \d+",
                  r"#define ATT_WIDTH_BLOCKS_BF16_NPT\1 2")],
    "new_occ3": [(r"#define ATT_WIDTH_BLOCKS_BF16_NPT7 \d+",
                  "#define ATT_WIDTH_BLOCKS_BF16_NPT7 3")],
    "new_npt8_2": [(r"#define ATT_WIDTH_BLOCKS_BF16_NPT8 \d+",
                    "#define ATT_WIDTH_BLOCKS_BF16_NPT8 2")],
    "new_npt8_4": [(r"#define ATT_WIDTH_BLOCKS_BF16_NPT8 \d+",
                    "#define ATT_WIDTH_BLOCKS_BF16_NPT8 4")],
    "new_wpb2": [(r"constexpr int ATT_WIDTH_WPB = \d+;",
                  "constexpr int ATT_WIDTH_WPB = 2;")],
    "new_wpb1": [(r"constexpr int ATT_WIDTH_WPB = \d+;",
                  "constexpr int ATT_WIDTH_WPB = 1;")],
}
STREAM_SOURCES = ("swin_block.cu", "window_msa.cu", "attn_stream_swin.cu",
                  "attn_stream_msa.cu", "errors.cu")
STREAM_ABLATIONS = {
    "stream": [(re.escape("if (hd % 8 || hd > 128 || (hd <= 64 && NP <= 16 "
                          "* ATT_LONG_MAX_NPT))"),
                "if (hd % 8 || hd > 128)")],
}
# (head width, heads) at the stage-0 grid
WIDTH_CASES = ((8, 9), (24, 8), (40, 3), (48, 4), (56, 3))
# the 8-warp instances: windows 7 and 11 at these widths
WIDTH_NPT8 = ((8, 9), (48, 4))
WIDTH_ORDER = ("old", "old_bias0", "old_exact48", "old_occ3", "new",
               "new_occ2", "new_occ3", "new_npt8_2", "new_npt8_4",
               "new_wpb2", "new_wpb1", "new", "old")
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


def width_registers(d: pathlib.Path) -> dict:
    """The one-pass head-width instances (7 or 8 warps): registers, spill
    bytes and the blocks an SM their registers allow (registers go to a
    warp in units of 256)."""
    spec = importlib.util.spec_from_file_location(
        "ptxas_lines", HERE / "ptxas_lines.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = {}
    ks = mod.kernels(d)
    names = mod.demangle(ks)
    for name, (regs, _, st, ld) in ks.items():
        dem = names[name].split("(")[0]
        m = re.search(r"window_attn_(width_)?kernel<[^,]+, \d+, ([78]),",
                      dem)
        if regs is None or not m:
            continue
        per_warp = -(-regs * 32 // 256) * 256
        got[dem] = dict(registers=regs, spill_stores=st, spill_loads=ld,
                        blocks=65536 // per_warp // int(m.group(2)))
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


def child_widths(root: str, lib: str, variant: str) -> None:
    """Time the head-width instances of ``root``'s package on ``lib``."""
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.ops import swin_block as kswin

    kb._lib = ctypes.CDLL(lib)
    dev, hw, win = "cuda", (125, 125), 10

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

    res = {"variant": variant, "root": root}
    shift = kswin.effective_shift(hw, win, True)
    dtypes = ((torch.bfloat16, torch.float32)
              if variant in ("old", "new") else (torch.bfloat16,))
    with torch.no_grad():
        for hd, heads in WIDTH_CASES:
            c = hd * heads
            for dt in dtypes:
                key = f"hd{hd}" + ("_f32" if dt == torch.float32 else "")
                g = torch.Generator().manual_seed(hd)
                qkv = torch.randn(BATCH * hw[0] * hw[1], 3 * c,
                                  generator=g).to(dev, dt)
                qb = (0.1 * torch.randn(3 * c, generator=g)).to(dev)
                table = (0.02 * torch.randn((2 * win - 1) ** 2, heads,
                                            generator=g)).to(dev, dt)
                rel = kswin.rel_bias_from_table(table, win)
                a = (qkv, qb, rel, BATCH, hw, heads, win, shift)
                got = kswin.attention("swin_block", *a, msa=False)
                want = kswin.window_attention_plain(*a, msa=False)
                res[key + "_err"] = float(
                    (got.float() - want.float()).abs().max()
                    / want.float().abs().max())
                del got, want
                res[key + "_ms"] = round(cuda_ms(
                    lambda: kswin.attention("swin_block", *a, msa=False)), 5)
                if variant == "new":
                    q, k, v = (t.contiguous() for t in kswin.qkv_windows(
                        qkv, qb, BATCH, hw, heads, win, shift))
                    mask = (rel.float()[None] + kswin.shift_mask(
                        hw, win, shift, qkv.device)[:, None]).repeat(
                        BATCH, 1, 1, 1).to(dt).contiguous()
                    res[key + "_sdpa_ms"] = round(cuda_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=mask, scale=hd ** -0.5),
                        reps=5), 5)
                    del q, k, v, mask
                del qkv, qb, rel
        for (hd, heads), w in ((x, w) for x in WIDTH_NPT8 for w in (7, 11)):
            c = hd * heads
            g = torch.Generator().manual_seed(hd + w)
            qkv = torch.randn(BATCH * hw[0] * hw[1], 3 * c, generator=g).to(
                dev, torch.bfloat16)
            qb = (0.1 * torch.randn(3 * c, generator=g)).to(dev)
            table = (0.02 * torch.randn((2 * w - 1) ** 2, heads,
                                        generator=g)).to(dev, torch.bfloat16)
            a = (qkv, qb, kswin.rel_bias_from_table(table, w), BATCH, hw,
                 heads, w, kswin.effective_shift(hw, w, True))
            res[f"hd{hd}_w{w}_ms"] = round(cuda_ms(
                lambda: kswin.attention("swin_block", *a, msa=False)), 5)
            del qkv, qb, a
    print(json.dumps(res), flush=True)


def child_stream(root: str, lib: str, variant: str) -> None:
    """Time ``root``'s attention at windows 12 and 16 on ``lib``, through
    the long-window kernel or (``stream``) the streaming one."""
    sys.path.insert(0, root)
    import torch

    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.ops import swin_block as kswin

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
                ms, err = {"w12": 0.0, "w16": 0.0}, 0.0
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
                        ms[label] += cuda_ms(lambda: kswin.attention(
                            name, *a, msa=msa)) * blocks / 2
                    del qkv, qb, rel
                # ms: the launches of one forward (.w12: 24; w16: one
                # block unshifted, one shifted)
                for label in ms:
                    res[f"{label}_{key}_ms"] = round(ms[label], 5)
                res[f"{key}_err"] = err
                res[f"{key}_instances"] = dict(kb.INSTANCES)
    print(json.dumps(res), flush=True)


def main_stream(root: pathlib.Path, out: pathlib.Path) -> None:
    order = ("long", "stream", "stream", "long")
    started = {v: prepare(root, v, out, STREAM_SOURCES,
                          ablations=STREAM_ABLATIONS) for v in set(order)}
    libs = {}
    for v, (d, procs) in started.items():
        if any(p.wait() for p in procs):
            logs = "".join(p.read_text() for p in d.glob("*.log"))
            raise SystemExit(f"{v}: build failed\n{logs[-4000:]}")
        libs[v] = link(d, STREAM_SOURCES)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    for v in order:
        subprocess.run([sys.executable, __file__, "--child-stream",
                        str(root), str(libs[v]), v], check=True,
                       env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))


def main_widths(old: pathlib.Path, new: pathlib.Path, out: pathlib.Path,
                order=WIDTH_ORDER) -> None:
    roots = {v: old if v.startswith("old") else new for v in order}
    started = {v: prepare(r, v, out, WIDTH_SOURCES, ablations=WIDTH_ABLATIONS)
               for v, r in roots.items()}
    libs = {}
    for v, (d, procs) in started.items():
        if any(p.wait() for p in procs):
            logs = "".join(p.read_text() for p in d.glob("*.log"))
            raise SystemExit(f"{v}: build failed\n{logs[-4000:]}")
        libs[v] = link(d, WIDTH_SOURCES)
        print(json.dumps({"variant": v, "ptxas": width_registers(d)}),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    for v in order:
        subprocess.run([sys.executable, __file__, "--child-widths",
                        str(roots[v]), str(libs[v]), v], check=True,
                       env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))


def main() -> None:
    if sys.argv[1] == "--child":
        child(*sys.argv[2:5])
        return
    if sys.argv[1] == "--child-widths":
        child_widths(*sys.argv[2:5])
        return
    if sys.argv[1] == "--child-stream":
        child_stream(*sys.argv[2:5])
        return
    widths = sys.argv[1] == "--widths"
    stream = sys.argv[1] == "--stream"
    if widths or stream:
        del sys.argv[1]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the profile runs on the card")
    if stream:
        out = pathlib.Path(sys.argv[sys.argv.index("--out") + 1]
                           if "--out" in sys.argv
                           else "_checkout/profile_build")
        main_stream(pathlib.Path(sys.argv[1]).resolve(), out.resolve())
        return
    old, new = (pathlib.Path(a).resolve() for a in sys.argv[1:3])
    out = pathlib.Path(sys.argv[sys.argv.index("--out") + 1]
                       if "--out" in sys.argv else "_checkout/profile_build")
    out = out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    if widths:
        order = (sys.argv[sys.argv.index("--variants") + 1].split(",")
                 if "--variants" in sys.argv else WIDTH_ORDER)
        main_widths(old, new, out, order)
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
