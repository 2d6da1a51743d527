#!/usr/bin/env python3
"""Profile of the window attention at the flagship head widths (16, 32, 64;
``csrc/window_attn.cuh``) on the card: two checkouts, and variants of the
second, timed in turns in one run.

    python3 scripts/flagship_attn_profile.py <old_root> <new_root> \
        [--variants old,new,new,old] [--runs main,K,...] [--out DIR]

(DIR, the variants' builds, defaults to ``_checkout/profile_build``.) A
variant whose name starts with ``old`` runs ``old_root``, the others
``new_root``; ``ABLATIONS`` names the source edits a variant makes. For each
variant the flagship widths' attention entries (``swin_window_attn``,
``window_msa_attn``: ``launch_window_attn<MSA, 16, 32, 64>`` of the
checkout's ``window_attn.cuh``, as ``swin_block.cu`` and ``window_msa.cu``
export them) are built alone from one generated source with ``nvcc
-Xptxas -v`` into ``DIR/<variant>/`` (all variants at once; the flagship
instances' registers and spill bytes are printed from the logs), and a
process of its own loads that library into its checkout's
``mask_bev_tpu_torch`` (``kernels.build._lib``) and times each case's
launches of one forward, summed over its blocks (every other block
shifted):

* ``main``: the main path's backbone (``semantic_kitti_default()``: batch
  8, stages (125^2, C 192, 3 heads), (63^2, 384, 6), (32^2, 768, 12),
  (16^2, 1536, 24), head width 64, window 10; 2, 2, 6, 2 blocks), the
  Swin variant in bf16 (12 launches);
* ``K``: path K's (``kitti_default()``: the 800^2 grid, stages 200^2,
  100^2, 50^2, 25^2 at the same widths), the MSA variant in bf16;
* ``refine``: the pixel decoder's refinement (C 256 over 8 heads, head
  width 32, grids 63^2, 32^2, 16^2, two blocks each), MSA in bf16;
* ``main_f32``, ``K_f32``: ``main`` and ``K`` in f32 (3xTF32);
* ``w7``, ``w11``: one block (unshifted, shifted) at windows 7 and 11 on
  the main path's stage-0 widths, Swin in bf16 (the 8-warp instances).

Each case gives the event time (CUDA events around 20 back-to-back calls,
the host's time between calls included where it exceeds the kernel's) and
the device time (``chip_smoke.py::queued_ms``: the calls queued behind a
sleep kernel, so the device runs them back to back), per stage and summed,
and the largest error against the plain version relative to the largest
value. The first variant run also times
``F.scaled_dot_product_attention`` on the same windows (float mask rel +
shift mask; the library yardstick, used on no path), event and device.
Prints one JSON line a variant run and the card's name and power limit.
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
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-lineinfo"]
SOURCES = ("attn_profile.cu", "errors.cu")
# the generated source: the two exported entries of the flagship widths
ENTRIES = """#include "common.cuh"
#include "window_attn.cuh"
#define ARGS const void* qkv, const float* qkv_bias, const float* rel, \\
    void* out, int B, int H, int W, int C, int heads, int win, int shift, \\
    float scale, int f32, cudaStream_t stream
#define PASS qkv, qkv_bias, rel, out, B, H, W, C, heads, win, shift, scale, \\
    f32, stream
MB_EXPORT int swin_window_attn(ARGS) {
  return launch_window_attn<false, 16, 32, 64>(PASS);
}
MB_EXPORT int window_msa_attn(ARGS) {
  return launch_window_attn<true, 16, 32, 64>(PASS);
}
"""


# variant -> [(pattern, text)] in window_attn.cuh (regular expressions):
# three blocks an SM (80 registers), or 88 / 96 registers a thread (three
# blocks of 7 warps); and what a part of the ring kernel costs, the part taken out (its outputs
# are then wrong by design): the exp, the S products, the P v products
# (their operands still consumed), the output stores, the row copies
ABLATIONS = {
    "new_b3": [(r"constexpr int ATT_RING_BLOCKS = \d+;",
                "constexpr int ATT_RING_BLOCKS = 3;")],
    **{f"new_r{r}": [(re.escape("__launch_bounds__(32 * MAXNPT, "
                                "ATT_RING_BLOCKS)"), f"__maxnreg__({r})")]
       for r in (88, 96)},
    "new_noexp": [(re.escape("const float x = expf(s[j][e] - (e < 2 ? m0 : "
                             "m1));"),
                   "const float x = s[j][e] - (e < 2 ? m0 : m1);")],
    "new_nos": [(re.escape("mma_16816(s[j], qa[kk], kb[0], kb[1]);\n"
                           "              mma_16816(s[j], qa[kk + 1], kb[2], "
                           "kb[3]);"), "")],
    "new_nopv": [(re.escape("mma_16816(acc[jd], pa[s2], vb[0], vb[1]);\n"
                            "        mma_16816(acc[jd + 1], pa[s2], vb[2], "
                            "vb[3]);"),
                  "acc[jd][0] += __uint_as_float(pa[s2][0] ^ vb[0]);\n"
                  "        acc[jd + 1][0] += __uint_as_float(pa[s2][1] ^ "
                  "vb[2]);")],
    "new_nostore": [(re.escape("*reinterpret_cast<uint32_t*>(out + (size_t)tr"
                               " * C + cc) =\n            pack_bf16(acc[jd]"
                               "[2 * hh], acc[jd][2 * hh + 1]);"),
                     "if (acc[jd][2 * hh] == 1234.5f)\n"
                     "          *reinterpret_cast<uint32_t*>(out + (size_t)tr"
                     " * C + cc) = 0u;")],
    "new_nocopy": [(re.escape("cp_async16(dst, qkv + (size_t)tr * 3 * C + "
                              "part * C + h * HD + c);"), ";")],
}
BATCH = 8
# (grid, C, heads, blocks) of each case's stages
CASES = {
    "main": (((125, 125), 192, 3, 2), ((63, 63), 384, 6, 2),
             ((32, 32), 768, 12, 6), ((16, 16), 1536, 24, 2)),
    "K": (((200, 200), 192, 3, 2), ((100, 100), 384, 6, 2),
          ((50, 50), 768, 12, 6), ((25, 25), 1536, 24, 2)),
    "refine": (((63, 63), 256, 8, 2), ((32, 32), 256, 8, 2),
               ((16, 16), 256, 8, 2)),
    "stage0": (((125, 125), 192, 3, 2),),
}
# run -> (stages, MSA variant, f32, window)
RUNS = {"main": ("main", False, False, 10), "K": ("K", True, False, 10),
        "refine": ("refine", True, False, 10),
        "main_f32": ("main", False, True, 10),
        "K_f32": ("K", True, True, 10),
        "w7": ("stage0", False, False, 7), "w11": ("stage0", False, False, 11)}


def _module(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas(d: pathlib.Path) -> dict:
    """The flagship widths' attention instances of a build: registers,
    stack frame and spill bytes."""
    mod = _module("ptxas_lines", HERE / "ptxas_lines.py")
    ks = mod.kernels(d)
    names = mod.demangle(ks)
    got = {}
    for k, v in ks.items():
        dem = names[k].split("(")[0]
        if (re.search(r"window_attn_(ring_kernel<|(width_)?kernel<[^,]+, )"
                      r"(16|32|64),", dem) and v[0] is not None):
            got[dem] = dict(registers=v[0], stack=v[1], spill_stores=v[2],
                            spill_loads=v[3])
    return got


def prepare(root: pathlib.Path, variant: str, out: pathlib.Path):
    """Copy ``root``'s kernel sources into ``out/variant`` with the
    variant's edits and the generated source; start nvcc on ``SOURCES``."""
    d = out / variant
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(root / "mask_bev_tpu_torch" / "csrc", d / "csrc")
    path = d / "csrc" / "window_attn.cuh"
    for pat, new in ABLATIONS.get(variant, []):
        text, hits = re.subn(pat, new, path.read_text())
        if not hits:
            raise SystemExit(f"{variant}: {pat!r} not in {path}")
        path.write_text(text)
    (d / "csrc" / SOURCES[0]).write_text(ENTRIES)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = []
    for src in SOURCES:
        stem = pathlib.Path(src).stem
        log = open(d / (stem + ".log"), "w")
        procs.append(subprocess.Popen(
            [nvcc, *FLAGS, "-Xptxas", "-v", "-I", str(d / "csrc"), "-c",
             str(d / "csrc" / src), "-o", str(d / (stem + ".o"))],
            stdout=log, stderr=subprocess.STDOUT))
    return d, procs


def link(d: pathlib.Path) -> pathlib.Path:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lib = d / "libattn.so"
    objs = [str(d / (pathlib.Path(s).stem + ".o")) for s in SOURCES]
    subprocess.run([nvcc, "-shared", "-gencode",
                    "arch=compute_90a,code=sm_90a", *objs, "-o", str(lib)],
                   check=True)
    return lib


def child(root: str, lib: str, variant: str, sdpa: bool, runs) -> None:
    """Time the attention of ``root``'s package on ``lib``."""
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.ops import swin_block as kswin

    smoke = _module("chip_smoke_timing", HERE.parent / "chip_smoke.py")
    kb._lib = ctypes.CDLL(lib)
    dev = "cuda"

    def event_ms(fn):
        return smoke.cuda_ms(torch, fn, 20, warm=2)

    res = {"variant": variant, "root": root}
    with torch.no_grad():
        for run in runs:
            case, msa, f32, win = RUNS[run]
            name = "window_msa" if msa else "swin_block"
            dt = torch.float32 if f32 else torch.bfloat16
            tot = dict(ms=0.0, dev_ms=0.0, sdpa_ms=0.0, sdpa_dev_ms=0.0)
            stages, err = [], 0.0
            kb.reset_launches()
            for i, (hw, c, heads, blocks) in enumerate(CASES[case]):
                g = torch.Generator().manual_seed(70 + i)
                qkv = torch.randn(BATCH * hw[0] * hw[1], 3 * c,
                                  generator=g).to(dev, dt)
                qb = (0.1 * torch.randn(3 * c, generator=g)).to(dev)
                table = (0.02 * torch.randn((2 * win - 1) ** 2, heads,
                                            generator=g)).to(dev, dt)
                rel = kswin.rel_bias_from_table(table, win)
                for shifted in (False, True):
                    shift = kswin.effective_shift(hw, win, shifted)
                    a = (qkv, qb, rel, BATCH, hw, heads, win, shift)
                    got = kswin.attention(name, *a, msa=msa)
                    want = kswin.window_attention_plain(*a, msa=msa)
                    err = max(err, float(
                        (got.float() - want.float()).abs().max()
                        / want.float().abs().max()))
                    del got, want

                    def call():
                        kswin.attention(name, *a, msa=msa)
                    ms, dev_ms = event_ms(call), smoke.queued_ms(
                        torch, call, 20)
                    stages.append([round(ms, 5), round(dev_ms, 5)])
                    tot["ms"] += ms * blocks / 2
                    tot["dev_ms"] += dev_ms * blocks / 2
                    if sdpa:
                        q, k, v, mask = smoke.sdpa_windows(
                            torch, kswin, *a)
                        hd = q.shape[-1]

                        def lib_call():
                            F.scaled_dot_product_attention(
                                q, k, v, attn_mask=mask, scale=hd ** -0.5)
                        tot["sdpa_ms"] += event_ms(lib_call) * blocks / 2
                        tot["sdpa_dev_ms"] += smoke.queued_ms(
                            torch, lib_call, 20) * blocks / 2
                        del q, k, v, mask
                del qkv, qb, rel
            res[run] = dict(
                {k: round(v, 5) for k, v in tot.items()
                 if sdpa or not k.startswith("sdpa")},
                stages=stages, err=err, instances=dict(kb.INSTANCES))
    print(json.dumps(res), flush=True)


def main() -> None:
    if sys.argv[1] == "--child":
        child(*sys.argv[2:5], sys.argv[5] == "1", sys.argv[6].split(","))
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the profile runs on the card")
    old, new = (pathlib.Path(a).resolve() for a in sys.argv[1:3])
    out = pathlib.Path(sys.argv[sys.argv.index("--out") + 1]
                       if "--out" in sys.argv else "_checkout/profile_build")
    out = out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    order = (sys.argv[sys.argv.index("--variants") + 1].split(",")
             if "--variants" in sys.argv else ("old", "new", "new", "old"))
    runs = (sys.argv[sys.argv.index("--runs") + 1]
            if "--runs" in sys.argv else ",".join(RUNS))
    roots = {v: old if v.startswith("old") else new for v in order}
    started = {v: prepare(r, v, out) for v, r in roots.items()}
    libs = {}
    for v, (d, procs) in started.items():
        if any(p.wait() for p in procs):  # reported, left out of the turns
            logs = "".join(p.read_text() for p in d.glob("*.log"))
            print(f"{v}: build failed\n{logs[-3000:]}", flush=True)
            continue
        libs[v] = link(d)
        print(json.dumps({"variant": v, "ptxas": ptxas(d)}), flush=True)
    if not libs:
        raise SystemExit("no variant built")
    order = [v for v in order if v in libs]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    for i, v in enumerate(order):
        subprocess.run([sys.executable, __file__, "--child", str(roots[v]),
                        str(libs[v]), v, "1" if i == 0 else "0", runs],
                       check=True,
                       env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))


if __name__ == "__main__":
    main()
