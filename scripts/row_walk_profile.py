#!/usr/bin/env python3
"""Profile of the row walks (kernel 9's rows over 2048 values and the Swin
LN's) on the card: two checkouts and ablations of the second, timed in
turns in one run.

    python3 scripts/row_walk_profile.py <old_root> <new_root> [--out DIR]

    python3 scripts/row_walk_profile.py <old_root> <new_root> --no-swin \
        --variants old,new,new_fma,...

(DIR, the variants' builds, defaults to ``_checkout/profile_build``;
``--variants`` picks variants in order, ``--no-swin`` times kernel 9
only.)

The old checkout walks a row in 8-value words through
``csrc/common.cuh::row_walk``: about one 16-byte load in flight a lane, and
two passes over the row (kernel 9: the sums, then the output; the Swin LN:
three). The new one holds the row in registers (``RowRegs``): every load
of a lane issued before the first reduction (a), one pass over the row (b).
The two causes apart:

* ``old``: the old checkout as it is (neither);
* ``new_twopass``: the new kernel 9 with its output pass reading the row
  again from memory (L1 / L2) in place of the registers: (a) alone;
* ``new_serial``: the new kernels with each load's address depending on the
  data of the load before it (an added zero: one load in flight a lane, as
  the walk), the row still read once: (b) alone;
* ``new``: the new checkout (both).

Kernel 9's variance in the new kernel, against the walk's bits:
``new_fma`` (``E[x^2] - mean^2`` as one fused multiply-add, in place of a
rounded product and a subtraction), ``new_oldstats`` (the walk's
``ln_row_stats`` for the statistics, reading the row again); its blocks an
SM: ``new_occ1`` / ``new_occ3`` (launch bounds for 1 / 3). The warps a
row of both wide kernels (``layer_norm.cu::LN_WIDE_WARPS``, 4;
``swin_block.cu::SWIN_LN_WIDE_WARPS``, 2), both patched in the sources
and kernel 9's mirrored in the child's plan
(``ops/layer_norm.py::WIDE_WARPS``): ``new_w1`` (1 in bf16 / 2 in f32, the
first design), ``new_w2`` (2 / 2), ``new_w4`` (4 / 4).

For each variant ``csrc/layer_norm.cu`` and ``errors.cu`` (and
``swin_block.cu`` for old, new, new_serial and the warp variants) are
built alone with ``nvcc
-Xptxas -v`` into ``DIR/<variant>/`` (all variants at once); a process of
its own loads that library into its checkout's ``mask_bev_tpu_torch``
(``kernels.build._lib``) and times, as device time with the calls queued
(``chip_smoke.py::queued_ms``), kernel 9 at ``chip_smoke.WALK_LN_CASES``
and the Swin LN (bf16 / f32 out, int8 rows) at ``WALK_SWIN_CASES``, bf16
and f32, on ``chip_smoke.walk_inputs``, with each output's sha256
(``chip_smoke.walk_digests``'s keys) and ``F.layer_norm``'s device time
beside ``old`` and ``new``. Order: old, new_twopass, new_serial, new, new,
old. Prints one JSON line a run, the card's name and power limit, and a
summary (ms a variant, the spread of the repeated ones, the digests that
differ from ``old``'s). ``ncu`` does not run on the card's machine, so
stall reasons are not measured.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
ORDER = ("old", "new_twopass", "new_serial", "new", "new", "old")
STATS = "(?s)" + re.escape("float acc[2] = {0.f, 0.f};") + ".*?" + re.escape(
    "const float rstd = rsqrtf(var + eps);")
VAR = re.escape("fmaxf(__fsub_rn(acc[1] / (float)C, __fmul_rn(mean, mean)), "
                "0.f);")
# the warps a row (bf16, f32) of the warp variants: both wide kernels
# patched, kernel 9's plan (ops/layer_norm.py::WIDE_WARPS) set to match
WARPS = {"new_w1": {False: 1, True: 2}, "new_w2": {False: 2, True: 2},
         "new_w4": {False: 4, True: 4}}
WARP_TEXT = {"new_w1": "(sizeof(T) == 2 ? 1 : 2)", "new_w2": "2",
             "new_w4": "4"}
# variant -> (file, pattern, ablation text): regular expressions that must
# match
ABLATIONS = {
    "new_fma": [("layer_norm.cu", VAR,
                 "fmaxf(__fmaf_rn(-mean, mean, acc[1] / (float)C), 0.f);")],
    "new_oldstats": [("layer_norm.cu", STATS,
                      "float mean, rstd;\n  ln_row_stats<true>(xr, C, lane, "
                      "32, true, eps, mean, rstd);")],
    "new_occ1": [("layer_norm.cu", r"#define LN_WIDE_BLOCKS \d+",
                  "#define LN_WIDE_BLOCKS 1")],
    "new_occ3": [("layer_norm.cu", r"#define LN_WIDE_BLOCKS \d+",
                  "#define LN_WIDE_BLOCKS 3")],
    "new_twopass": [("layer_norm.cu",
                     re.escape("unpack_word(r.u[i], v);  // the held row "
                               "(not read again)"),
                     "ld8(xr + 8 * wd, v);  // the row again (L1 / L2)")],
    "new_serial": [("common.cuh",
                    re.escape("for (int h = 0; h < N; ++h) "
                              "r.u[i][h] = src[h];"),
                    "for (int h = 0; h < N; ++h) r.u[i][h] = src[h];\n"
                    "      xr += r.u[i][0].x & ((unsigned)words >> 20);")],
    **{v: [("layer_norm.cu", r"#define LN_WIDE_WARPS \d+",
            f"#define LN_WIDE_WARPS {s}"),
           ("swin_block.cu", r"#define SWIN_LN_WIDE_WARPS \d+",
            f"#define SWIN_LN_WIDE_WARPS {s}")]
       for v, s in WARP_TEXT.items()},
}


def _module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sources(variant: str, swin: bool = True):
    """The sources a variant builds: the Swin LN's too where it is timed
    (not for the kernel 9 ablations, nor with ``--no-swin``)."""
    if swin and (variant in ("old", "new", "new_serial")
                 or variant in WARPS):
        return ("layer_norm.cu", "swin_block.cu", "errors.cu")
    return ("layer_norm.cu", "errors.cu")


def child(root: str, new_root: str, lib: str, variant: str) -> None:
    """Time ``root``'s row walks on ``lib``."""
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.ops import layer_norm as kln
    from mask_bev_tpu_torch.ops import swin_block as kswin

    smoke = _module(pathlib.Path(new_root) / "chip_smoke.py", "chip_smoke")
    kb._lib = ctypes.CDLL(lib)
    lib_too = variant in ("old", "new")
    res = {"variant": variant, "root": root}
    with torch.no_grad():
        for c, rows in smoke.WALK_LN_CASES:
            for f32 in (False, True):
                if variant in WARPS:  # the plan's warps a token
                    kln.WIDE_WARPS = WARPS[variant][f32]
                key = f"ln_c{c}" + ("_f32" if f32 else "")
                x, w, b = smoke.walk_inputs(torch, c, rows, f32)
                got = kln.layer_norm(x, w, b)
                want = kln.layer_norm_plain(x, w, b)
                res[key + "_err"] = float((got.float() - want.float()).abs()
                                          .max() / want.float().abs().max())
                res[key + "_sha"] = smoke.digest(torch, got)[:16]
                res[key + "_ms"] = round(smoke.queued_ms(
                    torch, lambda: kln.layer_norm(x, w, b), 20), 5)
                if lib_too:
                    res[key + "_lib_ms"] = round(smoke.queued_ms(
                        torch, lambda: F.layer_norm(x, (c,), w, b, 1e-6),
                        20), 5)
                del x, w, b, got, want
        if hasattr(kb.lib(), "swin_layernorm"):
            for c, rows in smoke.WALK_SWIN_CASES:
                for f32 in (False, True):
                    x, w, b = smoke.walk_inputs(torch, c, rows, f32)
                    for quant in (False, True):
                        key = (f"swin_c{c}" + ("_f32" if f32 else "")
                               + ("_int8" if quant else ""))
                        got = kswin._ln(x, w, b, quant)
                        res[key + "_sha"] = smoke.digest(
                            torch, *(got if quant else (got,)))[:16]
                        if not quant:
                            want = kswin.layer_norm_p(x, w, b)
                            res[key + "_err"] = float(
                                (got.float() - want.float()).abs().max()
                                / want.float().abs().max())
                        res[key + "_ms"] = round(smoke.queued_ms(
                            torch, lambda: kswin._ln(x, w, b, quant), 20), 5)
                        if lib_too and not quant:
                            res[key + "_lib_ms"] = round(smoke.queued_ms(
                                torch, lambda: F.layer_norm(
                                    x, (c,), w, b, 1e-6), 20), 5)
                    del x, w, b
    print(json.dumps(res), flush=True)


def prepare(root: pathlib.Path, variant: str, out: pathlib.Path,
            swin: bool):
    """``root``'s kernel sources with the variant's ablation, nvcc started
    on :func:`sources` (long_attn_profile.py's builder)."""
    lap = _module(HERE / "long_attn_profile.py", "long_attn_profile")
    return lap.prepare(root, variant, out, sources(variant, swin),
                       "common.cuh", ABLATIONS)


def main() -> None:
    if sys.argv[1] == "--child":
        child(*sys.argv[2:6])
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the profile runs on the card")
    old, new = (pathlib.Path(a).resolve() for a in sys.argv[1:3])
    out = pathlib.Path(sys.argv[sys.argv.index("--out") + 1]
                       if "--out" in sys.argv else "_checkout/profile_build")
    out = out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    lap = _module(HERE / "long_attn_profile.py", "long_attn_profile")
    pl = _module(HERE / "ptxas_lines.py", "ptxas_lines")
    order = (sys.argv[sys.argv.index("--variants") + 1].split(",")
             if "--variants" in sys.argv else ORDER)
    swin = "--no-swin" not in sys.argv
    roots = {v: old if v == "old" else new for v in order}
    started = {v: prepare(r, v, out, swin) for v, r in roots.items()}
    libs = {}
    for v, (d, procs) in started.items():
        if any(p.wait() for p in procs):
            logs = "".join(p.read_text() for p in d.glob("*.log"))
            raise SystemExit(f"{v}: build failed\n{logs[-4000:]}")
        libs[v] = lap.link(d, sources(v, swin))
        ks = pl.kernels(d)
        names = pl.demangle(ks)
        regs = {names[k].split("(")[0]: dict(registers=r, spill_stores=st,
                                             spill_loads=ld)
                for k, (r, _, st, ld) in ks.items()
                if re.search(r"layernorm|swin_rows", names[k])}
        print(json.dumps({"variant": v, "ptxas": regs}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    runs = []
    for v in order:
        r = subprocess.run([sys.executable, __file__, "--child",
                            str(roots[v]), str(new), str(libs[v]), v],
                           check=True, capture_output=True, text=True,
                           env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
        print(r.stdout.strip(), flush=True)
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    # summary: each case's ms a variant (min and max over its runs), its
    # digest against old's
    ref = next(r for r in runs if r["variant"] == "old")
    for key in sorted(k[:-3] for k in ref if k.endswith("_ms")
                      and not k.endswith("_lib_ms")):
        row = {}
        for r in runs:
            if key + "_ms" in r:
                row.setdefault(r["variant"], []).append(r[key + "_ms"])
        lib = [r[key + "_lib_ms"] for r in runs if key + "_lib_ms" in r]
        same = {r["variant"]: r.get(key + "_sha") == ref.get(key + "_sha")
                for r in runs if key + "_sha" in r}
        print(json.dumps({"case": key, "ms": row, "lib_ms": lib,
                          "digest_as_old": same}), flush=True)


if __name__ == "__main__":
    main()
