#!/usr/bin/env python3
"""The GEMM's N tail on the card: two checkouts and variants of the new
one, timed in turns in one run.

    python3 scripts/gemm_tail_profile.py <old_root> <new_root> [--out DIR]

For each variant the GEMM's sources (``gemm*.cu``, ``errors.cu``) are
built alone with ``nvcc -Xptxas -v`` into ``DIR/<variant>/`` (default
``_checkout/profile_build``; all variants at once), and a process of its
own loads that library into the checkout's ``mask_bev_tpu_torch``
(``kernels.build._lib``) and times ``ops/swin_block.py::gemm`` with the
bias epilogue on the stage-0 rows of ``chip_smoke.py``'s ``[shapes
tail]`` (125000 x K, K 24 and 40, A at the GEMM's pitch):

* N 100 (the N tail) in bf16, int8 (bf16 out) and 3xTF32;
* N 96 and N 104 (the flagship instances): a small K's own cost;
* ``torch.addmm`` at N 100 (bf16, f32), the library call.

Each time twice: CUDA events over 20 back-to-back calls (as
``chip_smoke.py``: the host's time a call included where it is the
longer) and the profiler's device time of the kernels alone. Variants:
``old`` (the first N-tail instance, ``gemm_kernel<OP | OP_NTAIL>``),
``new`` (``csrc/gemm_ntail.cu`` as committed: two buffers of A
fragments in turn) and ``new_abuf4`` (a buffer for each of a stage's
four k-steps, all in flight: 96 registers with 472-856 bytes spilled
on the H100's ptxas). Order: old, new, new_abuf4, new_abuf4, new, old.
Each variant's registers and spills come
from its ptxas log. Prints one JSON line a run and the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location(
    "long_attn_profile", HERE / "long_attn_profile.py")
lap = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(lap)

# (old text, variant text) in the new checkout's gemm_ntail.cu
VARIANTS = {
    "new_abuf4": [("constexpr int NT_ABUF = 2;",
                   "constexpr int NT_ABUF = 4;")],
}
M = 125000


def sources(root: pathlib.Path):
    csrc = root / "mask_bev_tpu_torch" / "csrc"
    return tuple(sorted(p.name for p in csrc.glob("gemm*.cu"))) + (
        "errors.cu",)


def child(root: str, lib: str, variant: str) -> None:
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.ops import swin_block as kswin

    kb._lib = ctypes.CDLL(lib)

    def event_ms(fn, reps=20):
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

    def device_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        return us / 1e3 / reps

    res = {"variant": variant, "root": root}
    g = torch.Generator().manual_seed(90)
    with torch.no_grad():
        for k in (24, 40):
            a32 = torch.randn(M, k, generator=g).to("cuda")
            for n in (100, 96, 104):
                w32 = (torch.randn(n, k, generator=g) / k ** 0.5).to("cuda")
                bias = (0.1 * torch.randn(n, generator=g)).to("cuda")
                for kind in ("bf16", "int8", "f32"):
                    dt = torch.float32 if kind == "f32" else torch.bfloat16
                    d = kswin.make_dense(w32.to(dt), bias, kind == "int8")
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
                    key = f"k{k}_n{n}_{kind}"
                    res[key] = [round(event_ms(run), 5),
                                round(device_ms(run), 5)]
                    if n == 100 and kind != "int8" and variant == "new":
                        wl, bl = d.wt.t(), bias.to(dt)
                        lib_run = lambda: torch.addmm(  # noqa: E731
                            bl, a, wl)
                        res[key + "_addmm"] = [round(event_ms(lib_run), 5),
                                               round(device_ms(lib_run), 5)]
                    del a, d
    print(json.dumps(res), flush=True)


def main() -> None:
    if sys.argv[1] == "--child":
        child(*sys.argv[2:5])
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the profile runs on the card")
    old, new = (pathlib.Path(a).resolve() for a in sys.argv[1:3])
    out = pathlib.Path(sys.argv[sys.argv.index("--out") + 1]
                       if "--out" in sys.argv else "_checkout/profile_build")
    out = out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    roots = {"old": old, "new": new, "new_abuf4": new}
    started = {v: lap.prepare(r, "gemm_" + v, out, sources(r),
                              "gemm_ntail.cu" if r == new else "gemm.cu",
                              {"gemm_" + k: t for k, t in VARIANTS.items()})
               for v, r in roots.items()}
    libs = {}
    for v, (d, procs) in started.items():
        if any(p.wait() for p in procs):
            logs = "".join(p.read_text() for p in d.glob("*.log"))
            raise SystemExit(f"{v}: build failed\n{logs[-4000:]}")
        libs[v] = lap.link(d, sources(roots[v]))
        regs = {}
        spec = importlib.util.spec_from_file_location(
            "ptxas_lines", HERE / "ptxas_lines.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for name, (r, _, st, ld) in mod.kernels(d).items():
            # the new instances, or the old gemm_kernel<4 | kind, OT>
            if "ntail" in name or any(f"gemm_kernelILi{op}E" in name
                                      for op in (4, 5, 6)):
                regs[name] = dict(registers=r, spill_stores=st,
                                  spill_loads=ld)
        print(json.dumps({"variant": v, "ptxas": regs}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    for v in ("old", "new", "new_abuf4", "new_abuf4", "new", "old"):
        subprocess.run([sys.executable, __file__, "--child",
                        str(roots[v]), str(libs[v]), v], check=True,
                       env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))


if __name__ == "__main__":
    main()
