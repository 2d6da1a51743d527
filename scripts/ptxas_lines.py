#!/usr/bin/env python3
"""Registers and spills of every CUDA kernel of the PyTorch port, as ptxas
reports them, and a comparison of two checkouts.

    python3 scripts/ptxas_lines.py <root>                # one checkout
    python3 scripts/ptxas_lines.py --compare <old> <new>

Each checkout's kernels are built from its own sources
(``mask_bev_tpu_torch/kernels/build.py``, ``nvcc -Xptxas -v``: the logs of
the build directory), both at once with ``--compare``. A line a kernel:
its demangled name, registers, stack frame and spill bytes; a function a
kernel calls that is not inlined gets a line of its own (its stack frame
and spills; ptxas gives its registers only with the kernel's). ``--compare``
prints the kernels and functions present in both builds whose lines
differ, and those that only one has, and exits 1 if one of both differs: a
change that adds instances must leave the ones it had compiling as before.
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ENTRY = re.compile(r"Compiling entry function '([^']+)'")
PROPS = re.compile(r"Function properties for (\S+)")
# a static function's name carries hashes of its translation unit
INTERNAL = re.compile(r"_INTERNAL_[0-9a-f]{8}_(\d+_\w+?_cu)_[0-9a-f]{8}")
FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                   r"(\d+) bytes spill loads")
USED = re.compile(r"Used (\d+) registers")

BUILD = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
         "from mask_bev_tpu_torch.kernels import build as kb; "
         "print(json.dumps(str(kb.build().parent)))")


def build_dir(root: str) -> pathlib.Path:
    """Build ``root``'s kernels in a process of its own; their directory."""
    out = subprocess.run([sys.executable, "-c", BUILD, root],
                         capture_output=True, text=True, check=True)
    return pathlib.Path(json.loads(out.stdout.strip().splitlines()[-1]))


def kernels(logs: pathlib.Path) -> dict:
    """mangled name -> (registers, stack frame, spill stores, spill loads)
    of every kernel and every function not inlined (registers None), from
    every ``*.log`` of a build directory."""
    got = {}
    for log in sorted(logs.glob("*.log")):
        name = props = None
        for line in log.read_text().splitlines():
            m = ENTRY.search(line)
            if m:
                name = m.group(1)
                got[name] = [None, 0, 0, 0]
                continue
            m = PROPS.search(line)
            if m:
                props = INTERNAL.sub(r"_INTERNAL_\1", m.group(1))
                got.setdefault(props, [None, 0, 0, 0])
                continue
            m = FRAME.search(line)
            if m and props is not None:
                got[props][1:] = [int(v) for v in m.groups()]
            m = USED.search(line)
            if m and name is not None:
                got[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in got.items()}


def demangle(names) -> dict:
    names = list(names)
    tool = shutil.which("c++filt")
    if not tool or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {
        n: n for n in names}


def line(name: str, v) -> str:
    return (f"{name}: {v[0]} registers, {v[1]} bytes stack frame, {v[2]} "
            f"bytes spill stores, {v[3]} bytes spill loads")


def main(argv) -> int:
    if argv[:1] == ["--compare"] and len(argv) == 3:
        with ThreadPoolExecutor(2) as pool:
            old, new = (kernels(d) for d in pool.map(build_dir, argv[1:]))
        names = demangle(set(old) | set(new))
        both = sorted(set(old) & set(new), key=names.get)
        changed = [k for k in both if old[k] != new[k]]
        print(f"[ptxas compare] {len(both)} kernels and functions in both "
              "builds, "
              f"{len(changed)} changed, {len(set(new) - set(old))} new, "
              f"{len(set(old) - set(new))} gone", flush=True)
        for k in changed:
            print("[ptxas changed] " + line(names[k], old[k]) + " -> "
                  + f"{new[k][0]} registers, {new[k][2]}/{new[k][3]} bytes "
                  "spilled", flush=True)
        for k in sorted(set(new) - set(old), key=names.get):
            print("[ptxas new] " + line(names[k], new[k]), flush=True)
        for k in sorted(set(old) - set(new), key=names.get):
            print("[ptxas gone] " + line(names[k], old[k]), flush=True)
        return 1 if changed else 0
    if len(argv) == 1:
        got = kernels(build_dir(argv[0]))
        names = demangle(got)
        for k in sorted(got, key=names.get):
            print("[ptxas] " + line(names[k], got[k]))
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
