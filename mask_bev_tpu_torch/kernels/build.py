"""Build, load and call the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` at first
use (one ``nvcc`` process per source, all started together), linked into one
shared library with a plain C interface, and loaded with ``ctypes``. The
build goes to ``mask_bev_tpu_torch/_build/<hash of the sources>/``, which
``.gitignore`` lists, so a fresh checkout builds its kernels from its own
sources and nothing else.

Every exported C function returns ``cudaGetLastError()`` as an int; the
``launch`` helper raises when it is not 0. Launch counts live in
``LAUNCHES`` (one plain integer per kernel): each wrapper adds to its count
where it launches, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Optional

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {
    "pfn": 0, "canvas_norm": 0, "swin_block": 0, "decoder_stack": 0,
    "canvas_scatter": 0, "canvas_scatter_bwd": 0, "hungarian": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                       "the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-lineinfo"]


def build() -> pathlib.Path:
    """Compile the sources (if this digest is not built yet); return the
    library path. Objects compile in parallel, one nvcc per source."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libmaskbev_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    objs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        objs.append(obj)
        cmd = [nvcc, *FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
               "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, p in procs:
        out, _ = p.communicate()
        (out_dir / (src.stem + ".log")).write_text(out)
        if p.returncode != 0:
            errors.append(f"{src.name} failed:\n{out}")
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    tmp = out_dir / f"lib.{os.getpid()}.so"
    link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
            *map(str, objs), "-o", str(tmp)]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"CUDA kernel link failed:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the CUDA kernels need a CUDA device")
            _lib = ctypes.CDLL(str(build()))
    return _lib


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def launch(name: str, fn: str, *args) -> None:
    """Call exported C function ``fn`` (every argument already a ctypes
    value), raise on a launch error, and count one launch of ``name``."""
    f = getattr(lib(), fn)
    f.restype = ctypes.c_int
    rc = f(*args)
    if rc != 0:
        err_name = lib().mb_error_name
        err_name.restype = ctypes.c_char_p
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: error {rc} "
                           f"({err_name(ctypes.c_int(rc)).decode()})")
    LAUNCHES[name] += 1


def check_cuda(t: torch.Tensor, name: str, dtype=None, shape=None) -> None:
    """Wrapper-side argument check: device, dtype, shape, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ci(v: int) -> ctypes.c_int:
    return ctypes.c_int(int(v))


def cf(v: float) -> ctypes.c_float:
    return ctypes.c_float(float(v))
