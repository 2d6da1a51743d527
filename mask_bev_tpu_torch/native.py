"""ctypes bindings of the port's C++ host core (``csrc/host/maskbev_host.cpp``).

The library is built at first call, not on import: ``g++ -O3 -fPIC -shared
-std=c++17`` from the checkout's own source into
``mask_bev_tpu_torch/_build/host-<hash of the source>/libmaskbev_host.so``
(``.gitignore`` lists ``_build/``). It is written under a temporary name and
moved into place with ``os.replace``, so processes that build at once each
load a whole file. There is no fallback: when the compiler fails, the call
raises with its output. The numpy twins, which the tests hold these entry
points against and a caller may use by name, are
``ops/morphology.py::close_then_open`` and
``datasets/kitti/kitti_rasterizer.py::fill_rotated_boxes_img`` and
``::points_in_boxes_count``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc" / "host"
          / "maskbev_host.cpp")
BUILD_ROOT = pathlib.Path(__file__).resolve().parent / "_build"
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build() -> pathlib.Path:
    """Compile the host core if this source is not built yet; return the
    library's path. Raises ``RuntimeError`` with the compiler's output."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"host-{digest}"
    lib_path = out_dir / "libmaskbev_host.so"
    if lib_path.exists():
        return lib_path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the host core "
                           f"({SOURCE.name}) cannot be built")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib.{os.getpid()}.{threading.get_ident()}.so"
    res = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the host core failed to build ({cxx} "
                           f"{' '.join(FLAGS)}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded host core (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            ci, cf = ctypes.c_int, ctypes.c_float
            so.close_then_open.argtypes = [u8p, ci, ci, ci]
            so.close_then_open.restype = None
            so.fill_rotated_boxes_img.argtypes = [
                i32p, ci, ci, f32p, f32p, f32p, u8p, ci, cf, cf, cf]
            so.fill_rotated_boxes_img.restype = None
            so.points_in_boxes_count.argtypes = [
                f32p, ci, ci, f32p, f32p, f32p, ci, i32p]
            so.points_in_boxes_count.restype = None
            _lib = so
    return _lib


def _check_shapes(**arrays) -> None:
    """Raise unless each ``name=(array, shape)`` has that shape: the C
    entry points read as many rows as their count says."""
    for name, (a, shape) in arrays.items():
        if np.shape(a) != shape:
            raise ValueError(f"{name}: shape {np.shape(a)}, expected "
                             f"{shape}")


def close_then_open(mask: np.ndarray, k: int = 9) -> np.ndarray:
    """Binary close then open with a k x k square, cv2's borders (dilation
    reads 0 outside, erosion 1). mask: (H, W) bool -> (H, W) bool."""
    if np.ndim(mask) != 2:
        raise ValueError(f"mask: shape {np.shape(mask)}, expected (H, W)")
    buf = np.ascontiguousarray(mask, np.uint8).copy()
    lib().close_then_open(buf, buf.shape[0], buf.shape[1], int(k))
    return buf.astype(bool)


def fill_rotated_boxes_img(h: int, w: int, centers: np.ndarray,
                           dims: np.ndarray, yaws: np.ndarray,
                           keep: np.ndarray, x0: float, y0: float,
                           voxel: float) -> np.ndarray:
    """(N, 2) centers, (N, 2) (length, width), (N,) yaws -> (H, W) int32
    instance-id image: box i (where ``keep``) writes i + 1 on every cell
    whose centre lies inside it, later boxes over earlier ones."""
    n = len(yaws)
    _check_shapes(centers=(centers, (n, 2)), dims=(dims, (n, 2)),
                  yaws=(yaws, (n,)), keep=(keep, (n,)))
    img = np.zeros((h, w), np.int32)
    lib().fill_rotated_boxes_img(
        img, h, w, np.ascontiguousarray(centers, np.float32),
        np.ascontiguousarray(dims, np.float32),
        np.ascontiguousarray(yaws, np.float32),
        np.ascontiguousarray(keep, np.uint8), n,
        float(x0), float(y0), float(voxel))
    return img


def points_in_boxes_count(points: np.ndarray, centers3: np.ndarray,
                          dims3: np.ndarray, yaws: np.ndarray) -> np.ndarray:
    """(P, >= 3) points, (N, 3) bottom centres, (N, 3) (length, width,
    height), (N,) yaws -> (N,) int32 points inside each box (footprint and
    z in [z0, z0 + height])."""
    pts = np.ascontiguousarray(points, np.float32)
    n = len(yaws)
    _check_shapes(centers3=(centers3, (n, 3)), dims3=(dims3, (n, 3)),
                  yaws=(yaws, (n,)))
    if pts.ndim != 2 or pts.shape[1] < 3:
        raise ValueError(f"points: shape {pts.shape}, expected (P, >= 3)")
    out = np.zeros((n,), np.int32)
    lib().points_in_boxes_count(
        pts, pts.shape[0], pts.shape[1],
        np.ascontiguousarray(centers3, np.float32),
        np.ascontiguousarray(dims3, np.float32),
        np.ascontiguousarray(yaws, np.float32), len(yaws), out)
    return out
