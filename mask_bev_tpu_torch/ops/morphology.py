"""Binary morphology (close/open) with cv2's semantics, in numpy and scipy.

The port's copy of the numpy half of ``mask_bev_tpu/ops/morphology.py``:
the reference's cv2 ``morphologyEx`` MORPH_CLOSE then MORPH_OPEN with a
9x9 rectangle (reference ``semantic_kitti_rasterizer.py:71-88``). Borders
as cv2's defaults: dilation reads 0 outside the image, erosion 1 (edge
pixels are not eroded by the border). This is the numpy twin of the host
core's ``close_then_open`` (``mask_bev_tpu_torch/native.py``), which the
rasterizer calls.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def _structure(k: int) -> np.ndarray:
    return np.ones((k, k), bool)


def binary_dilate(mask: np.ndarray, k: int = 9) -> np.ndarray:
    return ndimage.binary_dilation(mask, _structure(k), border_value=0)


def binary_erode(mask: np.ndarray, k: int = 9) -> np.ndarray:
    return ndimage.binary_erosion(mask, _structure(k), border_value=1)


def binary_close(mask: np.ndarray, k: int = 9) -> np.ndarray:
    return binary_erode(binary_dilate(mask, k), k)


def binary_open(mask: np.ndarray, k: int = 9) -> np.ndarray:
    return binary_dilate(binary_erode(mask, k), k)


def close_then_open(mask: np.ndarray, k: int = 9) -> np.ndarray:
    """The reference's GT-mask cleanup: MORPH_CLOSE then MORPH_OPEN."""
    return binary_open(binary_close(mask, k), k)
