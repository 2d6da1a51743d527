"""Binary morphology (close/open) with cv2's semantics: numpy and torch.

The port's copy of ``mask_bev_tpu/ops/morphology.py``: the reference's cv2
``morphologyEx`` MORPH_CLOSE then MORPH_OPEN with a 9x9 rectangle
(reference ``semantic_kitti_rasterizer.py:71-88``). Borders as cv2's
defaults: dilation reads 0 outside the image, erosion 1 (edge pixels are
not eroded by the border).

* The numpy half is the twin of the host core's ``close_then_open``
  (``mask_bev_tpu_torch/native.py``), which the rasterizer calls.
* The torch half (:func:`torch_close_then_open`, the JAX package's
  ``jnp_*`` functions) is max pooling on tensors, on whatever device the
  mask lives: dilation is ``F.max_pool2d`` of the mask (its implicit -inf
  padding is the JAX pool's init), erosion the complement of the max pool
  of the complement (outside the image the complement is 0, so the mask
  reads 1 there, as the JAX version's padding with ones gives).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
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


# ---- torch variants (same semantics, on tensors) ----

def _max_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """(..., H, W) float -> k x k max pool, stride 1, k // 2 padding that
    no value of the window can lose to."""
    lead = x.shape[:-2]
    y = F.max_pool2d(x.reshape(-1, 1, *x.shape[-2:]), k, stride=1,
                     padding=k // 2)
    return y.reshape(*lead, *y.shape[-2:])


def torch_dilate(mask: torch.Tensor, k: int = 9) -> torch.Tensor:
    """(..., H, W) bool/float -> max-pool dilation (outside = 0)."""
    return _max_pool(mask.to(torch.float32), k) > 0.5


def torch_erode(mask: torch.Tensor, k: int = 9) -> torch.Tensor:
    """(..., H, W) -> erosion with outside = 1 (cv2 border semantics): the
    complement of the dilated complement."""
    return _max_pool(1.0 - mask.to(torch.float32), k) < 0.5


def torch_close_then_open(mask: torch.Tensor, k: int = 9) -> torch.Tensor:
    """The reference's GT-mask cleanup on a tensor: MORPH_CLOSE then
    MORPH_OPEN."""
    x = torch_erode(torch_dilate(mask, k), k)  # close
    return torch_dilate(torch_erode(x, k), k)  # open
