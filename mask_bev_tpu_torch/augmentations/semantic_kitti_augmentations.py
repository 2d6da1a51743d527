"""SemanticKITTI (points, mask) augmentations — host-side numpy.

The port's copy of
``mask_bev_tpu/augmentations/semantic_kitti_augmentations.py``.
Rebuild of reference ``augmentations/semantic_kitti_mask_augmentations.py``:
factory (ref :14-41) + Flip (x and y, flipping mask axes, ref :44-57),
ShufflePoints, RandomRotate (SE(2) on the cloud + nearest-neighbor mask
rotation — numpy inverse-mapping instead of cv2.warpAffine, ref :69-104),
DecimatePoints, JitterPoints, RandomDropPoints, CutPc (working rebuild of
the reference's broken CutPcAugmentation, ref :164-175), RandAugment.

These operate on (points (N,4), mask (H=y, W=x)) pairs; our mask orientation
is (y, x) so flip-x touches columns and flip-y touches rows (the reference's
mask is (x, y) at this stage, hence its transposed indexing). The mask
rotation pivots about the world origin (= grid center for the symmetric
SemanticKITTI ranges), matching the point-cloud rotation exactly.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Tuple

import numpy as np

from mask_bev_tpu_torch.augmentations.rand_augment import RandAugment


def rotate_mask_nearest(mask: np.ndarray, theta_rad: float) -> np.ndarray:
    """Rotate an instance-id image by theta about its center (nearest)."""
    h, w = mask.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    c, s = np.cos(theta_rad), np.sin(theta_rad)
    # inverse mapping: output cell <- input cell rotated by -theta
    sx = (xx - cx) * c + (yy - cy) * s + cx
    sy = -(xx - cx) * s + (yy - cy) * c + cy
    ix = np.rint(sx).astype(np.int64)
    iy = np.rint(sy).astype(np.int64)
    ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    out = np.zeros_like(mask)
    out[ok] = mask[iy[ok], ix[ok]]
    return out


class Flip:
    def __init__(self, prob_flip_x: float = 0.5, prob_flip_y: float = 0.5):
        self.prob_flip_x = prob_flip_x
        self.prob_flip_y = prob_flip_y

    def __call__(self, x, rng: np.random.Generator, magnitude: float = 1):
        points, mask = x
        if rng.uniform() < self.prob_flip_x * magnitude:
            points[:, 0] = -points[:, 0]
            mask = mask[:, ::-1].copy()  # x -> columns in (y, x) layout
        if rng.uniform() < self.prob_flip_y * magnitude:
            points[:, 1] = -points[:, 1]
            mask = mask[::-1, :].copy()
        return points, mask


class ShufflePoints:
    def __init__(self, prob_shuffle: float = 0.5):
        self.prob_shuffle = prob_shuffle

    def __call__(self, x, rng, magnitude: float = 1):
        points, mask = x
        if rng.uniform() < self.prob_shuffle * magnitude:
            rng.shuffle(points, axis=0)
        return points, mask


class RandomRotate:
    def __init__(self, rotate_prob: float, rotation_range):
        self.rotate_prob = rotate_prob
        if np.isscalar(rotation_range):
            rotation_range = (-rotation_range, rotation_range)
        self.rotation_range = rotation_range

    def __call__(self, x, rng, magnitude: float = 1):
        points, mask = x
        if rng.uniform() < self.rotate_prob:
            theta = np.deg2rad(rng.uniform(
                self.rotation_range[0] * magnitude,
                self.rotation_range[1] * magnitude))
            c, s = np.cos(theta), np.sin(theta)
            rot = np.array([[c, -s], [s, c]], np.float32)
            points[:, :2] = points[:, :2] @ rot.T
            mask = rotate_mask_nearest(mask, theta)
        return points, mask


class DecimatePoints:
    def __init__(self, prob_decimate: float, keep_every: int):
        self.prob_decimate = prob_decimate
        self.keep_every = keep_every

    def __call__(self, x, rng, magnitude: float = 1):
        points, mask = x
        if rng.uniform() < self.prob_decimate:
            perm = rng.permutation(points.shape[0])
            points = points[perm][:: max(int(self.keep_every * magnitude), 1)]
        return points, mask


class JitterPoints:
    def __init__(self, prob_jitter: float, jitter_std, max_delta=None,
                 intensity_std: float = 0.0, intensity_max_delta=None):
        self.prob_jitter = prob_jitter
        if np.isscalar(jitter_std):
            jitter_std = (jitter_std,) * 3
        self.jitter_std = np.asarray(jitter_std, np.float32)
        self.max_delta = (np.asarray((max_delta,) * 3) if np.isscalar(max_delta)
                          else (None if max_delta is None else np.asarray(max_delta)))
        self.intensity_std = intensity_std
        self.intensity_max_delta = intensity_max_delta

    def __call__(self, x, rng, magnitude: float = 1):
        points, mask = x
        if rng.uniform() < self.prob_jitter:
            n = points.shape[0]
            noise = rng.standard_normal((n, 3)).astype(np.float32) * self.jitter_std
            if self.max_delta is not None:
                noise = np.clip(noise, -self.max_delta, self.max_delta)
            points[:, :3] += noise * magnitude
            if points.shape[1] > 3:
                ins = rng.standard_normal(n).astype(np.float32) * self.intensity_std
                if self.intensity_max_delta is not None:
                    ins = np.clip(ins, -self.intensity_max_delta,
                                  self.intensity_max_delta)
                points[:, 3] = np.clip(points[:, 3] + ins * magnitude, 0, 1)
        return points, mask


class RandomDropPoints:
    def __init__(self, prob_drop: float, per_point_drop_prob: float):
        self.prob_drop = prob_drop
        self.per_point_drop_prob = per_point_drop_prob

    def __call__(self, x, rng, magnitude: float = 1):
        points, mask = x
        if rng.uniform() < self.prob_drop:
            keep = rng.uniform(size=points.shape[0]) >= (
                self.per_point_drop_prob * magnitude)
            points = points[keep]
        return points, mask


class CutPc:
    """Erase points in a random BEV rectangle (fixes ref :164-175 dead code)."""

    def __init__(self, prob_cut: float = 0.5, scale=(0.02, 0.33),
                 ratio=(0.3, 3.3), **_):
        self.prob_cut = prob_cut
        self.scale = scale
        self.ratio = ratio

    def __call__(self, x, rng, magnitude: float = 1):
        points, mask = x
        if rng.uniform() < self.prob_cut and len(points):
            xy = points[:, :2]
            lo, hi = xy.min(0), xy.max(0)
            span = hi - lo
            area = span[0] * span[1] * rng.uniform(*self.scale) * magnitude
            r = rng.uniform(*self.ratio)
            w, h = np.sqrt(area * r), np.sqrt(area / r)
            cx, cy = rng.uniform(lo[0], hi[0]), rng.uniform(lo[1], hi[1])
            keep = ~((np.abs(xy[:, 0] - cx) < w / 2)
                     & (np.abs(xy[:, 1] - cy) < h / 2))
            points = points[keep]
        return points, mask


_CONSTRUCTORS = {
    "flip": Flip,
    "shuffle": ShufflePoints,
    "rotate": RandomRotate,
    "decimate": DecimatePoints,
    "jitter": JitterPoints,
    "drop": RandomDropPoints,
    "cut_pc": CutPc,
}


def make_augmentation(args: dict) -> Callable:
    name = args.get("name")
    if name == "rand_augment":
        transforms = make_semantic_kitti_augmentation_list(args["transforms"])
        return RandAugment(args["num_augments"], transforms,
                           args.get("magnitude", 1.0))
    if name not in _CONSTRUCTORS:
        raise NotImplementedError(f"{name} is not implemented")
    kwargs = copy.copy(args)
    kwargs.pop("name")
    return _CONSTRUCTORS[name](**kwargs)


def make_semantic_kitti_augmentation_list(augs: List[Dict]) -> List[Callable]:
    return [make_augmentation(a) for a in (augs or [])]


def apply_mask_augmentations(points: np.ndarray, mask: np.ndarray,
                             augs: List[Callable],
                             rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    x = (points, mask)
    for a in augs:
        x = a(x, rng)
    return x
