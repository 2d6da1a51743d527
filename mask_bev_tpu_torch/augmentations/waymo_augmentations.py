"""Waymo frame augmentations (reference ``waymo_mask_augmentations.py``):
flip-y / shuffle / rotate / decimate / jitter / drop on converted frames,
applied BEFORE rasterization so masks track the boxes.

The port's copy of ``mask_bev_tpu/augmentations/waymo_augmentations.py``:
each transform draws from the ``np.random.Generator`` it is given in the
same order and with the same sizes, so one seed gives the same frame bit
for bit, and changes the frame in place.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List

import numpy as np

from mask_bev_tpu_torch.augmentations.rand_augment import RandAugment
from mask_bev_tpu_torch.datasets.waymo.waymo_data import WaymoFrame


class Flip:
    def __init__(self, prob_flip_x: float = 0, prob_flip_y: float = 0.5):
        if prob_flip_x != 0:
            raise ValueError("Cannot flip in x")
        self.prob_flip_y = prob_flip_y

    def __call__(self, f: WaymoFrame, rng, magnitude: float = 1):
        if rng.uniform() < self.prob_flip_y * magnitude:
            f.points[:, 1] = -f.points[:, 1]
            f.box_center[:, 1] = -f.box_center[:, 1]
            f.box_heading[:] = -f.box_heading
        return f


class ShufflePoints:
    def __init__(self, prob_shuffle: float = 0.5):
        self.prob_shuffle = prob_shuffle

    def __call__(self, f, rng, magnitude: float = 1):
        if rng.uniform() < self.prob_shuffle * magnitude:
            rng.shuffle(f.points, axis=0)
        return f


class RandomRotate:
    def __init__(self, rotate_prob: float, rotation_range):
        self.rotate_prob = rotate_prob
        if np.isscalar(rotation_range):
            rotation_range = (-rotation_range, rotation_range)
        self.rotation_range = rotation_range

    def __call__(self, f: WaymoFrame, rng, magnitude: float = 1):
        if rng.uniform() < self.rotate_prob:
            theta = np.deg2rad(rng.uniform(
                self.rotation_range[0] * magnitude,
                self.rotation_range[1] * magnitude))
            c, s = np.cos(theta), np.sin(theta)
            rot = np.array([[c, -s], [s, c]], np.float32)
            f.points[:, :2] = f.points[:, :2] @ rot.T
            f.box_center[:, :2] = f.box_center[:, :2] @ rot.T
            f.box_heading[:] = f.box_heading + theta
        return f


class DecimatePoints:
    def __init__(self, prob_decimate: float, keep_every: int):
        self.prob_decimate = prob_decimate
        self.keep_every = keep_every

    def __call__(self, f, rng, magnitude: float = 1):
        if rng.uniform() < self.prob_decimate:
            perm = rng.permutation(f.points.shape[0])
            f.points = f.points[perm][:: max(int(self.keep_every * magnitude), 1)]
        return f


class JitterPoints:
    def __init__(self, prob_jitter: float, jitter_std, max_delta=None,
                 intensity_std: float = 0.0, intensity_max_delta=None):
        self.prob_jitter = prob_jitter
        if np.isscalar(jitter_std):
            jitter_std = (jitter_std,) * 3
        self.jitter_std = np.asarray(jitter_std, np.float32)
        self.max_delta = None if max_delta is None else np.asarray(max_delta)
        self.intensity_std = intensity_std

    def __call__(self, f, rng, magnitude: float = 1):
        if rng.uniform() < self.prob_jitter:
            n = f.points.shape[0]
            noise = rng.standard_normal((n, 3)).astype(np.float32) * self.jitter_std
            if self.max_delta is not None:
                noise = np.clip(noise, -self.max_delta, self.max_delta)
            f.points[:, :3] += noise * magnitude
            if f.points.shape[1] > 3:
                f.points[:, 3] = np.clip(
                    f.points[:, 3]
                    + rng.standard_normal(n).astype(np.float32)
                    * self.intensity_std * magnitude, 0, 1)
        return f


class RandomDropPoints:
    def __init__(self, prob_drop: float, per_point_drop_prob: float):
        self.prob_drop = prob_drop
        self.per_point_drop_prob = per_point_drop_prob

    def __call__(self, f, rng, magnitude: float = 1):
        if rng.uniform() < self.prob_drop:
            keep = rng.uniform(size=f.points.shape[0]) >= (
                self.per_point_drop_prob * magnitude)
            f.points = f.points[keep]
        return f


_CONSTRUCTORS = {
    "flip": Flip,
    "shuffle": ShufflePoints,
    "rotate": RandomRotate,
    "decimate": DecimatePoints,
    "jitter": JitterPoints,
    "drop": RandomDropPoints,
}


def make_augmentation(args: dict) -> Callable:
    name = args.get("name")
    if name == "rand_augment":
        transforms = make_waymo_augmentation_list(args["transforms"])
        return RandAugment(args["num_augments"], transforms,
                           args.get("magnitude", 1.0))
    if name not in _CONSTRUCTORS:
        raise NotImplementedError(f"{name} is not implemented")
    kwargs = copy.copy(args)
    kwargs.pop("name")
    return _CONSTRUCTORS[name](**kwargs)


def make_waymo_augmentation_list(augs: List[Dict]) -> List[Callable]:
    return [make_augmentation(a) for a in (augs or [])]


def apply_waymo_augmentations(frame, augs, rng: np.random.Generator):
    for a in augs:
        frame = a(frame, rng)
    return frame
