"""KITTI frame augmentations (vectorized numpy, host-side).

The port's copy of ``mask_bev_tpu/augmentations/kitti_augmentations.py``.
Behavioral rebuild of reference ``augmentations/kitti_mask_augmentations.py``:
the YAML name->class factory (ref :19-52) and the augmentation set — flip-y,
shuffle, rotate, decimate, jitter, drop, global scale/translate noise,
per-object box noise, and GT-paste ObjectSample with collision tests
(ref :55-343). All operate on :class:`KittiFrame` with struct-of-array
labels, BEFORE rasterization, so masks pick up the augmentations for free
(reference ``kitti_data_module.py:83-105``).

Differences (documented):
  * every augmentation takes an explicit ``np.random.Generator`` instead of
    the global numpy RNG — reproducible pipelines, per-worker streams;
  * ``cut_pc`` in the reference is dead code (calls torchvision RandomErasing
    on a dataclass, ``kitti_mask_augmentations.py:164-175``); rebuilt here as
    an actually-working BEV-rectangle point eraser;
  * the GT-paste sample bank is a pickle of (points, box-row) pairs produced
    by ``python -m mask_bev_tpu_torch.datasets.kitti.object_sampler`` (same
    role as the reference's ``samples.pkl``; the JAX package's
    ``scripts/generate_kitti_object_sampler.py`` writes the same file).
"""
from __future__ import annotations

import copy
import pathlib
import pickle
from typing import Callable, Dict, List

import numpy as np

from mask_bev_tpu_torch.augmentations.box_ops import (
    box_collision_test, center_to_corner_box2d, noise_per_object,
    points_in_rbbox)
from mask_bev_tpu_torch.augmentations.rand_augment import RandAugment
from mask_bev_tpu_torch.datasets.kitti.kitti_dataset import BoxArray, KittiFrame


class Flip:
    """Mirror the scene across the x axis (y -> -y). Ref :55-72."""

    def __init__(self, prob_flip_x: float = 0, prob_flip_y: float = 0.5):
        if prob_flip_x != 0:
            raise ValueError("Cannot flip in x")  # ref :58-59
        self.prob_flip_y = prob_flip_y

    def __call__(self, f: KittiFrame, rng: np.random.Generator,
                 magnitude: float = 1) -> KittiFrame:
        if rng.uniform() < self.prob_flip_y * magnitude:
            f.points[:, 1] = -f.points[:, 1]
            f.boxes.center[:, 1] = -f.boxes.center[:, 1]
            f.boxes.yaw[:] = -f.boxes.yaw
            f.boxes.alpha[:] = -f.boxes.alpha
            f.boxes.rotation_y[:] = -f.boxes.rotation_y
        return f


class ShufflePoints:
    def __init__(self, prob_shuffle: float = 0.5):
        self.prob_shuffle = prob_shuffle

    def __call__(self, f, rng, magnitude: float = 1):
        if rng.uniform() < self.prob_shuffle * magnitude:
            rng.shuffle(f.points, axis=0)
        return f


class RandomRotate:
    """SE(2) rotation of the whole scene about the sensor. Ref :86-124."""

    def __init__(self, rotate_prob: float, rotation_range):
        self.rotate_prob = rotate_prob
        if np.isscalar(rotation_range):
            rotation_range = (-rotation_range, rotation_range)
        self.rotation_range = rotation_range

    def __call__(self, f: KittiFrame, rng, magnitude: float = 1):
        if rng.uniform() < self.rotate_prob:
            lo, hi = (self.rotation_range[0] * magnitude,
                      self.rotation_range[1] * magnitude)
            theta = np.deg2rad(rng.uniform(lo, hi))
            c, s = np.cos(theta), np.sin(theta)
            rot = np.array([[c, -s], [s, c]], np.float32)
            f.points[:, :2] = f.points[:, :2] @ rot.T
            f.boxes.center[:, :2] = f.boxes.center[:, :2] @ rot.T
            f.boxes.yaw[:] = f.boxes.yaw + theta
            f.boxes.alpha[:] = f.boxes.alpha + theta
            f.boxes.rotation_y[:] = f.boxes.rotation_y + theta
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
        if np.isscalar(max_delta):
            max_delta = (max_delta,) * 3
        self.jitter_std = np.asarray(jitter_std, np.float32)
        self.max_delta = None if max_delta is None else np.asarray(max_delta)
        self.intensity_std = intensity_std
        self.intensity_max_delta = intensity_max_delta

    def __call__(self, f, rng, magnitude: float = 1):
        if rng.uniform() < self.prob_jitter:
            n = f.points.shape[0]
            noise = rng.standard_normal((n, 3)).astype(np.float32) * self.jitter_std
            if self.max_delta is not None:
                noise = np.clip(noise, -self.max_delta, self.max_delta)
            f.points[:, :3] += noise * magnitude
            if f.points.shape[1] > 3:
                inoise = rng.standard_normal(n).astype(np.float32) * self.intensity_std
                if self.intensity_max_delta is not None:
                    inoise = np.clip(inoise, -self.intensity_max_delta,
                                     self.intensity_max_delta)
                f.points[:, 3] = np.clip(f.points[:, 3] + inoise * magnitude, 0, 1)
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


class CutPc:
    """Erase points inside a random BEV rectangle (working rebuild of the
    reference's broken ``CutPcAugmentation``, ref :164-175)."""

    def __init__(self, prob_cut: float = 0.5, scale=(0.02, 0.33),
                 ratio=(0.3, 3.3), **_):
        self.prob_cut = prob_cut
        self.scale = scale
        self.ratio = ratio

    def __call__(self, f, rng, magnitude: float = 1):
        if rng.uniform() < self.prob_cut and len(f.points):
            xy = f.points[:, :2]
            lo, hi = xy.min(0), xy.max(0)
            span = hi - lo
            area = span[0] * span[1] * rng.uniform(*self.scale) * magnitude
            r = rng.uniform(*self.ratio)
            w = np.sqrt(area * r)
            h = np.sqrt(area / r)
            cx = rng.uniform(lo[0], hi[0])
            cy = rng.uniform(lo[1], hi[1])
            keep = ~((np.abs(xy[:, 0] - cx) < w / 2)
                     & (np.abs(xy[:, 1] - cy) < h / 2))
            f.points = f.points[keep]
        return f


class GlobalNoise:
    """Global scale + translation of scene and labels. Ref :195-215."""

    def __init__(self, prob_aug: float, trans_std: float = 0.2,
                 scale_delta: float = 0.05):
        self.prob_aug = prob_aug
        self.trans_std = trans_std
        self.scale_delta = scale_delta

    def __call__(self, f: KittiFrame, rng, magnitude: float = 1):
        # NB the reference applies this unconditionally (prob_aug unused in
        # its __call__, ref :201); we honor the configured probability.
        if rng.uniform() < self.prob_aug:
            noise = rng.standard_normal(3).astype(np.float32) * self.trans_std
            scale = rng.uniform(1 - self.scale_delta, 1 + self.scale_delta)
            f.points[:, :3] = f.points[:, :3] * scale + noise
            f.boxes.center[:] = f.boxes.center * scale + noise
            f.boxes.dims[:] = f.boxes.dims * scale
        return f


class BoxNoise:
    """Per-object pose perturbation with collision rejection. Ref :226-267."""

    def __init__(self, translation_std=None, global_rot_range=None,
                 rot_range=None, num_try: int = 100):
        self.translation_std = tuple(translation_std or (0.25, 0.25, 0.25))
        self.rot_range = tuple(rot_range or (-0.15707963267, 0.15707963267))
        self.num_try = num_try

    def __call__(self, f: KittiFrame, rng, magnitude: float = 1):
        if len(f.boxes) == 0:
            return f
        noise_per_object(
            rng, f.boxes.center, f.boxes.dims, f.boxes.yaw, f.points,
            rot_range=self.rot_range, trans_std=self.translation_std,
            num_try=self.num_try)
        return f


class ObjectSample:
    """GT-paste: insert pre-extracted objects (points + box) without collisions.

    Ref :278-343. The sample bank is built by
    ``datasets/kitti/object_sampler.py`` as a pickle of dicts
    {'points': (Ni, 4), 'center': (3,), 'dims': (3,), 'yaw': float,
     'type': int} (all objects with >= 5 interior points).
    """

    def __init__(self, dataset_root: str, num_sample: int):
        path = pathlib.Path(dataset_root).expanduser() / "samples.pkl"
        if not path.exists():
            raise FileNotFoundError(f"Cannot find samples at {path}")
        with open(path, "rb") as fp:
            self.samples = pickle.load(fp)
        self.num_sample = num_sample

    def __call__(self, f: KittiFrame, rng, magnitude: float = 1):
        # reference's triangular-ish count distribution (ref :287-289)
        n = int((rng.integers(0, self.num_sample)
                 + rng.integers(0, self.num_sample)
                 + rng.integers(0, self.num_sample)) % self.num_sample)
        if n == 0 or not self.samples:
            return f
        avoid = center_to_corner_box2d(
            f.boxes.center[:, :2], f.boxes.dims[:, :2], f.boxes.yaw)
        picked = []
        for _ in range(n):
            s = self.samples[int(rng.integers(0, len(self.samples)))]
            corners = center_to_corner_box2d(
                np.asarray(s["center"])[None, :2],
                np.asarray(s["dims"])[None, :2],
                np.asarray([s["yaw"]]))
            if box_collision_test(corners, avoid).any():
                continue
            picked.append(s)
            avoid = np.concatenate([avoid, corners])
        if not picked:
            return f

        centers = np.stack([s["center"] for s in picked]).astype(np.float32)
        dims = np.stack([s["dims"] for s in picked]).astype(np.float32)
        yaws = np.array([s["yaw"] for s in picked], np.float32)
        types = np.array([s.get("type", 0) for s in picked], np.int32)

        # drop scene points inside pasted boxes, then add the sample points
        member = points_in_rbbox(f.points, centers, dims[:, :2], yaws)
        f.points = f.points[~member.any(-1)]
        f.points = np.concatenate(
            [f.points] + [np.asarray(s["points"], np.float32)[:, : f.points.shape[1]]
                          for s in picked])

        k = len(picked)
        pasted = BoxArray(
            center=centers, dims=dims, yaw=yaws, types=types,
            truncated=np.zeros(k, np.float32),
            occluded=np.zeros(k, np.int32),
            alpha=np.zeros(k, np.float32),
            bbox=np.zeros((k, 4), np.float32),
            location_cam=np.zeros((k, 3), np.float32),
            rotation_y=-yaws - np.pi / 2,
        )
        f.boxes = BoxArray.concat([f.boxes, pasted])
        return f


_CONSTRUCTORS: Dict[str, type] = {
    "flip": Flip,
    "shuffle": ShufflePoints,
    "rotate": RandomRotate,
    "decimate": DecimatePoints,
    "jitter": JitterPoints,
    "drop": RandomDropPoints,
    "cut_pc": CutPc,
    "global_noise": GlobalNoise,
    "object_noise": BoxNoise,
    "object_sample": ObjectSample,
}


def make_augmentation(args: dict) -> Callable:
    """YAML dict -> augmentation callable (ref factory :19-52)."""
    name = args.get("name")
    if name == "rand_augment":
        transforms = make_kitti_augmentation_list(args["transforms"])
        return RandAugment(args["num_augments"], transforms,
                           args.get("magnitude", 1.0))
    if name not in _CONSTRUCTORS:
        raise NotImplementedError(f"{name} is not implemented")
    kwargs = copy.copy(args)
    kwargs.pop("name")
    return _CONSTRUCTORS[name](**kwargs)


def make_kitti_augmentation_list(augmentations: List[dict]) -> List[Callable]:
    return [make_augmentation(a) for a in (augmentations or [])]


def apply_augmentations(frame, augs: List[Callable],
                        rng: np.random.Generator):
    for a in augs:
        frame = a(frame, rng)
    return frame
