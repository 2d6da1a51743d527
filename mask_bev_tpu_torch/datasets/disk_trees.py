"""Dataset trees in the SemanticKITTI and KITTI on-disk formats, from a seed.

No dataset can be downloaded where the port is tested, so the tests and the
card's smoke run write their scans in the datasets' own formats and read
them back through the loaders:

* :func:`write_semantic_kitti_tree`: ``<root>/dataset/sequences/<seq>/``
  with ``velodyne/*.bin`` (float32 x, y, z, intensity), ``labels/*.label``
  (uint32: semantic id in the low 16 bits, instance id in the high 16),
  ``poses.txt`` (camera-frame 3x4 poses), ``calib.txt`` (``P0``-``P3``,
  ``Tr``) and ``times.txt``. Sequence ``00`` is the train split, ``08`` the
  valid split, ``11`` (no labels) the test split. The sensor drives along a
  road at ``step`` metres a scan with a slow turn; parked cars along the
  road keep their instance ids in the world frame, labelled ``CAR``
  (raw 10); every other point is ``ROAD`` (40) or ``BUILDING`` (50).
* :func:`write_kitti_tree`: ``<root>/data_object_{calib,label_2,velodyne}/
  training/...`` with ``train.txt`` and ``val.txt``: each frame holds
  non-overlapping Car, Pedestrian and Cyclist boxes with LiDAR points
  inside them, labelled in the camera frame as KITTI's ``label_2`` files
  are.

Every scan is a disc of points out to ``radius`` metres drawn as
``chip_smoke.py::scans`` draws it, plus the objects' points: about
``points`` points a scan in all. Calibrations are KITTI's published
odometry and object values.
"""
from __future__ import annotations

import pathlib
from typing import Tuple

import numpy as np

# velodyne -> camera of the KITTI odometry sequences 00-02
ODOMETRY_TR = np.array([
    [4.276802385584e-04, -9.999672484946e-01, -8.084491683471e-03,
     -1.198459927713e-02],
    [-7.210626507497e-03, 8.081198471645e-03, -9.999413164504e-01,
     -5.403984729748e-02],
    [9.999738645903e-01, 4.859485810390e-04, -7.206933692422e-03,
     -2.921968648686e-01]])
# velodyne -> camera and the projections of KITTI object frame 000000
OBJECT_TR = np.array([
    [6.927964e-03, -9.999722e-01, -2.757829e-03, -2.457729e-02],
    [-1.162982e-03, 2.749836e-03, -9.999955e-01, -6.127237e-02],
    [9.999753e-01, 6.931141e-03, -1.143899e-03, -3.321029e-01]])
OBJECT_P2 = np.array([
    [7.070493e+02, 0.0, 6.040814e+02, 4.575831e+01],
    [0.0, 7.070493e+02, 1.805066e+02, -3.454157e-01],
    [0.0, 0.0, 1.0, 4.981016e-03]])
OBJECT_R0 = np.array([
    [9.999128e-01, 1.009263e-02, -8.511932e-03],
    [-1.012729e-02, 9.999406e-01, -4.037671e-03],
    [8.470675e-03, 4.123522e-03, 9.999556e-01]])

ROAD, BUILDING, CAR = 40, 50, 10  # raw SemanticKITTI ids
GROUND_Z = -1.73  # the road below a KITTI velodyne, metres
# (type name, (length, width, height), share of the boxes)
KITTI_OBJECTS = (("Car", (3.9, 1.6, 1.56), 0.6),
                 ("Pedestrian", (0.8, 0.6, 1.75), 0.2),
                 ("Cyclist", (1.76, 0.6, 1.73), 0.2))


def disc_points(rng: np.random.Generator, n: int,
                radius: float = 50.0) -> np.ndarray:
    """(n, 4) float32: a disc of points out to ``radius`` (heights -2..1 m,
    intensities 0..1), the distribution of ``chip_smoke.py::scans``."""
    r = rng.uniform(2, radius, n) * np.sqrt(rng.uniform(0.1, 1, n))
    th = rng.uniform(-np.pi, np.pi, n)
    return np.stack([r * np.cos(th), r * np.sin(th), rng.uniform(-2, 1, n),
                     rng.uniform(0, 1, n)], -1).astype(np.float32)


def box_points(rng: np.random.Generator, n: int, center, dims,
               yaw: float) -> np.ndarray:
    """(n, 4) float32 points uniform inside a box standing on ``center``
    (its bottom centre): (length, width, height) ``dims``, heading ``yaw``."""
    local = rng.uniform(-0.45, 0.45, (n, 3)) * np.asarray(dims)
    local[:, 2] += 0.5 * dims[2]
    c, s = np.cos(yaw), np.sin(yaw)
    xy = local[:, :2] @ np.array([[c, s], [-s, c]])
    pts = np.concatenate([xy + np.asarray(center)[:2],
                          local[:, 2:3] + center[2],
                          rng.uniform(0, 1, (n, 1))], 1)
    return pts.astype(np.float32)


def _hom(m34: np.ndarray) -> np.ndarray:
    return np.vstack([m34, [0.0, 0.0, 0.0, 1.0]])


def _row(m: np.ndarray) -> str:
    return " ".join(f"{v:.12e}" for v in np.asarray(m).reshape(-1))


def _parked_cars(rng, length: float, radius: float, spacing: float,
                 lanes: Tuple[float, ...]):
    """World-frame parked cars along the road x in [-radius, length +
    radius]: (centers (K, 3) bottom centres, dims (K, 3), yaws (K,))."""
    xs = np.arange(-radius, length + radius, spacing)
    k = len(xs)
    centers = np.stack([xs + rng.uniform(-0.5, 0.5, k),
                        rng.choice(lanes, k) + rng.uniform(-0.3, 0.3, k),
                        np.full(k, GROUND_Z)], 1)
    dims = np.stack([rng.uniform(3.8, 4.8, k), rng.uniform(1.6, 1.9, k),
                     rng.uniform(1.4, 1.7, k)], 1)
    return centers, dims, rng.uniform(-0.15, 0.15, k)


def _write_sequence(seq_dir: pathlib.Path, rng, n_scans: int, points: int,
                    radius: float, step: float, spacing: float,
                    lanes: Tuple[float, ...], car_points: float,
                    labels: bool) -> None:
    (seq_dir / "velodyne").mkdir(parents=True)
    if labels:
        (seq_dir / "labels").mkdir()
    tr = _hom(ODOMETRY_TR)
    centers, dims, yaws = _parked_cars(rng, step * n_scans, radius, spacing,
                                       lanes)
    poses = []
    heading, pos = 0.0, np.zeros(2)
    for i in range(n_scans):
        c, s = np.cos(heading), np.sin(heading)
        velo_pose = np.eye(4)  # velodyne frame of scan i -> world
        velo_pose[:2, :2] = [[c, -s], [s, c]]
        velo_pose[:2, 3] = pos
        poses.append((tr @ velo_pose @ np.linalg.inv(tr))[:3])
        # cars near the sensor, in the scan's velodyne frame
        rel = (centers[:, :2] - pos) @ np.array([[c, -s], [s, c]])
        seen = np.flatnonzero(np.hypot(*rel.T) < 0.96 * radius)
        parts, sem, inst = [], [], []
        for k in seen:
            dist = max(float(np.hypot(*rel[k])), 5.0)
            n = int(np.clip(car_points / dist, 0.01 * car_points,
                            0.1 * car_points))
            parts.append(box_points(
                rng, n, (rel[k, 0], rel[k, 1], GROUND_Z), dims[k],
                yaws[k] - heading))
            sem.append(np.full(n, CAR, np.uint32))
            inst.append(np.full(n, k + 1, np.uint32))
        n_bg = max(points - sum(len(p) for p in parts), 0)
        bg = disc_points(rng, n_bg, radius)
        parts.append(bg)
        sem.append(np.where(bg[:, 2] < -1.2, ROAD, BUILDING).astype(np.uint32))
        inst.append(np.zeros(n_bg, np.uint32))
        order = rng.permutation(sum(len(p) for p in parts))
        np.concatenate(parts)[order].tofile(
            seq_dir / "velodyne" / f"{i:06d}.bin")
        if labels:
            packed = (np.concatenate(inst) << 16) | np.concatenate(sem)
            packed[order].astype(np.uint32).tofile(
                seq_dir / "labels" / f"{i:06d}.label")
        heading += 0.004
        pos = pos + step * np.array([np.cos(heading), np.sin(heading)])
    np.savetxt(seq_dir / "poses.txt", np.stack(poses).reshape(n_scans, 12),
               fmt="%.12e")
    np.savetxt(seq_dir / "times.txt", 0.1 * np.arange(n_scans), fmt="%.6e")
    p = np.hstack([np.diag([718.856, 718.856, 1.0]), np.zeros((3, 1))])
    (seq_dir / "calib.txt").write_text(
        "".join(f"P{j}: {_row(p)}\n" for j in range(4))
        + f"Tr: {_row(ODOMETRY_TR)}\n")


def write_semantic_kitti_tree(root, seed: int = 0, train_scans: int = 32,
                              valid_scans: int = 8, test_scans: int = 0,
                              points: int = 120_000, radius: float = 50.0,
                              step: float = 1.0, spacing: float = 6.0,
                              lanes: Tuple[float, ...] = (-7.5, -3.5, 3.5,
                                                          7.5),
                              car_points: float = 6000.0) -> pathlib.Path:
    """Write sequences ``00`` (train), ``08`` (valid) and, with
    ``test_scans``, ``11`` (test, no labels) under ``<root>/dataset``;
    returns ``root``. Cars stand every ``spacing`` metres in one of
    ``lanes`` (lateral offsets); a car at d metres gets ``car_points / d``
    points (d at least 5), clipped to 1-10 % of ``car_points``."""
    root = pathlib.Path(root)
    rng = np.random.default_rng(seed)
    seqs = root / "dataset" / "sequences"
    for name, n, labels in (("00", train_scans, True),
                            ("08", valid_scans, True),
                            ("11", test_scans, False)):
        if n:
            _write_sequence(seqs / name, rng, n, points, radius, step,
                            spacing, lanes, car_points, labels)
    return root


def _kitti_boxes(rng, n: int, radius: float):
    """Up to ``n`` non-overlapping boxes in front of the sensor (fewer
    where 50 draws in a row find no room): (type names, bottom centres
    (n, 3), dims (n, 3), yaws (n,))."""
    from mask_bev_tpu_torch.augmentations.box_ops import (
        box_collision_test, center_to_corner_box2d)

    shares = np.array([o[2] for o in KITTI_OBJECTS])
    names, centers, dims, yaws = [], [], [], []
    corners = np.zeros((0, 4, 2))
    misses = 0
    while len(names) < n and misses < 50:
        kind = int(rng.choice(len(KITTI_OBJECTS), p=shares / shares.sum()))
        name, size, _ = KITTI_OBJECTS[kind]
        d = np.asarray(size) * rng.uniform(0.9, 1.1, 3)
        c = np.array([rng.uniform(4.0, 0.75 * radius),
                      rng.uniform(-0.6, 0.6) * radius, GROUND_Z])
        y = rng.uniform(-np.pi, np.pi)
        # a margin of 0.2 m keeps the boxes apart
        box = center_to_corner_box2d(c[None, :2], d[None, :2] + 0.4,
                                     np.array([y]))
        if box_collision_test(box, corners).any():
            misses += 1
            continue
        misses = 0
        corners = np.concatenate([corners, box])
        names.append(name)
        centers.append(c)
        dims.append(d)
        yaws.append(y)
    return names, np.array(centers), np.array(dims), np.array(yaws)


def write_kitti_tree(root, seed: int = 0, frames: int = 16, train: int = 12,
                     points: int = 120_000, boxes: Tuple[int, int] = (8, 15),
                     radius: float = 50.0) -> pathlib.Path:
    """Write ``frames`` KITTI object ``training`` frames under ``root``, the
    first ``train`` ids in ``train.txt`` and the rest in ``val.txt``;
    returns ``root``. The GT-paste bank (``samples.pkl``) is written by
    ``datasets/kitti/object_sampler.py``."""
    root = pathlib.Path(root)
    rng = np.random.default_rng(seed)
    dirs = {k: root / f"data_object_{k}" / "training" / k
            for k in ("calib", "label_2", "velodyne")}
    for d in dirs.values():
        d.mkdir(parents=True)
    p = [np.hstack([OBJECT_P2[:, :3], OBJECT_P2[:, 3:] * j])
         for j in (0.0, 0.5, 1.0, 1.5)]
    calib = ("".join(f"P{j}: {_row(p[j])}\n" for j in range(4))
             + f"R0_rect: {_row(OBJECT_R0)}\n"
             + f"Tr_velo_to_cam: {_row(OBJECT_TR)}\n"
             + f"Tr_imu_to_velo: {_row(np.eye(4)[:3])}\n")
    tr = _hom(OBJECT_TR)
    for i in range(frames):
        n = int(rng.integers(boxes[0], boxes[1] + 1))
        names, centers, dims, yaws = _kitti_boxes(rng, n, radius)
        parts, lines = [], []
        for name, c, d, y in zip(names, centers, dims, yaws):
            parts.append(box_points(rng, int(rng.integers(60, 300)), c, d,
                                    y))
            cam = (tr @ np.append(c, 1.0))[:3]
            ry = np.arctan2(np.sin(-y - np.pi / 2), np.cos(-y - np.pi / 2))
            occ = int(rng.integers(0, 3))
            lines.append(
                f"{name} 0.00 {occ} 0.00 100.00 120.00 200.00 220.00 "
                f"{d[2]:.2f} {d[1]:.2f} {d[0]:.2f} {cam[0]:.2f} "
                f"{cam[1]:.2f} {cam[2]:.2f} {ry:.2f}")
        lines.append("DontCare -1 -1 -10 503.89 169.71 590.61 190.13 -1 -1 "
                     "-1 -1000 -1000 -1000 -10")
        n_bg = max(points - sum(len(q) for q in parts), 0)
        parts.append(disc_points(rng, n_bg, radius))
        pts = np.concatenate(parts)
        pts[rng.permutation(len(pts))].tofile(dirs["velodyne"] / f"{i:06d}.bin")
        (dirs["label_2"] / f"{i:06d}.txt").write_text("\n".join(lines) + "\n")
        (dirs["calib"] / f"{i:06d}.txt").write_text(calib)
    (root / "train.txt").write_text(
        "".join(f"{i:06d}\n" for i in range(train)))
    (root / "val.txt").write_text(
        "".join(f"{i:06d}\n" for i in range(train, frames)))
    return root
