"""KITTI object-detection dataset: host-side numpy loading.

The port's copy of ``mask_bev_tpu/datasets/kitti/kitti_dataset.py``.

Behavioral rebuild of the reference loader (reference
``datasets/kitti/kitti_dataset.py:94-204``): per-frame calib parsing,
camera-frame labels, camera->velodyne transform of box centers with the yaw
remap ``yaw = wrap(-rotation_y - pi/2)`` and dimension reorder (h,w,l) ->
(l,w,h), and raw velodyne .bin point clouds. Vectorized: labels live in a
struct-of-arrays :class:`BoxArray` rather than per-object dataclasses, which
feeds the vectorized rasterizer/augmentations directly.
"""
from __future__ import annotations

import dataclasses
import pathlib
from enum import IntEnum
from typing import List, Optional, Sequence

import numpy as np


class KittiType(IntEnum):
    Car = 0
    Van = 1
    Truck = 2
    Pedestrian = 3
    Person_sitting = 4
    Cyclist = 5
    Tram = 6
    Misc = 7
    DontCare = 8


class KittiOccluded(IntEnum):
    FullyVisible = 0
    PartlyOccluded = 1
    LargelyOccluded = 2
    Unknown = 3


CAR_LIKE = (KittiType.Car, KittiType.Van, KittiType.Truck)


@dataclasses.dataclass
class KittiCalib:
    P0: np.ndarray
    P1: np.ndarray
    P2: np.ndarray
    P3: np.ndarray
    R0_rect: np.ndarray  # (4, 4)
    Tr_velo_to_cam: np.ndarray  # (4, 4)
    Tr_imu_to_velo: np.ndarray  # (4, 4)


@dataclasses.dataclass
class BoxArray:
    """Struct-of-arrays 7-DoF boxes in the velodyne frame.

    center: (N, 3); dims: (N, 3) as (length, width, height); yaw: (N,).
    Camera-frame metadata rides along for difficulty filtering / eval.
    """

    center: np.ndarray
    dims: np.ndarray
    yaw: np.ndarray
    types: np.ndarray  # (N,) int (KittiType values)
    truncated: np.ndarray  # (N,)
    occluded: np.ndarray  # (N,) int
    alpha: np.ndarray  # (N,)
    bbox: np.ndarray  # (N, 4) camera 2D box
    location_cam: np.ndarray  # (N, 3) original camera-frame location
    rotation_y: np.ndarray  # (N,)

    def __len__(self):
        return len(self.yaw)

    def select(self, idx) -> "BoxArray":
        return BoxArray(*(getattr(self, f.name)[idx]
                          for f in dataclasses.fields(self)))

    @staticmethod
    def empty() -> "BoxArray":
        z = lambda *s: np.zeros(s, np.float32)
        return BoxArray(z(0, 3), z(0, 3), z(0), np.zeros((0,), np.int32),
                        z(0), np.zeros((0,), np.int32), z(0), z(0, 4),
                        z(0, 3), z(0))

    @staticmethod
    def concat(parts: Sequence["BoxArray"]) -> "BoxArray":
        return BoxArray(*(np.concatenate([getattr(p, f.name) for p in parts])
                          for f in dataclasses.fields(BoxArray)))


@dataclasses.dataclass
class KittiFrame:
    calib: Optional[KittiCalib]
    boxes: BoxArray  # velodyne-frame labels
    points: np.ndarray  # (N, 4)
    frame_id: int = -1


def _mat_from(tokens, rows, cols):
    m = np.array([float(t) for t in tokens[: rows * cols]], np.float64)
    return m.reshape(rows, cols)


def _extend(m34):
    return np.concatenate([m34, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)


def parse_calib(path: pathlib.Path) -> KittiCalib:
    with open(path) as f:
        lines = [l.strip().split(" ") for l in f.readlines() if l.strip()]
    p = [_extend(_mat_from(lines[i][1:], 3, 4)) for i in range(4)]
    r0 = np.eye(4)
    r0[:3, :3] = _mat_from(lines[4][1:], 3, 3)
    tr_v2c = _extend(_mat_from(lines[5][1:], 3, 4))
    tr_i2v = _extend(_mat_from(lines[6][1:], 3, 4))
    return KittiCalib(p[0], p[1], p[2], p[3], r0, tr_v2c, tr_i2v)


def parse_labels(path: pathlib.Path, calib: KittiCalib) -> BoxArray:
    """Parse label_2 txt and transform camera labels to velodyne frame."""
    rows = []
    with open(path) as f:
        for line in f:
            t = line.strip().split(" ")
            if not t or t[0] == "DontCare" or t[0] not in KittiType.__members__:
                continue
            rows.append(t)
    if not rows:
        return BoxArray.empty()

    types = np.array([int(KittiType[t[0]]) for t in rows], np.int32)
    vals = np.array([[float(v) for v in t[1:15]] for t in rows], np.float64)
    truncated = vals[:, 0]
    occluded = vals[:, 1].astype(np.int32)
    alpha = vals[:, 2]
    bbox = vals[:, 3:7]
    # camera dims order (h, w, l) -> velodyne (l, w, h); ref :186
    dims_cam = vals[:, 7:10]
    dims = dims_cam[:, [2, 1, 0]]
    loc_cam = vals[:, 10:13]
    ry = vals[:, 13]

    c2v = np.linalg.inv(calib.Tr_velo_to_cam)
    loc_h = np.concatenate([loc_cam, np.ones((len(rows), 1))], axis=1)
    loc_velo = (c2v @ loc_h.T).T[:, :3]
    yaw = -ry - np.pi / 2
    yaw = np.arctan2(np.sin(yaw), np.cos(yaw))  # wrap to (-pi, pi]; ref :190-191

    return BoxArray(
        center=loc_velo.astype(np.float32),
        dims=dims.astype(np.float32),
        yaw=yaw.astype(np.float32),
        types=types,
        truncated=truncated.astype(np.float32),
        occluded=occluded,
        alpha=alpha.astype(np.float32),
        bbox=bbox.astype(np.float32),
        location_cam=loc_cam.astype(np.float32),
        rotation_y=ry.astype(np.float32),
    )


class KittiDataset:
    """KITTI 3D object detection layout:
    <root>/data_object_{calib,label_2,velodyne}/<split>/..."""

    def __init__(self, root_path: str, split: str = "training"):
        self.root = pathlib.Path(root_path).expanduser()
        self._calib = sorted(
            (self.root / "data_object_calib" / split / "calib").iterdir())
        self._labels = sorted(
            (self.root / "data_object_label_2" / split / "label_2").iterdir())
        self._velo = sorted(
            (self.root / "data_object_velodyne" / split / "velodyne").iterdir())
        assert len(self._calib) == len(self._labels) == len(self._velo)

    def __len__(self):
        return len(self._velo)

    def __getitem__(self, idx: int) -> KittiFrame:
        calib = parse_calib(self._calib[idx])
        boxes = parse_labels(self._labels[idx], calib)
        points = np.fromfile(self._velo[idx], dtype=np.float32).reshape(-1, 4)
        return KittiFrame(calib, boxes, points, frame_id=idx)


def read_split_ids(path: pathlib.Path) -> List[int]:
    with open(path) as f:
        return [int(l.strip()) for l in f if l.strip()]
