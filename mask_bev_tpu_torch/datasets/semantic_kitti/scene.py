"""Multi-scan scene accumulation in the world frame.

The port's copy of ``mask_bev_tpu/datasets/semantic_kitti/scene.py``.

Rebuild of reference ``semantic_kitti_scene.py:23-81`` (``SceneMaker``):
scans are transformed by ``velo_to_pose`` into the world frame and appended
into a growing buffer together with their labels. Vectorized transform, list
append instead of a preallocated max_points buffer.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from mask_bev_tpu_torch.datasets.semantic_kitti.dataset import (
    SemanticKittiCalib, SemanticKittiScan)


@dataclasses.dataclass
class SemanticKittiScene:
    seq_number: int
    scan_numbers: List[int]
    point_cloud: np.ndarray  # (N, 4) world-frame xyz + intensity
    sem_label: Optional[np.ndarray]
    inst_label: Optional[np.ndarray]
    calib: SemanticKittiCalib


class SceneMaker:
    def __init__(self, max_points: Optional[int] = None):
        # max_points accepted for API parity; buffers grow dynamically
        self._seq_number: Optional[int] = None
        self._calib: Optional[SemanticKittiCalib] = None
        self._scan_numbers: List[int] = []
        self._pcs: List[np.ndarray] = []
        self._sems: List[np.ndarray] = []
        self._insts: List[np.ndarray] = []
        self._has_labels = False

    def add_scan(self, scan: SemanticKittiScan) -> None:
        if self._seq_number is None:
            self._seq_number = scan.seq_number
            self._calib = scan.calib
            self._has_labels = scan.has_labels
        if scan.seq_number != self._seq_number:
            raise ValueError("Scan not from same sequence")
        self._scan_numbers.append(scan.scan_number)

        pts = scan.point_cloud
        world = pts[:, :3] @ scan.velo_to_pose[:3, :3].T + scan.velo_to_pose[:3, 3]
        self._pcs.append(
            np.hstack([world, pts[:, 3:4]]).astype(np.float64))
        if self._has_labels:
            self._sems.append(scan.sem_label)
            self._insts.append(scan.inst_label)

    @property
    def scene(self) -> SemanticKittiScene:
        if not self._scan_numbers:
            raise RuntimeError("No scan in scene")
        return SemanticKittiScene(
            seq_number=self._seq_number,
            scan_numbers=self._scan_numbers,
            point_cloud=np.concatenate(self._pcs),
            sem_label=np.concatenate(self._sems) if self._has_labels else None,
            inst_label=np.concatenate(self._insts) if self._has_labels else None,
            calib=self._calib,
        )
