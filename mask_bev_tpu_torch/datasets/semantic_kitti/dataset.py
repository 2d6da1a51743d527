"""SemanticKITTI scan/sequence loading (host-side numpy).

The port's copy of ``mask_bev_tpu/datasets/semantic_kitti/dataset.py``.

Behavioral rebuild of reference ``semantic_kitti_dataset.py:196-454``:
.bin point clouds, 32-bit .label files (semantic lower 16 bits, instance
upper 16), learning-map LUT remap with include/exclude filtering, per
sequence poses.txt (N,3,4 -> 4,4), times.txt, calib Tr, and the pose
algebra ``velo_to_pose = Tr^-1 @ P @ Tr`` (ref :49-66).
"""
from __future__ import annotations

import dataclasses
import io
import pathlib
from typing import Callable, Iterator, List, Optional

import numpy as np

from mask_bev_tpu_torch.datasets.semantic_kitti.taxonomy import (
    LearningLabel, SPLITS, learning_map_lut)


@dataclasses.dataclass
class SemanticKittiCalib:
    velo_to_cam: np.ndarray  # (4, 4)
    projections: dict  # P0..P3 (3, 4)


@dataclasses.dataclass
class SemanticKittiScan:
    seq_number: int
    seq_idx: int
    scan_number: int
    point_cloud: np.ndarray  # (N, 4)
    pose: np.ndarray  # (4, 4) cam-frame pose
    sem_label: Optional[np.ndarray]  # (N,)
    inst_label: Optional[np.ndarray]  # (N,)
    time: float
    calib: SemanticKittiCalib

    @property
    def has_labels(self) -> bool:
        return self.sem_label is not None

    @property
    def num_points(self) -> int:
        return self.point_cloud.shape[0]

    @property
    def velo_to_pose(self) -> np.ndarray:
        """Velodyne-frame scan -> world (ref :49-56)."""
        tr = self.calib.velo_to_cam
        return np.linalg.inv(tr) @ self.pose @ tr

    @property
    def velo_to_inv_pose(self) -> np.ndarray:
        tr = self.calib.velo_to_cam
        return np.linalg.inv(tr) @ np.linalg.inv(self.pose) @ tr

    @property
    def position(self) -> np.ndarray:
        p = self.velo_to_pose @ np.array([0.0, 0, 0, 1])
        return p[:3] / p[3]


def positions_from_poses(poses: np.ndarray, velo_to_cam: np.ndarray) -> np.ndarray:
    tr = np.linalg.inv(velo_to_cam) @ poses @ velo_to_cam
    pos = tr @ np.array([0.0, 0, 0, 1])
    return pos[:, :3] / pos[:, 3:4]


@dataclasses.dataclass
class SemanticKittiLazySequence:
    seq_number: int
    scan_indices: List[int]
    poses: np.ndarray
    calib: SemanticKittiCalib

    def positions(self) -> np.ndarray:
        return positions_from_poses(self.poses, self.calib.velo_to_cam)


@dataclasses.dataclass
class SemanticKittiSequence:
    """Eager sequence: every scan of the sequence loaded into RAM
    (reference ``semantic_kitti_dataset.py:397`` eager variant)."""

    seq_number: int
    scans: List["SemanticKittiScan"]
    poses: np.ndarray
    calib: SemanticKittiCalib

    def positions(self) -> np.ndarray:
        return positions_from_poses(self.poses, self.calib.velo_to_cam)


def load_poses(path: pathlib.Path) -> np.ndarray:
    flat = np.loadtxt(path).reshape(-1, 3, 4)
    n = flat.shape[0]
    out = np.zeros((n, 4, 4))
    out[:, :3] = flat
    out[:, 3, 3] = 1.0
    return out


def load_calib(path: pathlib.Path) -> SemanticKittiCalib:
    velo_to_cam = np.eye(4)
    projections = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            mat = np.loadtxt(io.StringIO(v)).reshape(3, 4)
            if k.strip() == "Tr":
                velo_to_cam = np.vstack([mat, [0, 0, 0, 1]])
            else:
                projections[k.strip().lower()] = mat
    return SemanticKittiCalib(velo_to_cam, projections)


def load_label(path: pathlib.Path, lut: np.ndarray):
    """.label file -> (sem_label, inst_label) with LUT remap (ref :360-374)."""
    raw = np.fromfile(path, dtype=np.uint32)
    sem = lut[(raw & 0xFFFF).astype(np.int64)]
    inst = (raw >> 16).astype(np.uint32)
    inst[sem == LearningLabel.UNLABELED] = 0
    return sem, inst


class SemanticKittiDataset:
    """Scan-level dataset over <root>/dataset/sequences/<seq>/..."""

    def __init__(self, root_path: str, split: str,
                 excluded_labels: Optional[List[int]] = None,
                 included_labels: Optional[List[int]] = None,
                 remove_unlabeled: bool = False,
                 transform: Optional[Callable] = None):
        self.root = pathlib.Path(root_path).expanduser() / "dataset"
        self.split = split
        self._transform = transform
        self._remove_unlabeled = remove_unlabeled
        self._lut = learning_map_lut(excluded_labels, included_labels)

        self.seq_numbers = sorted(SPLITS[split])
        self._seq_dirs = []
        for s in sorted((self.root / "sequences").iterdir()):
            try:
                if int(s.name) in self.seq_numbers:
                    self._seq_dirs.append(s)
            except ValueError:
                continue
        self._seq_number_to_index = {
            int(s.name): i for i, s in enumerate(self._seq_dirs)}
        self._scan_files = [
            sorted((s / "velodyne").iterdir()) for s in self._seq_dirs]
        self._label_files = (
            [sorted((s / "labels").iterdir()) for s in self._seq_dirs]
            if self.has_labels() else None)
        self._seq_len = [len(f) for f in self._scan_files]
        self._cum_len = np.cumsum(self._seq_len)
        self.poses = [load_poses(s / "poses.txt") for s in self._seq_dirs]
        self._times = [np.loadtxt(s / "times.txt", ndmin=1) for s in self._seq_dirs]
        self._calibs = [load_calib(s / "calib.txt") for s in self._seq_dirs]

    def has_labels(self) -> bool:
        return self.split != "test"

    def __len__(self) -> int:
        return int(self._cum_len[-1]) if len(self._cum_len) else 0

    def len_seq(self) -> int:
        return len(self._seq_dirs)

    def _idx_to_seq_scan(self, idx: int):
        seq_idx = int(np.searchsorted(self._cum_len, idx, side="right"))
        if seq_idx >= len(self._seq_len):
            raise IndexError(idx)
        prev = self._cum_len[seq_idx - 1] if seq_idx > 0 else 0
        return seq_idx, int(idx - prev)

    def get_sequence_scan_idx(self, seq_idx: int) -> List[int]:
        offset = int(self._cum_len[seq_idx - 1]) if seq_idx > 0 else 0
        return list(range(offset, offset + self._seq_len[seq_idx]))

    def get_in_sequence(self, seq_number: int, scan_number: int) -> SemanticKittiScan:
        return self._get_scan(self._seq_number_to_index[seq_number], scan_number)

    def _get_scan(self, seq_idx: int, scan_number: int) -> SemanticKittiScan:
        pts = np.fromfile(
            self._scan_files[seq_idx][scan_number], dtype=np.float32
        ).reshape(-1, 4)
        if self.has_labels():
            sem, inst = load_label(
                self._label_files[seq_idx][scan_number], self._lut)
        else:
            sem, inst = None, None
        if self._remove_unlabeled and sem is not None:
            keep = sem != LearningLabel.UNLABELED
            pts, sem, inst = pts[keep], sem[keep], inst[keep]
        return SemanticKittiScan(
            seq_number=int(self._seq_dirs[seq_idx].name),
            seq_idx=seq_idx,
            scan_number=scan_number,
            point_cloud=pts,
            pose=self.poses[seq_idx][scan_number],
            sem_label=sem,
            inst_label=inst,
            time=float(self._times[seq_idx][scan_number]),
            calib=self._calibs[seq_idx],
        )

    def __getitem__(self, idx: int) -> SemanticKittiScan:
        seq_idx, scan_number = self._idx_to_seq_scan(idx)
        scan = self._get_scan(seq_idx, scan_number)
        if self._transform is not None:
            scan = self._transform(scan)
        return scan


class SemanticKittiSequenceDataset:
    """Sequence-level view, lazy (default) or eager (reference
    ``semantic_kitti_dataset.py:397-433``: eager loads a whole sequence of
    scans into RAM; training always uses the lazy view)."""

    def __init__(self, root_path: str, split: str, lazy: bool = True, **kw):
        self.dataset = SemanticKittiDataset(root_path, split, **kw)
        self.root_path = self.dataset.root
        self._lazy = lazy

    def __len__(self) -> int:
        return self.dataset.len_seq()

    def __getitem__(self, seq_idx: int):
        return (self.getitem_lazy(seq_idx) if self._lazy
                else self.getitem_eager(seq_idx))

    def getitem_lazy(self, seq_idx: int) -> SemanticKittiLazySequence:
        indices = self.dataset.get_sequence_scan_idx(seq_idx)
        if not indices:
            raise ValueError("Empty sequence")
        first = self.dataset[indices[0]]
        return SemanticKittiLazySequence(
            first.seq_number, indices, self.dataset.poses[seq_idx], first.calib)

    def getitem_eager(self, seq_idx: int) -> SemanticKittiSequence:
        indices = self.dataset.get_sequence_scan_idx(seq_idx)
        if not indices:
            raise ValueError("Empty sequence")
        scans = [self.dataset[i] for i in indices]
        return SemanticKittiSequence(
            scans[0].seq_number, scans, self.dataset.poses[seq_idx],
            scans[0].calib)

    def load_scan_number_in_sequence(self, seq, scan_number: int
                                     ) -> SemanticKittiScan:
        return self.dataset.get_in_sequence(seq.seq_number, scan_number)

    def load_scan_numbers_in_sequence(self, seq, scan_numbers) -> Iterator:
        return (self.load_scan_number_in_sequence(seq, n) for n in scan_numbers)

    def load_scan_index(self, scan_idx: int) -> SemanticKittiScan:
        return self.dataset[scan_idx]

    def load_scan_indices(self, scan_indices) -> Iterator:
        return (self.dataset[i] for i in scan_indices)
