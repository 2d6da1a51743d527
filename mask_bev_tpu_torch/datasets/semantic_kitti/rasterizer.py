"""SemanticKITTI GT rasterizer: accumulated scene -> BEV instance-id mask.

The port's copy of ``mask_bev_tpu/datasets/semantic_kitti/rasterizer.py``;
the morphology runs in the port's C++ host core (``native.py``), whose
numpy twin is :func:`mask_bev_tpu_torch.ops.morphology.close_then_open`.

Behavioral rebuild of reference ``semantic_kitti_rasterizer.py:41-98``:
transform the scene into the center scan's frame, crop to range (exclusive
bounds), per-point voxel indices via floor division, then per instance a
binary image cleaned with morphological CLOSE then OPEN (9x9 rect kernel,
cv2's border semantics).
``remove_unseen`` keeps only instances with >= min_points in the center scan
(ref :73-80).

Orientation: returns (num_voxel_y, num_voxel_x), i.e. already the (H, W)
layout the model uses. The reference returns (x, y) here and transposes in
``MaskToLabelInstanceMasks`` (``semantic_kitti_transforms.py:74``); we fold
the transpose in.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from mask_bev_tpu_torch.datasets.semantic_kitti.dataset import SemanticKittiScan
from mask_bev_tpu_torch.datasets.semantic_kitti.scene import SemanticKittiScene
from mask_bev_tpu_torch.native import close_then_open


class SemanticKittiRasterizer:
    def __init__(self, x_range, y_range, z_range, voxel_size: float,
                 remove_unseen: bool = False, min_points: int = 1,
                 morph_kernel_size: int = 9):
        self.x_range = tuple(x_range)
        self.y_range = tuple(y_range)
        self.z_range = tuple(z_range)
        self.voxel_size = voxel_size
        self.num_voxel_x = int(round((x_range[1] - x_range[0]) / voxel_size))
        self.num_voxel_y = int(round((y_range[1] - y_range[0]) / voxel_size))
        self.remove_unseen = remove_unseen
        self.min_points = min_points
        self.morph_kernel_size = morph_kernel_size

    def get_mask_around(self, scan: SemanticKittiScan,
                        scene: SemanticKittiScene,
                        return_heights: bool = False):
        """(H=num_voxel_y, W=num_voxel_x) int mask; 0 = background.

        With ``return_heights``: also {instance_id: z-extent} from the
        in-range scene points (feeds the height head's GT cache).
        """
        pts = scene.point_cloud[:, :3] @ scan.velo_to_inv_pose[:3, :3].T \
            + scan.velo_to_inv_pose[:3, 3]
        inst = scene.inst_label

        in_range = (
            (pts[:, 0] > self.x_range[0]) & (pts[:, 0] < self.x_range[1])
            & (pts[:, 1] > self.y_range[0]) & (pts[:, 1] < self.y_range[1])
            & (pts[:, 2] > self.z_range[0]) & (pts[:, 2] < self.z_range[1])
        )
        pts = pts[in_range]
        inst = inst[in_range]
        ix = ((pts[:, 0] - self.x_range[0]) // self.voxel_size).astype(np.int64)
        iy = ((pts[:, 1] - self.y_range[0]) // self.voxel_size).astype(np.int64)

        if self.remove_unseen:
            ids, counts = np.unique(
                scan.inst_label[scan.inst_label != 0], return_counts=True)
            present = set(ids[counts >= self.min_points].tolist())
        else:
            present = set(np.unique(inst).tolist()) - {0}

        out = np.zeros((self.num_voxel_y, self.num_voxel_x), np.int64)
        heights = {}
        for instance in sorted(present):
            sel = inst == instance
            if not sel.any():
                continue
            img = np.zeros_like(out, bool)
            img[iy[sel], ix[sel]] = True
            img = close_then_open(img, self.morph_kernel_size)
            out[img] = instance
            if return_heights:
                z = pts[sel, 2]
                heights[int(instance)] = float(z.max() - z.min())
        if return_heights:
            return out, heights
        return out
