"""SemanticKITTI label taxonomy (the public semantic-kitti-api standard).

The port's copy of ``mask_bev_tpu/datasets/semantic_kitti/taxonomy.py``.

Embeds the dataset's standard raw-label ids, learning map, and
train/valid/test sequence splits that the reference keeps in
``configs/semantic_kitti/semantic-kitti.yaml`` (consumed at reference
``semantic_kitti_dataset.py:218-242``). Values are the published
SemanticKITTI conventions, expressed as python dicts.
"""
from __future__ import annotations

import numpy as np


class RawLabel:
    """Raw 16-bit semantic ids (reference ``SemanticKittiRawLabel``)."""

    UNLABELED = 0
    OUTLIER = 1
    CAR = 10
    BICYCLE = 11
    BUS = 13
    MOTORCYCLE = 15
    ON_RAILS = 16
    TRUCK = 18
    OTHER_VEHICLE = 20
    PERSON = 30
    BICYCLIST = 31
    MOTORCYCLIST = 32
    ROAD = 40
    PARKING = 44
    SIDEWALK = 48
    OTHER_GROUND = 49
    BUILDING = 50
    FENCE = 51
    OTHER_STRUCTURE = 52
    LANE_MARKING = 60
    VEGETATION = 70
    TRUNK = 71
    TERRAIN = 72
    POLE = 80
    TRAFFIC_SIGN = 81
    OTHER_OBJECT = 99
    MOVING_CAR = 252
    MOVING_BICYCLIST = 253
    MOVING_PERSON = 254
    MOVING_MOTORCYCLIST = 255
    MOVING_ON_RAILS = 256
    MOVING_BUS = 257
    MOVING_TRUCK = 258
    MOVING_OTHER_VEHICLE = 259


class LearningLabel:
    """Post-remap learning ids (reference ``SemanticKittiLearningLabel``)."""

    UNLABELED = 0
    CAR = 1
    BICYCLE = 2
    MOTORCYCLE = 3
    TRUCK = 4
    OTHER_VEHICLE = 5
    PERSON = 6
    BICYCLIST = 7
    MOTORCYCLIST = 8
    ROAD = 9
    PARKING = 10
    SIDEWALK = 11
    OTHER_GROUND = 12
    BUILDING = 13
    FENCE = 14
    VEGETATION = 15
    TRUNK = 16
    TERRAIN = 17
    POLE = 18
    TRAFFIC_SIGN = 19


# standard semantic-kitti learning_map (raw id -> learning id)
LEARNING_MAP = {
    0: 0, 1: 0,
    10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5,
    30: 6, 31: 7, 32: 8,
    40: 9, 44: 10, 48: 11, 49: 12,
    50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17,
    80: 18, 81: 19, 99: 0,
    252: 1, 253: 7, 254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

SPLITS = {
    "train": [0, 1, 2, 3, 4, 5, 6, 7, 9, 10],
    "valid": [8],
    "test": [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21],
}


def learning_map_lut(excluded_labels=None, included_labels=None) -> np.ndarray:
    """Raw-label -> learning-label LUT with include/exclude semantics
    (reference ``semantic_kitti_dataset.py:230-242``)."""
    if excluded_labels is not None and included_labels is not None:
        raise ValueError("excluded_labels and included_labels are exclusive")
    lut = np.zeros(max(LEARNING_MAP) + 100, np.int32)
    lut[list(LEARNING_MAP.keys())] = list(LEARNING_MAP.values())
    if excluded_labels is not None:
        lut[np.asarray(excluded_labels)] = RawLabel.UNLABELED
    elif included_labels is not None:
        included = np.atleast_1d(np.asarray(included_labels))
        excluded = np.ones_like(lut, bool)
        excluded[included] = False
        lut[excluded] = RawLabel.UNLABELED
    return lut
