"""RandAugment over point-cloud augmentations.

The port's copy of ``mask_bev_tpu/augmentations/rand_augment.py``.

Behavior of reference ``augmentations/rand_augment.py:18-22``: sample k
transforms from the list and apply them with a shared magnitude.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np


class RandAugment:
    def __init__(self, num_augments: int, transforms: List[Callable],
                 magnitude: float = 1.0):
        self.num_augments = num_augments
        self.transforms = transforms
        self.magnitude = magnitude

    def __call__(self, x, rng: np.random.Generator, magnitude: float = None):
        mag = self.magnitude if magnitude is None else magnitude
        idx = rng.choice(len(self.transforms), self.num_augments, replace=False)
        for i in idx:
            x = self.transforms[i](x, rng, magnitude=mag)
        return x
