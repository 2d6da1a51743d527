"""Point-free dataset-transform combinators.

The port's copy of ``mask_bev_tpu/utils/pipeline.py``.

Rebuild of the reference's pipeline DSL (``utils/pipeline.py:8-202``):
``Lambda, Identity, Compose, Tupled, MapAll, Tee, MapNth, First, Second,
Third, Bifunctor, Both, Inspect``. The datamodules compose their
user-supplied ``sample_transforms`` hooks through ``Compose``/``Identity``
(``datasets/semantic_kitti/mask_data.py``, ``datasets/kitti/kitti_data.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Sequence


class Lambda:
    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, x):
        return self.fn(x)


class Identity:
    def __call__(self, x):
        return x


class Compose:
    def __init__(self, fns: Sequence[Callable]):
        self.fns = list(fns)

    def __call__(self, x):
        for f in self.fns:
            x = f(x)
        return x


class Tupled:
    """x -> (x,) * n."""

    def __init__(self, n: int):
        self.n = n

    def __call__(self, x):
        return tuple(x for _ in range(self.n))


class MapAll:
    """Apply fn to every element of a tuple."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, xs):
        return tuple(self.fn(x) for x in xs)


class Tee:
    """x -> (f(x), g(x), ...)."""

    def __init__(self, fns: Sequence[Callable]):
        self.fns = list(fns)

    def __call__(self, x):
        return tuple(f(x) for f in self.fns)


class MapNth:
    """Apply fn to the n-th element of a tuple, pass the rest through."""

    def __init__(self, n: int, fn: Callable):
        self.n = n
        self.fn = fn

    def __call__(self, xs):
        return tuple(self.fn(x) if i == self.n else x for i, x in enumerate(xs))


def First(fn: Callable) -> MapNth:
    return MapNth(0, fn)


def Second(fn: Callable) -> MapNth:
    return MapNth(1, fn)


def Third(fn: Callable) -> MapNth:
    return MapNth(2, fn)


class Bifunctor:
    def __init__(self, f: Callable, g: Callable):
        self.f = f
        self.g = g

    def __call__(self, xs):
        a, b = xs
        return (self.f(a), self.g(b))


class Both:
    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, xs):
        a, b = xs
        return (self.fn(a), self.fn(b))


class Inspect:
    """Identity that calls a side-effect (debugging)."""

    def __init__(self, fn: Callable = print):
        self.fn = fn

    def __call__(self, x):
        self.fn(x)
        return x


class ApplyTransform:
    """Dataset wrapper applying a transform in __getitem__
    (reference ``datasets/apply_transform.py:9-17``)."""

    def __init__(self, dataset, transform: Callable):
        self.dataset = dataset
        self.transform = transform

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        return self.transform(self.dataset[idx])
