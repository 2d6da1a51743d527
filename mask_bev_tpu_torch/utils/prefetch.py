"""Background-thread batch prefetching.

The port's own copy of ``mask_bev_tpu/utils/prefetch.py``.

The reference overlaps input work with compute via DataLoader worker
processes (``num_workers``). Here a bounded background thread assembles the
next host batches while the device steps — on a jit-async runtime the
device call returns immediately, so a single prefetch thread hides most of
the numpy pipeline.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``it`` on a daemon thread, keeping up to ``depth`` items ready."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err: list = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if err:
                raise err[0]
            return
        yield item
