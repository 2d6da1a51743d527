"""Background-thread batch prefetching.

The port's own copy of ``mask_bev_tpu/utils/prefetch.py``.

The reference overlaps input work with compute via DataLoader worker
processes (``num_workers``). Here a bounded background thread assembles the
next host batches while the device steps: the card's launches are
asynchronous, so a single prefetch thread hides most of the numpy pipeline.

When the consumer stops early (``Trainer.train_epoch`` at
``limit_train_batches``) and closes the iterator, the thread stops after the
item it is producing, closes its source (which terminates a
``sample_stream`` worker pool) and is joined before ``close`` returns.
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
    stop = threading.Event()

    def put(item) -> bool:
        """Queue ``item`` unless the consumer has stopped."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    break
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()  # runs the source's finally blocks on this thread
            put(_SENTINEL)

    t = threading.Thread(target=worker, name="prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        t.join()
