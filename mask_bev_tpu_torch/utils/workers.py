"""Multi-process sample loading (the reference's DataLoader workers).

The port's copy of ``mask_bev_tpu/utils/workers.py``. The reference
parallelizes host-side sample assembly (mask-cache misses, rasterization,
augmentation) with ``num_workers`` DataLoader processes
(``semantic_kitti_mask_data_module.py:122-133``). Here a fork-context
process pool maps the per-sample function over the epoch order, in order,
while the main process collates and the device computes.

Determinism: each sample draws from ``default_rng([seed, position])`` — the
stream is bitwise identical for ANY ``num_workers`` (including 0), unlike
torch DataLoader whose augmentation draws depend on worker scheduling.

Fork safety: the pool is forked from a process whose CUDA context may be
live (the trainer's prefetch thread starts the epoch after the first
steps). A forked child must not touch CUDA, torch ops or an OpenMP region
of the parent's runtime, so the sample functions are numpy and scipy only
(the host core, ``native.py``, is plain C++ without threads).
"""
from __future__ import annotations

import multiprocessing as mp
import warnings
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np

_WORKER_SAMPLE_FN: Callable | None = None


def _init_worker(fn) -> None:
    global _WORKER_SAMPLE_FN
    _WORKER_SAMPLE_FN = fn


def _run_sample(arg):
    idx, seed_key = arg
    return _WORKER_SAMPLE_FN(idx, np.random.default_rng(seed_key))


def _cuda_is_live() -> bool:
    import sys

    torch = sys.modules.get("torch")  # never import torch just to ask
    return bool(torch is not None and torch.cuda.is_initialized())


def sample_stream(
    sample_fn: Callable[[int, np.random.Generator], Dict[str, np.ndarray]],
    order: Sequence[int],
    seed: int,
    num_workers: int = 0,
    chunksize: int = 2,
    positions: Optional[Sequence[int]] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield ``sample_fn(idx, rng)`` for each idx in order, optionally fanned
    out over a process pool. ``sample_fn`` is shipped to workers by fork
    inheritance (no pickling), so closures over dataset objects are fine.
    ``positions``: only the samples at these positions of ``order``, each
    with its own position's draws (a rank's rows of every global batch,
    ``parallel/distributed.py::rank_positions``). Closing the stream
    terminates the pool."""
    if positions is None:
        positions = range(len(order))
    args = [(int(order[pos]), [seed, int(pos)]) for pos in positions]
    if num_workers <= 0:
        for idx, sk in args:
            yield sample_fn(idx, np.random.default_rng(sk))
        return
    if _cuda_is_live():
        warnings.warn(
            "sample_stream(num_workers>0) forks with a live CUDA context; "
            "the workers must run numpy/scipy only (no torch op, no CUDA, "
            "no OpenMP region). If workers hang, set num_workers=0.",
            RuntimeWarning, stacklevel=2)
    ctx = mp.get_context("fork")
    pool = ctx.Pool(num_workers, initializer=_init_worker, initargs=(sample_fn,))
    try:
        yield from pool.imap(_run_sample, args, chunksize=chunksize)
    finally:
        pool.terminate()
        pool.join()


def batched(stream: Iterator[Dict[str, np.ndarray]], batch_size: int,
            total: int) -> Iterator[Dict[str, np.ndarray]]:
    """Collate a sample stream into stacked batches, dropping the last
    partial batch (the reference uses drop_last for train/val). The stream
    is closed when the batches end or are closed (its worker pool, if any,
    is terminated then)."""
    chunk = []
    n_batches = total // batch_size
    emitted = 0
    try:
        for s in stream:
            chunk.append(s)
            if len(chunk) == batch_size:
                yield {k: np.stack([c[k] for c in chunk]) for k in chunk[0]}
                chunk = []
                emitted += 1
                if emitted >= n_batches:
                    return
    finally:
        close = getattr(stream, "close", None)
        if close is not None:
            close()
