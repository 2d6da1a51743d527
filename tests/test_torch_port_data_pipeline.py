"""The port's host pipeline against the JAX package's: the transform
combinators, ``sample_stream`` / ``batched`` with 0 and 2 worker processes,
and the prefetch thread's clean stop.

Streams are compared bit for bit (tolerance 0): each sample draws from
``default_rng([seed, position])`` in both packages, whatever the number of
workers. The prefetch checks count live worker processes
(``multiprocessing.active_children``) and live threads named ``prefetch``
after an epoch is cut short.
"""
import contextlib
import multiprocessing as mp
import threading

import numpy as np
import pytest

from mask_bev_tpu.utils import pipeline as jax_pipeline
from mask_bev_tpu.utils.workers import (
    batched as jax_batched, sample_stream as jax_sample_stream)
from mask_bev_tpu_torch.utils import pipeline
from mask_bev_tpu_torch.utils.prefetch import prefetch
from mask_bev_tpu_torch.utils.workers import batched, sample_stream


def _combinators(m):
    inc = m.Lambda(lambda x: x + 1)
    dbl = m.Lambda(lambda x: x * 2)
    return {
        "compose": (m.Compose([inc, dbl, m.Identity()]), 3),
        "tupled": (m.Tupled(3), 5),
        "first": (m.First(inc), (1, 2, 3)),
        "second": (m.Second(dbl), (1, 2, 3)),
        "third": (m.Third(m.Lambda(str)), (1, 2, 3)),
        "mapnth": (m.MapNth(1, m.Lambda(lambda x: -x)), (4, 5)),
        "mapall": (m.MapAll(inc), (1, 2, 3)),
        "tee": (m.Tee([inc, dbl]), 5),
        "bifunctor": (m.Bifunctor(inc, dbl), (1, 10)),
        "both": (m.Both(dbl), (3, 4)),
        "inspect": (m.Inspect(lambda x: None), 42),
        "apply_transform": (m.ApplyTransform([1, 2, 3], dbl), 1),
    }


@pytest.mark.parametrize("name", sorted(_combinators(pipeline)))
def test_combinators_match_jax(name):
    fn, x = _combinators(pipeline)[name]
    jfn, jx = _combinators(jax_pipeline)[name]
    if name == "apply_transform":
        assert len(fn) == len(jfn) == 3
        assert [fn[i] for i in range(3)] == [jfn[i] for i in range(3)]
    else:
        assert fn(x) == jfn(jx)


def _sample(idx: int, rng: np.random.Generator):
    return {"points": rng.standard_normal((16, 4)).astype(np.float32) + idx,
            "label": np.int32(rng.integers(0, 100)),
            "mask": rng.random((5, 6)) < 0.5}


def _stream(mod_stream, mod_batched, workers):
    order = [7, 3, 0, 9, 4, 1, 8]
    return list(mod_batched(mod_stream(_sample, order, 11,
                                       num_workers=workers), 2, len(order)))


@pytest.mark.parametrize("workers", [0, 2])
def test_sample_stream_matches_jax(workers):
    got = _stream(sample_stream, batched, workers)
    want = _stream(jax_sample_stream, jax_batched, 0)
    assert len(got) == len(want) == 3  # drop_last: 7 samples, batch 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])
    assert not mp.active_children()


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "prefetch" and t.is_alive()]


def test_prefetch_closes_its_source_when_cut():
    closed = []

    def source():
        try:
            for i in range(100):
                yield i
        finally:
            closed.append(True)

    with contextlib.closing(prefetch(source(), depth=2)) as it:
        assert [next(it) for _ in range(3)] == [0, 1, 2]
    assert closed == [True]
    assert not _prefetch_threads()
    # run to its end, the prefetch passes every item and an error through
    assert list(prefetch(range(5))) == list(range(5))

    def broken():
        yield 1
        raise KeyError("source failed")

    with pytest.raises(KeyError, match="source failed"):
        list(prefetch(broken()))
    assert not _prefetch_threads()


def test_cut_epoch_leaves_no_worker_or_thread(tmp_path):
    """A pool-backed SemanticKITTI epoch of 6 batches, cut by
    ``Trainer.train_epoch`` at ``limit_train_batches=1``: after the epoch
    no worker process and no prefetch thread is alive. (With the prefetch
    two batches deep, an epoch of 3 would be produced whole before the
    cut, and its pool would end with it; at 6 the pool is still working
    when the step loop stops.)"""
    torch = pytest.importorskip("torch")
    from mask_bev_tpu_torch.config import tiny_test_config
    from mask_bev_tpu_torch.datasets.disk_trees import (
        write_semantic_kitti_tree)
    from mask_bev_tpu_torch.datasets.semantic_kitti.mask_data import (
        SemanticKittiMaskDataModule)
    from mask_bev_tpu_torch.train.loop import Trainer

    root = write_semantic_kitti_tree(
        tmp_path / "sk", seed=4, train_scans=12, valid_scans=2, points=1500,
        radius=9.0, spacing=5.0, lanes=(-3.0, 3.0), car_points=1200.0)
    cfg = tiny_test_config().replace(
        dataset="semantic_kitti", x_range=(-6.4, 6.4), y_range=(-6.4, 6.4),
        voxel_size=0.16, batch_size=2, num_workers=2, limit_train_batches=1,
        max_num_pillars=256, head_num_points=64, loss_gt_crop=48,
        log_images=False, compute_train_metrics=False)
    dm = SemanticKittiMaskDataModule(str(root), cfg)
    tr = Trainer(cfg, workdir=str(tmp_path / "runs"), device="cpu")
    stream = dm.train_batches(0)
    loss = tr.train_epoch(stream, torch.Generator().manual_seed(0))
    assert np.isfinite(loss) and tr.state.step == 1
    assert stream.gi_frame is None  # the epoch's generator was closed
    assert not mp.active_children()
    assert not _prefetch_threads()
