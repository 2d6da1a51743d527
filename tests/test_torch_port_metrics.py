"""The per-decoder-layer metric bank and the metric accumulators of the port
against the JAX package's, on the CPU.

* ``LayerMetricsBank.compute()`` against ``mask_bev_tpu.train.metrics.
  LayerMetricsBank`` on the same decoder outputs (logits built from the GT
  masks plus noise, so IoUs and mAPs are far from 0), the same synthetic GT
  and the same matching points (the JAX bank's own draws, taken from its
  keys and passed to the port as ``match_coords``), over two batches:
  every key, to 1e-6. Also one layer through ``update_layer_metrics``.
* Every accumulator of ``evaluation/detection_metric.py`` against the JAX
  module's on the same arrays, to 1e-9 (the same numpy code).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from mask_bev_tpu.datasets.synthetic import make_batch  # noqa: E402
from mask_bev_tpu.evaluation import detection_metric as jdm  # noqa: E402
from mask_bev_tpu.models.mask2former import (  # noqa: E402
    DecoderOutputs as JaxOutputs)
from mask_bev_tpu.train import metrics as jmet  # noqa: E402
from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.evaluation import (  # noqa: E402
    detection_metric as tdm)
from mask_bev_tpu_torch.models.mask2former import (  # noqa: E402
    DecoderOutputs)
from mask_bev_tpu_torch.train import metrics as tmet  # noqa: E402

# the tiny config's 256 matching points: with far fewer, two GT instances
# can sample to identical cost columns, an exact tie that the two matchers
# (whose f32 costs differ in the last bits) break either way
# two classes, so that GT labels of 1 meet predictions of class 1 (the
# bank's segm mAP skips class 0)
KW = dict(head_num_points=256, head_num_classes=2)


def _outputs(cfg, batch, seed):
    """(L+1, B, Q, K+1) class logits and (L+1, B, Q, H/4, W/4) mask logits:
    query q of layer l predicts GT (q + l) mod Q, downsampled, plus noise."""
    rng = np.random.default_rng(seed)
    n_l, q = cfg.num_decoder_outputs, cfg.num_queries
    gt = batch["gt_masks"].astype(np.float32)
    b, _, h, w = gt.shape
    ds = gt.reshape(b, q, h // 4, 4, w // 4, 4).mean((3, 5))
    masks = np.stack([np.roll(ds, -li, axis=1) for li in range(n_l)])
    masks = 8.0 * (masks - 0.4) + 0.5 * rng.normal(size=masks.shape)
    cls = rng.normal(size=(n_l, b, q, cfg.head_num_classes + 1)) * 2.0
    return cls.astype(np.float32), masks.astype(np.float32)


def _jax_coords(rng, cfg, b, n_l):
    """The matching points the JAX bank draws from ``rng``, per layer."""
    out = []
    for _ in range(n_l):
        rng, sub = jax.random.split(rng)
        keys = jax.random.split(sub, b)
        out.append(np.array(jax.vmap(lambda k: jax.random.uniform(
            k, (cfg.head_num_points, 2)))(keys)))
    return out


@pytest.fixture(scope="module")
def case():
    jcfg = jax_tiny().replace(**KW)
    tcfg = tiny_test_config().replace(**KW)
    batches = [make_batch(np.random.default_rng(s), jcfg, batch_size=2)
               for s in (0, 1)]
    outs = [_outputs(jcfg, bt, s + 10) for s, bt in enumerate(batches)]
    return jcfg, tcfg, batches, outs


def test_layer_metrics_bank_matches_jax(case):
    jcfg, tcfg, batches, outs = case
    jbank = jmet.LayerMetricsBank(jcfg)
    tbank = tmet.LayerMetricsBank(tcfg)
    n_l = jcfg.num_decoder_outputs
    for i, (bt, (cls, masks)) in enumerate(zip(batches, outs)):
        rng = jax.random.PRNGKey(100 + i)
        jbank.update(rng, JaxOutputs(jnp.asarray(cls), jnp.asarray(masks),
                                     None), bt)
        tbank.update(DecoderOutputs(torch.as_tensor(cls),
                                    torch.as_tensor(masks), None), bt,
                     match_coords=_jax_coords(rng, jcfg, 2, n_l))
    want = jbank.compute()
    got = tbank.compute()
    assert set(got) == set(want)
    assert len(got) == 5 * n_l
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert max(got[f"mIoU_{i}"] for i in range(n_l)) > 0.3
    assert max(got[f"mAP_{i}_map_50"] for i in range(n_l)) > 0.1
    tbank.reset()
    assert tbank.compute()["mIoU_0"] == 0.0


def test_update_layer_metrics_matches_jax(case):
    jcfg, tcfg, batches, outs = case
    cls, masks = outs[0]
    rng = jax.random.PRNGKey(7)
    jm, tm = jmet.LayerMetrics.create(), tmet.LayerMetrics.create()
    jmet.update_layer_metrics(rng, JaxOutputs(jnp.asarray(cls),
                                              jnp.asarray(masks), None),
                              batches[0], jm, jcfg, layer_index=-1)
    keys = jax.random.split(rng, 2)
    coords = np.array(jax.vmap(lambda k: jax.random.uniform(
        k, (jcfg.head_num_points, 2)))(keys))
    tmet.update_layer_metrics(DecoderOutputs(torch.as_tensor(cls),
                                             torch.as_tensor(masks), None),
                              batches[0], tm, tcfg, layer_index=-1,
                              match_coords=coords)
    want, got = jm.compute(), tm.compute()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_bank_draws_from_the_generator(case):
    """Without pinned points the bank draws them from the generator: the
    same seed gives the same metrics."""
    _, tcfg, batches, outs = case
    res = []
    for _ in range(2):
        bank = tmet.LayerMetricsBank(tcfg)
        gen = torch.Generator().manual_seed(3)
        for bt, (cls, masks) in zip(batches, outs):
            bank.update(DecoderOutputs(torch.as_tensor(cls),
                                       torch.as_tensor(masks), None), bt,
                        gen)
        res.append(bank.compute())
    assert res[0] == res[1]


def _pair(name, *args):
    return getattr(jdm, name)(*args), getattr(tdm, name)(*args)


def test_detection_metrics_match_jax():
    rng = np.random.default_rng(5)
    j, t = _pair("BinaryClassifMapMetric")
    for _ in range(3):
        s, y = rng.uniform(size=40), rng.integers(0, 2, 40)
        j.update(s, y)
        t.update(s, y)
    np.testing.assert_allclose(t.compute(), j.compute(), rtol=0, atol=1e-9)

    j, t = _pair("ClassifMapMetric", 4)
    for _ in range(2):
        s, y = rng.dirichlet(np.ones(4), 30), rng.integers(0, 4, 30)
        j.update(s, y)
        t.update(s, y)
    np.testing.assert_allclose(t.compute(), j.compute(), rtol=0, atol=1e-9)

    for mode in tdm.IntegrationMode:
        j = jdm.DetectionMapMetric(jdm.IntegrationMode[mode.name])
        t = tdm.DetectionMapMetric(mode)
        for _ in range(2):
            c, tp = rng.uniform(size=25), rng.uniform(size=25) > 0.4
            j.update(c, tp, 20)
            t.update(c, tp, 20)
        np.testing.assert_allclose(t.compute(), j.compute(), rtol=0,
                                   atol=1e-9)

    j, t = _pair("MeanIoU")
    v = rng.uniform(size=17)
    j.update(v)
    t.update(v)
    np.testing.assert_allclose(t.compute(), j.compute(), rtol=0, atol=1e-9)

    j, t = _pair("MaskArea")
    for inst in range(3):
        a, b = rng.uniform(size=(2, 8, 8)) > 0.5
        j.update(a, b, inst)
        t.update(a, b, inst)
    assert t.compute() == j.compute()

    j, t = _pair("MaskMeanAveragePrecision")
    for _ in range(3):
        gm = rng.uniform(size=(4, 12, 12)) > 0.6
        pm = np.concatenate([gm ^ (rng.uniform(size=gm.shape) > 0.9),
                             rng.uniform(size=(2, 12, 12)) > 0.5])
        ps, pl = rng.uniform(size=6), rng.integers(1, 3, 6)
        gl = rng.integers(1, 3, 4)
        j.update(pm, ps, pl, gm, gl)
        t.update(pm, ps, pl, gm, gl)
        ious = rng.uniform(size=(6, 4))
        j.update_from_ious(ps, pl, gl, ious)
        t.update_from_ious(ps, pl, gl, ious)
    want, got = j.compute_dict(), t.compute_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9)
    np.testing.assert_allclose(t.compute(), j.compute(), rtol=0, atol=1e-9)
