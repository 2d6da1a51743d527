"""Weight bridge: flax variables of the JAX package -> the PyTorch port."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.config import tiny_test_config as jax_tiny  # noqa: E402
from mask_bev_tpu.models.maskbev import MaskBev as JaxMaskBev  # noqa: E402
from mask_bev_tpu_torch.config import tiny_test_config  # noqa: E402
from mask_bev_tpu_torch.models.convert import (  # noqa: E402
    _flatten, from_flax, load_flax)
from mask_bev_tpu_torch.models.maskbev import MaskBev  # noqa: E402


def _variables(depths):
    cfg = jax_tiny().replace(backbone_depths=depths)
    n = cfg.max_points_per_scan
    v = jax.eval_shape(lambda: JaxMaskBev(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, n, 4)),
        jnp.ones((1, n), bool), train=False))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), v)


@pytest.mark.parametrize("depths", [(1, 1, 2, 1), (2, 2, 4, 2)])
def test_every_leaf_consumed(depths):
    """Each flax leaf lands in exactly one port tensor with its values; the
    (2, 2, 4, 2) case builds the nn.scan-stacked ``stage{i}_pairs``."""
    v = _variables(depths)
    if depths[2] >= 4:
        assert "stage2_pairs" in v["params"]["backbone"]
    model = MaskBev(tiny_test_config().replace(backbone_depths=depths))
    load_flax(model, v)
    sd = model.state_dict()
    n_leaf_values = sum(np.asarray(a).size for _, a in _flatten(v))
    assert n_leaf_values == sum(t.numel() for t in sd.values())

    bp = v["params"]["backbone"]
    if depths[2] >= 4:
        # slice g of block b is block 2g + b
        q = bp["stage2_pairs"]["block1"]["attn"]["w_msa"]["qkv"]["kernel"]
        np.testing.assert_array_equal(
            sd["backbone.stage2_block3.attn.w_msa.qkv.weight"].numpy(),
            q[1].T)
    # decoder scan layout: layer 3g + l is slice g of lvl{l}
    lt = v["params"]["decoder"]["layers"]
    np.testing.assert_array_equal(
        sd["decoder.layer2.self_attn.v.weight"].numpy(),
        lt["lvl2_self"]["v"]["kernel"][0].T)
    np.testing.assert_array_equal(
        sd["backbone.patch_embed.weight"].numpy(),
        bp["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["encoder.pillar_feature_net.pfn_1.norm.running_var"].numpy(),
        v["batch_stats"]["encoder"]["pillar_feature_net"]["pfn_1"]["norm"][
            "var"])
    np.testing.assert_array_equal(sd["encoder.norm.weight"].numpy(),
                                  v["params"]["encoder"]["norm"]["scale"])


def test_leftover_and_missing_keys_raise():
    v = _variables((1, 1, 2, 1))
    v["params"]["decoder"]["heads"]["height_embed"] = {
        "kernel": np.zeros((64, 12), np.float32)}
    with pytest.raises(KeyError, match="left over"):
        load_flax(MaskBev(tiny_test_config()), v)
    v = _variables((1, 1, 2, 1))
    del v["params"]["decoder"]["query_embed"]
    with pytest.raises(KeyError, match="not set"):
        load_flax(MaskBev(tiny_test_config()), v)
    v = _variables((1, 1, 2, 1))
    v["params"]["backbone"]["absolute_pos_embed"] = np.zeros((2, 2, 48))
    # the embedding maps to a port key, which a model without it lacks
    with pytest.raises(KeyError, match="left over"):
        load_flax(MaskBev(tiny_test_config()), v)
    v = _variables((1, 1, 2, 1))
    v["params"]["backbone"]["pos_scale"] = np.zeros((2, 2, 48))
    with pytest.raises(KeyError, match="no place"):
        from_flax(v)
