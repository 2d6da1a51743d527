"""Weight bridge: the JAX package's flax variables -> this port's state_dict.

``from_flax`` takes ``{"params": ..., "batch_stats": ...}`` as nested dicts
of numpy arrays (``jax.device_get`` of the flax variables) and returns a
state_dict for :class:`mask_bev_tpu_torch.models.maskbev.MaskBev`:

* Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in);
* Conv ``kernel`` HWIO -> ``weight`` OIHW;
* LayerNorm / GroupNorm / batch-norm / pseudo-image-norm ``scale`` ->
  ``weight`` (the pseudo-image norm keeps its (H, W, C) shape);
* ``MaskedBatchNorm`` ``batch_stats`` ``mean``/``var`` -> ``running_mean``/
  ``running_var``;
* the ``nn.scan``-stacked ``backbone/stage{i}_pairs/block{b}`` trees are
  split along axis 0: slice ``g`` is block ``2g + b``;
* the decoder's ``layers/lvl{l}_*`` trees: slice ``g`` is layer
  ``3g + l`` (``self`` becomes ``self_attn``).

A leaf the port has no place for raises; :func:`load_flax` also raises on
any port parameter that the variables leave unset.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_PLAIN_LEAVES = {"bias", "query_feat", "query_embed", "level_embed",
                 "rel_pos_bias_table"}


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _leaf(path: Tuple[str, ...], a: np.ndarray, collection: str):
    """(port leaf name, converted array) for one flax leaf."""
    name = path[-1]
    if collection == "batch_stats":
        if name == "mean":
            return "running_mean", a
        if name == "var":
            return "running_var", a
    elif name == "kernel":
        if a.ndim == 2:
            return "weight", a.T
        if a.ndim == 4:
            return "weight", a.transpose(3, 2, 0, 1)
    elif name == "scale":
        return "weight", a
    elif name in _PLAIN_LEAVES:
        return name, a
    raise KeyError(f"flax leaf {collection}/{'/'.join(path)} "
                   f"{a.shape} has no place in the port")


def _module_paths(path: Tuple[str, ...], a: np.ndarray, nl: int):
    """Yield (port module path, slice of a) — several for stacked trees."""
    p = list(path[:-1])
    for i, part in enumerate(p[:-1]):
        if re.fullmatch(r"stage\d+_pairs", part):
            stage = part[: -len("_pairs")]
            b = int(re.fullmatch(r"block(\d)", p[i + 1]).group(1))
            for g in range(a.shape[0]):
                yield p[:i] + [f"{stage}_block{2 * g + b}"] + p[i + 2:], a[g]
            return
        m = re.fullmatch(r"lvl(\d+)_(\w+)", p[i + 1])
        if part == "layers" and m:
            lvl, sub = int(m.group(1)), m.group(2)
            sub = "self_attn" if sub == "self" else sub
            for g in range(a.shape[0]):
                yield p[:i] + [f"layer{nl * g + lvl}", sub] + p[i + 2:], a[g]
            return
        m = re.fullmatch(r"layer(\d+)_(\w+)", part)
        if m:
            sub = "self_attn" if m.group(2) == "self" else m.group(2)
            yield p[:i] + [f"layer{m.group(1)}", sub] + p[i + 1:], a
            return
    yield p, a


def from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` (numpy leaves) -> state_dict."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections {sorted(unknown)}")
    lvls = {m.group(1) for path, _ in _flatten(variables["params"])
            for a, b in zip(path, path[1:]) if a == "layers"
            for m in [re.fullmatch(r"lvl(\d+)_\w+", b)] if m}
    nl = len(lvls) or 1
    out: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(coll, {})):
            a = np.asarray(leaf)
            for mod, sl in _module_paths(path, a, nl):
                name, conv = _leaf(path, np.asarray(sl), coll)
                key = ".".join(mod + [name])
                if key in out:
                    raise KeyError(f"two flax leaves map to {key}")
                out[key] = _tensor(conv)
    return out


def load_flax(model: torch.nn.Module, variables: Dict) -> torch.nn.Module:
    """Load flax variables into ``model``; every leaf must be consumed and
    every port parameter and buffer set."""
    sd = from_flax(variables)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"weight bridge mismatch: port keys not set "
                       f"{missing}; flax leaves left over {extra}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(v.shape)} vs port "
                             f"{tuple(own[k].shape)}")
    model.load_state_dict(sd, strict=True)
    return model
