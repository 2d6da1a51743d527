"""Weight bridges: the JAX package's flax variables, and the upstream
reference's torch checkpoints, -> this port's state_dict.

``from_flax`` takes ``{"params": ..., "batch_stats": ...}`` as nested dicts
of numpy arrays (``jax.device_get`` of the flax variables) and returns a
state_dict for :class:`mask_bev_tpu_torch.models.maskbev.MaskBev`:

* Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in);
* Conv ``kernel`` HWIO -> ``weight`` OIHW;
* LayerNorm / GroupNorm / batch-norm / pseudo-image-norm ``scale`` ->
  ``weight`` (the pseudo-image norm keeps its (H, W, C) shape);
* ``MaskedBatchNorm`` ``batch_stats`` ``mean``/``var`` -> ``running_mean``/
  ``running_var``;
* the modules MaskBev does not call: FKAConv's ``alpha``, ``beta``,
  ``bn{i}_scale``/``bn{i}_bias`` (-> ``bn{i}.weight``/``bias``) and its
  ``norm_radius`` batch statistic (``models/fkaconv.py``); DynamicEdgeConv's
  Dense layers (``models/dgcnn.py``);
* the ``nn.scan``-stacked ``backbone/stage{i}_pairs/block{b}`` trees are
  split along axis 0: slice ``g`` is block ``2g + b``;
* the decoder's ``layers/lvl{l}_*`` trees: slice ``g`` is layer
  ``3g + l`` (``self`` becomes ``self_attn``).

A leaf the port has no place for raises; :func:`load_flax` also raises on
any port parameter that the variables leave unset.

:func:`from_reference_swin` and :func:`from_reference_maskbev` are the
counterparts of the JAX package's ``convert_torch_swin`` (``mask_bev_tpu/
models/convert.py:54``) and ``convert_torch_maskbev`` (:206): an upstream
Swin checkpoint (mmdet ``stages.*`` or the original ``layers.*`` names)
or a whole upstream ``MaskBevModule`` checkpoint, mapped key by key onto
the port's state_dict, the same keys as the JAX converter writes (the
height head included). Relative-position bias tables of another window
and an absolute embedding of another grid are resized bicubically
(``ops/resize.py``); mmdet's patch-merging channels are permuted to this
package's order. The reference's deformable-attention pixel decoder has no
counterpart here, so the pixel decoder keeps the model's own weights, as
the JAX converter keeps its initialisation.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from mask_bev_tpu_torch.ops.resize import resize_bicubic

_PLAIN_LEAVES = {"bias", "query_feat", "query_embed", "level_embed",
                 "rel_pos_bias_table", "absolute_pos_embed", "alpha", "beta"}


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
        if name == "norm_radius":
            return name, a
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


def _split_affine(path: Tuple[str, ...]) -> Tuple[str, ...]:
    """FKAConv's instance-norm leaves ``bn1_scale``/``bn1_bias`` -> the
    ``bn1`` module's ``scale``/``bias``."""
    m = re.fullmatch(r"(bn\d+)_(scale|bias)", path[-1])
    return path[:-1] + (m.group(1), m.group(2)) if m else path


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
            path = _split_affine(path)
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


def _f32(v) -> np.ndarray:
    """A checkpoint value (tensor or array) as a float32 numpy array."""
    if torch.is_tensor(v):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def _resized(value: np.ndarray, shape) -> np.ndarray:
    return resize_bicubic(torch.from_numpy(np.ascontiguousarray(value)),
                          shape).numpy()


def _merge_perm(four_c: int) -> np.ndarray:
    """mmdet's patch merging (``nn.Unfold``) orders its 4C channels
    channel-major over the positions (0,0),(0,1),(1,0),(1,1); this package
    concatenates position-major [x(0,0), x(1,0), x(0,1), x(1,1)]: the
    mmdet index of each of ours."""
    c = four_c // 4
    ours = [(0, 0), (1, 0), (0, 1), (1, 1)]
    mmdet = [(0, 0), (0, 1), (1, 0), (1, 1)]
    return np.array([(j % c) * 4 + mmdet.index(ours[j // c])
                     for j in range(four_c)], np.int64)


class _Writer:
    """The port state_dict being written: each value is shape-checked
    against the model's own and stored as float32."""

    def __init__(self, model: torch.nn.Module):
        self.own = model.state_dict()
        self.out = {k: v.clone() for k, v in self.own.items()}

    def has(self, key: str) -> bool:
        return key in self.own

    def put(self, key: str, value: np.ndarray) -> None:
        if key not in self.own:
            raise KeyError(f"the port has no {key}")
        want = tuple(self.own[key].shape)
        if tuple(value.shape) != want:
            raise ValueError(f"{key}: checkpoint shape {tuple(value.shape)} "
                             f"vs port {want}")
        self.out[key] = torch.from_numpy(np.array(value, np.float32))


_SWIN_BLOCK = {
    "norm1.weight": "norm1.weight", "norm1.bias": "norm1.bias",
    "norm2.weight": "norm2.weight", "norm2.bias": "norm2.bias",
    "attn.qkv.weight": "attn.w_msa.qkv.weight",
    "attn.qkv.bias": "attn.w_msa.qkv.bias",
    "attn.proj.weight": "attn.w_msa.proj.weight",
    "attn.proj.bias": "attn.w_msa.proj.bias",
    "ffn.layers.0.0.weight": "ffn_1.weight", "mlp.fc1.weight": "ffn_1.weight",
    "ffn.layers.0.0.bias": "ffn_1.bias", "mlp.fc1.bias": "ffn_1.bias",
    "ffn.layers.1.weight": "ffn_2.weight", "mlp.fc2.weight": "ffn_2.weight",
    "ffn.layers.1.bias": "ffn_2.bias", "mlp.fc2.bias": "ffn_2.bias",
}


def _write_swin(state_dict: Dict, w: _Writer) -> None:
    is_mmdet = any(("w_msa" in k)
                   or k.split("backbone.")[-1].startswith("stages.")
                   for k in state_dict)

    def norm(k: str) -> str:
        k = k.replace("backbone.", "")
        # the original release's 'layers.N' -> 'stages.N', anchored so that
        # mmdet's 'ffn.layers.0.0.weight' keys stay as they are
        k = re.sub(r"^layers\.", "stages.", k)
        return k.replace("attn.w_msa.", "attn.")

    for key, v in ((norm(k), _f32(v)) for k, v in state_dict.items()):
        if key in ("patch_embed.projection.weight", "patch_embed.proj.weight"):
            w.put("patch_embed.weight", v)
        elif key in ("patch_embed.projection.bias", "patch_embed.proj.bias"):
            w.put("patch_embed.bias", v)
        elif key == "patch_embed.norm.weight":
            w.put("patch_norm.weight", v)
        elif key == "patch_embed.norm.bias":
            w.put("patch_norm.bias", v)
        elif key == "absolute_pos_embed":
            want = tuple(w.own[key].shape)
            if v.shape != want:
                if v.ndim == 3 and v.shape[0] == 1:  # torch's (1, L, C)
                    src = int(round(np.sqrt(v.shape[1])))
                    v = v.reshape(src, src, v.shape[2])
                v = _resized(v, want)
            w.put(key, v)
        elif m := re.match(r"stages\.(\d+)\.blocks\.(\d+)\.(.+)", key):
            blk = f"stage{m.group(1)}_block{m.group(2)}."
            rest = m.group(3)
            if not w.has(blk + "norm1.weight"):
                continue  # a block the model does not have
            if rest == "attn.relative_position_bias_table":
                dst = blk + "attn.w_msa.rel_pos_bias_table"
                want = tuple(w.own[dst].shape)
                if v.shape != want:
                    src = int(round(np.sqrt(v.shape[0])))
                    side = int(round(np.sqrt(want[0])))
                    v = _resized(v.reshape(src, src, v.shape[1]),
                                 (side, side, v.shape[1])).reshape(want)
                w.put(dst, v)
            elif rest in _SWIN_BLOCK:
                w.put(blk + _SWIN_BLOCK[rest], v)
        elif m := re.match(r"stages\.(\d+)\.downsample\.(.+)", key):
            mg, rest = f"merge{m.group(1)}.", m.group(2)
            if not w.has(mg + "reduction.weight"):
                continue
            if rest in ("norm.weight", "norm.bias"):
                w.put(mg + rest, v[_merge_perm(v.shape[0])] if is_mmdet
                      else v)
            elif rest == "reduction.weight":
                w.put(mg + rest, v[:, _merge_perm(v.shape[1])] if is_mmdet
                      else v)
        elif m := re.match(r"norm(\d+)\.(weight|bias)", key):
            name = f"out_norm{m.group(1)}.{m.group(2)}"
            if w.has(name):
                w.put(name, v)


def from_reference_swin(state_dict: Dict, model: torch.nn.Module
                        ) -> Dict[str, torch.Tensor]:
    """An upstream Swin checkpoint -> the state_dict of ``model`` (the
    port's ``SwinTransformer``): every key the checkpoint maps to, float32;
    the rest keep the model's values."""
    w = _Writer(model)
    _write_swin(state_dict, w)
    return w.out


def from_reference_maskbev(state_dict: Dict, model: torch.nn.Module
                           ) -> Dict[str, torch.Tensor]:
    """An upstream ``MaskBevModule`` checkpoint -> the state_dict of
    ``model`` (the port's ``MaskBev``): the PFN layers and their batch
    norms, the pseudo-image LayerNorm ((C, H, W) -> (H, W, C)), the Swin
    backbone (:func:`from_reference_swin`), the decoder's queries, layers
    (packed ``in_proj`` split into q, k, v) and heads, ``height_embed``
    where the model predicts heights; float32. The pixel decoder keeps the
    model's values."""
    sd = {k: _f32(v) for k, v in state_dict.items()}
    w = _Writer(model)
    for key, v in sd.items():
        if m := re.match(r"_encoder\._voxel_encoder\.pfn_layers\.(\d+)\."
                         r"(linear\.weight|norm\.(weight|bias|running_mean|"
                         r"running_var))$", key):
            w.put(f"encoder.pillar_feature_net.pfn_{m.group(1)}."
                  f"{m.group(2)}", v)
        elif key in ("_encoder._layer_norm.weight",
                     "_encoder._layer_norm.bias"):
            w.put("encoder.norm." + key.rsplit(".", 1)[1],
                  v.transpose(1, 2, 0))
    bb = "_backbone._backbone."
    swin = {k[len(bb):]: v for k, v in sd.items() if k.startswith(bb)}
    if swin:
        wb = _Writer(model.backbone)
        _write_swin(swin, wb)
        w.out.update({"backbone." + k: t for k, t in wb.out.items()})

    hp = "_panoptic_head._panoptic_head."
    heads = {"transformer_decoder.post_norm.weight": "decoder_norm.weight",
             "transformer_decoder.post_norm.bias": "decoder_norm.bias",
             "cls_embed.weight": "cls_embed.weight",
             "cls_embed.bias": "cls_embed.bias"}
    for j, name in ((0, "mask_mlp1"), (2, "mask_mlp2"), (4, "mask_mlp3")):
        for wb_ in ("weight", "bias"):
            heads[f"mask_embed.{j}.{wb_}"] = f"{name}.{wb_}"
    for key, v in sd.items():
        if not key.startswith(hp):
            continue
        k = key[len(hp):]
        if k in ("query_feat.weight", "query_embed.weight",
                 "level_embed.weight"):
            w.put("decoder." + k.split(".")[0], v)
        elif k in heads:
            w.put("decoder.heads." + heads[k], v)
        elif k in ("height_embed.weight", "height_embed.bias"):
            if w.has("decoder.heads." + k):
                w.put("decoder.heads." + k, v)
        elif m := re.match(r"transformer_decoder\.layers\.(\d+)\.(.+)", k):
            layer, rest = f"decoder.layer{m.group(1)}.", m.group(2)
            for kind, ours in (("cross_attn", "cross"),
                               ("self_attn", "self_attn")):
                if rest in (f"{kind}.attn.in_proj_weight",
                            f"{kind}.attn.in_proj_bias"):
                    c = v.shape[0] // 3
                    leaf = "weight" if rest.endswith("weight") else "bias"
                    for j, nm in enumerate("qkv"):
                        w.put(f"{layer}{ours}.{nm}.{leaf}",
                              v[j * c:(j + 1) * c])
                elif rest in (f"{kind}.attn.out_proj.weight",
                              f"{kind}.attn.out_proj.bias"):
                    w.put(f"{layer}{ours}.out.{rest.rsplit('.', 1)[1]}", v)
            # norms.0 after cross-attention, .1 after self-attention, .2
            # after the FFN
            if m2 := re.match(r"norms\.(\d)\.(weight|bias)$", rest):
                w.put(f"{layer}norm{int(m2.group(1)) + 1}.{m2.group(2)}", v)
            elif m2 := re.match(r"ffn\.layers\.(0\.0|1)\.(weight|bias)$",
                                rest):
                fc = "fc1" if m2.group(1) == "0.0" else "fc2"
                w.put(f"{layer}ffn.{fc}.{m2.group(2)}", v)
    return w.out
