"""Mask2Former query decoder: the ``final_only`` inference path and the
per-layer training path.

Port of ``mask_bev_tpu/models/mask2former.py``. ``final_only`` (:321-425)
runs the fused stack: the initial mask embedding and the per-level
bilinear downsampling of ``mask_features`` (``antialias=False``, i.e.
``F.interpolate(bilinear, align_corners=False)``) run here; every decoder
layer runs in ``ops/decoder_stack.py`` (kernel 4); the final head pass
(decoder norm, ``cls_embed``, mask MLP and the full-resolution
``bqc,bhwc`` einsum) runs here in plain torch, as XLA runs it in JAX.

``final_only=False`` (training, :463-489) is plain torch on the live
parameters, as XLA runs it: the shared heads (``_heads_apply`` :122) run
once on the learned queries and once after each layer; each layer's
masked cross-attention bias comes from the previous head pass's
full-resolution mask logits (``_make_attn_bias`` :203-211,
``_bias_from_logits`` :189-200: bilinear resize with ``align_corners=False``
and no antialias, blocked where sigmoid < 0.5, fully blocked rows cleared,
detached); layer ``i`` reads memory level ``i % 3``; the L+1 head passes
stack along a leading axis.

Layer ``i`` is module ``layer{i}`` (``cross``, ``self_attn``, ``norm1..3``,
``ffn``); the weight bridge maps the JAX scan layout ``layers/lvl{l}_*``
(layer ``3g + l`` is slice ``g``) onto it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mask_bev_tpu_torch.models.positional import sine_positional_encoding_2d
from mask_bev_tpu_torch.models.swin import LayerNorm, forget_packed, linear
from mask_bev_tpu_torch.ops.decoder_stack import (
    NEG, HeadWeights, LayerWeights, decoder_stack, kv_weights, pack_weights)


class DecoderOutputs(NamedTuple):
    """Stacked head passes: L+1 on the training path, 1 on the
    ``final_only`` path."""

    cls_logits: torch.Tensor  # (L+1 | 1, B, Q, num_classes + 1)
    mask_logits: torch.Tensor  # (L+1 | 1, B, Q, H/4, W/4)
    height_logits: Optional[torch.Tensor]


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q, k, v, attn_bias=None):
        """XLA order: projections in the model dtype, scores and the
        weighted sum accumulated in f32, probabilities rounded to the
        dtype; ``attn_bias`` (B, Q, K) f32."""
        b, nq, c = q.shape
        h = self.num_heads
        hd = c // h
        qp = linear(q, self.q).reshape(b, nq, h, hd)
        kp = linear(k, self.k).reshape(b, k.shape[1], h, hd)
        vp = linear(v, self.v).reshape(b, v.shape[1], h, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", (qp * hd ** -0.5).float(),
                            kp.float())
        if attn_bias is not None:
            attn = attn + attn_bias[:, None]
        attn = torch.softmax(attn, dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.float(),
                           vp.float()).to(q.dtype)
        return linear(out.reshape(b, nq, c), self.out)


class FFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class DecoderLayer(nn.Module):
    def __init__(self, dim: int, ffn_dim: int, num_heads: int = 8):
        super().__init__()
        self.cross = MultiHeadAttention(dim, num_heads)
        self.self_attn = MultiHeadAttention(dim, num_heads)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)
        self.ffn = FFN(dim, ffn_dim)

    def forward(self, out, qpos, mem, pe, bias):
        """Training form: masked cross-attention, self-attention, FFN, each
        with a post-norm residual."""
        y = self.cross(out + qpos, mem + pe, mem, attn_bias=bias)
        out = self.norm1(out + y)
        y = self.self_attn(out + qpos, out + qpos, out)
        out = self.norm2(out + y)
        y = linear(torch.relu(linear(out, self.ffn.fc1)), self.ffn.fc2)
        return self.norm3(out + y)

    def weights(self) -> LayerWeights:
        def w(lin):  # (in, out) in the parameters' dtype
            return lin.weight.detach().t().contiguous()

        def f(t):
            return t.detach().float().contiguous()

        c, s = self.cross, self.self_attn
        return LayerWeights(
            w(c.q), f(c.q.bias), w(c.k), f(c.k.bias), w(c.v), f(c.v.bias),
            w(c.out), f(c.out.bias), w(s.q), f(s.q.bias), w(s.k),
            f(s.k.bias), w(s.v), f(s.v.bias), w(s.out), f(s.out.bias),
            f(self.norm1.weight), f(self.norm1.bias), f(self.norm2.weight),
            f(self.norm2.bias), f(self.norm3.weight), f(self.norm3.bias),
            w(self.ffn.fc1), f(self.ffn.fc1.bias), w(self.ffn.fc2),
            f(self.ffn.fc2.bias))


class MaskHeads(nn.Module):
    def __init__(self, num_classes: int, feat_channels: int,
                 out_channels: int):
        super().__init__()
        c = feat_channels
        self.decoder_norm = LayerNorm(c)
        self.cls_embed = nn.Linear(c, num_classes + 1)
        self.mask_mlp1 = nn.Linear(c, c)
        self.mask_mlp2 = nn.Linear(c, c)
        self.mask_mlp3 = nn.Linear(c, out_channels)

    def mask_embed(self, query):
        """``_mask_embed``: (normed query, mask embedding) in XLA order."""
        x = self.decoder_norm(query)
        y = torch.relu(linear(x, self.mask_mlp1))
        y = torch.relu(linear(y, self.mask_mlp2))
        return x, linear(y, self.mask_mlp3)

    def forward(self, query, mask_features):
        """``_heads_apply``: class logits and full-resolution mask logits."""
        x, emb = self.mask_embed(query)
        cls_logits = linear(x, self.cls_embed)
        mask_logits = torch.einsum("bqc,bhwc->bqhw", emb.float(),
                                   mask_features.float()).to(query.dtype)
        return cls_logits, mask_logits

    def weights(self) -> HeadWeights:
        def w(lin):
            return lin.weight.detach().t().contiguous()

        def f(t):
            return t.detach().float().contiguous()

        return HeadWeights(
            f(self.decoder_norm.weight), f(self.decoder_norm.bias),
            w(self.mask_mlp1), f(self.mask_mlp1.bias), w(self.mask_mlp2),
            f(self.mask_mlp2.bias), w(self.mask_mlp3),
            f(self.mask_mlp3.bias))


def make_attn_bias(mask_logits: torch.Tensor, target_hw) -> torch.Tensor:
    """(B, Q, H, W) mask logits -> detached additive bias (B, Q, hl*wl) f32:
    -1e9 where sigmoid of the resized logit is < 0.5, except on rows that
    would block every position."""
    b, q = mask_logits.shape[:2]
    with torch.no_grad():
        m = F.interpolate(mask_logits, size=tuple(target_hw), mode="bilinear",
                          align_corners=False, antialias=False)
        blocked = (torch.sigmoid(m) < 0.5).reshape(b, q, -1)
        blocked = blocked & ~blocked.all(dim=-1, keepdim=True)
        return torch.where(blocked, NEG, 0.0).float()


class Mask2FormerDecoder(nn.Module):
    """Queries x 3-level memories -> final (cls, mask) logits."""

    def __init__(self, num_queries: int = 45, num_classes: int = 1,
                 num_layers: int = 9, feat_channels: int = 256,
                 out_channels: int = 256, num_heads: int = 8,
                 ffn_dim: int = 2048, num_levels: int = 3):
        super().__init__()
        c = feat_channels
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.query_feat = nn.Parameter(torch.zeros(num_queries, c))
        self.query_embed = nn.Parameter(torch.zeros(num_queries, c))
        self.level_embed = nn.Parameter(torch.zeros(num_levels, c))
        self.heads = MaskHeads(num_classes, c, out_channels)
        for i in range(num_layers):
            self.add_module(f"layer{i}", DecoderLayer(c, ffn_dim, num_heads))
        self._packed = None
        self.register_load_state_dict_post_hook(forget_packed)

    def _apply(self, fn, *args, **kwargs):
        self._packed = None
        return super()._apply(fn, *args, **kwargs)

    def stack_weights(self):
        layers = [getattr(self, f"layer{i}").weights()
                  for i in range(self.num_layers)]
        return layers, self.heads.weights()

    def flat_memories(self, memories: Sequence[torch.Tensor]):
        """Per level: the (B, T_l, C) memory plus its level embedding, the
        sine PE (T_l, C) in the memory dtype, and (h_l, w_l)."""
        c = self.query_feat.shape[1]
        mems, pes, hws = [], [], []
        for i, mem in enumerate(memories):
            b, hl, wl, mc = mem.shape
            hws.append((hl, wl))
            mems.append((mem.reshape(b, hl * wl, mc)
                         + self.level_embed[i]).contiguous())
            pes.append(sine_positional_encoding_2d(
                hl, wl, num_feats=c // 2, device=mem.device).to(mem.dtype))
        return mems, pes, hws

    def stack_inputs(self, mask_features: torch.Tensor,
                     memories: Sequence[torch.Tensor]):
        """The decoder stack's data inputs: (queries (B, Q, C), initial mask
        embedding, query positions, flat memories with their level embedding,
        sine PEs (T_l, C), f32 resized mask features (B, T_l, C))."""
        b = mask_features.shape[0]
        mems, pes, hws = self.flat_memories(memories)
        f32feat = mask_features.float().permute(0, 3, 1, 2)
        feats = []
        for hl, wl in hws:
            fr = F.interpolate(f32feat, size=(hl, wl), mode="bilinear",
                               align_corners=False, antialias=False)
            feats.append(fr.permute(0, 2, 3, 1).reshape(b, hl * wl, -1))
        out = self.query_feat[None].expand(b, -1, -1).contiguous()
        _, emb0 = self.heads.mask_embed(out)
        return out, emb0, self.query_embed, mems, pes, feats

    def forward(self, mask_features: torch.Tensor,
                memories: Sequence[torch.Tensor], final_only: bool = True
                ) -> DecoderOutputs:
        if not final_only:
            return self.forward_layers(mask_features, memories)
        layers, head, packed = self.kernel_inputs(mask_features.is_cuda,
                                                  len(memories))
        out_f = decoder_stack(*self.stack_inputs(mask_features, memories),
                              layers, head, num_heads=self.num_heads,
                              packed=packed)
        cls_f, mask_f = self.heads(out_f, mask_features)
        return DecoderOutputs(cls_f[None], mask_f[None], None)

    def forward_layers(self, mask_features: torch.Tensor,
                       memories: Sequence[torch.Tensor]) -> DecoderOutputs:
        """All L+1 head passes (training path)."""
        b = mask_features.shape[0]
        nl = len(memories)
        mems, pes, hws = self.flat_memories(memories)
        out = self.query_feat[None].expand(b, -1, -1)
        qpos = self.query_embed[None]
        cls_l, mask_l = self.heads(out, mask_features)
        cls_all, mask_all = [cls_l], [mask_l]
        for i in range(self.num_layers):
            lvl = i % nl
            bias = make_attn_bias(mask_l, hws[lvl])
            out = getattr(self, f"layer{i}")(out, qpos, mems[lvl], pes[lvl],
                                             bias)
            cls_l, mask_l = self.heads(out, mask_features)
            cls_all.append(cls_l)
            mask_all.append(mask_l)
        return DecoderOutputs(torch.stack(cls_all), torch.stack(mask_all),
                              None)

    def kernel_inputs(self, cuda: bool, num_levels: int):
        """(layers, head, packed) for ``decoder_stack``; on CUDA built once
        (with the packed kernel weights) and kept."""
        if not cuda:
            return (*self.stack_weights(), None)
        if self._packed is None:
            layers, head = self.stack_weights()
            self._packed = (layers, head, (pack_weights(layers, head),
                                           kv_weights(layers, num_levels)))
        return self._packed
