"""Swin-Transformer BEV backbone (NHWC in, 4-level NHWC pyramid out).

Port of ``mask_bev_tpu/models/swin.py``: patch embed with mmdet's 'corner'
padding, stages of (shifted-)window blocks (``ops/swin_block.py``, kernel
3, for every stage), patch merging with the concat order ``[x0, x1, x2,
x3]``, and per-stage output LayerNorms. Every block is a module
``stage{i}_block{d}``; the JAX package's ``nn.scan``-stacked
``stage{i}_pairs`` trees are split into those blocks by the weight bridge
(``models/convert.py``).

Training (``forward(x, train=True)``) runs the blocks as the JAX package
trains them, the XLA form (``mask_bev_tpu/models/swin.py:222`` and :512 take
the fused kernels only when not training): plain torch on the live
parameters, so gradients reach them, never int8 (JAX :300), exact erf GELU,
drop path with per-block rates linear over depth (JAX :286-297, :575-577;
one per-sample mask for each residual branch, drawn from the caller's
generator before the block runs) and, with ``remat``, each block
recomputed in the backward pass by ``torch.utils.checkpoint`` (JAX
:662-665, :701-704).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from mask_bev_tpu_torch.ops.swin_block import (
    BlockWeights, Dense, dense, effective_shift, int8_sim_dense, layer_norm,
    make_dense, rel_bias_from_table, swin_block, window_msa_plain)

__all__ = ["LayerNorm", "SwinBlock", "PatchMerging", "SwinTransformer",
           "int8_sim_dense", "linear", "forget_packed"]


class LayerNorm(nn.Module):
    """flax LayerNorm semantics: f32 statistics, eps 1e-6, input dtype out."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``x @ kernel + bias`` in the operand dtype, in flax/XLA order (the
    product rounds to the dtype before the bias is added)."""
    y = x @ lin.weight.t()
    return y if lin.bias is None else y + lin.bias


def forget_packed(module, incompatible_keys=None):
    """Load-state-dict hook: new weights were loaded, so drop the module's
    kernel-ready copy of them (rebuilt at the next forward)."""
    module._packed = None


class WindowMSA(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))


class ShiftWindowMSA(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.w_msa = WindowMSA(dim, num_heads, window)


class SwinBlock(nn.Module):
    """LN -> (S)W-MSA -> residual -> LN -> MLP -> residual, on (B, H*W, C)."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: bool,
                 mlp_ratio: int = 4, quantize: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.shift = shift
        self.quantize = quantize
        self.norm1 = LayerNorm(dim)
        self.attn = ShiftWindowMSA(dim, num_heads, window)
        self.norm2 = LayerNorm(dim)
        self.ffn_1 = nn.Linear(dim, dim * mlp_ratio)
        self.ffn_2 = nn.Linear(dim * mlp_ratio, dim)
        self._packed = None
        self.register_load_state_dict_post_hook(forget_packed)

    def _apply(self, fn, *args, **kwargs):
        self._packed = None
        return super()._apply(fn, *args, **kwargs)

    def weights(self) -> BlockWeights:
        """Kernel-ready weights (transposed, f32 biases, int8 when
        quantised, gathered relative-position bias), built once."""
        if self._packed is None:
            msa = self.attn.w_msa
            q = self.quantize
            with torch.no_grad():
                self._packed = BlockWeights(
                    self.norm1.weight.detach(), self.norm1.bias.detach(),
                    make_dense(msa.qkv.weight, msa.qkv.bias, q),
                    make_dense(msa.proj.weight, msa.proj.bias, q),
                    self.norm2.weight.detach(), self.norm2.bias.detach(),
                    make_dense(self.ffn_1.weight, self.ffn_1.bias, q),
                    make_dense(self.ffn_2.weight, self.ffn_2.bias, q),
                    rel_bias_from_table(msa.rel_pos_bias_table.detach(),
                                        self.window))
        return self._packed

    def live_weights(self) -> BlockWeights:
        """The block's parameters as they are, in their dtype, not detached
        (the training form differentiates through them)."""
        msa = self.attn.w_msa
        return BlockWeights(
            self.norm1.weight, self.norm1.bias,
            Dense(msa.qkv.weight, msa.qkv.bias),
            Dense(msa.proj.weight, msa.proj.bias),
            self.norm2.weight, self.norm2.bias,
            Dense(self.ffn_1.weight, self.ffn_1.bias),
            Dense(self.ffn_2.weight, self.ffn_2.bias),
            rel_bias_from_table(msa.rel_pos_bias_table, self.window))

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                train: bool = False, drop=None) -> torch.Tensor:
        """``drop`` (training): the two residual branches' per-sample drop
        path factors, each (B, 1, 1) f32 ``mask / keep``, or None."""
        shift = effective_shift(hw, self.window, self.shift)
        if not train:
            return swin_block(x, self.weights(), hw, self.window,
                              self.num_heads, shift, self.quantize)
        p = self.live_weights()
        y = window_msa_plain(layer_norm(x, p.ln1_w, p.ln1_b), p, hw,
                             self.window, self.num_heads, shift, False)
        x = x + (y if drop is None else y * drop[0].to(y.dtype))
        y = layer_norm(x, p.ln2_w, p.ln2_b)
        y = dense(F.gelu(dense(y, p.fc1, False), approximate="none"), p.fc2,
                  False)
        return x + (y if drop is None else y * drop[1].to(y.dtype))


class PatchMerging(nn.Module):
    """2x2 patch concat -> LN -> Linear(4C -> 2C, no bias)."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False)

    def forward(self, x, hw):
        h, w = hw
        b, _, c = x.shape
        hp, wp = (h + 1) // 2 * 2, (w + 1) // 2 * 2
        x = F.pad(x.reshape(b, h, w, c), (0, 0, 0, wp - w, 0, hp - h))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        x = x.reshape(b, (hp // 2) * (wp // 2), 4 * c)
        return linear(self.norm(x), self.reduction), (hp // 2, wp // 2)


class SwinTransformer(nn.Module):
    """BEV pseudo-image (B, H, W, C) -> 4-scale pyramid [(B, Hi, Wi, Ci)]."""

    def __init__(self, in_channels: int, embed_dim: int = 192,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window: int = 10, patch_size: int = 4,
                 patch_stride: int = None, mlp_ratio: int = 4,
                 quantize_int8: bool = False, drop_path_rate: float = 0.0,
                 remat: bool = False):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.remat = remat
        self.patch_size = patch_size
        self.stride = patch_stride or patch_size
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.patch_embed = nn.Conv2d(in_channels, embed_dim, patch_size,
                                     stride=self.stride)
        self.patch_norm = LayerNorm(embed_dim)
        dim = embed_dim
        for i, depth in enumerate(self.depths):
            for d in range(depth):
                self.add_module(f"stage{i}_block{d}", SwinBlock(
                    dim, num_heads[i], window, shift=(d % 2 == 1),
                    mlp_ratio=mlp_ratio, quantize=quantize_int8))
            self.add_module(f"out_norm{i}", LayerNorm(dim))
            if i < len(self.depths) - 1:
                self.add_module(f"merge{i}", PatchMerging(dim, 2 * dim))
                dim *= 2

    def drop_factors(self, batch: int, device, generator=None):
        """Per block, the training drop path factors of its two residual
        branches (None where the block's rate is 0): rates linear over depth
        up to ``drop_path_rate``, per-sample Bernoulli keep masks / keep."""
        total = sum(self.depths)
        out = []
        for i in range(total):
            rate = self.drop_path_rate * i / max(total - 1, 1)
            if rate <= 0.0:
                out.append(None)
                continue
            keep = 1.0 - rate
            u = torch.rand((2, batch, 1, 1), generator=generator,
                           device=device)
            out.append((u < keep).float() / keep)
        return out

    def forward(self, x: torch.Tensor, train: bool = False,
                generator=None) -> List[torch.Tensor]:
        b, h, w, _ = x.shape
        drops = (self.drop_factors(b, x.device, generator) if train
                 else [None] * sum(self.depths))
        p, s = self.patch_size, self.stride
        gh, gw = -(-h // s), -(-w // s)
        pad_h = max((gh - 1) * s + p - h, 0)
        pad_w = max((gw - 1) * s + p - w, 0)
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h)).permute(0, 3, 1, 2)
        x = self.patch_embed(x).permute(0, 2, 3, 1)
        x = self.patch_norm(x.reshape(b, gh * gw, self.embed_dim))
        hw = (gh, gw)
        outs = []
        bi = 0
        for i, depth in enumerate(self.depths):
            for d in range(depth):
                blk = getattr(self, f"stage{i}_block{d}")
                if train and self.remat:
                    x = torch.utils.checkpoint.checkpoint(
                        blk, x, hw, True, drops[bi], use_reentrant=False)
                else:
                    x = blk(x, hw, train, drops[bi])
                bi += 1
            y = getattr(self, f"out_norm{i}")(x)
            outs.append(y.reshape(b, hw[0], hw[1], -1))
            if i < len(self.depths) - 1:
                x, hw = getattr(self, f"merge{i}")(x, hw)
        return outs
