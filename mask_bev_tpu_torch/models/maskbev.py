"""Full MaskBEV model: raw padded scans -> stacked (cls, mask) logits.

Port of ``mask_bev_tpu/models/maskbev.py:24-117``: encoder -> Swin backbone
-> conv-FPN pixel decoder -> Mask2Former decoder. ``train=False,
final_only=True`` is the serving path; the config's switches choose its
kernels as they choose the JAX package's (``use_pallas_encoder``: the slot
PFN or the capped-stream PFN; ``use_pallas_backbone``: the whole-block
kernel or the XLA-form blocks, whose attention is the window-MSA kernel
with ``use_pallas_attention``; ``fuse_patch_embed``: the patch-embed
kernel where :meth:`MaskBev.flat_embed_ok`; ``use_pallas_head``: the
decoder-stack kernel, or the per-layer decoder; the canvas kernel
always). Every kernel takes the model's dtype, bf16 or f32. The model
options run as in the JAX package: ``predict_height`` (the height head and
``DecoderOutputs.height_logits``), ``backbone_use_abs_emb`` with
``backbone_swap_dims`` (the absolute position embedding after
``patch_norm``; it keeps kernel 8 off), ``encoder_encoding_type`` fourier
or cosine and more than 4 point columns (the capped stream with the plain
pillar feature net: kernels 1 and 10 take only vanilla points of at most
4 columns) and ``pixel_decoder_num_attn_layers`` (the refinement blocks,
kernel 7 at eval). ``train=True,
final_only=False`` is the training forward (training encoder with kernel A
and its backward B, plain-torch backbone and decoder, all L+1 head passes).
Gradients are tracked as usual: the serving entry point
(``inference.py::MaskBevPredictor.forward``) runs under ``torch.no_grad``.
"""
from __future__ import annotations

import torch
from torch import nn

from mask_bev_tpu_torch.config import MaskBevConfig
from mask_bev_tpu_torch.models.encoder import MaskBevEncoder
from mask_bev_tpu_torch.models.mask2former import (
    DecoderOutputs, Mask2FormerDecoder)
from mask_bev_tpu_torch.models.pixel_decoder import PixelDecoder
from mask_bev_tpu_torch.models.swin import SwinTransformer
from mask_bev_tpu_torch.utils.precision import full_f32, resolve_dtype


class MaskBev(nn.Module):
    def __init__(self, cfg: MaskBevConfig):
        super().__init__()
        c = cfg
        strides = tuple(c.backbone_strides)
        if strides[1:] != (2, 2, 2):
            raise ValueError(f"backbone_strides[1:] must be (2, 2, 2), got "
                             f"{strides}")
        self.encoder = MaskBevEncoder(
            c.x_range, c.y_range, c.z_range, c.voxel_size,
            feat_channels=tuple(c.encoder_feat_channels),
            max_points_per_pillar=c.max_num_points,
            point_dim=c.pc_point_dim,
            pseudo_image_norm=c.pseudo_image_norm,
            encoding_type=c.encoder_encoding_type,
            fourier_enc_group=c.encoder_fourier_enc_group,
            max_pillars=c.max_num_pillars, use_pallas=c.use_pallas_encoder)
        h, w = self.encoder.grid_hw
        grid = (-(-h // strides[0]), -(-w // strides[0]))
        self.backbone = SwinTransformer(
            c.encoder_feat_channels[-1], embed_dim=c.backbone_embed_dim,
            depths=tuple(c.backbone_depths),
            num_heads=tuple(c.backbone_num_heads),
            window=c.backbone_window_size, patch_size=c.backbone_patch_size,
            patch_stride=strides[0], mlp_ratio=c.backbone_mlp_ratio,
            quantize_int8=(c.backbone_quantize == "int8"),
            drop_path_rate=c.backbone_drop_path_rate,
            remat=c.remat_backbone, use_pallas=c.use_pallas_attention,
            use_pallas_block=c.use_pallas_backbone,
            use_abs_pos_embed=c.backbone_use_abs_emb,
            abs_pos_grid=grid,
            swap_dims=c.backbone_swap_dims)
        self.cfg = c
        e = c.backbone_embed_dim
        self.pixel_decoder = PixelDecoder(
            [e, 2 * e, 4 * e, 8 * e], feat_channels=c.head_feat_channels,
            out_channels=c.head_out_channels,
            num_attn_layers=c.pixel_decoder_num_attn_layers)
        self.decoder = Mask2FormerDecoder(
            num_queries=c.num_queries, num_classes=c.head_num_classes,
            num_layers=c.head_num_decoder_layers,
            feat_channels=c.head_feat_channels,
            out_channels=c.head_out_channels,
            num_heads=c.head_num_attn_heads, ffn_dim=c.head_ffn_dim,
            use_kernel=c.use_pallas_head, predict_height=c.predict_height,
            num_height_bins=c.head_num_height_bins)

    def random_state_dict(self, seed: int) -> dict:
        """Random weights from ``seed`` (an explicit CPU generator), at the
        scales a trained model keeps: fan-in-scaled matrices, norm weights
        near 1, small biases, unit-variance queries, batch-norm statistics
        away from the identity, an absolute position embedding at 0.02 (the
        JAX initialiser's ``truncated_normal(0.02)`` scale)."""
        gen = torch.Generator().manual_seed(seed)
        mats = {f"{mn}.weight" for mn, m in self.named_modules()
                if isinstance(m, (nn.Linear, nn.Conv2d))}
        out = {}
        for name, t in self.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            shape = tuple(t.shape)
            r = torch.randn(shape, generator=gen)
            if name.endswith("running_var"):
                v = 0.5 + torch.rand(shape, generator=gen)
            elif name.endswith("running_mean"):
                v = 0.1 * r
            elif name in mats:
                fan_in = t[0].numel()
                v = r / fan_in ** 0.5
            elif leaf == "weight":  # norm scales (pseudo-image norm included)
                v = 1.0 + 0.1 * r
            elif leaf == "bias":
                v = 0.02 * r
            elif leaf in ("rel_pos_bias_table", "absolute_pos_embed"):
                v = 0.02 * r
            else:  # query_feat, query_embed, level_embed
                v = r
            out[name] = v.to(t.dtype)
        return out

    def flat_embed_ok(self, train: bool) -> bool:
        """Kernel 8 for the patch embed: ``_flat_embed_ok`` of the JAX
        package (:86-98) without its TPU check: ``fuse_patch_embed``, eval,
        the encoder's slot path, stride == patch, whole patches, no
        absolute embedding."""
        c = self.cfg
        h, w = self.encoder.grid_hw
        p = c.backbone_patch_size
        return (c.fuse_patch_embed and not train
                and self.encoder.uses_slot_path(train)
                and not c.backbone_use_abs_emb
                and tuple(c.backbone_strides)[0] == p
                and h % p == 0 and w % p == 0)

    def forward(self, points: torch.Tensor, point_mask: torch.Tensor,
                train: bool = False, final_only: bool = True,
                generator=None) -> DecoderOutputs:
        """``train``: training encoder (updates the batch-norm running
        statistics) and backbone (drop path drawn from ``generator``). A
        float32 configuration runs its convolutions and plain matrix
        products in full float32 (:func:`~mask_bev_tpu_torch.utils.
        precision.full_f32`), whatever TF32 flags the caller has set."""
        with full_f32(resolve_dtype(self.cfg.compute_dtype)):
            x = self.encoder(points, point_mask, train=train)
            feats = self.backbone(x, train=train, generator=generator,
                                  fused_embed=self.flat_embed_ok(train))
            mask_features, memories = self.pixel_decoder(feats, train=train)
            return self.decoder(mask_features, memories,
                                final_only=final_only)
