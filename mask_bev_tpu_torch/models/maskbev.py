"""Full MaskBEV model, inference form: raw padded scans -> final logits.

Port of ``mask_bev_tpu/models/maskbev.py:24-117``: encoder -> Swin backbone
-> conv-FPN pixel decoder -> Mask2Former decoder (``final_only``).
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


class MaskBev(nn.Module):
    def __init__(self, cfg: MaskBevConfig):
        super().__init__()
        c = cfg
        strides = tuple(c.backbone_strides)
        if strides[1:] != (2, 2, 2):
            raise ValueError(f"backbone_strides[1:] must be (2, 2, 2), got "
                             f"{strides}")
        if c.backbone_use_abs_emb or c.predict_height:
            raise NotImplementedError(
                "absolute position embedding and height heads are not "
                "ported yet")
        self.encoder = MaskBevEncoder(
            c.x_range, c.y_range, c.z_range, c.voxel_size,
            feat_channels=tuple(c.encoder_feat_channels),
            max_points_per_pillar=c.max_num_points,
            point_dim=c.pc_point_dim,
            pseudo_image_norm=c.pseudo_image_norm,
            encoding_type=c.encoder_encoding_type)
        self.backbone = SwinTransformer(
            c.encoder_feat_channels[-1], embed_dim=c.backbone_embed_dim,
            depths=tuple(c.backbone_depths),
            num_heads=tuple(c.backbone_num_heads),
            window=c.backbone_window_size, patch_size=c.backbone_patch_size,
            patch_stride=strides[0], mlp_ratio=c.backbone_mlp_ratio,
            quantize_int8=(c.backbone_quantize == "int8"))
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
            num_heads=c.head_num_attn_heads, ffn_dim=c.head_ffn_dim)

    def random_state_dict(self, seed: int) -> dict:
        """Random weights from ``seed`` (an explicit CPU generator), at the
        scales a trained model keeps: fan-in-scaled matrices, norm weights
        near 1, small biases, unit-variance queries, batch-norm statistics
        away from the identity."""
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
            elif leaf == "rel_pos_bias_table":
                v = 0.02 * r
            else:  # query_feat, query_embed, level_embed
                v = r
            out[name] = v.to(t.dtype)
        return out

    @torch.no_grad()
    def forward(self, points: torch.Tensor, point_mask: torch.Tensor,
                final_only: bool = True) -> DecoderOutputs:
        x = self.encoder(points, point_mask)
        feats = self.backbone(x)
        mask_features, memories = self.pixel_decoder(feats)
        return self.decoder(mask_features, memories, final_only=final_only)
