"""Flat experiment configuration (the PyTorch port's own copy).

The port keeps its own copy of the JAX package's configuration so that it
imports nothing of ``mask_bev_tpu``; the fields, defaults, factories and
YAML round-trip are the same, so one YAML file configures both packages.

Mirrors the reference's flat-YAML config surface (reference
``docs/CONFIGURATION.md``; keys splatted as ``**kwargs`` at
``train_mask_bev.py:52-65``) as a typed dataclass. Unknown YAML keys are
accepted and kept in ``extras`` to preserve the reference's permissive
behavior, but everything the model/trainer consumes is typed here.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import yaml


@dataclasses.dataclass
class MaskBevConfig:
    # General
    name: str = "experiment"
    seed: int = 420
    checkpoint: Optional[str] = None  # None | 'last' | path

    # Optimization (reference mask_bev_module.py:132-171)
    lr: float = 1e-4
    weight_decay: float = 1e-4
    optimiser_type: str = "adam_w"  # adam | adam_w | lamb | sgd
    lr_schedulers_type: str = "plateau"  # plateau | cosine | poly | none
    differential_lr: bool = False
    differential_lr_scaling: float = 0.1
    batch_size: int = 4
    test_batch_size: Optional[int] = None
    max_epochs: int = 1000
    early_stop_patience: int = 30
    grad_clip_norm: float = 0.0  # 0 = off (reference does not clip)

    # Geometry (reference mask_bev_module.py:53-64)
    x_range: Tuple[float, float] = (-40.0, 40.0)
    y_range: Tuple[float, float] = (-40.0, 40.0)
    z_range: Tuple[float, float] = (-20.0, 20.0)
    voxel_size: float = 0.16

    # Queries / classes
    num_queries: int = 45
    head_num_classes: int = 1
    predict_height: bool = False

    # Encoder (reference mask_bev_encoders.py:21-92)
    pc_point_dim: int = 4
    max_num_points: int = 32  # per pillar
    max_num_pillars: int = 32768  # pillar cap of the JAX training path
    max_points_per_scan: int = 131072  # point slots per padded scan
    encoder_feat_channels: Tuple[int, ...] = (128, 128, 128)
    encoder_encoding_type: str = "vanilla"  # vanilla | fourier | cosine
    encoder_fourier_enc_group: int = 1

    # Backbone (reference mask_bev_backbone.py:41-64)
    backbone_embed_dim: int = 192
    backbone_depths: Tuple[int, ...] = (2, 2, 6, 2)
    backbone_num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    backbone_window_size: int = 10
    backbone_patch_size: int = 4
    backbone_strides: Tuple[int, ...] = (4, 2, 2, 2)
    backbone_use_abs_emb: bool = False
    backbone_swap_dims: bool = False
    backbone_drop_path_rate: float = 0.0
    backbone_mlp_ratio: int = 4
    backbone_frozen_stages: int = -1  # freeze patch embed + stages <= this

    # Head (reference mask_bev_panoptic_head.py:98-215)
    head_feat_channels: int = 256
    head_out_channels: int = 256
    head_num_decoder_layers: int = 9
    head_num_attn_heads: int = 8
    head_ffn_dim: int = 2048
    head_reverse_class_weights: bool = False
    head_num_points: int = 12544  # PointRend sampling
    head_oversample_ratio: float = 3.0
    head_importance_sample_ratio: float = 0.75
    # loss point sampling (training): matmul-form
    # bilinear sampling, and the operand dtype of those matmuls ("auto"
    # follows compute_dtype)
    loss_sample_dense: bool = True
    loss_sample_dtype: str = "auto"  # auto | float32 | bfloat16
    # sample GT masks through per-instance square crops of this size
    # (0 = off). EXACT whenever every instance's mask bbox fits the crop
    # (out-of-crop hat mass lands on zeros): 128 px = 20.5 m at 0.16 m
    # resolution, generous for any vehicle footprint. Cuts the dominant
    # (H*W)-proportional GT-sampling matmul FLOPs ~15x on the 500 grid and
    # skips materializing per-query (B, Q, H, W) target masks.
    # FAILURE MODE: an instance bbox LARGER than the crop is silently
    # truncated — its loss targets sample as zeros outside the crop. The
    # knob is in PIXELS: at finer grid resolutions the same value covers
    # less physical extent (128 px is only 10.2 m at 0.08 m/px). Size it as
    # ceil(max_footprint_m / voxel_size) — e.g. 25 m trams at 0.16 m/px
    # need >=157 — or watch the `gt_crop_truncated` train-log counter,
    # which counts affected instances every step (any nonzero = too small).
    loss_gt_crop: int = 128
    head_cls_weight: float = 2.0
    head_mask_weight: float = 5.0
    head_dice_weight: float = 5.0
    head_bg_cls_weight: float = 0.1
    head_height_weight: float = 1.0
    head_num_height_bins: int = 12
    pixel_decoder_num_attn_layers: int = 0  # 0 = pure conv FPN pixel decoder

    # Dataset
    dataset: str = "semantic_kitti"  # semantic_kitti | kitti | waymo
    dataset_root: Optional[str] = None
    num_workers: int = 0  # process-pool sample loading (0 = in-line)
    test_num_workers: Optional[int] = None  # --test override (ref :63)
    shuffle_train: bool = True
    remove_unseen: bool = True
    min_num_points: int = 1
    min_num_inst_pixels: int = 0
    augmentations: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    log_every_n_step: int = 50
    limit_train_batches: Optional[int] = None
    limit_val_batches: Optional[int] = None
    # observability (reference computes per-layer metrics on train AND val
    # and dumps first-batch images every epoch, mask_bev_module.py:223-294)
    compute_train_metrics: bool = True
    log_images: bool = True

    # Precision / performance
    compute_dtype: str = "float32"  # float32 | bfloat16
    # Options of the JAX package's TPU kernels. The port reads the ones that
    # choose a path the JAX package also takes (use_pallas_encoder,
    # use_pallas_attention, use_pallas_backbone, use_pallas_head,
    # fuse_patch_embed, backbone_quantize: 'int8' dynamic int8 quantisation
    # of the backbone's dense products at eval, remat_backbone) and keeps the
    # rest so that one YAML file configures both packages.
    use_pallas_encoder: bool = True
    use_pallas_attention: bool = False
    use_pallas_backbone: bool = True
    backbone_band_layout: str = "wpair"
    use_pallas_head: bool = True
    backbone_quantize: str = "none"
    fuse_patch_embed: bool = False
    backbone_unroll_eval: bool = False
    remat_backbone: bool = False  # training: recompute backbone blocks
    pseudo_image_norm: str = "full"  # 'full' = LayerNorm([C,H,W]) like reference; 'channel' = per-channel

    # Unknown YAML keys land here (reference swallows them via **kwargs)
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # ---- derived geometry ----
    @property
    def num_voxel_x(self) -> int:
        return int(round((self.x_range[1] - self.x_range[0]) / self.voxel_size))

    @property
    def num_voxel_y(self) -> int:
        return int(round((self.y_range[1] - self.y_range[0]) / self.voxel_size))

    @property
    def grid_hw(self) -> Tuple[int, int]:
        """(H, W) of the BEV pseudo-image = (num_voxel_y, num_voxel_x)."""
        return (self.num_voxel_y, self.num_voxel_x)

    @property
    def num_decoder_outputs(self) -> int:
        """Per-layer heads run once before the decoder + once per layer."""
        return self.head_num_decoder_layers + 1

    def replace(self, **kw) -> "MaskBevConfig":
        return dataclasses.replace(self, **kw)

    # ---- YAML round-trip ----
    _KEY_ALIASES = {
        # reference key -> dataclass field
        "optimizer_type": "optimiser_type",
        "lr_scheduler_type": "lr_schedulers_type",
        "head_reverse_class_weight": "head_reverse_class_weights",
        "backbone_path_size": "backbone_patch_size",  # reference typo kept as alias
    }

    @classmethod
    def from_dict(cls, d: Dict[str, Any], name: str = "experiment") -> "MaskBevConfig":
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs: Dict[str, Any] = {"name": name}
        extras: Dict[str, Any] = {}
        for k, v in d.items():
            k = cls._KEY_ALIASES.get(k, k)
            if k in fields and k != "extras":
                ftype = fields[k].type
                if isinstance(v, list) and "Tuple" in str(ftype):
                    v = tuple(v)
                kwargs[k] = v
            else:
                extras[k] = v
        kwargs["extras"] = extras
        return cls(**kwargs)

    @classmethod
    def from_yaml(cls, path: str | pathlib.Path) -> "MaskBevConfig":
        path = pathlib.Path(path)
        with open(path) as f:
            d = yaml.safe_load(f) or {}
        return cls.from_dict(d, name=path.stem)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.pop("extras")
        return d


def semantic_kitti_default() -> MaskBevConfig:
    """Reference configs/training/semantic_kitti/01_point_mask_data_aug_gentle.yml."""
    return MaskBevConfig(
        name="semantic_kitti_default", dataset="semantic_kitti",
        x_range=(-40, 40), y_range=(-40, 40), z_range=(-20, 20),
        voxel_size=0.16, num_queries=45, head_num_classes=1,
        # int8 backbone products at eval, as in the JAX package
        backbone_quantize="int8",
    )


def kitti_default() -> MaskBevConfig:
    """Reference configs/training/kitti/01_kitti_point_mask_lower_lr_finer.yml."""
    return MaskBevConfig(
        name="kitti_default", dataset="kitti", lr=5e-5,
        x_range=(0, 80), y_range=(-40, 40), z_range=(-20, 20),
        voxel_size=0.1, num_queries=45, head_num_classes=3,
    )


def waymo_default() -> MaskBevConfig:
    """Reference configs/training/waymo/01_waymo_point_mask_data_aug_gentle.yml."""
    return MaskBevConfig(
        name="waymo_default", dataset="waymo",
        x_range=(-40, 40), y_range=(-40, 40), z_range=(-20, 20),
        voxel_size=0.16, num_queries=170, head_num_classes=2, pc_point_dim=3,
    )


def tiny_test_config() -> MaskBevConfig:
    """Small config for hermetic tests: 20m @ 0.25m -> 80x80 grid."""
    return MaskBevConfig(
        name="tiny", dataset="synthetic",
        x_range=(-10, 10), y_range=(-10, 10), z_range=(-4, 4),
        voxel_size=0.25, num_queries=8, head_num_classes=1,
        max_points_per_scan=2048, max_num_pillars=1024, max_num_points=8,
        encoder_feat_channels=(32, 32), backbone_embed_dim=48,
        backbone_depths=(1, 1, 2, 1), backbone_num_heads=(3, 3, 6, 6),
        backbone_window_size=5, head_feat_channels=64, head_out_channels=64,
        head_num_decoder_layers=3, head_ffn_dim=128, head_num_points=256,
        batch_size=2,
    )
