"""REPA's frozen teachers (counterpart of vaw_tpu/encoders)."""

from .align import get_feature, initialize_encoders, preprocess_raw_image
from .loaders import (
    convert_clip_vit,
    convert_timm_vit,
    find_encoder_weights,
    load_encoders,
    resample_pos_embed,
    runtime_image_size,
)
from .vit_backbone import (
    FAMILY_CONFIGS,
    FeatureViT,
    make_teacher,
    mocov3_sincos_pos_embed,
)

__all__ = [
    "FeatureViT", "make_teacher", "FAMILY_CONFIGS",
    "mocov3_sincos_pos_embed",
    "load_encoders", "convert_timm_vit", "convert_clip_vit",
    "find_encoder_weights", "resample_pos_embed", "runtime_image_size",
    "initialize_encoders", "preprocess_raw_image", "get_feature",
]
