from .builder import (MODELS, BACKBONES, NECKS, HEADS, LOSSES, DETECTORS,
                      TRANSFORMERS, ATTENTION, VOXEL_ENCODERS,
                      MIDDLE_ENCODERS, build_backbone, build_neck,
                      build_head, build_loss, build_transformer,
                      build_attention, build_detector, build_voxel_encoder,
                      build_middle_encoder)
from . import layers, losses
from .backbones import resnet  # noqa: F401 — registration
from .necks import fpn  # noqa: F401
from .necks import view_transformer  # noqa: F401
from .dense_heads import centerpoint_head  # noqa: F401
from .detectors import bevdet  # noqa: F401
from .detectors import bevdet_distill  # noqa: F401
from .transformer import attention as _attn  # noqa: F401
from .transformer import encoder as _enc  # noqa: F401
from .transformer import decoder as _dec  # noqa: F401
from .transformer import perception_transformer as _pt  # noqa: F401
from .dense_heads import bevformer_head  # noqa: F401
from .detectors import bevformer  # noqa: F401
from .voxel_encoders import pillar_encoder  # noqa: F401
from .middle_encoders import pillar_scatter  # noqa: F401
from .backbones import second  # noqa: F401
from .necks import second_fpn  # noqa: F401
from .detectors import centerpoint  # noqa: F401
from .detectors import mvx_two_stage  # noqa: F401

__all__ = ["MODELS", "BACKBONES", "NECKS", "HEADS", "LOSSES", "DETECTORS",
           "TRANSFORMERS", "ATTENTION", "VOXEL_ENCODERS", "MIDDLE_ENCODERS",
           "build_backbone", "build_neck", "build_head", "build_loss",
           "build_transformer", "build_attention", "build_detector",
           "build_voxel_encoder", "build_middle_encoder", "layers",
           "losses"]
