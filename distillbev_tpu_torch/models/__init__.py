from .builder import (MODELS, BACKBONES, NECKS, HEADS, LOSSES, DETECTORS,
                      TRANSFORMERS, ATTENTION, build_backbone, build_neck,
                      build_head, build_loss, build_transformer,
                      build_attention, build_detector)
from . import layers, losses
from .backbones import resnet  # noqa: F401 — registration
from .necks import fpn  # noqa: F401
from .necks import view_transformer  # noqa: F401
from .dense_heads import centerpoint_head  # noqa: F401
from .detectors import bevdet  # noqa: F401
from .transformer import attention as _attn  # noqa: F401
from .transformer import encoder as _enc  # noqa: F401
from .transformer import decoder as _dec  # noqa: F401
from .transformer import perception_transformer as _pt  # noqa: F401
from .dense_heads import bevformer_head  # noqa: F401
from .detectors import bevformer  # noqa: F401

__all__ = ["MODELS", "BACKBONES", "NECKS", "HEADS", "LOSSES", "DETECTORS",
           "TRANSFORMERS", "ATTENTION", "build_backbone", "build_neck",
           "build_head", "build_loss", "build_transformer",
           "build_attention", "build_detector", "layers", "losses"]
