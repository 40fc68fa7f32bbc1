from .builder import (MODELS, BACKBONES, NECKS, HEADS, DETECTORS,
                      build_backbone, build_neck, build_head,
                      build_detector)
from . import layers
from .backbones import resnet  # noqa: F401 — registration
from .necks import fpn  # noqa: F401
from .necks import view_transformer  # noqa: F401
from .dense_heads import centerpoint_head  # noqa: F401
from .detectors import bevdet  # noqa: F401

__all__ = ["MODELS", "BACKBONES", "NECKS", "HEADS", "DETECTORS",
           "build_backbone", "build_neck", "build_head", "build_detector",
           "layers"]
