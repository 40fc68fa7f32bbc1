"""Model registries and the ``build_*`` helpers of the serving slice.

Counterpart of ``distillbev_tpu/models/builder.py``.  Building here
returns a ``torch.nn.Module`` that owns its parameters; the modules need
their input widths at construction, so every config block of the slice
carries them (``in_channels`` / ``numC_input``).
"""
from __future__ import annotations

from ..registry import Registry, build_from_cfg

MODELS = Registry("models")
BACKBONES = Registry("backbones", parent=MODELS)
NECKS = Registry("necks", parent=MODELS)
HEADS = Registry("heads", parent=MODELS)
DETECTORS = Registry("detectors", parent=MODELS)


def build_backbone(cfg):
    return build_from_cfg(cfg, BACKBONES)


def build_neck(cfg):
    return build_from_cfg(cfg, NECKS)


def build_head(cfg):
    return build_from_cfg(cfg, HEADS)


def build_detector(cfg):
    return build_from_cfg(cfg, DETECTORS)
