"""Model registries and the ``build_*`` helpers.

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
LOSSES = Registry("losses", parent=MODELS)
DETECTORS = Registry("detectors", parent=MODELS)
TRANSFORMERS = Registry("transformers", parent=MODELS)
ATTENTION = Registry("attention", parent=MODELS)


def build_backbone(cfg):
    return build_from_cfg(cfg, BACKBONES)


def build_neck(cfg):
    return build_from_cfg(cfg, NECKS)


def build_head(cfg):
    return build_from_cfg(cfg, HEADS)


def build_loss(cfg):
    return build_from_cfg(cfg, LOSSES)


def build_transformer(cfg):
    return build_from_cfg(cfg, TRANSFORMERS)


def build_attention(cfg):
    return build_from_cfg(cfg, ATTENTION)


def build_detector(cfg):
    return build_from_cfg(cfg, DETECTORS)
