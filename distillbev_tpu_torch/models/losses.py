"""Losses of the DETR-style heads.

Counterpart of ``distillbev_tpu/models/losses.py`` (``FocalLoss`` :121,
``L1Loss`` :59): sigmoid focal loss over one-hot targets and a weighted
L1, both with the mmdet ``reduction``/``avg_factor`` rules.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .builder import LOSSES


def _reduce(loss: torch.Tensor, reduction: str, avg_factor):
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.sum() / (avg_factor if avg_factor is not None
                             else max(loss.numel(), 1))
    return loss


@LOSSES.register_module()
class L1Loss:

    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        loss = (pred - target).abs()
        if weight is not None:
            loss = loss * weight
        return self.loss_weight * _reduce(loss, self.reduction, avg_factor)


@LOSSES.register_module()
class FocalLoss:
    """Sigmoid focal loss (DETR-style classification)."""

    def __init__(self, use_sigmoid: bool = True, gamma: float = 2.0,
                 alpha: float = 0.25, reduction: str = "mean",
                 loss_weight: float = 1.0):
        if not use_sigmoid:
            raise ValueError("FocalLoss supports use_sigmoid=True only")
        self.gamma = gamma
        self.alpha = alpha
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target_onehot, weight=None, avg_factor=None):
        """pred: ``[..., C]`` logits; target_onehot: ``[..., C]`` {0, 1}."""
        p = torch.sigmoid(pred)
        ce = F.relu(pred) - pred * target_onehot + torch.log1p(
            torch.exp(-pred.abs()))
        p_t = p * target_onehot + (1 - p) * (1 - target_onehot)
        alpha_t = (self.alpha * target_onehot +
                   (1 - self.alpha) * (1 - target_onehot))
        loss = alpha_t * torch.pow(1 - p_t, self.gamma) * ce
        if weight is not None:
            while weight.dim() < loss.dim():
                weight = weight[..., None]
            loss = loss * weight
        return self.loss_weight * _reduce(loss, self.reduction, avg_factor)
