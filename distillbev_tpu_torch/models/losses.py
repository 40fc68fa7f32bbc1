"""Registry-built losses.

Counterpart of ``distillbev_tpu/models/losses.py``: ``clip_sigmoid``
(:19), ``GaussianFocalLoss`` (:25, CenterHead's heatmaps), the
elementwise-weighted ``L1Loss`` (:59), ``SmoothL1Loss`` (:78) and
``MSELoss`` (:102), and the sigmoid ``FocalLoss`` (:121) of the
DETR-style heads, all with the mmdet ``reduction``/``avg_factor``
rules (``reduction="none"`` returns the elementwise loss).
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


def clip_sigmoid(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Sigmoid clamped to ``[eps, 1 - eps]``."""
    return torch.clamp(torch.sigmoid(x), eps, 1 - eps)


@LOSSES.register_module()
class GaussianFocalLoss:
    """Focal loss on gaussian heatmaps: ``-(1-p)^alpha log(p)`` where the
    target is 1, ``-(1-t)^gamma p^alpha log(1-p)`` elsewhere; ``pred``
    holds probabilities (``clip_sigmoid`` of the logits)."""

    def __init__(self, alpha: float = 2.0, gamma: float = 4.0,
                 reduction: str = "mean", loss_weight: float = 1.0):
        self.alpha = alpha
        self.gamma = gamma
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, avg_factor=None):
        eps = 1e-12
        pos_w = (target == 1.0).to(pred.dtype)
        neg_w = torch.pow(1 - target, self.gamma)
        pos = -torch.log(pred + eps) * torch.pow(1 - pred, self.alpha) * pos_w
        neg = -torch.log(1 - pred + eps) * torch.pow(pred, self.alpha) * neg_w
        loss = pos + neg * (1 - pos_w)
        if self.reduction == "mean" and avg_factor is not None:
            loss = loss.sum() / torch.clamp(torch.as_tensor(
                avg_factor, dtype=loss.dtype, device=loss.device), min=1.0)
        else:
            loss = _reduce(loss, self.reduction, None)
        return self.loss_weight * loss


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
class SmoothL1Loss:

    def __init__(self, beta: float = 1.0, reduction: str = "mean",
                 loss_weight: float = 1.0):
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        diff = (pred - target).abs()
        loss = torch.where(diff < self.beta, 0.5 * diff * diff / self.beta,
                           diff - 0.5 * self.beta)
        if weight is not None:
            loss = loss * weight
        return self.loss_weight * _reduce(loss, self.reduction, avg_factor)


@LOSSES.register_module()
class MSELoss:

    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        loss = (pred - target) ** 2
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
