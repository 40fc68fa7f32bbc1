"""The plain BEVFormer train step: detection loss only.

Counterpart of ``distillbev_tpu/training/train_step.py``
(``gravity_centered`` :48, ``BEVFormerBatch``,
``make_bevformer_train_step`` :438-484): the queue forward (history BEV
without gradients, the current frame with GridMask and dropout), the
Hungarian-matched loss, the backward and one AdamW update with clipping.
The dropout and GridMask draws come from a generator seeded by ``(seed,
step)``, as the JAX step folds the step into its dropout key.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch


class BEVFormerBatch(NamedTuple):
    """Queue batch of the transformer student (points and point_mask
    belong to the distill step and may be None)."""
    imgs: torch.Tensor           # [B, T, N, H, W, 3]
    can_bus: torch.Tensor        # [B, T, 18]
    lidar2img: torch.Tensor      # [B, T, N, 4, 4]
    prev_exists: torch.Tensor    # [B, T]
    points: Optional[torch.Tensor]
    point_mask: Optional[torch.Tensor]
    gt_boxes: torch.Tensor       # [B, M, 9] bottom-centre
    gt_labels: torch.Tensor      # [B, M]
    gt_mask: torch.Tensor        # [B, M] bool


def gravity_centered(gt_boxes: torch.Tensor) -> torch.Tensor:
    """Bottom-centre -> gravity-centre z."""
    out = gt_boxes.clone()
    out[..., 2] += gt_boxes[..., 5] * 0.5
    return out


def make_bevformer_train_step(model, optimizer, seed: int = 0) -> Callable:
    """``train_step(batch, step) -> metrics``: one optimizer update of
    ``model`` (a ``BEVFormer``) on ``batch``.  ``optimizer`` is a
    ``training.optim.Optimizer``.  The metrics are the loss dict,
    ``total_loss`` and ``grad_norm`` (before clipping), as tensors."""

    def train_step(batch: BEVFormerBatch, step: int) -> Dict[str,
                                                            torch.Tensor]:
        gt = gravity_centered(batch.gt_boxes)
        gen = torch.Generator(device=batch.imgs.device).manual_seed(
            (seed << 32) + int(step))
        optimizer.zero_grad()
        outs = model(batch.imgs, batch.can_bus, batch.lidar2img,
                     batch.prev_exists, train=True, generator=gen)
        losses = model.loss(outs, gt, batch.gt_labels, batch.gt_mask)
        total = sum(losses.values())
        total.backward()
        grad_norm = optimizer.step(step)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step
