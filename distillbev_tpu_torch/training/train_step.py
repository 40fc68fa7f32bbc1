"""Train steps: the flagship distill step and the plain BEVFormer step.

Counterpart of ``distillbev_tpu/training/train_step.py``
(``gravity_centered`` :48, ``DistillBatch`` :38,
``make_distill_train_step`` :100-251 at fp32 and one microbatch,
``BEVFormerBatch``, ``make_bevformer_train_step`` :438-484).

The distill step runs the frozen teacher in eval mode without gradient,
the student in training mode (batch statistics), the detection, depth
and FGD losses, the backward and one AdamW update with clipping.  The
BEVFormer step: the queue forward (history BEV without gradients, the
current frame with GridMask and dropout), the Hungarian-matched loss,
the backward and the update; its dropout and GridMask draws come from a
generator seeded by ``(seed, step)``, as the JAX step folds the step
into its dropout key.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

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


class DistillBatch(NamedTuple):
    """Camera-student distillation batch: the student's ``ImgInputs``,
    the teacher's points ``[B, N, 5]`` (pillar-sorted) and point mask,
    and the padded GT (bottom-centre boxes ``[B, M, 9]``, labels, mask)."""
    img_inputs: Any
    points: torch.Tensor
    point_mask: torch.Tensor
    gt_boxes: torch.Tensor
    gt_labels: torch.Tensor
    gt_mask: torch.Tensor


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


def make_distill_train_step(student, teacher, optimizer) -> Callable:
    """``train_step(batch, step, epoch) -> metrics``: one optimizer update
    of ``student`` (a ``BEVDepth4DDistill``) distilled from ``teacher``
    on a ``DistillBatch``.  ``optimizer`` is a ``training.optim.Optimizer``
    over the student's parameters.  The loss is detection + depth +
    distill; the metrics are the loss dict, ``total_loss`` and
    ``grad_norm`` (before clipping), as tensors."""

    def train_step(batch: DistillBatch, step: int,
                   epoch: float = 1.0) -> Dict[str, torch.Tensor]:
        gt = gravity_centered(batch.gt_boxes)
        teacher.eval()
        with torch.no_grad():
            _, t_bundle = teacher(batch.points, batch.point_mask)
        student.train()
        optimizer.zero_grad()
        preds, bundle, depth = student(batch.img_inputs)
        losses = dict(student.head_loss(preds, gt, batch.gt_labels,
                                        batch.gt_mask))
        depth_gt = batch.img_inputs.depth_gt
        if depth is not None and depth_gt is not None:
            losses["loss_depth"] = student.depth_loss(depth, depth_gt)
        losses.update(student.distill_losses(bundle, t_bundle, gt,
                                             batch.gt_mask, epoch))
        total = sum(losses.values())
        total.backward()
        grad_norm = optimizer.step(step)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step
