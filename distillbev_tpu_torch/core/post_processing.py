"""BEV NMS as keep masks over a fixed candidate set.

Counterpart of ``distillbev_tpu/core/post_processing.py``
(``rotated_nms_mask``, ``circle_nms_mask``).  The overlap matrix is
built on the inputs' device; the greedy sweep -- up to N sequential
steps, each depending on the last -- runs on a host copy of that
``[N, N]`` mask, as the reference's ``nms_gpu`` sweeps its IoU bitmask
on the host.  The keep mask returns to the inputs' device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .bbox.box_ops import rotated_iou_bev


def _greedy_sweep(overlap: torch.Tensor, order: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """A candidate survives iff no higher-ranked survivor overlaps it."""
    over = overlap.cpu().numpy()
    ok = valid.cpu().numpy()
    keep = np.zeros(over.shape[0], bool)
    supp = np.zeros(over.shape[0], bool)
    for i in order.cpu().numpy():
        if ok[i] and not supp[i]:
            keep[i] = True
            supp |= over[i]
    return torch.from_numpy(keep).to(valid.device)


def circle_nms_mask(centers_xy: torch.Tensor, scores: torch.Tensor,
                    thresh: float,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Circular NMS: a detection survives iff no higher-scored survivor
    lies within squared BEV center distance ``thresh``.
    ``[N, 2], [N] -> bool [N]``."""
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    d2 = ((centers_xy[:, None, :] - centers_xy[None, :, :]) ** 2).sum(-1)
    order = torch.sort(-scores, stable=True).indices
    return _greedy_sweep(d2 <= thresh, order, valid)


def rotated_nms_mask(boxes_xywhr: torch.Tensor, scores: torch.Tensor,
                     thresh: float, valid: Optional[torch.Tensor] = None,
                     pre_max_size: Optional[int] = None) -> torch.Tensor:
    """Rotated-BEV-IoU NMS keep mask (reference ``nms_gpu``).

    ``[N, 5]`` (cx, cy, dx, dy, yaw), ``[N]`` scores -> bool ``[N]``.
    With ``pre_max_size < N`` only the top ``pre_max_size`` valid
    candidates take part.
    """
    n = scores.shape[0]
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    masked = torch.where(valid, scores, torch.full_like(scores,
                                                        -float("inf")))
    if pre_max_size is not None and pre_max_size < n:
        top_scores, top_idx = torch.topk(masked, pre_max_size)
        sub_keep = rotated_nms_mask(boxes_xywhr[top_idx], top_scores,
                                    thresh, valid=valid[top_idx])
        keep = torch.zeros_like(valid)
        keep[top_idx] = sub_keep
        return keep
    overlap = rotated_iou_bev(boxes_xywhr, boxes_xywhr) > thresh
    order = torch.sort(-masked, stable=True).indices
    return _greedy_sweep(overlap, order, valid)
