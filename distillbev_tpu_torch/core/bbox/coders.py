"""Box coders: fixed K, masked.

Counterpart of ``distillbev_tpu/core/bbox/coders.py``
(``DecodedBoxes``, ``CenterPointBBoxCoder``, ``NMSFreeCoder``).
CenterPoint: top-K over the ``H*W*n_cls`` scores with class
``idx % n_cls``, regressions gathered at the peak pixels.  NMS-free
(DETR heads): top-K over the ``Q*n_cls`` sigmoid scores, boxes decoded
from the 10-dim regression with the bottom-centre z.  Validity by score
threshold and post-center range in both.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ...registry import Registry

CODERS = Registry("bbox_coders_core")


class DecodedBoxes(NamedTuple):
    bboxes: torch.Tensor  # [B, K, code_size] (x, y, z, dx, dy, dz, yaw, vx, vy)
    scores: torch.Tensor  # [B, K]
    labels: torch.Tensor  # [B, K] int32
    valid: torch.Tensor   # [B, K] bool


@CODERS.register_module()
class CenterPointBBoxCoder:

    def __init__(self, pc_range: Optional[Sequence[float]] = None,
                 out_size_factor: int = 4,
                 voxel_size: Sequence[float] = (0.2, 0.2),
                 post_center_range: Optional[Sequence[float]] = None,
                 max_num: int = 100, score_threshold: Optional[float] = None,
                 code_size: int = 9):
        self.pc_range = pc_range
        self.out_size_factor = out_size_factor
        self.voxel_size = voxel_size
        self.post_center_range = post_center_range
        self.max_num = max_num
        self.score_threshold = score_threshold
        self.code_size = code_size

    def decode(self, heat: torch.Tensor, rot_sine: torch.Tensor,
               rot_cosine: torch.Tensor, hei: torch.Tensor,
               dim: torch.Tensor, vel: Optional[torch.Tensor],
               reg: Optional[torch.Tensor] = None,
               task_id: int = -1) -> DecodedBoxes:
        """Channels-last maps: heat ``[B, H, W, n_cls]``, reg
        ``[B, H, W, 2]``, hei ``[B, H, W, 1]``, dim ``[B, H, W, 3]``
        (already exp'ed if norm_bbox), rot_* ``[B, H, W, 1]``, vel
        ``[B, H, W, 2]``."""
        b, h, w, n_cls = heat.shape
        scores, flat_idx = torch.topk(heat.reshape(b, h * w * n_cls),
                                      self.max_num)
        cls = (flat_idx % n_cls).to(torch.int32)
        pix = flat_idx // n_cls
        ys = (pix // w).to(torch.float32)
        xs = (pix % w).to(torch.float32)

        def gather(m):
            mm = m.reshape(b, h * w, -1)
            return torch.gather(mm, 1, pix[..., None].expand(
                -1, -1, mm.shape[-1]))

        if reg is not None:
            r = gather(reg)
            xs = xs + r[..., 0]
            ys = ys + r[..., 1]
        else:
            xs = xs + 0.5
            ys = ys + 0.5
        rot = torch.atan2(gather(rot_sine)[..., 0],
                          gather(rot_cosine)[..., 0])
        x = xs * self.out_size_factor * self.voxel_size[0] + \
            self.pc_range[0]
        y = ys * self.out_size_factor * self.voxel_size[1] + \
            self.pc_range[1]
        parts = [x[..., None], y[..., None], gather(hei), gather(dim),
                 rot[..., None]]
        if vel is not None:
            parts.append(gather(vel))
        boxes = torch.cat(parts, dim=-1)

        valid = torch.ones_like(scores, dtype=torch.bool)
        if self.score_threshold is not None:
            valid &= scores > self.score_threshold
        if self.post_center_range is not None:
            pcr = boxes.new_tensor(self.post_center_range)
            valid &= (boxes[..., :3] >= pcr[:3]).all(-1)
            valid &= (boxes[..., :3] <= pcr[3:]).all(-1)
        return DecodedBoxes(boxes, scores, cls, valid)


@CODERS.register_module()
class NMSFreeCoder:
    """Decode DETR-style ``(cls_scores, bbox_preds)`` without NMS;
    bbox_preds ``(cx, cy, log w, log l, cz, log h, sin, cos, vx, vy)``
    with cx/cy/cz already denormalised."""

    def __init__(self, pc_range: Sequence[float],
                 post_center_range: Optional[Sequence[float]] = None,
                 max_num: int = 100, score_threshold: Optional[float] = None,
                 num_classes: int = 10):
        self.pc_range = pc_range
        self.post_center_range = post_center_range
        self.max_num = max_num
        self.score_threshold = score_threshold
        self.num_classes = num_classes

    def decode_single(self, cls_scores: torch.Tensor,
                      bbox_preds: torch.Tensor) -> DecodedBoxes:
        """cls_scores ``[Q, n_cls]`` logits; bbox_preds ``[Q, 10]`` ->
        DecodedBoxes with a leading batch axis of 1."""
        n_cls = cls_scores.shape[1]
        scores_all = torch.sigmoid(cls_scores).reshape(-1)
        k = min(self.max_num, scores_all.shape[0])
        # ties: lower index first, as jax.lax.top_k
        order = torch.sort(scores_all, descending=True, stable=True).indices
        idx = order[:k]
        scores = scores_all[idx]
        labels = (idx % n_cls).to(torch.int32)
        bp = bbox_preds[idx // n_cls]
        h = torch.exp(bp[:, 5])
        boxes = torch.stack(
            [bp[:, 0], bp[:, 1], bp[:, 4] - h / 2, torch.exp(bp[:, 2]),
             torch.exp(bp[:, 3]), h, torch.atan2(bp[:, 6], bp[:, 7]),
             bp[:, 8], bp[:, 9]], dim=-1)
        valid = torch.ones_like(scores, dtype=torch.bool)
        if self.score_threshold is not None:
            valid &= scores > self.score_threshold
        if self.post_center_range is not None:
            pcr = boxes.new_tensor(self.post_center_range)
            valid &= (boxes[:, :3] >= pcr[:3]).all(-1)
            valid &= (boxes[:, :3] <= pcr[3:]).all(-1)
        return DecodedBoxes(boxes[None], scores[None], labels[None],
                            valid[None])
