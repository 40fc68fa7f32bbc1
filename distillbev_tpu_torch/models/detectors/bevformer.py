"""BEVFormer camera detector.

Counterpart of ``distillbev_tpu/models/detectors/bevformer.py:BEVFormer``
(:37-203): GridMask on the training images, the no-grad history BEV over
the queue's earlier frames (``obtain_history_bev``), the current frame
with gradients, the test-frame forward of the scene-token state machine,
and the loss and decode of the head.

Inputs follow the JAX queue protocol: imgs ``[B, T, N, H, W, 3]``,
can_bus ``[B, T, 18]``, lidar2img ``[B, T, N, 4, 4]``, prev_exists
``[B, T]``; the last frame is the current one.  Training randomness
(GridMask, dropout) draws from the generator passed with ``train=True``.
The image encoder takes all cameras in one batched call;
``seq_img_encoder`` (the JAX package's per-camera loop, a TPU memory
choice) is accepted and ignored.  ``BEVFormerDistill`` (the teacher and the FGD losses) is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..builder import DETECTORS, build_backbone, build_head, build_neck
from ..utils.grid_mask import grid_mask


@DETECTORS.register_module()
class BEVFormer(nn.Module):
    """Submodules ``img_backbone``, ``img_neck``, ``pts_bbox_head``."""

    def __init__(self, img_backbone=None, img_neck=None, pts_bbox_head=None,
                 use_grid_mask: bool = False, video_test_mode: bool = True,
                 seq_img_encoder: bool = False, history_sca_budget: Any = None,
                 train_cfg=None, test_cfg=None, pretrained=None):
        super().__init__()
        self.use_grid_mask = use_grid_mask
        self.history_sca_budget = history_sca_budget
        self.img_backbone = build_backbone(dict(img_backbone))
        self.img_neck = build_neck(dict(img_neck)) if img_neck else None
        head_cfg = dict(pts_bbox_head)
        head_cfg.pop("in_channels", None)
        head_cfg.setdefault("train_cfg", (train_cfg or {}).get("pts"))
        head_cfg.setdefault("test_cfg", (test_cfg or {}).get("pts"))
        self.pts_bbox_head = build_head(head_cfg)

    def _encode(self, x):
        feats = self.img_backbone(x)
        return list(self.img_neck(feats) if self.img_neck is not None
                    else feats)

    def extract_img_feat(self, imgs, train: bool = False,
                         generator: Optional[torch.Generator] = None):
        """imgs ``[B, N, H, W, 3]`` -> list of ``[B, N, h_l, w_l, C]``."""
        b, n, h, w, c = imgs.shape
        x = imgs.reshape(b * n, h, w, c)
        if self.use_grid_mask and train:
            x = grid_mask(_required(generator), x)
        # contiguous NCHW: torch's CPU conv backward aborts on the
        # channels-last strides of the permuted view
        return [f.reshape((b, n) + f.shape[1:]).permute(0, 1, 3, 4, 2)
                for f in self._encode(x.permute(0, 3, 1, 2).contiguous())]

    def _frame_bev(self, imgs, can_bus, lidar2img, prev_bev,
                   prev_valid=None, sca_budget=None):
        feats = self.extract_img_feat(imgs)
        return self.pts_bbox_head(
            feats, prev_bev=prev_bev, can_bus=can_bus, lidar2img=lidar2img,
            img_shape=(imgs.shape[2], imgs.shape[3]), only_bev=True,
            prev_valid=prev_valid, sca_budget=sca_budget)

    @torch.no_grad()
    def obtain_history_bev(self, imgs_queue, can_bus_queue, lidar2img_queue,
                           prev_exists):
        """Roll the queue's frames into a history BEV without gradients
        and without dropout.  Frame 0 never has history inside the queue;
        later frames follow ``prev_exists`` (TSA falls back to the
        current query where it is 0)."""
        b, t = imgs_queue.shape[:2]
        head = self.pts_bbox_head
        prev_bev = imgs_queue.new_zeros(b, head.bev_h * head.bev_w,
                                        head.embed_dims)
        first = torch.ones(t, dtype=prev_exists.dtype,
                           device=prev_exists.device)
        first[0] = 0
        valid = prev_exists * first[None]
        for i in range(t):
            prev_bev = self._frame_bev(
                imgs_queue[:, i], can_bus_queue[:, i], lidar2img_queue[:, i],
                prev_bev, prev_valid=valid[:, i],
                sca_budget=self.history_sca_budget)
        return prev_bev

    def forward(self, imgs, can_bus, lidar2img, prev_exists,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict:
        """imgs ``[B, T, N, H, W, 3]`` -> the head's outputs dict for the
        last frame."""
        t = imgs.shape[1]
        prev_bev = prev_valid = None
        if t > 1:
            prev_bev = self.obtain_history_bev(
                imgs[:, :-1], can_bus[:, :-1], lidar2img[:, :-1],
                prev_exists[:, :-1])
            prev_valid = prev_exists[:, -1]
        gen = _required(generator) if train else None
        feats = self.extract_img_feat(imgs[:, -1], train=train,
                                      generator=gen)
        return self.pts_bbox_head(
            feats, prev_bev=prev_bev, can_bus=can_bus[:, -1],
            lidar2img=lidar2img[:, -1],
            img_shape=(imgs.shape[3], imgs.shape[4]), prev_valid=prev_valid,
            generator=gen)

    def forward_test_frame(self, imgs, can_bus, lidar2img, prev_bev,
                           prev_valid) -> Dict:
        """Test-time single frame: imgs ``[B, N, H, W, 3]``; prev_bev
        ``[B, H*W, C]`` (zeros at a scene start), gated by prev_valid
        ``[B]``."""
        feats = self.extract_img_feat(imgs)
        return self.pts_bbox_head(
            feats, prev_bev=prev_bev, can_bus=can_bus, lidar2img=lidar2img,
            img_shape=(imgs.shape[2], imgs.shape[3]), prev_valid=prev_valid)

    def loss(self, outs, gt_boxes, gt_labels, gt_mask):
        return self.pts_bbox_head.loss(outs, gt_boxes, gt_labels, gt_mask)

    def get_bboxes(self, outs):
        return self.pts_bbox_head.get_bboxes(outs)


def _required(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("train=True draws GridMask and dropout from a "
                         "generator: pass one")
    return generator
