"""BEVDepth4D: the two-frame camera student, forward and losses.

Counterpart of ``distillbev_tpu/models/detectors/bevdet.py``
(``ImgInputs``, ``BEVDepth4D``, ``shift_feature``, ``head_loss``,
``depth_loss``).  The inputs keep the JAX layout (images ``[B, F*N, H,
W, 3]``) and so do the head maps; the image encoder, view transformer and
BEV encoder run NCHW in between.  ``.train()`` switches every BatchNorm
to batch statistics; their running statistics then update in the JAX
order (image encoder and view transformer of frame 0, then of frame 1,
pre_process of frame 0 and of frame 1, the BEV encoder), so a module
shared by the two frames updates twice a call.  With ``detach`` frame 1
reaches the BEV encoder detached, so it runs without an autograd graph
(the JAX step prunes its backward at trace time): its splat launches no
backward gather.
Submodules are named as the reference state_dict (``img_backbone``,
``img_neck``, ``img_view_transformer``, ``pre_process_net``,
``img_bev_encoder_backbone``, ``img_bev_encoder_neck``,
``pts_bbox_head``).
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..builder import DETECTORS, build_backbone, build_head, build_neck
from ..necks.view_transformer import depth_bce_loss
from ...ops.grid_sample import grid_sample


class ImgInputs(NamedTuple):
    """Camera inputs.

    imgs: ``[B, F*N, H, W, 3]`` (F = 2 frames).
    rots/intrins/post_rots: ``[B, F, N, 3, 3]``; trans/post_trans:
    ``[B, F, N, 3]``.  depth_gt: optional ``[B, N, fH, fW]``.
    """
    imgs: torch.Tensor
    rots: torch.Tensor
    trans: torch.Tensor
    intrins: torch.Tensor
    post_rots: torch.Tensor
    post_trans: torch.Tensor
    depth_gt: Optional[torch.Tensor] = None


class StudentFeatureBundle(NamedTuple):
    """Distillation pairing positions, NCHW."""
    neck_feat: torch.Tensor
    backbone_feats: Optional[Tuple[torch.Tensor, ...]]
    lss_feat: Optional[torch.Tensor]


@DETECTORS.register_module()
class BEVDepth4D(nn.Module):
    """2-frame temporal BEVDepth (the distill student's forward)."""

    def __init__(self, img_backbone: Any = None, img_neck: Any = None,
                 img_view_transformer: Any = None,
                 img_bev_encoder_backbone: Any = None,
                 img_bev_encoder_neck: Any = None,
                 pts_bbox_head: Any = None, pre_process: Any = None,
                 train_cfg: Any = None, test_cfg: Any = None,
                 aligned: bool = True, detach: bool = True,
                 before: bool = True):
        super().__init__()
        self.detach, self.before = detach, before
        self.img_backbone = build_backbone(dict(img_backbone))
        self.img_neck = build_neck(dict(img_neck))
        self.img_view_transformer = build_neck(dict(img_view_transformer))
        self.img_bev_encoder_backbone = build_backbone(
            dict(img_bev_encoder_backbone))
        self.img_bev_encoder_neck = build_neck(dict(img_bev_encoder_neck))
        self.pre_process_net = build_backbone(dict(pre_process)) \
            if pre_process is not None else None
        head_cfg = dict(pts_bbox_head)
        head_cfg.setdefault("train_cfg", (train_cfg or {}).get("pts"))
        head_cfg.setdefault("test_cfg", (test_cfg or {}).get("pts"))
        self.pts_bbox_head = build_head(head_cfg)

    def image_encoder(self, imgs):
        """``[B, N, H, W, 3]`` -> ``[B, N, C, fH, fW]``."""
        b, n, h, w, c = imgs.shape
        x = imgs.reshape(b * n, h, w, c).permute(0, 3, 1, 2)
        x = self.img_neck(self.img_backbone(x.contiguous()))
        if isinstance(x, (tuple, list)):
            x = x[0]
        return x.reshape(b, n, *x.shape[1:])

    def bev_encoder(self, bev):
        feats = self.img_bev_encoder_backbone(bev)
        out = self.img_bev_encoder_neck(feats)
        if isinstance(out, (tuple, list)):
            out = out[0]
        return out, feats

    def shift_feature(self, bev_prev, trans, rots):
        """Warp the previous-frame BEV into the current ego frame with
        camera 0's extrinsics, fp32, ``grid_sample(align_corners=True)``.

        bev_prev ``[B, H, W, C]``; trans ``[B, 2, N, 3]``; rots
        ``[B, 2, N, 3, 3]`` -> ``[B, H, W, C]``.
        """
        b, h, w, _ = bev_prev.shape
        f32 = torch.float32
        dev = bev_prev.device
        geo = self.img_view_transformer.geo

        def make44(rot, tran):
            m = torch.zeros(b, 4, 4, dtype=f32, device=dev)
            m[:, :3, :3] = rot[:, 0].to(f32)
            m[:, :3, 3] = tran[:, 0].to(f32)
            m[:, 3, 3] = 1.0
            return m

        c02l0 = make44(rots[:, 0], trans[:, 0])
        c12l0 = make44(rots[:, 1], trans[:, 1])
        l02l1 = c02l0 @ torch.linalg.inv(c12l0)
        keep = torch.tensor([0, 1, 3], device=dev)
        l02l1 = l02l1[:, keep][:, :, keep]              # [B, 3, 3]
        feat2bev = torch.tensor(
            [[float(geo.dx[0]), 0.0, float(geo.bx[0] - geo.dx[0] / 2)],
             [0.0, float(geo.dx[1]), float(geo.bx[1] - geo.dx[1] / 2)],
             [0.0, 0.0, 1.0]], dtype=f32, device=dev)
        tf = torch.einsum("ij,bjk,kl->bil", torch.linalg.inv(feat2bev),
                          l02l1, feat2bev)
        xs = torch.arange(w, dtype=f32, device=dev)
        ys = torch.arange(h, dtype=f32, device=dev)
        grid = torch.stack([xs[None, :].expand(h, w),
                            ys[:, None].expand(h, w),
                            torch.ones(h, w, dtype=f32, device=dev)], -1)
        warped = torch.einsum("bij,hwj->bhwi", tf, grid)
        norm = torch.tensor([w - 1.0, h - 1.0], dtype=f32, device=dev)
        grid_n = warped[..., :2] / norm * 2.0 - 1.0
        return grid_sample(bev_prev.to(f32), grid_n,
                           align_corners=True).to(bev_prev.dtype)

    def _frame(self, f: int):
        """Frame 1 feeds the BEV encoder detached: no graph for it."""
        return torch.no_grad() if self.detach and f == 1 else \
            contextlib.nullcontext()

    def extract_img_feat(self, inputs: ImgInputs):
        imgs = inputs.imgs
        n = imgs.shape[1] // 2
        bev_list, depth0 = [], None
        for f in range(2):
            with self._frame(f):
                x = self.image_encoder(imgs[:, f * n:(f + 1) * n])
                # both frames use the current frame's extrinsics (the
                # pipeline ego-aligns the adjacent cams) and their own
                # intrinsics and image-aug transforms
                bev, dl = self.img_view_transformer(
                    (x, inputs.rots[:, 0], inputs.trans[:, 0],
                     inputs.intrins[:, f], inputs.post_rots[:, f],
                     inputs.post_trans[:, f]))
            if f == 0:
                depth0 = dl
            bev_list.append(bev)
        if self.before and self.pre_process_net is not None:
            bev_list = [self._pre_process(f, bv)
                        for f, bv in enumerate(bev_list)]
        with self._frame(1):
            shifted = self.shift_feature(bev_list[1].permute(0, 2, 3, 1),
                                         inputs.trans, inputs.rots)
        bev_list[1] = shifted.permute(0, 3, 1, 2)
        if self.pre_process_net is not None and not self.before:
            bev_list = [self._pre_process(f, bv)
                        for f, bv in enumerate(bev_list)]
        if self.detach:
            bev_list[1] = bev_list[1].detach()
        bev = torch.cat(bev_list, dim=1)
        neck, feats = self.bev_encoder(bev)
        return StudentFeatureBundle(neck, feats, bev), depth0

    def _pre_process(self, f: int, bev):
        with self._frame(f):
            return self.pre_process_net(bev)[0]

    def forward(self, inputs: ImgInputs):
        """-> (per-task dicts of channels-last head maps, the feature
        bundle, frame 0's depth logits ``[B, N, fH, fW, D]``)."""
        bundle, depth = self.extract_img_feat(inputs)
        return self.pts_bbox_head(bundle.neck_feat), bundle, depth

    def get_bboxes(self, preds):
        return self.pts_bbox_head.get_bboxes(preds)

    def head_loss(self, preds, gt_boxes, gt_labels, gt_mask):
        """The CenterHead loss on gravity-centred GT."""
        return self.pts_bbox_head.loss(preds, gt_boxes, gt_labels, gt_mask)

    def depth_loss(self, depth_logits, depth_gt):
        """Depth supervision of frame 0's logits."""
        vt = self.img_view_transformer
        return depth_bce_loss(depth_logits, depth_gt,
                              vt.grid_config["dbound"], vt.loss_depth_weight)
