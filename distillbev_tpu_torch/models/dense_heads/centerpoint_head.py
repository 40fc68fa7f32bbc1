"""CenterPoint multi-task head: forward, targets, loss and decode.

Counterpart of ``distillbev_tpu/models/dense_heads/centerpoint_head.py``
(``SeparateHead``, ``CenterHead.__call__``, ``get_targets``, ``loss`` and
``get_bboxes``).  Submodules are named as the reference state_dict:
``shared_conv`` and ``task_heads.{t}.{name}.{j}``.  Convolutions run
NCHW; the predictions are returned as the JAX layout, per-task dicts of
channels-last maps.  Targets are made on the device from the padded GT
arrays (static shapes: dense gaussians, regression targets at the
integer centres).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

from ..builder import HEADS, build_loss
from ..layers import ConvModule
from ..losses import clip_sigmoid
from ...core import gaussian
from ...core.bbox.coders import CODERS, DecodedBoxes
from ...core.post_processing import circle_nms_mask, rotated_nms_mask
from ...registry import build_from_cfg


class SeparateHead(nn.Module):
    """Per-task branch: one conv stack per output name (``heads`` maps
    name -> (out_channels, num_conv))."""

    def __init__(self, in_channels: int, heads: Dict, head_conv: int = 64,
                 final_kernel: int = 3, init_bias: float = -2.19,
                 norm_cfg: Any = None):
        super().__init__()
        self.names = list(heads)
        self.init_bias = init_bias
        for name, (out_ch, num_conv) in heads.items():
            layers, c = [], in_channels
            for _ in range(num_conv - 1):
                layers.append(ConvModule(c, head_conv, 3, padding=1,
                                         norm_cfg=norm_cfg or
                                         dict(type="BN")))
                c = head_conv
            layers.append(nn.Conv2d(c, out_ch, final_kernel,
                                    padding=final_kernel // 2))
            self.add_module(name, nn.Sequential(*layers))

    def init_extra(self, generator):
        # heatmap prior: sigmoid(-2.19) ~ 0.1 (reference init_weights)
        nn.init.constant_(self.heatmap[-1].bias, self.init_bias)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name)(x).permute(0, 2, 3, 1)
                for name in self.names}


@HEADS.register_module()
class CenterHead(nn.Module):
    """``x [B, C_in, H, W]`` -> per-task dicts of ``[B, H, W, C]`` maps."""

    def __init__(self, in_channels: int = 384, tasks: Any = None,
                 common_heads: Any = None, share_conv_channel: int = 64,
                 bbox_coder: Any = None, separate_head: Any = None,
                 loss_cls: Any = None, loss_bbox: Any = None,
                 norm_cfg: Any = None, norm_bbox: bool = True,
                 train_cfg: Any = None, test_cfg: Any = None,
                 task_specific: bool = False, loss_prefix: str = "",
                 init_cfg: Any = None):
        super().__init__()
        self.tasks = [dict(t) for t in tasks]
        self.norm_bbox = norm_bbox
        self.bbox_coder = dict(bbox_coder)
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.loss_cls_cfg = dict(loss_cls or {})
        self.loss_bbox_cfg = dict(loss_bbox or {})
        self.loss_prefix = loss_prefix
        self.task_class_offsets = []
        acc = 0
        for t in self.tasks:
            self.task_class_offsets.append(acc)
            acc += t["num_class"]
        sep = dict(separate_head or {})
        if sep.pop("type", "SeparateHead") != "SeparateHead":
            raise KeyError("only SeparateHead is in this slice")
        sep.pop("dcn_config", None)
        self.shared_conv = ConvModule(in_channels, share_conv_channel, 3,
                                      padding=1,
                                      norm_cfg=norm_cfg or dict(type="BN"))
        heads_list = []
        for task in self.tasks:
            heads = {k: tuple(v) for k, v in dict(common_heads).items()}
            heads["heatmap"] = (task["num_class"], 2)
            # head_conv defaults to 64 whatever share_conv_channel is
            # (mmdet3d SeparateHead:31); the separate_head cfg overrides
            heads_list.append(SeparateHead(
                share_conv_channel, heads, norm_cfg=norm_cfg,
                **{"head_conv": 64, **sep}))
        self.task_heads = nn.ModuleList(heads_list)

    def forward(self, x) -> List[Dict[str, torch.Tensor]]:
        x = self.shared_conv(x)
        return [head(x) for head in self.task_heads]

    def get_targets(self, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                    gt_mask: torch.Tensor):
        """Per-task training targets from padded GT.

        Args:
            gt_boxes: ``[B, M, 9]`` gravity-centred (x, y, z, dx, dy, dz,
                yaw, vx, vy).
            gt_labels: ``[B, M]`` global class ids.
            gt_mask: ``[B, M]`` bool.

        Returns (heatmaps, anno_boxes, inds, masks), lists over tasks:
        ``[B, K_t, H, W]``, ``[B, M, 10]``, ``[B, M]`` int64 and
        ``[B, M]`` bool.
        """
        tc = self.train_cfg
        osf = tc["out_size_factor"]
        vx, vy = tc["voxel_size"][0], tc["voxel_size"][1]
        pc_range = tc["point_cloud_range"]
        w = tc["grid_size"][0] // osf
        h = tc["grid_size"][1] // osf
        cx = (gt_boxes[..., 0] - pc_range[0]) / vx / osf
        cy = (gt_boxes[..., 1] - pc_range[1]) / vy / osf
        radius = gaussian.gaussian_radius(gt_boxes[..., 4] / vy / osf,
                                          gt_boxes[..., 3] / vx / osf,
                                          tc["gaussian_overlap"])
        radius = torch.clamp(radius, min=float(tc["min_radius"]))
        cxi = torch.floor(cx).to(torch.int32)
        cyi = torch.floor(cy).to(torch.int32)
        in_grid = (cxi >= 0) & (cxi < w) & (cyi >= 0) & (cyi < h)
        centers = torch.stack([cx, cy], -1)
        dims = gt_boxes[..., 3:6]
        if self.norm_bbox:
            dims = torch.log(torch.clamp(dims, min=1e-6))
        anno = torch.cat([(cx - cxi.to(cx.dtype))[..., None],
                          (cy - cyi.to(cy.dtype))[..., None],
                          gt_boxes[..., 2:3], dims,
                          torch.sin(gt_boxes[..., 6:7]),
                          torch.cos(gt_boxes[..., 6:7]),
                          gt_boxes[..., 7:9]], dim=-1)
        heatmaps, anno_boxes, inds, masks = [], [], [], []
        for off, task in zip(self.task_class_offsets, self.tasks):
            k_t = task["num_class"]
            ok = gt_mask & (gt_labels >= off) & (gt_labels < off + k_t) & \
                in_grid
            local_cls = torch.clamp(gt_labels - off, 0, k_t - 1)
            heatmaps.append(gaussian.gaussian_heatmap_dense(
                centers, radius, local_cls, ok, k_t, h, w))
            inds.append(torch.where(ok, cyi * w + cxi,
                                    torch.zeros_like(cxi)).long())
            anno_boxes.append(torch.where(ok[..., None], anno,
                                          torch.zeros_like(anno)))
            masks.append(ok)
        return heatmaps, anno_boxes, inds, masks

    def loss(self, preds: List[Dict[str, torch.Tensor]],
             gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
             gt_mask: torch.Tensor):
        """Gaussian focal loss on each task's heatmap + code-weighted L1 on
        the regression maps gathered at the GT centres."""
        heatmaps, anno_boxes, inds, masks = self.get_targets(
            gt_boxes, gt_labels, gt_mask)
        loss_cls = build_loss(self.loss_cls_cfg)
        loss_bbox = build_loss(self.loss_bbox_cfg)
        code_weights = gt_boxes.new_tensor(self.train_cfg["code_weights"])
        losses = {}
        for tid, pred in enumerate(preds):
            hm_tgt = heatmaps[tid].permute(0, 2, 3, 1)
            num_pos = (hm_tgt == 1.0).sum()
            losses[f"{self.loss_prefix}task{tid}.loss_heatmap"] = loss_cls(
                clip_sigmoid(pred["heatmap"]), hm_tgt,
                avg_factor=torch.clamp(num_pos, min=1))
            parts = [pred["reg"], pred["height"], pred["dim"], pred["rot"]]
            if "vel" in pred:
                parts.append(pred["vel"])
            anno_pred = torch.cat(parts, dim=-1)           # [B, H, W, 10]
            bsz, hh, ww, cc = anno_pred.shape
            gathered = torch.gather(
                anno_pred.reshape(bsz, hh * ww, cc), 1,
                inds[tid][..., None].expand(-1, -1, cc))   # [B, M, 10]
            weights = masks[tid][..., None].to(torch.float32) * code_weights
            num = torch.clamp(masks[tid].sum(), min=1).to(torch.float32)
            losses[f"{self.loss_prefix}task{tid}.loss_bbox"] = loss_bbox(
                gathered, anno_boxes[tid], weights,
                avg_factor=num + 1e-4)
        return losses

    def get_bboxes(self, preds: List[Dict[str, torch.Tensor]]
                   ) -> DecodedBoxes:
        """Decode every task, NMS per task, merge with global labels and
        keep the global top ``max_per_img`` by masked score.  z is the
        box bottom (the reference shifts gravity z at merge)."""
        coder = build_from_cfg(self.bbox_coder, CODERS)
        tcfg = self.test_cfg
        all_boxes, all_scores, all_labels, all_valid = [], [], [], []
        for tid, pred in enumerate(preds):
            heat = torch.sigmoid(pred["heatmap"])
            dim = torch.exp(pred["dim"]) if self.norm_bbox else pred["dim"]
            boxes, scores, labels, valid = coder.decode(
                heat, pred["rot"][..., 0:1], pred["rot"][..., 1:2],
                pred["height"], dim, pred.get("vel"), reg=pred["reg"],
                task_id=tid)
            nms_type = tcfg.get("nms_type", "rotate")
            if isinstance(nms_type, (list, tuple)):
                nms_type = nms_type[tid]
            if nms_type == "circle":
                thr = tcfg["min_radius"][tid]
                keep = torch.stack([
                    circle_nms_mask(boxes[i, :, :2], scores[i], thr,
                                    valid[i])
                    for i in range(boxes.shape[0])])
            else:
                factor = tcfg.get("nms_rescale_factor",
                                  [1.0] * len(self.tasks))[tid]
                if isinstance(factor, (list, tuple)):
                    fac = boxes.new_tensor(factor)[labels.long()]
                else:
                    fac = torch.full(labels.shape, float(factor),
                                     device=boxes.device)
                nms_boxes = torch.cat([
                    boxes[..., 0:2], boxes[..., 3:5] * fac[..., None],
                    boxes[..., 6:7]], dim=-1)
                thr = tcfg["nms_thr"]
                if isinstance(thr, (list, tuple)):
                    thr = thr[tid]
                score_ok = valid & (scores >= tcfg["score_threshold"])
                keep = torch.stack([
                    rotated_nms_mask(nms_boxes[i], scores[i], thr,
                                     score_ok[i],
                                     pre_max_size=tcfg.get("pre_max_size"))
                    for i in range(boxes.shape[0])])
            valid = valid & keep
            boxes = torch.cat([boxes[..., :2],
                               boxes[..., 2:3] + -boxes[..., 5:6] * 0.5,
                               boxes[..., 3:]], dim=-1)
            all_boxes.append(boxes)
            all_scores.append(scores)
            all_labels.append(labels + self.task_class_offsets[tid])
            all_valid.append(valid)

        boxes = torch.cat(all_boxes, dim=1)
        scores = torch.cat(all_scores, dim=1)
        labels = torch.cat(all_labels, dim=1)
        valid = torch.cat(all_valid, dim=1)
        k = min(tcfg.get("max_per_img", 500), scores.shape[1])
        masked = torch.where(valid, scores,
                             torch.full_like(scores, -float("inf")))
        top_scores, idx = torch.topk(masked, k)
        finite = torch.isfinite(top_scores)
        return DecodedBoxes(
            torch.gather(boxes, 1, idx[..., None].expand(
                -1, -1, boxes.shape[-1])),
            torch.where(finite, top_scores, torch.zeros_like(top_scores)),
            torch.gather(labels.to(torch.int32), 1, idx),
            finite)
