"""BEVFormer's DETR-style 3D head: BEV and object queries, the learned
positional encoding, per-decoder-layer classification and regression
branches, the Hungarian-matched focal + L1 loss and the NMS-free decode.

Counterpart of ``distillbev_tpu/models/dense_heads/bevformer_head.py``
(``normalize_bbox``, ``LearnedPositionalEncoding``,
``make_match_cost_fns`` :75, ``hungarian_match_single`` :123, the
``_DETR3DHeadBase`` branches, decode, ``loss``, ``_loss_single`` and
``get_bboxes``, ``BEVFormerHead``).  The JAX package matches on the
device with ``optax.assignment``; here the cost matrix goes to the host
and ``scipy.optimize.linear_sum_assignment`` solves it over the real
ground-truth columns.  The two agree wherever the optimum is unique.
The teacher's ``DGCNN3DHead`` is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment
from torch import nn

from ..builder import HEADS, build_loss
from ..transformer.decoder import inverse_sigmoid
from ..transformer.perception_transformer import PerceptionTransformer
from ...core.bbox.coders import DecodedBoxes, NMSFreeCoder


def normalize_bbox(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, cz, w, l, h, yaw, vx, vy) -> (cx, cy, log w, log l, cz,
    log h, sin, cos, vx, vy)."""
    logs = torch.log(boxes[..., 3:6].clamp(min=1e-6))
    rot = boxes[..., 6:7]
    out = [boxes[..., 0:2], logs[..., 0:2], boxes[..., 2:3], logs[..., 2:3],
           torch.sin(rot), torch.cos(rot)]
    if boxes.shape[-1] > 7:
        out.append(boxes[..., 7:9])
    return torch.cat(out, dim=-1)


def make_match_cost_fns(assigner_cfg: Optional[dict]):
    """``(cls_cost_fn, reg_weight)`` of the config's HungarianAssigner3D;
    ``cls_cost_fn(logits [Q, C], labels [M]) -> [Q, M]``.  Defaults to
    FocalLossCost(weight=2.0) + BBox3DL1Cost(weight=0.25)."""
    cfg = dict(assigner_cfg or {})
    cls_cfg = dict(cfg.get("cls_cost", dict(type="FocalLossCost",
                                            weight=2.0)))
    reg_cfg = dict(cfg.get("reg_cost", dict(type="BBox3DL1Cost",
                                            weight=0.25)))
    iou_cfg = dict(cfg.get("iou_cost", dict(type="IoUCost", weight=0.0)))
    if float(iou_cfg.get("weight", 0.0)) != 0.0:
        raise ValueError("HungarianAssigner3D iou_cost with a non-zero "
                         "weight is not supported")
    if reg_cfg.get("type", "BBox3DL1Cost") != "BBox3DL1Cost":
        raise ValueError(f"unknown reg_cost type {reg_cfg['type']!r}")
    reg_weight = float(reg_cfg.get("weight", 0.25))
    cls_type = cls_cfg.get("type", "FocalLossCost")
    cls_weight = float(cls_cfg.get("weight", 2.0))
    if cls_type == "FocalLossCost":
        alpha = float(cls_cfg.get("alpha", 0.25))
        gamma = float(cls_cfg.get("gamma", 2.0))
        eps = float(cls_cfg.get("eps", 1e-12))

        def cls_cost_fn(logits, labels):
            prob = torch.sigmoid(logits)
            neg = (1 - alpha) * prob ** gamma * -torch.log(1 - prob + eps)
            pos = alpha * (1 - prob) ** gamma * -torch.log(prob + eps)
            return (pos - neg)[:, labels] * cls_weight
    elif cls_type == "ClassificationCost":
        def cls_cost_fn(logits, labels):
            return -F.softmax(logits, dim=-1)[:, labels] * cls_weight
    else:
        raise ValueError(f"unknown cls_cost type {cls_type!r}")
    return cls_cost_fn, reg_weight


@torch.no_grad()
def hungarian_match_single(cls_scores, bbox_preds, norm_gt, gt_labels,
                           gt_mask, cls_cost_fn, reg_weight) -> torch.Tensor:
    """Assigned ground-truth index per query (``[Q]`` int64, -1 for
    background) for one sample: cost = cls cost + L1(pred[:8], gt[:8]) *
    reg_weight, solved on the host over the real columns."""
    q = cls_scores.shape[0]
    real = torch.nonzero(gt_mask).reshape(-1)
    assigned = torch.full((q,), -1, dtype=torch.int64)
    if real.numel():
        cost = cls_cost_fn(cls_scores, gt_labels[real].long()) + reg_weight * (
            bbox_preds[:, None, :8] - norm_gt[None, real, :8]).abs().sum(-1)
        rows, cols = linear_sum_assignment(cost.double().cpu().numpy())
        assigned[torch.from_numpy(rows)] = real.cpu()[torch.from_numpy(cols)]
    return assigned.to(cls_scores.device)


class LearnedPositionalEncoding(nn.Module):
    """Row/column learned embeddings (mmcv), x features first."""

    def __init__(self, num_feats: int = 128, row_num_embed: int = 200,
                 col_num_embed: int = 200):
        super().__init__()
        self.row_embed = nn.Embedding(row_num_embed, num_feats)
        self.col_embed = nn.Embedding(col_num_embed, num_feats)

    def init_extra(self, generator):
        with torch.no_grad():
            for e in (self.row_embed, self.col_embed):
                e.weight.copy_(torch.randn(e.weight.shape,
                                           generator=generator))

    def forward(self, h: int, w: int) -> torch.Tensor:
        f = self.col_embed.weight.shape[1]
        pos = torch.cat([
            self.col_embed.weight[None, :w].expand(h, w, f),
            self.row_embed.weight[:h, None].expand(h, w, f)], dim=-1)
        return pos.reshape(h * w, -1)


def _cls_branch(embed_dims: int, num_classes: int, num_reg_fcs: int):
    layers = []
    for _ in range(num_reg_fcs):
        layers += [nn.Linear(embed_dims, embed_dims),
                   nn.LayerNorm(embed_dims, eps=1e-5), nn.ReLU()]
    return nn.Sequential(*layers, nn.Linear(embed_dims, num_classes))


def _reg_branch(embed_dims: int, code_size: int, num_reg_fcs: int):
    layers = []
    for _ in range(num_reg_fcs):
        layers += [nn.Linear(embed_dims, embed_dims), nn.ReLU()]
    return nn.Sequential(*layers, nn.Linear(embed_dims, code_size))


@HEADS.register_module()
class BEVFormerHead(nn.Module):
    """Submodules ``bev_embedding``, ``query_embedding``,
    ``positional_encoding``, ``transformer``, ``cls_branches.{l}`` and
    ``reg_branches.{l}`` (one per decoder layer) as the reference."""

    def __init__(self, num_classes: int = 10, embed_dims: int = 256,
                 num_query: int = 900, code_size: int = 10,
                 code_weights=(1.0,) * 8 + (0.2, 0.2), pc_range=None,
                 bbox_coder=None, loss_cls=None, loss_bbox=None,
                 num_reg_fcs: int = 2, with_box_refine: bool = True,
                 train_cfg=None, test_cfg=None,
                 sync_cls_avg_factor: bool = False, bev_h: int = 200,
                 bev_w: int = 200, transformer=None,
                 positional_encoding=None, as_two_stage: bool = False,
                 real_h: float = 102.4, real_w: float = 102.4):
        super().__init__()
        if as_two_stage:
            raise ValueError("BEVFormerHead as_two_stage is not supported")
        self.num_classes, self.embed_dims = num_classes, embed_dims
        self.code_weights = tuple(code_weights)
        self.pc_range = list(pc_range)
        self.bev_h, self.bev_w = bev_h, bev_w
        self.grid_length = (real_h / bev_h, real_w / bev_w)
        self.bbox_coder_cfg = dict(bbox_coder or {})
        self.loss_cls = build_loss(dict(loss_cls))
        self.loss_bbox = build_loss(dict(loss_bbox))
        self.assigner_cfg = dict(train_cfg or {}).get("assigner")
        self.bev_embedding = nn.Embedding(bev_h * bev_w, embed_dims)
        self.query_embedding = nn.Embedding(num_query, embed_dims * 2)
        pe = dict(positional_encoding or {})
        pe.pop("type", None)
        self.positional_encoding = LearnedPositionalEncoding(**pe)
        t_cfg = dict(transformer or {})
        t_cfg.pop("type", None)
        self.transformer = PerceptionTransformer(**t_cfg)
        n_layers = len(self.transformer.decoder.layers)
        self.cls_branches = nn.ModuleList(
            _cls_branch(embed_dims, num_classes, num_reg_fcs)
            for _ in range(n_layers))
        self.reg_branches = nn.ModuleList(
            _reg_branch(embed_dims, code_size, num_reg_fcs)
            for _ in range(n_layers))
        if with_box_refine:
            self.transformer.decoder.reg_branches = nn.ModuleList(
                _reg_branch(embed_dims, code_size, num_reg_fcs)
                for _ in range(n_layers))

    def init_extra(self, generator):
        with torch.no_grad():
            for e in (self.bev_embedding, self.query_embedding):
                e.weight.copy_(torch.randn(e.weight.shape,
                                           generator=generator))
            for branch in self.cls_branches:
                branch[-1].bias.fill_(-4.595)

    def forward(self, mlvl_feats, prev_bev=None, can_bus=None,
                lidar2img=None, img_shape=None, only_bev: bool = False,
                prev_valid=None, sca_budget=None, generator=None):
        """mlvl_feats: list of ``[B, N_cam, H_l, W_l, C]``.  Returns
        bev_embed with ``only_bev``, else the outputs dict."""
        bsz = mlvl_feats[0].shape[0]
        bev_pos = self.positional_encoding(self.bev_h, self.bev_w)
        bev_pos = bev_pos[None].expand((bsz,) + bev_pos.shape)
        common = dict(grid_length=self.grid_length, bev_pos=bev_pos,
                      prev_bev=prev_bev, can_bus=can_bus,
                      lidar2img=lidar2img, img_shape=img_shape,
                      prev_valid=prev_valid, generator=generator)
        query_embed = self.query_embedding.weight
        if only_bev:
            return self.transformer(
                mlvl_feats, self.bev_embedding.weight, query_embed,
                self.bev_h, self.bev_w, only_bev=True, sca_budget=sca_budget,
                **common)
        bev_embed, hs, init_ref, inter_refs = self.transformer(
            mlvl_feats, self.bev_embedding.weight, query_embed, self.bev_h,
            self.bev_w, **common)
        all_cls, all_box = self._decode_outputs(hs, init_ref, inter_refs)
        return dict(bev_embed=bev_embed, all_cls_scores=all_cls,
                    all_bbox_preds=all_box, hs=hs, query_embed=query_embed,
                    enc_cls_scores=None, enc_bbox_preds=None)

    def _decode_outputs(self, hs, init_ref, inter_refs):
        """Per-layer class logits and denormalised box predictions."""
        pcr = self.pc_range
        all_cls, all_box = [], []
        for lvl in range(hs.shape[0]):
            ref = inverse_sigmoid(init_ref if lvl == 0
                                  else inter_refs[lvl - 1])
            tmp = self.reg_branches[lvl](hs[lvl])
            xy = torch.sigmoid(tmp[..., 0:2] + ref[..., 0:2])
            z = torch.sigmoid(tmp[..., 4:5] + ref[..., 2:3])
            box = torch.cat([
                xy[..., 0:1] * (pcr[3] - pcr[0]) + pcr[0],
                xy[..., 1:2] * (pcr[4] - pcr[1]) + pcr[1],
                tmp[..., 2:4], z * (pcr[5] - pcr[2]) + pcr[2],
                tmp[..., 5:]], dim=-1)
            all_cls.append(self.cls_branches[lvl](hs[lvl]))
            all_box.append(box)
        return torch.stack(all_cls), torch.stack(all_box)

    def loss(self, outs: Dict, gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, gt_mask: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        """Hungarian-matched focal + weighted L1 over every decoder layer;
        gt_boxes ``[B, M, 9]`` gravity-centred."""
        cls_cost_fn, reg_weight = make_match_cost_fns(self.assigner_cfg)
        norm_gt = normalize_bbox(gt_boxes)
        all_cls, all_box = outs["all_cls_scores"], outs["all_bbox_preds"]
        n = all_cls.shape[0]
        losses = {}
        for lvl in range(n):
            lc, lb = self._loss_single(all_cls[lvl], all_box[lvl], norm_gt,
                                       gt_labels, gt_mask, cls_cost_fn,
                                       reg_weight)
            suffix = "" if lvl == n - 1 else f".d{lvl}"
            losses[f"loss_cls{suffix}"] = lc
            losses[f"loss_bbox{suffix}"] = lb
        return losses

    def _loss_single(self, cls_scores, bbox_preds, norm_gt, gt_labels,
                     gt_mask, cls_cost_fn, reg_weight):
        assigned = torch.stack([
            hungarian_match_single(cls_scores[i].detach(),
                                   bbox_preds[i].detach(), norm_gt[i],
                                   gt_labels[i], gt_mask[i], cls_cost_fn,
                                   reg_weight)
            for i in range(cls_scores.shape[0])])
        pos = assigned >= 0
        num_pos = pos.sum().clamp(min=1).to(torch.float32)
        safe = assigned.clamp(min=0)
        tgt_labels = torch.where(
            pos, torch.gather(gt_labels.long(), 1, safe),
            torch.full_like(safe, self.num_classes))
        onehot = F.one_hot(tgt_labels, self.num_classes + 1)[
            ..., :self.num_classes].to(cls_scores.dtype)
        loss_cls = self.loss_cls(cls_scores, onehot, avg_factor=num_pos)
        tgt_boxes = torch.gather(
            norm_gt, 1, safe[..., None].expand(-1, -1, norm_gt.shape[-1]))
        w = pos[..., None].to(torch.float32) * bbox_preds.new_tensor(
            self.code_weights)
        valid = torch.isfinite(tgt_boxes).all(-1, keepdim=True)
        loss_bbox = self.loss_bbox(
            bbox_preds, torch.where(valid, tgt_boxes,
                                    tgt_boxes.new_zeros(())),
            w * valid, avg_factor=num_pos)
        return loss_cls, loss_bbox

    def get_bboxes(self, outs: Dict) -> DecodedBoxes:
        """Decode the final layer's predictions with the NMS-free coder."""
        cfg = dict(self.bbox_coder_cfg)
        cfg.pop("type", None)
        cfg.pop("voxel_size", None)
        coder = NMSFreeCoder(**cfg)
        cls = outs["all_cls_scores"][-1]
        box = outs["all_bbox_preds"][-1]
        dets = [coder.decode_single(cls[i], box[i])
                for i in range(cls.shape[0])]
        return DecodedBoxes(*[torch.cat(parts) for parts in zip(*dets)])
