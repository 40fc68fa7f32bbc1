"""FGD feature distillation: the adaptation layers and the loss.

Counterpart of ``distillbev_tpu/models/distill/fgd.py`` (``Distiller``
with ``distill_type="fgd"``, ``fgd_loss`` :247-503).  Feature maps are
NCHW.  Ported: the flagship knob set (GT foreground, ``logical_not`` or
``1minus`` background, ``combine_gt`` / ``separate_gt`` / ``bg_only``
scale masks, teacher or teacher+student spatial attention, the channel
and spatial masks and losses, any registered feature criterion).  The
other branches raise ``NotImplementedError``: the gauss-family
foreground masks, false-positive mining, the non-empty background
boost, the affinity loss and the other distill types.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..builder import build_loss
from . import masks as M
from .adaptations import StudentAdaptation, TeacherAdaptation


def _per_index(val, index):
    """A list parameter is indexed when it has more than one entry."""
    if isinstance(val, (list, tuple)):
        return val[index] if len(val) > 1 else val[0]
    return val


class Distiller(nn.Module):
    """The trainable adaptations of each (student, teacher) pairing and
    the FGD losses.  Submodules: ``channel_wise_adaptations.{i}``,
    ``teacher_adaptations.{i}``, ``spatial_wise_adaptations.{i}`` (a 3x3
    conv from 1 to 1 channel, with the spatial mask)."""

    # every distill_params key the JAX engine reads: an unknown key is an
    # error, not a silently ignored knob
    KNOWN_KEYS = frozenset({
        "adaptation_type", "affinity_attention_topk",
        "affinity_criterion", "affinity_max_pixels", "affinity_mode",
        "affinity_split", "affinity_weights", "avg_fg_scale_mask",
        "background_mask", "bg_feat_loss_weights", "channel_criterion",
        "channel_loss_weights", "channel_mask", "channel_t",
        "context_length", "context_weight", "criterion",
        "custom_radius_func", "custom_radius_scale", "feat_criterion",
        "feat_loss_weights", "fg_feat_loss_weights", "fn_weights",
        "foreground_mask", "fp_as_foreground", "fp_epoch",
        "fp_scale_mode", "fp_weight", "fp_weights", "fpfn_weight",
        "fpfn_weights", "gauss_fg_weight", "groundtruth_threshold",
        "heatmap", "hs_feat_loss_weights", "hs_weight", "mode",
        "multi_scale_epoch", "non_empty_weight", "nonlocal_weights",
        "output_threshold", "p", "query_criterion", "query_loss_weight",
        "query_weight", "scale_mask", "spatial_attentions",
        "spatial_criterion", "spatial_loss_weights", "spatial_mask",
        "spatial_student_ratio", "spatial_t", "student_adaptation_params",
        "student_channels", "student_feat_pos",
        "teacher_adaptation_params", "teacher_adaptation_type",
        "teacher_channels", "teacher_feat_pos", "tp_weight", "tp_weights",
        "transpose_mask", "two_stage_epoch",
    })

    def __init__(self, distill_type: str, distill_params: Any,
                 train_cfg_pts: Any):
        super().__init__()
        p = self.params = dict(distill_params)
        unknown = sorted(set(p) - self.KNOWN_KEYS)
        if unknown:
            raise ValueError(f"unknown distill_params keys {unknown}")
        if distill_type != "fgd":
            raise NotImplementedError(f"distill_type {distill_type!r}")
        self.train_cfg_pts = dict(train_cfg_pts)
        sc = list(p["student_channels"])
        tc = list(p["teacher_channels"])
        n = len(sc)
        at = p["adaptation_type"]
        at = [at] * n if isinstance(at, str) else list(at)
        tat = p["teacher_adaptation_type"]
        tat = [tat] * n if isinstance(tat, str) else list(tat)
        self.channel_wise_adaptations = nn.ModuleList(
            StudentAdaptation(at[i], sc[i], tc[i],
                              p.get("student_adaptation_params"))
            for i in range(n))
        self.teacher_adaptations = nn.ModuleList(
            TeacherAdaptation(tat[i], tc[i], sc[i],
                              p.get("teacher_adaptation_params"))
            for i in range(n))
        if p.get("spatial_mask", True):
            self.spatial_wise_adaptations = nn.ModuleList(
                nn.Conv2d(1, 1, 3, padding=1) for _ in range(n))
        self._unported()

    def _unported(self):
        """The branches of the JAX ``fgd_loss`` this port does not have."""
        p = self.params
        checks = {
            "foreground_mask": (p.get("foreground_mask", "gt"), "gt"),
            "non_empty_weight": (p.get("non_empty_weight", 0), 0),
            "affinity_mode": (_per_index(p.get("affinity_mode", "none"), 0),
                              "none"),
            "fp_as_foreground": (_per_index(p.get("fp_as_foreground",
                                                  "none"), 0), "none"),
        }
        for key, (got, want) in checks.items():
            if got != want:
                raise NotImplementedError(f"{key}={got!r}")
        if p.get("scale_mask", "combine_gt") not in (
                "combine_gt", "separate_gt", "bg_only", None, ""):
            raise NotImplementedError(f"scale_mask={p['scale_mask']!r}")
        if p.get("background_mask", "logical_not") not in ("logical_not",
                                                           "1minus"):
            raise NotImplementedError(
                f"background_mask={p['background_mask']!r}")

    def fgd_loss(self, index: int, teacher_feat: torch.Tensor,
                 student_feat: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """FGD losses of pairing ``index``: teacher ``[B, Ct, H, W]`` and
        student ``[B, Cs, H', W']`` features (the adaptations bring both
        to one shape); gt_boxes ``[B, M, 7+]``, gt_mask ``[B, M]``."""
        p = self.params
        w_fg = _per_index(p["fg_feat_loss_weights"], index)
        w_bg = _per_index(p["bg_feat_loss_weights"], index)
        w_ch = _per_index(p["channel_loss_weights"], index)
        w_sp = _per_index(p["spatial_loss_weights"], index)
        spatial_att = _per_index(p["spatial_attentions"], index)
        feat_crit = build_loss(dict(p["feat_criterion"]))
        sp_crit = build_loss(dict(p["spatial_criterion"]))
        ch_crit = build_loss(dict(p["channel_criterion"]))

        teacher_feat = self.teacher_adaptations[index](teacher_feat)
        student_feat = self.channel_wise_adaptations[index](student_feat)
        b, _, h, w = student_feat.shape
        if (b, h, w) != (teacher_feat.shape[0], *teacher_feat.shape[2:]):
            raise ValueError(f"adapted student {tuple(student_feat.shape)} "
                             f"vs teacher {tuple(teacher_feat.shape)}")
        tc = self.train_cfg_pts
        fg_mask, fg_scale, bg_scale = M.foreground_scale_mask(
            gt_boxes, gt_mask, h, w, tc["voxel_size"],
            tc["point_cloud_range"], tc["grid_size"],
            avg_fg_scale_mask=p.get("avg_fg_scale_mask", False),
            context_length=p.get("context_length", 0),
            context_weight=p.get("context_weight", 0),
            transpose=p.get("transpose_mask", False))

        t_att = M.spatial_attention(teacher_feat, p["spatial_t"])
        c_t_att = M.channel_attention(teacher_feat, p["channel_t"])
        if spatial_att == "teacher":
            sum_att = t_att
        elif spatial_att == "teacher_student":
            ratio = p["spatial_student_ratio"]
            s_att = M.spatial_attention(student_feat, p["spatial_t"])
            sum_att = (t_att + s_att * ratio) / (1 + ratio)
        else:
            raise NotImplementedError(spatial_att)

        if p.get("background_mask", "logical_not") == "logical_not":
            bg_mask = (fg_mask == 0).to(torch.float32)
        else:                                            # "1minus"
            bg_mask = 1.0 - fg_mask

        scale_mode = p.get("scale_mask", "combine_gt")
        fg_m, bg_m = fg_mask, bg_mask
        if scale_mode == "combine_gt":
            scale = torch.maximum(fg_scale, bg_scale)
            fg_m, bg_m = fg_m * scale, bg_m * scale
        elif scale_mode == "separate_gt":
            fg_m, bg_m = fg_m * fg_scale, bg_m * bg_scale
        elif scale_mode == "bg_only":
            fg_m, bg_m = fg_m * bg_scale, bg_m * bg_scale

        if p.get("spatial_mask", True):
            fg_m, bg_m = fg_m * sum_att, bg_m * sum_att
        fg_w, bg_w = fg_m[:, None], bg_m[:, None]          # [B, 1, H, W]
        if p.get("channel_mask", True):
            ch_mask = c_t_att[:, :, None, None]            # [B, C, 1, 1]
            fg_w, bg_w = fg_w * ch_mask, bg_w * ch_mask

        losses = {}
        diff = feat_crit(student_feat, teacher_feat)
        losses["kd_fg_feat_loss"] = (diff * fg_w).sum() * w_fg / b
        losses["kd_bg_feat_loss"] = (diff * bg_w).sum() * w_bg / b
        if p.get("channel_mask", True):
            losses["kd_channel_loss"] = ch_crit(
                teacher_feat.mean(dim=(2, 3)),
                student_feat.mean(dim=(2, 3))).sum() * w_ch / b
        if p.get("spatial_mask", True):
            t_pool = teacher_feat.mean(dim=1, keepdim=True)
            s_pool = self.spatial_wise_adaptations[index](
                student_feat.mean(dim=1, keepdim=True))
            losses["kd_spatial_loss"] = sp_crit(t_pool, s_pool).sum() * \
                w_sp / b
        return losses
