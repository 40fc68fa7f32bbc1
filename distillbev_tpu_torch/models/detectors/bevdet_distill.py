"""The flagship distill student: BEVDepth4D with the FGD distiller.

Counterpart of ``distillbev_tpu/models/detectors/bevdet_distill.py``
(``BEVDepth4DDistill`` :128 and ``_DistillBase.distill_losses`` :65-124).
The student and the adaptation layers are one module (``distiller``
holds the trainable adaptations); the frozen teacher is a separate
module that the train step runs without gradient.  The epoch gates
(``multi_scale_epoch`` for backbone pairings, ``two_stage_epoch``)
multiply the losses by 0 or 1.  Teacher checkpoints and
``inherit_head`` are not ported.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..builder import DETECTORS
from ..distill.fgd import Distiller
from .bevdet import BEVDepth4D, StudentFeatureBundle


def _select_feat(pos: str, bundle) -> torch.Tensor:
    """A pairing position of a student or teacher feature bundle."""
    if pos == "head":
        return bundle.neck_feat
    if pos == "lss":
        return bundle.lss_feat
    if pos == "canvas":
        return bundle.canvas
    if pos.startswith("backbone"):
        return bundle.backbone_feats[int(pos[-1])]
    raise NotImplementedError(pos)


@DETECTORS.register_module()
class BEVDepth4DDistill(BEVDepth4D):
    """``BEVDepth4D`` + ``distiller`` (reference
    bevdet_distill_more.py:334)."""

    def __init__(self, distill_type: str = "fgd", distill_params: Any = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.distill_params = dict(distill_params)
        self.distiller = Distiller(
            distill_type, self.distill_params,
            (kwargs.get("train_cfg") or {}).get("pts"))

    def distill_losses(self, student_bundle: StudentFeatureBundle,
                       teacher_bundle, gt_boxes: torch.Tensor,
                       gt_mask: torch.Tensor, epoch: float
                       ) -> Dict[str, torch.Tensor]:
        """Every (student_pos, teacher_pos) pairing's losses, keyed
        ``{loss}_{student_pos}_{teacher_pos}``; the teacher's features
        carry no gradient."""
        p = self.distill_params
        ms_epoch = p.get("multi_scale_epoch", -1)
        two_stage = p.get("two_stage_epoch", -1)
        losses: Dict[str, torch.Tensor] = {}
        for index, (sp, tp) in enumerate(zip(p["student_feat_pos"],
                                             p["teacher_feat_pos"])):
            s_feat = _select_feat(sp, student_bundle)
            t_feat = _select_feat(tp, teacher_bundle).detach()
            s_stride = self.distiller.channel_wise_adaptations[index].stride
            t_stride = self.distiller.teacher_adaptations[index].stride
            if abs(s_feat.shape[2] / s_stride -
                   t_feat.shape[2] / t_stride) >= 1e-6:
                raise ValueError(
                    f"field of view differs at pairing {index}: student "
                    f"{tuple(s_feat.shape)} / {s_stride} vs teacher "
                    f"{tuple(t_feat.shape)} / {t_stride}")
            gate = 1.0
            if sp.startswith("backbone") and ms_epoch > 0:
                gate *= float(epoch >= ms_epoch)
            if two_stage > 0:
                gate *= float(epoch >= two_stage)
            for k, v in self.distiller.fgd_loss(index, t_feat, s_feat,
                                                gt_boxes, gt_mask).items():
                losses[f"{k}_{sp}_{tp}"] = v * gate
        return losses
