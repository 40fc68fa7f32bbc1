"""Generic multi-modality detector base, LiDAR-only.

Counterpart of ``distillbev_tpu/models/detectors/mvx_two_stage.py``: the
LiDAR path is exactly ``CenterPoint``; the class accepts the image-branch
fields so configs naming the generic detector build, and refuses an
image branch, which is not ported.
"""
from __future__ import annotations

from typing import Any

from ..builder import DETECTORS
from .centerpoint import CenterPoint


@DETECTORS.register_module()
class MVXTwoStageDetector(CenterPoint):

    def __init__(self, pts_fusion_layer: Any = None,
                 img_backbone: Any = None, img_neck: Any = None,
                 img_roi_head: Any = None, img_rpn_head: Any = None,
                 img_bbox_head: Any = None, pretrained: Any = None,
                 **kwargs):
        if img_backbone is not None or img_neck is not None:
            raise NotImplementedError("the image branch of "
                                      "MVXTwoStageDetector is not ported")
        super().__init__(**kwargs)


@DETECTORS.register_module()
class MVXFasterRCNN(MVXTwoStageDetector):
    """Config-name compatibility (reference mvx_faster_rcnn.py)."""
