"""Image FPN and BEV FPN necks (NCHW).

Counterpart of ``distillbev_tpu/models/necks/fpn.py``.
``FPN``: the mmdet FPN -- 1x1 laterals, nearest top-down add, 3x3
output convs, then extra levels: stride-2 subsampling of the last output,
or with ``add_extra_convs`` stride-2 3x3 convs (``fpn_convs.{i}`` past
the inputs, after a ReLU with ``relu_before_extra_convs``).
``FPNForBEVDet``: 1x1 laterals, nearest top-down add, 3x3 output convs on
the ``out_ids`` levels.  ``FPN_LSS``: bilinear (align_corners=True)
upsample of the deep level, concat with the shallow one, two 3x3
conv-BN-ReLU, then a 2x upsample, 3x3 conv-BN-ReLU and a 1x1 conv.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..builder import NECKS
from ..layers import ConvModule, make_norm


def _resize_to(x, hw):
    """Nearest resize to ``hw`` with source index ``i * h // th``."""
    _, _, h, w = x.shape
    th, tw = hw
    ry = torch.arange(th, device=x.device) * h // th
    rx = torch.arange(tw, device=x.device) * w // tw
    return x[:, :, ry][:, :, :, rx]


@NECKS.register_module()
class FPN(nn.Module):
    """Submodules ``lateral_convs.{i}.conv`` and ``fpn_convs.{i}.conv``
    (extra convs continue the ``fpn_convs`` numbering, as mmdet)."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 4,
                 start_level: int = 0, add_extra_convs: Any = False,
                 relu_before_extra_convs: bool = False,
                 norm_cfg: Any = None):
        super().__init__()
        self.start_level = start_level
        self.num_outs = num_outs
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        used = list(in_channels)[start_level:]
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, norm_cfg=norm_cfg, act=False)
            for c in used)
        n_extra = num_outs - len(used) if add_extra_convs else 0
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1,
                       norm_cfg=norm_cfg, act=False)
            for _ in range(len(used) + n_extra))
        for conv in list(self.fpn_convs)[len(used):]:
            conv.conv.stride = (2, 2)

    def forward(self, feats):
        laterals = [conv(feats[self.start_level + i])
                    for i, conv in enumerate(self.lateral_convs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _resize_to(
                laterals[i], laterals[i - 1].shape[2:])
        outs = [self.fpn_convs[i](laterals[i])
                for i in range(len(laterals))]
        source = outs[-1]
        for i in range(len(outs), self.num_outs):
            if not self.add_extra_convs:
                source = source[:, :, ::2, ::2]
            else:
                if self.relu_before_extra_convs:
                    source = F.relu(source)
                source = self.fpn_convs[i](source)
            outs.append(source)
        return tuple(outs)


@NECKS.register_module()
class FPNForBEVDet(nn.Module):
    """Submodules ``lateral_convs.{i}.conv`` and ``fpn_convs.{i}.conv``."""

    def __init__(self, in_channels: Sequence[int] = (1024, 2048),
                 out_channels: int = 512, num_outs: int = 1,
                 start_level: int = 0, end_level: int = -1,
                 out_ids: Sequence[int] = (0,), add_extra_convs: Any = False,
                 norm_cfg: Any = None):
        super().__init__()
        self.start_level = start_level
        self.out_ids = list(out_ids)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, act=False)
            for c in list(in_channels)[start_level:])
        self.fpn_convs = nn.ModuleDict({
            str(i): ConvModule(out_channels, out_channels, 3, padding=1,
                               act=False)
            for i in self.out_ids})

    def forward(self, feats):
        laterals = [conv(feats[self.start_level + i])
                    for i, conv in enumerate(self.lateral_convs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _resize_to(
                laterals[i], laterals[i - 1].shape[2:])
        outs = [self.fpn_convs[str(i)](laterals[i]) for i in self.out_ids]
        return outs[0] if len(outs) == 1 else tuple(outs)


@NECKS.register_module()
class FPN_LSS(nn.Module):
    """Submodules ``conv.{0,1,3,4}`` and ``up2.{1,2,4}`` as the reference
    ``lss_fpn.py`` Sequentials."""

    def __init__(self, in_channels: int = 640, out_channels: int = 256,
                 scale_factor: int = 4,
                 input_feature_index: Sequence[int] = (0, 2),
                 norm_cfg: Any = None, extra_upsample: Any = 2,
                 lateral: Any = None, extra_norm_act: bool = False):
        super().__init__()
        if lateral is not None or extra_norm_act:
            raise KeyError("FPN_LSS lateral / extra_norm_act are not in "
                           "this slice")
        self.scale_factor = scale_factor
        self.input_feature_index = tuple(input_feature_index)
        ch = out_channels * (2 if extra_upsample is not None else 1)
        self.conv = nn.Sequential(
            nn.Conv2d(in_channels, ch, 3, padding=1, bias=False),
            make_norm(norm_cfg, ch), nn.ReLU(),
            nn.Conv2d(ch, ch, 3, padding=1, bias=False),
            make_norm(norm_cfg, ch), nn.ReLU())
        self.up2 = None
        if extra_upsample is not None:
            self.up2 = nn.Sequential(
                nn.Upsample(scale_factor=int(extra_upsample),
                            mode="bilinear", align_corners=True),
                nn.Conv2d(ch, out_channels, 3, padding=1, bias=False),
                make_norm(norm_cfg, out_channels), nn.ReLU(),
                nn.Conv2d(out_channels, out_channels, 1))

    def forward(self, feats):
        x2 = feats[self.input_feature_index[0]]
        x1 = F.interpolate(feats[self.input_feature_index[1]],
                           scale_factor=self.scale_factor, mode="bilinear",
                           align_corners=True)
        x = self.conv(torch.cat([x2, x1], dim=1))
        return self.up2(x) if self.up2 is not None else x
