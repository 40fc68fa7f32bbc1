"""Image and BEV ResNet backbones (NCHW).

Counterpart of ``distillbev_tpu/models/backbones/resnet.py``.
``ResNet`` is the mmdet image backbone with the plain 7x7/s2 stem (the
JAX package's space-to-depth stem computes the same sums and is off by
default).  ``ResNetForBEVDet`` is the BEV-space ResNet whose first
block of each stage has a bare 3x3 conv shortcut.

Training knobs of ``ResNet``: ``frozen_stages=k`` takes the stem and
``layer1..layer k`` out of the gradient (``requires_grad=False``, as
mmdet), a ``norm_cfg`` with ``requires_grad=False`` freezes every
BatchNorm affine, and ``norm_eval=True`` keeps every BatchNorm of the
backbone in eval mode (running statistics) when the model trains, as
mmdet's ``ResNet.train``.  ``with_cp`` and ``pretrained`` are accepted
and change no number.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..builder import BACKBONES
from ..layers import BasicBlock, BatchNorm, Bottleneck, make_norm

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


@BACKBONES.register_module()
class ResNet(nn.Module):
    """``x [B, 3, H, W]`` -> tuple of the ``out_indices`` stage features.
    Submodules ``conv1``/``bn1``/``layer{i}.{j}`` as in mmdet."""

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 norm_cfg: Any = None, base_channels: int = 64,
                 frozen_stages: int = -1,
                 norm_eval: bool = False, style: str = "pytorch",
                 with_cp: bool = False, pretrained: Any = None,
                 init_cfg: Any = None):
        super().__init__()
        block_type, stage_blocks = ARCH_SETTINGS[depth]
        self.out_indices = tuple(out_indices)
        self.num_stages = num_stages
        self.conv1 = nn.Conv2d(3, base_channels, 7, 2, 3, bias=False)
        self.bn1 = make_norm(norm_cfg, base_channels)
        channels, in_ch = base_channels, base_channels
        for i, n_blocks in enumerate(stage_blocks[:num_stages]):
            blocks = []
            for j in range(n_blocks):
                s = strides[i] if j == 0 else 1
                if block_type == "bottleneck":
                    blocks.append(Bottleneck(in_ch, channels, stride=s,
                                             dilation=dilations[i],
                                             norm_cfg=norm_cfg))
                    in_ch = channels * 4
                else:
                    blocks.append(BasicBlock(in_ch, channels, stride=s,
                                             norm_cfg=norm_cfg))
                    in_ch = channels
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            channels *= 2
        if frozen_stages >= 0:
            self.conv1.requires_grad_(False)
            self.bn1.requires_grad_(False)
            for i in range(1, frozen_stages + 1):
                getattr(self, f"layer{i}").requires_grad_(False)
        self.norm_eval = norm_eval
        self.train(self.training)

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, BatchNorm):
                    m.eval()
        return self

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register_module()
class ResNetForBEVDet(nn.Module):
    """BEV ResNet of BasicBlocks, submodules ``layers.{i}.{j}``."""

    def __init__(self, numC_input: int = 64,
                 num_layer: Sequence[int] = (2, 2, 2),
                 num_channels: Optional[Sequence[int]] = None,
                 stride: Sequence[int] = (2, 2, 2),
                 backbone_output_ids: Optional[Sequence[int]] = None,
                 norm_cfg: Any = None, act_cfg: Any = "ReLU",
                 with_cp: bool = False, block_type: str = "Basic"):
        super().__init__()
        if block_type != "Basic":
            raise KeyError(f"block_type {block_type} is not in this slice")
        num_channels = list(num_channels) if num_channels else \
            [numC_input * 2 ** (i + 1) for i in range(len(num_layer))]
        self.out_ids = (list(backbone_output_ids)
                        if backbone_output_ids is not None
                        else list(range(len(num_layer))))
        stages, in_ch = [], numC_input
        for i, n in enumerate(num_layer):
            blocks = []
            for j in range(n):
                blocks.append(BasicBlock(
                    in_ch, num_channels[i],
                    stride=stride[i] if j == 0 else 1, norm_cfg=norm_cfg,
                    downsample=(j == 0), downsample_kernel=3,
                    downsample_norm=False))
                in_ch = num_channels[i]
            stages.append(nn.Sequential(*blocks))
        self.layers = nn.Sequential(*stages)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        outs = []
        for i, stage in enumerate(self.layers):
            x = stage(x)
            if i in self.out_ids:
                outs.append(x)
        return tuple(outs)
