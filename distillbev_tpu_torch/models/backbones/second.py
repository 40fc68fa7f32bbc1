"""SECOND BEV backbone (NCHW).

Counterpart of ``distillbev_tpu/models/backbones/second.py``: per stage a
strided 3x3 conv and ``layer_nums[i]`` 3x3 convs, each with BatchNorm and
ReLU, returning every stage's map.  Named as the reference state_dict:
``blocks.{i}`` is ``Sequential(Conv, BN, ReLU, ...)``.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch
from torch import nn

from ..builder import BACKBONES
from ..layers import make_norm


@BACKBONES.register_module()
class SECOND(nn.Module):

    def __init__(self, in_channels: int = 128,
                 out_channels: Sequence[int] = (128, 128, 256),
                 layer_nums: Sequence[int] = (3, 5, 5),
                 layer_strides: Sequence[int] = (2, 2, 2),
                 norm_cfg: Any = None, conv_cfg: Any = None):
        super().__init__()
        norm = norm_cfg or dict(type="BN")
        blocks, c = [], in_channels
        for ch, n, s in zip(out_channels, layer_nums, layer_strides):
            layers = []
            for j in range(n + 1):
                layers += [nn.Conv2d(c if j == 0 else ch, ch, 3,
                                     stride=s if j == 0 else 1, padding=1,
                                     bias=False),
                           make_norm(norm, ch), nn.ReLU(inplace=True)]
            blocks.append(nn.Sequential(*layers))
            c = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        outs = []
        for block in self.blocks:
            x = block(x)
            outs.append(x)
        return tuple(outs)
