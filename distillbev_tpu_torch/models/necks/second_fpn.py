"""SECONDFPN neck (NCHW): each stage to a common resolution, then concat.

Counterpart of ``distillbev_tpu/models/necks/second_fpn.py``.  As in the
reference, an upsample stride > 1 is a transposed conv (kernel = stride),
a stride < 1 a strided conv (kernel = stride = round(1 / s)), and a
stride of 1 a 1x1 conv when ``use_conv_for_no_stride``, else a 1x1
transposed conv (the same map; the JAX module always takes the conv).
Named as the reference state_dict: ``deblocks.{i}`` is
``Sequential(up, BN, ReLU)``.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ..builder import NECKS
from ..layers import make_norm


@NECKS.register_module()
class SECONDFPN(nn.Module):

    def __init__(self, in_channels: Sequence[int] = (128, 128, 256),
                 out_channels: Sequence[int] = (256, 256, 256),
                 upsample_strides: Sequence[float] = (1, 2, 4),
                 norm_cfg: Any = None, upsample_cfg: Any = None,
                 conv_cfg: Any = None, use_conv_for_no_stride: bool = False):
        super().__init__()
        norm = norm_cfg or dict(type="BN")
        self.transposed = []
        deblocks = []
        for cin, ch, st in zip(in_channels, out_channels, upsample_strides):
            if st > 1 or (st == 1 and not use_conv_for_no_stride):
                k = int(st)
                up = nn.ConvTranspose2d(cin, ch, k, stride=k, bias=False)
            else:
                k = int(round(1 / st))
                up = nn.Conv2d(cin, ch, k, stride=k, bias=False)
            self.transposed.append(isinstance(up, nn.ConvTranspose2d))
            deblocks.append(nn.Sequential(up, make_norm(norm, ch),
                                          nn.ReLU(inplace=True)))
        self.deblocks = nn.ModuleList(deblocks)

    def forward(self, feats):
        ups = [deblock(x) for deblock, x in zip(self.deblocks, feats)]
        return torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
