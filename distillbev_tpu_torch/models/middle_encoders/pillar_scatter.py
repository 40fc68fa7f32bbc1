"""Scatter pillar features to a dense BEV canvas.

Counterpart of ``distillbev_tpu/models/middle_encoders/
pillar_scatter.py:PointPillarsScatter``.  A sample's voxel coords are
unique, so one row write per kept voxel builds the canvas; dropped voxels
go to a trash row that is cut off.  Returns NCHW, the port's layout for
the convolutions that follow (the JAX module returns NHWC).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..builder import MIDDLE_ENCODERS


@MIDDLE_ENCODERS.register_module()
class PointPillarsScatter(nn.Module):

    def __init__(self, in_channels: int = 64,
                 output_shape: Sequence[int] = (512, 512)):
        super().__init__()
        self.in_channels = in_channels
        self.ny, self.nx = (int(s) for s in output_shape)

    def forward(self, voxel_feats, coords, voxel_mask):
        """voxel_feats ``[B, V, C]``; coords ``[B, V, 3]`` (z, y, x);
        voxel_mask ``[B, V]`` -> canvas ``[B, C, ny, nx]``."""
        b, v, c = voxel_feats.shape
        cells = b * self.ny * self.nx
        batch_idx = torch.arange(b, device=coords.device)[:, None]
        flat = (batch_idx * self.ny + coords[..., 1].long()) * self.nx + \
            coords[..., 2].long()
        flat = torch.where(voxel_mask, flat, torch.full_like(flat, cells))
        canvas = voxel_feats.new_zeros(cells + 1, c)
        canvas[flat.reshape(-1)] = voxel_feats.reshape(-1, c)
        return canvas[:-1].reshape(b, self.ny, self.nx, c).permute(
            0, 3, 1, 2).contiguous()
