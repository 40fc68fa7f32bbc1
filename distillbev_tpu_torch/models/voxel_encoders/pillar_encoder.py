"""Pillar voxel-feature encoders, serving forward.

Counterpart of ``distillbev_tpu/models/voxel_encoders/pillar_encoder.py``:
``PFNLayer.sorted_call``, ``PillarFeatureNet.encode_sorted`` (the fused
sorted-pillar path, with ``legacy`` and ``virtual``) and
``DynamicPillarFeatureNet`` (with ``virtual``, which MVP uses).
Submodules are named as the reference mmdet3d state_dict:
``pfn_layers.{i}.linear`` / ``.norm`` for ``PillarFeatureNet`` and
``pfn_layers.{i}.0`` (Linear) / ``.1`` (BatchNorm) for
``DynamicPillarFeatureNet``.  BatchNorm runs in eval mode with running
statistics; a masked row's normalised value is 0, as the JAX masked
BatchNorm gives it.  Decorations follow the JAX package: raw features,
the offset from the pillar's point mean (3), the xy offset from the
pillar centre (2), optionally the distance.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..builder import VOXEL_ENCODERS
from ..layers import make_norm
from ...ops.scatter import scatter_reduce
from ...ops.segmented import capped_segment_reduce


def _decorated_channels(in_channels: int, with_cluster_center: bool,
                        with_voxel_center: bool, with_distance: bool) -> int:
    return in_channels + 3 * with_cluster_center + 2 * with_voxel_center + \
        int(with_distance)


def _relabel_virtual(feats: torch.Tensor) -> torch.Tensor:
    """MVP's flag channel (second to last): -1 (virtual) -> 1, else 0."""
    flag = (feats[:, -2] == -1).to(feats.dtype)
    return torch.cat([feats[:, :-2], flag[:, None], feats[:, -1:]], dim=1)


def _masked_bn(norm: nn.Module, x: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[:, None], norm(x), torch.zeros_like(x))


class PFNLayer(nn.Module):
    """Linear -> BatchNorm -> ReLU -> max (or mean) over each pillar's
    kept points, on sorted flat points."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm_cfg: Optional[dict] = None, last_layer: bool = True,
                 mode: str = "max"):
        super().__init__()
        self.units = out_channels if last_layer else out_channels // 2
        self.last_layer, self.mode = last_layer, mode
        self.linear = nn.Linear(in_channels, self.units, bias=False)
        self.norm = make_norm(norm_cfg or dict(type="BN1d"), self.units)

    def pad_floor(self, like: torch.Tensor) -> torch.Tensor:
        """relu(BN(0)) per channel: what an empty slot contributes to the
        reference's max-pool over all ``max_points`` slots."""
        return F.relu(self.norm(like.new_zeros(1, self.units)))[0]

    def sorted_call(self, feats, voxel_idx, keep, start_rows, cap: int,
                    num_segments: int, num_points=None):
        """feats ``[N, C]`` sorted by voxel, voxel_idx ``[N]`` contiguous
        segment ids, keep ``[N]``, start_rows ``[num_segments]``, cap =
        ``max_points``.  Returns ``[num_segments, units]`` (last layer) or
        the per-point concat ``[N, 2 * units]``."""
        x = F.relu(_masked_bn(self.norm, self.linear(feats), keep))
        reduce = "max" if self.mode == "max" else "sum"
        pooled = capped_segment_reduce(x, voxel_idx, start_rows, cap,
                                       num_segments, reduce=reduce,
                                       valid=keep)
        if self.mode != "max" and num_points is not None:
            pooled = pooled / num_points.clamp(min=1).to(pooled.dtype)[:,
                                                                        None]
        # the JAX package's eval-time parity with the reference, which
        # max-pools over all ``cap`` slots of a pillar, empty ones too
        if self.last_layer and self.mode == "max" and \
                num_points is not None:
            pooled = torch.where((num_points < cap)[:, None],
                                 torch.maximum(pooled, self.pad_floor(x)),
                                 pooled)
        if self.last_layer:
            return pooled
        idx = voxel_idx.clamp(max=num_segments - 1).long()
        return torch.cat([x, pooled[idx]], dim=-1)


@VOXEL_ENCODERS.register_module()
class PillarFeatureNet(nn.Module):
    """Hard-voxelized pillar encoder on the fused sorted-pillar path."""

    def __init__(self, in_channels: int = 4,
                 feat_channels: Sequence[int] = (64,),
                 with_distance: bool = False,
                 with_cluster_center: bool = True,
                 with_voxel_center: bool = True,
                 voxel_size: Sequence[float] = (0.2, 0.2, 4),
                 point_cloud_range: Sequence[float] = (0, -40, -3, 70.4, 40,
                                                       1),
                 norm_cfg: Any = None, mode: str = "max",
                 legacy: bool = True, virtual: bool = False):
        super().__init__()
        self.with_distance = with_distance
        self.with_cluster_center = with_cluster_center
        self.with_voxel_center = with_voxel_center
        self.voxel_size, self.point_cloud_range = voxel_size, \
            point_cloud_range
        self.legacy, self.virtual = legacy, virtual
        chans = [_decorated_channels(in_channels, with_cluster_center,
                                     with_voxel_center, with_distance)]
        chans += list(feat_channels)
        self.pfn_layers = nn.ModuleList(
            PFNLayer(chans[i], chans[i + 1], norm_cfg=norm_cfg,
                     last_layer=i == len(feat_channels) - 1, mode=mode)
            for i in range(len(feat_channels)))

    def encode_sorted(self, sorted_pts, voxel_idx, keep, coords,
                      num_points, start_rows, num_segments: int,
                      max_points: int, voxel_mask=None):
        """Fused pillar encoding from ``sorted_voxel_info`` rows (batch
        folded into the voxel ids).

        Args:
            sorted_pts: ``[N, C_in]`` points sorted by voxel key.
            voxel_idx: ``[N]`` ascending segment ids (>= num_segments
                drops); keep: ``[N]`` the kept points.
            coords: ``[num_segments, 3]`` (z, y, x); num_points and
                start_rows (first sorted row): ``[num_segments]``.
            voxel_mask: ``[num_segments]``; masked voxels give 0.

        Returns ``[num_segments, feat_channels[-1]]``.
        """
        cap = int(max_points)
        feats = _relabel_virtual(sorted_pts) if self.virtual else sorted_pts
        idx = voxel_idx.clamp(max=num_segments - 1).long()

        # the per-voxel values the points need, in one [V, 5] table read
        # with one gather
        per_voxel = []
        if self.with_cluster_center:
            sums = capped_segment_reduce(feats[:, :3], voxel_idx,
                                         start_rows, cap, num_segments,
                                         reduce="sum", valid=keep)
            per_voxel.append(sums / num_points.clamp(min=1).to(
                feats.dtype)[:, None])
        if self.with_voxel_center:
            vx, vy = self.voxel_size[0], self.voxel_size[1]
            x_off = vx / 2 + self.point_cloud_range[0]
            y_off = vy / 2 + self.point_cloud_range[1]
            per_voxel.append(torch.stack(
                [coords[:, 2].to(feats.dtype) * vx + x_off,
                 coords[:, 1].to(feats.dtype) * vy + y_off], dim=-1))
        gathered = torch.cat(per_voxel, dim=-1)[idx] if per_voxel else None

        decorations = [feats]
        col = 0
        if self.with_cluster_center:
            decorations.append(feats[:, :3] - gathered[:, :3])
            col = 3
        if self.with_voxel_center:
            f_center = torch.stack([feats[:, 0] - gathered[:, col],
                                    feats[:, 1] - gathered[:, col + 1]],
                                   dim=-1)
            if self.legacy:
                # the reference's legacy mode overwrites the raw xy with
                # the centre offsets in place (JAX pillar_encoder.py:191)
                feats = torch.cat([f_center, feats[:, 2:]], dim=-1)
                decorations[0] = feats
            decorations.append(f_center)
        if self.with_distance:
            decorations.append(torch.linalg.norm(feats[:, :3], dim=-1,
                                                 keepdim=True))
        x = torch.cat(decorations, dim=-1)
        x = torch.where(keep[:, None], x, torch.zeros_like(x))
        for layer in self.pfn_layers:
            x = layer.sorted_call(x, voxel_idx, keep, start_rows, cap,
                                  num_segments, num_points=num_points)
        if voxel_mask is not None:
            x = torch.where(voxel_mask[:, None], x, torch.zeros_like(x))
        return x


@VOXEL_ENCODERS.register_module()
class DynamicPillarFeatureNet(nn.Module):
    """Dynamic-voxelization pillar encoder: each point is decorated with
    its pillar's point mean (``scatter_reduce`` 'mean', the segmented
    scan) and the pillar-centre offset, runs the per-point PFN layers and
    is reduced per pillar with ``mode``."""

    def __init__(self, in_channels: int = 4,
                 feat_channels: Sequence[int] = (64,),
                 with_distance: bool = False,
                 with_cluster_center: bool = True,
                 with_voxel_center: bool = True,
                 voxel_size: Sequence[float] = (0.2, 0.2, 4),
                 point_cloud_range: Sequence[float] = (0, -40, -3, 70.4, 40,
                                                       1),
                 norm_cfg: Any = None, mode: str = "max",
                 virtual: bool = False):
        super().__init__()
        self.with_distance = with_distance
        self.with_cluster_center = with_cluster_center
        self.with_voxel_center = with_voxel_center
        self.voxel_size, self.point_cloud_range = voxel_size, \
            point_cloud_range
        self.mode, self.virtual = mode, virtual
        c_in = _decorated_channels(in_channels, with_cluster_center,
                                   with_voxel_center, with_distance)
        layers = []
        for i, ch in enumerate(feat_channels):
            layers.append(nn.Sequential(
                nn.Linear(c_in if i == 0 else 2 * feat_channels[i - 1], ch,
                          bias=False),
                make_norm(norm_cfg or dict(type="BN1d"), ch)))
        self.pfn_layers = nn.ModuleList(layers)

    def forward(self, points, point2voxel, coords, max_voxels: int,
                valid=None):
        """points ``[N, C_in]``; point2voxel ``[N]`` (``max_voxels`` for
        dropped points); coords ``[max_voxels, 3]`` (z, y, x) ->
        ``[max_voxels, C_out]``."""
        ok = point2voxel < max_voxels
        if valid is not None:
            ok = ok & valid
        feats = _relabel_virtual(points) if self.virtual else points
        idx = point2voxel.clamp(0, max_voxels - 1).long()
        decorations = [feats]
        if self.with_cluster_center:
            vmean = scatter_reduce(feats[:, :3], point2voxel, max_voxels,
                                   "mean")
            decorations.append(feats[:, :3] - vmean[idx])
        if self.with_voxel_center:
            vx, vy = self.voxel_size[0], self.voxel_size[1]
            x_off = vx / 2 + self.point_cloud_range[0]
            y_off = vy / 2 + self.point_cloud_range[1]
            cxy = coords[idx]
            decorations.append(torch.stack(
                [feats[:, 0] - (cxy[:, 2].to(feats.dtype) * vx + x_off),
                 feats[:, 1] - (cxy[:, 1].to(feats.dtype) * vy + y_off)],
                dim=-1))
        if self.with_distance:
            decorations.append(torch.linalg.norm(feats[:, :3], dim=-1,
                                                 keepdim=True))
        x = torch.cat(decorations, dim=-1)
        x = torch.where(ok[:, None], x, torch.zeros_like(x))
        for i, (linear, norm) in enumerate(self.pfn_layers):
            x = F.relu(_masked_bn(norm, linear(x), ok))
            if i < len(self.pfn_layers) - 1:
                vmax = scatter_reduce(x, point2voxel, max_voxels, "max")
                x = torch.cat([x, vmax[idx]], dim=-1)
        return scatter_reduce(x, point2voxel, max_voxels, self.mode)
