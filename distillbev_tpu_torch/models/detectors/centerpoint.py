"""CenterPoint LiDAR detectors, serving forward (pillar and dynamic).

Counterpart of ``distillbev_tpu/models/detectors/centerpoint.py``:
``FeatureBundle``, ``CenterPoint`` on its fused sorted-pillar path
(``_extract_fused``) and ``DynamicCenterPoint`` (MVP is the same module
with ``DynamicPillarFeatureNet(virtual=True)`` over 17-dim points).
Inputs keep the JAX layout, ``points [B, N, C]`` padded with
``point_mask [B, N]``; the batch is folded into the voxel ids, so one
encoder call serves every sample.  The canvas, backbone and neck maps of
the bundle are NCHW; the head maps are the JAX layout (per-task dicts of
channels-last maps).  Submodules are named as the reference state_dict
(``pts_voxel_encoder``, ``pts_middle_encoder``, ``pts_backbone``,
``pts_neck``, ``pts_bbox_head``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..builder import (DETECTORS, build_backbone, build_head,
                       build_middle_encoder, build_neck, build_voxel_encoder)
from ...ops.voxelize import (SortedVoxelInfo, compute_voxel_coords,
                             grid_xyz, sorted_voxel_info, unique_voxels)


class FeatureBundle(NamedTuple):
    """Every intermediate the distillation engine can pair on (NCHW)."""
    canvas: Optional[torch.Tensor]                      # [B, C, ny, nx]
    backbone_feats: Optional[Tuple[torch.Tensor, ...]]  # SECOND stages
    neck_feat: torch.Tensor                             # [B, C, H, W]


class _PointsDetector(nn.Module):
    """The parts both teachers share: voxel encoder, scatter, SECOND,
    SECONDFPN, CenterHead."""

    def __init__(self, pts_voxel_layer, pts_voxel_encoder,
                 pts_middle_encoder, pts_backbone, pts_neck, pts_bbox_head,
                 train_cfg, test_cfg):
        super().__init__()
        self.pts_voxel_layer = dict(pts_voxel_layer or {})
        self.pts_voxel_encoder = build_voxel_encoder(dict(pts_voxel_encoder))
        self.pts_middle_encoder = build_middle_encoder(
            dict(pts_middle_encoder))
        self.pts_backbone = build_backbone(dict(pts_backbone))
        self.pts_neck = build_neck(dict(pts_neck))
        head_cfg = dict(pts_bbox_head)
        head_cfg.setdefault("train_cfg", (train_cfg or {}).get("pts"))
        head_cfg.setdefault("test_cfg", (test_cfg or {}).get("pts"))
        self.pts_bbox_head = build_head(head_cfg)

    def _grid(self):
        vl = self.pts_voxel_layer
        return tuple(vl["voxel_size"]), tuple(vl["point_cloud_range"])

    def _dense(self, canvas) -> FeatureBundle:
        feats = self.pts_backbone(canvas)
        return FeatureBundle(canvas, feats, self.pts_neck(feats))

    def forward(self, points, point_mask):
        """-> (per-task dicts of channels-last head maps, the bundle)."""
        bundle = self.extract_pts_feat(points, point_mask)
        return self.pts_bbox_head(bundle.neck_feat), bundle

    def get_bboxes(self, preds):
        return self.pts_bbox_head.get_bboxes(preds)


@DETECTORS.register_module()
class CenterPoint(_PointsDetector):
    """Hard-voxelization (pillar) CenterPoint on the fused path: the pillar
    encoder reduces the sorted points directly, with no ``[V, P, C]``
    voxel tensor.  ``presorted_points`` declares points sorted by pillar
    key (``sort_points_by_pillar``).  The unfused path and the JAX
    ``backbone_dtype`` cast are not ported."""

    def __init__(self, pts_voxel_layer: Any = None,
                 pts_voxel_encoder: Any = None,
                 pts_middle_encoder: Any = None, pts_backbone: Any = None,
                 pts_neck: Any = None, pts_bbox_head: Any = None,
                 train_cfg: Any = None, test_cfg: Any = None,
                 presorted_points: bool = False):
        super().__init__(pts_voxel_layer, pts_voxel_encoder,
                         pts_middle_encoder, pts_backbone, pts_neck,
                         pts_bbox_head, train_cfg, test_cfg)
        self.presorted_points = presorted_points

    def extract_pts_feat(self, points, point_mask) -> FeatureBundle:
        vs, pcr = self._grid()
        max_points = self.pts_voxel_layer["max_num_points"]
        v = self.pts_voxel_layer["max_voxels"]
        if isinstance(v, (tuple, list)):
            v = v[0]
        b, n, c = points.shape
        info = SortedVoxelInfo(*(torch.stack(parts) for parts in zip(*(
            sorted_voxel_info(points[i], point_mask[i], vs, pcr, max_points,
                              v, presorted=self.presorted_points)
            for i in range(b)))))
        dev = points.device
        # sample i's voxels are ids [i*v, (i+1)*v), its rows [i*n, (i+1)*n);
        # dropped rows and empty voxels go to the sentinels b*v and b*n
        off = torch.arange(b, dtype=torch.int32, device=dev)[:, None]
        vidx = torch.where(info.keep, info.voxel_idx + off * v,
                           torch.full_like(info.voxel_idx, b * v))
        start_rows = torch.where(info.start_rows < n,
                                 info.start_rows + off * n,
                                 torch.full_like(info.start_rows, b * n))
        voxel_mask = torch.arange(v, device=dev)[None, :] < \
            info.num_voxels[:, None]
        vf = self.pts_voxel_encoder.encode_sorted(
            info.sorted_pts.reshape(b * n, c), vidx.reshape(-1),
            info.keep.reshape(-1), info.coords.reshape(b * v, 3),
            info.num_points.reshape(-1), start_rows.reshape(-1), b * v,
            max_points, voxel_mask=voxel_mask.reshape(-1))
        return self._dense(self.pts_middle_encoder(vf.reshape(b, v, -1),
                                                   info.coords, voxel_mask))


@DETECTORS.register_module()
class DynamicCenterPoint(_PointsDetector):
    """Dynamic-voxelization CenterPoint: coords-only voxelization, unique
    voxels, the dynamic pillar encoder (``scatter_reduce``)."""

    def __init__(self, pts_voxel_layer: Any = None,
                 pts_voxel_encoder: Any = None,
                 pts_middle_encoder: Any = None, pts_backbone: Any = None,
                 pts_neck: Any = None, pts_bbox_head: Any = None,
                 train_cfg: Any = None, test_cfg: Any = None,
                 max_voxels: int = 32000):
        super().__init__(pts_voxel_layer, pts_voxel_encoder,
                         pts_middle_encoder, pts_backbone, pts_neck,
                         pts_bbox_head, train_cfg, test_cfg)
        self.max_voxels = max_voxels

    def extract_pts_feat(self, points, point_mask) -> FeatureBundle:
        vs, pcr = self._grid()
        gx, gy, gz = grid_xyz(vs, pcr)
        mv = self.max_voxels
        b, n, c = points.shape
        per_sample = []
        for i in range(b):
            coords, in_range = compute_voxel_coords(points[i], vs, pcr)
            per_sample.append(unique_voxels(coords, in_range & point_mask[i],
                                            (gz, gy, gx), mv))
        p2v, vcoords, nvox = (torch.stack(parts)
                              for parts in zip(*per_sample))
        off = torch.arange(b, dtype=torch.int32, device=points.device)[:,
                                                                       None]
        p2v_flat = torch.where(p2v < mv, p2v + off * mv,
                               torch.full_like(p2v, b * mv)).reshape(-1)
        vfeats = self.pts_voxel_encoder(
            points.reshape(b * n, c), p2v_flat, vcoords.reshape(b * mv, 3),
            b * mv, valid=point_mask.reshape(-1))
        voxel_mask = torch.arange(mv, device=points.device)[None, :] < \
            nvox[:, None]
        return self._dense(self.pts_middle_encoder(
            vfeats.reshape(b, mv, -1), vcoords, voxel_mask))
