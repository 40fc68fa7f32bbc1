"""BEVFormer encoder: TSA -> LN -> SCA -> LN -> FFN -> LN layers over the
BEV query grid.

Counterpart of ``distillbev_tpu/models/transformer/encoder.py``
(``get_reference_points_3d/2d``, fp32 ``point_sampling``,
``BEVFormerLayer``, ``BEVFormerEncoder``).  The SCA query selection
depends only on the frame geometry, so it runs once per frame and every
layer reuses it.  The layers run as a Python loop (the JAX
``scan_layers`` is a compile-size choice); ``with_cp`` and
``cp_save_attn`` are accepted and change no number.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..builder import TRANSFORMERS
from .attention import FFN, SpatialCrossAttention, TemporalSelfAttention


def get_reference_points_3d(h: int, w: int, z: float,
                            num_points_in_pillar: int) -> np.ndarray:
    """``[P, H*W, 3]`` normalised pillar reference points."""
    zs = np.linspace(0.5, z - 0.5, num_points_in_pillar) / z
    xs = np.linspace(0.5, w - 0.5, w) / w
    ys = np.linspace(0.5, h - 0.5, h) / h
    out = np.zeros((num_points_in_pillar, h, w, 3), np.float32)
    out[..., 0] = xs[None, None, :]
    out[..., 1] = ys[None, :, None]
    out[..., 2] = zs[:, None, None]
    return out.reshape(num_points_in_pillar, h * w, 3)


def get_reference_points_2d(h: int, w: int) -> np.ndarray:
    """``[H*W, 1, 2]`` normalised BEV-plane reference points."""
    ys, xs = np.meshgrid(np.linspace(0.5, h - 0.5, h) / h,
                         np.linspace(0.5, w - 0.5, w) / w, indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1)],
                    -1).reshape(h * w, 1, 2).astype(np.float32)


def point_sampling(ref_3d: torch.Tensor, pc_range: Sequence[float],
                   lidar2img: torch.Tensor, img_shape: Tuple[int, int]):
    """Project pillar reference points into each camera (fp32).

    ref_3d ``[P, Q, 3]`` normalised; lidar2img ``[B, N, 4, 4]`` ->
    reference_points_cam ``[N, B, Q, P, 2]``, bev_mask ``[N, B, Q, P]``.
    """
    pcr = [float(v) for v in pc_range]
    pts = ref_3d.to(torch.float32)
    xyz = torch.stack([pts[..., 0] * (pcr[3] - pcr[0]) + pcr[0],
                       pts[..., 1] * (pcr[4] - pcr[1]) + pcr[1],
                       pts[..., 2] * (pcr[5] - pcr[2]) + pcr[2]], dim=-1)
    hom = torch.cat([xyz, torch.ones_like(xyz[..., :1])], -1)
    cam = torch.einsum("bnij,pqj->bnpqi", lidar2img.to(torch.float32), hom)
    eps = 1e-5
    depth = cam[..., 2:3]
    mask = depth > eps
    uv = cam[..., 0:2] / torch.clamp(depth, min=eps)
    uv = uv / uv.new_tensor([img_shape[1], img_shape[0]])
    mask = (mask[..., 0] & (uv[..., 0] > 0.0) & (uv[..., 0] < 1.0) &
            (uv[..., 1] > 0.0) & (uv[..., 1] < 1.0))
    return uv.permute(1, 0, 3, 2, 4), mask.permute(1, 0, 3, 2)


class BEVFormerLayer(nn.Module):
    """One encoder layer: ``attentions.0`` (TSA) -> ``norms.0`` ->
    ``attentions.1`` (SCA) -> ``norms.1`` -> ``ffns.0`` -> ``norms.2``."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 feedforward_channels: int = 512, num_levels: int = 4,
                 num_points_sca: int = 8, num_points_tsa: int = 4,
                 dropout: float = 0.1, num_cams: int = 6,
                 max_queries_per_cam: Optional[int] = None):
        super().__init__()
        self.attentions = nn.ModuleList([
            TemporalSelfAttention(embed_dims=embed_dims, num_heads=num_heads,
                                  num_points=num_points_tsa,
                                  dropout=dropout),
            SpatialCrossAttention(
                embed_dims=embed_dims, num_cams=num_cams, dropout=dropout,
                deformable_attention=dict(num_heads=num_heads,
                                          num_levels=num_levels,
                                          num_points=num_points_sca),
                max_queries_per_cam=max_queries_per_cam)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels,
                                       dropout)])
        self.norms = nn.ModuleList([nn.LayerNorm(embed_dims, eps=1e-5)
                                    for _ in range(3)])

    def forward(self, query, value, prev_bev, ref_2d, ref_cam, bev_mask,
                bev_pos, spatial_shapes, bev_hw, shift=None,
                prev_valid=None, sca_select=None, init_query=None,
                generator=None):
        bsz, q, c = query.shape
        tsa_value = None
        tsa_ref = ref_2d
        if prev_bev is not None:
            pb = prev_bev.to(query.dtype)
            # the TSA value stack is [prev_bev, INITIAL bev query] for
            # every layer, as the reference builds it once per call
            q1 = init_query.to(query.dtype) if init_query is not None \
                else query
            if prev_valid is not None:
                has = (prev_valid > 0)[:, None, None]
                pb = torch.where(has, pb, query)
                q1 = torch.where(has, q1, query)
            tsa_value = torch.stack([pb, q1], dim=1).reshape(bsz * 2, q, c)
            if shift is not None:
                # the ego-motion shift moves the refs of both queue slots
                shifted = ref_2d + shift[:, None, None, :]
                tsa_ref = torch.stack([shifted, shifted], dim=1).reshape(
                    (bsz * 2,) + ref_2d.shape[1:])
        query = self.attentions[0](query, value=tsa_value,
                                   query_pos=bev_pos,
                                   reference_points=tsa_ref,
                                   spatial_shapes=(bev_hw,),
                                   generator=generator)
        query = self.norms[0](query)
        query = self.attentions[1](query, value, ref_cam, bev_mask,
                                   spatial_shapes,
                                   precomputed_select=sca_select,
                                   generator=generator)
        query = self.norms[1](query)
        query = self.ffns[0](query, generator=generator)
        return self.norms[2](query)


@TRANSFORMERS.register_module()
class BEVFormerEncoder(nn.Module):
    """``layers.{i}``: ``num_layers`` BEVFormerLayers."""

    def __init__(self, num_layers: int = 6, pc_range=None,
                 num_points_in_pillar: int = 4, embed_dims: int = 256,
                 num_heads: int = 8, feedforward_channels: int = 512,
                 num_levels: int = 4, num_cams: int = 6,
                 dropout: float = 0.1, return_intermediate: bool = False,
                 max_queries_per_cam: Optional[int] = None,
                 with_cp: bool = False, cp_save_attn: bool = True,
                 scan_layers: bool = False):
        super().__init__()
        self.pc_range = list(pc_range)
        self.num_points_in_pillar = num_points_in_pillar
        self.return_intermediate = return_intermediate
        self.max_queries_per_cam = max_queries_per_cam
        self.layers = nn.ModuleList([
            BEVFormerLayer(embed_dims=embed_dims, num_heads=num_heads,
                           feedforward_channels=feedforward_channels,
                           num_levels=num_levels, dropout=dropout,
                           num_cams=num_cams,
                           max_queries_per_cam=max_queries_per_cam)
            for _ in range(num_layers)])

    def sca_budget(self, q_total: int, sca_budget=None) -> int:
        """The SCA per-camera budget: an absolute count or (None) the
        layer default; clamped to Q."""
        if sca_budget is None:
            return SpatialCrossAttention.budget(q_total,
                                                self.max_queries_per_cam)
        if int(sca_budget) < 1:
            raise ValueError(f"sca_budget={sca_budget!r}: at least 1 query")
        return min(int(sca_budget), q_total)

    def forward(self, bev_query, value, bev_h: int, bev_w: int,
                bev_pos=None, prev_bev=None, lidar2img=None,
                img_shape=None, spatial_shapes=None, shift=None,
                prev_valid=None, sca_budget=None, generator=None):
        """bev_query ``[B, H*W, C]``; value ``[B, N_cam, sum(HW), C]``;
        lidar2img ``[B, N_cam, 4, 4]``."""
        dev = bev_query.device
        pcr = self.pc_range
        ref_3d = torch.from_numpy(get_reference_points_3d(
            bev_h, bev_w, pcr[5] - pcr[2], self.num_points_in_pillar)).to(dev)
        ref_2d = torch.from_numpy(get_reference_points_2d(bev_h, bev_w)).to(
            dev)
        ref_2d = ref_2d[None].expand((bev_query.shape[0],) + ref_2d.shape)
        ref_cam, bev_mask = point_sampling(ref_3d, pcr, lidar2img, img_shape)
        sca_select = SpatialCrossAttention.select(
            ref_cam, bev_mask, self.sca_budget(bev_query.shape[1],
                                               sca_budget))
        out = bev_query
        intermediate = []
        for layer in self.layers:
            out = layer(out, value, prev_bev, ref_2d, ref_cam, bev_mask,
                        bev_pos, spatial_shapes, (bev_h, bev_w), shift=shift,
                        prev_valid=prev_valid, sca_select=sca_select,
                        init_query=bev_query, generator=generator)
            if self.return_intermediate:
                intermediate.append(out)
        if self.return_intermediate:
            return torch.stack(intermediate)
        return out
