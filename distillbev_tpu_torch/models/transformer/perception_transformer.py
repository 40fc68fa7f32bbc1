"""PerceptionTransformer: BEV feature construction + detection decoding.

Counterpart of ``distillbev_tpu/models/transformer/perception_transformer.py``
(``rotate_bev`` :29, ``PerceptionTransformer``): the can-bus MLP, the
ego-motion shift of the previous BEV's reference points, the rotation of
the previous BEV, the camera and level embeddings, then the encoder and
the decoder.  Feature levels arrive channels-last, ``[B, N_cam, H_l,
W_l, C]``, as in the JAX package.  The teacher's
``DeformableDetrTransformerDistill`` is not ported yet.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..builder import TRANSFORMERS
from .decoder import DetectionTransformerDecoder
from .encoder import BEVFormerEncoder
from ...ops.grid_sample import grid_sample


def rotate_bev(bev: torch.Tensor, angle_deg: torch.Tensor) -> torch.Tensor:
    """Rotate ``[B, H, W, C]`` BEV maps around their centres by
    ``angle_deg [B]`` (counter-clockwise in the image, as torchvision)."""
    b, h, w, _ = bev.shape
    ang = -angle_deg * math.pi / 180.0
    cos, sin = torch.cos(ang), torch.sin(ang)
    ys = torch.linspace(-1.0, 1.0, h, device=bev.device)
    xs = torch.linspace(-1.0, 1.0, w, device=bev.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    gx2 = cos[:, None, None] * gx[None] - sin[:, None, None] * gy[None]
    gy2 = sin[:, None, None] * gx[None] + cos[:, None, None] * gy[None]
    return grid_sample(bev, torch.stack([gx2, gy2], dim=-1),
                       align_corners=True)


@TRANSFORMERS.register_module()
class PerceptionTransformer(nn.Module):
    """Submodules ``encoder``, ``decoder``, ``reference_points``,
    ``can_bus_mlp.{0,2,norm}``; parameters ``level_embeds``,
    ``cams_embeds``."""

    def __init__(self, embed_dims: int = 256, num_cams: int = 6,
                 num_feature_levels: int = 4, rotate_prev_bev: bool = True,
                 use_shift: bool = True, use_can_bus: bool = True,
                 use_cams_embeds: bool = True, rotate_center=(100, 100),
                 encoder=None, decoder=None, can_bus_dims: int = 18):
        super().__init__()
        self.rotate_prev_bev = rotate_prev_bev
        self.use_shift, self.use_can_bus = use_shift, use_can_bus
        self.use_cams_embeds = use_cams_embeds
        enc = dict(encoder or {})
        enc.pop("type", None)
        dec = dict(decoder or {})
        dec.pop("type", None)
        self.encoder = BEVFormerEncoder(**enc)
        self.decoder = DetectionTransformerDecoder(**dec)
        self.level_embeds = nn.Parameter(torch.zeros(num_feature_levels,
                                                     embed_dims))
        self.cams_embeds = nn.Parameter(torch.zeros(num_cams, embed_dims))
        self.reference_points = nn.Linear(embed_dims, 3)
        self.can_bus_mlp = nn.Sequential(
            nn.Linear(can_bus_dims, embed_dims // 2), nn.ReLU(),
            nn.Linear(embed_dims // 2, embed_dims), nn.ReLU())
        self.can_bus_mlp.add_module("norm", nn.LayerNorm(embed_dims,
                                                         eps=1e-5))

    def init_extra(self, generator):
        with torch.no_grad():
            for p in (self.level_embeds, self.cams_embeds):
                p.copy_(torch.randn(p.shape, generator=generator))

    def forward(self, mlvl_feats, bev_queries, object_query_embed,
                bev_h: int, bev_w: int, grid_length=(0.512, 0.512),
                bev_pos=None, prev_bev=None, can_bus=None, lidar2img=None,
                img_shape=None, only_bev: bool = False, prev_valid=None,
                sca_budget=None, generator=None):
        """mlvl_feats: list of ``[B, N_cam, H_l, W_l, C]``; bev_queries
        ``[H*W, C]``; object_query_embed ``[Q, 2C]``; can_bus ``[B, 18]``;
        lidar2img ``[B, N_cam, 4, 4]``.  Returns bev_embed, or (bev_embed,
        hs, init_reference, inter_references)."""
        bsz = mlvl_feats[0].shape[0]
        bev_query = bev_queries[None].expand((bsz,) + bev_queries.shape)
        if can_bus is not None:
            delta_x, delta_y = can_bus[:, 0], can_bus[:, 1]
            ego_angle = can_bus[:, -2] / math.pi * 180.0
            tl = torch.sqrt(delta_x ** 2 + delta_y ** 2)
            ta = torch.atan2(delta_y, delta_x) / math.pi * 180.0
            bev_angle = ego_angle - ta
            shift_y = tl * torch.cos(bev_angle / 180 * math.pi) / \
                grid_length[0] / bev_h
            shift_x = tl * torch.sin(bev_angle / 180 * math.pi) / \
                grid_length[1] / bev_w
            shift = torch.stack([shift_x, shift_y], -1) * float(
                self.use_shift)
        else:
            shift = bev_query.new_zeros(bsz, 2)

        if prev_bev is not None and self.rotate_prev_bev and \
                can_bus is not None:
            pb = rotate_bev(prev_bev.reshape(bsz, bev_h, bev_w, -1),
                            can_bus[:, -1])
            prev_bev = pb.reshape(bsz, bev_h * bev_w, -1).to(bev_query.dtype)
        elif prev_bev is not None:
            prev_bev = prev_bev.to(bev_query.dtype)

        if self.use_can_bus and can_bus is not None:
            bev_query = bev_query + self.can_bus_mlp(can_bus)[:, None, :]

        flat, shapes = [], []
        for lvl, feat in enumerate(mlvl_feats):
            b, n, h, w, c = feat.shape
            f = feat.reshape(b, n, h * w, c)
            if self.use_cams_embeds:
                f = f + self.cams_embeds[None, :, None, :]
            flat.append(f + self.level_embeds[None, None, None, lvl])
            shapes.append((h, w))
        value = torch.cat(flat, dim=2)

        bev_embed = self.encoder(
            bev_query, value, bev_h, bev_w, bev_pos=bev_pos,
            prev_bev=prev_bev, lidar2img=lidar2img, img_shape=img_shape,
            spatial_shapes=tuple(shapes), shift=shift, prev_valid=prev_valid,
            sca_budget=sca_budget, generator=generator)
        if only_bev:
            return bev_embed

        query_pos, query = torch.split(object_query_embed,
                                       object_query_embed.shape[-1] // 2,
                                       dim=-1)
        query_pos = query_pos[None].expand((bsz,) + query_pos.shape)
        query = query[None].expand((bsz,) + query.shape)
        reference_points = torch.sigmoid(self.reference_points(query_pos))
        inter_states, inter_refs = self.decoder(
            query, bev_embed, query_pos, reference_points, ((bev_h, bev_w),),
            generator=generator)
        return bev_embed, inter_states, reference_points, inter_refs
