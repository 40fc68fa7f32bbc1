"""BEVFormer attention modules (deformable family), batch-first.

Counterpart of ``distillbev_tpu/models/transformer/attention.py``:
``MSDeformableAttention3D``, ``SpatialCrossAttention`` (all cameras in
one sampling call over a fixed per-camera budget of the K queries with
the most projected hits, hit-count normalisation), ``TemporalSelfAttention``
(``num_bev_queue`` = 2: offsets conditioned on the previous BEV and the
query, the two queue outputs averaged), ``CustomMSDeformableAttention``
(decoder cross-attention), ``MultiheadAttention`` and ``FFN``.  The
sampling core is ``ops/ms_deform_attn.py``.

Submodule names follow the reference mmdet3d/mmcv state_dict.  The
sampling-offset Linear carries the JAX package's separate
``sampling_offsets_bias`` as its bias (``query @ W + b`` either way).
Dropout takes an explicit generator and is off without one.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..builder import ATTENTION
from ..layers import _lecun_normal_, dropout
from ...ops.ms_deform_attn import ms_deform_attn


def _grid_init(num_heads: int, num_levels: int, num_points: int
               ) -> np.ndarray:
    """Deformable-DETR sampling-offset bias init (flat ``[H*L*P*2]``)."""
    thetas = np.arange(num_heads, dtype=np.float32) * (
        2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(num_heads, 1, 1, 2),
                   (1, num_levels, num_points, 1))
    for i in range(num_points):
        grid[:, :, i] *= i + 1
    return grid.reshape(-1)


def _level_norm(spatial_shapes, ref: torch.Tensor) -> torch.Tensor:
    """``[L, 2]`` (w, h) per level."""
    return ref.new_tensor([[w, h] for h, w in spatial_shapes])


class _OffsetInit:
    """Zero sampling-offset weights and the grid bias (tiled once per
    BEV queue slot), as the JAX modules initialise them."""

    def init_extra(self, generator):
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(torch.from_numpy(np.tile(
                _grid_init(self.num_heads, self.num_levels,
                           self.num_points),
                getattr(self, "num_bev_queue", 1))))


@ATTENTION.register_module()
class MSDeformableAttention3D(nn.Module, _OffsetInit):
    """Deformable sampling over multi-level image features with
    ``Z`` projected reference points per query (``num_points // Z``
    points each)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 8):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        self.sampling_offsets = nn.Linear(
            embed_dims, num_heads * num_levels * num_points * 2)
        self.attention_weights = nn.Linear(
            embed_dims, num_heads * num_levels * num_points)
        self.value_proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, query, value, reference_points, spatial_shapes):
        """query ``[B', Q, C]``; value ``[B', sum(HW), C]``;
        reference_points ``[B', Q, Z, 2]`` -> ``[B', Q, C]``."""
        bsz, q, _ = query.shape
        nh, nl, npt = self.num_heads, self.num_levels, self.num_points
        value = self.value_proj(value).reshape(bsz, value.shape[1], nh, -1)
        offsets = self.sampling_offsets(query).reshape(bsz, q, nh, nl, npt,
                                                       2)
        weights = F.softmax(self.attention_weights(query).reshape(
            bsz, q, nh, nl * npt), dim=-1).reshape(bsz, q, nh, nl, npt)
        offsets = offsets / _level_norm(spatial_shapes, offsets)[
            None, None, None, :, None, :]
        z = reference_points.shape[2]
        offsets = offsets.reshape(bsz, q, nh, nl, npt // z, z, 2)
        locs = reference_points[:, :, None, None, None, :, :] + offsets
        return ms_deform_attn(value, spatial_shapes,
                              locs.reshape(bsz, q, nh, nl, npt, 2), weights)


@ATTENTION.register_module()
class SpatialCrossAttention(nn.Module):
    """Camera-aware cross attention from BEV queries to image features,
    over the fixed per-camera budget of ``budget`` queries."""

    def __init__(self, embed_dims: int = 256, num_cams: int = 6,
                 dropout: float = 0.1, deformable_attention=None,
                 max_queries_per_cam: Optional[int] = None):
        super().__init__()
        da_cfg = dict(deformable_attention or {})
        da_cfg.pop("type", None)
        self.deformable_attention = MSDeformableAttention3D(
            embed_dims=embed_dims, **{k: v for k, v in da_cfg.items()
                                      if k in ("num_heads", "num_levels",
                                               "num_points")})
        self.output_proj = nn.Linear(embed_dims, embed_dims)
        self.dropout = dropout
        self.max_queries_per_cam = max_queries_per_cam

    @staticmethod
    def budget(q: int, max_queries_per_cam: Optional[int] = None) -> int:
        """The per-camera query budget K (default 0.4 Q)."""
        k = max_queries_per_cam or max(2 * q // 5, 1)
        return min(k, q)

    @staticmethod
    def select(reference_points_cam, bev_mask, k: int):
        """Per camera, the ``k`` queries with the most projected hits,
        lower index first among ties (``jax.lax.top_k``'s order, from a
        stable descending sort).

        Returns (idx ``[N, B, K]``, sel_ref ``[N, B, K, D, 2]``, has_hit
        ``[N, B, K]`` bool, hit_count ``[B, Q]`` fp32)."""
        hits = bev_mask.sum(-1)                      # [N, B, Q]
        idx = torch.sort(hits, dim=-1, descending=True,
                         stable=True).indices[..., :k]
        sel_ref = torch.take_along_dim(reference_points_cam,
                                       idx[..., None, None], dim=2)
        has_hit = torch.take_along_dim(hits, idx, dim=2) > 0
        hit_count = (hits > 0).to(torch.float32).permute(1, 2, 0).sum(-1)
        return idx, sel_ref, has_hit, hit_count

    def forward(self, query, value, reference_points_cam, bev_mask,
                spatial_shapes, query_pos=None, residual=None,
                precomputed_select=None, generator=None):
        """query ``[B, Q, C]``; value ``[B, N_cam, sum(HW), C]``;
        reference_points_cam ``[N_cam, B, Q, D, 2]``; bev_mask ``[N_cam,
        B, Q, D]`` -> ``[B, Q, C]``."""
        inp_residual = query if residual is None else residual
        if query_pos is not None:
            query = query + query_pos
        bsz, q, c = query.shape
        n_cam = value.shape[1]
        d = reference_points_cam.shape[3]
        if precomputed_select is not None:
            idx, sel_ref, has_hit, hit_count = precomputed_select
        else:
            idx, sel_ref, has_hit, hit_count = self.select(
                reference_points_cam, bev_mask,
                self.budget(q, self.max_queries_per_cam))
        k = idx.shape[-1]
        sel_q = torch.take_along_dim(query[None], idx[..., None], dim=2)
        nb = n_cam * bsz
        out = self.deformable_attention(
            sel_q.reshape(nb, k, c),
            value.transpose(0, 1).reshape(nb, value.shape[2], c),
            sel_ref.reshape(nb, k, d, 2), spatial_shapes
        ).reshape(n_cam, bsz, k, c)
        out = torch.where(has_hit[..., None], out, out.new_zeros(()))
        # one index_add_ over all samples: flat slot b * Q + idx
        flat = (idx + q * torch.arange(bsz, device=idx.device)[:, None]
                ).reshape(-1)
        slots = out.new_zeros(bsz * q, c).index_add_(
            0, flat, out.reshape(-1, c)).reshape(bsz, q, c)
        slots = slots / hit_count.to(slots.dtype).clamp(min=1.0)[..., None]
        slots = dropout(self.output_proj(slots), self.dropout, generator)
        return slots + inp_residual


@ATTENTION.register_module()
class TemporalSelfAttention(nn.Module, _OffsetInit):
    """Deformable self-attention over the ``[prev_bev, current]`` value
    queue."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4,
                 num_bev_queue: int = 2, dropout: float = 0.1):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        self.num_bev_queue, self.dropout = num_bev_queue, dropout
        nq = num_bev_queue
        self.sampling_offsets = nn.Linear(
            embed_dims * nq, num_heads * nq * num_levels * num_points * 2)
        self.attention_weights = nn.Linear(
            embed_dims * nq, num_heads * nq * num_levels * num_points)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, query, value=None, identity=None, query_pos=None,
                reference_points=None, spatial_shapes=None,
                generator=None):
        """query ``[B, Q, C]``; value ``[B*2, Q, C]`` stacked (prev,
        current) or None (the query twice); reference_points ``[B, Q, 1,
        2]`` or ``[B*2, Q, 1, 2]``."""
        bsz, q, c = query.shape
        nq, nh = self.num_bev_queue, self.num_heads
        nl, npt = self.num_levels, self.num_points
        if value is None:
            value = torch.stack([query, query], dim=1).reshape(bsz * 2, q, c)
        if identity is None:
            identity = query
        if query_pos is not None:
            query = query + query_pos
        query_c = torch.cat([value[0::nq].reshape(bsz, q, c), query], -1)
        value = self.value_proj(value)
        offsets = self.sampling_offsets(query_c).reshape(
            bsz, q, nh, nq, nl, npt, 2)
        weights = F.softmax(self.attention_weights(query_c).reshape(
            bsz, q, nh, nq, nl * npt), dim=-1).reshape(
            bsz, q, nh, nq, nl, npt)
        # the queue axis folds into the batch
        weights = weights.permute(0, 3, 1, 2, 4, 5).reshape(
            bsz * nq, q, nh, nl, npt)
        offsets = offsets.permute(0, 3, 1, 2, 4, 5, 6).reshape(
            bsz * nq, q, nh, nl, npt, 2)
        if reference_points.shape[0] == bsz:
            ref = torch.stack([reference_points] * nq, dim=1).reshape(
                (bsz * nq,) + reference_points.shape[1:])
        else:
            ref = reference_points
        locs = ref[:, :, None, :, None, :] + offsets / _level_norm(
            spatial_shapes, offsets)[None, None, None, :, None, :]
        vh = value.reshape(bsz * nq, q, nh, -1)
        out = ms_deform_attn(vh, spatial_shapes, locs, weights)
        out = out.reshape(bsz, nq, q, self.embed_dims).mean(dim=1)
        out = dropout(self.output_proj(out), self.dropout, generator)
        return out + identity


@ATTENTION.register_module()
class CustomMSDeformableAttention(nn.Module, _OffsetInit):
    """Plain deformable attention (decoder cross-attention)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4,
                 dropout: float = 0.1):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        self.dropout = dropout
        self.sampling_offsets = nn.Linear(
            embed_dims, num_heads * num_levels * num_points * 2)
        self.attention_weights = nn.Linear(
            embed_dims, num_heads * num_levels * num_points)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, query, value, reference_points, spatial_shapes,
                query_pos=None, identity=None, generator=None):
        """query ``[B, Q, C]``; value ``[B, sum(HW), C]``;
        reference_points ``[B, Q, 2]`` or ``[B, Q, 4]``."""
        if identity is None:
            identity = query
        if query_pos is not None:
            query = query + query_pos
        bsz, q, _ = query.shape
        nh, nl, npt = self.num_heads, self.num_levels, self.num_points
        vh = self.value_proj(value).reshape(bsz, value.shape[1], nh, -1)
        offsets = self.sampling_offsets(query).reshape(bsz, q, nh, nl, npt,
                                                       2)
        weights = F.softmax(self.attention_weights(query).reshape(
            bsz, q, nh, nl * npt), dim=-1).reshape(bsz, q, nh, nl, npt)
        if reference_points.shape[-1] == 2:
            locs = reference_points[:, :, None, None, None, :] + \
                offsets / _level_norm(spatial_shapes, offsets)[
                    None, None, None, :, None, :]
        else:
            locs = reference_points[:, :, None, None, None, :2] + \
                offsets / npt * reference_points[:, :, None, None, None,
                                                 2:] * 0.5
        out = ms_deform_attn(vh, spatial_shapes, locs, weights)
        out = dropout(self.output_proj(out), self.dropout, generator)
        return out + identity


class _MHACore(nn.Module):
    """The parameters of ``nn.MultiheadAttention`` (mmcv wraps one as
    ``attn``): ``in_proj_weight [3E, E]``, ``in_proj_bias`` and
    ``out_proj``."""

    def __init__(self, embed_dims: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims,
                                                       embed_dims))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims))
        self.out_proj = nn.Linear(embed_dims, embed_dims)

    def init_extra(self, generator):
        with torch.no_grad():
            for w in self.in_proj_weight.chunk(3):
                _lecun_normal_(w, generator)
            self.in_proj_bias.zero_()


class MultiheadAttention(nn.Module):
    """Multi-head dot-product attention with residual (decoder
    self-attention), as flax's ``MultiHeadDotProductAttention``: the
    query scaled by ``head_dim ** -0.5``, softmax in fp32, dropout on
    the attention weights."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 dropout: float = 0.1):
        super().__init__()
        self.num_heads, self.dropout = num_heads, dropout
        self.attn = _MHACore(embed_dims)

    def forward(self, query, key=None, value=None, query_pos=None,
                key_pos=None, identity=None, generator=None):
        key = query if key is None else key
        value = key if value is None else value
        identity = query if identity is None else identity
        qq = query + query_pos if query_pos is not None else query
        kk = key + key_pos if key_pos is not None else key
        wq, wk, wv = self.attn.in_proj_weight.chunk(3)
        bq, bk, bv = self.attn.in_proj_bias.chunk(3)
        b, nq_, e = qq.shape
        h = self.num_heads

        def heads(x, w, bias):
            return F.linear(x, w, bias).reshape(b, x.shape[1], h, e // h)

        q = heads(qq, wq, bq) / math.sqrt(e // h)
        k = heads(kk, wk, bk)
        v = heads(value, wv, bv)
        attn = F.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        attn = dropout(attn, self.dropout, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, nq_, e)
        return self.attn.out_proj(out) + identity


class FFN(nn.Module):
    """fc1 -> ReLU -> dropout -> fc2 -> dropout, plus the residual;
    ``layers.0.0`` and ``layers.1`` as mmcv's FFN."""

    def __init__(self, embed_dims: int = 256,
                 feedforward_channels: int = 512, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(embed_dims, feedforward_channels)),
            nn.Linear(feedforward_channels, embed_dims))

    def forward(self, x, identity=None, generator=None):
        identity = x if identity is None else identity
        y = dropout(F.relu(self.layers[0][0](x)), self.dropout, generator)
        y = dropout(self.layers[1](y), self.dropout, generator)
        return y + identity
