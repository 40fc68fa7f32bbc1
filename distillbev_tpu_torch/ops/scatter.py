"""Dynamic scatter: per-point -> per-voxel feature reduction.

Counterpart of ``distillbev_tpu/ops/scatter.py``: sort points by voxel,
reduce each voxel's run with ``ops/segmented.py`` (sum and mean through
the segmented-scan kernel, max through the running max), as a
``torch.autograd.Function`` with the JAX VJP: a gather of the voxel
gradient, divided by the voxel's count for 'mean', and given to every
point equal to the voxel max for 'max' (ties all receive it).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .segmented import segment_reduce_sorted, sort_by_key
from .voxelize import compute_voxel_coords, grid_xyz, unique_voxels


class ScatterOutput(NamedTuple):
    voxel_feats: torch.Tensor    # [max_voxels, C]
    voxel_coords: torch.Tensor   # [max_voxels, 3] (z, y, x), -1 padded
    point2voxel: torch.Tensor    # [N] voxel per point (max_voxels = drop)
    num_voxels: torch.Tensor     # [] int32


def _scatter_reduce_impl(feats, point2voxel, max_voxels, mode):
    valid = point2voxel < max_voxels
    sorted_keys, _, sorted_feats, sorted_valid = sort_by_key(
        point2voxel, feats, valid)
    return segment_reduce_sorted(sorted_feats, sorted_keys, max_voxels,
                                 reduce=mode, valid=sorted_valid)


class _ScatterReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, feats, point2voxel, max_voxels, mode):
        out = _scatter_reduce_impl(feats, point2voxel, max_voxels, mode)
        ctx.save_for_backward(feats, point2voxel, out)
        ctx.max_voxels, ctx.mode = max_voxels, mode
        return out

    @staticmethod
    def backward(ctx, g):
        feats, point2voxel, out = ctx.saved_tensors
        max_voxels = ctx.max_voxels
        valid = point2voxel < max_voxels
        idx = point2voxel.clamp(0, max_voxels - 1).long()
        g_pt = g[idx]
        if ctx.mode == "mean":
            ones = valid.to(torch.float32)[:, None]
            counts = _scatter_reduce_impl(ones, point2voxel, max_voxels,
                                          "sum")[:, 0]
            g_pt = g_pt / counts[idx].clamp(min=1.0)[:, None]
        elif ctx.mode == "max":
            g_pt = g_pt * (feats == out[idx]).to(g_pt.dtype)
        dx = torch.where(valid[:, None], g_pt, torch.zeros_like(g_pt))
        return dx.to(feats.dtype), None, None, None


def scatter_reduce(feats: torch.Tensor, point2voxel: torch.Tensor,
                   max_voxels: int, mode: str = "mean") -> torch.Tensor:
    """``[N, C]`` point features + ``[N]`` voxel ids -> ``[max_voxels, C]``
    float32 (mode 'sum' | 'mean' | 'max'; empty voxels 0);
    differentiable in ``feats``."""
    if mode not in ("sum", "mean", "max"):
        raise ValueError(f"unknown reduce {mode!r}")
    return _ScatterReduce.apply(feats, point2voxel, max_voxels, mode)


def dynamic_scatter(feats: torch.Tensor, points: torch.Tensor,
                    valid: torch.Tensor, voxel_size: Sequence[float],
                    point_cloud_range: Sequence[float], max_voxels: int,
                    mode: str = "mean") -> ScatterOutput:
    """Coords from raw ``points [N, 3+]``, dedup into at most
    ``max_voxels`` voxels, and the reduction of ``feats [N, C]``;
    ``valid [N]`` masks padding."""
    coords, in_range = compute_voxel_coords(points, voxel_size,
                                            point_cloud_range)
    gx, gy, gz = grid_xyz(voxel_size, point_cloud_range)
    point2voxel, voxel_coords, num_voxels = unique_voxels(
        coords, in_range & valid, (gz, gy, gx), max_voxels)
    voxel_feats = scatter_reduce(feats, point2voxel, max_voxels, mode)
    return ScatterOutput(voxel_feats, voxel_coords, point2voxel, num_voxels)
