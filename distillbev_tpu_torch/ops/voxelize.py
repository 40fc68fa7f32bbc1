"""Voxelization metadata: point -> voxel coords, the sorted-pillar view
and the unique-voxel map.

Counterpart of ``distillbev_tpu/ops/voxelize.py`` (``compute_voxel_coords``,
``sorted_voxel_info`` with its ``presorted`` branch,
``_segment_meta_compact`` and ``unique_voxels``): sort points by flat
voxel key, find segment starts, number the segments.  Overflow follows
the JAX package: voxels past ``max_voxels`` and points past
``max_points`` per voxel are dropped in sorted-key order.  Everything
stays on the points' device; counts are 0-d tensors, so nothing waits
on the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .segmented import (INT32_MAX, compact_flagged_rows,
                        position_in_segment, segment_ids_from_starts,
                        segment_starts, sort_by_key)


def grid_xyz(voxel_size: Sequence[float],
             point_cloud_range: Sequence[float]) -> Tuple[int, int, int]:
    """Voxel grid (gx, gy, gz) = floor((hi - lo) / size + 0.5), in fp32
    as the JAX package computes it."""
    vs = np.asarray(voxel_size, np.float32)
    lo = np.asarray(point_cloud_range[:3], np.float32)
    hi = np.asarray(point_cloud_range[3:], np.float32)
    g = np.floor((hi - lo) / vs + np.float32(0.5)).astype(np.int64)
    return int(g[0]), int(g[1]), int(g[2])


def compute_voxel_coords(points: torch.Tensor, voxel_size: Sequence[float],
                         point_cloud_range: Sequence[float]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point int32 voxel coords ``(z, y, x)`` and the in-grid mask:
    ``floor((p - lo) / size)``."""
    kw = dict(dtype=points.dtype, device=points.device)
    vs = torch.tensor(list(voxel_size), **kw)
    lo = torch.tensor(list(point_cloud_range[:3]), **kw)
    gx, gy, gz = grid_xyz(voxel_size, point_cloud_range)
    c = torch.floor((points[:, :3] - lo) / vs).to(torch.int32)
    valid = ((c[:, 0] >= 0) & (c[:, 0] < gx) & (c[:, 1] >= 0) &
             (c[:, 1] < gy) & (c[:, 2] >= 0) & (c[:, 2] < gz))
    return torch.stack([c[:, 2], c[:, 1], c[:, 0]], dim=-1), valid


class SortedVoxelInfo(NamedTuple):
    """Hard voxelization in sorted-point form (no ``[V, P, C]`` tensor).

    sorted_pts: ``[N, C]`` points sorted by flat voxel key.
    voxel_idx: ``[N]`` int32 segment id per sorted point (ascending;
        dropped rows carry ids >= max_voxels).
    slot: ``[N]`` int32 position within the voxel.
    keep: ``[N]`` bool, the hard-voxelized kept set.
    coords: ``[max_voxels, 3]`` int32 (z, y, x); -1 padding.
    num_points: ``[max_voxels]`` kept points per voxel.
    num_voxels: ``[]`` int32.
    start_rows: ``[max_voxels]`` first sorted row of each voxel (N past
        ``num_voxels``).
    """
    sorted_pts: torch.Tensor
    voxel_idx: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    coords: torch.Tensor
    num_points: torch.Tensor
    num_voxels: torch.Tensor
    start_rows: torch.Tensor


def _flat_key(coords: torch.Tensor, valid: torch.Tensor, gx: int,
              gy: int) -> torch.Tensor:
    key = (coords[:, 0] * gy + coords[:, 1]) * gx + coords[:, 2]
    return torch.where(valid, key, torch.full_like(key, INT32_MAX))


def sorted_voxel_info(points: torch.Tensor, valid_points: torch.Tensor,
                      voxel_size: Sequence[float],
                      point_cloud_range: Sequence[float], max_points: int,
                      max_voxels: int,
                      presorted: bool = False) -> SortedVoxelInfo:
    """Hard voxelization metadata of one sample's ``[N, C]`` points.

    ``presorted=True`` declares that the points arrive sorted ascending
    by flat voxel key with invalid rows last (``sort_points_by_pillar``);
    the sort is then skipped, with the same result."""
    n = points.shape[0]
    coords, in_range = compute_voxel_coords(points, voxel_size,
                                            point_cloud_range)
    gx, gy, _ = grid_xyz(voxel_size, point_cloud_range)
    key = _flat_key(coords, in_range & valid_points, gx, gy)
    if presorted:
        sorted_keys, sorted_pts = key, points
    else:
        sorted_keys, _, sorted_pts = sort_by_key(key, points)
    sorted_valid = sorted_keys != INT32_MAX
    sorted_coords, _ = compute_voxel_coords(sorted_pts, voxel_size,
                                            point_cloud_range)
    starts = (segment_starts(sorted_keys) & sorted_valid) | ~sorted_valid
    voxel_idx = segment_ids_from_starts(starts)
    slot = position_in_segment(starts)
    keep = sorted_valid & (voxel_idx < max_voxels) & (slot < max_points)
    num_voxels = (starts & sorted_valid & (voxel_idx < max_voxels)).sum(
        dtype=torch.int32)
    coords_meta, num_points, start_rows = _segment_meta_compact(
        sorted_keys, sorted_coords, max_voxels, n, max_points)
    return SortedVoxelInfo(sorted_pts, voxel_idx, slot, keep, coords_meta,
                           num_points, num_voxels, start_rows)


def _segment_meta_compact(sorted_keys: torch.Tensor,
                          sorted_coords: torch.Tensor, max_voxels: int,
                          n: int, max_points: Optional[int] = None):
    """``(coords [V, 3], num_points [V], start_rows [V])`` from the sorted
    keys: the v-th segment-start row is voxel v's start; its length runs
    to the next start (or the last valid row), capped at ``max_points``."""
    dev = sorted_keys.device
    sorted_valid = sorted_keys != INT32_MAX
    prev = torch.cat([sorted_keys[:1] - 1, sorted_keys[:-1]])
    real_start = (sorted_keys != prev) & sorted_valid
    num_segments = real_start.sum()
    n_valid = sorted_valid.sum()
    m = min(n, max_voxels + 1)
    cand = compact_flagged_rows(real_start, m)
    v = torch.arange(m, device=dev)
    in_seg = v < num_segments
    start_rows = torch.where(in_seg, cand, n)
    nxt = torch.cat([cand[1:], torch.full((1,), n, device=dev)])
    next_start = torch.where(v + 1 < num_segments, nxt, n_valid)
    seg_len = (next_start - cand).clamp(min=0)
    if max_points is not None:
        seg_len = seg_len.clamp(max=max_points)
    num_points = torch.where(in_seg, seg_len, 0).to(torch.int32)
    coords = torch.where(in_seg[:, None],
                         sorted_coords[cand.clamp(max=n - 1)],
                         torch.full((), -1, dtype=torch.int32, device=dev))
    start_rows = start_rows.to(torch.int32)
    if m < max_voxels:          # fewer points than voxels: pad
        pad = max_voxels - m
        coords = torch.cat([coords, torch.full((pad, 3), -1,
                                               dtype=torch.int32,
                                               device=dev)])
        num_points = torch.cat([num_points, torch.zeros(
            pad, dtype=torch.int32, device=dev)])
        start_rows = torch.cat([start_rows, torch.full(
            (pad,), n, dtype=torch.int32, device=dev)])
    return (coords[:max_voxels], num_points[:max_voxels],
            start_rows[:max_voxels])


def unique_voxels(coords: torch.Tensor, valid: torch.Tensor,
                  grid_size: Sequence[int], max_voxels: int):
    """Compact per-point voxel coords into unique voxels.

    Args:
        coords: ``[N, 3]`` int32 (z, y, x); valid: ``[N]`` bool.
        grid_size: (gz, gy, gx).

    Returns ``(point2voxel [N] int32 (max_voxels for dropped points),
    voxel_coords [max_voxels, 3] int32 (-1 padded), num_voxels [] int32)``.
    """
    _, gy, gx = (int(g) for g in grid_size)
    key = _flat_key(coords, valid, gx, gy)
    sorted_keys, order, sorted_valid = sort_by_key(key, valid)
    starts = (segment_starts(sorted_keys) & sorted_valid) | ~sorted_valid
    voxel_idx = segment_ids_from_starts(starts)
    kept = sorted_valid & (voxel_idx < max_voxels)
    voxel_idx = torch.where(kept, voxel_idx,
                            torch.full_like(voxel_idx, max_voxels))
    point2voxel = torch.empty_like(voxel_idx)
    point2voxel[order] = voxel_idx
    start_dst = torch.where(starts & kept, voxel_idx,
                            torch.full_like(voxel_idx, max_voxels))
    voxel_coords = torch.full((max_voxels + 1, 3), -1, dtype=torch.int32,
                              device=coords.device)
    # one start row per kept voxel; the trash row max_voxels is cut off
    voxel_coords[start_dst.long()] = coords[order].to(torch.int32)
    num_voxels = (starts & kept).sum(dtype=torch.int32)
    return point2voxel, voxel_coords[:-1], num_voxels
