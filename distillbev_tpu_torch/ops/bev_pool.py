"""Lift-splat BEV pooling.

Counterpart of ``distillbev_tpu/ops/bev_pool.py``:

* ``bev_pool_batched``: the per-sample scatter splat, on the row scatter
  kernel, as a ``torch.autograd.Function`` whose backward is the row
  gather kernel (``ops/gather_rows.py``).  The JAX splat takes it only
  while the per-sample canvas fits its 10 MiB VMEM budget; that gate is
  a TPU constraint, so on the card the view transformer's splat always
  comes here.
* ``bev_pool``: the generic sort path, sort by cell + segmented scan +
  read of each cell's last row (``ops/segmented.py``, whose scan is the
  segmented-scan kernel), as a ``torch.autograd.Function`` whose
  backward is the gather ``dx[i] = dout[cell[i]]``.
* ``lift_splat_pool``: geometry -> cell coords -> ``bev_pool``.

Both splats give the same canvas; they sum a cell's rows in another
order, so they agree to rounding.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .gather_rows import gather_rows
from .scatter_rows import scatter_add_rows_batched
from .segmented import segment_reduce_sorted, sort_by_key


class _BevPoolBatched(torch.autograd.Function):

    @staticmethod
    def forward(ctx, feats, cell, valid, h, w):
        bsz, _, c = feats.shape
        size = h * w
        # as ops/bev_pool.py:105: clip to the grid, then send invalid rows
        # past it so the kernel drops them
        ids = torch.where(valid, cell.clamp(0, size - 1),
                          torch.full_like(cell, size)).to(torch.int32)
        out = scatter_add_rows_batched(ids.contiguous(),
                                       feats.to(torch.float32).contiguous(),
                                       size)
        ctx.save_for_backward(ids)
        ctx.dtype = feats.dtype
        return out.reshape(bsz, h, w, c)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        bsz, p = ids.shape
        size = g.shape[1] * g.shape[2]
        # the JAX VJP (ops/bev_pool.py:116-123): cast to the feats dtype,
        # gather g[b, clip(cell)], zero where ~valid.  Over the flattened
        # [B * size, C] cotangent an invalid row (id == size) is sent past
        # the table, where the gather writes a zero row.
        g_flat = g.to(ctx.dtype).reshape(bsz * size, -1).contiguous()
        base = torch.arange(bsz, dtype=torch.int32,
                            device=ids.device)[:, None] * size
        idx = torch.where(ids < size, ids + base,
                          torch.full_like(ids, bsz * size))
        dx = gather_rows(g_flat, idx.reshape(-1))
        return dx.reshape(bsz, p, -1), None, None, None, None


def bev_pool_batched(feats: torch.Tensor, cell: torch.Tensor,
                     valid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Per-sample scatter-add splat.

    Args:
        feats: ``[B, P, C]`` frustum-point features (any float dtype).
        cell: ``[B, P]`` integer LOCAL cell ids (``y * w + x``).
        valid: ``[B, P]`` bool.
        h, w: per-sample grid.

    Returns ``[B, h, w, C]`` float32, summed in ascending point order;
    differentiable in ``feats``: the backward is the row gather
    ``dfeats[b, p] = g[b, cell[b, p]]`` (zero where invalid) of
    ``ops/gather_rows.py``.
    """
    return _BevPoolBatched.apply(feats, cell, valid, h, w)


def _flat_cell_index(coords: torch.Tensor, valid: torch.Tensor, b: int,
                     h: int, w: int) -> torch.Tensor:
    """coords ``[N, 3]`` = (batch, y, x) -> flat cell id; invalid ->
    ``b * h * w``."""
    flat = (coords[:, 0] * h + coords[:, 1]) * w + coords[:, 2]
    return torch.where(valid, flat, torch.full_like(flat, b * h * w))


class _BevPool(torch.autograd.Function):

    @staticmethod
    def forward(ctx, feats, coords, valid, b, h, w):
        cell = _flat_cell_index(coords, valid, b, h, w)
        sorted_keys, _, sorted_feats = sort_by_key(cell, feats)
        out = segment_reduce_sorted(sorted_feats, sorted_keys, b * h * w,
                                    reduce="sum")
        ctx.save_for_backward(cell, valid)
        ctx.size, ctx.dtype = b * h * w, feats.dtype
        return out.reshape(b, h, w, feats.shape[1])

    @staticmethod
    def backward(ctx, g):
        cell, valid = ctx.saved_tensors
        # cast before the [N, C] gather, as the JAX VJP does
        g_flat = g.to(ctx.dtype).reshape(ctx.size, -1)
        dx = g_flat[cell.clamp(0, ctx.size - 1).long()]
        dx = torch.where(valid[:, None], dx, torch.zeros_like(dx))
        return dx, None, None, None, None, None


def bev_pool(feats: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
             b: int, h: int, w: int) -> torch.Tensor:
    """Scatter-add point features into a BEV grid (the sort path).

    Args:
        feats: ``[N, C]`` per-point features (bf16 or fp32 reach the
            kernel as they are, other types as fp32).
        coords: ``[N, 3]`` int32 (batch_idx, y, x) grid coordinates.
        valid: ``[N]`` bool; False rows contribute nothing.
        b, h, w: grid dims.

    Returns ``[b, h, w, C]`` float32; differentiable in ``feats``.
    """
    return _BevPool.apply(feats, coords, valid, b, h, w)


def lift_splat_pool(feats: torch.Tensor, geom: torch.Tensor,
                    bev_start: Tuple[float, float],
                    bev_resolution: Tuple[float, float],
                    bev_shape: Tuple[int, int],
                    z_bounds: Tuple[float, float] = (-10.0, 10.0)
                    ) -> torch.Tensor:
    """Full splat step: geometry -> cell coords -> ``bev_pool``.

    Args:
        feats: ``[B, P, C]`` lifted features.
        geom: ``[B, P, 3]`` ego-frame xyz of each frustum point.
        bev_start: (x0, y0) of cell 0's lower corner.
        bev_resolution: (dx, dy) metres per cell.
        bev_shape: (H, W), H indexing y and W indexing x.
        z_bounds: points outside are dropped.

    Returns ``[B, H, W, C]`` float32.
    """
    bsz, p, c = feats.shape
    hh, ww = bev_shape
    ix = torch.floor((geom[..., 0] - bev_start[0]) / bev_resolution[0]
                     ).to(torch.int32)
    iy = torch.floor((geom[..., 1] - bev_start[1]) / bev_resolution[1]
                     ).to(torch.int32)
    valid = ((ix >= 0) & (ix < ww) & (iy >= 0) & (iy < hh) &
             (geom[..., 2] >= z_bounds[0]) & (geom[..., 2] < z_bounds[1]))
    batch_idx = torch.arange(bsz, dtype=torch.int32,
                             device=feats.device)[:, None].expand(bsz, p)
    coords = torch.stack([batch_idx.reshape(-1), iy.reshape(-1),
                          ix.reshape(-1)], dim=-1)
    return bev_pool(feats.reshape(bsz * p, c), coords, valid.reshape(-1),
                    bsz, hh, ww)
