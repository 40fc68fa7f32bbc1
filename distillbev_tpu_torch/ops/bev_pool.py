"""Lift-splat BEV pooling, per-sample scatter path (forward only).

Counterpart of ``distillbev_tpu/ops/bev_pool.py:bev_pool_batched``.  The
JAX splat takes this path only while the per-sample canvas fits its
VMEM budget; that gate is a TPU constraint, so on the card the splat
always comes here.  The generic sort path (``bev_pool``) and the
backward come with later slices.
"""
from __future__ import annotations

import torch

from .scatter_rows import scatter_add_rows_batched


def bev_pool_batched(feats: torch.Tensor, cell: torch.Tensor,
                     valid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Per-sample scatter-add splat.

    Args:
        feats: ``[B, P, C]`` frustum-point features (any float dtype).
        cell: ``[B, P]`` integer LOCAL cell ids (``y * w + x``).
        valid: ``[B, P]`` bool.
        h, w: per-sample grid.

    Returns ``[B, h, w, C]`` float32, summed in ascending point order.
    """
    bsz, _, c = feats.shape
    size = h * w
    # as ops/bev_pool.py:105: clip to the grid, then send invalid rows
    # past it so the kernel drops them
    ids = torch.where(valid, cell.clamp(0, size - 1),
                      torch.full_like(cell, size)).to(torch.int32)
    out = scatter_add_rows_batched(ids.contiguous(),
                                   feats.to(torch.float32).contiguous(),
                                   size)
    return out.reshape(bsz, h, w, c)
