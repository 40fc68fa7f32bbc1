"""Distillation masks, computed on the device.

Counterpart of ``distillbev_tpu/models/distill/masks.py``:
``bev_pixel_coords`` (:31), ``foreground_scale_mask`` (:49),
``spatial_attention`` (:165), ``channel_attention`` (:173) and
``resize_mask`` (:181).  Feature maps are NCHW; masks are ``[B, H, W]``
with rows indexing y.  The foreground test is
``core/bbox/box_ops.py:points_in_rbbox_bev`` over padded GT arrays, so
nothing leaves the device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ...core.bbox.box_ops import points_in_rbbox_bev


def bev_pixel_coords(h: int, w: int, voxel_size, pc_range,
                     out_size_factor: int, center_offset: float = 0.0,
                     device=None) -> torch.Tensor:
    """``[H * W, 2]`` metric (x, y) of the BEV pixels, row-major (row =
    y): the pixel corner at ``center_offset = 0`` (the CNN distiller), the
    cell centre at 0.5."""
    xs = (torch.arange(w, dtype=torch.float32, device=device) +
          center_offset) * voxel_size[0] * out_size_factor + pc_range[0]
    ys = (torch.arange(h, dtype=torch.float32, device=device) +
          center_offset) * voxel_size[1] * out_size_factor + pc_range[1]
    return torch.stack([xs[None, :].expand(h, w).reshape(-1),
                        ys[:, None].expand(h, w).reshape(-1)], dim=-1)


def _first_owner(inside: torch.Tensor) -> torch.Tensor:
    """Index of the lowest box containing each pixel (0 where none):
    ``inside [B, HW, M]`` -> ``[B, HW]``."""
    m = inside.shape[-1]
    rank = m - torch.arange(m, device=inside.device)
    return torch.argmax(torch.where(inside, rank, torch.zeros_like(rank)),
                        dim=-1)


def foreground_scale_mask(gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                          h: int, w: int, voxel_size, pc_range, grid_size,
                          avg_fg_scale_mask: bool = False,
                          context_length: float = 0.0,
                          context_weight: float = 0.0,
                          center_offset: float = 0.0,
                          transpose: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Foreground, foreground-scale and background-scale masks.

    gt_boxes ``[B, M, 7+]`` (x, y, z, dx, dy, dz, yaw, ...); gt_mask
    ``[B, M]``.  Returns fg_mask, fg_scale, bg_scale, each ``[B, H, W]``
    fp32.  A pixel inside several boxes takes the scale of the lowest
    index among them (the reference's first-occurrence rule);
    ``fg_scale = sqrt(cell area / box area)``, or ``1 / #fg`` with
    ``avg_fg_scale_mask``; ``bg_scale = 1 / #bg``.  ``transpose`` is the
    reference's ``transpose_mask`` (square grids only).
    """
    if grid_size[0] % w:
        raise ValueError(f"grid {grid_size[0]} is not a multiple of {w}")
    osf = grid_size[0] // w
    coords = bev_pixel_coords(h, w, voxel_size, pc_range, osf,
                              center_offset, device=gt_boxes.device)
    cell_area = voxel_size[0] * voxel_size[1] * osf * osf
    b, m = gt_mask.shape
    bev_boxes = torch.cat([gt_boxes[..., 0:2], gt_boxes[..., 3:5],
                           gt_boxes[..., 6:7]], dim=-1)
    bev_boxes = torch.where(gt_mask[..., None], bev_boxes,
                            torch.zeros_like(bev_boxes))
    inside = points_in_rbbox_bev(coords, bev_boxes)          # [B, HW, M]
    fg = inside.any(dim=-1)
    first = _first_owner(inside)
    zero = torch.zeros((), dtype=torch.float32, device=gt_boxes.device)
    area = torch.clamp(gt_boxes[..., 3] * gt_boxes[..., 4], min=1e-6)
    if avg_fg_scale_mask:
        n_fg = torch.clamp(fg.sum(-1, keepdim=True), min=1)
        fg_scale = torch.where(fg, 1.0 / n_fg, zero)
    else:
        fg_scale = torch.where(
            fg, torch.sqrt(cell_area / torch.gather(area, 1, first)), zero)
    fg_f = fg.to(torch.float32)
    if context_length > 0 and context_weight > 0:
        ext = voxel_size[0] * osf * context_length
        big = bev_boxes.clone()
        big[..., 2:4] += torch.where(gt_mask[..., None], ext, zero)
        inside_big = points_in_rbbox_bev(coords, big)
        fg_big = inside_big.any(dim=-1)
        fg_f = torch.maximum(fg_f, fg_big.to(torch.float32) *
                             context_weight)
        # context pixels take cell area / box area, without the root
        fg_scale = torch.where(fg_big, cell_area / torch.gather(
            area, 1, _first_owner(inside_big)), fg_scale)
    n_bg = torch.clamp(h * w - (fg_f != 0).sum(-1, keepdim=True), min=1)
    bg_scale = torch.ones(b, h * w, device=gt_boxes.device) / n_bg
    out = tuple(t.reshape(b, h, w) for t in (fg_f, fg_scale, bg_scale))
    if transpose:
        if h != w:
            raise ValueError("transpose_mask=True needs a square BEV grid")
        out = tuple(t.transpose(1, 2) for t in out)
    return out


def spatial_attention(feat: torch.Tensor, t: float) -> torch.Tensor:
    """``softmax(mean_c |feat| / T)`` over the pixels, times H * W:
    ``[B, C, H, W]`` -> ``[B, H, W]``, without gradient."""
    b, _, h, w = feat.shape
    a = feat.detach().abs().mean(dim=1).reshape(b, h * w)
    return (torch.softmax(a / t, dim=-1) * (h * w)).reshape(b, h, w)


def channel_attention(feat: torch.Tensor, t: float) -> torch.Tensor:
    """``softmax(mean_hw |feat| / T)`` over the channels, times C:
    ``[B, C, H, W]`` -> ``[B, C]``, without gradient."""
    a = feat.detach().abs().mean(dim=(2, 3))
    return torch.softmax(a / t, dim=-1) * feat.shape[1]


def resize_mask(m: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """Max-pool down or repeat up a ``[B, H, W]`` mask to ``target_hw``
    (integer factors)."""
    b, h, w = m.shape
    th, tw = target_hw
    if (h, w) == (th, tw):
        return m
    if h > th:
        if h % th or w % tw:
            raise ValueError(f"cannot pool {(h, w)} to {target_hw}")
        return m.reshape(b, th, h // th, tw, w // tw).amax(dim=(2, 4))
    if th % h or tw % w:
        raise ValueError(f"cannot repeat {(h, w)} to {target_hw}")
    return m.repeat_interleave(th // h, 1).repeat_interleave(tw // w, 2)
