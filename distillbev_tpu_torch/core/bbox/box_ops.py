"""Rotated BEV box operations, plain torch.

Counterpart of the rotated-IoU part of
``distillbev_tpu/core/bbox/box_jax_ops.py`` (box A's corners are clipped
by the four edges of box B with a fixed budget of 8 vertices per
polygon, all pairs at once, so the shapes are static) and of its
``points_in_rbbox_bev`` (:48), the distillation masks' point-in-box test.
"""
from __future__ import annotations

import torch

_MAX_VERTS = 8  # the intersection of two convex quads has <= 8 vertices


def _next_index(valid: torch.Tensor) -> torch.Tensor:
    """Index of each vertex's successor in a dense-packed polygon."""
    v = valid.shape[-1]
    idx = torch.arange(v, device=valid.device)
    n_valid = valid.sum(-1, keepdim=True)
    nxt = torch.where(idx == n_valid - 1, torch.zeros_like(idx), idx + 1)
    return nxt.clamp(0, v - 1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, :]`` (or ``x[..., idx]``) along the vertex axis."""
    if x.dim() == idx.dim():
        return torch.gather(x, -1, idx)
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape,
                                                    x.shape[-1]))


def _clip_polygon_halfplane(poly, valid, a, b):
    """Clip polygons ``poly [..., V, 2]`` (``valid [..., V]``) to the
    inside of the directed edges ``a -> b`` (``[..., 2]``)."""
    v = poly.shape[-2]
    edge = b - a
    rel = poly - a[..., None, :]
    side = edge[..., None, 0] * rel[..., 1] - edge[..., None, 1] * rel[..., 0]
    inside = (side >= 0) & valid
    nxt = _next_index(valid).expand_as(side)
    p_next = _take(poly, nxt)
    inside_next = _take(inside, nxt)
    side_next = _take(side, nxt)
    denom = side - side_next
    big = denom.abs() > 1e-12
    t = torch.where(big, side / torch.where(big, denom,
                                            torch.ones_like(denom)),
                    torch.zeros_like(denom))
    inter = poly + t[..., None] * (p_next - poly)
    crossing = (inside ^ inside_next) & valid
    # each vertex emits itself (if inside) and the edge crossing (if any)
    out_pts = torch.stack([poly, inter], dim=-2).reshape(
        *poly.shape[:-2], 2 * v, 2)
    out_ok = torch.stack([inside, crossing], dim=-1).reshape(
        *inside.shape[:-1], 2 * v)
    order = torch.sort((~out_ok).to(torch.uint8), dim=-1,
                       stable=True).indices[..., :v]
    return _take(out_pts, order), _take(out_ok, order)


def _polygon_area(poly, valid):
    """Shoelace area of dense-packed polygons with validity masks."""
    q = _take(poly, _next_index(valid).expand_as(valid))
    cross = poly[..., 0] * q[..., 1] - q[..., 0] * poly[..., 1]
    return 0.5 * torch.where(valid, cross,
                             torch.zeros_like(cross)).sum(-1).abs()


def _rect_corners(boxes):
    """``[..., 5]`` (cx, cy, dx, dy, yaw) -> 4 CCW corners ``[..., 4, 2]``."""
    local = boxes.new_tensor([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5],
                              [-0.5, 0.5]])
    local = local * boxes[..., None, 2:4]
    c = torch.cos(boxes[..., 4])[..., None]
    s = torch.sin(boxes[..., 4])[..., None]
    x = local[..., 0] * c - local[..., 1] * s + boxes[..., None, 0]
    y = local[..., 0] * s + local[..., 1] * c + boxes[..., None, 1]
    return torch.stack([x, y], dim=-1)


def rotated_overlaps_bev(boxes_a: torch.Tensor,
                         boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated intersection area ``[N, 5] x [M, 5] -> [N, M]``."""
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    quad_a = _rect_corners(boxes_a)
    quad_b = _rect_corners(boxes_b)
    poly = boxes_a.new_zeros(n, m, _MAX_VERTS, 2)
    poly[:, :, :4] = quad_a[:, None]
    valid = (torch.arange(_MAX_VERTS, device=boxes_a.device) < 4).expand(
        n, m, _MAX_VERTS)
    for i in range(4):
        poly, valid = _clip_polygon_halfplane(
            poly, valid, quad_b[None, :, i], quad_b[None, :, (i + 1) % 4])
    return _polygon_area(poly, valid)


def rotated_iou_bev(boxes_a: torch.Tensor,
                    boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated BEV IoU ``[N, 5] x [M, 5] -> [N, M]``."""
    inter = rotated_overlaps_bev(boxes_a, boxes_b)
    area_a = boxes_a[:, 2] * boxes_a[:, 3]
    area_b = boxes_b[:, 2] * boxes_b[:, 3]
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 1e-8, inter / union.clamp_min(1e-8),
                       torch.zeros_like(inter))


def points_in_rbbox_bev(points_xy: torch.Tensor,
                        boxes: torch.Tensor) -> torch.Tensor:
    """BEV membership ``[..., N, 2]`` points vs ``[..., M, 5|7+]`` rotated
    boxes (x, y, dx, dy, yaw or x, y, z, dx, dy, dz, yaw; z ignored) ->
    bool ``[..., N, M]``, as ``box_jax_ops.py:points_in_rbbox_bev``.  A
    box with a non-positive extent contains nothing."""
    if boxes.shape[-1] >= 7:
        ctr, dims, yaw = boxes[..., :2], boxes[..., 3:5], boxes[..., 6]
    else:
        ctr, dims, yaw = boxes[..., :2], boxes[..., 2:4], boxes[..., 4]
    rel = points_xy[..., :, None, :] - ctr[..., None, :, :]
    c = torch.cos(yaw)[..., None, :]
    s = torch.sin(yaw)[..., None, :]
    lx = rel[..., 0] * c + rel[..., 1] * s
    ly = -rel[..., 0] * s + rel[..., 1] * c
    valid = (dims > 0).all(dim=-1)[..., None, :]
    inside = (lx.abs() <= dims[..., None, :, 0] / 2) & \
        (ly.abs() <= dims[..., None, :, 1] / 2)
    return inside & valid
