"""Gaussian heatmap targets, computed on the device.

Counterpart of the device half of ``distillbev_tpu/core/gaussian.py``
(``gaussian_radius_jnp`` :70, ``gaussian_heatmap_dense`` :126,
``radius_jnp`` :193): every object's
gaussian is evaluated over the whole grid and reduced with a max over the
objects of each class, so the shapes are static and no patch is written
in place.
"""
from __future__ import annotations

import torch


def gaussian_radius(height, width, min_overlap: float = 0.5):
    """The smallest of the three CornerNet radii (reference
    ``gaussian.py:58-88``), elementwise over tensors."""
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0.0))) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 16 * c2, min=0.0))) / 8
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))) / (
        2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


def custom_radius(name: str, height, width, min_overlap: float = 0.5,
                  scale: float = 1.0):
    """The reference's custom radius functions (``gaussian.py:91-123``) by
    name, elementwise over tensors."""
    b1 = height + width
    if name in ("centerpoint1", "centerpoint_radius_func1"):
        c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
        return (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0.0))) / 2
    if name in ("centerpoint2", "centerpoint_radius_func2"):
        b2 = 2 * b1
        c2 = (1 - min_overlap) * width * height
        return (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 16 * c2,
                                            min=0.0))) / 8
    if name in ("centerpoint3", "centerpoint_radius_func3"):
        a3 = 4 * min_overlap
        b3 = -2 * min_overlap * b1
        c3 = (min_overlap - 1) * width * height
        return (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3,
                                            min=0.0))) / (2 * a3)
    if name in ("maxwh", "maxwh_radius_func"):
        return torch.maximum(height, width) * scale
    if name == "gaussian_radius":
        return gaussian_radius(height, width, min_overlap)
    raise NotImplementedError(name)


def gaussian_heatmap_dense(centers_xy: torch.Tensor, radii: torch.Tensor,
                           class_ids: torch.Tensor, valid: torch.Tensor,
                           num_classes: int, height: int, width: int,
                           k: float = 1.0) -> torch.Tensor:
    """Dense multi-object gaussian heatmap, batched.

    Args:
        centers_xy: ``[B, M, 2]`` float centres in pixels (x, y).
        radii: ``[B, M]`` radii (clamped to the minimum by the caller).
        class_ids: ``[B, M]`` class of each object.
        valid: ``[B, M]`` bool.
        num_classes, height, width: the output grid.

    Returns ``[B, num_classes, H, W]``, the max over each class's objects
    of their gaussians: sigma = (2 floor(r) + 1) / 6 around the
    floor-snapped centre, cut to the square of half-size floor(r) (the
    reference's patch draws, ``gaussian.py:25-55``).
    """
    dev = centers_xy.device
    grid_y = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    grid_x = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    r_int = torch.floor(radii).to(torch.int32)
    cx = torch.floor(centers_xy[..., 0]).to(torch.int32)
    cy = torch.floor(centers_xy[..., 1]).to(torch.int32)
    sigma = (2 * r_int + 1).to(torch.float32) / 6.0
    dx = grid_x - cx[..., None, None].to(torch.float32)   # [B, M, H, W]
    dy = grid_y - cy[..., None, None].to(torch.float32)
    g = torch.exp(-(dx * dx + dy * dy) /
                  (2.0 * sigma * sigma)[..., None, None]) * k
    r_f = r_int[..., None, None]
    inpatch = (dx.abs() <= r_f) & (dy.abs() <= r_f)
    ok = valid & (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height)
    g = torch.where(inpatch & ok[..., None, None], g, torch.zeros_like(g))
    onehot = torch.nn.functional.one_hot(class_ids.long(), num_classes).to(
        g.dtype)                                          # [B, M, K]
    return (g[:, :, None] * onehot[..., None, None]).amax(dim=1)

