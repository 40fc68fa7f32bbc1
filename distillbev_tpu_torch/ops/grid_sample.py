"""Bilinear grid sampling, channels-last, zero padding outside.

Counterpart of ``distillbev_tpu/ops/grid_sample.py``: four corner
gathers over the flattened spatial axis, each corner zeroed when it
falls outside the image.  Used by the temporal BEV warp
(``BEVDepth4D.shift_feature``) and the deformable conv.
"""
from __future__ import annotations

import torch


def bilinear_sample_pixels(img: torch.Tensor, px: torch.Tensor,
                           py: torch.Tensor) -> torch.Tensor:
    """Sample ``img [B, H, W, C]`` at pixel coords ``px, py [B, h, w]``.

    Returns ``[B, h, w, C]``.  The caller maps normalised grids to pixel
    coordinates per its align_corners choice.
    """
    b, h, w, c = img.shape
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    lx = (px - x0).to(img.dtype)
    ly = (py - y0).to(img.dtype)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat_img = img.reshape(b, h * w, c)

    def corner(yi, xi):
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        flat = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = torch.gather(flat_img, 1,
                         flat.reshape(b, -1, 1).expand(-1, -1, c))
        v = v.reshape(flat.shape + (c,))
        return torch.where(ok[..., None], v, v.new_zeros(()))

    return (corner(y0i, x0i) * ((1 - lx) * (1 - ly))[..., None] +
            corner(y0i, x0i + 1) * (lx * (1 - ly))[..., None] +
            corner(y0i + 1, x0i) * ((1 - lx) * ly)[..., None] +
            corner(y0i + 1, x0i + 1) * (lx * ly)[..., None])


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = True) -> torch.Tensor:
    """torch-convention grid sample, channels-last.

    img ``[B, H, W, C]``; grid ``[B, h, w, 2]`` normalised (x, y) in
    [-1, 1].  Returns ``[B, h, w, C]``.
    """
    b, h, w, c = img.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        px = (gx + 1) * 0.5 * (w - 1)
        py = (gy + 1) * 0.5 * (h - 1)
    else:
        px = ((gx + 1) * w - 1) * 0.5
        py = ((gy + 1) * h - 1) * 0.5
    return bilinear_sample_pixels(img, px, py)
