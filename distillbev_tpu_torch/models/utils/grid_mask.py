"""GridMask image augmentation with an explicit generator.

Counterpart of ``distillbev_tpu/models/utils/grid_mask.py:grid_mask``
(:22): a square grid of stripes of period ``d`` (random in ``[d_min,
max(min(H, W), d_min + 1))``) with random offsets, keeping the first
``l = clip(int(d * ratio + 0.5), 1, d - 1)`` rows and columns of each
period dark, applied with probability ``prob`` to the whole batch.  The
JAX function's ``rotate`` option is not ported: the BEVFormer recipe's
``rotate=1`` never rotates.  The draws come from a ``torch.Generator``,
so they differ from the JAX key's draws; the geometry is the same.
"""
from __future__ import annotations

import torch


def _randint(low: int, high: int, generator: torch.Generator) -> int:
    return int(torch.randint(low, high, (), generator=generator,
                             device=generator.device))


def grid_mask(generator: torch.Generator, imgs: torch.Tensor,
              ratio: float = 0.5, d_min: int = 2,
              prob: float = 0.7) -> torch.Tensor:
    """imgs ``[B, H, W, C]`` -> masked images."""
    _, h, w, _ = imgs.shape
    d_max = max(min(h, w), d_min + 1)
    d = _randint(d_min, d_max, generator)
    off_y = _randint(0, d_max, generator) % d
    off_x = _randint(0, d_max, generator) % d
    keep_len = min(max(int(d * ratio + 0.5), 1), d - 1)
    apply = float(torch.rand((), generator=generator,
                             device=generator.device)) < prob
    if not apply:
        return imgs
    ys = (torch.arange(h, device=imgs.device) + off_y) % d
    xs = (torch.arange(w, device=imgs.device) + off_x) % d
    mask = (ys[:, None] >= keep_len) | (xs[None, :] >= keep_len)
    return imgs * mask[None, :, :, None].to(imgs.dtype)
