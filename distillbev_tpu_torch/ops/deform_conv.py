"""Modulated deformable convolution v2 (DCNv2), plain torch.

Counterpart of ``distillbev_tpu/ops/deform_conv.py``, which is XLA and
not a Pallas kernel.  The K = kh*kw sampling locations of every output
pixel go through the shared bilinear sampler, the mask multiplies the
samples, and the conv is one ``[B*Ho*Wo, K*C] x [K*C, C_out]`` product.
The JAX package's dense separable-lerp path computes the same sums for
small grids; this port keeps the gather form only.
"""
from __future__ import annotations

from typing import Optional

import torch

from .grid_sample import bilinear_sample_pixels


def modulated_deform_conv2d(x: torch.Tensor,
                            offset: torch.Tensor,
                            mask: torch.Tensor,
                            weight: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            stride: int = 1,
                            dilation: int = 1) -> torch.Tensor:
    """DCNv2 forward, JAX layouts.

    Args:
        x: ``[B, H, W, C]`` input.
        offset: ``[B, Ho, Wo, 2*K]`` offsets, tap-major (dy, dx) pairs in
            row-major kernel order (mmcv channel layout).
        mask: ``[B, Ho, Wo, K]`` modulation (already sigmoided).
        weight: ``[kh, kw, C, C_out]``.
        bias: optional ``[C_out]``.

    Returns ``[B, Ho, Wo, C_out]``.
    """
    b, h, w, c = x.shape
    kh, kw, _, c_out = weight.shape
    k = kh * kw
    _, ho, wo, _ = offset.shape
    pad_h = (kh - 1) * dilation // 2
    pad_w = (kw - 1) * dilation // 2
    dev = x.device
    f32 = torch.float32
    # sampling coordinates stay fp32 whatever the feature dtype
    oy = torch.arange(ho, dtype=f32, device=dev) * stride - pad_h
    ox = torch.arange(wo, dtype=f32, device=dev) * stride - pad_w
    ty = torch.arange(kh, dtype=f32, device=dev).repeat_interleave(kw) \
        * dilation
    tx = torch.arange(kw, dtype=f32, device=dev).repeat(kh) * dilation
    off = offset.reshape(b, ho, wo, k, 2).to(f32)
    py = oy[None, :, None, None] + ty[None, None, None, :] + off[..., 0]
    px = ox[None, None, :, None] + tx[None, None, None, :] + off[..., 1]
    samples = bilinear_sample_pixels(x, px.reshape(b, ho, wo * k),
                                     py.reshape(b, ho, wo * k))
    samples = samples.reshape(b, ho, wo, k, c) * mask[..., None]
    out = samples.reshape(b * ho * wo, k * c) @ weight.reshape(k * c,
                                                               c_out)
    out = out.reshape(b, ho, wo, c_out).to(x.dtype)
    if bias is not None:
        out = out + bias
    return out
