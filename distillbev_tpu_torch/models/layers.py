"""Common building blocks of the serving slice (NCHW inside).

Counterpart of ``distillbev_tpu/models/layers.py``.  Submodule names
follow the reference mmcv/mmdet state_dict (``conv``/``bn``,
``conv1``/``bn1``, ``downsample.0``/``downsample.1``), so a reference
checkpoint and ``utils/convert.py`` address the same tensors.  BatchNorm
is the eval-mode form with running statistics (the BEVFormer recipe
trains with ``norm_eval=True``); batch statistics come with the distill
train step.  ``dropout`` draws its mask from an explicit generator.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.deform_conv import modulated_deform_conv2d

_BN_TYPES = ("BN", "BN1d", "BN2d", "SyncBN", "naiveSyncBN1d",
             "naiveSyncBN2d", "SyncBatchNorm")


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over dim 1 (``[N, C]`` or ``[N, C, H, W]``)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=self.eps)


def make_norm(norm_cfg: Optional[dict], num_features: int) -> BatchNorm:
    """BatchNorm from an mmcv-style norm_cfg (the BN family only);
    ``requires_grad=False`` freezes its affine parameters."""
    cfg = dict(norm_cfg or dict(type="BN"))
    if cfg.get("type", "BN") not in _BN_TYPES:
        raise KeyError(f"norm type {cfg['type']} is not in this slice")
    bn = BatchNorm(num_features, eps=cfg.get("eps", 1e-5))
    bn.requires_grad_(cfg.get("requires_grad", True))
    return bn


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout whose mask comes from ``generator`` (on ``x``'s
    device); the identity when ``generator`` is None or ``p`` is 0."""
    if generator is None or p == 0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) >= p
    return x * keep / (1.0 - p)


class ConvModule(nn.Module):
    """Conv2d (+ BN) (+ ReLU), named ``conv``/``bn`` as mmcv's
    ConvModule."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, padding: int = 0,
                 norm_cfg: Optional[dict] = None, act: bool = True):
        super().__init__()
        # bias only without a norm, as mmcv's ConvModule
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              padding=padding, bias=norm_cfg is None)
        self.bn = make_norm(norm_cfg, out_channels) \
            if norm_cfg is not None else None
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.act else x


class BasicBlock(nn.Module):
    """ResNet BasicBlock.  The shortcut is either the mmdet 1x1 conv + BN
    (``downsample.0``/``.1``) or ResNetForBEVDet's bare 3x3 conv with
    bias (``downsample``), as in the JAX block."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 downsample: bool = False, norm_cfg=None,
                 downsample_kernel: int = 1, downsample_norm: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, channels, 3, stride, 1,
                               bias=False)
        self.bn1 = make_norm(norm_cfg, channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, 1, 1, bias=False)
        self.bn2 = make_norm(norm_cfg, channels)
        self.downsample = None
        if downsample or stride != 1 or in_channels != channels:
            k = downsample_kernel
            conv = nn.Conv2d(in_channels, channels, k, stride, k // 2,
                             bias=not downsample_norm)
            self.downsample = nn.Sequential(
                conv, make_norm(norm_cfg, channels)) \
                if downsample_norm else conv

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    """ResNet Bottleneck, mmdet 'pytorch' style (stride on the 3x3)."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 dilation: int = 1, norm_cfg=None):
        super().__init__()
        out_ch = channels * 4
        self.conv1 = nn.Conv2d(in_channels, channels, 1, bias=False)
        self.bn1 = make_norm(norm_cfg, channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, stride, dilation,
                               dilation=dilation, bias=False)
        self.bn2 = make_norm(norm_cfg, channels)
        self.conv3 = nn.Conv2d(channels, out_ch, 1, bias=False)
        self.bn3 = make_norm(norm_cfg, out_ch)
        self.downsample = None
        if stride != 1 or in_channels != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out_ch, 1, stride, bias=False),
                make_norm(norm_cfg, out_ch))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + identity)


class ModulatedDeformConv(nn.Module):
    """DCNv2 as mmcv's ModulatedDeformConv2dPack: ``conv_offset``
    predicts 3K channels; the first 2K are tap-major (dy, dx) offsets and
    the last K the mask logits (JAX ``layers.py:231-237``).  NCHW in and
    out; the sampling itself is ``ops.deform_conv`` (channels-last)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 bias: bool = True):
        super().__init__()
        k = kernel_size
        self.stride, self.dilation = stride, dilation
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias \
            else None
        self.conv_offset = nn.Conv2d(
            in_channels, 3 * k * k, k, stride=stride,
            padding=(k - 1) * dilation // 2, dilation=dilation)

    def init_extra(self, generator):
        # mmcv zero-initialises the offset conv: offsets 0, mask 0.5
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def forward(self, x):
        taps = self.weight.shape[2] * self.weight.shape[3]
        off = self.conv_offset(x).permute(0, 2, 3, 1)
        y = modulated_deform_conv2d(
            x.permute(0, 2, 3, 1), off[..., :2 * taps],
            torch.sigmoid(off[..., 2 * taps:]),
            self.weight.permute(2, 3, 1, 0), self.bias,
            stride=self.stride, dilation=self.dilation)
        return y.permute(0, 3, 1, 2)


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator,
                   fan_in: Optional[int] = None):
    fan_in = fan_in or w[0].numel()
    w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(fan_in))


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator):
    """Seeded random init with the JAX package's defaults: LeCun-normal
    conv/deconv/linear/DCN weights, zero biases, identity BatchNorm and
    LayerNorm.  Modules with an ``init_extra(generator)`` hook then apply
    their own rule (zero DCN offsets, the heatmap prior bias, embeddings,
    the deformable-attention offset grid)."""
    for m in module.modules():
        if isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear,
                            ModulatedDeformConv)):
            w = m.weight
            # a transposed conv's weight is [in, out, kh, kw]: its fan-in
            # is in * kh * kw, as flax counts it for [kh, kw, in, out]
            _lecun_normal_(w, generator, w.shape[0] * w[0, 0].numel()
                           if isinstance(m, nn.ConvTranspose2d) else None)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    for m in module.modules():
        if hasattr(m, "init_extra"):
            m.init_extra(generator)
