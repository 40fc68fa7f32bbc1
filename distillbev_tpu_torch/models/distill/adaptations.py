"""Adaptation layers of the feature distillation.

Counterpart of ``distillbev_tpu/models/distill/adaptations.py``: the
student's channel-wise adaptations (``1x1conv``, ``3x3conv``, ``mlp``,
``2layer``, ``3layer``, ``downsample_2layer``, the upsampling and pooling
variants, ``identity``) and the teacher's (``identity``, pools,
``avgpool_3layer``, ``downsample_3layer``).  Each carries the effective
``stride`` the field-of-view check of the distill detector reads (below
1 for upsampling).  NCHW; convolutions pad as flax's ``SAME`` unless the
JAX layer pads explicitly; upsampling is bilinear with
``align_corners=True``; pools are ``VALID``.  Torch needs the input
channels, which flax infers.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch.nn.functional as F
from torch import nn

from ..layers import BatchNorm


def _pad_same(x, k: int, s: int):
    """Pad ``x`` as flax's ``SAME`` does for a ``k``/``s`` conv."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((math.ceil(size / s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class _SameConv(nn.Conv2d):
    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        return super().forward(_pad_same(x, k, s))


class MlpAdapt(nn.Module):
    def __init__(self, in_channels: int, out_features: int,
                 hidden_features: Optional[int] = None):
        super().__init__()
        hidden = hidden_features or in_channels
        self.fc1 = nn.Conv2d(in_channels, hidden, 1)
        self.fc2 = nn.Conv2d(hidden, out_features, 1)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class _LayerStack(nn.Module):
    """``conv1`` (k, s) + BN + ReLU, then 1x1 convs + BN + ReLU: two
    layers (``TwoLayer``) or three (``ThreeLayer``)."""

    def __init__(self, in_channels: int, out_features: int, n_layers: int,
                 kernel_size: int = 4, stride: int = 4,
                 hidden_features: Optional[int] = None):
        super().__init__()
        hidden = hidden_features or in_channels
        chans = [in_channels] + [hidden] * (n_layers - 1) + [out_features]
        self.n_layers = n_layers
        for i in range(n_layers):
            k, s = (kernel_size, stride) if i == 0 else (1, 1)
            self.add_module(f"conv{i + 1}",
                            _SameConv(chans[i], chans[i + 1], k, s))
            self.add_module(f"norm{i + 1}", BatchNorm(chans[i + 1]))

    def forward(self, x):
        for i in range(1, self.n_layers + 1):
            x = F.relu(getattr(self, f"norm{i}")(getattr(self,
                                                         f"conv{i}")(x)))
        return x


def TwoLayer(in_channels, out_features, kernel_size=4, stride=4,
             hidden_features=None):
    return _LayerStack(in_channels, out_features, 2, kernel_size, stride,
                       hidden_features)


def ThreeLayer(in_channels, out_features, kernel_size=4, stride=4,
               hidden_features=None):
    return _LayerStack(in_channels, out_features, 3, kernel_size, stride,
                       hidden_features)


class StudentAdaptation(nn.Module):
    """One student channel-wise adaptation, selected by type string."""

    def __init__(self, adaptation_type: str, in_channels: int,
                 out_channels: int, params_cfg: Any = None):
        super().__init__()
        p = dict(params_cfg or {})
        t = self.adaptation_type = adaptation_type
        self.upsample = None
        self.pool = None
        if t in ("upsample_2layer", "upsample_3layer", "upsample_1x1conv",
                 "interpolate_1x1conv"):
            self.upsample = int(p.get("upsample_factor", 4))
        if t == "avgpool_1x1conv":
            self.pool = int(p.get("downsample_kernel_size", 4))
        if t == "identity":
            self.stride = 1.0
        elif t in ("1x1conv", "upsample_1x1conv", "interpolate_1x1conv",
                   "avgpool_1x1conv"):
            self.conv = nn.Conv2d(in_channels, out_channels, 1)
        elif t == "3x3conv":
            self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        elif t == "mlp":
            self.mlp = MlpAdapt(in_channels, out_channels)
        elif t in ("2layer", "upsample_2layer"):
            self.two = TwoLayer(in_channels, out_channels, 1, 1)
        elif t in ("3layer", "upsample_3layer"):
            self.three = ThreeLayer(in_channels, out_channels, 1, 1)
        elif t == "downsample_2layer":
            self.two = TwoLayer(in_channels, out_channels,
                                p.get("downsample_kernel_size", 4),
                                p.get("downsample_stride", 4))
        else:
            raise NotImplementedError(t)
        if t in ("1x1conv", "3x3conv", "mlp", "2layer", "3layer",
                 "identity"):
            self.stride = 1.0
        elif t == "downsample_2layer":
            self.stride = float(p.get("downsample_stride", 4))
        elif t in ("upsample_2layer", "upsample_3layer",
                   "upsample_1x1conv"):
            self.stride = float(p.get("stride", 1)) / float(
                p.get("upsample_factor", 4))
        elif t == "avgpool_1x1conv":
            self.stride = float(self.pool)
        else:                                   # interpolate_1x1conv
            self.stride = 1.0 / float(self.upsample)

    def forward(self, x):
        if self.adaptation_type == "identity":
            return x
        if self.upsample is not None:
            x = F.interpolate(x, scale_factor=self.upsample,
                              mode="bilinear", align_corners=True)
        if self.pool is not None:
            x = F.avg_pool2d(x, self.pool, self.pool)
        for name in ("conv", "mlp", "two", "three"):
            if hasattr(self, name):
                return getattr(self, name)(x)
        raise AssertionError(self.adaptation_type)


class TeacherAdaptation(nn.Module):
    """Teacher-side adaptation: identity, a pool, or a pool / strided
    conv followed by three conv layers."""

    def __init__(self, adaptation_type: str, in_channels: int,
                 out_channels: Optional[int] = None, params_cfg: Any = None):
        super().__init__()
        p = dict(params_cfg or {})
        t = self.adaptation_type = adaptation_type
        self.kernel, self.pool_stride = None, None
        if t == "identity":
            self.stride = 1.0
        elif t in ("avgpool", "maxpool", "avgpool_3layer"):
            self.kernel = int(p.get("kernel_size", 2))
            self.pool_stride = int(p.get("stride", self.kernel))
            self.stride = float(p.get("stride", p.get("kernel_size", 1)))
            if t == "avgpool_3layer":
                self.three = ThreeLayer(in_channels, out_channels, 1, 1)
        elif t == "downsample_3layer":
            self.three = ThreeLayer(in_channels, out_channels,
                                    p.get("kernel_size", 4),
                                    p.get("stride", 4))
            self.stride = float(p.get("stride", 4))
        else:
            raise NotImplementedError(t)

    def forward(self, x):
        t = self.adaptation_type
        if t == "identity":
            return x
        if self.kernel is not None:
            pool = F.avg_pool2d if t.startswith("avg") else F.max_pool2d
            x = pool(x, self.kernel, self.pool_stride)
        return self.three(x) if hasattr(self, "three") else x
