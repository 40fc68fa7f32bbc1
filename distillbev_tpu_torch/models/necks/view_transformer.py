"""BEVDepth Lift-Splat-Shoot view transformer (camera -> BEV).

Counterpart of ``distillbev_tpu/models/necks/view_transformer.py``:
``LSSGeometry`` (depth-last frustum, fp32 geometry, truncating splat),
``SELikeModule``, ``ViewTransformerLSSBEVDepth`` and the depth
supervision ``depth_bce_loss``.  Convolutions run NCHW; the splat goes
through ``ops.bev_pool.bev_pool_batched``, whose kernels are the
hand-written ``scatter_add_rows_batched`` (forward) and ``gather_rows``
(backward).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..builder import NECKS, build_backbone
from ..layers import BatchNorm, ModulatedDeformConv
from ...ops.bev_pool import bev_pool_batched

DEFAULT_GRID = {"xbound": [-51.2, 51.2, 0.8], "ybound": [-51.2, 51.2, 0.8],
                "zbound": [-10.0, 10.0, 20.0], "dbound": [1.0, 60.0, 1.0]}
DEFAULT_DATA = {"input_size": (256, 704)}


def gen_dx_bx(xbound, ybound, zbound):
    dx = np.array([row[2] for row in [xbound, ybound, zbound]], np.float32)
    bx = np.array([row[0] + row[2] / 2.0
                   for row in [xbound, ybound, zbound]], np.float32)
    nx = np.array([round((row[1] - row[0]) / row[2])
                   for row in [xbound, ybound, zbound]], np.int64)
    return dx, bx, nx


class LSSGeometry:
    """Static geometry of the LSS transformers (numpy constants)."""

    def __init__(self, grid_config: Dict, data_config: Dict,
                 downsample: int):
        self.dx, self.bx, self.nx = gen_dx_bx(
            grid_config["xbound"], grid_config["ybound"],
            grid_config["zbound"])
        ogfH, ogfW = data_config["input_size"]
        self.fH, self.fW = ogfH // downsample, ogfW // downsample
        d0, d1, dd = grid_config["dbound"]
        self.ds = np.arange(d0, d1, dd, dtype=np.float32)
        self.D = len(self.ds)
        xs = np.linspace(0, ogfW - 1, self.fW, dtype=np.float32)
        ys = np.linspace(0, ogfH - 1, self.fH, dtype=np.float32)
        # depth-LAST: the lift product depth[..., None] * feat[..., None, :]
        # lands in [.., fH, fW, D, C], the splat's row order
        frustum = np.zeros((self.fH, self.fW, self.D, 3), np.float32)
        frustum[..., 0] = xs[None, :, None]
        frustum[..., 1] = ys[:, None, None]
        frustum[..., 2] = self.ds[None, None, :]
        self.frustum = frustum     # [fH, fW, D, 3] (u, v, d)

    def get_geometry(self, frustum, rots, trans, intrins, post_rots,
                     post_trans):
        """Ego-frame xyz of every frustum point, fp32.

        frustum: ``self.frustum`` as a tensor on the inputs' device.
        rots/intrins/post_rots ``[B, N, 3, 3]``; trans/post_trans
        ``[B, N, 3]`` -> ``[B, N, fH, fW, D, 3]``.
        """
        f32 = torch.float32
        pts = frustum.to(f32)[None, None] - post_trans.to(f32)[
            :, :, None, None, None, :]
        inv_post = torch.linalg.inv(post_rots.to(f32))
        pts = torch.einsum("bnij,bnhwdj->bnhwdi", inv_post, pts)
        pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], -1)
        combine = rots.to(f32) @ torch.linalg.inv(intrins.to(f32))
        pts = torch.einsum("bnij,bnhwdj->bnhwdi", combine, pts)
        return pts + trans.to(f32)[:, :, None, None, None, :]

    def splat(self, geom, volume):
        """geom ``[B, N, fH, fW, D, 3]``; volume ``[B, N, fH, fW, D, C]``
        -> ``[B, ny, nx, C]`` float32 (rows index y)."""
        b, c = geom.shape[0], volume.shape[-1]
        nx, ny, nz = (int(v) for v in self.nx)
        lo = [float(self.bx[i] - self.dx[i] / 2) for i in range(3)]
        # truncation toward zero, NOT floor (reference .long()): points
        # in the (-1, 0) band of an axis land in cell 0 and are kept
        ix = ((geom[..., 0] - lo[0]) / float(self.dx[0])).to(torch.int32)
        iy = ((geom[..., 1] - lo[1]) / float(self.dx[1])).to(torch.int32)
        iz = ((geom[..., 2] - lo[2]) / float(self.dx[2])).to(torch.int32)
        valid = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) &
                 (iz >= 0) & (iz < nz))
        p = int(np.prod(geom.shape[1:5]))
        return bev_pool_batched(volume.reshape(b, p, c),
                                (iy * nx + ix).reshape(b, p),
                                valid.reshape(b, p), ny, nx)


class SELikeModule(nn.Module):
    """Camera-parameter gate: ``input_conv`` and ``fc`` = (BN1d, Linear,
    Sigmoid), as the reference ``SELikeModule``."""

    def __init__(self, in_channels: int, feat_channel: int = 256,
                 intrinsic_channel: int = 33):
        super().__init__()
        self.input_conv = nn.Conv2d(in_channels, feat_channel, 1)
        self.fc = nn.Sequential(BatchNorm(intrinsic_channel),
                                nn.Linear(intrinsic_channel, feat_channel),
                                nn.Sigmoid())

    def forward(self, x, cam_params):
        y = self.input_conv(x)
        return y * self.fc(cam_params).to(y.dtype)[:, :, None, None]


@NECKS.register_module()
class ViewTransformerLSSBEVDepth(nn.Module):
    """BEVDepth transformer: SE-gated depth net (extra ResNet, DCNv2, BN,
    1x1 logits) + context featnet, lift and splat.

    ``forward((x, rots, trans, intrins, post_rots, post_trans))`` with x
    ``[B, N, C, fH, fW]`` returns the BEV map ``[B, C_trans, ny, nx]`` and
    the depth logits ``[B, N, fH, fW, D]`` (the JAX layout).
    """

    def __init__(self, grid_config: Any = None, data_config: Any = None,
                 numC_input: int = 512, numC_Trans: int = 64,
                 downsample: int = 16, accelerate: bool = True,
                 loss_depth_weight: float = 100.0,
                 extra_depth_net: Any = None, se_config: Any = None,
                 dcn_config: Any = None):
        super().__init__()
        self.grid_config = dict(grid_config or DEFAULT_GRID)
        self.loss_depth_weight = loss_depth_weight
        self.numC_Trans = numC_Trans
        self.geo = LSSGeometry(self.grid_config,
                               dict(data_config or DEFAULT_DATA),
                               downsample)
        self.D = self.geo.D
        self.register_buffer("frustum", torch.from_numpy(self.geo.frustum),
                             persistent=False)
        ed_cfg = dict(extra_depth_net or dict(
            type="ResNetForBEVDet", numC_input=256, num_layer=[3],
            num_channels=[256], stride=[1]))
        dch = ed_cfg["num_channels"][0]
        self.featnet = nn.Conv2d(numC_input, numC_Trans, 1)
        self.se = SELikeModule(numC_input, dch, intrinsic_channel=33)
        self.extra_depthnet = build_backbone({**ed_cfg, "numC_input": dch})
        # the reference's dcn_config defaults to dict(bias=True)
        dcn_bias = bool(dict(dcn_config or {}).get("bias", True))
        self.dcn = nn.Sequential(
            ModulatedDeformConv(dch, dch, 3, bias=dcn_bias), BatchNorm(dch))
        self.depthnet = nn.Conv2d(dch, self.D, 1)

    def forward(self, inputs) -> Tuple[torch.Tensor, torch.Tensor]:
        x, rots, trans, intrins, post_rots, post_trans = inputs[:6]
        b, n, c, fh, fw = x.shape
        xf = x.reshape(b * n, c, fh, fw)
        img_feat = self.featnet(xf)
        cam_params = torch.cat([
            intrins.reshape(b * n, -1), post_rots.reshape(b * n, -1),
            post_trans.reshape(b * n, -1), rots.reshape(b * n, -1),
            trans.reshape(b * n, -1)], dim=-1)
        depth_feat = self.se(xf, cam_params)
        depth_feat = self.extra_depthnet(depth_feat)[0]
        depth_logits = self.depthnet(self.dcn(depth_feat))
        depth = depth_logits.softmax(dim=1).permute(0, 2, 3, 1)
        geom = self.geo.get_geometry(self.frustum, rots, trans, intrins,
                                     post_rots, post_trans)
        feat = img_feat.permute(0, 2, 3, 1)
        volume = (depth[..., None] * feat[..., None, :]).reshape(
            b, n, fh, fw, self.D, self.numC_Trans)
        bev = self.geo.splat(geom, volume).to(img_feat.dtype)
        return (bev.permute(0, 3, 1, 2).contiguous(),
                depth_logits.permute(0, 2, 3, 1).reshape(b, n, fh, fw,
                                                         self.D))


def depth_bce_loss(depth_logits: torch.Tensor, depth_gt: torch.Tensor,
                   dbound: Sequence[float],
                   loss_weight: float = 100.0) -> torch.Tensor:
    """BCE between each depth bin's sigmoid and the one-hot LiDAR depth,
    pixels without a return masked out, reduced by a plain mean over every
    element (the masked ones included), as the JAX ``depth_bce_loss``.

    depth_logits ``[B, N, fH, fW, D]``; depth_gt ``[B, N, fH, fW]`` metric
    depth (0 = no return).
    """
    d = depth_logits.shape[-1]
    valid = depth_gt > 0
    idx = torch.floor((depth_gt - dbound[0]) / dbound[2])
    idx = idx.clamp(0, d - 1).long()
    onehot = torch.nn.functional.one_hot(idx, d).to(torch.float32)
    p = torch.sigmoid(depth_logits.to(torch.float32)).clamp(1e-6, 1 - 1e-6)
    bce = -(onehot * torch.log(p) + (1 - onehot) * torch.log(1 - p))
    bce = bce * valid[..., None]
    return loss_weight * bce.mean()
