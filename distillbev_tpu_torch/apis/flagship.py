"""Flagship configs and the serving student at the reference's sizes.

Counterpart of ``distillbev_tpu/apis/flagship.py``: the same config
factories (CenterPoint-pillar teacher, BEVDepth4D-R50 distill student),
the camera part of ``make_example_batch`` as torch tensors, and
``build_flagship_student``, the student-only counterpart of
``build_flagship``: a ``BEVDepth4D`` built from the distill cfg's model
block with a seeded random init.  The teacher, points and GT of the
train batch come with the training slice.
"""
from __future__ import annotations

import copy
from typing import Tuple

import numpy as np
import torch

POINT_CLOUD_RANGE = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]
VOXEL_SIZE = [0.2, 0.2, 8]
GRID_CONFIG = {
    "xbound": [-51.2, 51.2, 0.8],
    "ybound": [-51.2, 51.2, 0.8],
    "zbound": [-10.0, 10.0, 20.0],
    "dbound": [1.0, 60.0, 1.0],
}
DATA_CONFIG = {"input_size": (256, 704)}
MAX_OBJS = 500


def centerpoint_tasks():
    return [
        dict(num_class=1, class_names=["car"]),
        dict(num_class=2, class_names=["truck", "construction_vehicle"]),
        dict(num_class=2, class_names=["bus", "trailer"]),
        dict(num_class=1, class_names=["barrier"]),
        dict(num_class=2, class_names=["motorcycle", "bicycle"]),
        dict(num_class=2, class_names=["pedestrian", "traffic_cone"]),
    ]


def _common_head(in_channels: int, out_size_factor: int):
    return dict(
        type="CenterHead",
        in_channels=in_channels,
        tasks=centerpoint_tasks(),
        common_heads=dict(reg=(2, 2), height=(1, 2), dim=(3, 2),
                          rot=(2, 2), vel=(2, 2)),
        share_conv_channel=64,
        bbox_coder=dict(
            type="CenterPointBBoxCoder",
            post_center_range=[-61.2, -61.2, -10.0, 61.2, 61.2, 10.0],
            max_num=500, score_threshold=0.1,
            out_size_factor=out_size_factor,
            pc_range=POINT_CLOUD_RANGE[:2],
            voxel_size=VOXEL_SIZE[:2], code_size=9),
        separate_head=dict(type="SeparateHead", init_bias=-2.19,
                           final_kernel=3),
        loss_cls=dict(type="GaussianFocalLoss", reduction="mean"),
        loss_bbox=dict(type="L1Loss", reduction="mean", loss_weight=0.25),
        norm_bbox=True)


def _train_test_cfg(grid: int, out_size_factor: int):
    return (
        dict(pts=dict(
            grid_size=[grid, grid, 1], voxel_size=VOXEL_SIZE,
            point_cloud_range=POINT_CLOUD_RANGE,
            out_size_factor=out_size_factor, dense_reg=1,
            gaussian_overlap=0.1, max_objs=MAX_OBJS, min_radius=2,
            code_weights=[1.0] * 8 + [0.2, 0.2])),
        dict(pts=dict(
            post_center_limit_range=[-61.2, -61.2, -10.0, 61.2, 61.2,
                                     10.0],
            max_per_img=500, score_threshold=0.1,
            min_radius=[4, 12, 10, 1, 0.85, 0.175],
            pc_range=POINT_CLOUD_RANGE[:2],
            out_size_factor=out_size_factor,
            voxel_size=VOXEL_SIZE[:2], pre_max_size=1000,
            post_max_size=83, nms_thr=0.2, nms_type="rotate")),
    )


def centerpoint_teacher_cfg():
    """CenterPoint-pillar teacher (reference _base_/models/
    centerpoint_02pillar_second_secfpn_nus.py): 512 grid, SECONDFPN ->
    384ch at 128x128.  Its modules come with the training slice."""
    train_cfg, test_cfg = _train_test_cfg(512, 4)
    return dict(
        type="CenterPoint",
        presorted_points=True,
        pts_voxel_layer=dict(max_num_points=20, voxel_size=VOXEL_SIZE,
                             point_cloud_range=POINT_CLOUD_RANGE,
                             max_voxels=(30000, 40000)),
        pts_voxel_encoder=dict(
            type="PillarFeatureNet", in_channels=5, feat_channels=[64],
            with_distance=False, voxel_size=tuple(VOXEL_SIZE),
            point_cloud_range=tuple(POINT_CLOUD_RANGE),
            norm_cfg=dict(type="BN1d", eps=1e-3, momentum=0.01),
            legacy=False),
        pts_middle_encoder=dict(type="PointPillarsScatter",
                                in_channels=64, output_shape=(512, 512)),
        pts_backbone=dict(
            type="SECOND", in_channels=64, out_channels=[64, 128, 256],
            layer_nums=[3, 5, 5], layer_strides=[2, 2, 2],
            norm_cfg=dict(type="BN", eps=1e-3, momentum=0.01)),
        pts_neck=dict(
            type="SECONDFPN", in_channels=[64, 128, 256],
            out_channels=[128, 128, 128], upsample_strides=[0.5, 1, 2],
            norm_cfg=dict(type="BN", eps=1e-3, momentum=0.01),
            use_conv_for_no_stride=True),
        pts_bbox_head=_common_head(384, 4),
        train_cfg=train_cfg, test_cfg=test_cfg)


def bevdepth4d_distill_cfg(img_backbone_depth: int = 50):
    """BEVDepth4D-R50 distill student (reference distill cfg model block,
    ...to_bevdepth4d_r50.py:41-141)."""
    numC_Trans = 64
    train_cfg, test_cfg = _train_test_cfg(512, 4)  # head at 128x128
    return dict(
        type="BEVDepth4DDistill",
        distill_type="fgd",
        distill_params=dict(
            student_channels=[256], teacher_channels=[384],
            spatial_t=0.5, spatial_student_ratio=1.0, channel_t=0.5,
            fg_feat_loss_weights=[1.5e-3], bg_feat_loss_weights=[4e-2],
            channel_loss_weights=[0.25], spatial_loss_weights=[2.5e-3],
            adaptation_type="1x1conv",
            student_adaptation_params=dict(kernel_size=1, stride=1,
                                           upsample_factor=4),
            teacher_adaptation_type="identity",
            teacher_adaptation_params=dict(kernel_size=4, stride=4),
            spatial_attentions=["teacher"],
            feat_criterion=dict(type="MSELoss", reduction="none"),
            spatial_criterion=dict(type="L1Loss", reduction="none"),
            channel_criterion=dict(type="L1Loss", reduction="none"),
            transpose_mask=False, foreground_mask="gt",
            background_mask="logical_not", scale_mask="combine_gt",
            spatial_mask=True, channel_mask=True,
            student_feat_pos=["head"], teacher_feat_pos=["head"],
            two_stage_epoch=-1, affinity_weights=[0],
            affinity_mode="none",
            affinity_criterion=dict(type="SmoothL1Loss"),
            affinity_split=1, non_empty_weight=0, output_threshold=1.0,
            groundtruth_threshold=None, fp_as_foreground="none",
            fp_weight=0, fp_epoch=0, multi_scale_epoch=-1,
            fp_scale_mode="dfs", gauss_fg_weight=-1e10,
            context_length=0, context_weight=0),
        aligned=True, detach=True, before=True,
        img_backbone=dict(type="ResNet", depth=img_backbone_depth,
                          num_stages=4, out_indices=(2, 3),
                          frozen_stages=-1,
                          norm_cfg=dict(type="BN"), norm_eval=False,
                          with_cp=False),
        img_neck=dict(type="FPNForBEVDet", in_channels=[1024, 2048],
                      out_channels=512, num_outs=1, start_level=0,
                      out_ids=[0]),
        img_view_transformer=dict(
            type="ViewTransformerLSSBEVDepth", loss_depth_weight=100.0,
            grid_config=GRID_CONFIG, data_config=DATA_CONFIG,
            numC_Trans=numC_Trans, numC_input=512, downsample=16,
            extra_depth_net=dict(type="ResNetForBEVDet", numC_input=256,
                                 num_layer=[3], num_channels=[256],
                                 stride=[1])),
        img_bev_encoder_backbone=dict(type="ResNetForBEVDet",
                                      numC_input=128,
                                      num_channels=[128, 256, 512]),
        img_bev_encoder_neck=dict(type="FPN_LSS",
                                  in_channels=numC_Trans * 8 +
                                  numC_Trans * 2,
                                  out_channels=256),
        pre_process=dict(type="ResNetForBEVDet", numC_input=numC_Trans,
                         num_layer=[2], num_channels=[64], stride=[1],
                         backbone_output_ids=[0]),
        pts_bbox_head=_common_head(256, 4),
        train_cfg=train_cfg, test_cfg=test_cfg)


def student_model_cfg(distill_cfg: dict) -> dict:
    """The ``BEVDepth4D`` a ``BEVDepth4DDistill`` block inherits from:
    the same cfg without the distillation keys."""
    cfg = copy.deepcopy(distill_cfg)
    cfg.pop("distill_type", None)
    cfg.pop("distill_params", None)
    cfg["type"] = "BEVDepth4D"
    return cfg


def _shrink_student_grids(s_cfg: dict, factor: int = 4):
    """Coarsen the student's BEV grid and depth bins by ``factor`` in
    place (BEV 128 -> 32, depth bins 59 -> 15), as the JAX tiny recipe's
    ``_shrink_grids`` does to the student."""
    vs = [VOXEL_SIZE[0] * factor, VOXEL_SIZE[1] * factor, VOXEL_SIZE[2]]
    grid = 512 // factor
    s_cfg["pts_bbox_head"]["bbox_coder"]["voxel_size"] = vs[:2]
    s_cfg["train_cfg"]["pts"]["grid_size"] = [grid, grid, 1]
    s_cfg["train_cfg"]["pts"]["voxel_size"] = vs
    s_cfg["test_cfg"]["pts"]["voxel_size"] = vs[:2]
    gc = dict(s_cfg["img_view_transformer"]["grid_config"])
    for key in ("xbound", "ybound", "dbound"):
        gc[key] = [gc[key][0], gc[key][1], gc[key][2] * factor]
    s_cfg["img_view_transformer"]["grid_config"] = gc


def make_example_batch(batch_size: int = 1, n_cams: int = 6,
                       img_hw: Tuple[int, int] = (256, 704), seed: int = 0,
                       device: str = "cuda"):
    """Synthetic, geometrically plausible camera inputs at flagship
    shapes, as torch tensors on ``device``.  The camera parameters and
    depth_gt follow the JAX ``make_example_batch`` (numpy, seeded); the
    images are uniform noise from a seeded ``torch.Generator`` made on
    the device."""
    from ..models.detectors.bevdet import ImgInputs

    rng = np.random.RandomState(seed)
    h, w = img_hw
    gen = torch.Generator(device=device).manual_seed(seed)
    imgs = torch.rand((batch_size, 2 * n_cams, h, w, 3), generator=gen,
                      device=device)
    intr = np.array([[1266.0, 0.0, 816.0], [0.0, 1266.0, 491.0],
                     [0.0, 0.0, 1.0]], np.float32)
    # image-aug post transform: resize 1600x900 -> 704x396, crop to 256
    post_rot = np.eye(3, dtype=np.float32)
    post_rot[0, 0] = post_rot[1, 1] = 704.0 / 1600.0
    post_tran = np.array([0.0, -140.0 * 704.0 / 1600.0, 0.0], np.float32)
    intrins = np.tile(intr, (batch_size, 2, n_cams, 1, 1))
    post_rots = np.tile(post_rot, (batch_size, 2, n_cams, 1, 1))
    post_trans = np.tile(post_tran, (batch_size, 2, n_cams, 1))
    # cameras look outward: rotate cam z->x with per-cam yaw
    rots = np.zeros((batch_size, 2, n_cams, 3, 3), np.float32)
    for c in range(n_cams):
        yaw = 2 * np.pi * c / n_cams
        cam2ego = np.array(
            [[np.cos(yaw), 0, np.sin(yaw)],
             [np.sin(yaw), 0, -np.cos(yaw)],
             [0, 1, 0]], np.float32) @ np.diag([1, -1, 1]).astype(
            np.float32)
        rots[:, :, c] = cam2ego
    trans = np.zeros((batch_size, 2, n_cams, 3), np.float32)
    trans[:, 1, :, 0] = 0.5   # adjacent frame ego offset
    fh, fw = h // 16, w // 16
    depth_gt = rng.uniform(0, 60, (batch_size, n_cams, fh, fw)) * \
        (rng.rand(batch_size, n_cams, fh, fw) > 0.7)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    return ImgInputs(imgs, t(rots), t(trans), t(intrins), t(post_rots),
                     t(post_trans), t(depth_gt))


def build_flagship_student(batch_size: int = 1, tiny: bool = False,
                           seed: int = 0, device: str = "cuda"):
    """Build ``(student, batch)``: the eval-mode ``BEVDepth4D`` of the
    flagship distill cfg on ``device``, randomly initialised from
    ``seed`` with the JAX package's init rules, and an example batch.

    tiny=True is the JAX tiny recipe's student: R18, 64x176 images and
    grids coarsened by 4.
    """
    from ..models import build_detector
    from ..models.layers import init_weights

    if tiny:
        s_cfg = bevdepth4d_distill_cfg(18)
        _shrink_student_grids(s_cfg)
        hw = (64, 176)
        s_cfg["img_neck"]["in_channels"] = [256, 512]
        s_cfg["img_view_transformer"]["data_config"] = {"input_size": hw}
    else:
        s_cfg = bevdepth4d_distill_cfg(50)
        hw = DATA_CONFIG["input_size"]
    student = build_detector(student_model_cfg(s_cfg))
    init_weights(student, torch.Generator().manual_seed(seed))
    student = student.to(device).eval()
    batch = make_example_batch(batch_size, img_hw=hw, seed=seed,
                               device=device)
    return student, batch
