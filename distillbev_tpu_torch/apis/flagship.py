"""Flagship configs and models at the reference's sizes.

Counterpart of ``distillbev_tpu/apis/flagship.py``: the same config
factories (CenterPoint-pillar teacher, BEVDepth4D-R50 distill student),
the camera part of ``make_example_batch`` as torch tensors, and
``build_flagship_student``, the student-only counterpart of
``build_flagship``: a ``BEVDepth4D`` built from the distill cfg's model
block with a seeded random init.

The flagship distill setup: ``build_flagship`` (the ``BEVDepth4DDistill``
student with its FGD distiller, the frozen CenterPoint-pillar teacher and
one ``DistillBatch``).

The LiDAR teachers: ``dynamic_centerpoint_teacher_cfg``,
``sort_points_by_pillar``, ``make_points_example_batch`` (the points,
point mask and GT of ``make_example_batch``, drawn as JAX draws them) and
``build_teacher`` (CenterPoint-pillar or DynamicCenterPoint with seeded
weights).

The BEVFormer track: ``bevformer_r50_cfg`` (the student of
``configs/lidar2camera_bev_distillation/teacher_to_bevformer/
lidarformer_to_bevformer_nus_1x1conv_r50.py`` without the teacher),
``bevformer_train_cfg`` (its optimizer, clipping and schedule),
``bevformer_tiny_cfg`` (the same architecture cut to CPU size),
``make_bevformer_example_batch`` (seeded queue inputs on a nuScenes-like
six-camera rig, as ``tools/analysis_tools/bench_bevformer.py``) and
``build_bevformer``.
"""
from __future__ import annotations

import copy
from typing import NamedTuple, Tuple

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
    384ch at 128x128, on the fused sorted-pillar path with presorted
    points."""
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


def dynamic_centerpoint_teacher_cfg():
    """DynamicCenterPoint teacher (``configs/dynamic_centerpoint/
    dynamic_centerpoint_02pillar_second_secfpn_4x8_cyclic_20e_nus.py``):
    the pillar teacher with ``DynamicPillarFeatureNet`` and 32,000
    voxels.  MVP is this with ``in_channels=17, virtual=True``."""
    cfg = centerpoint_teacher_cfg()
    del cfg["presorted_points"]
    cfg.update(type="DynamicCenterPoint", max_voxels=32000)
    cfg["pts_voxel_encoder"] = dict(
        type="DynamicPillarFeatureNet", in_channels=5, feat_channels=[64],
        with_distance=False, voxel_size=tuple(VOXEL_SIZE),
        point_cloud_range=tuple(POINT_CLOUD_RANGE),
        norm_cfg=dict(type="BN1d", eps=1e-3, momentum=0.01))
    return cfg


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


def sort_points_by_pillar(pts: np.ndarray, voxel_size=None,
                          point_cloud_range=None) -> np.ndarray:
    """Host-side stable sort of ``[B, N, C]`` points by flat pillar key
    (out-of-grid points last), what the pipeline's SortPointsByPillar
    does per sample; the teacher's presorted path relies on it."""
    vs = np.asarray(voxel_size or VOXEL_SIZE, np.float32)
    pcr = point_cloud_range or POINT_CLOUD_RANGE
    lo = np.asarray(pcr[:3], np.float32)
    hi = np.asarray(pcr[3:], np.float32)
    grid = np.floor((hi - lo) / vs + 0.5).astype(np.int64)
    out = np.empty_like(pts)
    for b in range(pts.shape[0]):
        c = np.floor((pts[b, :, :3] - lo) / vs).astype(np.int64)
        valid = ((c >= 0).all(1) & (c[:, 0] < grid[0]) &
                 (c[:, 1] < grid[1]) & (c[:, 2] < grid[2]))
        key = (c[:, 2] * grid[1] + c[:, 1]) * grid[0] + c[:, 0]
        key = np.where(valid, key, np.iinfo(np.int64).max)
        out[b] = pts[b, np.argsort(key, kind="stable")]
    return out


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


MAX_POINTS = 300_000     # 10-sweep nuScenes padded budget


class PointsBatch(NamedTuple):
    """A LiDAR batch: ``points [B, N, 5]`` (x, y, z, intensity, time lag;
    sorted by pillar key), ``point_mask [B, N]``, ``gt_boxes [B, M, 9]``,
    ``gt_labels [B, M]``, ``gt_mask [B, M]``."""
    points: torch.Tensor
    point_mask: torch.Tensor
    gt_boxes: torch.Tensor
    gt_labels: torch.Tensor
    gt_mask: torch.Tensor


def make_points_example_batch(batch_size: int = 1,
                              n_points: int = MAX_POINTS, n_cams: int = 6,
                              img_hw: Tuple[int, int] = (256, 704),
                              seed: int = 0, voxel_size=None,
                              device: str = "cuda") -> PointsBatch:
    """The points, point mask and GT of the JAX ``make_example_batch``:
    the same numpy draws in the same order (the camera depth draws,
    whose shape follows ``n_cams`` and ``img_hw``, come first), so one
    seed gives one cloud.  ``n_points`` points uniform over +-51 m, sorted
    by pillar key for ``voxel_size``; 32 real GT boxes of ``MAX_OBJS``."""
    rng = np.random.RandomState(seed)
    b = batch_size
    fh, fw = img_hw[0] // 16, img_hw[1] // 16
    rng.uniform(0, 60, (b, n_cams, fh, fw))      # depth_gt's draws
    rng.rand(b, n_cams, fh, fw)
    pts = np.zeros((b, n_points, 5), np.float32)
    pts[..., :2] = rng.uniform(-51, 51, (b, n_points, 2))
    pts[..., 2] = rng.uniform(-4, 2, (b, n_points))
    pts[..., 3] = rng.uniform(0, 255, (b, n_points))
    pts[..., 4] = rng.uniform(0, 0.5, (b, n_points))
    pts = sort_points_by_pillar(pts, voxel_size=voxel_size)
    gt = np.zeros((b, MAX_OBJS, 9), np.float32)
    n_real = 32
    gt[:, :n_real, :2] = rng.uniform(-40, 40, (b, n_real, 2))
    gt[:, :n_real, 2] = rng.uniform(-2, 0, (b, n_real))
    gt[:, :n_real, 3:6] = rng.uniform(0.5, 8, (b, n_real, 3))
    gt[:, :n_real, 6] = rng.uniform(-np.pi, np.pi, (b, n_real))
    labels = rng.randint(0, 10, (b, MAX_OBJS))
    gmask = np.zeros((b, MAX_OBJS), bool)
    gmask[:, :n_real] = True

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return PointsBatch(t(pts), t(np.ones((b, n_points), bool), torch.bool),
                       t(gt), t(labels, torch.int64), t(gmask, torch.bool))


def _shrink_teacher_grid(t_cfg: dict, factor: int = 4):
    """Coarsen the teacher's pillar grid by ``factor`` in place (512 ->
    128) and cut its voxel budget to 512, as the JAX tiny recipe
    (``build_flagship(tiny=True)``) does; returns the voxel size."""
    vs = [VOXEL_SIZE[0] * factor, VOXEL_SIZE[1] * factor, VOXEL_SIZE[2]]
    grid = 512 // factor
    t_cfg["pts_voxel_layer"]["voxel_size"] = vs
    t_cfg["pts_voxel_layer"]["max_voxels"] = (512, 512)
    t_cfg["pts_voxel_encoder"]["voxel_size"] = tuple(vs)
    t_cfg["pts_middle_encoder"]["output_shape"] = (grid, grid)
    t_cfg["pts_bbox_head"]["bbox_coder"]["voxel_size"] = vs[:2]
    t_cfg["train_cfg"]["pts"]["grid_size"] = [grid, grid, 1]
    t_cfg["train_cfg"]["pts"]["voxel_size"] = vs
    t_cfg["test_cfg"]["pts"]["voxel_size"] = vs[:2]
    if "max_voxels" in t_cfg:
        t_cfg["max_voxels"] = 512
    return vs


def build_teacher(kind: str = "pillar", tiny: bool = False, seed: int = 0,
                  device: str = "cuda"):
    """Build ``(teacher, batch)``: the eval-mode LiDAR teacher on
    ``device`` (``kind`` "pillar": ``centerpoint_teacher_cfg``;
    "dynamic": ``dynamic_centerpoint_teacher_cfg``), randomly
    initialised from ``seed`` with the JAX package's init rules, and a
    one-sample ``PointsBatch`` of 300,000 points.

    tiny=True is the JAX tiny recipe's teacher: a 128x128 grid, 512
    voxels and 2,048 points, at the full widths."""
    from ..models import build_detector
    from ..models.layers import init_weights

    cfgs = {"pillar": centerpoint_teacher_cfg,
            "dynamic": dynamic_centerpoint_teacher_cfg}
    if kind not in cfgs:
        raise ValueError(f"unknown teacher kind {kind!r}")
    cfg = cfgs[kind]()
    if tiny:
        vs = _shrink_teacher_grid(cfg)
        batch = make_points_example_batch(1, 2048, img_hw=(64, 176),
                                          seed=seed, voxel_size=vs,
                                          device=device)
    else:
        batch = make_points_example_batch(1, seed=seed, device=device)
    model = build_detector(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval(), batch


def build_flagship(tiny: bool = False, seed: int = 0,
                   device: str = "cuda"):
    """Build ``(student, teacher, batch)``, the counterpart of the JAX
    ``build_flagship`` at batch 1: the training-mode ``BEVDepth4DDistill``
    of ``bevdepth4d_distill_cfg`` with its FGD distiller, the eval-mode
    CenterPoint-pillar teacher of ``centerpoint_teacher_cfg`` (both
    randomly initialised from ``seed`` with the JAX package's init rules)
    and one ``DistillBatch``: the camera inputs of ``make_example_batch``
    and the points and GT of ``make_points_example_batch``, one seed in
    the JAX draw order.

    tiny=True is the JAX tiny recipe: R18, 64x176 images, every grid
    coarsened by 4 (teacher 128x128 pillars, student BEV 32x32, 15 depth
    bins), 512 voxels and 2,048 points.
    """
    from ..models import build_detector
    from ..models.layers import init_weights
    from ..training.train_step import DistillBatch

    t_cfg = centerpoint_teacher_cfg()
    if tiny:
        vs = _shrink_teacher_grid(t_cfg)
        s_cfg = bevdepth4d_distill_cfg(18)
        _shrink_student_grids(s_cfg)
        hw, n_points = (64, 176), 2048
        s_cfg["img_view_transformer"]["data_config"] = {"input_size": hw}
        s_cfg["img_neck"]["in_channels"] = [256, 512]
    else:
        vs, hw, n_points = None, DATA_CONFIG["input_size"], MAX_POINTS
        s_cfg = bevdepth4d_distill_cfg(50)
    student = build_detector(s_cfg)
    init_weights(student, torch.Generator().manual_seed(seed))
    teacher = build_detector(t_cfg)
    init_weights(teacher, torch.Generator().manual_seed(seed + 1))
    cams = make_example_batch(1, img_hw=hw, seed=seed, device=device)
    pts = make_points_example_batch(1, n_points, img_hw=hw, seed=seed,
                                    voxel_size=vs, device=device)
    return (student.to(device).train(), teacher.to(device).eval(),
            DistillBatch(cams, *pts))


BEVFORMER_CLASSES = 10


def bevformer_r50_cfg() -> dict:
    """The BEVFormer-R50 student (reference distill cfg model block minus
    the teacher and the distill keys): R50 -> FPN (256 ch, 4 levels), 6
    encoder layers (TSA + SCA, 8 heads), 6 decoder layers, 900 queries,
    BEV 200x200."""
    pcr = POINT_CLOUD_RANGE
    dim, ffn, bev = 256, 512, 200
    return dict(
        type="BEVFormer",
        use_grid_mask=True, video_test_mode=True, seq_img_encoder=True,
        history_sca_budget=14000,
        img_backbone=dict(type="ResNet", depth=50, num_stages=4,
                          out_indices=(1, 2, 3), frozen_stages=1,
                          norm_cfg=dict(type="BN", requires_grad=False),
                          norm_eval=True, with_cp=True),
        img_neck=dict(type="FPN", in_channels=[512, 1024, 2048],
                      out_channels=dim, start_level=0,
                      add_extra_convs="on_output", num_outs=4,
                      relu_before_extra_convs=True),
        pts_bbox_head=dict(
            type="BEVFormerHead", bev_h=bev, bev_w=bev, num_query=900,
            num_classes=BEVFORMER_CLASSES, embed_dims=dim, pc_range=pcr,
            real_h=102.4, real_w=102.4, with_box_refine=True,
            code_weights=[1.0] * 8 + [0.2, 0.2],
            transformer=dict(
                type="PerceptionTransformer", embed_dims=dim, num_cams=6,
                num_feature_levels=4, rotate_prev_bev=True, use_shift=True,
                use_can_bus=True,
                encoder=dict(num_layers=6, pc_range=pcr,
                             num_points_in_pillar=4, embed_dims=dim,
                             num_heads=8, feedforward_channels=ffn,
                             num_levels=4, num_cams=6, with_cp=True,
                             scan_layers=True, max_queries_per_cam=14000),
                decoder=dict(num_layers=6, embed_dims=dim, num_heads=8,
                             feedforward_channels=ffn,
                             return_intermediate=True)),
            positional_encoding=dict(num_feats=dim // 2, row_num_embed=bev,
                                     col_num_embed=bev),
            bbox_coder=dict(
                type="NMSFreeCoder",
                post_center_range=[-61.2, -61.2, -10.0, 61.2, 61.2, 10.0],
                pc_range=pcr, max_num=300, num_classes=BEVFORMER_CLASSES),
            loss_cls=dict(type="FocalLoss", use_sigmoid=True, gamma=2.0,
                          alpha=0.25, reduction="mean", loss_weight=2.0),
            loss_bbox=dict(type="L1Loss", reduction="mean",
                           loss_weight=0.25)),
        train_cfg=dict(pts=dict(
            grid_size=[bev, bev, 1], voxel_size=[102.4 / bev, 102.4 / bev, 8],
            point_cloud_range=pcr, out_size_factor=1,
            assigner=dict(
                type="HungarianAssigner3D",
                cls_cost=dict(type="FocalLossCost", weight=2.0),
                reg_cost=dict(type="BBox3DL1Cost", weight=0.25),
                iou_cost=dict(type="IoUCost", weight=0.0),
                pc_range=pcr))),
        test_cfg=dict(pts=dict()))


def bevformer_train_cfg(steps_per_epoch: int = 28130):
    """``(optimizer, optimizer_config, lr_config, total_steps)`` of the
    config: AdamW 2e-4, weight decay 0.01, backbone lr_mult 0.1, clip at
    35, CosineAnnealing with 500 linear warmup steps over 24 epochs
    (``steps_per_epoch`` defaults to the nuScenes train split at batch
    1)."""
    optimizer = dict(type="AdamW", lr=2e-4, weight_decay=0.01,
                     paramwise_cfg=dict(custom_keys={
                         "backbone": dict(lr_mult=0.1)}))
    optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
    lr_config = dict(policy="CosineAnnealing", warmup="linear",
                     warmup_iters=500, warmup_ratio=1.0 / 3,
                     min_lr_ratio=1e-3)
    return optimizer, optimizer_config, lr_config, 24 * steps_per_epoch


TINY_BEVFORMER_PCR = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
TINY_BEVFORMER_IMG = (128, 224)


def bevformer_tiny_cfg() -> dict:
    """BEVFormer-R50's architecture at CPU size: ResNet-18 (base 8),
    embed 32, 4 heads, 2 encoder + 2 decoder layers, BEV 24x24 (so TSA and
    the decoder take the gather route), 20 queries, 4 classes, 16 m
    range; GridMask and dropout off."""
    cfg = bevformer_r50_cfg()
    pcr, dim, bev = TINY_BEVFORMER_PCR, 32, 24
    cfg.update(use_grid_mask=False, history_sca_budget=None)
    cfg["img_backbone"].update(depth=18, base_channels=8)
    cfg["img_neck"].update(in_channels=[16, 32, 64], out_channels=dim)
    head = cfg["pts_bbox_head"]
    head.update(bev_h=bev, bev_w=bev, num_query=20, num_classes=4,
                embed_dims=dim, pc_range=pcr, real_h=16.0, real_w=16.0)
    head["positional_encoding"] = dict(num_feats=dim // 2, row_num_embed=bev,
                                       col_num_embed=bev)
    head["bbox_coder"].update(post_center_range=[-10, -10, -10, 10, 10, 10],
                              pc_range=pcr, max_num=10, num_classes=4)
    t = head["transformer"]
    t["embed_dims"] = dim
    t["encoder"].update(num_layers=2, pc_range=pcr, embed_dims=dim,
                        num_heads=4, feedforward_channels=64, dropout=0.0,
                        max_queries_per_cam=None)
    t["decoder"].update(num_layers=2, embed_dims=dim, num_heads=4,
                        feedforward_channels=64, dropout=0.0)
    tc = cfg["train_cfg"]["pts"]
    tc.update(grid_size=[bev, bev, 1], voxel_size=[16.0 / bev, 16.0 / bev, 8],
              point_cloud_range=pcr)
    tc["assigner"]["pc_range"] = pcr
    return cfg


def nuscenes_like_lidar2img(img_h: int = 900, img_w: int = 1600
                            ) -> np.ndarray:
    """``[6, 4, 4]`` lidar-to-image matrices of six cameras with
    nuScenes-like geometry: five ~65 degree cameras (fx = 1266 at 1600 px)
    at yaws 0, +-55, +-110 degrees and one ~90 degree back camera (fx =
    809), 1.5 m from the ego centre at 1.6 m height; the focal lengths
    scale with ``img_w``."""
    yaws = np.deg2rad([0.0, 55.0, -55.0, 110.0, -110.0, 180.0])
    fxs = np.array([1266.4] * 5 + [809.2]) * img_w / 1600.0
    l2is = []
    for yaw, fx in zip(yaws, fxs):
        zc = np.array([np.cos(yaw), np.sin(yaw), 0.0])   # view direction
        yc = np.array([0.0, 0.0, -1.0])                  # image down
        xc = np.cross(yc, zc)                            # image right
        r_c2l = np.stack([xc, yc, zc], axis=1)
        t = 1.5 * zc + np.array([0.0, 0.0, 1.6])
        l2c = np.eye(4)
        l2c[:3, :3] = r_c2l.T
        l2c[:3, 3] = -r_c2l.T @ t
        k = np.eye(4)
        k[0, 0], k[1, 1] = fx, fx
        k[0, 2], k[1, 2] = img_w / 2.0, img_h / 2.0
        l2is.append(k @ l2c)
    return np.stack(l2is).astype(np.float32)


def make_bevformer_example_batch(batch_size: int = 1, queue: int = 4,
                                 img_hw: Tuple[int, int] = (928, 1600),
                                 n_obj: int = 64, n_real: int = 32,
                                 pc_range=None,
                                 num_classes: int = BEVFORMER_CLASSES,
                                 seed: int = 0, device: str = "cuda"):
    """A seeded BEVFormer queue batch, as
    ``tools/analysis_tools/bench_bevformer.py``: images uniform in [-2, 2)
    (drawn on ``device`` by a seeded generator), can-bus uniform in
    [-1, 1), the nuScenes-like rig on every frame, frame 0 without
    history, and ``n_real`` of ``n_obj`` GT boxes at 78% of the range with
    random sizes, heights, yaws and labels."""
    from ..training.train_step import BEVFormerBatch

    pcr = pc_range or POINT_CLOUD_RANGE
    rng = np.random.RandomState(seed)
    h, w = img_hw
    b, n_cams = batch_size, 6
    gen = torch.Generator(device=device).manual_seed(seed)
    imgs = torch.rand((b, queue, n_cams, h, w, 3), generator=gen,
                      device=device) * 4.0 - 2.0
    can_bus = rng.uniform(-1, 1, (b, queue, 18))
    l2i = np.tile(nuscenes_like_lidar2img(h, w)[None, None],
                  (b, queue, 1, 1, 1))
    prev_exists = np.array([[0.0] + [1.0] * (queue - 1)] * b)
    gt = np.zeros((b, n_obj, 9))
    gt[..., :2] = rng.uniform(-0.78, 0.78, (b, n_obj, 2)) * pcr[3]
    gt[..., 2] = rng.uniform(-2, 0, (b, n_obj))
    gt[..., 3:6] = rng.uniform(1, 4, (b, n_obj, 3)) * pcr[3] / 51.2
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (b, n_obj))
    labels = rng.randint(0, num_classes, (b, n_obj))
    mask = np.arange(n_obj)[None].repeat(b, 0) < n_real

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return BEVFormerBatch(imgs, t(can_bus), t(l2i), t(prev_exists), None,
                          None, t(gt), t(labels, torch.int64),
                          t(mask, torch.bool))


def build_bevformer(batch_size: int = 1, tiny: bool = False, seed: int = 0,
                    device: str = "cuda"):
    """Build ``(model, batch)``: the ``BEVFormer`` of
    ``bevformer_r50_cfg`` (or ``bevformer_tiny_cfg``) on ``device``,
    randomly initialised from ``seed`` with the JAX package's init rules,
    and an example queue batch (tiny: queue 2, 128x224 images)."""
    from ..models import build_detector
    from ..models.layers import init_weights

    cfg = bevformer_tiny_cfg() if tiny else bevformer_r50_cfg()
    model = build_detector(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device)
    if tiny:
        batch = make_bevformer_example_batch(
            batch_size, queue=2, img_hw=TINY_BEVFORMER_IMG, n_obj=8,
            n_real=6, pc_range=TINY_BEVFORMER_PCR, num_classes=4, seed=seed,
            device=device)
    else:
        batch = make_bevformer_example_batch(batch_size, seed=seed,
                                             device=device)
    return model, batch
