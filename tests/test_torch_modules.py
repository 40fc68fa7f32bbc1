"""Module-by-module parity of the PyTorch port with the JAX package.

Inputs come from a seeded numpy RandomState and go to both packages;
the JAX weights (with random BatchNorm statistics and, for the DCN, a
random offset conv) reach the port through its own weight bridge,
``distillbev_tpu_torch/utils/convert.py``.  Tolerance: rtol/atol 1e-4
(fp32 on the CPU, sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillbev_tpu.core.bbox import box_jax_ops
from distillbev_tpu.core import post_processing as jax_pp
from distillbev_tpu.core.bbox.coders import (CenterPointBBoxCoder as
                                             JaxCoder)
from distillbev_tpu.models import build_detector as jax_build_detector
from distillbev_tpu.models.backbones.resnet import (
    ResNet as JaxResNet, ResNetForBEVDet as JaxResNetForBEVDet)
from distillbev_tpu.models.dense_heads.centerpoint_head import \
    CenterHead as JaxCenterHead
from distillbev_tpu.models.necks.fpn import (FPN_LSS as JaxFPNLSS,
                                             FPNForBEVDet as JaxFPNForBEVDet)
from distillbev_tpu.models.necks.view_transformer import \
    ViewTransformerLSSBEVDepth as JaxVT
from distillbev_tpu.ops.deform_conv import \
    modulated_deform_conv2d as jax_dcn
from distillbev_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from distillbev_tpu_torch.core import post_processing as pt_pp
from distillbev_tpu_torch.core.bbox import box_ops
from distillbev_tpu_torch.core.bbox.coders import CenterPointBBoxCoder
from distillbev_tpu_torch.models import build_detector
from distillbev_tpu_torch.models.backbones.resnet import (ResNet,
                                                          ResNetForBEVDet)
from distillbev_tpu_torch.models.dense_heads.centerpoint_head import \
    CenterHead
from distillbev_tpu_torch.models.necks.fpn import FPN_LSS, FPNForBEVDet
from distillbev_tpu_torch.models.necks.view_transformer import \
    ViewTransformerLSSBEVDepth
from distillbev_tpu_torch.ops.deform_conv import modulated_deform_conv2d
from distillbev_tpu_torch.ops.grid_sample import grid_sample
from distillbev_tpu_torch.utils.convert import (bevdepth4d_name_map,
                                                flatten_variables,
                                                map_to_state_dict,
                                                resnet_name_map)

TOL = dict(rtol=1e-4, atol=1e-4)


def randomize(variables, rng, offset_scale=0.05):
    """Flattened variables with random BN statistics/affines, random
    biases and (for DCNs) a random offset conv."""
    flat = flatten_variables(variables)
    for k, v in flat.items():
        if k.endswith("/mean"):
            flat[k] = rng.uniform(-0.5, 0.5, v.shape)
        elif k.endswith("/var") or k.endswith("/scale"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith("/bias"):
            flat[k] = v + rng.uniform(-0.2, 0.2, v.shape)
        elif "conv_offset" in k:
            flat[k] = rng.randn(*v.shape) * offset_scale
        flat[k] = np.asarray(flat[k], np.float32)
    return flat


def unflatten(flat):
    root = {}
    for key, v in flat.items():
        d = root
        *path, leaf = key.split("/")
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(v)
    return root


def sub_map(torch_prefix, flax_prefix, depth=50):
    pm, sm = bevdepth4d_name_map(depth)

    def cut(m):
        return {k[len(torch_prefix):]: v[len(flax_prefix):]
                for k, v in m.items() if k.startswith(torch_prefix)}
    return cut(pm), cut(sm)


def load(module, flat, maps):
    module.load_state_dict(map_to_state_dict(flat, *maps), strict=True)
    return module.eval()


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a), (0, 3, 1, 2))))


def test_resnet50():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 64, 3).astype(np.float32)
    jm = JaxResNet(depth=50, base_channels=8, out_indices=(2, 3))
    flat = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = jm.apply(unflatten(flat), jnp.asarray(x))
    pt = load(ResNet(depth=50, base_channels=8, out_indices=(2, 3)), flat,
              resnet_name_map(50, "", ()))
    with torch.no_grad():
        out = pt(nchw(x))
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        np.testing.assert_allclose(nhwc(o), np.asarray(r), **TOL)


def test_resnet_for_bevdet():
    rng = np.random.RandomState(1)
    x = rng.randn(1, 16, 16, 8).astype(np.float32)
    kw = dict(numC_input=8, num_channels=[8, 16, 32])
    jm = JaxResNetForBEVDet(**kw)
    flat = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = jm.apply(unflatten(flat), jnp.asarray(x))
    pt = load(ResNetForBEVDet(**kw), flat,
              sub_map("img_bev_encoder_backbone.", ("bev_backbone",)))
    with torch.no_grad():
        out = pt(nchw(x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(nhwc(o), np.asarray(r), **TOL)


def test_fpn_for_bevdet():
    rng = np.random.RandomState(2)
    feats = [rng.randn(2, 8, 12, 16).astype(np.float32),
             rng.randn(2, 4, 6, 32).astype(np.float32)]
    kw = dict(in_channels=[16, 32], out_channels=24, out_ids=[0])
    jm = JaxFPNForBEVDet(**kw)
    jf = [jnp.asarray(f) for f in feats]
    flat = randomize(jm.init(jax.random.PRNGKey(0), jf), rng)
    ref = jm.apply(unflatten(flat), jf)
    pt = load(FPNForBEVDet(**kw), flat, sub_map("img_neck.", ("neck",)))
    with torch.no_grad():
        out = pt([nchw(f) for f in feats])
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), **TOL)


def test_fpn_lss():
    rng = np.random.RandomState(3)
    feats = [rng.randn(1, 16, 16, 8).astype(np.float32),
             rng.randn(1, 8, 8, 16).astype(np.float32),
             rng.randn(1, 4, 4, 32).astype(np.float32)]
    kw = dict(in_channels=40, out_channels=16)
    jm = JaxFPNLSS(**kw)
    jf = [jnp.asarray(f) for f in feats]
    flat = randomize(jm.init(jax.random.PRNGKey(0), jf), rng)
    ref = jm.apply(unflatten(flat), jf)
    pt = load(FPN_LSS(**kw), flat,
              sub_map("img_bev_encoder_neck.", ("bev_neck",)))
    with torch.no_grad():
        out = pt([nchw(f) for f in feats])
    assert out.shape == (1, 16, 32, 32)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), **TOL)


def _cameras(rng, b, n):
    from scipy.spatial.transform import Rotation
    rots = np.stack([np.stack([
        Rotation.from_euler(
            "zyx", [360.0 * i / n + rng.uniform(-10, 10),
                    rng.uniform(-5, 5), 90 + rng.uniform(-5, 5)],
            degrees=True).as_matrix().astype(np.float32)
        for i in range(n)]) for _ in range(b)])
    trans = rng.uniform(-1.0, 1.0, (b, n, 3)).astype(np.float32)
    intrins = np.tile(np.array([[50.0, 0, 48], [0, 50.0, 32], [0, 0, 1]],
                               np.float32), (b, n, 1, 1))
    post_rots = np.tile(np.diag([0.9, 0.9, 1.0]).astype(np.float32),
                        (b, n, 1, 1))
    post_trans = rng.uniform(-3, 3, (b, n, 3)).astype(np.float32)
    post_trans[..., 2] = 0
    return rots, trans, intrins, post_rots, post_trans


def test_view_transformer_lss_bevdepth():
    """SE gate, extra depth ResNet, DCN with a random offset conv, the
    depth-last lift and the truncating splat (the (-1, 0) band of each
    axis must land in cell 0, not be dropped)."""
    rng = np.random.RandomState(4)
    b, n, fh, fw, cin, dch = 1, 4, 4, 6, 16, 12
    grid = {"xbound": [-6.0, 6.0, 0.5], "ybound": [-6.0, 6.0, 0.5],
            "zbound": [-10.0, 10.0, 20.0], "dbound": [1.0, 9.0, 1.0]}
    kw = dict(grid_config=grid, data_config={"input_size": (64, 96)},
              numC_input=cin, numC_Trans=8, downsample=16,
              extra_depth_net=dict(type="ResNetForBEVDet", numC_input=dch,
                                   num_layer=[3], num_channels=[dch],
                                   stride=[1]))
    x = rng.randn(b, n, fh, fw, cin).astype(np.float32)
    cams = _cameras(rng, b, n)
    jin = (jnp.asarray(x),) + tuple(jnp.asarray(c) for c in cams)
    jm = JaxVT(**kw)
    flat = randomize(jm.init(jax.random.PRNGKey(0), jin), rng)
    ref_bev, ref_depth = jm.apply(unflatten(flat), jin)

    pt = load(ViewTransformerLSSBEVDepth(**kw), flat,
              sub_map("img_view_transformer.", ("view_transformer",)))
    tin = (torch.from_numpy(np.ascontiguousarray(
        np.transpose(x, (0, 1, 4, 2, 3)))),) + tuple(
        torch.from_numpy(c) for c in cams)
    with torch.no_grad():
        bev, depth = pt(tin)
        geom = pt.geo.get_geometry(pt.frustum, *tin[1:])
    g = (geom[..., :2] - (-6.0)) / 0.5
    in_band = ((g > -1) & (g < 0)).any(-1) & ((g > -1) & (g < 24)).all(-1)
    assert int(in_band.sum()) > 0, "no frustum point in the (-1, 0) band"
    np.testing.assert_allclose(nhwc(bev), np.asarray(ref_bev), **TOL)
    np.testing.assert_allclose(depth.numpy(), np.asarray(ref_depth), **TOL)


@pytest.mark.parametrize("h,w", [(8, 10), (34, 34)])
def test_modulated_deform_conv2d(h, w):
    """(8, 10) takes the JAX dense-lerp path, (34, 34) its gather path;
    both compute the same sums as the port's gather."""
    rng = np.random.RandomState(h)
    c, cout, k = 8, 6, 9
    x = rng.randn(2, h, w, c).astype(np.float32)
    off = (rng.randn(2, h, w, 2 * k) * 2.0).astype(np.float32)
    mask = rng.rand(2, h, w, k).astype(np.float32)
    weight = (rng.randn(3, 3, c, cout) * 0.2).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    ref = jax_dcn(*(jnp.asarray(a) for a in (x, off, mask, weight, bias)))
    out = modulated_deform_conv2d(*(torch.from_numpy(a) for a in (
        x, off, mask, weight, bias)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_grid_sample_and_shift_feature():
    import test_golden_detector as golden
    rng = np.random.RandomState(5)
    img = rng.randn(2, 9, 11, 4).astype(np.float32)
    grid_n = rng.uniform(-1.2, 1.2, (2, 5, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(
        grid_sample(torch.from_numpy(img), torch.from_numpy(grid_n)).numpy(),
        np.asarray(jax_grid_sample(jnp.asarray(img), jnp.asarray(grid_n))),
        **TOL)

    rots, trans = [], []
    for _ in range(2):
        r, t = _cameras(rng, 1, 2)[:2]
        rots.append(r)
        trans.append(t)
    rots = np.stack(rots, 1)                 # [B, 2, N, 3, 3]
    trans = np.stack(trans, 1)
    trans[:, 1] = trans[:, 0] + np.array([0.6, -0.3, 0.0], np.float32)
    bev = rng.randn(1, 16, 16, 8).astype(np.float32)
    cfg = golden._jax_cfg()
    jm = jax_build_detector(cfg)
    ref = jm.apply({}, jnp.asarray(bev), jnp.asarray(trans),
                   jnp.asarray(rots), method=jm.shift_feature)
    pt = build_detector(cfg)
    out = pt.shift_feature(torch.from_numpy(bev), torch.from_numpy(trans),
                           torch.from_numpy(rots))
    assert float(np.abs(np.asarray(ref) - bev).max()) > 0.1  # warped
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _head_cfg():
    import test_golden_detector as golden
    return dict(golden._jax_cfg()["pts_bbox_head"])


def test_center_head_forward():
    rng = np.random.RandomState(6)
    cfg = _head_cfg()
    cfg.pop("type")
    x = rng.randn(1, 8, 8, cfg["in_channels"]).astype(np.float32)
    jm = JaxCenterHead(**cfg)
    flat = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = jm.apply(unflatten(flat), jnp.asarray(x))
    pt = load(CenterHead(**cfg), flat, sub_map("pts_bbox_head.",
                                               ("bbox_head",)))
    with torch.no_grad():
        out = pt(nchw(x))
    assert len(out) == len(ref) == 6
    for o, r in zip(out, ref):
        assert list(o) == list(r)
        for key in r:
            np.testing.assert_allclose(o[key].numpy(), np.asarray(r[key]),
                                       err_msg=key, **TOL)


def test_center_point_coder_decode():
    rng = np.random.RandomState(7)
    b, h, w = 2, 16, 16
    maps = dict(heat=rng.rand(b, h, w, 3), rot_sine=rng.randn(b, h, w, 1),
                rot_cosine=rng.randn(b, h, w, 1),
                hei=rng.randn(b, h, w, 1), dim=rng.rand(b, h, w, 3) + 0.5,
                vel=rng.randn(b, h, w, 2), reg=rng.rand(b, h, w, 2))
    maps = {k: v.astype(np.float32) for k, v in maps.items()}
    kw = dict(pc_range=[-8.0, -8.0], out_size_factor=4,
              voxel_size=[0.25, 0.25],
              post_center_range=[-7.0, -7.0, -10.0, 7.0, 7.0, 10.0],
              max_num=40, score_threshold=0.3)
    ref = JaxCoder(**kw).decode(**{k: jnp.asarray(v)
                                   for k, v in maps.items()})
    out = CenterPointBBoxCoder(**kw).decode(
        **{k: torch.from_numpy(v) for k, v in maps.items()})
    np.testing.assert_allclose(out.bboxes.numpy(), np.asarray(ref.bboxes),
                               **TOL)
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores),
                               **TOL)
    np.testing.assert_array_equal(out.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert 0 < int(out.valid.sum()) < out.valid.numel()


def _boxes(rng, n):
    boxes = np.concatenate([rng.uniform(0, 8, (n, 2)),
                            rng.uniform(0.5, 3.0, (n, 2)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], axis=1)
    return boxes.astype(np.float32), rng.rand(n).astype(np.float32)


def test_rotated_iou_bev():
    rng = np.random.RandomState(8)
    a, _ = _boxes(rng, 40)
    bb, _ = _boxes(rng, 30)
    bb[:5] = a[:5]                         # identical pairs: IoU 1
    ref = np.asarray(box_jax_ops.rotated_iou_bev(jnp.asarray(a),
                                                 jnp.asarray(bb)))
    out = box_ops.rotated_iou_bev(torch.from_numpy(a),
                                  torch.from_numpy(bb)).numpy()
    assert (ref > 0.05).mean() > 0.05
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("pre_max_size", [None, 40])
def test_rotated_nms_mask(pre_max_size):
    rng = np.random.RandomState(9)
    boxes, scores = _boxes(rng, 60)
    valid = rng.rand(60) > 0.2
    ref = np.asarray(jax_pp.rotated_nms_mask(
        jnp.asarray(boxes), jnp.asarray(scores), 0.2, jnp.asarray(valid),
        pre_max_size=pre_max_size))
    out = pt_pp.rotated_nms_mask(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.2,
        torch.from_numpy(valid), pre_max_size=pre_max_size).numpy()
    assert 0 < ref.sum() < valid.sum()
    np.testing.assert_array_equal(out, ref)


def test_circle_nms_mask():
    rng = np.random.RandomState(10)
    boxes, scores = _boxes(rng, 50)
    valid = rng.rand(50) > 0.2
    ref = np.asarray(jax_pp.circle_nms_mask(
        jnp.asarray(boxes[:, :2]), jnp.asarray(scores), 1.0,
        jnp.asarray(valid)))
    out = pt_pp.circle_nms_mask(torch.from_numpy(boxes[:, :2]),
                                torch.from_numpy(scores), 1.0,
                                torch.from_numpy(valid)).numpy()
    assert 0 < ref.sum() < valid.sum()
    np.testing.assert_array_equal(out, ref)
