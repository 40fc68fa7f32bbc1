"""The port's LiDAR teachers against the JAX package.

CenterPoint-pillar (fused sorted-pillar path, presorted or not),
DynamicCenterPoint and MVP (the dynamic teacher with ``virtual=True`` and
17-dim points) on ``tests/test_model_centerpoint.py:tiny_centerpoint_cfg``,
with the JAX weights (random BatchNorm statistics and biases) carried
across by ``centerpoint_params_to_torch`` into a strict
``load_state_dict``.  The canvas, the SECOND and SECONDFPN maps and the
head maps are held at rtol 1e-4, atol 5e-4, as
``tests/test_torch_detector.py`` holds the student; the port's bundle is
NCHW and is transposed here.  ``run_eval(family="points")`` is held
against JAX ``get_bboxes`` by valid count, score-sorted boxes and exact
labels.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_model_centerpoint as tiny
from distillbev_tpu.models import build_detector as jax_build_detector
from distillbev_tpu_torch.apis import flagship
from distillbev_tpu_torch.apis.test import run_eval
from distillbev_tpu_torch.models import build_detector
from distillbev_tpu_torch.utils.convert import centerpoint_params_to_torch
from test_torch_detector import _sorted_valid
from test_torch_modules import randomize, unflatten

TOL = dict(rtol=1e-4, atol=5e-4)


def _mvp_cfg():
    """The dynamic teacher with MVP's encoder over 17-dim points, and the
    flagship neck's strides (0.5, 1) with ``use_conv_for_no_stride``."""
    cfg = tiny.tiny_centerpoint_cfg(dynamic=True)
    cfg["pts_voxel_encoder"].update(in_channels=17, virtual=True)
    cfg["pts_neck"].update(upsample_strides=[0.5, 1],
                           use_conv_for_no_stride=True)
    cfg["pts_bbox_head"]["bbox_coder"]["out_size_factor"] = 4
    cfg["train_cfg"]["pts"]["out_size_factor"] = 4
    cfg["test_cfg"]["pts"]["out_size_factor"] = 4
    return cfg


def _case(name):
    rng = np.random.RandomState({"pillar": 0, "presorted": 1, "dynamic": 2,
                                 "mvp": 3}[name])
    pts, mask = (np.array(a) for a in tiny.make_batch(rng)[:2])
    if name == "mvp":
        extra = rng.randn(*pts.shape[:2], 13).astype(np.float32)
        extra[..., -2] = rng.choice([-1.0, 0.0, 1.0], pts.shape[:2])
        pts = np.concatenate([pts, extra], -1)
        return _mvp_cfg(), pts, mask, rng
    cfg = tiny.tiny_centerpoint_cfg(dynamic=name == "dynamic")
    if name == "presorted":
        vl = cfg["pts_voxel_layer"]
        pts = flagship.sort_points_by_pillar(pts, vl["voxel_size"],
                                             vl["point_cloud_range"])
        mask = np.ones_like(mask)
        cfg["presorted_points"] = True
    return cfg, pts, mask, rng


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """The JAX init of a case's model, run once: presorted points change
    no parameter, so that case shares the pillar model's."""
    cfg, pts, mask, _ = _case(name)
    return jax_build_detector(cfg).init(jax.random.PRNGKey(0),
                                        jnp.asarray(pts), jnp.asarray(mask))


@functools.lru_cache(maxsize=None)
def _jax_decode(name):
    """The JAX decode of a case's model as one jitted graph (eagerly it
    dispatches op by op).  It reads no variables, and every case but MVP
    has the same head, so they share one."""
    jm = jax_build_detector(_case(name)[0])
    return jax.jit(lambda preds: jm.apply({}, preds, method=jm.get_bboxes))


def _both(name):
    cfg, pts, mask, rng = _case(name)
    jm = jax_build_detector(cfg)
    flat = randomize(_jax_init("pillar" if name == "presorted" else name),
                     rng)
    pt = build_detector(cfg)
    pt.load_state_dict(centerpoint_params_to_torch(flat, cfg), strict=True)
    return jm, unflatten(flat), pt.eval(), pts, mask


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name", ["pillar", "presorted", "dynamic", "mvp"])
def test_teacher_forward_and_decode_match_jax(name):
    jm, jvars, pt, pts, mask = _both(name)
    ref_preds, ref_bundle = jm.apply(jvars, jnp.asarray(pts),
                                     jnp.asarray(mask))
    ref_dec = _jax_decode("mvp" if name == "mvp" else "pillar")(ref_preds)
    with torch.no_grad():
        preds, bundle = pt(torch.tensor(pts), torch.tensor(mask))
    np.testing.assert_allclose(_nhwc(bundle.canvas),
                               np.asarray(ref_bundle.canvas), **TOL)
    assert np.abs(np.asarray(ref_bundle.canvas)).sum() > 0
    for got, ref in zip(bundle.backbone_feats, ref_bundle.backbone_feats):
        np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)
    np.testing.assert_allclose(_nhwc(bundle.neck_feat),
                               np.asarray(ref_bundle.neck_feat), **TOL)
    for ti, (p, r) in enumerate(zip(preds, ref_preds)):
        for key in r:
            np.testing.assert_allclose(p[key].numpy(), np.asarray(r[key]),
                                       **TOL, err_msg=f"task{ti}.{key}")

    results = run_eval(pt, [{"points": pts, "point_mask": mask,
                             "img_metas": [{"sample_idx": "a"},
                                           {"sample_idx": "b"}]}],
                       family="points", device="cpu")
    for bi, token in enumerate("ab"):
        boxes, scores, labels, valid = results[token]
        ref = [np.asarray(a)[bi] for a in ref_dec]
        assert int(valid.sum()) == int(ref[3].sum()) > 0
        got_b, got_s, got_l = _sorted_valid(boxes, scores, labels, valid)
        ref_b, ref_s, ref_l = _sorted_valid(*ref)
        np.testing.assert_allclose(got_s, ref_s, **TOL)
        np.testing.assert_allclose(got_b, ref_b, **TOL)
        np.testing.assert_array_equal(got_l, ref_l)


@pytest.mark.parametrize("kind", ["pillar", "dynamic"])
def test_full_teacher_variables_load_strictly(kind):
    """The full-width teacher config builds in both packages and every
    JAX variable has its place in the port (parameter shapes do not
    depend on the point count, so JAX is traced on 4,096 points)."""
    cfg = (flagship.centerpoint_teacher_cfg if kind == "pillar"
           else flagship.dynamic_centerpoint_teacher_cfg)()
    pts = np.zeros((1, 4096, 5), np.float32)
    shapes = jax.eval_shape(jax_build_detector(cfg).init,
                            jax.random.PRNGKey(0), pts,
                            np.ones((1, 4096), bool))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat = {"/".join(k.key for k in path): np.zeros(leaf.shape, np.float32)
            for path, leaf in leaves}
    model = build_detector(cfg)
    model.load_state_dict(centerpoint_params_to_torch(flat, cfg),
                          strict=True)
    n_jax = sum(int(np.prod(leaf.shape)) for path, leaf in leaves
                if path[0].key == "params")
    assert sum(p.numel() for p in model.parameters()) == n_jax > 4_000_000


def test_dynamic_teacher_cfg_matches_the_config_file():
    from distillbev_tpu.config import Config
    model = Config.fromfile(
        "configs/dynamic_centerpoint/dynamic_centerpoint_02pillar_second_"
        "secfpn_4x8_cyclic_20e_nus.py").model
    cfg = flagship.dynamic_centerpoint_teacher_cfg()
    assert cfg["pts_voxel_encoder"] == dict(model["pts_voxel_encoder"])
    assert cfg["max_voxels"] == model["max_voxels"] == 32000
    assert cfg["type"] == model["type"]


def test_points_batch_draws_match_jax():
    from distillbev_tpu.apis.flagship import make_example_batch
    ref = make_example_batch(2, n_points=3000, img_hw=(64, 176), seed=3)
    got = flagship.make_points_example_batch(2, 3000, img_hw=(64, 176),
                                             seed=3, device="cpu")
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


def test_build_teacher_and_mvx_detector():
    model, batch = flagship.build_teacher("dynamic", tiny=True, seed=1,
                                          device="cpu")
    assert batch.points.shape == (1, 2048, 5)
    with torch.no_grad():
        preds, bundle = model(batch.points, batch.point_mask)
    assert bundle.canvas.shape == (1, 64, 128, 128)
    assert preds[0]["heatmap"].shape == (1, 32, 32, 1)
    cfg = dict(tiny.tiny_centerpoint_cfg(), type="MVXTwoStageDetector")
    assert type(build_detector(cfg)).__name__ == "MVXTwoStageDetector"
    with pytest.raises(NotImplementedError):
        build_detector(dict(cfg, img_backbone=dict(type="ResNet")))
