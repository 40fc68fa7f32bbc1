"""The flagship distill step of the port against the JAX package.

Module by module (train-mode BatchNorm, CenterHead targets and loss,
``depth_bce_loss``, the FGD masks and losses over the knob cases of
``tests/test_golden_fgd.py``, the step learning-rate policy and one
AdamW update against optax), then the whole tiny distill step of
``distillbev_tpu.apis.flagship.build_flagship(tiny=True)``: the JAX
variables (the teacher's with random BN statistics and biases) reach
the port through ``utils/convert.py``, the JAX batch is fed to both, and the
loss dict, selected gradients, the BN running statistics and 3 SGD
steps (SGD is the oracle: AdamW amplifies rounding) are compared.  The
JAX step runs under one ``jax.jit`` in a module fixture; its splat is the
Pallas kernel in interpret mode.

Tolerances of the whole step.  Training-mode BatchNorm over the tiny
maps (down to 4x4 in the BEV encoder) makes fp32 sums of moments cancel
and its backward amplify rounding, so the step is compared in float64
on both sides: the JAX step under ``jax.enable_x64`` with its
BatchNorm's statistics taken in float64 (the test stands a float64
``jnp`` in for the one of the JAX ``models/layers.py``), the port's
model in float64, whose BatchNorm follows its input's dtype above fp32.
The geometry, the splat and the depth loss stay fp32 on both sides by
design.  Measured: step 0's losses agree within 1.2e-6, its selected
gradients within 5.0e-6 of their norm, the running statistics within
1.7e-7; held at 1e-5, 5e-5 and 1e-6.  SGD takes the recipe's clip at
5 and a rate of 1e-3 (an update of norm 5e-3).  Over three steps the
splat's fp32 rounding of slightly different features, amplified by the
backward of the BatchNorms upstream of the BEV encoder, moves those
gradients apart by 1e-4 at step 1 and 2.8e-3 at step 2, while the
losses agree within 1.03e-5 and the three steps' update within 1.2e-3
of its norm; held at 1e-4 and 5e-3.  The port's fp32 step against its
float64 run (the fp32 noise itself): losses within 2.7e-4, the
gradients downstream of the BEV encoder within 6.4e-4, those upstream
within 5.6e-2; held at 1e-3, 5e-3 and 0.2.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from optax import global_norm as optax_global_norm

import test_golden_fgd as golden_fgd
from distillbev_tpu.apis import flagship as jax_flagship
from distillbev_tpu.core import gaussian as jax_gaussian
from distillbev_tpu.models.dense_heads.centerpoint_head import \
    CenterHead as JaxCenterHead
from distillbev_tpu.models.distill import masks as jax_masks
from distillbev_tpu.models import layers as jax_layers
from distillbev_tpu.models.layers import BatchNorm as JaxBatchNorm
from distillbev_tpu.models.necks.view_transformer import \
    depth_bce_loss as jax_depth_bce_loss
from distillbev_tpu.training import optim as jax_optim
from distillbev_tpu.training import schedules as jax_schedules
from distillbev_tpu.training.train_step import \
    gravity_centered as jax_gravity_centered
from distillbev_tpu_torch.apis import flagship
from distillbev_tpu_torch.core import gaussian
from distillbev_tpu_torch.models.dense_heads.centerpoint_head import \
    CenterHead
from distillbev_tpu_torch.models.detectors.bevdet import ImgInputs
from distillbev_tpu_torch.models.distill import masks
from distillbev_tpu_torch.models.distill.fgd import Distiller
from distillbev_tpu_torch.models.layers import BatchNorm
from distillbev_tpu_torch.models.necks.view_transformer import \
    depth_bce_loss
from distillbev_tpu_torch.training import (DistillBatch,
                                           make_distill_train_step)
from distillbev_tpu_torch.training.optim import (build_optimizer,
                                                 clip_by_global_norm_)
from distillbev_tpu_torch.training.schedules import build_lr_schedule
from distillbev_tpu_torch.utils.convert import (
    bevdepth4d_distill_params_to_torch, centerpoint_params_to_torch,
    flatten_variables)
from test_torch_modules import randomize, unflatten

SGD_LR = 1e-3
MAX_NORM = 5.0
N_SGD = 3
LOSS_RTOL = 1e-5
GRAD_RTOL = 5e-5
STEPS_LOSS_RTOL = 1e-4
UPDATE_RTOL = 5e-3
FP32_LOSS_RTOL = 1e-3
FP32_NEAR_RTOL = 5e-3
FP32_DEEP_RTOL = 0.2


def _np(t):
    return t.detach().cpu().numpy()


# -- modules ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 6, 5, 3), (12, 33)])
def test_train_mode_batch_norm_matches_jax(shape):
    """Output and running statistics after two training-mode calls, then
    the eval-mode output (the JAX layout is channels-last)."""
    rng = np.random.RandomState(len(shape))
    xs = [(rng.randn(*shape) * 2 + 0.5).astype(np.float32) for _ in range(2)]
    c = shape[-1]
    jbn = JaxBatchNorm(momentum=0.1, epsilon=1e-5)
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, c),
                            "bias": rng.uniform(-0.2, 0.2, c)},
                 "batch_stats": {"mean": rng.uniform(-0.5, 0.5, c),
                                 "var": rng.uniform(0.5, 1.5, c)}}
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                       variables)
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(np.array(
            variables["params"]["scale"])))
        bn.bias.copy_(torch.from_numpy(np.array(
            variables["params"]["bias"])))
        bn.running_mean.copy_(torch.from_numpy(np.array(
            variables["batch_stats"]["mean"])))
        bn.running_var.copy_(torch.from_numpy(np.array(
            variables["batch_stats"]["var"])))
    to_t = (lambda a: torch.from_numpy(np.moveaxis(a, -1, 1).copy())) \
        if len(shape) == 4 else torch.from_numpy
    to_np = (lambda t: np.moveaxis(_np(t), 1, -1)) if len(shape) == 4 \
        else _np
    bn.train()
    for x in xs:
        ref, state = jbn.apply(variables, jnp.asarray(x),
                               use_running_average=False,
                               mutable=["batch_stats"])
        variables = {"params": variables["params"], **state}
        np.testing.assert_allclose(to_np(bn(to_t(x))), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
    for mine, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        np.testing.assert_allclose(_np(mine), np.asarray(
            variables["batch_stats"][key]), rtol=1e-6, atol=1e-6)
    bn.eval()
    ref = jbn.apply(variables, jnp.asarray(xs[0]), use_running_average=True)
    np.testing.assert_allclose(to_np(bn(to_t(xs[0]))), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def _head_cfgs():
    head = flagship._common_head(16, 4)
    head.pop("type")
    train_cfg, test_cfg = (c["pts"] for c in flagship._train_test_cfg(128, 4))
    train_cfg["voxel_size"] = [0.8, 0.8, 8]   # 32 x 32 maps over +-51.2 m
    return head, train_cfg, test_cfg


def _gt(rng, b=2, m=20, n_real=14, extent=52.0):
    gt = np.zeros((b, m, 9), np.float32)
    gt[:, :, :2] = rng.uniform(-extent, extent, (b, m, 2))
    gt[:, 1, :2] = gt[:, 0, :2] + 0.3          # overlapping centres
    gt[:, :, 2] = rng.uniform(-2, 0, (b, m))
    gt[:, :, 3:6] = rng.uniform(0.5, 8, (b, m, 3))
    gt[:, :, 6] = rng.uniform(-np.pi, np.pi, (b, m))
    gt[:, :, 7:9] = rng.uniform(-3, 3, (b, m, 2))
    labels = rng.randint(0, 10, (b, m)).astype(np.int32)
    mask = np.zeros((b, m), bool)
    mask[:, :n_real] = True
    return gt, labels, mask


def test_center_head_targets_and_loss_match_jax():
    rng = np.random.RandomState(3)
    head, train_cfg, test_cfg = _head_cfgs()
    gt, labels, mask = _gt(rng)
    jm = JaxCenterHead(**head, train_cfg=train_cfg, test_cfg=test_cfg)
    pt = CenterHead(**head, train_cfg=train_cfg, test_cfg=test_cfg)
    jargs = (jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(mask))
    targs = (torch.from_numpy(gt), torch.from_numpy(labels).long(),
             torch.from_numpy(mask))
    ref = jm.apply({}, *jargs, method=jm.get_targets)
    got = pt.get_targets(*targs)
    for name, r_list, g_list in zip(("heatmaps", "anno", "inds", "masks"),
                                    ref, got):
        for t, (r, g) in enumerate(zip(r_list, g_list)):
            np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name}[{t}]")
    assert sum(int((h == 1).sum()) for h in got[0]) > 10
    preds = [{k: rng.randn(2, 32, 32, n).astype(np.float32)
              for k, n in (("reg", 2), ("height", 1), ("dim", 3), ("rot", 2),
                           ("vel", 2), ("heatmap", task["num_class"]))}
             for task in head["tasks"]]
    ref = jm.apply({}, [{k: jnp.asarray(v) for k, v in p.items()}
                        for p in preds], *jargs, method=jm.loss)
    got = pt.loss([{k: torch.from_numpy(v) for k, v in p.items()}
                   for p in preds], *targs)
    assert set(got) == set(ref) and len(got) == 12
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["centerpoint1", "centerpoint2",
                                  "centerpoint3", "maxwh", "gaussian_radius"])
def test_radius_functions_match_jax(name):
    rng = np.random.RandomState(4)
    h, w = rng.uniform(0.1, 30, (2, 50)).astype(np.float32)
    ref = jax_gaussian.radius_jnp(name, jnp.asarray(h), jnp.asarray(w), 0.1,
                                  1.5)
    got = gaussian.custom_radius(name, torch.from_numpy(h),
                                 torch.from_numpy(w), 0.1, 1.5)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6)


def test_depth_bce_loss_matches_jax():
    rng = np.random.RandomState(5)
    logits = rng.randn(1, 3, 4, 11, 15).astype(np.float32) * 3
    depth = rng.uniform(0, 70, (1, 3, 4, 11)) * (rng.rand(1, 3, 4, 11) > 0.5)
    depth = depth.astype(np.float32)
    dbound = [1.0, 60.0, 4.0]
    ref = jax_depth_bce_loss(jnp.asarray(logits), jnp.asarray(depth), dbound)
    got = depth_bce_loss(torch.from_numpy(logits), torch.from_numpy(depth),
                         dbound)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(), dict(avg_fg_scale_mask=True),
    dict(context_length=2, context_weight=0.5), dict(transpose=True)],
    ids=["default", "avg_scale", "context", "transpose"])
def test_foreground_scale_mask_matches_jax(kw):
    """Overlapping boxes: a pixel takes the scale of the lowest index
    among the boxes that contain it."""
    rng = np.random.RandomState(6)
    gt, _, mask = _gt(rng, extent=40.0)
    gt[:, 2, :2] = gt[:, 0, :2]
    gt[:, 0, 3:5] = (3.0, 9.0)                 # three boxes on one spot
    gt[:, 2, 3:5] = (9.0, 3.0)
    args = (32, 32, [0.8, 0.8, 8], flagship.POINT_CLOUD_RANGE,
            [128, 128, 1])
    ref = jax_masks.foreground_scale_mask(jnp.asarray(gt), jnp.asarray(mask),
                                          *args, **kw)
    got = masks.foreground_scale_mask(torch.from_numpy(gt),
                                      torch.from_numpy(mask), *args, **kw)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
    scales = np.unique(np.asarray(ref[1]))
    assert (np.asarray(ref[0]) > 0).sum() > 20 and len(scales) >= 3


@pytest.mark.parametrize("target", [(8, 12), (32, 24)])
def test_resize_mask_matches_jax(target):
    rng = np.random.RandomState(8)
    m = (rng.rand(2, 16, 12) > 0.7).astype(np.float32)
    ref = jax_masks.resize_mask(jnp.asarray(m), target)
    got = masks.resize_mask(torch.from_numpy(m), target)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


@pytest.mark.parametrize("kind,params,teacher", [
    ("1x1conv", None, False), ("3x3conv", None, False), ("mlp", None, False),
    ("2layer", None, False), ("3layer", None, False),
    ("downsample_2layer", dict(downsample_kernel_size=4,
                               downsample_stride=4), False),
    ("upsample_1x1conv", dict(upsample_factor=2), False),
    ("interpolate_1x1conv", dict(upsample_factor=2), False),
    ("avgpool_1x1conv", dict(downsample_kernel_size=2), False),
    ("avgpool", dict(kernel_size=2, stride=2), True),
    ("maxpool", dict(kernel_size=2, stride=2), True),
    ("avgpool_3layer", dict(kernel_size=2), True),
    ("downsample_3layer", dict(kernel_size=4, stride=4), True)])
def test_adaptations_match_jax(kind, params, teacher):
    """Every adaptation type in eval mode, with the JAX weights and random
    BN statistics, and its field-of-view stride."""
    from distillbev_tpu.models.distill import adaptations as jax_adapt
    from distillbev_tpu_torch.models.distill import adaptations
    rng = np.random.RandomState(9)
    x = rng.randn(2, 16, 16, 6).astype(np.float32)
    jcls = jax_adapt.TeacherAdaptation if teacher else \
        jax_adapt.StudentAdaptation
    jm = jcls(kind, 5, params)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    flat = randomize(variables, rng)
    ref = jm.apply(unflatten(flat), jnp.asarray(x))
    pcls = adaptations.TeacherAdaptation if teacher else \
        adaptations.StudentAdaptation
    pm = pcls(kind, 6, 5, params).eval()
    names = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
    sd = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")[1:]
        v = np.asarray(v, np.float32)
        sd[".".join(path + [names[leaf]])] = torch.from_numpy(
            v.transpose(3, 2, 0, 1).copy() if v.ndim == 4 else v.copy())
    pm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    np.testing.assert_allclose(np.moveaxis(_np(got), 1, -1), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    assert pm.stride == jm.stride


FGD_CASES = {"shipped": {}, "1minus": dict(background_mask="1minus"),
             "separate_gt": dict(scale_mask="separate_gt"),
             "bg_only": dict(scale_mask="bg_only"),
             "ts_attention": dict(spatial_attentions=["teacher_student"]),
             "l1_feat": dict(feat_criterion=dict(type="L1Loss",
                                                 reduction="none")),
             "no_channel": dict(channel_mask=False),
             "no_spatial": dict(spatial_mask=False)}


@pytest.mark.parametrize("case", list(FGD_CASES))
def test_fgd_loss_matches_jax(case):
    """The flagship knob set and the seven variants of
    ``test_golden_fgd.py``, with the JAX adaptation weights."""
    params = golden_fgd.base_params(**FGD_CASES[case])
    d = golden_fgd.make_inputs(0 if case == "shipped" else 1)
    ref, variables = golden_fgd.run_repo(params, d)
    dist = Distiller("fgd", params, golden_fgd.TRAIN_CFG)
    p = variables["params"]
    sd = {"channel_wise_adaptations.0.conv.weight": np.asarray(
        p["student_adapt_0"]["conv"]["kernel"]).transpose(3, 2, 0, 1),
          "channel_wise_adaptations.0.conv.bias": np.asarray(
        p["student_adapt_0"]["conv"]["bias"])}
    if params.get("spatial_mask", True):
        sd["spatial_wise_adaptations.0.weight"] = np.asarray(
            p["spatial_adapt_0"]["kernel"]).transpose(3, 2, 0, 1)
        sd["spatial_wise_adaptations.0.bias"] = np.asarray(
            p["spatial_adapt_0"]["bias"])
    dist.load_state_dict({k: torch.from_numpy(v.copy())
                          for k, v in sd.items()}, strict=True)

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))

    got = dist.fgd_loss(0, nchw(d["t_feat"]), nchw(d["s_feat"]),
                        torch.from_numpy(d["boxes"]),
                        torch.from_numpy(d["gt_mask"]))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k].detach()), ref[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_fgd_unported_branches_raise():
    for knobs in (dict(foreground_mask="gauss"), dict(non_empty_weight=0.2),
                  dict(fp_as_foreground=["teacher"]),
                  dict(affinity_mode="foreground"),
                  dict(scale_mask="combine_extend")):
        with pytest.raises(NotImplementedError):
            Distiller("fgd", golden_fgd.base_params(**knobs),
                      golden_fgd.TRAIN_CFG)
    with pytest.raises(NotImplementedError):
        Distiller("all", golden_fgd.base_params(), golden_fgd.TRAIN_CFG)
    with pytest.raises(ValueError, match="unknown"):
        Distiller("fgd", golden_fgd.base_params(typo_knob=1),
                  golden_fgd.TRAIN_CFG)


@pytest.mark.parametrize("lr_config", [
    dict(policy="step", step=[1, 2]),
    dict(policy="step", step=[1, 2], gamma=0.5, min_lr=6e-5,
         warmup="linear", warmup_iters=3, warmup_ratio=0.25),
    dict(policy="CosineAnnealing", warmup="linear", warmup_iters=3,
         warmup_ratio=1.0 / 3, min_lr_ratio=1e-3)],
    ids=["step", "step_warmup_floor", "cosine"])
def test_lr_schedules_match_jax(lr_config):
    ref = jax_schedules.build_lr_schedule(lr_config, 2e-4, 20, 3)
    got = build_lr_schedule(lr_config, 2e-4, 20, 3)
    for s in range(12):
        np.testing.assert_allclose(got(s), float(ref(s)), rtol=1e-6,
                                   err_msg=f"step {s}")


def test_adamw_clip_step_schedule_matches_optax():
    """AdamW 2e-4, weight decay 1e-2, clip at 5, the step policy with
    milestones inside the run: five updates, the first ones clipped."""
    rng = np.random.RandomState(7)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3),
                                torch.nn.Linear(5, 2))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    names = [n for n, _ in model.named_parameters()]
    jparams = {n: jnp.asarray(_np(p)) for n, p in model.named_parameters()}
    lr_cfg = dict(policy="step", step=[1, 2])
    opt_cfg = dict(type="AdamW", lr=2e-4, weight_decay=1e-2)
    tx = jax_optim.build_optimizer(
        opt_cfg, jax_schedules.build_lr_schedule(lr_cfg, 2e-4, 100, 2),
        jparams, grad_clip=dict(max_norm=5))
    state = tx.init(jparams)
    opt = build_optimizer(opt_cfg, build_lr_schedule(lr_cfg, 2e-4, 100, 2),
                          model, dict(max_norm=5))
    for step, scale in enumerate((30.0, 10.0, 1.0, 0.2, 0.05)):
        grads = {n: (rng.randn(*jparams[n].shape) * scale).astype(
            np.float32) for n in names}
        updates, state = tx.update({n: jnp.asarray(g) for n, g in
                                    grads.items()}, state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        opt.zero_grad()
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        norm = opt.step(step)
        np.testing.assert_allclose(float(norm), np.sqrt(sum(
            (g.astype(np.float64) ** 2).sum() for g in grads.values())),
            rtol=1e-5)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(_np(p), np.asarray(jparams[n]),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{n} step {step}")


def test_distill_epoch_gates():
    """``two_stage_epoch`` zeroes every pairing's losses before its epoch
    and ``multi_scale_epoch`` the backbone pairings'."""
    from distillbev_tpu_torch.models.detectors.bevdet import \
        StudentFeatureBundle
    from distillbev_tpu_torch.models.detectors.centerpoint import \
        FeatureBundle
    student, _, _ = flagship.build_flagship(tiny=True, device="cpu")
    rng = np.random.RandomState(10)
    s_b = StudentFeatureBundle(torch.from_numpy(
        rng.randn(1, 256, 32, 32).astype(np.float32)), None, None)
    t_b = FeatureBundle(None, None, torch.from_numpy(
        rng.randn(1, 384, 32, 32).astype(np.float32)))
    gt, _, mask = _gt(rng, b=1)
    args = (s_b, t_b, torch.from_numpy(gt), torch.from_numpy(mask))
    with torch.no_grad():
        on = student.distill_losses(*args, epoch=1.0)
        student.distill_params["two_stage_epoch"] = 3
        before = student.distill_losses(*args, epoch=2.0)
        after = student.distill_losses(*args, epoch=3.0)
    assert len(on) == 4 and all(float(v) > 0 for v in on.values())
    assert all(float(v) == 0 for v in before.values())
    assert all(torch.equal(after[k], on[k]) for k in on)


# -- the whole tiny distill step -------------------------------------------

# gradients downstream of the BEV encoder and upstream of it
NEAR_GRADS = (
    "img_bev_encoder_neck.up2.4.weight",
    "pts_bbox_head.task_heads.3.heatmap.1.weight",
    "pts_bbox_head.task_heads.0.reg.0.conv.weight",
    "distiller.channel_wise_adaptations.0.conv.weight",
    "distiller.spatial_wise_adaptations.0.weight",
)
DEEP_GRADS = (
    "img_backbone.conv1.weight", "img_backbone.layer4.1.conv2.weight",
    "img_backbone.layer2.0.bn1.weight", "img_neck.fpn_convs.0.conv.weight",
    "img_view_transformer.featnet.weight",
    "img_view_transformer.depthnet.weight",
    "img_view_transformer.se.fc.1.weight",
    "img_view_transformer.dcn.0.weight",
    "pre_process_net.layers.0.0.conv1.weight",
    "img_bev_encoder_backbone.layers.2.1.conv2.weight",
    "pts_bbox_head.shared_conv.bn.weight",
)
SEL_GRADS = NEAR_GRADS + DEEP_GRADS
SEL_STATS = ("img_backbone.bn1.running_mean", "img_backbone.bn1.running_var",
             "img_view_transformer.se.fc.0.running_mean",
             "img_view_transformer.dcn.1.running_mean",
             "pre_process_net.layers.0.1.bn2.running_var",
             "img_bev_encoder_neck.up2.2.running_mean",
             "pts_bbox_head.task_heads.5.vel.0.bn.running_var")


def _s_cfg():
    return flagship.bevdepth4d_distill_cfg(18)


class _JnpFloat64(types.ModuleType):
    """``jax.numpy`` with ``float32`` read as ``float64``: stood in for the
    JAX ``models/layers.py``'s ``jnp`` so that its BatchNorm takes its
    batch statistics in float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _f32(flat):
    return {k: np.asarray(v, np.float32) for k, v in flat.items()}


@pytest.fixture(scope="module")
def jax_run():
    """JAX in float64: the tiny flagship with randomised variables, one
    jitted value-and-grad of the distill loss, and N_SGD SGD steps."""
    student, teacher, svars, tvars, batch = jax_flagship.build_flagship(
        tiny=True)
    rng = np.random.RandomState(0)
    # the student keeps its init (random running statistics only: its
    # training-mode BatchNorm reads none); the eval-mode teacher gets
    # random statistics, affines, biases
    sflat = flatten_variables(svars)
    for k, v in sflat.items():
        if k.endswith("/mean") or k.endswith("/var"):
            sflat[k] = rng.uniform(0.5, 1.5, v.shape)
    sflat, tflat = _f32(sflat), _f32(randomize(tvars, rng))

    def f64(a):
        a = np.asarray(a)
        return jnp.asarray(a, jnp.float64 if a.dtype.kind == "f"
                           else a.dtype)

    def loss_fn(params, stats, batch, tvars):
        gt = jax_gravity_centered(batch.gt_boxes)
        _, t_bundle = teacher.apply(tvars, batch.points, batch.point_mask,
                                    train=False)
        t_bundle = jax.lax.stop_gradient(t_bundle)
        variables = {"params": params, "batch_stats": stats}
        (preds, bundle, depth), new = student.apply(
            variables, batch.img_inputs, train=True, mutable=["batch_stats"])
        det, targets = student.apply(variables, preds, gt, batch.gt_labels,
                                     batch.gt_mask, True,
                                     method=student.head_loss)
        losses = dict(det)
        losses["loss_depth"] = student.apply(
            variables, depth, batch.img_inputs.depth_gt,
            method=student.depth_loss)
        losses.update(student.apply(
            variables, bundle, preds, t_bundle, None, gt, batch.gt_labels,
            batch.gt_mask, targets[0], jnp.float32(1.0), True,
            method=student.distill_losses))
        return sum(jax.tree_util.tree_leaves(losses)), (
            losses, new["batch_stats"])

    steps = []
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_layers, "jnp", _JnpFloat64("jnp"))
        svars64 = jax.tree_util.tree_map(f64, unflatten(sflat))
        tvars64 = jax.tree_util.tree_map(f64, unflatten(tflat))
        batch64 = jax.tree_util.tree_map(f64, batch)
        step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        params, stats = svars64["params"], svars64["batch_stats"]
        for _ in range(N_SGD):
            (total, (losses, new_stats)), grads = step(params, stats,
                                                       batch64, tvars64)
            steps.append(dict(
                total=float(total),
                grads=jax.tree_util.tree_map(np.asarray, grads),
                stats=jax.tree_util.tree_map(np.asarray, new_stats),
                losses={k: float(v) for k, v in losses.items()}))
            norm = float(optax_global_norm(grads))
            scale = SGD_LR * min(1.0, MAX_NORM / norm)
            params = jax.tree_util.tree_map(lambda p, g: p - scale * g,
                                            params, grads)
            stats = new_stats
        update = jax.tree_util.tree_map(lambda p, q: np.asarray(p - q),
                                        params, svars64["params"])
    return dict(sflat=sflat, tflat=tflat, batch=batch, steps=steps,
                update=update)


class _SGD:
    """The optimizer interface of ``make_distill_train_step``: SGD after
    the global-norm clip; keeps each step's gradients and running
    statistics."""

    def __init__(self, model):
        self.model = model
        self.grads, self.stats = [], []

    def zero_grad(self):
        self.model.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self, step):
        named = dict(self.model.named_parameters())
        self.grads.append({n: named[n].grad.clone() for n in SEL_GRADS})
        self.stats.append({k: v.clone() for k, v in
                           self.model.state_dict().items()
                           if k in SEL_STATS})
        norm = clip_by_global_norm_(list(named.values()), MAX_NORM)
        for p in named.values():
            p -= SGD_LR * p.grad
        return norm


def _port_batch(jb):
    def t(a, dtype=None):
        out = torch.from_numpy(np.array(a))
        return out if dtype is None else out.to(dtype)
    return DistillBatch(ImgInputs(*(t(a) for a in jb.img_inputs)),
                        t(jb.points), t(jb.point_mask), t(jb.gt_boxes),
                        t(jb.gt_labels, torch.int64), t(jb.gt_mask))


def _port_models(jax_run, dtype):
    student, teacher, _ = flagship.build_flagship(tiny=True, device="cpu")
    student.load_state_dict(bevdepth4d_distill_params_to_torch(
        jax_run["sflat"], _s_cfg()), strict=True)
    teacher.load_state_dict(centerpoint_params_to_torch(
        jax_run["tflat"], flagship.centerpoint_teacher_cfg()), strict=True)
    b = _port_batch(jax_run["batch"])
    batch = DistillBatch(
        ImgInputs(*(a.to(dtype) for a in b.img_inputs)),
        b.points.to(dtype), b.point_mask, b.gt_boxes.to(dtype),
        b.gt_labels, b.gt_mask)
    return student.to(dtype), teacher.to(dtype), batch


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port in float64: N_SGD steps of ``make_distill_train_step``."""
    student, teacher, batch = _port_models(jax_run, torch.float64)
    init = {n: p.detach().clone() for n, p in student.named_parameters()}
    opt = _SGD(student)
    step_fn = make_distill_train_step(student, teacher, opt)
    metrics = [step_fn(batch, i) for i in range(N_SGD)]
    return dict(metrics=metrics, grads=opt.grads, stats=opt.stats,
                update={n: p.detach() - init[n]
                        for n, p in student.named_parameters()})


def _ref_sd(jax_run, tree):
    flat = dict(jax_run["sflat"])
    flat.update(flatten_variables(tree))
    return bevdepth4d_distill_params_to_torch(flat, _s_cfg())


def test_tiny_distill_step_losses_grads_and_stats_match_jax(jax_run,
                                                            port_run):
    """Step 0 in float64 on both sides: the loss dict, selected gradients
    (relative to their norm) and the BN running statistics."""
    ref, got = jax_run["steps"][0], port_run["metrics"][0]
    assert set(got) == set(ref["losses"]) | {"total_loss", "grad_norm"}
    assert len(ref["losses"]) == 17
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(float(got[k]), v, rtol=LOSS_RTOL,
                                   atol=1e-8, err_msg=k)
    np.testing.assert_allclose(float(got["total_loss"]), ref["total"],
                               rtol=LOSS_RTOL)
    ref_sd = _ref_sd(jax_run, {"params": ref["grads"],
                               "batch_stats": ref["stats"]})
    for name in SEL_GRADS:
        r = ref_sd[name].double()
        err = float((port_run["grads"][0][name] - r).norm() / r.norm())
        assert err < GRAD_RTOL, (name, err)
    # running statistics after one call each of the two frames' shared
    # modules (two EMA updates) and of the BEV encoder (one)
    for name in SEL_STATS:
        np.testing.assert_allclose(_np(port_run["stats"][0][name]),
                                   _np(ref_sd[name]), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_tiny_distill_sgd_steps_track_jax(jax_run, port_run):
    """Three clipped SGD steps in float64: every step's losses, and the
    parameters' update over the three steps."""
    for i, (ref, got) in enumerate(zip(jax_run["steps"],
                                       port_run["metrics"])):
        for k, v in ref["losses"].items():
            np.testing.assert_allclose(float(got[k]), v,
                                       rtol=STEPS_LOSS_RTOL, atol=1e-8,
                                       err_msg=f"step {i} {k}")
    ref_upd = _ref_sd(jax_run, {"params": jax_run["update"]})
    sq_diff = sum(float(((u - ref_upd[n].double()) ** 2).sum())
                  for n, u in port_run["update"].items())
    sq_upd = sum(float((ref_upd[n].double() ** 2).sum())
                 for n in port_run["update"])
    assert 0 < sq_diff <= UPDATE_RTOL ** 2 * sq_upd, (sq_diff, sq_upd)
    first = jax_run["steps"][0]["total"]
    assert abs(jax_run["steps"][-1]["total"] / first - 1) > 1e-3


def test_tiny_distill_step_fp32_matches_float64(jax_run, port_run):
    """The port's fp32 step against its float64 run: the losses and the
    selected gradients."""
    student, teacher, batch = _port_models(jax_run, torch.float32)
    opt = _SGD(student)
    got = make_distill_train_step(student, teacher, opt)(batch, 0)
    for k, v in port_run["metrics"][0].items():
        if k != "grad_norm":
            np.testing.assert_allclose(float(got[k]), float(v),
                                       rtol=FP32_LOSS_RTOL, err_msg=k)
    for name in SEL_GRADS:
        r = port_run["grads"][0][name]
        err = float((opt.grads[0][name].double() - r).norm() / r.norm())
        assert err < (FP32_NEAR_RTOL if name in NEAR_GRADS
                      else FP32_DEEP_RTOL), (name, err)


def test_tiny_flagship_batch_is_the_jax_draw(jax_run):
    """The port's own ``build_flagship(tiny=True)`` batch: the JAX numpy
    draws (points, GT, depth and cameras) from the same seed."""
    _, _, batch = flagship.build_flagship(tiny=True, device="cpu")
    ref = _port_batch(jax_run["batch"])
    for name in ("points", "point_mask", "gt_boxes", "gt_labels",
                 "gt_mask"):
        assert torch.equal(getattr(batch, name), getattr(ref, name)), name
    for name in ("rots", "trans", "intrins", "post_rots", "post_trans",
                 "depth_gt"):
        assert torch.equal(getattr(batch.img_inputs, name),
                           getattr(ref.img_inputs, name)), name
    assert batch.img_inputs.imgs.shape == ref.img_inputs.imgs.shape


def test_frame_one_splat_runs_no_backward_gather(monkeypatch):
    """Frame 1 reaches the BEV encoder detached: of the two splats of a
    step only frame 0's backward gathers."""
    from distillbev_tpu_torch.ops import bev_pool
    calls = []
    real = bev_pool.gather_rows
    monkeypatch.setattr(bev_pool, "gather_rows",
                        lambda *a: calls.append(1) or real(*a))
    scatters = []
    real_scatter = bev_pool.scatter_add_rows_batched
    monkeypatch.setattr(bev_pool, "scatter_add_rows_batched",
                        lambda *a: scatters.append(1) or real_scatter(*a))
    student, teacher, batch = flagship.build_flagship(tiny=True,
                                                      device="cpu")
    opt = _SGD(student)
    make_distill_train_step(student, teacher, opt)(batch, 0)
    assert len(scatters) == 2 and len(calls) == 1
    assert student.training and not teacher.training
