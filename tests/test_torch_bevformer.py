"""The port's BEVFormer train step against the JAX package.

One tiny BEVFormer (``bevformer_tiny_cfg``: ResNet-18 base 8, embed 32,
4 heads, 2 + 2 layers, BEV 24x24 so that TSA and the decoder take the
gather route, queue 2, six nuScenes-like cameras) is initialised in JAX;
its variables, with random BatchNorm statistics, reach the port through
``utils/convert.py:bevformer_params_to_torch`` (strict load).  Inputs are
seeded numpy arrays given to both packages; dropout and GridMask are off.

Tolerances (fp32 on the CPU, sums in other orders, the Hungarian match
on the same costs): modules rtol/atol 1e-4; whole-model outputs and
losses rtol/atol 1e-4; gradients rtol 1e-3 / atol 1e-5; the losses of 3
SGD steps rtol 1e-3; AdamW rtol/atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from distillbev_tpu.core.bbox.coders import NMSFreeCoder as JaxNMSFreeCoder
from distillbev_tpu.models import build_detector as jax_build_detector
from distillbev_tpu.models.dense_heads.bevformer_head import \
    BEVFormerHead as JaxHead
from distillbev_tpu.models.transformer import attention as jax_attention
from distillbev_tpu.models.transformer import encoder as jax_encoder
from distillbev_tpu.models.transformer.decoder import \
    DetectionTransformerDecoder as JaxDecoder
from distillbev_tpu.models.transformer.perception_transformer import \
    PerceptionTransformer as JaxPT
from distillbev_tpu.training.optim import build_optimizer as jax_optimizer
from distillbev_tpu.training.schedules import \
    build_lr_schedule as jax_schedule
from distillbev_tpu_torch.apis import flagship
from distillbev_tpu_torch.core.bbox.coders import NMSFreeCoder
from distillbev_tpu_torch.models import build_detector
from distillbev_tpu_torch.models.transformer.encoder import point_sampling
from distillbev_tpu_torch.models.utils.grid_mask import grid_mask
from distillbev_tpu_torch.training import gravity_centered
from distillbev_tpu_torch.training.optim import build_optimizer
from distillbev_tpu_torch.training.schedules import build_lr_schedule
from distillbev_tpu_torch.utils.convert import (bevformer_params_to_torch,
                                                flatten_variables)

MOD_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
EMBED, HEADS, BEV = 32, 4, 24


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(scope="module")
def setup():
    cfg = flagship.bevformer_tiny_cfg()
    batch = flagship.make_bevformer_example_batch(
        1, queue=2, img_hw=flagship.TINY_BEVFORMER_IMG, n_obj=8, n_real=6,
        pc_range=flagship.TINY_BEVFORMER_PCR, num_classes=4, seed=3,
        device="cpu")
    jmodel = jax_build_detector(cfg)
    jin = tuple(jnp.asarray(_np(a)) for a in batch[:4])
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *jin)
    flat = flatten_variables(variables)
    rng = np.random.RandomState(0)
    for k, v in flat.items():
        if k.endswith("/mean"):
            flat[k] = rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    variables = jax.tree_util.tree_map(jnp.asarray, _unflatten(flat))
    model = build_detector(cfg)
    model.load_state_dict(bevformer_params_to_torch(flat, cfg), strict=True)
    gt = gravity_centered(batch.gt_boxes)
    return dict(cfg=cfg, batch=batch, jmodel=jmodel, jin=jin,
                variables=variables, model=model, gt=gt,
                jgt=(jnp.asarray(_np(gt)), jnp.asarray(_np(batch.gt_labels)),
                     jnp.asarray(_np(batch.gt_mask))))


def _unflatten(flat):
    root = {}
    for key, v in flat.items():
        d = root
        *path, leaf = key.split("/")
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return root


def _params(setup, *path):
    d = setup["variables"]["params"]
    for p in path:
        d = d[p]
    return d


def _encoder_params(setup, i):
    enc = _params(setup, "bbox_head", "transformer", "encoder")
    return jax.tree_util.tree_map(lambda a: a[i], enc["layers"])


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _geometry(rng, setup):
    """SCA geometry of the batch's current frame, and the image levels."""
    h, w = flagship.TINY_BEVFORMER_IMG
    shapes = ((h // 8, w // 8), (h // 16, w // 16), (h // 32, w // 32),
              (-(-h // 64), -(-w // 64)))
    ref_3d = torch.from_numpy(jax_encoder.get_reference_points_3d(
        BEV, BEV, 8.0, 4))
    ref_cam, bev_mask = point_sampling(
        ref_3d, flagship.TINY_BEVFORMER_PCR, setup["batch"].lidar2img[:, -1],
        (h, w))
    return shapes, ref_cam.numpy(), bev_mask.numpy()


def test_tsa_matches_jax(setup):
    rng = np.random.RandomState(1)
    q = BEV * BEV
    query, pos = _rand(rng, 1, q, EMBED), _rand(rng, 1, q, EMBED)
    value = _rand(rng, 2, q, EMBED)
    ref = np.repeat(jax_encoder.get_reference_points_2d(BEV, BEV)[None], 2,
                    0) + _rand(rng, 2, q, 1, 2, scale=0.02)
    jtsa = jax_attention.TemporalSelfAttention(
        embed_dims=EMBED, num_heads=HEADS, num_points=4, dropout=0.0)
    ref_out = jtsa.apply({"params": _encoder_params(setup, 0)["tsa"]},
                         query, value=value, query_pos=pos,
                         reference_points=ref, spatial_shapes=((BEV, BEV),))
    tsa = setup["model"].pts_bbox_head.transformer.encoder.layers[0] \
        .attentions[0]
    out = tsa(_t(query), value=_t(value), query_pos=_t(pos),
              reference_points=_t(ref), spatial_shapes=((BEV, BEV),))
    np.testing.assert_allclose(_np(out), np.asarray(ref_out), **MOD_TOL)


def test_sca_matches_jax(setup):
    rng = np.random.RandomState(2)
    shapes, ref_cam, bev_mask = _geometry(rng, setup)
    q = BEV * BEV
    query = _rand(rng, 1, q, EMBED)
    value = _rand(rng, 1, 6, sum(h * w for h, w in shapes), EMBED)
    jsca = jax_attention.SpatialCrossAttention(
        embed_dims=EMBED, num_cams=6, dropout=0.0,
        deformable_attention=dict(num_heads=HEADS, num_levels=4,
                                  num_points=8))
    ref_out = jsca.apply({"params": _encoder_params(setup, 1)["sca"]},
                         query, value, ref_cam, bev_mask, shapes)
    sca = setup["model"].pts_bbox_head.transformer.encoder.layers[1] \
        .attentions[1]
    out = sca(_t(query), _t(value), _t(ref_cam), _t(bev_mask), shapes)
    np.testing.assert_allclose(_np(out), np.asarray(ref_out), **MOD_TOL)
    # ties in the hit counts: lower query index first, as lax.top_k
    k = sca.budget(q)
    idx_ref = jax_attention.SpatialCrossAttention.select(
        ref_cam, bev_mask, k)[0]
    idx = sca.select(_t(ref_cam), _t(bev_mask), k)[0]
    np.testing.assert_array_equal(_np(idx), np.asarray(idx_ref))


def test_encoder_layer_matches_jax(setup):
    rng = np.random.RandomState(4)
    shapes, ref_cam, bev_mask = _geometry(rng, setup)
    q = BEV * BEV
    query, prev, pos, init = (_rand(rng, 1, q, EMBED) for _ in range(4))
    value = _rand(rng, 1, 6, sum(h * w for h, w in shapes), EMBED)
    ref_2d = jax_encoder.get_reference_points_2d(BEV, BEV)[None]
    shift = np.array([[0.03, -0.02]], np.float32)
    valid = np.array([1.0], np.float32)
    args = (query, value, prev, ref_2d, ref_cam, bev_mask, pos, shapes,
            (BEV, BEV))
    jlayer = jax_encoder.BEVFormerLayer(
        embed_dims=EMBED, num_heads=HEADS, feedforward_channels=64,
        num_levels=4, dropout=0.0)
    ref_out = jlayer.apply({"params": _encoder_params(setup, 0)}, *args,
                           shift=shift, prev_valid=valid, init_query=init)
    layer = setup["model"].pts_bbox_head.transformer.encoder.layers[0]
    out = layer(*[_t(a) if isinstance(a, np.ndarray) else a for a in args],
                shift=_t(shift), prev_valid=_t(valid), init_query=_t(init))
    np.testing.assert_allclose(_np(out), np.asarray(ref_out), **MOD_TOL)


def _jax_reg_branch(lvl, x):
    for i in range(2):
        x = nn.relu(nn.Dense(EMBED, name=f"reg_{lvl}_fc{i}")(x))
    return nn.Dense(10, name=f"reg_{lvl}_out")(x)


def test_decoder_matches_jax(setup):
    rng = np.random.RandomState(5)
    nq = 20
    query, qpos = _rand(rng, 1, nq, EMBED), _rand(rng, 1, nq, EMBED)
    value = _rand(rng, 1, BEV * BEV, EMBED)
    ref = rng.uniform(0.05, 0.95, (1, nq, 3)).astype(np.float32)
    jdec = JaxDecoder(num_layers=2, embed_dims=EMBED, num_heads=HEADS,
                      feedforward_channels=64, dropout=0.0)
    params = _params(setup, "bbox_head", "transformer", "decoder")
    states_ref, refs_ref = jdec.apply(
        {"params": params}, query, value, qpos, ref, ((BEV, BEV),),
        reg_branch=_jax_reg_branch)
    dec = setup["model"].pts_bbox_head.transformer.decoder
    states, refs = dec(_t(query), _t(value), _t(qpos), _t(ref),
                       ((BEV, BEV),))
    np.testing.assert_allclose(_np(states), np.asarray(states_ref),
                               **MOD_TOL)
    np.testing.assert_allclose(_np(refs), np.asarray(refs_ref), **MOD_TOL)


def _mlvl_feats(rng):
    h, w = flagship.TINY_BEVFORMER_IMG
    return [_rand(rng, 1, 6, -(-h // s), -(-w // s), EMBED)
            for s in (8, 16, 32, 64)]


def test_perception_transformer_bev_matches_jax(setup):
    rng = np.random.RandomState(6)
    feats = _mlvl_feats(rng)
    t_cfg = dict(setup["cfg"]["pts_bbox_head"]["transformer"])
    t_cfg.pop("type")
    q = BEV * BEV
    bev_q, pos, prev = (_rand(rng, *s) for s in ((q, EMBED), (1, q, EMBED),
                                                 (1, q, EMBED)))
    obj = _rand(rng, 20, 2 * EMBED)
    can_bus = _rand(rng, 1, 18, scale=0.5)
    l2i = _np(setup["batch"].lidar2img[:, -1])
    kw = dict(grid_length=(16.0 / BEV, 16.0 / BEV),
              img_shape=flagship.TINY_BEVFORMER_IMG, only_bev=True)
    ref = JaxPT(**t_cfg).apply(
        {"params": _params(setup, "bbox_head", "transformer")}, feats, bev_q,
        obj, BEV, BEV, bev_pos=pos, prev_bev=prev, can_bus=can_bus,
        lidar2img=l2i, prev_valid=np.ones(1, np.float32), **kw)
    pt = setup["model"].pts_bbox_head.transformer
    out = pt([_t(f) for f in feats], _t(bev_q), _t(obj), BEV, BEV,
             bev_pos=_t(pos), prev_bev=_t(prev), can_bus=_t(can_bus),
             lidar2img=_t(l2i), prev_valid=torch.ones(1), **kw)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **MOD_TOL)


def test_head_forward_matches_jax(setup):
    rng = np.random.RandomState(7)
    feats = _mlvl_feats(rng)
    h_cfg = dict(setup["cfg"]["pts_bbox_head"])
    h_cfg.pop("type")
    h_cfg["train_cfg"] = setup["cfg"]["train_cfg"]["pts"]
    can_bus = _rand(rng, 1, 18, scale=0.5)
    l2i = _np(setup["batch"].lidar2img[:, -1])
    kw = dict(img_shape=flagship.TINY_BEVFORMER_IMG)
    ref = JaxHead(**h_cfg).apply(
        {"params": _params(setup, "bbox_head")}, feats, can_bus=can_bus,
        lidar2img=l2i, **kw)
    out = setup["model"].pts_bbox_head([_t(f) for f in feats],
                                       can_bus=_t(can_bus),
                                       lidar2img=_t(l2i), **kw)
    for key in ("bev_embed", "all_cls_scores", "all_bbox_preds", "hs"):
        np.testing.assert_allclose(_np(out[key]), np.asarray(ref[key]),
                                   err_msg=key, **MOD_TOL)


# parameters whose gradients are compared: one per module kind
GRAD_PARAMS = (
    "img_backbone.layer3.0.conv2.weight",
    "img_neck.fpn_convs.3.conv.weight",
    "pts_bbox_head.bev_embedding.weight",
    "pts_bbox_head.positional_encoding.row_embed.weight",
    "pts_bbox_head.transformer.level_embeds",
    "pts_bbox_head.transformer.can_bus_mlp.0.weight",
    "pts_bbox_head.transformer.encoder.layers.1.attentions.0"
    ".sampling_offsets.bias",
    "pts_bbox_head.transformer.encoder.layers.0.attentions.1"
    ".deformable_attention.value_proj.weight",
    "pts_bbox_head.transformer.encoder.layers.0.ffns.0.layers.1.weight",
    "pts_bbox_head.transformer.decoder.layers.1.attentions.0.attn"
    ".in_proj_weight",
    "pts_bbox_head.transformer.decoder.layers.0.attentions.1"
    ".attention_weights.weight",
    "pts_bbox_head.cls_branches.1.6.bias",
    "pts_bbox_head.reg_branches.1.4.weight",
)


def _jax_loss_fn(setup):
    jmodel, jin, jgt = setup["jmodel"], setup["jin"], setup["jgt"]
    stats = setup["variables"]["batch_stats"]

    def loss_fn(params):
        v = {"params": params, "batch_stats": stats}
        outs, _ = jmodel.apply(v, *jin)
        losses = jmodel.apply(v, outs, *jgt, method=jmodel.loss)
        return sum(jax.tree_util.tree_leaves(losses)), (losses, outs)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _port_loss(setup):
    model, batch = setup["model"], setup["batch"]
    outs = model(batch.imgs, batch.can_bus, batch.lidar2img,
                 batch.prev_exists)
    losses = model.loss(outs, setup["gt"], batch.gt_labels, batch.gt_mask)
    return sum(losses.values()), losses, outs


def _port_grads_as_torch(setup, jgrads):
    flat = flatten_variables({"params": jgrads,
                              "batch_stats": setup["variables"][
                                  "batch_stats"]})
    return bevformer_params_to_torch(flat, setup["cfg"])


@pytest.fixture(scope="module")
def jax_step(setup):
    return _jax_loss_fn(setup)


def test_whole_model_outputs_losses_and_grads(setup, jax_step):
    (jtotal, (jlosses, jouts)), jgrads = jax_step(
        setup["variables"]["params"])
    model = setup["model"]
    model.zero_grad()
    total, losses, outs = _port_loss(setup)
    total.backward()
    for key in ("bev_embed", "all_cls_scores", "all_bbox_preds"):
        np.testing.assert_allclose(_np(outs[key]), np.asarray(jouts[key]),
                                   err_msg=key, **MOD_TOL)
    assert set(losses) == set(jlosses)
    for key in losses:
        np.testing.assert_allclose(_np(losses[key]),
                                   np.asarray(jlosses[key]), err_msg=key,
                                   **MOD_TOL)
    ref = _port_grads_as_torch(setup, jgrads)
    params = dict(model.named_parameters())
    for name in GRAD_PARAMS:
        assert params[name].grad is not None, name
        np.testing.assert_allclose(_np(params[name].grad), _np(ref[name]),
                                   err_msg=name, **GRAD_TOL)
    # the decoder's refinement branches are parameters of their own in
    # the JAX package and feed only the detached reference points: no
    # gradient reaches them in either package
    name = "pts_bbox_head.transformer.decoder.reg_branches.0.0.weight"
    assert params[name].grad is None and not _np(ref[name]).any()
    # frozen: the stem, layer1 and every BatchNorm affine
    for name in ("img_backbone.conv1.weight",
                 "img_backbone.layer1.0.conv1.weight",
                 "img_backbone.layer3.0.bn1.weight"):
        assert not params[name].requires_grad and params[name].grad is None


def test_three_sgd_steps_track_jax(setup, jax_step):
    """SGD on the parameters the port trains (the JAX side masks the
    stem, layer1 and the BatchNorm affines, which the port freezes)."""
    import copy
    lr = 0.05
    model = copy.deepcopy(setup["model"])
    local = dict(setup, model=model)
    trained = {n for n, p in model.named_parameters() if p.requires_grad}
    params = setup["variables"]["params"]
    mask = _trained_mask(setup, params, trained)
    for step in range(3):
        (jtotal, _), jgrads = jax_step(params)
        model.zero_grad()
        total, _, _ = _port_loss(local)
        total.backward()
        np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-3,
                                   err_msg=f"step {step}")
        params = jax.tree_util.tree_map(lambda p, g, m: p - lr * g * m,
                                        params, jgrads, mask)
        with torch.no_grad():
            for p in model.parameters():
                if p.grad is not None:
                    p -= lr * p.grad


def _trained_mask(setup, params, trained):
    """1 where the flax leaf feeds a parameter the port trains."""
    from distillbev_tpu_torch.utils.convert import bevformer_name_map
    pm, _, mha = bevformer_name_map(setup["cfg"])
    live = {"/".join(path) for name, path in pm.items() if name in trained}
    live |= {"/".join(path) for path in mha.values()}
    flat = flatten_variables({"params": params})
    out = {}
    for key in flat:
        path = key.split("/", 1)[1]
        scanned = path.replace("/encoder/layers/", "/encoder/layer_0/")
        keep = any(p == scanned or scanned.startswith(p + "/")
                   for p in live)
        out[key] = np.float32(keep)
    return _unflatten(out)["params"]


def test_adamw_step_with_lr_mult_and_clip_matches_optax():
    rng = np.random.RandomState(9)
    shapes = {"backbone": (7, 5), "head": (11,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    opt_cfg, opt_conf, lr_cfg, total = flagship.bevformer_train_cfg(100)
    sched_j = jax_schedule(lr_cfg, opt_cfg["lr"], total, 100)
    tx = jax_optimizer(opt_cfg, sched_j, {k: jnp.asarray(v) for k, v in
                                          init.items()},
                       grad_clip=opt_conf["grad_clip"])

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.img_backbone = torch.nn.Module()
            self.img_backbone.w = torch.nn.Parameter(_t(init["backbone"]))
            self.head = torch.nn.Module()
            self.head.w = torch.nn.Parameter(_t(init["head"]))

    toy = Toy()
    sched = build_lr_schedule(lr_cfg, opt_cfg["lr"], total, 100)
    opt = build_optimizer(opt_cfg, sched, toy, opt_conf["grad_clip"])
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    for step, scale in enumerate((40.0, 3.0, 60.0)):   # clip, no, clip
        grads = {k: rng.randn(*s).astype(np.float32) * scale
                 for k, s in shapes.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in
                                    grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad()
        toy.img_backbone.w.grad = torch.tensor(grads["backbone"])
        toy.head.w.grad = torch.tensor(grads["head"])
        norm = opt.step(step)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            grads)), rtol=1e-6)
        np.testing.assert_allclose(_np(toy.img_backbone.w),
                                   np.asarray(jparams["backbone"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(toy.head.w),
                                   np.asarray(jparams["head"]), rtol=1e-6,
                                   atol=1e-6)
        assert sched(step) == pytest.approx(float(sched_j(step)), rel=1e-6)


def test_nms_free_decode_matches_jax():
    rng = np.random.RandomState(10)
    cls = _rand(rng, 20, 4) * 3
    box = _rand(rng, 20, 10)
    box[:, :3] *= 6
    pcr = flagship.TINY_BEVFORMER_PCR
    kw = dict(pc_range=pcr, post_center_range=[-10, -10, -10, 10, 10, 10],
              max_num=10, num_classes=4)
    ref = JaxNMSFreeCoder(**kw).decode_single(jnp.asarray(cls),
                                              jnp.asarray(box))
    got = NMSFreeCoder(**kw).decode_single(_t(cls), _t(box))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    assert got.valid.any() and not got.valid.all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grid_mask_geometry(seed):
    """The JAX function's geometry with the generator's draws: the dark
    pixels are the product of a row set and a column set, each a band of
    ``l`` of every ``d`` (offset), ``l = clip(int(d / 2 + 0.5), 1, d - 1)``;
    prob 0 leaves the images alone."""
    imgs = torch.ones(2, 40, 56, 3)
    out = grid_mask(torch.Generator().manual_seed(seed), imgs, prob=1.0)
    dark = out[0, :, :, 0] == 0
    assert torch.equal(out[0], out[1]) and dark.any() and not dark.all()
    rows, cols = dark.any(1), dark.any(0)
    assert torch.equal(dark, rows[:, None] & cols[None, :])
    starts = [i for i in range(1, 40) if rows[i] and not rows[i - 1]]
    if len(starts) >= 2:
        d = starts[1] - starts[0]
        keep = min(max(int(d * 0.5 + 0.5), 1), d - 1)
        assert int(rows[starts[0]:starts[0] + d].sum()) == keep
    same = grid_mask(torch.Generator().manual_seed(seed), imgs, prob=0.0)
    assert torch.equal(same, imgs)
