"""The whole PyTorch ``BEVDepth4D`` serving path against the JAX one.

Forward plus ``get_bboxes`` on the small-but-full config of
``tests/test_golden_detector.py`` (R50, two frames, six 2-class tasks),
with the JAX weights (random BN statistics, a random DCN offset conv)
carried across by ``jax_params_to_torch`` into a strict
``load_state_dict``.  Head maps are held at atol 5e-4 as the golden
test holds the JAX package against torch; decoded boxes by valid count
and the score-sorted valid boxes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_golden_detector as golden
from distillbev_tpu.models import build_detector as jax_build_detector
from distillbev_tpu.models.detectors.bevdet import ImgInputs as JaxInputs
from distillbev_tpu_torch.apis.test import run_eval
from distillbev_tpu_torch.models import build_detector
from distillbev_tpu_torch.utils.convert import jax_params_to_torch
from test_torch_modules import _cameras, randomize, unflatten


def _inputs(rng):
    b, n = 1, golden.N_CAMS
    h, w = golden.DATA["input_size"]
    imgs = rng.randn(b, 2 * n, h, w, 3).astype(np.float32)
    frames = [_cameras(rng, b, n) for _ in range(2)]
    rots, trans, intrins, post_rots, post_trans = (
        np.stack([f[i] for f in frames], 1) for i in range(5))
    trans[:, 1] = trans[:, 0] + np.array([0.4, 0.1, 0.0], np.float32)
    depth_gt = np.zeros((b, n, h // 16, w // 16), np.float32)
    return (imgs, rots, trans, intrins, post_rots, post_trans, depth_gt)


def _sorted_valid(boxes, scores, labels, valid):
    order = np.argsort(-scores[valid], kind="stable")
    return boxes[valid][order], scores[valid][order], labels[valid][order]


def test_bevdepth4d_forward_and_decode_match_jax():
    rng = np.random.RandomState(0)
    arrays = _inputs(rng)
    cfg = golden._jax_cfg()
    jm = jax_build_detector(cfg)
    jin = JaxInputs(*(jnp.asarray(a) for a in arrays))
    flat = randomize(jm.init(jax.random.PRNGKey(0), jin), rng)
    jvars = unflatten(flat)
    ref_preds, _, ref_depth = jm.apply(jvars, jin)
    ref_dec = jm.apply(jvars, ref_preds, method=jm.get_bboxes)

    pt = build_detector(cfg)
    pt.load_state_dict(jax_params_to_torch(flat), strict=True)
    pt.eval()
    with torch.no_grad():
        preds, _, depth = pt(type(jin)(*(torch.from_numpy(a)
                                         for a in arrays)))
    np.testing.assert_allclose(depth.numpy(), np.asarray(ref_depth),
                               rtol=1e-4, atol=1e-4)
    assert len(preds) == len(ref_preds) == 6
    for ti, (p, r) in enumerate(zip(preds, ref_preds)):
        for key in r:
            np.testing.assert_allclose(p[key].numpy(), np.asarray(r[key]),
                                       rtol=1e-4, atol=5e-4,
                                       err_msg=f"task{ti}.{key}")

    results = run_eval(pt, [{"img_inputs": arrays,
                             "img_metas": [{"sample_idx": "tok"}]}],
                       device="cpu")
    boxes, scores, labels, valid = results["tok"]
    ref = [np.asarray(a)[0] for a in ref_dec]
    assert boxes.shape == ref[0].shape == (16, 9)
    assert int(valid.sum()) == int(ref[3].sum()) > 0
    got_b, got_s, got_l = _sorted_valid(boxes, scores, labels, valid)
    ref_b, ref_s, ref_l = _sorted_valid(*ref)
    np.testing.assert_allclose(got_s, ref_s, rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(got_b, ref_b, rtol=1e-4, atol=5e-4)
    np.testing.assert_array_equal(got_l, ref_l)
