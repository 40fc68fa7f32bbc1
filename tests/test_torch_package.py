"""Package rules of the PyTorch port.

* ``distillbev_tpu_torch`` and every module of it import with JAX absent,
  and pull in no module of the JAX package; no port file (nor
  ``chip_smoke.py``) names ``jax``, ``flax`` or ``distillbev_tpu`` in an
  import.
* Its entry points default to the card (``device="cuda"``).
* The JAX ``BEVDepth4D``'s and ``BEVFormer``'s variables load strictly
  into the port; ``bevformer_r50_cfg()`` builds in both packages (the
  teachers' are held in ``test_torch_centerpoint.py``).
"""
import inspect
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "distillbev_tpu_torch")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import distillbev_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in ("ops.segmented", "ops.segmented_scan", "ops.scatter",
             "ops.voxelize", "models.detectors.centerpoint"):
    assert pkg.__name__ + "." + name in names, name
import chip_smoke
bad = [m for m in sys.modules
       if m == "distillbev_tpu" or m.startswith("distillbev_tpu.")]
assert not bad, bad
print(len(names))
"""


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20


def test_no_port_file_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(from|import)\s+(jax|flax|distillbev_tpu)\b",
                     re.M)
    offenders = [f for f in _port_files() if pat.search(open(f).read())]
    assert not offenders, offenders


def test_entry_points_default_to_the_card():
    from distillbev_tpu_torch.apis import flagship
    from distillbev_tpu_torch.apis.test import run_eval
    for fn in (flagship.build_flagship_student,
               flagship.make_example_batch, flagship.build_bevformer,
               flagship.make_bevformer_example_batch, flagship.build_teacher,
               flagship.make_points_example_batch, run_eval):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_does_not_fall_back_to_the_cpu():
    import torch
    from distillbev_tpu_torch.apis import flagship
    from distillbev_tpu_torch.apis.test import run_eval
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises((RuntimeError, AssertionError)):
        flagship.make_example_batch(1, img_hw=(32, 64))
    with pytest.raises((RuntimeError, AssertionError)):
        flagship.make_points_example_batch(1, 100)
    model, batch = flagship.build_flagship_student(tiny=True, device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        run_eval(model, [{"img_inputs": batch,
                          "img_metas": [{"sample_idx": "t"}]}])


def test_jax_variables_load_strictly():
    import test_golden_detector as golden
    from distillbev_tpu.models import build_detector as jax_build_detector
    from distillbev_tpu.models.detectors.bevdet import ImgInputs
    from distillbev_tpu_torch.models import build_detector
    from distillbev_tpu_torch.utils.convert import jax_params_to_torch
    cfg = golden._jax_cfg()
    n = golden.N_CAMS
    h, w = golden.DATA["input_size"]
    z = np.zeros
    inputs = ImgInputs(z((1, 2 * n, h, w, 3), np.float32),
                       np.tile(np.eye(3, dtype=np.float32), (1, 2, n, 1, 1)),
                       z((1, 2, n, 3), np.float32),
                       np.tile(np.eye(3, dtype=np.float32), (1, 2, n, 1, 1)),
                       np.tile(np.eye(3, dtype=np.float32), (1, 2, n, 1, 1)),
                       z((1, 2, n, 3), np.float32))
    shapes = jax.eval_shape(jax_build_detector(cfg).init,
                            jax.random.PRNGKey(0), inputs)
    rng = np.random.RandomState(0)
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat = {"/".join(k.key for k in path):
            rng.randn(*leaf.shape).astype(np.float32)
            for path, leaf in leaves}
    sd = jax_params_to_torch(flat)
    model = build_detector(cfg)
    model.load_state_dict(sd, strict=True)
    key = "img_backbone.layer1.0.conv2.weight"
    np.testing.assert_array_equal(
        model.state_dict()[key].numpy(),
        flat["params/backbone/layer1_block0/conv2/kernel"].transpose(
            3, 2, 0, 1))


def test_bevformer_r50_variables_load_strictly():
    """The full BEVFormer-R50 config builds in both packages, and every
    JAX variable of it has its place in the port (parameter shapes do
    not depend on the image size, so the JAX side is traced on small
    images)."""
    import torch
    from distillbev_tpu.models import build_detector as jax_build_detector
    from distillbev_tpu_torch.apis.flagship import (
        bevformer_r50_cfg, nuscenes_like_lidar2img)
    from distillbev_tpu_torch.models import build_detector
    from distillbev_tpu_torch.utils.convert import bevformer_params_to_torch
    cfg = bevformer_r50_cfg()
    h, w = 64, 96
    l2i = np.tile(nuscenes_like_lidar2img(h, w)[None, None], (1, 2, 1, 1, 1))
    shapes = jax.eval_shape(
        jax_build_detector(cfg).init, jax.random.PRNGKey(0),
        np.zeros((1, 2, 6, h, w, 3), np.float32),
        np.zeros((1, 2, 18), np.float32), l2i, np.ones((1, 2), np.float32))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    flat = {"/".join(k.key for k in path): np.zeros(leaf.shape, np.float32)
            for path, leaf in leaves}
    model = build_detector(cfg)
    sd = bevformer_params_to_torch(flat, cfg)
    model.load_state_dict(sd, strict=True)
    n_jax = sum(int(np.prod(leaf.shape)) for path, leaf in leaves
                if path[0].key == "params")
    n_port = sum(p.numel() for p in model.parameters())
    assert n_port == n_jax and n_port > 40_000_000
    assert isinstance(sd["pts_bbox_head.bev_embedding.weight"], torch.Tensor)
