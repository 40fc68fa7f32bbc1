"""The port's deformable-attention core and its dvalue scatter against
the JAX package.

* ``scatter_add_rows_expand``: on CPU tensors the port's wrapper takes
  its plain version, held here against the JAX Pallas kernel in
  interpret mode (fp32, one group per JAX call; sums in another order:
  rtol 1e-5 / atol 1e-5).  The CUDA kernel is held against the plain
  version on the card by ``chip_smoke.py`` and the ``cuda`` test below.
* ``ms_deform_attn``: output and the grads of value, locations and
  weights against ``jax.vjp`` of the JAX function (which takes its XLA
  route off the TPU), on levels that mix the gather and the dense route,
  with samples on and past the borders.  Outputs rtol 1e-5 / atol 1e-5,
  grads rtol 1e-4 / atol 1e-5 (fp32, other summation orders).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillbev_tpu.ops.ms_deform_attn import (
    _is_dense as jax_is_dense, ms_deform_attn as jax_msda)
from distillbev_tpu.ops.pallas_scatter import \
    scatter_add_rows_expand as jax_expand
from distillbev_tpu_torch.ops import scatter_rows

# the module (the package exports its function under the same name)
msda = importlib.import_module("distillbev_tpu_torch.ops.ms_deform_attn")

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _expand_inputs(rng, groups, lbp, q, size, c=32, drop=0.1):
    ids = rng.randint(0, size, (groups, lbp, q))
    # the JAX kernel drops ids in [size, size + 8) (its trash rows)
    dropped = rng.rand(groups, lbp, q) < drop
    ids[dropped] = size + rng.randint(0, 8, int(dropped.sum()))
    w = rng.randn(groups, q, 4 * lbp).astype(np.float32)
    g = rng.randn(groups, q, c).astype(np.float32)
    return ids.astype(np.int32), w, g


@pytest.mark.parametrize("groups,lbp,q,size", [
    (1, 4, 512, 700),        # one JAX chunk
    (2, 24, 333, 1530),      # ragged Q, many samples per query
    (3, 8, 1000, 97),        # long segments: ~80 rows per output row
])
def test_expand_plain_matches_pallas(groups, lbp, q, size):
    rng = np.random.RandomState(lbp * 1000 + q)
    ids, w, g = _expand_inputs(rng, groups, lbp, q, size)
    before = scatter_rows.scatter_add_rows_expand.launches
    out = scatter_rows.scatter_add_rows_expand(
        torch.from_numpy(ids), torch.from_numpy(w), torch.from_numpy(g),
        size)
    assert scatter_rows.scatter_add_rows_expand.launches == before
    assert out.shape == (groups, size, 4 * g.shape[2])
    for i in range(groups):
        # the TPU kernel takes g tiled onto its 4 corner blocks
        ref = np.asarray(jax_expand(jnp.asarray(ids[i]), jnp.asarray(w[i]),
                                    jnp.asarray(np.tile(g[i], (1, 4))),
                                    size, interpret=True))
        np.testing.assert_allclose(out[i].numpy(), ref, **OUT_TOL)


def test_expand_plain_all_dropped_and_narrow_rows():
    rng = np.random.RandomState(5)
    ids, w, g = _expand_inputs(rng, 2, 4, 300, 64, drop=0.0)
    out = scatter_rows.scatter_add_rows_expand_plain(
        torch.full(ids.shape, 64, dtype=torch.int32), torch.from_numpy(w),
        torch.from_numpy(g), 64)
    assert not out.any()
    # C = 8 (4C = 32): corner k scales channels [8k, 8k + 8)
    ids, w, g = _expand_inputs(rng, 1, 2, 50, 10, c=8, drop=0.0)
    out = scatter_rows.scatter_add_rows_expand_plain(
        torch.from_numpy(ids), torch.from_numpy(w), torch.from_numpy(g), 10)
    ref = np.zeros((10, 32), np.float32)
    for s in range(2):
        for qq in range(50):
            for k in range(4):
                ref[ids[0, s, qq], 8 * k:8 * k + 8] += \
                    w[0, qq, 4 * s + k] * g[0, qq]
    np.testing.assert_allclose(out[0].numpy(), ref, **OUT_TOL)


@pytest.mark.parametrize("kwargs,err", [
    (dict(ids_dtype=torch.int64), TypeError),
    (dict(g_queries=4), ValueError),
    (dict(w_width=7), ValueError),
])
def test_expand_rejects_bad_inputs(kwargs, err):
    ids = torch.zeros(1, 2, 5, dtype=kwargs.get("ids_dtype", torch.int32))
    w = torch.zeros(1, 5, kwargs.get("w_width", 8))
    g = torch.zeros(1, kwargs.get("g_queries", 5), 32)
    with pytest.raises(err):
        scatter_rows.scatter_add_rows_expand(ids, w, g, 10)


def _msda_inputs(rng, b, q, m, c, shapes, p):
    s = sum(h * w for h, w in shapes)
    value = rng.randn(b, s, m, c).astype(np.float32)
    # samples on and past the borders of every level
    loc = rng.uniform(-0.15, 1.15, (b, q, m, len(shapes), p, 2))
    loc[:, :2] = np.round(loc[:, :2] * 4) / 4
    weight = rng.rand(b, q, m, len(shapes), p).astype(np.float32)
    weight /= weight.sum(axis=(3, 4), keepdims=True)
    dout = rng.randn(b, q, m * c).astype(np.float32)
    return value, loc.astype(np.float32), weight, dout


@pytest.mark.parametrize("b,q,m,c,shapes,p", [
    (1, 57, 2, 32, ((24, 24), (6, 8)), 4),             # gather + dense
    (2, 40, 2, 8, ((3, 5), (20, 30), (24, 20)), 2),    # dense first, C=8
    (1, 30, 1, 32, ((26, 26),), 4),                    # one gather level
])
def test_msda_matches_jax_value_and_grads(b, q, m, c, shapes, p):
    routes = {jax_is_dense(h, w) for h, w in shapes}
    assert routes == ({True, False} if len(shapes) > 1 else {False})
    rng = np.random.RandomState(q + c)
    value, loc, weight, dout = _msda_inputs(rng, b, q, m, c, shapes, p)

    ref_out, vjp = jax.vjp(lambda v, l, w: jax_msda(v, shapes, l, w),
                           jnp.asarray(value), jnp.asarray(loc),
                           jnp.asarray(weight))
    ref_grads = vjp(jnp.asarray(dout))

    tv, tl, tw = (torch.tensor(a, requires_grad=True)
                  for a in (value, loc, weight))
    out = msda.ms_deform_attn(tv, shapes, tl, tw)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               **OUT_TOL)
    for name, got, ref in zip(("value", "loc", "weight"),
                              (tv.grad, tl.grad, tw.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   err_msg=name, **GRAD_TOL)


def test_msda_chunked_equals_unchunked(monkeypatch):
    shapes = ((24, 24), (6, 8))
    rng = np.random.RandomState(11)
    value, loc, weight, dout = _msda_inputs(rng, 1, 64, 2, 8, shapes, 4)

    def run():
        tv, tl, tw = (torch.tensor(a, requires_grad=True)
                      for a in (value, loc, weight))
        out = msda.ms_deform_attn(tv, shapes, tl, tw)
        out.backward(torch.from_numpy(dout))
        return [out.detach(), tv.grad, tl.grad, tw.grad]

    whole = run()
    monkeypatch.setattr(msda, "_MAX_ROWS", 100)
    for a, b_ in zip(whole, run()):
        torch.testing.assert_close(a, b_, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_expand_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(2)
    for groups, lbp, q, size, c in ((16, 4, 4000, 4041, 32),
                                    (3, 24, 777, 1530, 8)):
        ids, w, g = _expand_inputs(rng, groups, lbp, q, size, c=c)
        args = [torch.from_numpy(a).cuda() for a in (ids, w, g)]
        out = scatter_rows.scatter_add_rows_expand(*args, size)
        again = scatter_rows.scatter_add_rows_expand(*args, size)
        plain = scatter_rows.scatter_add_rows_expand_plain(*args, size)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        torch.testing.assert_close(out, plain, **OUT_TOL)
