"""The port's segmented reductions against the JAX package.

* The segmented scan: the port's ``segmented_cumsum_rows`` (its plain
  version on CPU tensors) against JAX ``segmented_cumsum_pallas``, run as
  ``tests/test_pallas_segmented.py`` runs it (TPU interpret mode; fp32 at
  every width, bf16 from C = 8, where the JAX package routes a scan to
  it), and against the XLA ``segmented.segmented_cumsum``.  Tolerance:
  1e-5 of the segment's magnitude (its running sum of absolute values),
  since the tree order of ``associative_scan`` and the MXU's order differ
  from a sequential sum.
* ``segment_reduce_sorted``, ``capped_segment_reduce``,
  ``compact_flagged_rows``, ``sorted_voxel_info`` and ``unique_voxels``
  (integers exactly), the generic ``bev_pool`` (value and gradient) and
  ``scatter_reduce`` (value and gradient for each mode).

The CUDA kernel itself is held against the plain version by the
``cuda``-marked tests (they skip without a card) and by ``chip_smoke.py``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillbev_tpu.ops import scatter as jax_scatter
from distillbev_tpu.ops import segmented as jax_seg
from distillbev_tpu.ops import voxelize as jax_vox
from distillbev_tpu.ops.pallas_segmented import (pad_rows_to_multiple,
                                                 segmented_cumsum_pallas)
from distillbev_tpu_torch.ops import bev_pool as pt_bev_pool
from distillbev_tpu_torch.ops import scatter as pt_scatter
from distillbev_tpu_torch.ops import segmented as pt_seg
from distillbev_tpu_torch.ops import segmented_scan
from distillbev_tpu_torch.ops import voxelize as pt_vox

# the packages export functions under their modules' names
jax_bev_pool = importlib.import_module("distillbev_tpu.ops.bev_pool")


def _keys(kind, n, rng):
    if kind == "one_segment":
        return np.full(n, 7, np.int32)
    if kind == "singletons":
        return (np.arange(n) * 3).astype(np.int32)
    return np.sort(rng.randint(0, n // 4, n)).astype(np.int32)


def _magnitude(vals, keys):
    """Running sum of |vals| within each segment (float64)."""
    return segmented_scan.segmented_cumsum_rows_plain(
        torch.from_numpy(np.abs(vals.astype(np.float64))),
        torch.from_numpy(keys)).numpy()


def _assert_scan_close(got, want, mag):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bound = 1e-5 * mag + 1e-6
    assert (err <= bound).all(), float((err - bound).max())


SCAN_CASES = [("random", 1037, 1), ("random", 1037, 3), ("random", 777, 8),
              ("random", 600, 64), ("one_segment", 1500, 8),
              ("singletons", 700, 3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,n,c", SCAN_CASES)
def test_scan_matches_pallas_and_xla(kind, n, c, dtype):
    rng = np.random.RandomState(n + c)
    keys = _keys(kind, n, rng)
    vals = (rng.randn(n, c) * 4).astype(jnp.dtype(dtype))
    vals32 = vals.astype(np.float32)
    mag = _magnitude(vals32, keys)
    pallas = None
    # the JAX package routes a scan to its Pallas kernel only from C >= 8:
    # fp32 is held against the kernel at every width, bf16 where JAX
    # routes it there
    if dtype == "float32" or c >= 8:
        from jax.experimental.pallas import tpu as pltpu
        with pltpu.force_tpu_interpret_mode():
            v, k, _ = pad_rows_to_multiple(
                jnp.asarray(vals), jnp.asarray(keys), 512,
                pad_key=np.iinfo(np.int32).max)
            pallas = np.asarray(segmented_cumsum_pallas(v, k, tile=512))[:n]
    xla = np.asarray(jax.jit(jax_seg.segmented_cumsum)(
        jnp.asarray(vals32), jax_seg.segment_starts(jnp.asarray(keys))))
    tv = torch.from_numpy(vals32).to(getattr(torch, dtype))
    tk = torch.from_numpy(keys)
    before = segmented_scan.segmented_cumsum_rows.launches
    got = segmented_scan.segmented_cumsum_rows(tv, tk)
    assert segmented_scan.segmented_cumsum_rows.launches == before
    assert got.dtype == torch.float32 and got.shape == (n, c)
    if pallas is not None:
        _assert_scan_close(got.numpy(), pallas, mag)
    _assert_scan_close(got.numpy(), xla, mag)
    # the module-level routes reach the same scan
    starts = pt_seg.segment_starts(tk)
    _assert_scan_close(pt_seg.segmented_cumsum(tv, starts).numpy(), xla, mag)
    _assert_scan_close(pt_seg._scan_sum(tv, tk).numpy(), xla, mag)


@pytest.mark.parametrize("values,keys,err", [
    (torch.zeros(4, 2, dtype=torch.float64), torch.zeros(4, dtype=torch.int32),
     TypeError),
    (torch.zeros(4, 2), torch.zeros(4, dtype=torch.int64), TypeError),
    (torch.zeros(4), torch.zeros(4, dtype=torch.int32), ValueError),
    (torch.zeros(4, 2), torch.zeros(5, dtype=torch.int32), ValueError),
    (torch.zeros(2, 4).mT, torch.zeros(4, dtype=torch.int32), ValueError),
    (torch.zeros(4, 5000), torch.zeros(4, dtype=torch.int32), ValueError),
])
def test_scan_rejects(values, keys, err):
    with pytest.raises(err):
        segmented_scan.segmented_cumsum_rows(values, keys)


def test_scan_of_no_rows():
    before = segmented_scan.segmented_cumsum_rows.launches
    out = segmented_scan.segmented_cumsum_rows(
        torch.zeros(0, 3, dtype=torch.bfloat16),
        torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0, 3) and out.dtype == torch.float32
    assert segmented_scan.segmented_cumsum_rows.launches == before


def test_scan_has_no_fallback_off_cpu():
    vals = torch.zeros(8, 3, device="meta")
    keys = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        segmented_scan.segmented_cumsum_rows(vals, keys)


def test_cummax_ids_positions_and_compaction():
    rng = np.random.RandomState(1)
    keys = np.sort(rng.randint(0, 60, 333)).astype(np.int32)
    vals = rng.randn(333, 5).astype(np.float32)
    js = jax_seg.segment_starts(jnp.asarray(keys))
    ts = pt_seg.segment_starts(torch.from_numpy(keys))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        pt_seg.segmented_cummax(torch.from_numpy(vals), ts).numpy(),
        np.asarray(jax.jit(jax_seg.segmented_cummax)(jnp.asarray(vals),
                                                     js)))
    np.testing.assert_array_equal(pt_seg.segment_ids_from_starts(ts).numpy(),
                                  np.asarray(jax_seg.segment_ids_from_starts(
                                      js)))
    np.testing.assert_array_equal(pt_seg.position_in_segment(ts).numpy(),
                                  np.asarray(jax_seg.position_in_segment(js)))
    flags = rng.rand(2500) > 0.6
    for m in (10, 900, 2500):
        np.testing.assert_array_equal(
            pt_seg.compact_flagged_rows(torch.from_numpy(flags), m).numpy(),
            np.asarray(jax.jit(jax_seg.compact_flagged_rows,
                               static_argnums=1)(jnp.asarray(flags), m)))


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_segment_reduce_sorted(reduce):
    rng = np.random.RandomState(2)
    n, nseg = 900, 160
    keys = np.sort(rng.randint(0, nseg + 20, n)).astype(np.int32)
    keys[keys == 17] = 18                       # an empty segment
    vals = rng.randn(n, 6).astype(np.float32)
    # masked rows are whole segments (all-masked ones) and the keys past
    # num_segments, as the callers mask them: a masked row inside a run
    # would split it
    valid = (keys < nseg) & ~np.isin(keys, [30, 31, 77])
    ref = np.asarray(jax_seg.segment_reduce_sorted(
        jnp.asarray(vals), jnp.asarray(keys), nseg, reduce=reduce,
        valid=jnp.asarray(valid)))
    got = pt_seg.segment_reduce_sorted(
        torch.from_numpy(vals), torch.from_numpy(keys), nseg, reduce=reduce,
        valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert not got[[17, 30, 31, 77]].any()
    shuffled = rng.permutation(keys)
    np.testing.assert_allclose(
        pt_seg.segment_sum_by_key(torch.from_numpy(vals),
                                  torch.from_numpy(shuffled), nseg).numpy(),
        np.asarray(jax.jit(jax_seg.segment_sum_by_key, static_argnums=2)(
            jnp.asarray(vals), jnp.asarray(shuffled), nseg)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reduce", ["max", "sum"])
def test_capped_segment_reduce(reduce):
    rng = np.random.RandomState(3)
    lengths = rng.randint(1, 7, 40)
    keys = np.repeat(np.arange(40), lengths).astype(np.int32)
    n = keys.shape[0]
    start = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int32)
    start_rows = np.concatenate([start, [n, n + 3]]).astype(np.int32)
    vals = rng.randn(n, 4).astype(np.float32)
    valid = rng.rand(n) > 0.3
    ref = np.asarray(jax_seg.capped_segment_reduce(
        jnp.asarray(vals), jnp.asarray(keys), jnp.asarray(start_rows), 6,
        42, reduce=reduce, valid=jnp.asarray(valid)))
    got = pt_seg.capped_segment_reduce(
        torch.from_numpy(vals), torch.from_numpy(keys),
        torch.from_numpy(start_rows), 6, 42, reduce=reduce,
        valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


VS, PCR = (0.8, 0.8, 8.0), (-6.4, -6.4, -5.0, 6.4, 6.4, 3.0)


def _cloud(rng, n=700, c=5):
    pts = rng.uniform(-7.0, 7.0, (n, c)).astype(np.float32)
    pts[:, 2] = rng.uniform(-4, 2, n)
    pts[:40, :2] = rng.uniform(-0.3, 0.3, (40, 2))   # one crowded pillar
    return pts, rng.rand(n) > 0.1


@pytest.mark.parametrize("presorted", [False, True])
def test_sorted_voxel_info(presorted):
    from distillbev_tpu_torch.apis.flagship import sort_points_by_pillar
    rng = np.random.RandomState(4)
    pts, mask = _cloud(rng)
    if presorted:
        pts = sort_points_by_pillar(pts[None], VS, PCR)[0]
        mask = np.ones_like(mask)
    ref = jax_vox.sorted_voxel_info(jnp.asarray(pts), jnp.asarray(mask), VS,
                                    PCR, 8, 120, presorted=presorted)
    got = pt_vox.sorted_voxel_info(torch.from_numpy(pts),
                                   torch.from_numpy(mask), VS, PCR, 8, 120,
                                   presorted=presorted)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert int(got.num_voxels) == 120           # the budget binds


def test_unique_voxels_and_dynamic_scatter():
    rng = np.random.RandomState(5)
    pts, mask = _cloud(rng)
    feats = rng.randn(pts.shape[0], 6).astype(np.float32)
    ref = jax.jit(lambda f, p, m: jax_scatter.dynamic_scatter(
        f, p, m, VS, PCR, 150))(jnp.asarray(feats), jnp.asarray(pts),
                                jnp.asarray(mask))
    got = pt_scatter.dynamic_scatter(torch.from_numpy(feats),
                                     torch.from_numpy(pts),
                                     torch.from_numpy(mask), VS, PCR, 150)
    for name in ("voxel_coords", "point2voxel", "num_voxels"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.voxel_feats.numpy(),
                               np.asarray(ref.voxel_feats), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_scatter_reduce_value_and_grad(mode):
    rng = np.random.RandomState(6)
    n, v = 600, 90
    p2v = rng.randint(0, v + 10, n).astype(np.int32)   # >= v: dropped
    feats = rng.randn(n, 5).astype(np.float32)
    feats[:3] = feats[3]                  # a tie for the max rule
    p2v[:4] = 11
    cot = rng.randn(v, 5).astype(np.float32)
    ref, vjp = jax.vjp(jax.jit(lambda f: jax_scatter.scatter_reduce(
        f, jnp.asarray(p2v), v, mode)), jnp.asarray(feats))
    ref_dx = np.asarray(vjp(jnp.asarray(cot))[0])
    tf = torch.from_numpy(feats).requires_grad_()
    out = pt_scatter.scatter_reduce(tf, torch.from_numpy(p2v), v, mode)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), ref_dx, rtol=1e-5, atol=1e-6)


def test_bev_pool_value_grad_and_batched():
    rng = np.random.RandomState(7)
    b, p, c, h, w = 2, 1500, 16, 12, 10
    feats = rng.randn(b * p, c).astype(np.float32)
    cell = rng.randint(-3, h * w + 3, (b, p)).astype(np.int32)
    valid = (rng.rand(b, p) > 0.3) & (cell >= 0) & (cell < h * w)
    coords = np.stack([np.repeat(np.arange(b), p), cell.reshape(-1) // w,
                       cell.reshape(-1) % w], -1).astype(np.int32)
    cot = rng.randn(b, h, w, c).astype(np.float32)
    jargs = (jnp.asarray(coords), jnp.asarray(valid.reshape(-1)))
    ref, vjp = jax.vjp(jax.jit(lambda f: jax_bev_pool.bev_pool(
        f, *jargs, b, h, w)), jnp.asarray(feats))
    tf = torch.from_numpy(feats).requires_grad_()
    out = pt_bev_pool.bev_pool(tf, torch.from_numpy(coords),
                               torch.from_numpy(valid.reshape(-1)), b, h, w)
    out.backward(torch.from_numpy(cot))
    assert out.shape == (b, h, w, c) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-6, atol=1e-6)
    batched = pt_bev_pool.bev_pool_batched(
        torch.from_numpy(feats.reshape(b, p, c)), torch.from_numpy(cell),
        torch.from_numpy(valid), h, w)
    np.testing.assert_allclose(out.detach().numpy(), batched.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_lift_splat_pool_matches_jax():
    rng = np.random.RandomState(8)
    feats = rng.randn(2, 400, 8).astype(np.float32)
    geom = rng.uniform(-12, 12, (2, 400, 3)).astype(np.float32)
    args = ((-10.0, -10.0), (2.0, 2.5), (8, 10), (-5.0, 5.0))
    ref = jax.jit(lambda f, g: jax_bev_pool.lift_splat_pool(f, g, *args))(
        jnp.asarray(feats), jnp.asarray(geom))
    got = pt_bev_pool.lift_splat_pool(torch.from_numpy(feats),
                                      torch.from_numpy(geom), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,c", SCAN_CASES + [("random", 300_000, 3),
                                                  ("one_segment", 99_999, 1)])
def test_scan_kernel_matches_plain_on_card(cuda_device, kind, n, c):
    rng = np.random.RandomState(n + c)
    keys = torch.from_numpy(_keys(kind, n, rng)).to(cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        vals = torch.from_numpy(rng.randn(n, c).astype(np.float32)).to(
            cuda_device, dtype)
        before = segmented_scan.segmented_cumsum_rows.launches
        out = segmented_scan.segmented_cumsum_rows(vals, keys)
        again = segmented_scan.segmented_cumsum_rows(vals, keys)
        plain = segmented_scan.segmented_cumsum_rows_plain(vals, keys)
        torch.cuda.synchronize()
        assert segmented_scan.segmented_cumsum_rows.launches == before + 2
        assert torch.equal(out, again)
        mag = segmented_scan.segmented_cumsum_rows_plain(
            vals.float().abs(), keys)
        assert ((out - plain).abs() <= 1e-5 * mag + 1e-6).all()


@pytest.mark.cuda
def test_scan_kernel_of_no_rows_launches_nothing(cuda_device):
    before = segmented_scan.segmented_cumsum_rows.launches
    out = segmented_scan.segmented_cumsum_rows(
        torch.zeros(0, 3, device=cuda_device),
        torch.zeros(0, dtype=torch.int32, device=cuda_device))
    assert out.shape == (0, 3) and out.dtype == torch.float32
    assert out.device.type == "cuda"
    assert segmented_scan.segmented_cumsum_rows.launches == before
