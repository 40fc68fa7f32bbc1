"""The port's ``scatter_add_rows_batched``, ``scatter_add_rows`` and
``bev_pool_batched`` (value and gradient) against the JAX package's
Pallas kernels (interpret mode on the CPU).

On CPU tensors the port's wrapper takes its plain version; the CUDA
kernel itself is compared with that plain version on the card by
``chip_smoke.py`` and by the ``cuda``-marked test below.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillbev_tpu.ops.bev_pool import bev_pool_batched as jax_bev_pool
import jax

from distillbev_tpu.ops.pallas_scatter import \
    scatter_add_rows as jax_scatter_rows
from distillbev_tpu.ops.pallas_scatter import \
    scatter_add_rows_batched as jax_scatter
from distillbev_tpu_torch.ops import bev_pool_batched, scatter_rows


def _ids(rng, b, r, size, empty_cells=()):
    """Ids in [0, size + 8): the top 8 are the JAX kernel's trash rows;
    ``empty_cells`` receive no row."""
    ids = rng.randint(0, size + 8, size=(b, r))
    for c in empty_cells:
        ids[ids == c] = size
    return ids.astype(np.int32)


@pytest.mark.parametrize("b,r,w,size", [
    (1, 2048, 64, 256),      # whole JAX chunk
    (2, 1037, 64, 300),      # ragged R
    (3, 777, 24, 64),        # narrow rows, many duplicates per cell
])
def test_scatter_add_rows_batched_matches_pallas(b, r, w, size):
    rng = np.random.RandomState(b * 1000 + r)
    ids = _ids(rng, b, r, size, empty_cells=(0, 5, size - 1))
    upd = rng.randn(b, r, w).astype(np.float32)
    ref = np.asarray(jax_scatter(jnp.asarray(ids), jnp.asarray(upd), size,
                                 interpret=True))
    before = scatter_rows.scatter_add_rows_batched.launches
    out = scatter_rows.scatter_add_rows_batched(
        torch.from_numpy(ids), torch.from_numpy(upd), size)
    assert scatter_rows.scatter_add_rows_batched.launches == before
    assert out.shape == (b, size, w) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-5)
    assert not out[:, [0, 5, size - 1]].any()


def test_scatter_add_rows_batched_all_dropped_and_one_cell():
    rng = np.random.RandomState(3)
    upd = rng.randn(1, 500, 64).astype(np.float32)
    for ids in (np.full((1, 500), 128, np.int32),
                np.full((1, 500), 17, np.int32)):
        ref = np.asarray(jax_scatter(jnp.asarray(ids), jnp.asarray(upd),
                                     128, interpret=True))
        out = scatter_rows.scatter_add_rows_batched(
            torch.from_numpy(ids), torch.from_numpy(upd), 128)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("ids,upd,size,err", [
    (torch.zeros(1, 4, dtype=torch.int64), torch.zeros(1, 4, 8), 4,
     TypeError),
    (torch.zeros(1, 4, dtype=torch.int32), torch.zeros(1, 4, 8,
                                                       dtype=torch.float64),
     4, TypeError),
    (torch.zeros(1, 5, dtype=torch.int32), torch.zeros(1, 4, 8), 4,
     ValueError),
    (torch.zeros(1, 4, dtype=torch.int32), torch.zeros(1, 8, 4).mT, 4,
     ValueError),
    (torch.zeros(1, 4, dtype=torch.int32), torch.zeros(1, 4, 8), 0,
     ValueError),
])
def test_scatter_add_rows_batched_rejects(ids, upd, size, err):
    with pytest.raises(err):
        scatter_rows.scatter_add_rows_batched(ids, upd, size)


def test_scatter_add_rows_batched_has_no_fallback_off_cpu():
    """A tensor off the CPU goes to a kernel or raises; the plain
    version is never taken for it."""
    ids = torch.zeros(1, 4, dtype=torch.int32, device="meta")
    upd = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        scatter_rows.scatter_add_rows_batched(ids, upd, 4)


@pytest.mark.parametrize("b,p,c,h,w", [(1, 3000, 16, 12, 10),
                                       (2, 1111, 8, 16, 16)])
def test_bev_pool_batched_matches_jax(b, p, c, h, w):
    rng = np.random.RandomState(p)
    feats = rng.randn(b, p, c).astype(np.float32)
    # out-of-grid ids exercise the clip-then-drop handling
    cell = rng.randint(-5, h * w + 5, size=(b, p)).astype(np.int32)
    valid = rng.rand(b, p) > 0.3
    ref = np.asarray(jax_bev_pool(jnp.asarray(feats), jnp.asarray(cell),
                                  jnp.asarray(valid), h, w))
    out = bev_pool_batched(torch.from_numpy(feats), torch.from_numpy(cell),
                           torch.from_numpy(valid), h, w)
    assert out.shape == (b, h, w, c)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("r", [1, 2047, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_add_rows_matches_pallas(r, dtype):
    """Row 3 (``scatter_add_rows``): sequential in r, ids == size are the
    JAX kernel's pad rows (dropped); a bf16 upd sums in bf16, rounded
    after every add, which must show against the fp32 sum."""
    rng = np.random.RandomState(r)
    size, w = 300, 16
    ids = rng.randint(0, size + 1, r).astype(np.int32)
    upd32 = rng.randn(r, w).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    upd = jnp.asarray(upd32).astype(jdt)
    ref = np.asarray(jax_scatter_rows(jnp.asarray(ids), upd, size,
                                      interpret=True).astype(jnp.float32))
    t_upd = torch.from_numpy(np.array(upd.astype(jnp.float32))).to(
        getattr(torch, dtype))
    before = scatter_rows.scatter_add_rows.launches
    out = scatter_rows.scatter_add_rows(torch.from_numpy(ids), t_upd, size)
    assert scatter_rows.scatter_add_rows.launches == before
    assert out.shape == (size, w) and out.dtype == t_upd.dtype
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
        return
    np.testing.assert_array_equal(out.float().numpy(), ref)
    if r == 4096:
        # ~14 adds a row: the rounding of every add shows
        once = scatter_rows.scatter_add_rows(torch.from_numpy(ids),
                                             t_upd.float(), size)
        assert not torch.equal(out, once.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_rows_drops_ids_outside(dtype):
    """Ids below 0 or at and above ``size`` are dropped (the JAX kernel
    takes pad ids == size only): the result equals the same call without
    those rows."""
    rng = np.random.RandomState(5)
    ids = torch.from_numpy(rng.randint(-50, 350, 3000).astype(np.int32))
    upd = torch.from_numpy(rng.randn(3000, 8).astype(np.float32)).to(dtype)
    keep = (ids >= 0) & (ids < 300)
    out = scatter_rows.scatter_add_rows(ids, upd, 300)
    assert torch.equal(out, scatter_rows.scatter_add_rows(ids[keep],
                                                          upd[keep], 300))
    empty = scatter_rows.scatter_add_rows(ids[:0], upd[:0], 300)
    assert empty.shape == (300, 8) and not empty.any()


def test_scatter_add_rows_rejects_and_has_no_fallback_off_cpu():
    with pytest.raises(TypeError):
        scatter_rows.scatter_add_rows(torch.zeros(4, dtype=torch.int32),
                                      torch.zeros(4, 8, dtype=torch.float64),
                                      4)
    with pytest.raises(ValueError):
        scatter_rows.scatter_add_rows(torch.zeros(1, 4, dtype=torch.int32),
                                      torch.zeros(1, 4, 8), 4)
    with pytest.raises(ValueError, match="no kernel"):
        scatter_rows.scatter_add_rows(
            torch.zeros(4, dtype=torch.int32, device="meta"),
            torch.zeros(4, 8, device="meta"), 4)


def test_bev_pool_batched_vjp_matches_jax():
    """The splat's backward (the JAX VJP with the Pallas forward in
    interpret mode): ``dfeats = g[b, clip(cell)]``, zero where invalid."""
    rng = np.random.RandomState(11)
    b, p, c, h, w = 2, 1500, 8, 12, 10
    feats = rng.randn(b, p, c).astype(np.float32)
    cell = rng.randint(-5, h * w + 5, size=(b, p)).astype(np.int32)
    valid = rng.rand(b, p) > 0.3
    g = rng.randn(b, h, w, c).astype(np.float32)
    out_ref, vjp = jax.vjp(lambda f: jax_bev_pool(f, jnp.asarray(cell),
                                                  jnp.asarray(valid), h, w),
                           jnp.asarray(feats))
    (dx_ref,) = vjp(jnp.asarray(g))
    t_feats = torch.from_numpy(feats).requires_grad_(True)
    out = bev_pool_batched(t_feats, torch.from_numpy(cell),
                           torch.from_numpy(valid), h, w)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(t_feats.grad.numpy(), np.asarray(dx_ref))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_scatter_kernel_matches_plain_on_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ids = torch.randint(0, 16392, (2, 20000), generator=gen,
                        device=cuda_device).to(torch.int32)
    upd = torch.randn(2, 20000, 64, generator=gen, device=cuda_device)
    before = scatter_rows.scatter_add_rows_batched.launches
    out = scatter_rows.scatter_add_rows_batched(ids, upd, 16384)
    again = scatter_rows.scatter_add_rows_batched(ids, upd, 16384)
    plain = scatter_rows.scatter_add_rows_batched_plain(ids, upd, 16384)
    torch.cuda.synchronize()
    assert scatter_rows.scatter_add_rows_batched.launches == before + 2
    assert torch.equal(out, again)
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_rows_kernel_matches_plain_on_card(cuda_device, dtype):
    """fp32: within 1e-5 of each row's sum of |upd|; bf16: bitwise, both
    sum in ascending row order with every add rounded."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    ids = torch.randint(-3, 2003, (65536,), generator=gen,
                        device=cuda_device, dtype=torch.int32)
    upd = torch.randn(65536, 128, generator=gen, device=cuda_device).to(
        dtype)
    before = scatter_rows.scatter_add_rows.launches
    out = scatter_rows.scatter_add_rows(ids, upd, 2000)
    again = scatter_rows.scatter_add_rows(ids, upd, 2000)
    plain = scatter_rows.scatter_add_rows_plain(ids, upd, 2000)
    torch.cuda.synchronize()
    assert scatter_rows.scatter_add_rows.launches == before + 2
    assert torch.equal(out, again) and out.dtype == dtype
    if dtype == torch.bfloat16:
        assert torch.equal(out, plain)
    else:
        mag = scatter_rows.scatter_add_rows_plain(ids, upd.abs(), 2000)
        assert bool(((out - plain).abs() <= 1e-5 * mag + 1e-6).all())
