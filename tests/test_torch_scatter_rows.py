"""The port's ``scatter_add_rows_batched`` and ``bev_pool_batched``
against the JAX package's Pallas kernel (interpret mode on the CPU).

On CPU tensors the port's wrapper takes its plain version; the CUDA
kernel itself is compared with that plain version on the card by
``chip_smoke.py`` and by the ``cuda``-marked test below.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillbev_tpu.ops.bev_pool import bev_pool_batched as jax_bev_pool
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
