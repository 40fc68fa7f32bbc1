"""The port's row gather (``ops/gather_rows.py``) and the microbench
tool (``distillbev_tpu_torch/tools/bench_gather.py``) against the JAX
tool's Pallas kernels, ``pallas_gather`` and ``pallas_rmw``
(``tools/analysis_tools/bench_pallas_gather.py``), in interpret mode.

The JAX tool's file calls ``pl.pallas_call`` without ``interpret``; the
tests wrap that call to pass ``interpret=True`` and leave the file as it
is.  On CPU tensors the port takes its plain versions; the CUDA kernels
are held against those on the card by the ``cuda``-marked tests and by
``chip_smoke.py``.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distillbev_tpu_torch.ops import (gather_rows, gather_rows_plain,
                                       scatter_rows)
from distillbev_tpu_torch.tools import bench_gather

N, S = 4096, 300


@pytest.fixture(scope="module")
def jax_tool():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "analysis_tools",
        "bench_pallas_gather.py")
    spec = importlib.util.spec_from_file_location("bench_pallas_gather",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture
def interpret(jax_tool, monkeypatch):
    real = jax_tool.pl.pallas_call
    monkeypatch.setattr(jax_tool.pl, "pallas_call",
                        lambda *a, **kw: real(*a, interpret=True, **kw))
    return jax_tool


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gather_matches_pallas_gather(interpret, dtype):
    rng = np.random.RandomState(0)
    table = jnp.asarray(rng.randn(S, 128), getattr(jnp, dtype))
    idx = rng.randint(0, S, N).astype(np.int32)
    ref = np.asarray(interpret.pallas_gather(table, jnp.asarray(idx))
                     .astype(jnp.float32))
    t_table = torch.from_numpy(np.array(table.astype(jnp.float32))).to(
        getattr(torch, dtype))
    before = gather_rows.launches
    out = gather_rows(t_table, torch.from_numpy(idx))
    assert gather_rows.launches == before
    assert out.shape == (N, 128) and out.dtype == t_table.dtype
    np.testing.assert_array_equal(out.float().numpy(), ref)


def test_rmw_matches_pallas_rmw(interpret):
    """The tool's ``rmw`` row (``scatter_add_rows`` in fp32)."""
    rng = np.random.RandomState(1)
    rows = rng.randn(N, 128).astype(np.float32)
    idx = rng.randint(0, S, N).astype(np.int32)
    ref = np.asarray(interpret.pallas_rmw(jnp.asarray(rows),
                                          jnp.asarray(idx), S))
    out = scatter_rows.scatter_add_rows(torch.from_numpy(idx),
                                        torch.from_numpy(rows), S)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_gather_zero_rows_outside_and_rejects():
    table = torch.arange(24, dtype=torch.float32).reshape(8, 3) + 1
    idx = torch.tensor([0, 7, 8, -1, 3, 100], dtype=torch.int32)
    out = gather_rows(table, idx)
    assert torch.equal(out[[0, 1, 4]], table[[0, 7, 3]])
    assert not out[[2, 3, 5]].any()
    assert gather_rows(table, idx[:0]).shape == (0, 3)
    with pytest.raises(TypeError):
        gather_rows(table, idx.long())
    with pytest.raises(ValueError):
        gather_rows(table[None], idx)
    with pytest.raises(ValueError):
        gather_rows(table.t(), idx)
    with pytest.raises(ValueError, match="no kernel"):
        gather_rows(table.to("meta"), idx.to("meta"))


def test_bench_tool_rows_on_the_cpu():
    """The tool's four rows at a small size (plain versions on the CPU):
    times are host times here and say nothing of the card."""
    out = bench_gather.main(2048, 200, device="cpu", iters=1)
    assert list(out) == ["torch gather", "gather kernel",
                         "torch scatter-add", "rmw kernel"]
    assert all(v["ms"] > 0 and v["bound_ms"] > 0 for v in out.values())
    table, idx, rows = bench_gather.inputs(2048, 200, device="cpu")
    assert torch.equal(gather_rows(table, idx),
                       table.index_select(0, idx))
    torch.testing.assert_close(
        scatter_rows.scatter_add_rows(idx, rows, 200),
        torch.zeros(200, 128).index_add_(0, idx, rows), rtol=1e-6,
        atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,width", [(torch.bfloat16, 128),
                                         (torch.float32, 64),
                                         (torch.bfloat16, 3),
                                         (torch.float32, 5)])
def test_gather_kernel_matches_plain_on_card(cuda_device, dtype, width):
    """Bitwise, at 16-byte, 4-byte and 2-byte row vectors."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    table = torch.randn(1000, width, generator=gen, device=cuda_device).to(
        dtype)
    idx = torch.randint(-5, 1005, (70001,), generator=gen,
                        device=cuda_device, dtype=torch.int32)
    before = gather_rows.launches
    out = gather_rows(table, idx)
    plain = gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(out, plain)
