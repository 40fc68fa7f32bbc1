"""Microbench: the row gather and the ordered row scatter-add kernels
against PyTorch's own calls.

Counterpart of ``tools/analysis_tools/bench_pallas_gather.py``, at its
shapes: a table ``[S, 128]`` bf16 (S = 23,634, the 4x-duplicated
superrow grid of one deformable-attention (batch, head) level), N =
4,194,304 int32 indices uniform over the table, and N fp32 update rows
``[N, 128]`` accumulated into ``min(S, 23,634)`` rows.  Rows:

  torch gather       ``index_select`` of the table rows (the JAX tool's
                     ``xla gather``)
  gather kernel      ``ops/gather_rows.py:gather_rows`` (the tool's
                     ``pallas_gather``)
  torch scatter-add  ``index_add_`` into zeros (the tool's ``xla
                     scatter-add``)
  rmw kernel         ``ops/scatter_rows.py:scatter_add_rows``, ascending
                     row order (the tool's ``pallas_rmw``)

Each prints ms a call, M rows/s and the bound: the bytes the function
must move over 3.35 TB/s (H100 SXM HBM3).  The JAX tool's ``pallas_u8``
is a TPU loop unroll and has no counterpart.

Usage: ``python -m distillbev_tpu_torch.tools.bench_gather [N] [S]``
"""
from __future__ import annotations

import sys
import time

import torch

from ..ops.gather_rows import gather_rows
from ..ops.scatter_rows import scatter_add_rows

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
WIDTH = 128


def timeit(fn, *args, iters: int = 5) -> float:
    """Seconds a call: one warm call, then ``iters`` calls between two
    synchronisations of the device."""
    sync = torch.cuda.synchronize if args[0].is_cuda else (lambda: None)
    fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / iters


def inputs(n: int, s: int, device: str = "cuda", seed: int = 0):
    """The tool's inputs, drawn on ``device``: the bf16 table, the
    indices and the fp32 update rows."""
    gen = torch.Generator(device=device).manual_seed(seed)
    table = torch.randn(s, WIDTH, generator=gen, device=device).to(
        torch.bfloat16)
    idx = torch.randint(0, s, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    rows = torch.randn(n, WIDTH, generator=gen, device=device)
    return table, idx, rows


def gather_bytes(n: int, s: int, width: int = WIDTH,
                 itemsize: int = 2) -> int:
    """Least bytes of gathering ``n`` rows of an ``[s, width]`` table:
    the int32 indices and the table read once, the output written once."""
    return 4 * n + itemsize * (s * width + n * width)


def scatter_bytes(n: int, sacc: int, width: int = WIDTH) -> int:
    """Least bytes of adding ``n`` fp32 rows into ``sacc`` rows: the rows
    and the int32 indices read once, the accumulator written once."""
    return 4 * n * width + 4 * n + 4 * sacc * width


def main(n: int = 1 << 22, s: int = 23634, device: str = "cuda",
         iters: int = 5) -> dict:
    """Time the four rows; print them and return ``{row: {ms, mrows_s,
    bound_ms}}``."""
    table, idx, rows = inputs(n, s, device)
    sacc = min(s, 23634)
    name = torch.cuda.get_device_name(0) if table.is_cuda else device
    print(f"bench_gather on {name}: N {n}, S {s}, table [{s}, {WIDTH}] "
          f"bf16, rows [{n}, {WIDTH}] fp32 into {sacc}", flush=True)
    gather_bound = 1e3 * gather_bytes(n, s) / HBM_BYTES_PER_S
    scatter_bound = 1e3 * scatter_bytes(n, sacc) / HBM_BYTES_PER_S
    cases = [
        ("torch gather", lambda t, i: t.index_select(0, i), (table, idx),
         gather_bound),
        ("gather kernel", gather_rows, (table, idx), gather_bound),
        ("torch scatter-add",
         lambda r, i: torch.zeros(sacc, WIDTH, device=r.device).index_add_(
             0, i, r), (rows, idx), scatter_bound),
        ("rmw kernel", lambda r, i: scatter_add_rows(i, r, sacc),
         (rows, idx), scatter_bound),
    ]
    out = {}
    for label, fn, args, bound_ms in cases:
        t = timeit(fn, *args, iters=iters)
        out[label] = dict(ms=1e3 * t, mrows_s=n / t / 1e6,
                          bound_ms=bound_ms)
        print(f"{label:18s}: {1e3 * t:8.3f} ms  {n / t / 1e6:8.1f}M rows/s"
              f"  (bound {bound_ms:.3f} ms)", flush=True)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 22,
         int(sys.argv[2]) if len(sys.argv) > 2 else 23634)
