"""Row gather, a hand-written Hopper kernel.

``gather_rows(table, idx)``: ``out[n] = table[idx[n]]``, a zero row where
``idx[n]`` lies outside ``[0, S)``.  Replaces the TPU kernel
``tools/analysis_tools/bench_pallas_gather.py:pallas_gather``
(``_gather_kernel``); kernel ``csrc/gather_rows.cu``.  Its caller on the
distill step is the LSS splat's backward (``ops/bev_pool.py``
``bev_pool_batched``), whose invalid rows are sent past the table.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it
takes ``gather_rows_plain``.  There is no fallback between the two.  A
gather moves bits, so the kernel is bitwise equal to the plain version.

Bound: memory, each index and table row read once and each output row
written once (the table stays in L2 after its first touch).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """Plain version: ``index_select`` of the valid rows into zeros."""
    ok = (idx >= 0) & (idx < table.shape[0])
    out = table.new_zeros(idx.shape[0], table.shape[1])
    out[ok] = table.index_select(0, idx[ok].long())
    return out


def _check(table: torch.Tensor, idx: torch.Tensor):
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"expected table [S, W] and idx [N], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.element_size() < 2:
        raise TypeError(f"table elements of {table.element_size()} byte "
                        f"are not supported")
    if table.device != idx.device:
        raise ValueError(f"table on {table.device}, idx on {idx.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")


def _launch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    fn = cuda_build.load("gather_rows").gather_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(idx.shape[0], table.shape[1], dtype=table.dtype,
                      device=table.device)
    with torch.cuda.device(table.device):
        err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                 idx.shape[0], table.shape[0],
                 table.shape[1] * table.element_size(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_rows launch failed: cudaError {err}")
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[n] = table[idx[n]]``, zero where ``idx[n]`` is outside
    ``[0, S)``.

    Args:
        table: ``[S, W]`` rows of any float type (bf16 and fp32 on the
            distill step and in the tool).
        idx: ``[N]`` int32.

    Returns ``[N, W]`` of the table's dtype.  ``gather_rows.launches``
    counts the CUDA kernel's launches.
    """
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    out = _launch(table, idx)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
