"""Per-sample row scatter-add: ``out[b, ids[b, r]] += upd[b, r]``.

Replaces the TPU kernel ``distillbev_tpu/ops/pallas_scatter.py``
``scatter_add_rows_batched`` (``_kernel_batched``), the LSS splat behind
``bev_pool_batched``.  On a CUDA tensor the wrapper launches the
hand-written Hopper kernel of ``csrc/scatter_rows.cu``; on a CPU tensor
it takes the plain version below.  There is no fallback between the two.

Design (see the source note in ``csrc/scatter_rows.cu``): the TPU kernel
keeps the whole 4.2 MB canvas in VMEM, which no Hopper block can hold.
Here the wrapper prepares the row order -- a stable ``torch.sort`` of
each sample's ids and ``torch.searchsorted`` for the start of every
cell's segment -- and the kernel sums each cell's rows with one warp, in
ascending original row order, in fp32, writing each cell once.  That is
the TPU kernel's order of adds, so the result is deterministic.

Bound: memory.  At the flagship (R = 249,216, W = 64, size = 16,384)
the function must move 63.8 MB of updates, 1 MB of ids and 4.2 MB of
output, about 21 us at the H100's 3.35 TB/s.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build


def scatter_add_rows_batched_plain(ids: torch.Tensor, upd: torch.Tensor,
                                   size: int) -> torch.Tensor:
    """Plain version: sequential ``index_add_`` per sample, ids outside
    ``[0, size)`` land in one trash row that is sliced off."""
    b, _, w = upd.shape
    idx = torch.where((ids >= 0) & (ids < size), ids,
                      torch.full_like(ids, size)).long()
    out = upd.new_zeros(b, size + 1, w)
    for i in range(b):
        out[i].index_add_(0, idx[i], upd[i])
    return out[:, :size]


def _check(ids: torch.Tensor, upd: torch.Tensor, size: int):
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if upd.dtype != torch.float32:
        raise TypeError(f"upd must be float32, got {upd.dtype}")
    if ids.dim() != 2 or upd.dim() != 3 or tuple(ids.shape) != tuple(
            upd.shape[:2]):
        raise ValueError(f"expected ids [B, R] and upd [B, R, W], got "
                         f"{tuple(ids.shape)} and {tuple(upd.shape)}")
    if ids.device != upd.device:
        raise ValueError(f"ids on {ids.device}, upd on {upd.device}")
    if not (ids.is_contiguous() and upd.is_contiguous()):
        raise ValueError("ids and upd must be contiguous")
    if size < 1 or upd.shape[1] >= 2 ** 31 or upd.shape[2] < 1:
        raise ValueError(f"unsupported size {size} or shape "
                         f"{tuple(upd.shape)}")


def segment_order(ids: torch.Tensor, size: int):
    """Index preparation of the kernel: each sample's rows stably sorted
    by id (``order`` [B, R] int64) and the first sorted position of every
    cell id 0..size (``seg_start`` [B, size + 1] int32)."""
    sorted_ids, order = torch.sort(ids, dim=1, stable=True)
    bounds = torch.arange(size + 1, dtype=torch.int32,
                          device=ids.device).expand(ids.shape[0], size + 1)
    seg_start = torch.searchsorted(sorted_ids, bounds.contiguous(),
                                   out_int32=True)
    return order, seg_start


def segment_sum(upd: torch.Tensor, order: torch.Tensor,
                seg_start: torch.Tensor, size: int) -> torch.Tensor:
    """Launch the segment-sum kernel of ``csrc/scatter_rows.cu``."""
    b, r, w = upd.shape
    fn = cuda_build.load("scatter_rows").scatter_rows_segment_sum
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(b, size, w, dtype=torch.float32, device=upd.device)
    with torch.cuda.device(upd.device):
        err = fn(upd.data_ptr(), order.data_ptr(), seg_start.data_ptr(),
                 out.data_ptr(), b, r, size, w,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"scatter_rows_segment_sum launch failed: "
                           f"cudaError {err}")
    return out


def scatter_add_rows_batched(ids: torch.Tensor, upd: torch.Tensor,
                             size: int) -> torch.Tensor:
    """``out[b, ids[b, r]] += upd[b, r]`` with out zero-initialised.

    Args:
        ids: ``[B, R]`` int32 row ids; ids outside ``[0, size)`` are
            dropped.
        upd: ``[B, R, W]`` float32 update rows.
        size: accumulator rows per sample.

    Returns ``[B, size, W]`` float32, summed in ascending row order.
    ``scatter_add_rows_batched.launches`` counts the CUDA kernel's
    launches.
    """
    _check(ids, upd, size)
    if upd.device.type == "cpu":
        return scatter_add_rows_batched_plain(ids, upd, size)
    if upd.device.type != "cuda":
        raise ValueError(f"no kernel for device {upd.device}")
    out = segment_sum(upd, *segment_order(ids, size), size)
    scatter_add_rows_batched.launches += 1
    return out


scatter_add_rows_batched.launches = 0
