"""Row scatter-adds of the port, each a hand-written Hopper kernel.

* ``scatter_add_rows_batched``: ``out[b, ids[b, r]] += upd[b, r]``.
  Replaces the TPU kernel ``distillbev_tpu/ops/pallas_scatter.py``
  ``scatter_add_rows_batched`` (``_kernel_batched``), the LSS splat
  behind ``bev_pool_batched``; kernel ``csrc/scatter_rows.cu``.
* ``scatter_add_rows``: ``out[ids[r]] += upd[r]`` of ``upd``'s dtype,
  ascending r; a bf16 ``upd`` accumulates in bf16, rounded after every
  add.  Replaces ``scatter_add_rows`` (``_kernel``) of the same file and
  ``tools/analysis_tools/bench_pallas_gather.py:pallas_rmw``
  (``_rmw_kernel``): the batched kernel at B = 1, in fp32 or bf16.
* ``scatter_add_rows_expand``: ``out[grp, ids[grp, s, q]] +=
  concat_k(w[grp, q, 4s + k] * g[grp, q])``, the dvalue scatter of the
  deformable-attention backward with the rank-1 update rows expanded
  inside the kernel.  Replaces ``scatter_add_rows_expand``
  (``_kernel_expand``) of the same file; kernel
  ``csrc/scatter_rows_expand.cu``.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it
takes the plain version beside it.  There is no fallback between the
two.

Design (see the source notes in ``csrc/``): the TPU kernels keep the
whole accumulator (4.2 MB for the splat, up to 20.7 MB for one
attention group, 12.1 MB at the gather tool's shape) in VMEM, which no
Hopper block can hold.  Here the wrapper prepares the row order -- a
stable ``torch.sort`` of the row keys and ``torch.searchsorted`` for the
start of every output row's segment -- and the kernel sums each output
row with one warp, in ascending original row order, in fp32 (bf16 for a
bf16 ``upd`` of ``scatter_add_rows``), writing each row once.  That is
the TPU kernels' order of adds, so the result is deterministic.

Bound: memory.  At the flagship splat (R = 249,216, W = 64, size =
16,384) the function must move 63.8 MB of updates, 1 MB of ids and
4.2 MB of output, about 21 us at the H100's 3.35 TB/s; at the tool's
shape (R = 4,194,304, W = 128, size = 23,634) 2,176 MB, about 0.65 ms.
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


def _check(ids: torch.Tensor, upd: torch.Tensor, size: int,
           dtypes=(torch.float32,)):
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if upd.dtype not in dtypes:
        raise TypeError(f"upd must be one of {dtypes}, got {upd.dtype}")
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
    """Launch the segment-sum kernel of ``csrc/scatter_rows.cu`` on
    ``upd [B, R, W]`` (fp32, or bf16 summed in bf16)."""
    b, r, w = upd.shape
    lib = cuda_build.load("scatter_rows")
    fn = lib.scatter_rows_segment_sum_bf16 if upd.dtype == torch.bfloat16 \
        else lib.scatter_rows_segment_sum
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(b, size, w, dtype=upd.dtype, device=upd.device)
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


def scatter_add_rows_plain(ids: torch.Tensor, upd: torch.Tensor,
                           size: int) -> torch.Tensor:
    """Plain version: fp32 rows go through ``index_add_`` (ids outside
    ``[0, size)`` into one trash row that is sliced off); the kept bf16
    rows are added rank by rank (the k-th row of every output row's
    segment, in ascending row order, k = 0, 1, ...), each add rounded to
    bf16, as the kernel does."""
    keep = (ids >= 0) & (ids < size)
    out = upd.new_zeros(size + 1, upd.shape[1])
    if upd.dtype != torch.bfloat16:
        idx = torch.where(keep, ids, torch.full_like(ids, size)).long()
        return out.index_add_(0, idx, upd)[:size]
    idx, upd = ids[keep].long(), upd[keep]
    sorted_ids, order = torch.sort(idx, stable=True)
    rank = torch.arange(idx.shape[0], device=idx.device) - \
        torch.searchsorted(sorted_ids, sorted_ids)
    for k in range(int(rank.max()) + 1 if idx.numel() else 0):
        rows = order[rank == k]          # at most one row per output row
        out[idx[rows]] = out[idx[rows]] + upd[rows]
    return out[:size]


def scatter_add_rows(ids: torch.Tensor, upd: torch.Tensor,
                     size: int) -> torch.Tensor:
    """``out[ids[r]] += upd[r]`` with out zero-initialised, sequential in r.

    Args:
        ids: ``[R]`` int32 row ids.  Ids outside ``[0, size)`` are
            dropped: a superset of the JAX contract, whose pad ids equal
            ``size`` and land in trash rows.
        upd: ``[R, W]`` float32 or bfloat16 update rows.
        size: accumulator rows.

    Returns ``[size, W]`` of ``upd.dtype``: a bf16 ``upd`` accumulates in
    bf16, rounded after every add, as the TPU kernel's bf16 accumulator.
    ``scatter_add_rows.launches`` counts the CUDA kernel's launches.
    """
    if ids.dim() != 1 or upd.dim() != 2:
        raise ValueError(f"expected ids [R] and upd [R, W], got "
                         f"{tuple(ids.shape)} and {tuple(upd.shape)}")
    _check(ids[None], upd[None], size,
           dtypes=(torch.float32, torch.bfloat16))
    if upd.device.type == "cpu":
        return scatter_add_rows_plain(ids, upd, size)
    if upd.device.type != "cuda":
        raise ValueError(f"no kernel for device {upd.device}")
    out = segment_sum(upd[None], *segment_order(ids[None], size), size)[0]
    scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0


def scatter_add_rows_expand_plain(ids_sq: torch.Tensor, w: torch.Tensor,
                                  g: torch.Tensor, size: int
                                  ) -> torch.Tensor:
    """Plain version: materialise the ``[G * lbp * Q, 4C]`` update rows
    in the flat row order ``(group, sample, query)`` and ``index_add_``
    them; ids outside ``[0, size)`` land in one trash row per group that
    is sliced off."""
    groups, lbp, q = ids_sq.shape
    c = g.shape[2]
    width = 4 * c
    wk = w.reshape(groups, q, lbp, 4).permute(0, 2, 1, 3)[..., None]
    upd = (wk * g.reshape(groups, 1, q, 1, c)).reshape(-1, width)
    keep = (ids_sq >= 0) & (ids_sq < size)
    idx = torch.where(keep, ids_sq, torch.full_like(ids_sq, size)).long()
    idx = idx + (size + 1) * torch.arange(
        groups, device=ids_sq.device).reshape(groups, 1, 1)
    out = g.new_zeros(groups * (size + 1), width)
    out.index_add_(0, idx.reshape(-1), upd)
    return out.reshape(groups, size + 1, width)[:, :size]


def _check_expand(ids_sq: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                  size: int):
    if ids_sq.dtype != torch.int32:
        raise TypeError(f"ids_sq must be int32, got {ids_sq.dtype}")
    if w.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"w and g must be float32, got {w.dtype}, "
                        f"{g.dtype}")
    if ids_sq.dim() != 3 or w.dim() != 3 or g.dim() != 3:
        raise ValueError("expected ids_sq [G, lbp, Q], w [G, Q, 4 lbp] and "
                         "g [G, Q, C]")
    groups, lbp, q = ids_sq.shape
    if tuple(w.shape) != (groups, q, 4 * lbp) or tuple(g.shape[:2]) != (
            groups, q) or g.shape[2] < 1:
        raise ValueError(f"shapes do not agree: ids_sq {tuple(ids_sq.shape)}"
                         f", w {tuple(w.shape)}, g {tuple(g.shape)}")
    if not (ids_sq.device == w.device == g.device):
        raise ValueError(f"ids_sq on {ids_sq.device}, w on {w.device}, g "
                         f"on {g.device}")
    if not (ids_sq.is_contiguous() and w.is_contiguous()
            and g.is_contiguous()):
        raise ValueError("ids_sq, w and g must be contiguous")
    if size < 1 or groups * lbp * q >= 2 ** 31 or groups * size >= 2 ** 31:
        raise ValueError(f"unsupported size {size} or shape "
                         f"{tuple(ids_sq.shape)}")


def expand_segment_sum(w: torch.Tensor, g: torch.Tensor,
                       order: torch.Tensor, seg_start: torch.Tensor,
                       lbp: int, size: int) -> torch.Tensor:
    """Launch the kernel of ``csrc/scatter_rows_expand.cu``."""
    groups, q, c = g.shape
    width = 4 * c
    fn = cuda_build.load("scatter_rows_expand"
                         ).scatter_rows_expand_segment_sum
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(groups, size, width, dtype=torch.float32,
                      device=g.device)
    with torch.cuda.device(g.device):
        err = fn(w.data_ptr(), g.data_ptr(), order.data_ptr(),
                 seg_start.data_ptr(), out.data_ptr(), groups, lbp, q, size,
                 width, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"scatter_rows_expand_segment_sum launch failed: "
                           f"cudaError {err}")
    return out


def expand_segment_order(ids_sq: torch.Tensor, size: int):
    """Index preparation of the expand kernel: the flat rows ``(group,
    sample, query)`` stably sorted by ``group * size + id`` (dropped ids
    after every kept key) and the first sorted position of every key
    ``0 .. G * size``."""
    groups = ids_sq.shape[0]
    keep = (ids_sq >= 0) & (ids_sq < size)
    base = size * torch.arange(groups, dtype=torch.int32,
                               device=ids_sq.device).reshape(groups, 1, 1)
    keys = torch.where(keep, ids_sq + base,
                       torch.full_like(ids_sq, groups * size))
    order, seg_start = segment_order(keys.reshape(1, -1), groups * size)
    return order[0], seg_start[0]


def scatter_add_rows_expand(ids_sq: torch.Tensor, w: torch.Tensor,
                            g: torch.Tensor, size: int) -> torch.Tensor:
    """``out[grp, ids_sq[grp, s, q]] += concat_k(w[grp, q, 4s + k] *
    g[grp, q])`` with out zero-initialised, per group.

    Args:
        ids_sq: ``[G, lbp, Q]`` int32 sample-major row ids per group; ids
            outside ``[0, size)`` are dropped.
        w: ``[G, Q, 4 * lbp]`` float32 corner weights, lane ``4s + k`` for
            sample slot ``s`` and corner ``k``.
        g: ``[G, Q, C]`` float32 per-query rows; corner ``k`` of a sample
            writes ``w * g`` into output channels ``[kC, (k + 1)C)``.
        size: accumulator rows per group.

    Returns ``[G, size, 4C]`` float32, summed per output row in ascending
    ``(sample, query)`` order.  ``scatter_add_rows_expand.launches``
    counts the CUDA kernel's launches.
    """
    _check_expand(ids_sq, w, g, size)
    if g.device.type == "cpu":
        return scatter_add_rows_expand_plain(ids_sq, w, g, size)
    if g.device.type != "cuda":
        raise ValueError(f"no kernel for device {g.device}")
    order, seg_start = expand_segment_order(ids_sq, size)
    out = expand_segment_sum(w, g, order, seg_start, ids_sq.shape[1], size)
    scatter_add_rows_expand.launches += 1
    return out


scatter_add_rows_expand.launches = 0
