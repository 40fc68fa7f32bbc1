"""Sorted-segment reductions, the engine under the point-cloud ops.

Counterpart of ``distillbev_tpu/ops/segmented.py``: sort rows by segment
key, scan each segment, read the segment's last row.  The inclusive
segmented cumsum (``segmented_cumsum`` and ``_scan_sum``) is the Hopper
kernel of ``ops/segmented_scan.py`` at every width; the segmented running
max and the capped window reduce are plain torch, as they are plain XLA
in the JAX package.  Where the JAX file shapes a step for the TPU (the
blocked compaction sort, the one-bit sort of the end rows) the port takes
the direct torch formulation that returns the same rows.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .segmented_scan import segmented_cumsum_rows

INT32_MAX = torch.iinfo(torch.int32).max


def _col(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """``[N]`` -> ``[N, 1, ...]`` broadcasting against ``ndim`` dims."""
    return mask.reshape((-1,) + (1,) * (ndim - 1))


def sort_by_key(keys: torch.Tensor, *arrays) -> Tuple[torch.Tensor, ...]:
    """Stable-sort ``keys`` ascending; returns ``(sorted_keys, order,
    *arrays[order])``."""
    sorted_keys, order = torch.sort(keys, stable=True)
    return (sorted_keys, order) + tuple(a[order] for a in arrays)


def segment_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Boolean start-of-segment flags for an ascending key array."""
    prev = torch.cat([sorted_keys[:1] - 1, sorted_keys[:-1]])
    return sorted_keys != prev


def compact_flagged_rows(flags: torch.Tensor, m: int) -> torch.Tensor:
    """Row ids of the first ``m`` True flags, ascending; ``n`` (the row
    count) after the last flag."""
    n = flags.shape[0]
    rows = torch.nonzero(flags).reshape(-1)[:m]
    out = torch.full((m,), n, dtype=torch.int64, device=flags.device)
    out[:rows.shape[0]] = rows
    return out


def _scan_input(values: torch.Tensor) -> torch.Tensor:
    """``values [N, ...]`` as the kernel's contiguous ``[N, C]`` rows,
    bf16 kept, other types in fp32."""
    rows = values.reshape(values.shape[0], -1)
    if rows.dtype not in (torch.float32, torch.bfloat16):
        rows = rows.to(torch.float32)
    return rows.contiguous()


def segmented_cumsum(values: torch.Tensor,
                     starts: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented cumsum along axis 0 (segments begin where
    ``starts`` is True); fp32 of ``values``' shape."""
    keys = torch.cumsum(starts.to(torch.int32), 0, dtype=torch.int32)
    return segmented_cumsum_rows(_scan_input(values), keys).reshape(
        values.shape)


def segmented_cummax(values: torch.Tensor,
                     starts: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented running max along axis 0 (a log-step scan; max
    is exact in any order)."""
    out, flags = values, starts
    n, d = values.shape[0], 1
    while d < n:
        tail = torch.where(_col(flags[d:], values.dim()), out[d:],
                           torch.maximum(out[:-d], out[d:]))
        out = torch.cat([out[:d], tail])
        flags = torch.cat([flags[:d], flags[d:] | flags[:-d]])
        d *= 2
    return out


def _scan_sum(vals: torch.Tensor, sorted_keys: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive cumsum of rows keyed by ascending
    ``sorted_keys``: the kernel, at every width (it finds the segment
    starts from the keys)."""
    return segmented_cumsum_rows(
        _scan_input(vals), sorted_keys.to(torch.int32).contiguous()
    ).reshape(vals.shape)


def segment_ids_from_starts(starts: torch.Tensor) -> torch.Tensor:
    """Compacted 0-based segment index per sorted element (int32)."""
    return torch.cumsum(starts.to(torch.int32), 0, dtype=torch.int32) - 1


def position_in_segment(starts: torch.Tensor) -> torch.Tensor:
    """0-based position of each element within its segment (int32)."""
    idx = torch.arange(starts.shape[0], dtype=torch.int32,
                       device=starts.device)
    start_pos = torch.where(starts, idx, torch.zeros_like(idx))
    return idx - torch.cummax(start_pos, 0).values


def capped_segment_reduce(values: torch.Tensor, sorted_keys: torch.Tensor,
                          start_rows: torch.Tensor, cap: int,
                          num_segments: int, reduce: str = "max",
                          valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Per-segment reduction when a segment's contributing rows all lie
    within its first ``cap`` rows: ceil(log2(cap)) shifted combines build
    a windowed suffix reduce, read at the segment-start rows.

    Args:
        values: ``[N, C]`` rows sorted so equal keys are contiguous.
        sorted_keys: ``[N]`` segment key per row.
        start_rows: ``[num_segments]`` first row of each segment; rows
            ``>= N`` mean an empty segment (result 0).
        cap: bound on valid rows per segment.
        valid: ``[N]`` mask; invalid rows contribute nothing.

    Returns ``[num_segments, C]`` (float32 for sum/mean; max keeps the
    input type; an all-masked max is 0).
    """
    n = values.shape[0]
    if reduce == "max":
        vals, ident, combine = values, float("-inf"), torch.maximum
    elif reduce in ("sum", "mean"):
        vals, ident, combine = values.to(torch.float32), 0.0, torch.add
    else:
        raise ValueError(f"unknown reduce {reduce!r}")
    fill = torch.full((), ident, dtype=vals.dtype, device=vals.device)
    if valid is not None:
        vals = torch.where(_col(valid, vals.dim()), vals, fill)
    x, k = vals, sorted_keys
    pad_key = torch.iinfo(k.dtype).max
    d = 1
    while d < cap:
        xs = torch.cat([x[d:], fill.expand((d,) + x.shape[1:])])
        ks = torch.cat([k[d:], torch.full((d,), pad_key, dtype=k.dtype,
                                          device=k.device)])
        x = combine(x, torch.where(_col(ks == k, x.dim()), xs, fill))
        d *= 2
    out = x[start_rows.clamp(max=n - 1).long()]
    out = torch.where(_col(start_rows >= n, out.dim()),
                      torch.zeros((), dtype=out.dtype, device=out.device),
                      out)
    if reduce == "max":
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out


def segment_reduce_sorted(values: torch.Tensor, sorted_keys: torch.Tensor,
                          num_segments: int, reduce: str = "sum",
                          valid: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Reduce rows sharing a key into ``[num_segments, ...]`` float32.

    Args:
        values: ``[N, ...]`` rows ordered by ``sorted_keys``.
        sorted_keys: ``[N]`` ascending int keys in ``[0, num_segments)``
            for valid rows; masked rows may carry any key.
        reduce: 'sum' | 'max' | 'mean'.
        valid: optional ``[N]`` mask; invalid rows contribute nothing.

    Empty segments are 0, and so is a segment whose every row is masked
    under 'max'.  Rows with keys outside ``[0, num_segments)`` reach no
    segment.
    """
    if valid is not None:
        sorted_keys = torch.where(valid, sorted_keys,
                                  torch.full_like(sorted_keys,
                                                  num_segments))
    n = sorted_keys.shape[0]
    if reduce in ("sum", "mean"):
        vals = values
        if valid is not None:
            vals = torch.where(_col(valid, vals.dim()), vals,
                               torch.zeros((), dtype=vals.dtype,
                                           device=vals.device))
        cols = _scan_input(vals)
        if reduce == "mean":
            # the counts ride as one more column of the same scan
            ones = torch.ones(n, 1, dtype=cols.dtype, device=cols.device)
            if valid is not None:
                ones = torch.where(valid[:, None], ones,
                                   torch.zeros_like(ones))
            cols = torch.cat([cols, ones], 1)
        scanned = _scan_sum(cols, sorted_keys)
        if reduce == "mean":
            counts, scanned = scanned[:, -1], scanned[:, :-1]
        scanned = scanned.reshape(values.shape)
    elif reduce == "max":
        vals = values.to(torch.float32)
        if valid is not None:
            vals = torch.where(_col(valid, vals.dim()), vals,
                               torch.full((), float("-inf"),
                                          device=vals.device))
        scanned = segmented_cummax(vals, segment_starts(sorted_keys))
    else:
        raise ValueError(f"unknown reduce {reduce!r}")

    # the last row of each segment holds its reduction; keys ascend, so
    # each key in range has one end row
    nxt = torch.cat([sorted_keys[1:], sorted_keys[-1:] + 1])
    ends = (sorted_keys != nxt) & (sorted_keys >= 0) & (
        sorted_keys < num_segments)
    rows = torch.nonzero(ends).reshape(-1)
    end_rows = torch.full((num_segments,), n, dtype=torch.int64,
                          device=sorted_keys.device)
    end_rows[sorted_keys[rows].long()] = rows
    has = _col(end_rows < n, scanned.dim())
    at = end_rows.clamp(max=n - 1)
    zero = torch.zeros((), dtype=scanned.dtype, device=scanned.device)
    out = torch.where(has, scanned[at], zero)
    if reduce == "mean":
        cnt = torch.where(has.reshape(-1), counts[at], zero)
        out = out / _col(cnt.clamp(min=1.0), out.dim())
    if reduce == "max":
        out = torch.where(torch.isfinite(out), out, zero)
    return out


def segment_sum_by_key(values: torch.Tensor, keys: torch.Tensor,
                       num_segments: int,
                       valid: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Unsorted convenience wrapper: sort + ``segment_reduce_sorted``
    (sum)."""
    if valid is not None:
        keys = torch.where(valid, keys, torch.full_like(keys, num_segments))
    sorted_keys, _, sorted_vals = sort_by_key(keys, values)
    return segment_reduce_sorted(sorted_vals, sorted_keys, num_segments,
                                 reduce="sum")
