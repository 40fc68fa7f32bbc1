"""Inclusive segmented cumsum over rows, a hand-written Hopper kernel.

``segmented_cumsum_rows(values, keys)``: ``out[i] = sum(values[j] for j
<= i if keys[j] == keys[i])`` for ``values [N, C]`` bf16 or fp32 and
ascending int32 ``keys [N]``, summed and returned in fp32.  Replaces the
TPU kernel ``distillbev_tpu/ops/pallas_segmented.py``
``segmented_cumsum_pallas`` (``_seg_scan_kernel``), the engine under
``ops/segmented.py:_scan_sum``; kernel ``csrc/segmented_scan.cu``.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it
takes the plain version beside it.  There is no fallback between the
two, and no width below which the kernel is skipped: the JAX package's
``C >= 8`` gate sizes an MXU matmul, and PyTorch has no segmented scan to
fall back to.  N needs no padding to a tile multiple.

Design (see the source note in ``csrc/``): tiles of rows scanned in
shared memory, a second pass that scans the tiles' (started, trailing
sum) pairs into a carry per tile, and a fix-up pass that adds the carry
to the leading rows of the tiles that continue a segment.  Every sum is
taken in a fixed order, so two launches agree bitwise.

Bound: memory, N*C values and N keys read, N*C fp32 written (128.6 MB at
[249,216, 64] fp32, about 38 us at the H100's 3.35 TB/s).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

MAX_CHANNELS = 4096   # one row of a tile must fit the kernel's 16 KB tile


def segmented_cumsum_rows_plain(values: torch.Tensor,
                                keys: torch.Tensor) -> torch.Tensor:
    """Plain version: float64 running sums less each segment's running
    sum before its first row, rounded once to fp32."""
    n = values.shape[0]
    v = values.to(torch.float64)
    if n == 0:
        return v.to(torch.float32)
    starts = torch.ones(n, dtype=torch.bool, device=keys.device)
    starts[1:] = keys[1:] != keys[:-1]
    total = torch.cumsum(v, dim=0)
    before = total - v
    rows = torch.arange(n, device=keys.device)
    first = torch.cummax(torch.where(starts, rows, 0), dim=0).values
    return (total - before[first]).to(torch.float32)


def _check(values: torch.Tensor, keys: torch.Tensor):
    if values.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"values must be float32 or bfloat16, got "
                        f"{values.dtype}")
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {keys.dtype}")
    if values.dim() != 2 or keys.dim() != 1 or keys.shape[0] != \
            values.shape[0]:
        raise ValueError(f"expected values [N, C] and keys [N], got "
                         f"{tuple(values.shape)} and {tuple(keys.shape)}")
    if values.device != keys.device:
        raise ValueError(f"values on {values.device}, keys on {keys.device}")
    if not (values.is_contiguous() and keys.is_contiguous()):
        raise ValueError("values and keys must be contiguous")
    if values.shape[0] >= 2 ** 31 or not 1 <= values.shape[1] <= \
            MAX_CHANNELS:
        raise ValueError(f"unsupported shape {tuple(values.shape)}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with its entry points' C signatures set."""
    lib = cuda_build.load("segmented_scan")
    lib.segmented_scan_tile_rows.argtypes = [ctypes.c_int]
    lib.segmented_scan_tile_rows.restype = ctypes.c_int
    for fn in (lib.segmented_scan_f32, lib.segmented_scan_bf16):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def scan_launch(values: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Launch the three passes of ``csrc/segmented_scan.cu``."""
    n, c = values.shape
    lib = _library()
    fn = lib.segmented_scan_f32 if values.dtype == torch.float32 \
        else lib.segmented_scan_bf16
    tiles = -(-n // lib.segmented_scan_tile_rows(c))
    dev = values.device
    out = torch.empty(n, c, dtype=torch.float32, device=dev)
    tile_sum = torch.empty(tiles, c, dtype=torch.float32, device=dev)
    carry = torch.empty(tiles, c, dtype=torch.float32, device=dev)
    tile_started = torch.empty(tiles, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(values.data_ptr(), keys.data_ptr(), out.data_ptr(),
                 tile_sum.data_ptr(), tile_started.data_ptr(),
                 carry.data_ptr(), n, c,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"segmented_scan launch failed: cudaError {err}")
    return out


def segmented_cumsum_rows(values: torch.Tensor,
                          keys: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented cumsum of ``values [N, C]`` (bf16 or fp32)
    over runs of equal ``keys [N]`` (int32, ascending).

    Returns ``[N, C]`` float32.  ``segmented_cumsum_rows.launches``
    counts the calls that launched the CUDA kernel (one a call, for its
    three passes).
    """
    _check(values, keys)
    if values.device.type == "cpu":
        return segmented_cumsum_rows_plain(values, keys)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    if values.shape[0] == 0:
        return torch.empty(values.shape, dtype=torch.float32,
                           device=values.device)
    out = scan_launch(values, keys)
    segmented_cumsum_rows.launches += 1
    return out


segmented_cumsum_rows.launches = 0
