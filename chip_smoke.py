#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``distillbev_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a
CUDA device, ``nvcc`` and nothing of JAX or the JAX package.  Phases:

1. print the card (``nvidia-smi``) and build every CUDA source of the
   port, all ``nvcc`` runs started together;
2. serve path, BEVDepth4D-R50 at full width, fp32, batch 1, seeded
   random weights: ``scatter_add_rows_batched`` against its plain
   version at the splat's shapes and on edge cases; the tiny student on
   the card against the same weights on the CPU; ``run_eval`` over 3
   synthetic requests with every launch count set to 0 just before and
   read just after; one more request under ``torch.profiler``;
3. train path, BEVFormer-R50 at full width (6 cameras at 928x1600, queue
   4, BEV 200x200, 6 + 6 layers), fp32, batch 1, seeded random weights:
   ``scatter_add_rows_expand`` against its plain version at the real TSA,
   SCA and decoder backward shapes (taken from a forward of the model)
   and on edge cases; the tiny BEVFormer's loss and gradients on the card
   against the same weights on the CPU; 3 AdamW train steps with the
   config's lr, lr_mult and clipping, launch counts set to 0 just before
   and read just after (18 expand launches a step: 6 TSA, 6 SCA, 6
   decoder backward calls); one more step under ``torch.profiler``; one
   test-frame request through ``forward_test_frame`` + ``get_bboxes``;
4. teacher path, the LiDAR teachers at full width (300,000 points, a
   512x512 pillar grid, SECOND + SECONDFPN to 384 channels, CenterHead
   with 6 tasks and rotate NMS), fp32, batch 1, seeded random weights:
   ``segmented_cumsum_rows`` against its plain version at the dynamic
   teacher's real scan (its point mean, [300,000, 3] sums beside the
   counts as one [300,000, 4] scan, taken from a forward) and at the
   generic ``bev_pool`` over phase 2's splat rows with 64 channels
   (whose canvas is also held against ``bev_pool_batched``'s); both tiny
   teachers on the card against the same weights on the CPU;
   ``run_eval(family="points")`` over 3 requests per teacher
   (CenterPoint-pillar, DynamicCenterPoint) with launch counts set to 0
   just before and read just after; one more request per teacher under
   ``torch.profiler``;
5. distill path, the flagship train step at full width (CenterPoint-
   pillar teacher -> BEVDepth4D-R50 with FGD, AdamW 2e-4, weight decay
   1e-2, clip at 5, the step policy), fp32, batch 1, seeded random
   weights: ``gather_rows`` against its plain version at the splat
   backward's shape (frame 0's cell ids of phase 2) and at the tool's,
   bitwise; the tiny distill step's losses and gradients on the card
   against the same weights on the CPU; 3 train steps with the launch
   counts set to 0 just before and read just after (2
   ``scatter_add_rows_batched`` a step, the two frames' splats, and 1
   ``gather_rows``, frame 0's splat backward: frame 1 reaches the BEV
   encoder detached); one more step under ``torch.profiler``;
6. the microbench tool ``distillbev_tpu_torch.tools.bench_gather`` at
   its defaults (4,194,304 rows, a 23,634-row table) with the launch
   counts set to 0 just before and read just after, after
   ``scatter_add_rows`` is held against its plain version at the tool's
   shape (fp32, within 1e-5 of each row's sum of |upd|) and on a bf16
   case (bitwise: both add in ascending row order, rounding every add).

The scan kernel is first held against its plain version on edge cases
right after the build, before any model is built.

Every kernel check holds the kernel against its plain version, checks
that two launches agree bitwise, times the kernel, its plain version and
the one-call PyTorch yardstick, and computes the kernel's bound.  Any
fault raises and the script exits non-zero.  The last line is the
result: ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
N_REQUESTS = 3
N_TRAIN_STEPS = 3
EXPAND_LAUNCHES_PER_STEP = 18   # 6 TSA + 6 SCA + 6 decoder backward calls
# the distill step: the splat forward of both frames, the splat backward
# of frame 0 only (frame 1 is detached before the BEV encoder)
SPLAT_LAUNCHES_PER_DISTILL_STEP = 2
GATHER_LAUNCHES_PER_DISTILL_STEP = 1
TOOL_N, TOOL_S = 1 << 22, 23634   # bench_gather's default rows and table
TOOL_ITERS = 5              # bench_gather's timed calls after one warm call
# DynamicPillarFeatureNet's point mean (scatter_reduce 'mean' ->
# segment_reduce_sorted): one scan of [N, 4], the three sums with the
# count as a fourth column.  The pillar teacher's reductions are capped
# windows (no scan), and its per-pillar max in the dynamic one a running
# max.
SCAN_LAUNCHES_PER_DYNAMIC_REQUEST = 1


def bound_of(nbytes: float, ops: float):
    """The least time (ms) for ``nbytes`` over the memory rate and ``ops``
    fp32 operations over the peak rate, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def splat_ids(model, batch):
    """The splat's per-sample cell ids for frame 0 of ``batch``, exactly
    as the view transformer computes them (dropped rows -> size)."""
    import torch
    vt = model.img_view_transformer
    geom = vt.geo.get_geometry(vt.frustum, batch.rots[:, 0],
                               batch.trans[:, 0], batch.intrins[:, 0],
                               batch.post_rots[:, 0], batch.post_trans[:, 0])
    nx, ny, nz = (int(v) for v in vt.geo.nx)
    lo = [float(vt.geo.bx[i] - vt.geo.dx[i] / 2) for i in range(3)]
    ix, iy, iz = (((geom[..., i] - lo[i]) / float(vt.geo.dx[i])).to(
        torch.int32) for i in range(3))
    valid = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0) &
             (iz < nz))
    size = nx * ny
    ids = torch.where(valid, (iy * nx + ix).clamp(0, size - 1),
                      torch.full_like(ix, size))
    return ids.reshape(ids.shape[0], -1).to(torch.int32).contiguous(), size


def check_scatter_rows(ids_main, size_main, width, gen):
    """scatter_add_rows_batched vs its plain version on the card."""
    import torch
    from distillbev_tpu_torch.ops import scatter_rows as sr

    dev = ids_main.device
    b, r = ids_main.shape
    cases = {"flagship": (ids_main, size_main, width)}
    ragged = torch.randint(0, 308, (2, 1037), generator=gen, device=dev)
    cases["ragged_R_W80"] = (ragged.to(torch.int32), 300, 80)
    cases["all_dropped"] = (torch.full((1, 4099), size_main,
                                       dtype=torch.int32, device=dev),
                            size_main, width)
    cases["one_cell"] = (torch.full((1, 65536), 7, dtype=torch.int32,
                                    device=dev), size_main, width)
    errs = {}
    for name, (ids, size, w) in cases.items():
        if name == "one_cell":
            # 65,536 rows into one cell: integer values keep every
            # partial sum exact, so any order of adds must agree bitwise
            upd = torch.randint(-8, 9, (*ids.shape, w), generator=gen,
                                device=dev).to(torch.float32)
        else:
            upd = torch.randn(*ids.shape, w, generator=gen, device=dev)
        out = sr.scatter_add_rows_batched(ids, upd, size)
        again = sr.scatter_add_rows_batched(ids, upd, size)
        plain = sr.scatter_add_rows_batched_plain(ids, upd, size)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"scatter_rows {name}: two launches "
                                 f"differ")
        if name == "one_cell" and not torch.equal(out, plain):
            raise AssertionError("scatter_rows one_cell: not exact")
        torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-4,
                                   msg=lambda m: f"scatter_rows {name}: {m}")
        errs[name] = float((out - plain).abs().max())
        print(f"scatter_rows {name}: ids {tuple(ids.shape)} W {w} size "
              f"{size} max_abs_err {errs[name]:.3e}", flush=True)

    upd = torch.randn(b, r, width, generator=gen, device=dev)
    n_valid = int(((ids_main >= 0) & (ids_main < size_main)).sum())
    ms = cuda_time_ms(lambda: sr.scatter_add_rows_batched(ids_main, upd,
                                                          size_main))
    plain_ms = cuda_time_ms(lambda: sr.scatter_add_rows_batched_plain(
        ids_main, upd, size_main))
    flat_ids = (ids_main.long() + torch.arange(
        b, device=dev)[:, None] * (size_main + 1)).reshape(-1)
    buf = torch.zeros(b * (size_main + 1), width, device=dev)
    upd2d = upd.reshape(-1, width)
    library_ms = cuda_time_ms(lambda: buf.index_add_(0, flat_ids, upd2d))
    order, seg_start = sr.segment_order(ids_main, size_main)
    prep_ms = cuda_time_ms(lambda: sr.segment_order(ids_main, size_main))
    sum_ms = cuda_time_ms(lambda: sr.segment_sum(upd, order, seg_start,
                                                 size_main))
    # least work: read every id, the update rows that are kept, write
    # the canvas once; one fp32 add per kept element
    nbytes = 4 * (b * r + n_valid * width + b * size_main * width)
    bound_ms, bound_by = bound_of(nbytes, n_valid * width)
    print(f"scatter_rows flagship: {n_valid}/{b * r} rows kept; "
          f"{ms:.4f} ms (sort + segment search {prep_ms:.4f} ms, segment "
          f"sum {sum_ms:.4f} ms; bound {bound_ms:.4f} ms, {nbytes} B), "
          f"plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms; "
          f"longest segment {int(torch.bincount(ids_main[0].long()).max())}"
          f" rows", flush=True)
    return dict(name="scatter_add_rows_batched", route="cuda",
                source="distillbev_tpu_torch/csrc/scatter_rows.cu",
                replaces="distillbev_tpu/ops/pallas_scatter.py:70",
                launches=None, max_abs_err=errs["flagship"], ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms,
                edge_max_abs_err={k: v for k, v in errs.items()
                                  if k != "flagship"},
                prep_ms=prep_ms, segment_sum_ms=sum_ms)


def check_tiny_against_cpu(gen_seed: int):
    """The tiny student on the card against the same weights on the CPU
    (whose path the CPU tests hold against the JAX package)."""
    import torch
    from distillbev_tpu_torch.apis.flagship import build_flagship_student

    cpu_model, cpu_batch = build_flagship_student(tiny=True, seed=gen_seed,
                                                  device="cpu")
    gpu_model, _ = build_flagship_student(tiny=True, seed=gen_seed,
                                          device="cuda")
    with torch.inference_mode():
        ref, _, _ = cpu_model(cpu_batch)
        got, _, _ = gpu_model(type(cpu_batch)(*[
            None if a is None else a.cuda() for a in cpu_batch]))
    worst = 0.0
    for t_ref, t_got in zip(ref, got):
        for key in t_ref:
            torch.testing.assert_close(t_got[key].cpu(), t_ref[key],
                                       rtol=1e-3, atol=1e-3)
            worst = max(worst, float((t_got[key].cpu() - t_ref[key])
                                     .abs().max()))
    print(f"tiny student cuda vs cpu: head maps max_abs_err {worst:.3e}",
          flush=True)
    return worst


def serve(model, gen_seed: int):
    """run_eval over N_REQUESTS synthetic requests; returns the
    per-request latencies (ms) and raises if a head map is not finite or
    a decoded result has the wrong shape or values."""
    import numpy as np
    import torch
    from distillbev_tpu_torch.apis.flagship import make_example_batch
    from distillbev_tpu_torch.apis.test import run_eval

    requests = [make_example_batch(1, seed=gen_seed + i, device="cuda")
                for i in range(N_REQUESTS)]
    head_ok = []
    hook = model.pts_bbox_head.register_forward_hook(
        lambda mod, inp, out: head_ok.append(all(
            bool(torch.isfinite(v).all()) for task in out
            for v in task.values())))
    stamps = []

    def loader():
        for i, batch in enumerate(requests):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            yield {"img_inputs": batch,
                   "img_metas": [{"sample_idx": f"request{i}"}]}
        stamps.append(time.perf_counter())

    try:
        results = run_eval(model, loader(), family="img", device="cuda")
    finally:
        hook.remove()
    latencies = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    if head_ok != [True] * N_REQUESTS:
        raise AssertionError(f"non-finite head maps: {head_ok}")
    for token, (boxes, scores, labels, valid) in results.items():
        if boxes.shape != (500, 9) or scores.shape != (500,):
            raise AssertionError(f"{token}: boxes {boxes.shape}")
        if not (np.isfinite(boxes).all() and np.isfinite(scores).all()):
            raise AssertionError(f"{token}: non-finite boxes")
        if labels.min() < 0 or labels.max() >= 10:
            raise AssertionError(f"{token}: labels out of range")
        print(f"{token}: {int(valid.sum())} valid boxes, top score "
              f"{float(scores.max()):.4f}", flush=True)
    if len(results) != N_REQUESTS:
        raise AssertionError(f"{len(results)} results")
    return latencies


def profiled(fn):
    """Run ``fn`` once under torch.profiler: its wall time, device time by
    kernel and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in kernels]
    dev_ms.sort(key=lambda t: -t[1])
    total = sum(t[1] for t in dev_ms)
    return {"wall_ms": wall_ms, "device_ms": total,
            "busy_share": total / wall_ms, "n_kernels": sum(
                t[2] for t in dev_ms),
            "top": [[k[:90], round(ms, 4), n] for k, ms, n in dev_ms[:15]]}


def profile_request(model, seed: int):
    """One more request under torch.profiler, after the counted run."""
    import torch
    from distillbev_tpu_torch.apis.flagship import make_example_batch

    batch = make_example_batch(1, seed=seed, device="cuda")

    def request():
        preds, _, _ = model(batch)
        model.get_bboxes(preds)

    with torch.inference_mode():
        return profiled(request)


def msda_calls(model, batch):
    """The (value, shapes, loc, weight) of the first TSA, SCA and decoder
    calls of the sampling core in one test-frame forward of the full
    model, exactly as the model makes them (the shapes every train step
    gives the dvalue kernel)."""
    import torch
    from distillbev_tpu_torch.models.transformer import attention

    real = attention.ms_deform_attn
    calls = {}

    def record(value, shapes, loc, weight):
        kind = "sca" if len(shapes) > 1 else (
            "tsa" if loc.shape[1] == value.shape[1] else "decoder")
        calls.setdefault(kind, (value.detach(), tuple(shapes),
                                loc.detach(), weight.detach()))
        return real(value, shapes, loc, weight)

    head = model.pts_bbox_head
    attention.ms_deform_attn = record
    try:
        with torch.no_grad():
            model.forward_test_frame(
                batch.imgs[:, -1], batch.can_bus[:, -1],
                batch.lidar2img[:, -1],
                batch.imgs.new_zeros(1, head.bev_h * head.bev_w,
                                     head.embed_dims),
                batch.imgs.new_ones(1))
    finally:
        attention.ms_deform_attn = real
    if set(calls) != {"tsa", "sca", "decoder"}:
        raise AssertionError(f"sampling calls seen: {sorted(calls)}")
    return calls


def expand_bound(ids_sq, w, g, size):
    """Least bytes and operations of one expand call on these inputs:
    every id, the corner weights of the kept samples, the C-wide g rows of
    the queries with a kept sample, the 4C-wide accumulator written once;
    a multiply and an add per kept sample and output channel."""
    groups, lbp, q = ids_sq.shape
    c = g.shape[2]
    width = 4 * c
    kept = (ids_sq >= 0) & (ids_sq < size)
    n_kept = int(kept.sum())
    n_queries = int(kept.any(dim=1).sum())
    nbytes = 4 * (ids_sq.numel() + 4 * n_kept + n_queries * c +
                  groups * size * width)
    ops = 2 * n_kept * width
    bound_ms, bound_by = bound_of(nbytes, ops)
    return dict(bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                ops=ops, kept_samples=n_kept)


def check_scatter_expand(calls, gen):
    """scatter_add_rows_expand vs its plain version on the card, at the
    real TSA, SCA and decoder backward shapes and on edge cases."""
    import importlib
    import torch
    from distillbev_tpu_torch.ops import scatter_rows as sr

    # the module (the package exports its function under the same name)
    msda = importlib.import_module("distillbev_tpu_torch.ops.ms_deform_attn")
    dev = gen.device
    cases = {}
    for kind, (value, shapes, loc, weight) in calls.items():
        b, _, m, c = value.shape
        gather, _ = msda._level_groups(shapes)
        ids_sq, w, size = msda.expand_operands(
            msda._to_groups(loc), msda._to_groups(weight), shapes, gather)
        g = torch.randn(b * m, loc.shape[1], c, generator=gen, device=dev)
        cases[kind] = (ids_sq, w, g, size)
    ragged = torch.randint(0, 1530, (3, 24, 1037), generator=gen,
                           device=dev, dtype=torch.int32)
    cases["ragged_Q"] = (ragged, torch.rand(3, 1037, 96, generator=gen,
                                            device=dev),
                         torch.randn(3, 1037, 32, generator=gen,
                                     device=dev), 1530)
    narrow = torch.randint(0, 400, (4, 8, 2000), generator=gen, device=dev,
                           dtype=torch.int32)
    cases["C8"] = (narrow, torch.rand(4, 2000, 32, generator=gen,
                                      device=dev),
                   torch.randn(4, 2000, 8, generator=gen, device=dev), 400)
    cases["all_dropped"] = (torch.full((4, 4, 5000), 4041, device=dev,
                                       dtype=torch.int32),
                            torch.rand(4, 5000, 16, generator=gen,
                                       device=dev),
                            torch.randn(4, 5000, 32, generator=gen,
                                        device=dev), 4041)
    # 65,536 updates into one row: integer-valued factors keep every
    # product and partial sum exact, so any order of adds agrees bitwise
    cases["one_row"] = (
        torch.full((1, 4, 16384), 7, device=dev, dtype=torch.int32),
        torch.randint(-2, 3, (1, 16384, 16), generator=gen,
                      device=dev).to(torch.float32),
        torch.randint(-8, 9, (1, 16384, 32), generator=gen,
                      device=dev).to(torch.float32), 4041)
    errs = {}
    for name, (ids_sq, w, g, size) in cases.items():
        out = sr.scatter_add_rows_expand(ids_sq, w, g, size)
        again = sr.scatter_add_rows_expand(ids_sq, w, g, size)
        plain = sr.scatter_add_rows_expand_plain(ids_sq, w, g, size)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"expand {name}: two launches differ")
        if name == "one_row" and not torch.equal(out, plain):
            raise AssertionError("expand one_row: not exact")
        if name == "all_dropped" and out.any():
            raise AssertionError("expand all_dropped: nonzero output")
        torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-4,
                                   msg=lambda msg: f"expand {name}: {msg}")
        errs[name] = float((out - plain).abs().max())
        print(f"expand {name}: ids {tuple(ids_sq.shape)} C {g.shape[2]} "
              f"size {size} max_abs_err {errs[name]:.3e}",
              flush=True)
        del out, again, plain

    shapes = {}
    for kind in ("tsa", "sca", "decoder"):
        ids_sq, w, g, size = cases[kind]
        groups, lbp, q = ids_sq.shape
        ms = cuda_time_ms(lambda: sr.scatter_add_rows_expand(ids_sq, w, g,
                                                             size))
        plain_ms = cuda_time_ms(lambda: sr.scatter_add_rows_expand_plain(
            ids_sq, w, g, size), iters=5, warmup=1)
        order, seg_start = sr.expand_segment_order(ids_sq, size)
        prep_ms = cuda_time_ms(lambda: sr.expand_segment_order(ids_sq,
                                                               size))
        sum_ms = cuda_time_ms(lambda: sr.expand_segment_sum(
            w, g, order, seg_start, lbp, size))
        del order, seg_start
        # one-call yardstick: index_add_ over the materialised rows
        c = g.shape[2]
        width = 4 * c
        keep = (ids_sq >= 0) & (ids_sq < size)
        idx = (torch.where(keep, ids_sq, torch.full_like(ids_sq, size))
               .long() + (size + 1) * torch.arange(
                   groups, device=dev).reshape(groups, 1, 1)).reshape(-1)
        upd = (w.reshape(groups, q, lbp, 4).permute(0, 2, 1, 3)[..., None]
               * g.reshape(groups, 1, q, 1, c)).reshape(-1, width)
        buf = torch.zeros(groups * (size + 1), width, device=dev)
        library_ms = cuda_time_ms(lambda: buf.index_add_(0, idx, upd),
                                  iters=5, warmup=1)
        del upd, buf, idx
        bound = expand_bound(ids_sq, w, g, size)
        shapes[kind] = dict(groups=groups, lbp=lbp, queries=q, size=size,
                            width=width, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, prep_ms=prep_ms,
                            segment_sum_ms=sum_ms,
                            max_abs_err=errs[kind], **bound)
        print(f"expand {kind}: [{groups}, {lbp}, {q}] -> [{groups}, {size},"
              f" {width}]; {ms:.4f} ms (sort + segment search "
              f"{prep_ms:.4f} ms, segment sum {sum_ms:.4f} ms; bound "
              f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}, "
              f"{bound['bytes']} B, {bound['kept_samples']} kept samples),"
              f" plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms",
              flush=True)
    main = shapes["tsa"]
    return dict(name="scatter_add_rows_expand", route="cuda",
                source="distillbev_tpu_torch/csrc/scatter_rows_expand.cu",
                replaces="distillbev_tpu/ops/pallas_scatter.py:154",
                launches=None, max_abs_err=max(
                    shapes[k]["max_abs_err"] for k in shapes),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], timed_shape="tsa",
                shapes=shapes, edge_max_abs_err={
                    k: v for k, v in errs.items() if k not in shapes})


TINY_GRADS = ("img_neck.fpn_convs.3.conv.weight",
              "pts_bbox_head.transformer.encoder.layers.0.attentions.0"
              ".value_proj.weight",
              "pts_bbox_head.transformer.encoder.layers.1.attentions.1"
              ".deformable_attention.sampling_offsets.weight",
              "pts_bbox_head.transformer.decoder.layers.1.attentions.1"
              ".value_proj.weight",
              "pts_bbox_head.bev_embedding.weight",
              "pts_bbox_head.cls_branches.1.6.weight")


def check_tiny_bevformer_against_cpu(seed: int):
    """The tiny BEVFormer's losses and gradients on the card against the
    same weights on the CPU (whose path the CPU tests hold against the
    JAX package); dropout and GridMask off."""
    import copy
    import torch
    from distillbev_tpu_torch.apis.flagship import build_bevformer
    from distillbev_tpu_torch.training import gravity_centered

    cpu_model, cpu_batch = build_bevformer(tiny=True, seed=seed,
                                           device="cpu")
    gpu_model = copy.deepcopy(cpu_model).cuda()
    gpu_batch = type(cpu_batch)(*[None if a is None else a.cuda()
                                  for a in cpu_batch])

    def loss_and_grads(model, batch):
        outs = model(batch.imgs, batch.can_bus, batch.lidar2img,
                     batch.prev_exists)
        losses = model.loss(outs, gravity_centered(batch.gt_boxes),
                            batch.gt_labels, batch.gt_mask)
        sum(losses.values()).backward()
        params = dict(model.named_parameters())
        return losses, {n: params[n].grad.cpu() for n in TINY_GRADS}

    ref_losses, ref_grads = loss_and_grads(cpu_model, cpu_batch)
    losses, grads = loss_and_grads(gpu_model, gpu_batch)
    worst = 0.0
    for key in ref_losses:
        torch.testing.assert_close(losses[key].detach().cpu(),
                                   ref_losses[key].detach(), rtol=1e-3,
                                   atol=1e-3)
        worst = max(worst, float((losses[key].detach().cpu() -
                                  ref_losses[key].detach()).abs()))
    for key in TINY_GRADS:
        torch.testing.assert_close(grads[key], ref_grads[key], rtol=1e-3,
                                   atol=1e-3, msg=lambda m: f"{key}: {m}")
        worst = max(worst, float((grads[key] - ref_grads[key]).abs().max()))
    print(f"tiny BEVFormer cuda vs cpu: losses and {len(TINY_GRADS)} grads "
          f"max_abs_err {worst:.3e}", flush=True)
    return worst


def train_bevformer(model, batch, seed: int, counters):
    """N_TRAIN_STEPS AdamW steps with the config's optimizer; launch
    counts set to 0 just before and read just after.  Returns the
    per-step metrics, wall times, peak memory, launches and the profile
    of one more step."""
    import torch
    from distillbev_tpu_torch.apis.flagship import bevformer_train_cfg
    from distillbev_tpu_torch.training import make_bevformer_train_step
    from distillbev_tpu_torch.training.optim import build_optimizer
    from distillbev_tpu_torch.training.schedules import build_lr_schedule

    opt_cfg, opt_conf, lr_cfg, total = bevformer_train_cfg()
    sched = build_lr_schedule(lr_cfg, opt_cfg["lr"], total, total // 24)
    opt = build_optimizer(opt_cfg, sched, model, opt_conf["grad_clip"])
    step_fn = make_bevformer_train_step(model, opt, seed=seed)
    bev_ok = []
    hook = model.pts_bbox_head.register_forward_hook(
        lambda mod, inp, out: bev_ok.append(bool(torch.isfinite(
            out["bev_embed"]).all())) if isinstance(out, dict) else None)
    walls, metrics = [], []
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        for step in range(N_TRAIN_STEPS):
            t0 = time.perf_counter()
            m = step_fn(batch, step)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            metrics.append({k: float(v) for k, v in m.items()})
            print(f"train step {step}: {walls[-1]:.1f} ms, total_loss "
                  f"{metrics[-1]['total_loss']:.4f}, grad_norm "
                  f"{metrics[-1]['grad_norm']:.4f}", flush=True)
        launches = {name: fn.launches for name, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        prof = profiled(lambda: step_fn(batch, N_TRAIN_STEPS))
    finally:
        hook.remove()
    bad = [(i, k) for i, m in enumerate(metrics) for k, v in m.items()
           if not np.isfinite(v)]
    if bad or bev_ok[:N_TRAIN_STEPS] != [True] * N_TRAIN_STEPS:
        raise AssertionError(f"non-finite metrics {bad} or bev_embed "
                             f"{bev_ok}")
    return dict(metrics=metrics, step_ms=walls, peak_mem_bytes=peak,
                launches=launches, profile=prof)


def test_frame_requests(model, batch):
    """forward_test_frame + get_bboxes on the queue's first two frames:
    a scene start (zero prev_bev, gated off) and its continuation."""
    import torch
    head = model.pts_bbox_head
    prev = batch.imgs.new_zeros(1, head.bev_h * head.bev_w,
                                head.embed_dims)
    valid = batch.imgs.new_zeros(1)
    walls = []
    with torch.no_grad():
        for t in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = model.forward_test_frame(
                batch.imgs[:, t], batch.can_bus[:, t], batch.lidar2img[:, t],
                prev, valid)
            dec = model.get_bboxes(outs)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            prev, valid = outs["bev_embed"], batch.imgs.new_ones(1)
            k = head.bbox_coder_cfg["max_num"]
            if dec.bboxes.shape != (1, k, 9) or dec.scores.shape != (1, k):
                raise AssertionError(f"decoded {tuple(dec.bboxes.shape)}")
            if not (torch.isfinite(dec.bboxes).all() and
                    torch.isfinite(prev).all()):
                raise AssertionError("non-finite test-frame outputs")
            if int(dec.labels.min()) < 0 or int(dec.labels.max()) >= 10 or \
                    not ((dec.scores >= 0) & (dec.scores <= 1)).all():
                raise AssertionError("labels or scores out of range")
            print(f"test frame {t}: {walls[-1]:.1f} ms, "
                  f"{int(dec.valid.sum())} valid boxes, top score "
                  f"{float(dec.scores.max()):.4f}", flush=True)
    return walls


def kernel_device_ms(fn, names, iters: int = 10):
    """Device time a call of each kernel whose name holds one of
    ``names``, from ``torch.profiler`` over ``iters`` calls of ``fn``
    (the launch gaps that CUDA events count between calls left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name in names}
    for e in prof.key_averages():
        for name in names:
            if name in e.key:
                out[name] += e.self_device_time_total / 1e3 / iters
    return {name: round(ms, 5) for name, ms in out.items()}


def scan_magnitude(values, keys):
    """Running sum of |values| within each segment: the scale of the
    rounding a sum in another order may differ by."""
    from distillbev_tpu_torch.ops import segmented_scan
    return segmented_scan.segmented_cumsum_rows_plain(
        values.float().abs(), keys)


def check_scan_case(name, values, keys, exact=False):
    """segmented_cumsum_rows vs its plain version on one input: within
    1e-5 of the segment's magnitude (bitwise when ``exact``), two
    launches bitwise equal.  Returns the max abs error."""
    import torch
    from distillbev_tpu_torch.ops import segmented_scan as ss

    out = ss.segmented_cumsum_rows(values, keys)
    again = ss.segmented_cumsum_rows(values, keys)
    plain = ss.segmented_cumsum_rows_plain(values, keys)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"scan {name}: two launches differ")
    if exact and not torch.equal(out, plain):
        raise AssertionError(f"scan {name}: not exact")
    err = (out - plain).abs()
    slack = 1e-5 * scan_magnitude(values, keys) + 1e-6 - err
    if not bool((slack >= 0).all()):
        raise AssertionError(f"scan {name}: off by {float(-slack.min())} "
                             f"beyond 1e-5 of the segment magnitude")
    n_seg = int((keys[1:] != keys[:-1]).sum()) + 1
    print(f"scan {name}: [{values.shape[0]}, {values.shape[1]}] "
          f"{str(values.dtype)[6:]}, {n_seg} segments, max_abs_err "
          f"{float(err.max()):.3e}", flush=True)
    return float(err.max())


def check_scan_edge_cases(gen):
    """The scan kernel on edge cases: every width of the CPU tests, bf16,
    one segment over a million rows, every row its own segment, no N a
    multiple of any tile, integer values (exact in any order), no rows
    (no launch)."""
    import torch
    from distillbev_tpu_torch.ops import segmented_scan as ss
    dev = gen.device
    errs = {}
    before = ss.segmented_cumsum_rows.launches
    empty = ss.segmented_cumsum_rows(
        torch.empty(0, 3, device=dev),
        torch.empty(0, dtype=torch.int32, device=dev))
    if empty.shape != (0, 3) or empty.dtype != torch.float32 or \
            ss.segmented_cumsum_rows.launches != before:
        raise AssertionError("scan of no rows: launched or ill formed")
    n = 100_003
    keys = torch.sort(torch.randint(0, n // 4, (n,), generator=gen,
                                    device=dev, dtype=torch.int32)).values
    for c in (1, 3, 8, 64):
        vals = torch.randn(n, c, generator=gen, device=dev)
        errs[f"C{c}"] = check_scan_case(f"C{c}", vals, keys)
    errs["bf16_C64"] = check_scan_case(
        "bf16_C64", torch.randn(n, 64, generator=gen, device=dev).to(
            torch.bfloat16), keys)
    m = 1_000_003
    errs["one_segment"] = check_scan_case(
        "one_segment", torch.randn(m, 3, generator=gen, device=dev),
        torch.zeros(m, dtype=torch.int32, device=dev))
    errs["singletons"] = check_scan_case(
        "singletons", torch.randn(70_001, 8, generator=gen, device=dev),
        torch.arange(70_001, dtype=torch.int32, device=dev))
    ints = torch.randint(-8, 9, (1 << 20, 4), generator=gen, device=dev)
    errs["integers_one_segment"] = check_scan_case(
        "integers_one_segment", ints.to(torch.float32),
        torch.full((1 << 20,), 5, dtype=torch.int32, device=dev),
        exact=True)
    return errs


def scan_calls(fn):
    """Run ``fn`` once; the (values, keys) of every segmented-scan call it
    makes, exactly as the port makes them."""
    import torch
    from distillbev_tpu_torch.ops import segmented

    real = segmented.segmented_cumsum_rows
    calls = []

    def record(values, keys):
        calls.append((values.clone(), keys.clone()))
        return real(values, keys)

    segmented.segmented_cumsum_rows = record
    try:
        with torch.inference_mode():
            fn()
    finally:
        segmented.segmented_cumsum_rows = real
    return calls


def check_bev_pool_generic(ids_main, size, nx, gen):
    """The generic ``bev_pool`` over the splat's rows (phase 2's cell
    ids) with 64 random channels, against ``bev_pool_batched``'s canvas;
    returns the scan's (values, keys) at this shape and the two splats'
    times."""
    import torch
    from distillbev_tpu_torch.ops.bev_pool import bev_pool, bev_pool_batched

    dev = ids_main.device
    b, r = ids_main.shape
    ny = size // nx
    feats = torch.randn(b, r, 64, generator=gen, device=dev)
    valid = ids_main < size
    ids = ids_main.long()
    coords = torch.stack([torch.arange(b, device=dev)[:, None].expand(b, r),
                          ids // nx, ids % nx], -1).reshape(-1, 3).to(
                              torch.int32)
    canvas = []
    calls = scan_calls(lambda: canvas.append(bev_pool(
        feats.reshape(-1, 64), coords, valid.reshape(-1), b, ny, nx)))
    if len(calls) != 1:
        raise AssertionError(f"bev_pool made {len(calls)} scans")
    with torch.inference_mode():
        batched = bev_pool_batched(feats, ids_main, valid, ny, nx)
        mag = bev_pool_batched(feats.abs(), ids_main, valid, ny, nx)
        err = (canvas[0] - batched).abs()
        if not bool((err <= 1e-5 * mag + 1e-5).all()):
            raise AssertionError("bev_pool vs bev_pool_batched: canvases "
                                 "differ beyond rounding")
        generic_ms = cuda_time_ms(lambda: bev_pool(
            feats.reshape(-1, 64), coords, valid.reshape(-1), b, ny, nx),
            iters=10)
        batched_ms = cuda_time_ms(lambda: bev_pool_batched(
            feats, ids_main, valid, ny, nx), iters=10)
    print(f"bev_pool generic vs batched over the splat rows [{b * r}, 64]: "
          f"max_abs_err {float(err.max()):.3e}; {generic_ms:.4f} ms "
          f"against {batched_ms:.4f} ms", flush=True)
    return calls[0], dict(generic_ms=generic_ms, batched_ms=batched_ms,
                          canvas_max_abs_err=float(err.max()))


def scan_shape_report(name, values, keys):
    """Time the scan kernel, its plain version and ``index_add_`` of the
    segment sums the scan feeds (no single PyTorch call computes a
    segmented scan) at one real shape; compute the bound."""
    import torch
    from distillbev_tpu_torch.ops import segmented_scan as ss

    err = check_scan_case(name, values, keys)
    n, c = values.shape
    with torch.inference_mode():
        ms = cuda_time_ms(lambda: ss.segmented_cumsum_rows(values, keys))
        plain_ms = cuda_time_ms(lambda: ss.segmented_cumsum_rows_plain(
            values, keys), iters=5, warmup=1)
        idx = keys.long()
        buf = torch.zeros(int(idx.max()) + 1, c, device=values.device)
        rows = values.float()
        index_add_ms = cuda_time_ms(lambda: buf.index_add_(0, idx, rows))
        longest = int(torch.unique_consecutive(keys, return_counts=True)[1]
                      .max())
        device_ms = kernel_device_ms(
            lambda: ss.segmented_cumsum_rows(values, keys),
            ("tile_scan_kernel", "carry_scan_kernel", "carry_fixup_kernel"))
    # least work: read the values and keys once, write the fp32 output
    # once; one fp32 add per value
    nbytes = n * c * values.element_size() + 4 * n + 4 * n * c
    bound_ms, bound_by = bound_of(nbytes, n * c)
    print(f"scan {name}: {ms:.4f} ms a call (device time of its passes "
          f"{device_ms}; bound {bound_ms:.4f} ms, {nbytes} B), plain "
          f"{plain_ms:.4f} ms, index_add_ of the segment sums "
          f"{index_add_ms:.4f} ms; longest segment {longest} rows",
          flush=True)
    return dict(rows=n, channels=c, dtype=str(values.dtype)[6:], ms=ms,
                device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes,
                index_add_segment_sums_ms=index_add_ms, max_abs_err=err,
                longest_segment=longest)


def check_tiny_teachers_against_cpu(seed: int):
    """Both tiny teachers on the card against the same weights on the CPU
    (whose path the CPU tests hold against the JAX package)."""
    import copy
    import torch
    from distillbev_tpu_torch.apis.flagship import build_teacher

    worst = {}
    for kind in ("pillar", "dynamic"):
        cpu_model, batch = build_teacher(kind, tiny=True, seed=seed,
                                         device="cpu")
        gpu_model = copy.deepcopy(cpu_model).cuda()
        with torch.inference_mode():
            ref, ref_bundle = cpu_model(batch.points, batch.point_mask)
            got, bundle = gpu_model(batch.points.cuda(),
                                    batch.point_mask.cuda())
        pairs = [(bundle.canvas, ref_bundle.canvas),
                 (bundle.neck_feat, ref_bundle.neck_feat)] + [
            (g[k], r[k]) for g, r in zip(got, ref) for k in r]
        worst[kind] = 0.0
        for g, r in pairs:
            torch.testing.assert_close(g.cpu(), r, rtol=1e-3, atol=1e-3)
            worst[kind] = max(worst[kind], float((g.cpu() - r).abs().max()))
        print(f"tiny {kind} teacher cuda vs cpu: canvas, neck and head maps "
              f"max_abs_err {worst[kind]:.3e}", flush=True)
    return worst


def teacher_data_report(model, batch):
    """What the synthetic cloud keeps: pillars and points within the voxel
    budget (and the per-pillar cap of the hard teacher); in the dynamic
    teacher the dropped points form one segment of the scatter's scan."""
    import torch
    from distillbev_tpu_torch.ops.voxelize import (compute_voxel_coords,
                                                   grid_xyz,
                                                   sorted_voxel_info,
                                                   unique_voxels)

    vl = model.pts_voxel_layer
    vs, pcr = tuple(vl["voxel_size"]), tuple(vl["point_cloud_range"])
    gx, gy, gz = grid_xyz(vs, pcr)
    pts, mask = batch.points[0], batch.point_mask[0]
    with torch.inference_mode():
        coords, ok = compute_voxel_coords(pts, vs, pcr)
        ok = ok & mask
        occupied = int(torch.unique(coords[ok][:, 1] * gx + coords[ok][:, 2])
                       .numel())
        if hasattr(model, "max_voxels"):
            p2v, _, nvox = unique_voxels(coords, ok, (gz, gy, gx),
                                         model.max_voxels)
            kept = int((p2v < model.max_voxels).sum())
        else:
            info = sorted_voxel_info(pts, mask, vs, pcr,
                                     vl["max_num_points"],
                                     vl["max_voxels"][0], presorted=True)
            nvox, kept = info.num_voxels, int(info.keep.sum())
    return dict(points=int(pts.shape[0]), in_grid=int(ok.sum()),
                occupied_pillars=occupied, kept_pillars=int(nvox),
                kept_points=kept, dropped_points=int(pts.shape[0]) - kept)


def serve_teacher(model, kind: str, seed: int, counters):
    """run_eval(family="points") over N_REQUESTS synthetic clouds with the
    launch counts set to 0 just before and read just after; checks the
    head maps are finite and the decoded results well formed."""
    import torch
    from distillbev_tpu_torch.apis.flagship import make_points_example_batch
    from distillbev_tpu_torch.apis.test import run_eval

    requests = [make_points_example_batch(1, seed=seed + i, device="cuda")
                for i in range(N_REQUESTS)]
    head_ok = []
    hook = model.pts_bbox_head.register_forward_hook(
        lambda mod, inp, out: head_ok.append(all(
            bool(torch.isfinite(v).all()) for task in out
            for v in task.values())))
    stamps = []

    def loader():
        for i, batch in enumerate(requests):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            yield {"points": batch.points, "point_mask": batch.point_mask,
                   "img_metas": [{"sample_idx": f"{kind}{i}"}]}
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    try:
        results = run_eval(model, loader(), family="points", device="cuda")
    finally:
        hook.remove()
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    latencies = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    if head_ok != [True] * N_REQUESTS or len(results) != N_REQUESTS:
        raise AssertionError(f"{kind}: head maps finite {head_ok}, "
                             f"{len(results)} results")
    valid_boxes = []
    for token, (boxes, scores, labels, valid) in results.items():
        if boxes.shape != (500, 9) or scores.shape != (500,):
            raise AssertionError(f"{token}: boxes {boxes.shape}")
        if not (np.isfinite(boxes).all() and np.isfinite(scores).all()):
            raise AssertionError(f"{token}: non-finite boxes")
        if labels.min() < 0 or labels.max() >= 10:
            raise AssertionError(f"{token}: labels out of range")
        valid_boxes.append(int(valid.sum()))
        print(f"{token}: {latencies[len(valid_boxes) - 1]:.1f} ms, "
              f"{valid_boxes[-1]} valid boxes, top score "
              f"{float(scores.max()):.4f}", flush=True)
    prof_batch = make_points_example_batch(1, seed=seed + N_REQUESTS,
                                           device="cuda")

    def request():
        preds, _ = model(prof_batch.points, prof_batch.point_mask)
        model.get_bboxes(preds)

    with torch.inference_mode():
        prof = profiled(request)
    return dict(latency_ms=latencies, peak_mem_bytes=peak,
                valid_boxes=valid_boxes, launches=launches, profile=prof)


def teacher_path(ids_main, size_main, nx, seed, gen, counters):
    """Phase 4: the scan kernel at its real shapes, the tiny teachers
    card vs CPU, then each full-width teacher served."""
    import torch
    from distillbev_tpu_torch.apis.flagship import build_teacher

    (bp_values, bp_keys), bev_pool_times = check_bev_pool_generic(
        ids_main, size_main, nx, gen)
    tiny_err = check_tiny_teachers_against_cpu(seed)
    served, shapes, data = {}, {}, {}
    for kind in ("dynamic", "pillar"):
        t0 = time.perf_counter()
        model, batch = build_teacher(kind, seed=seed, device="cuda")
        n_params = sum(p.numel() for p in model.parameters())
        print(f"{kind} teacher: {n_params} parameters, built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        data[kind] = teacher_data_report(model, batch)
        print(f"{kind} teacher cloud: {data[kind]}", flush=True)
        if kind == "dynamic":
            calls = scan_calls(lambda: model(batch.points, batch.point_mask))
            if len(calls) != SCAN_LAUNCHES_PER_DYNAMIC_REQUEST:
                raise AssertionError(f"dynamic forward made {len(calls)} "
                                     f"scans")
            shapes["vfe_mean"] = scan_shape_report("vfe_mean", *calls[0])
            del calls
        served[kind] = serve_teacher(model, kind, seed, counters)
        want = {name: 0 for name in counters}
        if kind == "dynamic":
            want["segmented_cumsum_rows"] = \
                SCAN_LAUNCHES_PER_DYNAMIC_REQUEST * N_REQUESTS
        if served[kind]["launches"] != want:
            raise AssertionError(f"{kind} serve launches "
                                 f"{served[kind]['launches']}, expected "
                                 f"{want}")
        del model, batch
        torch.cuda.empty_cache()
    shapes["bev_pool"] = scan_shape_report("bev_pool", bp_values, bp_keys)
    return served, shapes, dict(tiny_cuda_vs_cpu_max_abs_err=tiny_err,
                                bev_pool=bev_pool_times, clouds=data)


def check_gather_rows(ids_main, size_main, width, gen):
    """gather_rows vs its plain version on the card, bitwise: at the
    splat backward's shape (the cotangent [size, C] fp32 gathered by
    frame 0's cell ids, dropped rows past the table), at the tool's shape
    and on edge cases; times, bound and the ``index_select`` yardstick at
    the two real shapes."""
    import torch
    from distillbev_tpu_torch.ops import gather_rows, gather_rows_plain
    from distillbev_tpu_torch.tools.bench_gather import gather_bytes

    dev = ids_main.device
    s_tool, n_tool = TOOL_S, TOOL_N
    cases = {
        "splat_backward": (torch.randn(size_main, width, generator=gen,
                                       device=dev), ids_main[0].contiguous()),
        "tool": (torch.randn(s_tool, 128, generator=gen, device=dev).to(
            torch.bfloat16), torch.randint(0, s_tool, (n_tool,),
                                           generator=gen, device=dev,
                                           dtype=torch.int32)),
        "bf16_W3": (torch.randn(1000, 3, generator=gen, device=dev).to(
            torch.bfloat16), torch.randint(-5, 1005, (70001,), generator=gen,
                                           device=dev, dtype=torch.int32)),
        "fp32_W5": (torch.randn(1000, 5, generator=gen, device=dev),
                    torch.randint(-5, 1005, (70001,), generator=gen,
                                  device=dev, dtype=torch.int32)),
        "no_rows": (torch.randn(10, 64, generator=gen, device=dev),
                    torch.empty(0, dtype=torch.int32, device=dev)),
    }
    shapes = {}
    for name, (table, idx) in cases.items():
        out = gather_rows(table, idx)
        again = gather_rows(table, idx)
        plain = gather_rows_plain(table, idx)
        torch.cuda.synchronize()
        if not (torch.equal(out, again) and torch.equal(out, plain)):
            raise AssertionError(f"gather_rows {name}: not bitwise equal")
        print(f"gather_rows {name}: table {tuple(table.shape)} "
              f"{str(table.dtype)[6:]}, {idx.shape[0]} rows, bitwise equal",
              flush=True)
        if name not in ("splat_backward", "tool"):
            continue
        s, w = table.shape
        n = idx.shape[0]
        ms = cuda_time_ms(lambda: gather_rows(table, idx))
        plain_ms = cuda_time_ms(lambda: gather_rows_plain(table, idx))
        padded = torch.cat([table, table.new_zeros(1, w)])
        lib_idx = torch.where((idx >= 0) & (idx < s), idx,
                              torch.full_like(idx, s))
        library_ms = cuda_time_ms(lambda: torch.index_select(padded, 0,
                                                             lib_idx))
        # a copy does no arithmetic
        nbytes = gather_bytes(n, s, w, table.element_size())
        bound_ms, bound_by = bound_of(nbytes, 0)
        shapes[name] = dict(rows=n, table=[s, w],
                            dtype=str(table.dtype)[6:], ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            bytes=nbytes, max_abs_err=0.0)
        print(f"gather_rows {name}: {ms:.4f} ms (bound {bound_ms:.4f} ms, "
              f"{nbytes} B), plain {plain_ms:.4f} ms, index_select "
              f"{library_ms:.4f} ms", flush=True)
    return shapes


def check_scatter_add_rows(gen):
    """scatter_add_rows vs its plain version on the card at the tool's
    shape (fp32: within 1e-5 of each row's sum of |upd|) and on a bf16
    case (bitwise) and ids outside [0, size); times, bound and the
    ``index_add_`` yardstick at the tool's shape."""
    import torch
    from distillbev_tpu_torch.ops import scatter_rows as sr
    from distillbev_tpu_torch.tools.bench_gather import scatter_bytes

    dev = gen.device
    s, n = TOOL_S, TOOL_N
    idx = torch.randint(0, s, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    rows = torch.randn(n, 128, generator=gen, device=dev)
    out = sr.scatter_add_rows(idx, rows, s)
    again = sr.scatter_add_rows(idx, rows, s)
    plain = sr.scatter_add_rows_plain(idx, rows, s)
    mag = sr.scatter_add_rows_plain(idx, rows.abs(), s)
    torch.cuda.synchronize()
    err = (out - plain).abs()
    if not torch.equal(out, again) or not bool(
            (err <= 1e-5 * mag + 1e-6).all()):
        raise AssertionError("scatter_add_rows tool: differs beyond 1e-5 "
                             "of the row magnitude or between launches")
    errs = {"tool": float(err.max())}
    n16 = n // 4
    r16, i16 = rows[:n16].to(torch.bfloat16), idx[:n16].contiguous()
    out16 = sr.scatter_add_rows(i16, r16, s)
    if out16.dtype != torch.bfloat16 or not torch.equal(
            out16, sr.scatter_add_rows_plain(i16, r16, s)):
        raise AssertionError("scatter_add_rows bf16: not bitwise equal")
    errs["bf16"] = 0.0
    wild = torch.randint(-50, 2050, (300_000,), generator=gen, device=dev,
                         dtype=torch.int32)
    upd = torch.randn(300_000, 40, generator=gen, device=dev)
    got = sr.scatter_add_rows(wild, upd, 2000)
    ref = sr.scatter_add_rows_plain(wild, upd, 2000)
    big = sr.scatter_add_rows_plain(wild, upd.abs(), 2000)
    if not bool(((got - ref).abs() <= 1e-5 * big + 1e-6).all()):
        raise AssertionError("scatter_add_rows dropped ids: differs")
    errs["dropped_ids"] = float((got - ref).abs().max())
    for name, e in errs.items():
        print(f"scatter_add_rows {name}: max_abs_err {e:.3e}", flush=True)
    ms = cuda_time_ms(lambda: sr.scatter_add_rows(idx, rows, s), iters=10)
    plain_ms = cuda_time_ms(lambda: sr.scatter_add_rows_plain(idx, rows, s),
                            iters=10)
    buf = torch.zeros(s, 128, device=dev)
    library_ms = cuda_time_ms(lambda: buf.index_add_(0, idx, rows), iters=10)
    bf16_ms = cuda_time_ms(lambda: sr.scatter_add_rows(i16, r16, s),
                           iters=10)
    order, seg_start = sr.segment_order(idx[None], s)
    prep_ms = cuda_time_ms(lambda: sr.segment_order(idx[None], s))
    sum_ms = cuda_time_ms(lambda: sr.segment_sum(rows[None], order,
                                                 seg_start, s))
    # one fp32 add per element
    nbytes = scatter_bytes(n, s)
    bound_ms, bound_by = bound_of(nbytes, n * 128)
    print(f"scatter_add_rows tool: [{n}, 128] fp32 -> [{s}, 128]; {ms:.4f} ms"
          f" (sort + segment search {prep_ms:.4f} ms, segment sum "
          f"{sum_ms:.4f} ms; bound {bound_ms:.4f} ms, {nbytes} B), plain "
          f"{plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms; bf16 "
          f"[{n16}, 128] {bf16_ms:.4f} ms", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                prep_ms=prep_ms, segment_sum_ms=sum_ms, bf16_ms=bf16_ms,
                max_abs_err=max(errs.values()), edge_max_abs_err=errs)


# gradients held card vs CPU: downstream of the BEV encoder (fp32 noise
# near 1e-4) and upstream of it (training-mode BatchNorm over the tiny
# maps puts the fp32 noise near 1% of the norm)
TINY_DISTILL_GRADS = {
    "distiller.channel_wise_adaptations.0.conv.weight": 1e-2,
    "pts_bbox_head.task_heads.3.heatmap.1.weight": 1e-2,
    "img_bev_encoder_neck.up2.4.weight": 1e-2,
    "img_bev_encoder_backbone.layers.2.1.conv2.weight": 5e-2,
    "img_view_transformer.depthnet.weight": 5e-2,
    "img_backbone.conv1.weight": 5e-2,
}


class GradProbe:
    """The optimizer interface of ``make_distill_train_step`` that keeps
    the gradients and updates nothing."""

    def __init__(self, model):
        self.model, self.grads = model, {}

    def zero_grad(self):
        self.model.zero_grad(set_to_none=True)

    def step(self, step):
        named = dict(self.model.named_parameters())
        self.grads = {n: named[n].grad.detach().cpu()
                      for n in TINY_DISTILL_GRADS}
        return named[next(iter(named))].grad.new_zeros(())


def to_device(batch, device):
    """A DistillBatch (with its ImgInputs) on ``device``."""
    img = type(batch.img_inputs)(*[None if a is None else a.to(device)
                                   for a in batch.img_inputs])
    return type(batch)(img, *[a.to(device) for a in batch[1:]])


def check_tiny_distill_against_cpu(seed: int):
    """The tiny distill step's losses and gradients on the card against
    the same weights on the CPU (whose path the CPU tests hold against
    the JAX package)."""
    import copy
    import torch
    from distillbev_tpu_torch.apis.flagship import build_flagship
    from distillbev_tpu_torch.training import make_distill_train_step

    cpu_student, cpu_teacher, cpu_batch = build_flagship(tiny=True,
                                                         seed=seed,
                                                         device="cpu")
    gpu_student = copy.deepcopy(cpu_student).cuda()
    gpu_teacher = copy.deepcopy(cpu_teacher).cuda()
    results = []
    for student, teacher, batch in (
            (cpu_student, cpu_teacher, cpu_batch),
            (gpu_student, gpu_teacher, to_device(cpu_batch, "cuda"))):
        probe = GradProbe(student)
        metrics = make_distill_train_step(student, teacher, probe)(batch, 0)
        results.append(({k: float(v) for k, v in metrics.items()
                         if k != "grad_norm"}, probe.grads))
    (ref, ref_g), (got, got_g) = results
    worst_loss = max(abs(got[k] - v) / max(abs(v), 1e-6)
                     for k, v in ref.items())
    if set(got) != set(ref) or worst_loss > 1e-3:
        raise AssertionError(f"tiny distill losses: rel err {worst_loss}")
    grad_err = {n: float((got_g[n] - ref_g[n]).norm() / ref_g[n].norm())
                for n in TINY_DISTILL_GRADS}
    bad = {n: e for n, e in grad_err.items() if e > TINY_DISTILL_GRADS[n]}
    if bad:
        raise AssertionError(f"tiny distill grads: {bad}")
    print(f"tiny distill step cuda vs cpu: {len(ref)} losses, max rel err "
          f"{worst_loss:.3e}; grads (norm-relative) {grad_err}", flush=True)
    return dict(loss_max_rel_err=worst_loss, grad_norm_rel_err=grad_err)


def train_distill(student, teacher, batch, counters):
    """N_TRAIN_STEPS of the flagship distill step with the bench's
    optimizer; launch counts set to 0 just before and read just after.
    Returns the per-step metrics, wall times, peak memory, launches and
    the profile of one more step."""
    import torch
    from distillbev_tpu_torch.training import make_distill_train_step
    from distillbev_tpu_torch.training.optim import build_optimizer
    from distillbev_tpu_torch.training.schedules import build_lr_schedule

    lr = build_lr_schedule(dict(policy="step", step=[16, 22]), 2e-4,
                           total_steps=10000, steps_per_epoch=1000)
    opt = build_optimizer(dict(type="AdamW", lr=2e-4, weight_decay=1e-2),
                          lr, student, grad_clip=dict(max_norm=5))
    step_fn = make_distill_train_step(student, teacher, opt)
    walls, metrics = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    for step in range(N_TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step_fn(batch, step)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: float(v) for k, v in m.items()})
        print(f"distill step {step}: {walls[-1]:.1f} ms, total_loss "
              f"{metrics[-1]['total_loss']:.4f}, grad_norm "
              f"{metrics[-1]['grad_norm']:.4f}", flush=True)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    prof = profiled(lambda: step_fn(batch, N_TRAIN_STEPS))
    bad = [(i, k) for i, m in enumerate(metrics) for k, v in m.items()
           if not np.isfinite(v)]
    if bad or any(len(m) != 19 for m in metrics):
        raise AssertionError(f"distill metrics: non-finite {bad} or "
                             f"{[len(m) for m in metrics]} keys")
    return dict(metrics=metrics, step_ms=walls, peak_mem_bytes=peak,
                launches=launches, profile=prof)


def distill_path(ids_main, size_main, seed, gen, counters):
    """Phase 5: the row gather at its real shapes, the tiny distill step
    card vs CPU, then the full-width flagship distill steps."""
    import torch
    from distillbev_tpu_torch.apis.flagship import build_flagship

    gather_shapes = check_gather_rows(ids_main, size_main, 64, gen)
    torch.cuda.empty_cache()
    tiny = check_tiny_distill_against_cpu(seed)
    t0 = time.perf_counter()
    student, teacher, batch = build_flagship(seed=seed, device="cuda")
    n_params = sum(p.numel() for p in student.parameters())
    print(f"flagship distill: student {n_params} parameters, teacher "
          f"{sum(p.numel() for p in teacher.parameters())}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    train = train_distill(student, teacher, batch, counters)
    want = {name: 0 for name in counters}
    want["scatter_add_rows_batched"] = \
        SPLAT_LAUNCHES_PER_DISTILL_STEP * N_TRAIN_STEPS
    want["gather_rows"] = GATHER_LAUNCHES_PER_DISTILL_STEP * N_TRAIN_STEPS
    if train["launches"] != want:
        raise AssertionError(f"distill launches {train['launches']}, "
                             f"expected {want}")
    del student, teacher, batch
    torch.cuda.empty_cache()
    return gather_shapes, tiny, train


def tool_path(counters):
    """Phase 6: the microbench tool at its defaults, with the launch
    counts set to 0 just before and read just after."""
    import torch
    from distillbev_tpu_torch.tools import bench_gather

    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    rows = bench_gather.main(TOOL_N, TOOL_S, iters=TOOL_ITERS)
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: 0 for name in counters}
    want["gather_rows"] = want["scatter_add_rows"] = TOOL_ITERS + 1
    if launches != want:
        raise AssertionError(f"tool launches {launches}, expected {want}")
    torch.cuda.empty_cache()
    return dict(rows=rows, launches=launches)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distillbev_tpu_torch.apis.flagship import (build_bevformer,
                                                    build_flagship_student)
    from distillbev_tpu_torch.ops import cuda_build, gather_rows
    from distillbev_tpu_torch.ops import scatter_rows as sr
    from distillbev_tpu_torch.ops import segmented_scan as ss

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)

    # phase 1: build every kernel source together
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(cuda_build.build, sources))
    print(f"built {sources} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in sources:
        cuda_build.load(name)
        log_path = cuda_build.BUILD_DIR / f"{name}.log"
        if log_path.exists():
            for line in log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}", flush=True)

    # TF32 off: fp32 convolutions and matmuls in full fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} "
          f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)

    seed = 0
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scan_edge_errs = check_scan_edge_cases(gen)
    t0 = time.perf_counter()
    model, batch = build_flagship_student(tiny=False, seed=seed,
                                          device="cuda")
    # mmcv zero-initialises the DCN offset conv; a small random one makes
    # the deformable conv sample off the grid
    cpu_gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "conv_offset"):
                m.conv_offset.weight.copy_(0.01 * torch.randn(
                    m.conv_offset.weight.shape, generator=cpu_gen))
                m.conv_offset.bias.copy_(0.1 * torch.randn(
                    m.conv_offset.bias.shape, generator=cpu_gen))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"flagship BEVDepth4D-R50: {n_params} parameters, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # phase 2: serve path -- the splat kernel, then the requests
    with torch.inference_mode():
        ids_main, size_main = splat_ids(model, batch)
    kernels = [check_scatter_rows(ids_main, size_main,
                                  model.img_view_transformer.numC_Trans,
                                  gen)]
    counters = {"scatter_add_rows_batched": sr.scatter_add_rows_batched,
                "scatter_add_rows_expand": sr.scatter_add_rows_expand,
                "segmented_cumsum_rows": ss.segmented_cumsum_rows,
                "scatter_add_rows": sr.scatter_add_rows,
                "gather_rows": gather_rows}
    tiny_err = check_tiny_against_cpu(seed)
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    latencies = serve(model, seed)
    serve_peak = torch.cuda.max_memory_allocated()
    serve_launches = {name: fn.launches for name, fn in counters.items()}
    if serve_launches != {**{name: 0 for name in counters},
                          "scatter_add_rows_batched": 2 * N_REQUESTS}:
        raise AssertionError(f"serve launches {serve_launches}, expected "
                             f"{2 * N_REQUESTS} splats")
    kernels[0]["launches"] = serve_launches["scatter_add_rows_batched"]
    serve_prof = profile_request(model, seed + N_REQUESTS)
    nx_main = int(model.img_view_transformer.geo.nx[0])
    del model, batch
    torch.cuda.empty_cache()

    # phase 3: train path -- the dvalue kernel, then BEVFormer-R50 steps
    t0 = time.perf_counter()
    model, batch = build_bevformer(tiny=False, seed=seed, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"BEVFormer-R50: {n_params} parameters ({n_train} trained), "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    kernels.append(check_scatter_expand(msda_calls(model, batch), gen))
    torch.cuda.empty_cache()
    tiny_bf_err = check_tiny_bevformer_against_cpu(seed)
    train = train_bevformer(model, batch, seed, counters)
    want = {**{name: 0 for name in counters},
            "scatter_add_rows_expand": EXPAND_LAUNCHES_PER_STEP *
            N_TRAIN_STEPS}
    if train["launches"] != want:
        raise AssertionError(f"train launches {train['launches']}, "
                             f"expected {want}")
    kernels[1]["launches"] = train["launches"]["scatter_add_rows_expand"]
    test_ms = test_frame_requests(model, batch)
    del model, batch
    torch.cuda.empty_cache()

    # phase 4: teacher path -- the scan kernel, then the LiDAR teachers
    teacher, scan_shapes, teacher_info = teacher_path(
        ids_main, size_main, nx_main, seed, gen, counters)
    main_shape = scan_shapes["vfe_mean"]
    kernels.append(dict(
        name="segmented_cumsum_rows", route="cuda",
        source="distillbev_tpu_torch/csrc/segmented_scan.cu",
        replaces="distillbev_tpu/ops/pallas_segmented.py:79",
        launches=teacher["dynamic"]["launches"]["segmented_cumsum_rows"],
        max_abs_err=max(v["max_abs_err"] for v in scan_shapes.values()),
        ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
        bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
        library_ms=None, library_note="no single PyTorch call computes a "
        "segmented scan; index_add_ of the segment sums it feeds is in "
        "shapes", timed_shape="vfe_mean", shapes=scan_shapes,
        edge_max_abs_err=scan_edge_errs))

    # phase 5: distill path -- the row gather, then the flagship step
    gather_shapes, tiny_distill, distill = distill_path(
        ids_main, size_main, seed, gen, counters)
    kernels[0]["launches_distill"] = \
        distill["launches"]["scatter_add_rows_batched"]
    gather_main = gather_shapes["splat_backward"]
    gather_kernel = dict(
        name="gather_rows", route="cuda",
        source="distillbev_tpu_torch/csrc/gather_rows.cu",
        replaces="tools/analysis_tools/bench_pallas_gather.py:44",
        launches=distill["launches"]["gather_rows"],
        max_abs_err=gather_main["max_abs_err"], ms=gather_main["ms"],
        plain_ms=gather_main["plain_ms"], bound_ms=gather_main["bound_ms"],
        bound_by=gather_main["bound_by"],
        library_ms=gather_main["library_ms"],
        timed_shape="splat_backward", shapes=gather_shapes)
    kernels.append(gather_kernel)

    # phase 6: the microbench tool -- the ordered scatter, then the tool
    scatter = check_scatter_add_rows(gen)
    tool = tool_path(counters)
    for replaces in ("distillbev_tpu/ops/pallas_scatter.py:220",
                     "tools/analysis_tools/bench_pallas_gather.py:78"):
        kernels.append(dict(
            name="scatter_add_rows", route="cuda",
            source="distillbev_tpu_torch/csrc/scatter_rows.cu",
            replaces=replaces,
            launches=tool["launches"]["scatter_add_rows"],
            max_abs_err=scatter["max_abs_err"], ms=scatter["ms"],
            plain_ms=scatter["plain_ms"], bound_ms=scatter["bound_ms"],
            bound_by=scatter["bound_by"], library_ms=scatter["library_ms"],
            timed_shape="tool fp32", detail=scatter))
    gather_kernel["launches_tool"] = tool["launches"]["gather_rows"]

    print(json.dumps({"profile": serve_prof}), flush=True)
    print(json.dumps({"serve": {
        "model": "BEVDepth4D-R50 flagship, fp32, batch 1",
        "requests": N_REQUESTS, "latency_ms": latencies,
        "tiny_cuda_vs_cpu_max_abs_err": tiny_err,
        "serve_peak_mem_bytes": serve_peak}}), flush=True)
    print(json.dumps({"train_profile": train.pop("profile")}), flush=True)
    print(json.dumps({"train": {
        "model": "BEVFormer-R50, 6 x 928x1600, queue 4, fp32, batch 1",
        "steps": N_TRAIN_STEPS, **train,
        "tiny_cuda_vs_cpu_max_abs_err": tiny_bf_err,
        "test_frame_ms": test_ms}}), flush=True)
    print(json.dumps({"teacher_profile": {
        kind: teacher[kind].pop("profile") for kind in teacher}}),
        flush=True)
    print(json.dumps({"teacher": {
        "model": "CenterPoint-pillar and DynamicCenterPoint, 300,000 "
                 "points, 512x512 pillars, fp32, batch 1",
        "requests": N_REQUESTS, **teacher, **teacher_info}}), flush=True)
    print(json.dumps({"distill_profile": distill.pop("profile")}),
          flush=True)
    print(json.dumps({"distill": {
        "model": "CenterPoint-pillar -> BEVDepth4D-R50 FGD, 6 x 2 x "
                 "256x704, 300,000 points, fp32, batch 1",
        "steps": N_TRAIN_STEPS, **distill, "tiny_cuda_vs_cpu": tiny_distill}}),
        flush=True)
    print(json.dumps({"tool": tool}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
