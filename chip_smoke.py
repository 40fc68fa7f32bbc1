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
   test-frame request through ``forward_test_frame`` + ``get_bboxes``.

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
    bound_ms = max(nbytes / HBM_BYTES_PER_S, n_valid * width / FP32_FLOPS
                   ) * 1e3
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
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes"
                if nbytes / HBM_BYTES_PER_S >= n_valid * width / FP32_FLOPS
                else "operations", library_ms=library_ms,
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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return dict(bound_ms=1e3 * max(t_bytes, t_ops), bound_by="bytes"
                if t_bytes >= t_ops else "operations", bytes=nbytes,
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distillbev_tpu_torch.apis.flagship import (build_bevformer,
                                                    build_flagship_student)
    from distillbev_tpu_torch.ops import cuda_build
    from distillbev_tpu_torch.ops import scatter_rows as sr

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
                "scatter_add_rows_expand": sr.scatter_add_rows_expand}
    tiny_err = check_tiny_against_cpu(seed)
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    latencies = serve(model, seed)
    serve_peak = torch.cuda.max_memory_allocated()
    serve_launches = {name: fn.launches for name, fn in counters.items()}
    if serve_launches != {"scatter_add_rows_batched": 2 * N_REQUESTS,
                          "scatter_add_rows_expand": 0}:
        raise AssertionError(f"serve launches {serve_launches}, expected "
                             f"{2 * N_REQUESTS} splats")
    kernels[0]["launches"] = serve_launches["scatter_add_rows_batched"]
    serve_prof = profile_request(model, seed + N_REQUESTS)
    del model, batch, ids_main
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
    want = {"scatter_add_rows_batched": 0,
            "scatter_add_rows_expand": EXPAND_LAUNCHES_PER_STEP *
            N_TRAIN_STEPS}
    if train["launches"] != want:
        raise AssertionError(f"train launches {train['launches']}, "
                             f"expected {want}")
    kernels[1]["launches"] = train["launches"]["scatter_add_rows_expand"]
    test_ms = test_frame_requests(model, batch)

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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
