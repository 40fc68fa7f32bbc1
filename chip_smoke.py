#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``distillbev_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a
CUDA device, ``nvcc`` and nothing else of the JAX package.  Phases:

1. print the card (``nvidia-smi``) and build every CUDA source of the
   port, all ``nvcc`` runs started together;
2. kernel phase: hold each kernel against its plain PyTorch version on
   the card at the main path's shapes and on edge cases, check that two
   launches agree bitwise, time the kernel, its plain version and the
   one-call PyTorch yardstick, and compute the kernel's bound;
3. serve phase: the flagship BEVDepth4D-R50 student at full width, fp32,
   batch 1, seeded random weights; the tiny student on the card against
   the same weights on the CPU; then ``run_eval`` over 3 synthetic
   requests with every kernel's launch count set to 0 just before and
   read just after.

Any fault raises and the script exits non-zero.  The last line is the
result: ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
N_REQUESTS = 3


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


def profile_request(model, seed: int):
    """One more request under torch.profiler, after the counted run:
    device time by kernel and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from distillbev_tpu_torch.apis.flagship import make_example_batch

    batch = make_example_batch(1, seed=seed, device="cuda")
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            preds, _, _ = model(batch)
            dec = model.get_bboxes(preds)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in kernels]
    dev_ms.sort(key=lambda t: -t[1])
    total = sum(t[1] for t in dev_ms)
    del dec
    return {"wall_ms": wall_ms, "device_ms": total,
            "busy_share": total / wall_ms, "n_kernels": sum(
                t[2] for t in dev_ms),
            "top": [[k[:90], round(ms, 4), n] for k, ms, n in dev_ms[:15]]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from distillbev_tpu_torch.apis.flagship import build_flagship_student
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

    # phase 2: kernels against their plain versions
    with torch.inference_mode():
        ids_main, size_main = splat_ids(model, batch)
    kernels = [check_scatter_rows(ids_main, size_main,
                                  model.img_view_transformer.numC_Trans,
                                  gen)]
    counters = {"scatter_add_rows_batched": sr.scatter_add_rows_batched}

    # phase 3: serving
    tiny_err = check_tiny_against_cpu(seed)
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    latencies = serve(model, seed)
    serve_peak = torch.cuda.max_memory_allocated()
    launches = {name: fn.launches for name, fn in counters.items()}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on the "
                                 f"main path")
    if launches["scatter_add_rows_batched"] != 2 * N_REQUESTS:
        raise AssertionError(f"splat launches {launches}, expected "
                             f"{2 * N_REQUESTS}")
    prof = profile_request(model, seed + N_REQUESTS)
    print(json.dumps({"profile": prof}), flush=True)
    print(json.dumps({"serve": {
        "model": "BEVDepth4D-R50 flagship, fp32, batch 1",
        "requests": N_REQUESTS, "latency_ms": latencies,
        "tiny_cuda_vs_cpu_max_abs_err": tiny_err,
        "serve_peak_mem_bytes": serve_peak}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
