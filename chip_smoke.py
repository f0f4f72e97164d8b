#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--profile]

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA.  It:

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and the TF32 flags, and turns TF32 off for the whole run;
2. builds every CUDA kernel of the package from ``mxnet_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the build time;
3. kernel phase: holds each kernel against its plain PyTorch version on the
   card at the shapes the serving path gives it (plus an NHWC, a bfloat16,
   a ragged and an unaligned case) and times kernel, plain version and the
   memory-bandwidth bound with CUDA events (L2 flushed between launches);
4. serving phase: builds ResNet-50 v1 (224x224x3, 1000 classes, float32,
   random weights from ``--seed``) on ``mx.gpu(0)``, serves it through
   ``serve.InferenceServer`` with buckets (1, 2, 4, 8), submits the
   requests in bursts of 1, 2, 3, 5 and 8, and checks every result
   against a direct batch-1 forward, zero dispatch errors, no quarantine,
   zero steady-state recompiles and 16 kernel launches per dispatch;
5. prints one JSON line describing each kernel, then as its last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero without the ``ok``
line.  Without a CUDA device, or without the package beside it, it exits
non-zero before printing anything on standard output.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# ResNet-50's BN -> add -> ReLU epilogues at serving bucket 8, NCHW:
# (shape, launches per forward) for stages 1-4
EPILOGUE_SHAPES = [((8, 256, 56, 56), 3), ((8, 512, 28, 28), 4),
                   ((8, 1024, 14, 14), 6), ((8, 2048, 7, 7), 3)]
BUCKETS = (1, 2, 4, 8)
BURSTS = (1, 2, 3, 5, 8)
N_REQUESTS = 64
TIMED_ITERS = 30
WARMUP_ITERS = 5
L2_FLUSH_BYTES = 128 << 20          # more than twice the H100's 50 MB L2
SPIN_CYCLES = 100_000_000           # about 50 ms at the H100's clock


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    """``name, power.limit`` of the card as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def memory_bytes_per_s(name):
    """Published device-memory rate of the card (NVIDIA data sheets)."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    if "H200" in name:
        return 4.8e12
    return 3.35e12                    # H100 SXM (HBM3)


def fp32_ops_per_s(name):
    """Published fp32 rate outside the tensor cores."""
    return 51e12 if "PCIe" in name else 67e12


def time_cuda(torch, fn, flush):
    """Median device milliseconds of ``fn()`` over TIMED_ITERS launches,
    each between its own CUDA events and preceded by an L2 flush.  The flush
    READS a buffer larger than L2, so the kernel finds clean lines (a
    zero-fill would leave dirty lines whose write-back the kernel would
    pay).  A spin kernel holds the card while the host enqueues every
    launch, so the events time the device work and not the host's launch
    overhead."""
    for _ in range(WARMUP_ITERS):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_ITERS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_ITERS)]
    torch.cuda._sleep(SPIN_CYCLES)
    for s, e in zip(starts, ends):
        flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def host_us(torch, fn):
    """Host microseconds per call of ``fn()`` (launch overhead: wrapper
    checks, allocation, the launch itself), with the card kept busy."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(TIMED_ITERS):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / TIMED_ITERS * 1e6


def kernel_phase(torch, fused_norm, card, flush):
    """Kernel against plain version, timings and bounds.  Launches made
    here are comparisons, not the main path: the caller resets the count
    afterwards."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    bw = memory_bytes_per_s(card)
    peak = fp32_ops_per_s(card)
    kernel = fused_norm.fused_bn_add_relu_epilogue
    plain = fused_norm.fused_bn_add_relu_epilogue_plain
    cases = [("nchw", shape, 1, torch.float32, 0, n)
             for shape, n in EPILOGUE_SHAPES]
    cases += [("nhwc", (8, 28, 28, 512), 3, torch.float32, 0, 0),
              ("bf16", (8, 256, 56, 56), 1, torch.bfloat16, 0, 0),
              ("ragged", (3, 7, 13, 11), 1, torch.float32, 0, 0),
              ("unaligned", (2, 64, 7, 7), 1, torch.float32, 1, 0)]
    rows = []
    for kind, shape, axis, dtype, offset, per_forward in cases:
        n = 1
        for d in shape:
            n *= d
        c = shape[axis]
        x = torch.randn(n + offset, device=dev, generator=gen)
        r = torch.randn(n + offset, device=dev, generator=gen)
        x = x.to(dtype)[offset:].view(shape)
        r = r.to(dtype)[offset:].view(shape)
        s = torch.rand(c, device=dev, generator=gen) + 0.5
        t = torch.randn(c, device=dev, generator=gen) * 0.1
        with torch.inference_mode():
            y = kernel(x, s, t, r, axis)
            want = plain(x, s, t, r, axis)
            torch.cuda.synchronize()
            check(y.shape == want.shape and y.dtype == want.dtype,
                  "%s: kernel gave %s %s" % (kind, y.shape, y.dtype))
            err = (y.float() - want.float()).abs().max().item()
            if dtype == torch.float32:
                tol = 1e-6 * want.abs().max().item()
                check(err <= tol, "%s %s: max|kernel-plain| %.3g > %.3g"
                      % (kind, shape, err, tol))
            else:
                ulps = (y.view(torch.int16).int()
                        - want.view(torch.int16).int()).abs().max().item()
                check(ulps <= 1, "%s %s: kernel is %d bf16 ulps from plain"
                      % (kind, shape, ulps))
            ms = time_cuda(torch, lambda: kernel(x, s, t, r, axis), flush)
            plain_ms = time_cuda(torch, lambda: plain(x, s, t, r, axis), flush)
            k_host = host_us(torch, lambda: kernel(x, s, t, r, axis))
            p_host = host_us(torch, lambda: plain(x, s, t, r, axis))
        nbytes = 3 * n * x.element_size() + 2 * c * 4
        bound_ms = max(nbytes / bw, 4 * n / peak) * 1e3
        rows.append({"case": kind, "shape": list(shape), "dtype":
                     str(dtype).replace("torch.", ""), "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bytes": nbytes, "launches_per_forward": per_forward,
                     "host_us": k_host, "plain_host_us": p_host})
        print("kernel %-9s %-20s %-8s err %.3g  kernel %.4f ms  plain %.4f ms"
              "  bound %.4f ms  host/call kernel %.1f us plain %.1f us  (%s)"
              % (kind, shape, rows[-1]["dtype"], err, ms, plain_ms, bound_ms,
                 k_host, p_host, card))
    return rows


def profile_calls(torch, model, x, bucket, calls=5):
    """torch.profiler over ``calls`` model calls of one bucket: the wall
    time per call, the device's busy time per call (kernel time summed)
    and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile
    model.run(bucket, x).cpu()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            model.run(bucket, x).cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    avgs = prof.key_averages()
    key = "self_device_time_total" if hasattr(avgs[0], "self_device_time_total") \
        else "self_cuda_time_total"
    device = [a for a in avgs if getattr(a, key) > 0
              and getattr(a, "device_type", None) is not None
              and "CUDA" in str(a.device_type)]
    busy_ms = sum(getattr(a, key) for a in device) / 1e3 / calls
    top = sorted(device, key=lambda a: -getattr(a, key))[:12]
    return {"bucket": bucket, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top": [(a.key[:60], getattr(a, key) / 1e3 / calls, a.count // calls)
                    for a in top]}


def serving_phase(torch, mx, fused_norm, seed, n_requests, profile=False):
    """ResNet-50 v1 served through InferenceServer; returns the numbers."""
    import numpy as onp
    from mxnet_tpu_torch import serve, telemetry
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    mx.random.seed(seed)
    net = resnet50_v1()
    net.initialize(ctx=mx.gpu(0))
    srv = serve.InferenceServer(
        net, feature_shape=(3, 224, 224),
        config=serve.ServeConfig(buckets=BUCKETS, max_queue=64),
        name="resnet50_v1")
    rng = onp.random.RandomState(seed)
    inputs = rng.uniform(-1, 1, (n_requests, 3, 224, 224)).astype("float32")
    t0 = time.perf_counter()
    srv.start()
    start_s = time.perf_counter() - t0
    check(srv.state() == serve.READY, "server not READY after start")
    errors0 = telemetry.counter("serve.dispatch_errors")
    dispatch0 = {b: telemetry.counter("serve.dispatches.b%d" % b)
                 for b in BUCKETS}
    handles = []
    try:
        # the main path: counts from 0 just before, read just after
        fused_norm.LAUNCHES = 0
        i = burst = 0
        while i < n_requests:
            size = min(BURSTS[burst % len(BURSTS)], n_requests - i)
            group = [srv.submit(inputs[j]) for j in range(i, i + size)]
            for h in group:
                h.outcome(timeout=30.0)
            handles += group
            i += size
            burst += 1
        launches = fused_norm.LAUNCHES
        dispatches = {b: telemetry.counter("serve.dispatches.b%d" % b)
                      - dispatch0[b] for b in BUCKETS}
        outs = [h.outcome(timeout=0) for h in handles]
        check(all(o is not None and o[0] == "result" for o in outs),
              "not every request resolved to a result: %r"
              % sorted({(o or ("pending",))[0] for o in outs}))
        check(telemetry.counter("serve.dispatch_errors") == errors0,
              "dispatch errors during serving")
        check(srv.stats()["quarantined"] == [], "a bucket was quarantined")
        check(srv.steady_state_recompiles() == {},
              "steady-state recompiles: %r" % srv.steady_state_recompiles())
        n_dispatch = sum(dispatches.values())
        check(all(dispatches[b] > 0 for b in BUCKETS),
              "not every bucket dispatched: %r" % dispatches)
        check(launches == 16 * n_dispatch,
              "%d kernel launches for %d dispatches (want 16 each)"
              % (launches, n_dispatch))
        first = [round(h.latency_ms(), 3) for h in handles[:6]]
        lat = sorted(h.latency_ms() for h in handles)
        # the model call per bucket, host batch in, host logits out
        call_ms = {}
        for b in BUCKETS:
            times = []
            for _ in range(12):
                t = time.perf_counter()
                srv._model.run(b, inputs[:b]).cpu()
                times.append(time.perf_counter() - t)
            call_ms[b] = statistics.median(times[2:]) * 1e3
        b8_ms = call_ms[8]
        profiles = [profile_calls(torch, srv._model, inputs[:b], b)
                    for b in (1, 8)] if profile else []
    finally:
        srv.close()
    # every result against a direct batch-1 forward of the same net
    worst = 0.0
    with torch.inference_mode(), mx.autograd.predict_mode():
        for j, o in enumerate(outs):
            ref = net(mx.nd.array(inputs[j:j + 1], ctx=mx.gpu(0))).asnumpy()[0]
            check(o[1].shape == (1000,) and onp.isfinite(o[1]).all(),
                  "request %d: bad logits" % j)
            rel = float(onp.abs(o[1] - ref).max() / onp.abs(ref).max())
            worst = max(worst, rel)
    check(worst <= 1e-4, "served logits differ from batch-1 forward: rel %.3g"
          % worst)
    return {"start_s": start_s, "launches": launches,
            "dispatches": dispatches, "p50_ms": float(onp.percentile(lat, 50)),
            "p99_ms": float(onp.percentile(lat, 99)),
            "bucket8_ms": b8_ms, "bucket8_images_per_s": 8e3 / b8_ms,
            "call_ms": call_ms, "first_latencies_ms": first,
            "profiles": profiles,
            "max_rel_err": worst, "requests": len(handles)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace bucket-1 and bucket-8 model calls with "
                         "torch.profiler and print where the device time goes")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import fused_norm

    card = card_line()
    print("card: %s" % card)
    print("torch %s, CUDA %s, %d device(s)" % (
        torch.__version__, torch.version.cuda, torch.cuda.device_count()))
    print("TF32 before: cudnn.allow_tf32=%s cuda.matmul.allow_tf32=%s" % (
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 set off for the whole run")

    t0 = time.perf_counter()
    kernels.build(kernels.SOURCES)
    build_s = time.perf_counter() - t0
    for name in kernels.SOURCES:
        kernels.load(name)
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas %s: %s" % (name, line.strip()))
    print("kernels built in %.2f s: %s" % (build_s, ", ".join(kernels.SOURCES)))

    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    rows = kernel_phase(torch, fused_norm, card, flush)
    del flush
    torch.cuda.empty_cache()

    res = serving_phase(torch, mx, fused_norm, args.seed, N_REQUESTS,
                        profile=args.profile)
    print("serving: %d requests, start %.2f s, dispatches per bucket %s, "
          "kernel launches %d, max rel err vs batch-1 %.3g"
          % (res["requests"], res["start_s"], res["dispatches"],
             res["launches"], res["max_rel_err"]))
    print("serving: request latency p50 %.3f ms p99 %.3f ms; bucket-8 model "
          "call %.3f ms = %.1f images/s (%s)"
          % (res["p50_ms"], res["p99_ms"], res["bucket8_ms"],
             res["bucket8_images_per_s"], card))
    print("serving: model call ms per bucket %s; first latencies ms %s"
          % ({b: round(v, 3) for b, v in res["call_ms"].items()},
             res["first_latencies_ms"]))
    for p in res["profiles"]:
        print("profile bucket %d: wall %.3f ms/call, device busy %.3f ms/call, "
              "idle share %.3f (%s)" % (p["bucket"], p["wall_ms"],
                                        p["device_busy_ms"],
                                        p["device_idle_share"], card))
        for name, ms, n in p["top"]:
            print("  %-60s %8.3f ms/call  %3d launches/call" % (name, ms, n))

    def per_fwd(key):
        return sum(r[key] * r["launches_per_forward"] for r in rows)

    entry = {
        "name": "fused_bn_add_relu_epilogue",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/fused_norm.cu",
        "replaces": "mxnet_tpu/ops/pallas_fused_norm.py:45",
        "launches": res["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_fwd("ms"),
        "plain_ms": per_fwd("plain_ms"),
        "bound_ms": per_fwd("bound_ms"),
        "bound_by": "bytes",
        "library_ms": None,
        "per": "one bucket-8 ResNet-50 forward: 16 launches at the shapes "
               "below; library: no single PyTorch call computes it",
        "shapes": rows,
    }
    print(card)                       # as nvidia-smi prints it
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
