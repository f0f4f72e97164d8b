#!/usr/bin/env python3
"""Diagnostics of the PyTorch/CUDA port on one NVIDIA GPU, beside
``chip_smoke.py``.

    python3 chip_diag.py parity [--seed 0]
    python3 chip_diag.py ab --parent DIR [--pairs 2]

``parity``: the gradients of one batch-2 ResNet-50 v1 training step from
the same Xavier weights (those of ``chip_smoke.py``'s training phase),
computed four ways: on the card with the port's kernels, on the card with
the kernels' plain versions, on the CPU with its default threads and on
the CPU with one thread.  It prints the relative L2 error of each pair
(over all parameters, the worst by kind of parameter and the worst four),
so that the card's difference from the CPU can be set beside what the
order of summation alone does on the CPU.

``ab``: the serving path of another checkout (``--parent``, e.g. the
parent commit unpacked with ``git archive``) against this one, in turns
(parent, this, this, parent for ``--pairs 2``), each in its own process
on the same card: ``chip_smoke.py``'s serving phase (p50, p99, model call
ms per bucket), the host time to enqueue one bucket-8 forward and the
number of Python calls it makes.

Both need a CUDA card and exit non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _grad_errors(a, b):
    """Relative L2 error of gradients ``a`` against ``b``: over all
    parameters, the worst by kind (the last part of the name) and the
    worst four."""
    import numpy as onp
    errs, e2, r2 = [], 0.0, 0.0
    for k, ref in b.items():
        d = a[k] - ref
        e2 += float(onp.sum(d * d))
        r2 += float(onp.sum(ref * ref))
        errs.append((float(onp.linalg.norm(d))
                     / max(float(onp.linalg.norm(ref)), 1e-30), k))
    errs.sort(reverse=True)
    kinds = {}
    for e, k in errs:
        kind = k.rsplit(".", 1)[1]
        kinds[kind] = max(kinds.get(kind, 0.0), e)
    return (e2 / r2) ** 0.5, kinds, errs[:4]


def parity(seed):
    import numpy as onp
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, kernels
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.utils import load_jax_params
    from mxnet_tpu_torch.ops import fused_norm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build(kernels.SOURCES)
    size = (1, 3, cs.IMAGE_SIZE, cs.IMAGE_SIZE)
    mx.random.seed(seed)
    net = resnet50_v1()
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    with mx.autograd.predict_mode():
        net(mx.nd.zeros(size, ctx=mx.gpu(0)))
    rng = onp.random.RandomState(seed)
    data = rng.uniform(-1, 1, (cs.TRAIN_BATCH,) + size[1:]).astype("float32")
    label = rng.randint(0, 1000, cs.TRAIN_BATCH).astype("float32")
    w0 = {k: p.data().asnumpy()
          for k, p in net._collect_params_with_prefix().items()}
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    b = cs.PARITY_BATCH

    def grads(n, ctx):
        x = mx.nd.array(data[:b], ctx=ctx)
        y = mx.nd.array(label[:b], ctx=ctx)
        with mx.autograd.record():
            loss = loss_fn(n(x), y)
        loss.backward()
        return {k: p.grad().asnumpy().astype("float64")
                for k, p in n._collect_params_with_prefix().items()
                if p.grad_req != "null"}

    card = grads(net, mx.gpu(0))
    # the same step on the card through the plain versions: the Function
    # calls these module attributes
    fwd, bwd = fused_norm._fwd_kernel, fused_norm.fused_bn_add_relu_epilogue_bwd
    fused_norm._fwd_kernel = lambda d, s, t, r, C, trail: \
        fused_norm.fused_bn_add_relu_epilogue_plain(d, s, t, r, 1)
    fused_norm.fused_bn_add_relu_epilogue_bwd = \
        fused_norm.fused_bn_add_relu_epilogue_bwd_plain
    try:
        card_plain = grads(net, mx.gpu(0))
    finally:
        fused_norm._fwd_kernel = fwd
        fused_norm.fused_bn_add_relu_epilogue_bwd = bwd
    cpu_net = resnet50_v1()
    cpu_net.initialize(ctx=mx.cpu())
    with mx.autograd.predict_mode():
        cpu_net(mx.nd.zeros(size, ctx=mx.cpu()))
    load_jax_params(cpu_net, w0)
    threads = torch.get_num_threads()
    cpu = grads(cpu_net, mx.cpu())
    torch.set_num_threads(1)
    cpu1 = grads(cpu_net, mx.cpu())
    print("card: %s" % cs.card_line())
    for name, a, ref in (("card kernels vs CPU %d threads" % threads, card,
                          cpu),
                         ("card plain vs CPU %d threads" % threads,
                          card_plain, cpu),
                         ("card kernels vs card plain", card, card_plain),
                         ("CPU 1 thread vs CPU %d threads" % threads, cpu1,
                          cpu)):
        total, kinds, worst = _grad_errors(a, ref)
        print("%-32s all %.3g  worst by kind %s  worst %s" % (
            name, total, {k: float("%.3g" % v) for k, v in kinds.items()},
            ["%s %.3g" % (k, e) for e, k in worst]))
    return 0


_AB_CHILD = r'''
import cProfile, json, pstats, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
from mxnet_tpu_torch.ops import fused_norm
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
kernels.build(kernels.SOURCES)
res = cs.serving_phase(torch, mx, fused_norm, 0, cs.N_REQUESTS)
net = resnet50_v1()
net.initialize(ctx=mx.gpu(0))
x = mx.nd.zeros((8, 3, 224, 224), ctx=mx.gpu(0))
with torch.inference_mode(), mx.autograd.predict_mode():
    for _ in range(5):
        net(x).asnumpy()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        net(x)
    enqueue_ms = (time.perf_counter() - t) / 20 * 1e3
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    net(x)
    prof.disable()
    torch.cuda.synchronize()
calls = pstats.Stats(prof).total_calls
print("ABRESULT " + json.dumps(dict(
    p50_ms=res["p50_ms"], p99_ms=res["p99_ms"], call_ms=res["call_ms"],
    forward_enqueue_ms=enqueue_ms, forward_python_calls=calls)))
'''


def ab(parent, pairs):
    order = []
    for i in range(pairs):
        order += [("parent", parent), ("this", HERE)] if i % 2 == 0 else \
            [("this", HERE), ("parent", parent)]
    for name, root in order:
        proc = subprocess.run([sys.executable, "-c", _AB_CHILD], cwd=root,
                              capture_output=True, text=True, timeout=900)
        line = [l for l in proc.stdout.splitlines()
                if l.startswith("ABRESULT ")]
        if proc.returncode != 0 or not line:
            print("%s: failed (exit %d)\n%s" % (name, proc.returncode,
                                                proc.stderr[-3000:]))
            return 1
        print("%-6s %s" % (name, line[0][len("ABRESULT "):]), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("parity")
    p.add_argument("--seed", type=int, default=0)
    a = sub.add_parser("ab")
    a.add_argument("--parent", required=True)
    a.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_diag: no CUDA device", file=sys.stderr)
        return 2
    if args.cmd == "parity":
        return parity(args.seed)
    return ab(os.path.abspath(args.parent), args.pairs)


if __name__ == "__main__":
    sys.exit(main())
