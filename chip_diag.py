#!/usr/bin/env python3
"""Diagnostics of the PyTorch/CUDA port on one NVIDIA GPU, beside
``chip_smoke.py``.

    python3 chip_diag.py parity [--seed 0]
    python3 chip_diag.py ab --parent DIR [--pairs 2]
    python3 chip_diag.py bwd [--other FILE ...] [--pairs 2] [--skip-bf16]
    python3 chip_diag.py fwd [--other FILE ...] [--pairs 2] [--skip-bf16]
    python3 chip_diag.py bert32 [--other FILE ...]
    python3 chip_diag.py ln [--other FILE ...] [--pairs 2]
    python3 chip_diag.py f16 [--seeds 0 1 2]
    python3 chip_diag.py symgrad [--other FILE ...] [--seeds 0 1 2]

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

``bwd``: where the bf16 flash-attention backward spends its time, at
BERT-base's shape (24, 12, 512, 512, 64) with ``bench.py``'s valid lengths
and at (1, 12, 4096, 4096, 64): the device time of each of its kernels
(dQ, which also computes delta, and dK/dV) under torch.profiler, the mean
of 10 calls; then
the cycles a tile of each phase of the dK/dV kernel's loop, from
``clock64()`` counters that an instrumented copy of
``csrc/flash_attention.cu`` (built into the git-ignored ``_build/``)
sums over the blocks for warp 0 -- once as the kernel is, and once with
every tile sent through the general masked exponential loop (a mask test
an element), which the kernel keeps for causal and segment masks.  Then
the float32 backward (the three-TF32 kernels) of this checkout's source
and of each ``--other`` version, built side by side, through the port's
(B, T, H, D) wrapper at BERT-base's float32 layer (q, k and v views of
one projection output, ``bench.py``'s valid lengths) and at (2, 1024,
1024, 8, 128): each build's error against the plain version, whether it
gives this build's bits, its ms in turns and its device ms a call by
kernel under torch.profiler.  ``--skip-bf16`` runs the float32 part
alone.

``fwd``: the bf16 flash-attention forward of this checkout's
``csrc/flash_attention.cu`` beside other versions of it (``--other``,
given once for each: e.g. the parent commit's file, or a copy with
another tiling of the forward kernel), all built side by side and called
through their C entries on the same operands: at BERT-base's (B, S, H, D)
views (q, k and v strided views of one (24, 512, 3 x 768) projection
output, ``bench.py``'s valid lengths), at its (B, H, T, D) shape (24, 12,
512, 512, 64) and at (1, 12, 2048, 2048, 64).  It prints each build's
error against the plain version, whether each ``--other`` gives the same
bits as this one, each build's forward registers, and their times in
turns (each build in order, then in reverse, for ``--pairs 2``) as
``chip_smoke.py`` times a kernel.  Then the float32 forward of each
build at the float32 cases of ``bwd`` (``--skip-bf16``: these alone).

``bert32``: ``chip_smoke.py``'s float32 BERT-base phase (the hybridized
MLM forward and the ``DataParallelStep`` Adam step at 24 x 512, graphed
against eager, with ``--profile``'s breakdown and the float32 attention
kernels' share of the device time) once with this checkout's
``csrc/flash_attention.cu`` and once with each ``--other`` version (e.g.
the parent commit's: the C entries must match), so that the step's
change is measured beside the kernels'.

``ln``: the bf16 LayerNorm backward at (12288, 768) and (1824, 768) --
BERT-base's rows and its masked-LM head's -- of this checkout's
``csrc/layernorm.cu`` and, with ``--other``, other versions of it (e.g.
the parent commit's), built side by side and called through their C
entry on the same operands: whether they give the same bits, their times
in turns (events, L2 flushed), and each build's device time by kernel
under torch.profiler (the rows kernel and the column fold separately; a
kernel launched as a programmatic dependent counts the time it waits for
the one before it), beside the bytes bound.

``f16``: the readings behind ``chip_smoke.py``'s float16 card-against-CPU
tolerances, for each seed: the narrow ResNetV1's and the 2-layer BERT's
logits, losses and update errors (``f16_resnet_card_vs_cpu``,
``f16_bert_card_vs_cpu``), the CPU's float16 step against its float32
step beside the ResNet's.  It prints them and holds nothing.

``symgrad``: the readings behind ``chip_smoke.py``'s symbolic BERT
card-against-CPU limits (``sym_bert_card_vs_cpu``: the 2-layer encoder's
probabilities and gradients), for each seed, with this checkout's
``csrc/flash_attention.cu`` and with each ``--other`` version (e.g. a
copy whose float32 kernels take one TF32 product in place of three),
then with this checkout's kernels and cuBLAS's and cuDNN's products in
TF32.  It prints them and holds nothing.

All eight need a CUDA card and exit non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import re
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


# (anchor, replacement) edits that turn csrc/flash_attention.cu into the
# instrumented copy; each anchor must occur exactly once
_PHASES = ("wait for the tile", "S^T and refill (wait<1>)", "exponentials",
           "dP^T (wait<0>)", "dS^T, bf16 packing", "dV, dK (RS wgmma)",
           "release")
_INSTRUMENT = [
    ("namespace {\n\ntypedef __nv_bfloat16 bf16;",
     "__device__ unsigned long long g_phase[16];\n"
     "namespace {\n\ntypedef __nv_bfloat16 bf16;"),
    ("  if (n_tiles > 0) mbar_wait(kvbar, 0);\n"
     "  for (int n = 0; n < n_tiles; ++n) {\n",
     "  unsigned long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  if (n_tiles > 0) mbar_wait(kvbar, 0);\n"
     "  for (int n = 0; n < n_tiles; ++n) {\n"
     "    long long c0 = clock64();\n"),
    ("    mbar_wait(full0 + 8 * s, (n / STAGES) & 1);\n",
     "    mbar_wait(full0 + 8 * s, (n / STAGES) & 1);\n"
     "    long long c1 = clock64(); ph[0] += c1 - c0;\n"),
    ("    wgmma_wait<1>();\n    fence_regs(st);\n",
     "    wgmma_wait<1>();\n    fence_regs(st);\n"
     "    long long c2 = clock64(); ph[1] += c2 - c1;\n"),
    ("    wgmma_wait<0>();\n    fence_regs(dpt);\n",
     "    fence_regs(st);\n    long long c3 = clock64(); ph[2] += c3 - c2;\n"
     "    wgmma_wait<0>();\n    fence_regs(dpt);\n"
     "    long long c4 = clock64(); ph[3] += c4 - c3;\n"),
    ("      acc_to_a<DT>(dsf[kk], &dpt[8 * kk], &dpt[8 * kk + 4]);\n    }\n",
     "      acc_to_a<DT>(dsf[kk], &dpt[8 * kk], &dpt[8 * kk + 4]);\n    }\n"
     "    long long c5 = clock64(); ph[4] += c5 - c4;\n"),
    ("    // this tile's buffer is free once all four warps arrive\n",
     "    long long c6 = clock64(); ph[5] += c6 - c5;\n"
     "    // this tile's buffer is free once all four warps arrive\n"),
    ("    if (lane == 0) mbar_arrive(empty0 + 8 * s);\n  }\n\n  T* dkp",
     "    if (lane == 0) mbar_arrive(empty0 + 8 * s);\n"
     "    ph[6] += clock64() - c6;\n"
     "  }\n  if (tid == 0) {\n    for (int i = 0; i < 7; ++i)\n"
     "      atomicAdd(&g_phase[i], ph[i]);\n"
     "    atomicAdd(&g_phase[7], (unsigned long long)n_tiles);\n  }\n\n"
     "  T* dkp"),
]
_MASKED_LOOP = [("    if (tile_unmasked<BR>(p, kvlen, q0, k0)) {",
                 "    if (false) {"),
                ("    } else if (!p.causal && p.qseg == nullptr) {\n"
                 "      const bool key_in",
                 "    } else if (false) {\n      const bool key_in")]
_PHASE_READER = """
extern "C" int mx_bwd_phases(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long z[16] = {0};
    return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
}
"""


def _instrumented_libs():
    """Build the two instrumented copies in parallel; {name: library}."""
    sys.path.insert(0, HERE)
    from mxnet_tpu_torch import kernels
    with open(os.path.join(kernels.CSRC_DIR, "flash_attention.cu")) as f:
        src = f.read()
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, edits in (("as_is", _INSTRUMENT),
                        ("masked_loop", _INSTRUMENT + _MASKED_LOOP)):
        out = src
        for old, new in edits:
            if out.count(old) != 1:
                raise SystemExit("chip_diag bwd: the instrumentation anchor "
                                 "%r is not in csrc/flash_attention.cu once"
                                 % old.strip()[:60])
            out = out.replace(old, new)
        cu = os.path.join(kernels.BUILD_DIR, "diag_bwd_%s.cu" % name)
        lib = os.path.join(kernels.BUILD_DIR, "libdiag_bwd_%s.so" % name)
        with open(cu, "w") as f:
            f.write(out + _PHASE_READER)
        procs[name] = (subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit("chip_diag bwd: build failed\n" + log[-3000:])
        libs[name] = lib
    return libs


def bwd(others, pairs, skip_bf16):
    import ctypes
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import attention as TA
    card = cs.card_line()
    print("card: %s" % card)
    torch.backends.cuda.matmul.allow_tf32 = False
    if not skip_bf16:
        bf16_bwd(torch, ProfilerActivity, profile, ctypes, cs, TA, card)
    f32_turns(_builds(others, "bwd"), pairs, "bwd", card)
    return 0


def bf16_bwd(torch, ProfilerActivity, profile, ctypes, cs, TA, card):
    """The bf16 backward's device ms by kernel and the dK/dV kernel's
    cycles a tile by phase (see the module's note)."""
    libs = _instrumented_libs()
    _, bench_lens, _ = cs.bert_inputs(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [("bert", 24, 12, 512, 512, 64, "bfloat16", False, "bench",
               False),
              ("t4096", 1, 12, 4096, 4096, 64, "bfloat16", False, None,
               False)]
    for case in shapes:
        q, k, v, do, kw = cs._attention_operands(torch, gen, case,
                                                 bench_lens)
        TA._FNS.clear()
        with torch.no_grad():
            o, lse = TA.flash_attention_fwd(q, k, v, **kw)
            o = o.contiguous()
            for _ in range(3):
                TA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    TA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
                torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            m = re.search(r"flash_bwd_\w+", e.key)
            if m and e.device_time_total > 0:
                split[m.group()] = e.device_time_total / e.count / 1e3
        print("bwd %s %s: device ms a call by kernel %s  (%s)"
              % (case[0], tuple(case[1:6]), json.dumps(split), card))
        for name, path in libs.items():
            lib = ctypes.CDLL(path)
            fn = lib.mx_flash_attention_bwd
            fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + \
                [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            TA._kernel_fn("fwd")
            TA._FNS["bwd"] = fn
            counts = (ctypes.c_ulonglong * 16)()
            with torch.no_grad():
                TA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
                torch.cuda.synchronize()
                lib.mx_bwd_phases(counts, 1)
                TA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
                torch.cuda.synchronize()
            lib.mx_bwd_phases(counts, 0)
            tiles = max(counts[7], 1)
            phases = {p: round(counts[i] / tiles, 1)
                      for i, p in enumerate(_PHASES)}
            print("bwd %s dK/dV kernel (%s): %d tiles, cycles a tile of warp "
                  "0 %s, total %.1f" % (case[0], name, counts[7],
                                        json.dumps(phases),
                                        sum(phases.values())))
        TA._FNS.clear()
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()


def _build_side_by_side(sources, what="fwd", kernel_prefix="flash_fwd"):
    """Build {name: .cu path} in parallel into ``_build/``; {name: (library,
    the ptxas lines of the kernels whose names start with
    ``kernel_prefix``)}."""
    from mxnet_tpu_torch import kernels
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = os.path.join(kernels.BUILD_DIR, "libdiag_%s_%s.so"
                           % (what, name))
        procs[name] = (subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    out = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit("chip_diag %s: build of %s failed\n%s"
                             % (what, name, log[-3000:]))
        out[name] = (lib, [r for r in kernels.ptxas_report(log)
                           if r["kernel"].startswith(kernel_prefix)])
    return out


def _order(names, pairs):
    """The builds' turns: ``names`` in order, then in reverse, ``pairs``
    times."""
    order = []
    for i in range(pairs):
        order += names if i % 2 == 0 else names[::-1]
    return order


def _other_sources(this, others):
    """{name: .cu path}: this checkout's source as ``this`` and each of
    ``others`` as ``other``, ``other2``, ..."""
    sources = {"this": this}
    for i, path in enumerate(others):
        sources["other" if i == 0 else "other%d" % (i + 1)] = path
    return sources


def _compare(outs):
    """For each build but ``this``, whether its outputs are the same bits
    as ``outs["this"]``, else the largest |difference| of each output."""
    import torch
    out = {}
    for name, other in outs.items():
        if name == "this":
            continue
        pairs = list(zip(other, outs["this"]))
        out[name] = "same bits" if all(torch.equal(a, b) for a, b in pairs) \
            else "max |%s - this| %s" % (name, [
                float("%.3g" % (a.float() - b.float()).abs().max().item())
                for a, b in pairs])
    return "; ".join("%s: %s" % kv for kv in out.items())


def fwd(others, pairs, skip_bf16):
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    card = cs.card_line()
    print("card: %s" % card)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = _builds(others, "fwd")
    if not skip_bf16:
        bf16_fwd(libs, pairs, card)
    f32_turns(libs, pairs, "fwd", card)
    return 0


def bf16_fwd(libs, pairs, card):
    """The bf16 forward of each build of ``libs`` ({name: library path})
    at BERT's shapes and T 2048 (see the module's note)."""
    import ctypes
    import torch
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import attention as TA
    fns = {}
    for name, lib in libs.items():
        dll = ctypes.CDLL(lib)
        fn = dll.mx_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bfn = dll.mx_flash_attention_bshd_fwd
        bfn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + \
            [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]
        bfn.restype = ctypes.c_int
        fns[name] = (fn, bfn)
    names = list(fns)
    order = _order(names, pairs)
    cases = {c[0]: c for c in cs.ATTN_CASES}
    _, bench_lens, _ = cs.bert_inputs(0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for label in ("bert_bshd", "bert", "t2048"):
        if label == "bert_bshd":
            # BERT's layer: q, k and v strided views of one (B, T, 3 H D)
            # projection output, o (B, T, H, D)
            case = [c for c in cs.ATTN_BSHD_CASES if c[0] == "bert"][0]
            _, B, Tq, Tk, H, D, _, causal, _, _ = case
            q, k, v, _, kw, _ = cs._bshd_operands(torch, TA, gen, case,
                                                  bench_lens)
            o = torch.empty((B, Tq, H, D), dtype=q.dtype, device="cuda")
            strides = TA._bshd_strides("chip_diag fwd", (q, k, v, o))
            po, plse = TA._flash_attention_bshd_plain(q, k, v, **kw)
        else:
            _, B, H, Tq, Tk, D, _, causal, _, _ = cases[label]
            q, k, v, _, kw = cs._attention_operands(torch, gen, cases[label],
                                                    bench_lens)
            o = torch.empty_like(q)
            po, plse = TA._flash_attention_plain(q, k, v, **kw)
        lens = kw.get("kv_lens")
        lse = torch.empty((B, H, Tq), device="cuda")

        def call(name):
            fn, bfn = fns[name]
            lp = None if lens is None else lens.data_ptr()
            if label == "bert_bshd":
                rc = bfn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), lse.data_ptr(), lp, B, H, Tq, Tk, D,
                         strides, D ** -0.5, int(causal), 1, stream)
            else:
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr(), lp, None, None, B * H,
                        H, Tq, Tk, D, D ** -0.5, int(causal), 1, stream)
            cs.check(rc == 0, "chip_diag fwd: %s returned %d" % (name, rc))
        outs, errs = {}, {}
        for name in names:
            o.zero_()
            call(name)
            torch.cuda.synchronize()
            outs[name] = (o.clone(), lse.clone())
            errs[name] = [float("%.3g" % e) for e in (
                (o.float() - po.float()).abs().max().item()
                / po.float().abs().max().item(),
                (lse - plse).abs().max().item())]
        times = {name: [] for name in names}
        for name in order:
            times[name].append(cs.time_cuda(torch, lambda: call(name),
                                            flush))
        print("fwd %s %s: o rel err and lse abs err against the plain "
              "version %s; %s; ms in turns %s  (%s)" % (
                  label, (B, H, Tq, Tk, D), json.dumps(errs),
                  _compare(outs),
                  json.dumps({n: t for n, t in times.items()}), card))
        del q, k, v, o, lse, outs, po, plse
        torch.cuda.empty_cache()


# the float32 cases of chip_smoke.ATTN_BSHD_CASES that ``fwd`` and ``bwd``
# run on each build: BERT-base's float32 layer and (2, 1024, 1024, 8, 128)
F32_CASES = ("f32_bert", "f32_t1024_d128")


def _use_library(path):
    """Point the port's attention wrappers at the library at ``path`` (a
    build of some version of ``csrc/flash_attention.cu`` with the same C
    entries); returns their typed entries."""
    import ctypes
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import attention as TA
    kernels._LIBS["flash_attention"] = ctypes.CDLL(path)
    TA._FNS.clear()
    TA._kernel_fn()
    return dict(TA._FNS)


def f32_turns(libs, pairs, direction, card):
    """The float32 (B, T, H, D) forward (``direction`` "fwd") or backward
    ("bwd") of each build of ``libs`` ({name: library path}, "this"
    first) through the port's wrappers at F32_CASES: each build's error
    against the plain version (forward: o and lse absolute; backward: dq,
    dk and dv over the largest |plain|), whether it gives this build's
    bits, its ms in turns and, for the backward, its device ms a call by
    kernel under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import attention as TA
    fns = {name: _use_library(path) for name, path in libs.items()}
    names = list(fns)
    order = _order(names, pairs)
    cases = {c[0]: c for c in cs.ATTN_BSHD_CASES}
    _, bench_lens, _ = cs.bert_inputs(0)
    gen = torch.Generator(device="cuda").manual_seed(13)
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, device="cuda")
    for label in F32_CASES:
        case = cases[label]
        q, k, v, do, kw, _ = cs._bshd_operands(torch, TA, gen, case,
                                               bench_lens)
        with torch.no_grad():
            po, plse = TA._flash_attention_bshd_plain(q, k, v, **kw)
            want = TA._flash_attention_bshd_bwd_plain(
                q, k, v, po, plse, do, **kw) if direction == "bwd" else None

            def call(name):
                TA._FNS.clear()
                TA._FNS.update(fns[name])
                if direction == "fwd":
                    return TA.flash_attention_bshd_fwd(q, k, v, **kw)
                return TA.flash_attention_bshd_bwd(q, k, v, po, plse, do,
                                                   **kw)
            outs, errs = {}, {}
            for name in names:
                got = call(name)
                torch.cuda.synchronize()
                outs[name] = tuple(t.clone() for t in got)
                if direction == "fwd":
                    errs[name] = [float("%.3g" % (a - b).abs().max().item())
                                  for a, b in zip(got, (po, plse))]
                else:
                    errs[name] = [float("%.3g" % (
                        (a - b).abs().max() / b.abs().max()).item())
                        for a, b in zip(got, want)]
            times = {name: [] for name in names}
            for name in order:
                times[name].append(cs.time_cuda(torch, lambda: call(name),
                                                flush))
            sdpa = _sdpa_kernels(torch, profile, ProfilerActivity, TA, q, k,
                                 v, do, kw, direction)
            split = {}
            for name in names if direction == "bwd" else ():
                call(name)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        call(name)
                    torch.cuda.synchronize()
                split[name] = {}
                for e in prof.key_averages():
                    m = re.search(r"flash_bwd_\w+", e.key)
                    if m and e.device_time_total > 0:
                        split[name][m.group()] = round(
                            e.device_time_total / e.count / 1e3, 4)
        print("%s f32 %s %s: %s against the plain version %s; %s; ms in "
              "turns %s%s; scaled_dot_product_attention's kernels (device "
              "ms a call) %s  (%s)" % (
                  direction, label, tuple(case[1:6]),
                  "o and lse abs err" if direction == "fwd"
                  else "dq, dk, dv err over the largest |plain|",
                  json.dumps(errs), _compare(outs), json.dumps(times),
                  "; device ms a call by kernel %s" % json.dumps(split)
                  if split else "", json.dumps(sdpa), card))
        del q, k, v, do, po, plse, want, outs
        torch.cuda.empty_cache()
    TA._FNS.clear()


def _sdpa_kernels(torch, profile, ProfilerActivity, TA, q, k, v, do, kw,
                  direction):
    """The device kernels of one scaled_dot_product_attention call (its
    backward too for ``direction`` "bwd") on the (B, H, T, D) views of the
    same float32 operands with the same boolean mask, as torch.profiler
    names them: {name: device ms a call}, the mean of 5 calls."""
    import torch.nn.functional as F
    B, Tq, H, _ = q.shape
    mask = TA._visible(B, Tq, k.shape[1], q.device, kw.get("causal", False),
                       kw.get("kv_lens"), None, None)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))

    def once():
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            if direction == "bwd":
                torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2))
    once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            once()
        torch.cuda.synchronize()
    return {e.key[:120]: round(e.device_time_total / 5 / 1e3, 4)
            for e in prof.key_averages() if e.device_time_total > 0}


def _builds(others, what):
    """This checkout's ``csrc/flash_attention.cu`` and ``others`` built side
    by side: {name: library path}, with the attention kernels' ptxas lines
    printed."""
    from mxnet_tpu_torch import kernels
    builds = _build_side_by_side(_other_sources(
        os.path.join(kernels.CSRC_DIR, "flash_attention.cu"), others),
        what=what, kernel_prefix="flash_")
    for name, (lib, report) in builds.items():
        for r in report:
            print("ptxas %s: %s: %s registers, spill %d/%d bytes" % (
                name, r["kernel"], r["registers"], r["spill_stores"],
                r["spill_loads"]))
    return {name: lib for name, (lib, _) in builds.items()}


def bert32(others):
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import attention as TA
    from mxnet_tpu_torch.ops import layernorm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build(kernels.SOURCES)
    card = cs.card_line()
    libs = _builds(others, "bert32")
    # another version's kernels carry other names: the profile checks ask
    # only for some attention kernel each way
    cs.PROFILE_KERNELS["bert_f32_forward"] = ("flash_fwd_", "ln_fwd")
    cs.PROFILE_KERNELS["bert_f32"] = ("flash_fwd_", "flash_bwd_", "ln_bwd")
    for name, path in libs.items():
        _use_library(path)
        print("bert32: %s's flash_attention.cu" % name)
        cs.print_f32_bert(cs.f32_bert_phase(torch, mx, TA, layernorm, 0,
                                            card, profile=True), card)
        torch.cuda.empty_cache()
    return 0


LN_SHAPES = ((12288, 768), (1824, 768))


def ln(others, pairs):
    import ctypes
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import layernorm as TL
    card = cs.card_line()
    print("card: %s" % card)
    sources = _other_sources(os.path.join(kernels.CSRC_DIR, "layernorm.cu"),
                             others)
    builds = _build_side_by_side(sources, "ln", "ln_bwd")
    fns = {}
    for name, (lib, report) in builds.items():
        for r in report:
            print("ptxas %s: %s: %s registers, spill %d/%d bytes" % (
                name, r["kernel"], r["registers"], r["spill_stores"],
                r["spill_loads"]))
        dll = ctypes.CDLL(lib)
        fn = dll.mx_layer_norm_bwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        blocks = dll.mx_layer_norm_bwd_blocks
        blocks.argtypes = [ctypes.c_longlong]
        blocks.restype = ctypes.c_longlong
        fns[name] = (fn, blocks)
    order = _order(list(fns), pairs)
    gen = torch.Generator(device="cuda").manual_seed(11)
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    bw = cs.memory_bytes_per_s(card)
    for N, C in LN_SHAPES:
        x = (torch.randn((N, C), device="cuda", generator=gen) * 2 + 0.5) \
            .to(torch.bfloat16)
        g = (torch.rand(C, device="cuda", generator=gen) + 0.5) \
            .to(torch.bfloat16)
        b = (torch.rand(C, device="cuda", generator=gen) - 0.5) \
            .to(torch.bfloat16)
        y, mu, rstd = TL._layer_norm_fwd_plain(x, g, b, 1e-12)
        ct = torch.randn((N, C), device="cuda", generator=gen).to(y.dtype)
        bufs = {}
        for name, (fn, blocks) in fns.items():
            bufs[name] = (torch.empty_like(x),
                          torch.empty((blocks(N), 2, C), device="cuda"),
                          torch.empty(C, device="cuda"),
                          torch.empty(C, device="cuda"))

        def call(name):
            fn = fns[name][0]
            dx, ws, dg, db = bufs[name]
            rc = fn(x.data_ptr(), g.data_ptr(), mu.data_ptr(),
                    rstd.data_ptr(), ct.data_ptr(), dx.data_ptr(),
                    ws.data_ptr(), dg.data_ptr(), db.data_ptr(), N, C, 1, 1,
                    stream)
            cs.check(rc == 0, "chip_diag ln: %s returned %d" % (name, rc))
        for name in fns:
            call(name)
        torch.cuda.synchronize()
        outs = {name: (bufs[name][0], bufs[name][2], bufs[name][3])
                for name in fns}
        compared = _compare(outs)
        times = {name: [] for name in fns}
        for name in order:
            times[name].append(cs.time_cuda(torch, lambda: call(name),
                                            flush))
        # device time by kernel, under the profiler
        split = {}
        for name in fns:
            for _ in range(3):
                call(name)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    flush.sum()
                    call(name)
                torch.cuda.synchronize()
            split[name] = {}
            for e in prof.key_averages():
                m = re.search(r"\bln_\w+", e.key)
                if m and e.device_time_total > 0:
                    split[name][m.group()] = \
                        e.device_time_total / e.count / 1e3
        nbytes = N * C * 6 + 8 * N + C * 10
        print("ln bwd (%d, %d) bf16: %s; ms in turns %s; device ms a call "
              "by kernel %s; bound %.4f ms  (%s)" % (
                  N, C, compared, json.dumps(times), json.dumps(split),
                  nbytes / bw * 1e3, card))
        del x, ct, bufs, outs
        torch.cuda.empty_cache()
    return 0


def f16(seeds):
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["MXNET_FUSED_LAYERNORM"] = "1"
    kernels.build(kernels.SOURCES)
    card = cs.card_line()
    for seed in seeds:
        for what, fn in (("resnet", cs.f16_resnet_card_vs_cpu),
                         ("bert", cs.f16_bert_card_vs_cpu)):
            print("f16 %s, seed %d (%s): %s"
                  % (what, seed, card, json.dumps(fn(torch, mx, seed))))
            torch.cuda.empty_cache()
    return 0


def symgrad(others, seeds):
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["MXNET_FUSED_LAYERNORM"] = "1"
    kernels.build(kernels.SOURCES)
    card = cs.card_line()
    # readings only: no limit holds them
    cs.BERT_PARITY_REL_L2 = cs.SYM_PARITY_GRAD_REL_L2 = float("inf")
    libs = _builds(others, "symgrad")

    def reading(what, seed):
        print("symgrad %s, seed %d (%s): %s" % (what, seed, card, json.dumps(
            cs.sym_bert_card_vs_cpu(torch, mx, seed))), flush=True)
        torch.cuda.empty_cache()
    for name, path in libs.items():
        _use_library(path)
        for seed in seeds:
            reading("%s's flash_attention.cu" % name, seed)
    _use_library(libs["this"])
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    reading("this flash_attention.cu, cuBLAS and cuDNN in TF32", seeds[0])
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("parity")
    p.add_argument("--seed", type=int, default=0)
    a = sub.add_parser("ab")
    a.add_argument("--parent", required=True)
    a.add_argument("--pairs", type=int, default=2)
    for name in ("bwd", "fwd"):
        f = sub.add_parser(name)
        f.add_argument("--other", action="append", default=[])
        f.add_argument("--pairs", type=int, default=2)
        f.add_argument("--skip-bf16", action="store_true")
    b = sub.add_parser("bert32")
    b.add_argument("--other", action="append", default=[])
    n = sub.add_parser("ln")
    n.add_argument("--other", action="append", default=[])
    n.add_argument("--pairs", type=int, default=2)
    h = sub.add_parser("f16")
    h.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    g = sub.add_parser("symgrad")
    g.add_argument("--other", action="append", default=[])
    g.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_diag: no CUDA device", file=sys.stderr)
        return 2
    if args.cmd == "parity":
        return parity(args.seed)
    if args.cmd == "f16":
        return f16(args.seeds)
    others = [os.path.abspath(o) for o in getattr(args, "other", [])]
    if args.cmd == "symgrad":
        return symgrad(others, args.seeds)
    if args.cmd in ("fwd", "bwd"):
        return (fwd if args.cmd == "fwd" else bwd)(others, args.pairs,
                                                   args.skip_bf16)
    if args.cmd == "bert32":
        return bert32(others)
    if args.cmd == "ln":
        return ln(others, args.pairs)
    return ab(os.path.abspath(args.parent), args.pairs)


if __name__ == "__main__":
    sys.exit(main())
