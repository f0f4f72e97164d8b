"""Bucketed-shape policy and per-bucket warmed models for serving.

Counterpart of ``mxnet_tpu/serve/buckets.py``.  A request batch of ``n``
runs on the smallest available bucket ``>= n`` (:func:`pick_bucket`); a
quarantined bucket degrades a batch onto a cover of smaller ones
(:func:`plan_buckets`); :func:`pad_batch` zero-pads rows up to the
bucket.  :class:`AotModel` holds the model function and the bucket menu.
Where the JAX package AOT-compiles one executable per bucket,
:meth:`AotModel.compile_all` captures one CUDA graph per bucket
(``cuda_graph.Captured``: a warm-up forward, then the capture), the
largest bucket first and all from one memory pool, so that the smaller
buckets reuse the largest one's memory.  Each capture is reported to the
telemetry recompile detector under ``serve.<name>.b<N>``, so a later one
(a steady-state "recompile") shows in ``compile_deltas``.
:meth:`AotModel.run` copies the padded batch into the bucket's static
input, replays the graph and returns a fresh output; it refuses a bucket
or a shape outside the captured menu.  On the CPU each run calls the
model on the same static input, without a graph.  ``from_exported`` (the
JAX package's StableHLO artifacts) waits: the port has no such artifact.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as onp
import torch

from .. import autograd, telemetry
from ..base import MXNetError, torch_dtype
from ..context import Context, current_context
from ..cuda_graph import Captured, new_pool
from ..ndarray.ndarray import NDArray, _wrap

__all__ = ["pick_bucket", "plan_buckets", "pad_batch", "AotModel"]

# per-process de-dup of model names: two models sharing a name would share
# recompile-detector keys
_NAME_SEQ = {}


def _unique_name(name):
    seq = _NAME_SEQ.get(name, 0) + 1
    _NAME_SEQ[name] = seq
    return name if seq == 1 else "%s#%d" % (name, seq)


def pick_bucket(n: int, buckets: Sequence[int],
                quarantined: Sequence[int] = ()) -> Optional[int]:
    """Smallest non-quarantined bucket ``>= n``; None when there is none."""
    for b in sorted(buckets):
        if b >= n and b not in quarantined:
            return b
    return None


def plan_buckets(n: int, buckets: Sequence[int],
                 quarantined: Sequence[int] = ()) -> Optional[list]:
    """Bucket cover for ``n`` requests: ``[smallest covering bucket]`` when
    healthy, a largest-available-first split when the covering buckets are
    quarantined, None when no bucket is available."""
    avail = sorted(b for b in set(buckets) if b not in set(quarantined))
    if not avail or n <= 0:
        return None if not avail else []
    plan = []
    left = n
    while left > 0:
        b = pick_bucket(left, avail)
        if b is not None:
            plan.append(b)
            break
        plan.append(avail[-1])
        left -= avail[-1]
    return plan


def pad_batch(rows: Sequence[onp.ndarray], bucket: int,
              feature_shape: tuple, dtype) -> onp.ndarray:
    """Zero-padded ``(bucket,) + feature_shape`` batch of ``rows`` in
    ``dtype``, each row cast as it is copied in."""
    if len(rows) > bucket:
        raise MXNetError("pad_batch: %d rows exceed bucket %d"
                         % (len(rows), bucket))
    out = onp.zeros((bucket,) + tuple(feature_shape), dtype)
    for i, r in enumerate(rows):
        out[i] = r
    return out


class AotModel:
    """A model function served at a fixed menu of batch buckets.

    ``fn(x)`` takes a ``(B,) + feature_shape`` tensor on ``ctx``'s device
    and returns a tensor whose first axis is ``B``.  It runs under
    ``torch.inference_mode()`` in predict mode, with ``ctx``'s CUDA device
    current, on the thread that calls :meth:`compile_all`, where it is
    captured (on the card; on the CPU it runs on each :meth:`run`).
    """

    def __init__(self, fn, feature_shape=(), dtype="float32", name="model",
                 ctx: Optional[Context] = None):
        self._fn = fn
        self.feature_shape = tuple(int(d) for d in feature_shape)
        self.dtype = onp.dtype(dtype)
        self.name = _unique_name(str(name))
        self.ctx = ctx if ctx is not None else current_context()
        self.device = self.ctx.torch_device
        self._graphs = {}       # bucket -> Captured
        self._pool = None

    @classmethod
    def from_block(cls, net, feature_shape, dtype="float32", name="model"):
        """Serve a Gluon block in eval mode on its parameters' context."""
        params = list(net.collect_params().values())
        if not params or not all(p._data is not None or p._deferred_init
                                 for p in params):
            raise MXNetError("AotModel.from_block: net has uninitialized "
                             "parameters; call net.initialize(ctx=...)")
        ctx = params[0].list_ctx()[0]

        def fn(x):
            out = net(_wrap(x))
            return out.astorch() if isinstance(out, NDArray) else out

        return cls(fn, feature_shape=feature_shape, dtype=dtype, name=name,
                   ctx=ctx)

    @classmethod
    def from_exported(cls, *args, **kwargs):
        raise MXNetError("AotModel.from_exported reads the JAX package's "
                         "StableHLO artifacts, which the port has no "
                         "counterpart of; it waits (ROADMAP.md, queue 1, "
                         "'Compiled-execution waits')")

    @property
    def buckets(self):
        return sorted(self._graphs)

    def compile_all(self, buckets: Sequence[int]):
        """Capture one graph per bucket (idempotent per bucket), the
        largest first, and report each to the recompile detector."""
        if self._pool is None:
            self._pool = new_pool(self.device)
        for b in sorted(set(int(b) for b in buckets), reverse=True):
            if b in self._graphs:
                continue
            t0 = time.perf_counter()
            shape = (b,) + self.feature_shape
            graph = Captured(self._body, [torch.empty(
                shape, dtype=torch_dtype(self.dtype), device=self.device)],
                pool=self._pool)
            self._call(graph, onp.zeros(shape, self.dtype))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._graphs[b] = graph
            dur_ms = round((time.perf_counter() - t0) * 1e3, 3)
            telemetry.record_compile(
                "serve.%s.b%d" % (self.name, b),
                {"bucket": b, "shape": [b] + list(self.feature_shape),
                 "dtype": str(self.dtype)})
            telemetry.event("serve", "compile", bucket=b, dur_ms=dur_ms,
                            model=self.name)
        return self

    def _body(self, inputs):
        with torch.inference_mode(), autograd.predict_mode():
            return [self._fn(inputs[0])]

    def _call(self, graph, x):
        """Copy the batch (host or device) into ``graph``'s static input
        and run it; the output tensor."""
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                return graph([torch.as_tensor(x)])[0]
        return graph([torch.as_tensor(x)])[0]

    def run(self, bucket: int, x):
        """Run one padded bucket batch (numpy or tensor) and return the
        output tensor.  A bucket outside the captured menu, or a batch of
        another shape, is an error."""
        bucket = int(bucket)
        if bucket not in self._graphs:
            raise MXNetError("AotModel %r: bucket %d was never captured"
                             % (self.name, bucket))
        if tuple(x.shape) != (bucket,) + self.feature_shape:
            raise MXNetError("AotModel %r: batch shape %r is not bucket %d's"
                             " %r" % (self.name, tuple(x.shape), bucket,
                                      (bucket,) + self.feature_shape))
        return self._call(self._graphs[bucket], x)
