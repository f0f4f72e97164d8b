"""In-process runtime telemetry: counters, gauges, an event journal,
log-bucketed histograms and the recompile detector.

Counterpart of the part of ``mxnet_tpu/telemetry.py`` that serving reads:
``inc``/``counter``, ``gauge``, ``event`` (a bounded in-memory journal),
``hist_observe``/``histogram`` with honest p50/p99 from fixed-size
log buckets, ``span_event``, ``record_compile``/``forget_compiles``/
``compile_counts``/``compile_deltas`` and ``new_trace_id``.  Export,
trace contexts, the collector and the profiler come with the
observability port.
"""
from __future__ import annotations

import math
import os
import threading
import time
from collections import deque

__all__ = ["inc", "counter", "gauge", "event", "span_event", "Histogram",
           "hist_observe", "histogram", "record_compile", "forget_compiles",
           "compile_counts",
           "compile_deltas", "new_trace_id"]

JOURNAL_MAXLEN = 4096

_EPOCH = time.perf_counter()
_WALL0 = time.time()

_lock = threading.Lock()
_counters = {}
_gauges = {}
_journal = deque(maxlen=JOURNAL_MAXLEN)
_compiles = {}       # fn -> {"count": int, "key": last key}
_hists = {}          # name -> Histogram
_ids = [0]


def _wall():
    return round(_WALL0 + time.perf_counter() - _EPOCH, 6)


def new_trace_id():
    """Process-unique trace id (pid-qualified)."""
    with _lock:
        _ids[0] += 1
        n = _ids[0]
    return "%x-%x-%x" % (int(_WALL0 * 1e3) & 0xffffffff,
                         os.getpid() & 0xffffff, n)


def event(kind, name, **data):
    """Append a structured record to the bounded journal."""
    rec = {"ts": _wall(), "kind": kind, "name": name}
    rec.update(data)
    with _lock:
        _journal.append(rec)


def span_event(name, dur_s, trace=None, hist=False, **data):
    """Journal an externally timed span; with ``hist=True`` its duration
    (ms) also feeds the ``name`` histogram."""
    rec = {"ts": round(_wall() - dur_s, 6), "kind": "span", "name": name,
           "dur_ms": round(dur_s * 1e3, 4)}
    if trace is not None:
        rec["trace"] = trace
    rec.update(data)
    with _lock:
        _journal.append(rec)
    if hist:
        hist_observe(name, dur_s * 1e3)


def inc(name, delta=1):
    """Bump a monotonic counter."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + delta


def counter(name):
    """Current value of a counter (0 if never bumped)."""
    with _lock:
        return _counters.get(name, 0)


def gauge(name, value):
    """Set a last-value gauge."""
    with _lock:
        _gauges[name] = value


class Histogram:
    """Log-bucketed online histogram: fixed memory, mergeable.

    ``BUCKETS_PER_DECADE`` buckets per power of ten from ``LO`` over
    ``DECADES`` decades (1e-3 to 1e7 when fed milliseconds) plus one
    underflow bucket; exact min/max are kept, so a quantile's relative
    error is bounded by the bucket ratio (about 12%)."""

    LO = 1e-3
    BUCKETS_PER_DECADE = 10
    DECADES = 10
    NBUCKETS = 1 + BUCKETS_PER_DECADE * DECADES

    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.buckets = [0] * self.NBUCKETS

    def _index(self, v):
        if v < self.LO:
            return 0
        return 1 + min(self.NBUCKETS - 2,
                       int(math.log10(v / self.LO) * self.BUCKETS_PER_DECADE))

    def add(self, v):
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self.buckets[self._index(v)] += 1

    def _bound(self, i):
        if i == 0:
            return self.LO
        return self.LO * 10.0 ** (i / self.BUCKETS_PER_DECADE)

    def quantile(self, q):
        """The geometric midpoint of the bucket holding the q-th
        observation, clamped by the exact min/max; None when empty."""
        if self.count == 0:
            return None
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.buckets):
            seen += c
            if seen >= target and c:
                lo = self._bound(i - 1) if i > 0 else 0.0
                hi = self._bound(i)
                mid = math.sqrt(lo * hi) if lo > 0 else hi / 2.0
                return max(self.min, min(self.max, mid))
        return self.max


def hist_observe(name, value_ms):
    """Feed one observation (milliseconds) into the ``name`` histogram."""
    with _lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = Histogram()
        h.add(value_ms)


def histogram(name):
    """The live Histogram for ``name`` (None if never observed)."""
    with _lock:
        return _hists.get(name)


def record_compile(fn, key):
    """Report a compile (for the port: a warm-up of one serving shape) of
    ``fn`` with its cache key.  The first is journaled as ``compile``,
    later ones as ``recompile`` with the previous key."""
    with _lock:
        ent = _compiles.setdefault(fn, {"count": 0, "key": None})
        ent["count"] += 1
        n, prev = ent["count"], ent["key"]
        ent["key"] = key
    if prev is None:
        event("compile", fn, n=n)
    else:
        event("recompile", fn, n=n, previous=prev, key=key)


def forget_compiles(fn):
    """Drop the compile record of ``fn``: a new owner of a name made from
    an ``id()`` that an earlier, collected object had starts from 0."""
    with _lock:
        _compiles.pop(fn, None)


def compile_counts():
    with _lock:
        return {k: v["count"] for k, v in _compiles.items()}


def compile_deltas(baseline):
    """``{fn: extra compiles}`` since a ``compile_counts()`` snapshot."""
    cur = compile_counts()
    return {k: v - baseline.get(k, 0) for k, v in cur.items()
            if v > baseline.get(k, 0)}

