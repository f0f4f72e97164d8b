"""Fault-tolerant continuous-batching inference server.

Counterpart of ``mxnet_tpu/serve/server.py``, with the same failure
envelope:

* **Every submitted request reaches one terminal outcome** — ``result``,
  ``timeout``, ``reject`` or ``error`` — no hangs, no silent drops.
* **Deadlines propagate** from enqueue through dispatch: an expired
  request is dropped before it costs a dispatch, and a batch never waits
  past its earliest member's deadline.
* **Backpressure, never blocking**: the request queue is bounded and a
  full queue is an immediate ``reject(queue_full)``.
* **Watchdog and quarantine**: a dispatch that hangs past
  ``dispatch_timeout_ms`` is timed out (its requests resolve, a fresh
  dispatcher takes over, the late result is discarded); a bucket whose
  model call fails is retried a bounded number of times, then
  quarantined, and batches degrade onto smaller buckets.
* **Health states** ``STARTING -> READY -> DEGRADED -> DRAINING``.

``start()`` captures one CUDA graph a bucket (``AotModel.compile_all``:
a warm-up forward, then the capture) on the dispatcher thread before it
admits a request, so neither the first cuDNN algorithm choice, nor the
creation of that thread's cuDNN and cuBLAS handles, nor a capture lands
inside a request's deadline; the capture is thread-local, so the other
threads may run meanwhile.  The dispatcher calls the model through
``AotModel.run``, which copies the batch into the bucket's static input
and replays its graph with the model's CUDA device current on that
thread.  A bucket whose replay fails is retried and quarantined like any
failing model call.  The JAX package's chaos injection points and flight
recorder dumps are not ported yet.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as onp
import torch

from .. import telemetry
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from .buckets import AotModel, pad_batch, plan_buckets

__all__ = ["InferenceServer", "ServeConfig", "PendingRequest",
           "ServeError", "ServeRejected", "ServeTimeout",
           "STARTING", "READY", "DEGRADED", "DRAINING"]

STARTING = "STARTING"
READY = "READY"
DEGRADED = "DEGRADED"
DRAINING = "DRAINING"


class ServeError(MXNetError):
    """A request failed inside the server (no bucket left to run it)."""


class ServeRejected(ServeError):
    """Admission refused the request (queue_full / shed / draining /
    not_ready / bad_shape / bad_dtype)."""


class ServeTimeout(ServeError):
    """The request's deadline expired before a result."""


def _to_numpy(out):
    if isinstance(out, NDArray):
        out = out.astorch()
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return onp.asarray(out)


class ServeConfig:
    """Serving knobs.  Times are milliseconds; every queue and wait is
    bounded."""

    def __init__(self, buckets=(1, 2, 4, 8), max_queue=64,
                 batch_wait_ms=2.0, deadline_margin_ms=5.0,
                 default_deadline_ms=1000.0, dispatch_timeout_ms=1000.0,
                 watchdog_interval_ms=25.0, max_retries=1,
                 shed_fraction=0.75, resume_fraction=0.25,
                 max_respawns=4, poll_ms=20.0):
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise MXNetError("ServeConfig: buckets must be >= 1")
        self.max_queue = int(max_queue)
        if self.max_queue < 1:
            # queue.Queue(maxsize=0) would be unbounded
            raise MXNetError("ServeConfig: max_queue must be >= 1 (got %d)"
                             % self.max_queue)
        self.batch_wait_s = float(batch_wait_ms) / 1e3
        self.margin_s = float(deadline_margin_ms) / 1e3
        self.default_deadline_s = float(default_deadline_ms) / 1e3
        self.dispatch_timeout_s = float(dispatch_timeout_ms) / 1e3
        self.watchdog_s = float(watchdog_interval_ms) / 1e3
        self.max_retries = int(max_retries)
        self.shed_depth = max(1, int(self.max_queue * float(shed_fraction)))
        self.resume_depth = int(self.max_queue * float(resume_fraction))
        self.max_respawns = int(max_respawns)
        self.poll_s = float(poll_ms) / 1e3


class PendingRequest:
    """Client handle that resolves exactly once to a terminal outcome.

    ``outcome(timeout)`` returns ``("result", value, None)``,
    ``("timeout", None, reason)``, ``("reject", None, reason)`` or
    ``("error", None, reason)``, or None if nothing arrived within
    ``timeout``.  ``result(timeout)`` unwraps, raising the typed error.
    The first resolution wins."""

    def __init__(self, x, deadline, priority=0):
        self.x = x
        self.deadline = deadline            # absolute time.monotonic()
        self.priority = int(priority)
        self.arrival = time.monotonic()
        self.trace_id = telemetry.new_trace_id()
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._outcome = None
        self._done_ts = None

    def _resolve(self, kind, value=None, reason=None):
        """Record the terminal outcome; False if already resolved."""
        with self._lock:
            if self._outcome is not None:
                return False
            self._outcome = (kind, value, reason)
            done_ts = self._done_ts = time.monotonic()
        self._done.set()
        lat_ms = (done_ts - self.arrival) * 1e3
        if kind == "result":
            telemetry.hist_observe("serve.request", lat_ms)
        telemetry.event("serve", "outcome", trace=self.trace_id,
                        outcome=kind, reason=reason,
                        latency_ms=round(lat_ms, 3))
        return True

    def done(self):
        return self._done.is_set()

    def outcome(self, timeout=None):
        if not self._done.wait(timeout):
            return None
        with self._lock:
            return self._outcome

    def latency_ms(self):
        """submit -> terminal-outcome latency, or None while pending."""
        with self._lock:
            ts = self._done_ts
        return None if ts is None else (ts - self.arrival) * 1e3

    def result(self, timeout=None):
        out = self.outcome(timeout)
        if out is None:
            raise ServeTimeout("no outcome within %.3fs client wait"
                               % (timeout or 0))
        kind, value, reason = out
        if kind == "result":
            return value
        if kind == "timeout":
            raise ServeTimeout(reason or "deadline exceeded")
        if kind == "reject":
            raise ServeRejected(reason or "rejected")
        raise ServeError(reason or "serving error")


class InferenceServer:
    """Continuous-batching server over a model warmed up per bucket.

    ::

        srv = serve.InferenceServer(net, feature_shape=(3, 224, 224))
        srv.start()                       # STARTING -> READY
        h = srv.submit(x, deadline_ms=50)
        y = h.result(timeout=1.0)
        srv.close()                       # DRAINING -> stopped

    ``model`` is a Gluon block (served on its parameters' context), an
    :class:`AotModel`, or a callable on tensors (served on the current
    context).
    """

    def __init__(self, model, feature_shape=None, dtype="float32",
                 config=None, name="model"):
        self._cfg = config or ServeConfig()
        if isinstance(model, AotModel):
            self._model = model
        else:
            if feature_shape is None:
                raise MXNetError("InferenceServer: feature_shape is required")
            if hasattr(model, "collect_params"):
                self._model = AotModel.from_block(
                    model, feature_shape=feature_shape, dtype=dtype,
                    name=name)
            elif callable(model):
                self._model = AotModel(model, feature_shape=feature_shape,
                                       dtype=dtype, name=name)
            else:
                raise MXNetError("InferenceServer: cannot serve %r" % model)
        self.name = self._model.name
        self._lock = threading.Lock()
        self._q = queue.Queue(maxsize=self._cfg.max_queue)
        self._dq = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._state = STARTING
        self._started = False
        self._batcher = None
        self._watchdog = None
        self._dispatcher = None
        self._retired = []
        self._gen = 0
        self._respawns = 0
        self._dispatcher_gone = False
        self._pending_n = 0
        self._inflight = {}          # id -> {"start", "reqs", "bucket"}
        self._inflight_seq = 0
        self._quarantined = set()
        self._compile_baseline = {}

    # -- lifecycle -------------------------------------------------------
    def start(self):
        """Warm every bucket up (STARTING), snapshot the compile counts
        (the zero-recompile baseline), go READY and start the batcher and
        watchdog threads.  The warm-up runs on the dispatcher thread, the
        thread that serves: PyTorch keeps cuDNN and cuBLAS handles per
        thread, so a warm-up on the caller's thread would leave the first
        request to create them.  A warm-up failure is raised here."""
        with self._lock:
            if self._started:
                return self
            self._started = True
            self._gen += 1
            gen = self._gen
        warmed = threading.Event()
        failure = []
        self._spawn_dispatcher(gen, warmup=(warmed, failure))
        warmed.wait()
        if failure:
            self._stop.set()
            with self._lock:
                d = self._dispatcher
            d.join()
            raise failure[0]
        baseline = telemetry.compile_counts()
        b = threading.Thread(target=self._batch_loop,
                             name="mxtorch-serve-batcher", daemon=True)
        w = threading.Thread(target=self._watchdog_loop,
                             name="mxtorch-serve-watchdog", daemon=True)
        with self._lock:
            self._compile_baseline = baseline
            self._batcher = b
            self._watchdog = w
        self._set_state(READY)
        b.start()
        w.start()
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.close()
        return False

    def drain(self, timeout=10.0):
        """DRAINING: new submissions reject, accepted requests complete.
        True when the queue, batcher and dispatch went quiet in time."""
        self._draining.set()
        self._set_state(DRAINING)
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            with self._lock:
                busy = self._pending_n or self._inflight
            if not busy and self._q.qsize() == 0 and self._dq.qsize() == 0:
                return True
            time.sleep(0.005)
        return False

    def close(self, timeout=10.0):
        """Drain, stop and join every thread; anything still unresolved
        after the drain window gets a terminal outcome.  Idempotent."""
        drained = True
        with self._lock:
            started = self._started
        if started:
            drained = self.drain(timeout)
        else:
            self._draining.set()
            self._set_state(DRAINING)
        self._stop.set()
        with self._lock:
            threads = [self._batcher, self._watchdog, self._dispatcher] + \
                list(self._retired)
        for t in threads:
            if t is not None and t.is_alive():
                t.join(timeout)
        self._fail_leftovers()
        return drained

    def _fail_leftovers(self):
        """Terminal outcomes for what a timed-out close left behind."""
        leftovers = []
        for q in (self._dq, self._q):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                leftovers.extend(item if isinstance(item, list) else [item])
        for r in leftovers:
            if r._resolve("reject", reason="shutdown"):
                telemetry.inc("serve.rejects")
        with self._lock:
            stuck = list(self._inflight.values())
            self._inflight.clear()
        for rec in stuck:
            for r in rec["reqs"]:
                if r._resolve("timeout", reason="shutdown"):
                    telemetry.inc("serve.timeouts")

    # -- state machine ---------------------------------------------------
    def state(self):
        with self._lock:
            return self._state

    def _set_state(self, new):
        with self._lock:
            old = self._state
            if old == new or (old == DRAINING and new != DRAINING):
                return
            self._state = new
        telemetry.event("serve", "state", state_from=old, state_to=new)
        telemetry.gauge("serve.state", new)

    # -- admission -------------------------------------------------------
    def submit(self, x, deadline_ms=None, priority=0):
        """Submit one request; returns a :class:`PendingRequest` that always
        reaches a terminal outcome.  ``priority`` 0 is the highest; under
        overload, ``priority > 0`` requests are shed.  Never blocks."""
        deadline_s = self._cfg.default_deadline_s if deadline_ms is None \
            else float(deadline_ms) / 1e3
        arr = onp.asarray(x)
        feat = self._model.feature_shape
        req = PendingRequest(arr, time.monotonic() + deadline_s,
                             priority=priority)
        telemetry.inc("serve.requests")
        if tuple(arr.shape) != feat:
            self._reject(req, "bad_shape: %r != %r" % (tuple(arr.shape), feat))
            return req
        if arr.dtype.kind not in "biuf":
            self._reject(req, "bad_dtype: %s" % arr.dtype)
            return req
        # a row of another dtype is cast as the batch is assembled
        # (pad_batch), after the batching window: a float32 image cast to
        # float16 here takes about a millisecond of the caller's thread
        self._admit(req)
        return req

    def _admit(self, req):
        with self._lock:
            st = self._state
        if st == STARTING:
            self._reject(req, "not_ready")
            return
        if st == DRAINING:
            self._reject(req, "draining")
            return
        overloaded = self._q.qsize() >= self._cfg.shed_depth
        if overloaded and st == READY:
            self._set_state(DEGRADED)
            st = DEGRADED
        if (st == DEGRADED or overloaded) and req.priority > 0:
            if req._resolve("reject", reason="shed"):
                telemetry.inc("serve.sheds")
            return
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self._reject(req, "queue_full")
            return
        if self._draining.is_set():
            # drain() raced this enqueue; the batcher may have exited
            self._reject(req, "draining")
            return
        telemetry.inc("serve.accepted")

    def _reject(self, req, reason):
        if req._resolve("reject", reason=reason):
            telemetry.inc("serve.rejects")

    # -- batcher thread --------------------------------------------------
    def _drop_expired(self, reqs, stage):
        """Resolve expired requests as timeouts before they cost a dispatch;
        returns the live ones."""
        now = time.monotonic()
        live = []
        for r in reqs:
            if r.deadline <= now:
                if r._resolve("timeout",
                              reason="deadline expired in %s" % stage):
                    telemetry.inc("serve.timeouts")
                    telemetry.inc("serve.deadline_drops")
            elif not r.done():
                live.append(r)
        return live

    def _batch_loop(self):
        cfg = self._cfg
        max_bucket = cfg.buckets[-1]
        pending = []
        first = None
        while True:
            stopped = self._stop.is_set()
            if not stopped:
                if pending:
                    flush_at = min(
                        first + cfg.batch_wait_s,
                        min(r.deadline for r in pending) - cfg.margin_s)
                    wait = max(0.0, flush_at - time.monotonic())
                else:
                    wait = cfg.poll_s
                try:
                    req = self._q.get(timeout=wait)
                except queue.Empty:
                    req = None
                if req is not None:
                    if not pending:
                        first = time.monotonic()
                    pending.append(req)
            pending = self._drop_expired(pending, "queue")
            if not pending:
                first = None
            now = time.monotonic()
            flush = bool(pending) and (
                stopped or self._draining.is_set()
                or len(pending) >= max_bucket
                or now >= first + cfg.batch_wait_s
                or now >= min(r.deadline for r in pending) - cfg.margin_s)
            if flush:
                batch, pending = pending[:max_bucket], pending[max_bucket:]
                first = now if pending else None
                self._hand_to_dispatch(batch)
            with self._lock:
                self._pending_n = len(pending)
            if stopped:
                while True:
                    try:
                        pending.append(self._q.get_nowait())
                    except queue.Empty:
                        break
                for r in pending:
                    if r._resolve("reject", reason="shutdown"):
                        telemetry.inc("serve.rejects")
                return
            if self._draining.is_set() and not pending \
                    and self._q.qsize() == 0:
                return

    def _hand_to_dispatch(self, batch):
        """Bounded handoff to the dispatch queue; expired members keep
        being dropped while dispatch is busy."""
        while batch:
            try:
                self._dq.put(batch, timeout=0.05)
                return
            except queue.Full:
                batch = self._drop_expired(batch, "queue")
                if self._stop.is_set():
                    for r in batch:
                        if r._resolve("reject", reason="shutdown"):
                            telemetry.inc("serve.rejects")
                    return

    # -- dispatch thread -------------------------------------------------
    def _spawn_dispatcher(self, gen, warmup=None):
        t = threading.Thread(target=self._dispatch_loop, args=(gen, warmup),
                             name="mxtorch-serve-dispatch", daemon=True)
        with self._lock:
            self._dispatcher = t
        t.start()

    def _dispatch_loop(self, gen, warmup=None):
        if warmup is not None:
            warmed, failure = warmup
            try:
                self._model.compile_all(self._cfg.buckets)
            except Exception as e:       # noqa: BLE001 — re-raised by start()
                failure.append(e)
                return
            finally:
                warmed.set()
        while not self._stop.is_set():
            with self._lock:
                cur, gone = self._gen, self._dispatcher_gone
            if gen != cur or gone:
                return          # superseded by a watchdog respawn
            try:
                batch = self._dq.get(timeout=0.05)
            except queue.Empty:
                continue
            self._run_batch(batch)

    def _run_batch(self, reqs):
        """Plan the batch onto the available buckets and dispatch each
        chunk; re-entered after a quarantine to re-plan without it."""
        reqs = self._drop_expired(reqs, "dispatch")
        if not reqs:
            return
        with self._lock:
            quarantined = set(self._quarantined)
        plan = plan_buckets(len(reqs), self._cfg.buckets, quarantined)
        if plan is None:
            self._fail_requests(reqs, "no executable available "
                                      "(all buckets quarantined)")
            return
        i = 0
        for b in plan:
            part = reqs[i:i + b]
            i += len(part)
            if part:
                self._dispatch_chunk(part, b)

    def _register_inflight(self, part, bucket):
        with self._lock:
            self._inflight_seq += 1
            did = self._inflight_seq
            self._inflight[did] = {"start": time.monotonic(),
                                   "reqs": part, "bucket": bucket}
        return did

    def _unregister_inflight(self, did):
        """Pop the dispatch record; None means the watchdog abandoned it."""
        with self._lock:
            return self._inflight.pop(did, None)

    def _dispatch_chunk(self, part, bucket):
        part = self._drop_expired(part, "dispatch")
        if not part:
            return
        attempts = 0
        while True:
            did = self._register_inflight(part, bucket)
            t0 = time.monotonic()
            try:
                xp = pad_batch([r.x for r in part], bucket,
                               self._model.feature_shape, self._model.dtype)
                out = _to_numpy(self._model.run(bucket, xp))
            except Exception as e:       # noqa: BLE001 — fault boundary
                abandoned = self._unregister_inflight(did) is None
                attempts += 1
                telemetry.inc("serve.dispatch_errors")
                telemetry.event("serve", "dispatch_error", bucket=bucket,
                                attempt=attempts, error=repr(e),
                                traces=[r.trace_id for r in part])
                if abandoned:
                    return
                if attempts <= self._cfg.max_retries:
                    telemetry.inc("serve.retries")
                    part = self._drop_expired(part, "dispatch")
                    if not part:
                        return
                    continue
                self._quarantine(bucket, e)
                self._run_batch(part)     # re-plan without the bucket
                return
            if self._unregister_inflight(did) is None:
                return                   # the watchdog resolved these
            dispatch_s = time.monotonic() - t0
            n = 0
            for j, r in enumerate(part):
                if r._resolve("result", value=out[j]):
                    n += 1
            for r in part:
                telemetry.span_event("serve.queue_wait",
                                     max(0.0, t0 - r.arrival),
                                     trace=r.trace_id, hist=True,
                                     bucket=bucket)
            telemetry.span_event("serve.dispatch", dispatch_s, hist=True,
                                 bucket=bucket, n=len(part))
            depth = self._q.qsize()
            telemetry.inc("serve.dispatches")
            telemetry.inc("serve.dispatches.b%d" % bucket)
            telemetry.inc("serve.results", n)
            telemetry.gauge("serve.queue_depth", depth)
            telemetry.event(
                "serve", "batch", bucket=bucket, n=len(part),
                fill_pct=round(100.0 * len(part) / bucket, 1),
                queue_depth=depth,
                wait_ms=round((t0 - min(r.arrival for r in part)) * 1e3, 3),
                dispatch_ms=round(dispatch_s * 1e3, 3))
            return

    def _fail_requests(self, reqs, reason):
        for r in reqs:
            if r._resolve("error", reason=reason):
                telemetry.inc("serve.errors")
        telemetry.event("serve", "error", reason=reason, n=len(reqs))

    def _quarantine(self, bucket, error):
        with self._lock:
            fresh = bucket not in self._quarantined
            self._quarantined.add(bucket)
        if fresh:
            telemetry.inc("serve.quarantines")
            telemetry.event("serve", "quarantine", bucket=bucket,
                            error=repr(error))
        self._set_state(DEGRADED)

    def reset_quarantine(self):
        """Re-admit quarantined buckets (operator knob)."""
        with self._lock:
            had = sorted(self._quarantined)
            self._quarantined.clear()
        if had:
            telemetry.event("serve", "quarantine_reset", buckets=had)
        return had

    # -- watchdog thread -------------------------------------------------
    def _watchdog_loop(self):
        cfg = self._cfg
        while not self._stop.wait(cfg.watchdog_s):
            now = time.monotonic()
            stuck = []
            with self._lock:
                for did in list(self._inflight):
                    rec = self._inflight[did]
                    if now - rec["start"] >= cfg.dispatch_timeout_s:
                        stuck.append(self._inflight.pop(did))
            for rec in stuck:
                self._on_stuck_dispatch(rec, now)
            self._drain_if_dispatcherless()
            self._maybe_recover()

    def _drain_if_dispatcherless(self):
        """Past the respawn budget nothing consumes the dispatch queue:
        the watchdog fails its batches every tick instead."""
        with self._lock:
            gone = self._dispatcher_gone
        if not gone:
            return
        while True:
            try:
                batch = self._dq.get_nowait()
            except queue.Empty:
                return
            self._fail_requests(batch, "no dispatcher available "
                                       "(watchdog respawn budget exhausted)")

    def _on_stuck_dispatch(self, rec, now):
        """Resolve a hung dispatch's requests, respawn a dispatcher
        (bounded) and degrade."""
        n = 0
        for r in rec["reqs"]:
            if r._resolve("timeout", reason="dispatch watchdog"):
                n += 1
        telemetry.inc("serve.timeouts", n)
        telemetry.inc("serve.watchdog_fires")
        with self._lock:
            can_respawn = self._respawns < self._cfg.max_respawns
            if can_respawn:
                self._respawns += 1
                self._gen += 1
                gen = self._gen
                if self._dispatcher is not None:
                    self._retired.append(self._dispatcher)
            else:
                self._dispatcher_gone = True
        telemetry.event("serve", "watchdog", bucket=rec["bucket"], n=n,
                        age_ms=round((now - rec["start"]) * 1e3, 3),
                        respawned=bool(can_respawn))
        if can_respawn:
            self._spawn_dispatcher(gen)
        self._set_state(DEGRADED)

    def _maybe_recover(self):
        """DEGRADED -> READY once the queue is below the resume mark, no
        bucket is quarantined and a dispatcher exists."""
        with self._lock:
            st = self._state
            quarantined = bool(self._quarantined)
            gone = self._dispatcher_gone
        if st == DEGRADED and not quarantined and not gone \
                and self._q.qsize() <= self._cfg.resume_depth:
            self._set_state(READY)

    # -- introspection ---------------------------------------------------
    def steady_state_recompiles(self):
        """``{fn: extra warm-ups}`` for this server's buckets since
        :meth:`start`; empty in a healthy steady state."""
        with self._lock:
            baseline = dict(self._compile_baseline)
        deltas = telemetry.compile_deltas(baseline)
        return {k: v for k, v in deltas.items()
                if k.startswith("serve.%s." % self.name)}

    def stats(self):
        with self._lock:
            return {"state": self._state,
                    "queue_depth": self._q.qsize(),
                    "batcher_pending": self._pending_n,
                    "inflight": len(self._inflight),
                    "quarantined": sorted(self._quarantined),
                    "respawns": self._respawns,
                    "buckets": list(self._cfg.buckets)}
