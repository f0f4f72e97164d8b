"""Port parity and failure envelope of ``mxnet_tpu_torch.serve`` on the CPU.

The port's InferenceServer, serving a narrow ResNetV1 on ``mx.cpu()``
with buckets (1, 4), returns the rows the JAX package's
``AotModel.from_block(...).compile_all([4]).run(4, x)`` computes on the
same weights and batch (float32, rel 1e-4 as in test_torch_resnet.py).
The remaining tests are small forms of tests/test_serve.py's cases on a
cheap matrix-product model.
"""
import time

import numpy as onp
import torch

from mxnet_tpu.serve import AotModel as JaxAotModel
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import serve, telemetry
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.gluon.utils import load_jax_params
from mxnet_tpu_torch.serve import AotModel, InferenceServer, ServeConfig
from test_torch_parity import NARROW, jax_narrow, random_weights

FEAT = (8,)
W = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3) * 0.1


def _cfg(**kw):
    base = dict(buckets=(1, 2, 4), max_queue=16, batch_wait_ms=2.0,
                default_deadline_ms=2000.0, dispatch_timeout_ms=2000.0,
                watchdog_interval_ms=15.0)
    base.update(kw)
    return ServeConfig(**base)


def _server(fn=None, **kw):
    model = AotModel(fn or (lambda x: x @ W), feature_shape=FEAT,
                     ctx=mxt.cpu())
    return InferenceServer(model, config=_cfg(**kw))


def _rows(n):
    return [onp.full(FEAT, i, "float32") for i in range(n)]


def test_resnet_rows_match_jax_aot_model():
    arrays = random_weights(3)
    jnet = jax_narrow(arrays)
    x = onp.random.RandomState(5).uniform(-1, 1, (4, 3, 32, 32)) \
        .astype("float32")
    want = onp.asarray(JaxAotModel.from_block(jnet, (3, 32, 32))
                       .compile_all([4]).run(4, x))

    net = tresnet.ResNetV1(tresnet.BottleneckV1, *NARROW, classes=10)
    net.initialize(ctx=mxt.cpu())
    load_jax_params(net, arrays)
    srv = InferenceServer(net, feature_shape=(3, 32, 32),
                          config=_cfg(buckets=(1, 4)), name="narrow")
    srv.start()
    try:
        handles = [srv.submit(row) for row in x]
        outs = [h.outcome(timeout=10.0) for h in handles]
        assert all(o is not None and o[0] == "result" for o in outs), outs
        got = onp.stack([o[1] for o in outs])
        onp.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        assert srv.steady_state_recompiles() == {}
    finally:
        srv.close()


def test_zero_steady_state_recompiles_and_results():
    srv = _server()
    srv.start()
    try:
        assert srv.state() == serve.READY
        rows = _rows(11)
        outs = [h.outcome(timeout=5.0) for h in [srv.submit(r) for r in rows]]
        assert all(o is not None and o[0] == "result" for o in outs)
        for r, o in zip(rows, outs):
            onp.testing.assert_allclose(o[1], r @ W.numpy(), rtol=1e-5)
        assert srv.steady_state_recompiles() == {}
        menu = {k: v for k, v in telemetry.compile_counts().items()
                if k.startswith("serve.%s." % srv.name)}
        assert len(menu) == 3 and set(menu.values()) == {1}
    finally:
        srv.close()


def test_expired_request_dropped_before_dispatch():
    srv = _server()
    srv.start()
    try:
        d0 = telemetry.counter("serve.dispatches")
        drops0 = telemetry.counter("serve.deadline_drops")
        out = srv.submit(_rows(1)[0], deadline_ms=0.0).outcome(timeout=5.0)
        assert out is not None and out[0] == "timeout"
        assert telemetry.counter("serve.deadline_drops") == drops0 + 1
        assert telemetry.counter("serve.dispatches") == d0
    finally:
        srv.close()


def test_queue_full_is_reject_not_block():
    srv = _server(max_queue=2, batch_wait_ms=200.0)
    srv.start()
    try:
        t0 = time.monotonic()
        handles = [srv.submit(r, deadline_ms=4000.0) for r in _rows(20)]
        assert time.monotonic() - t0 < 1.0          # no blocked producer
        outs = [h.outcome(timeout=8.0) for h in handles]
        assert all(o is not None for o in outs)
        assert any(o[0] == "reject" and o[2] == "queue_full" for o in outs)
    finally:
        srv.close()


def test_bad_shape_and_not_ready_reject():
    srv = _server()
    assert srv.submit(_rows(1)[0]).outcome(timeout=1.0) == \
        ("reject", None, "not_ready")
    srv.start()
    try:
        kind, _, reason = srv.submit(onp.zeros(3, "float32")).outcome(1.0)
        assert kind == "reject" and "bad_shape" in reason
    finally:
        srv.close()


def test_drain_completes_accepted_and_joins_threads():
    srv = _server()
    srv.start()
    handles = [srv.submit(r) for r in _rows(6)]
    assert srv.close(timeout=10.0)
    outs = [h.outcome(timeout=1.0) for h in handles]
    assert all(o is not None and o[0] == "result" for o in outs)
    assert srv.state() == serve.DRAINING
    for t in (srv._batcher, srv._watchdog, srv._dispatcher):
        assert t is not None and not t.is_alive()
    assert srv.submit(_rows(1)[0]).outcome(1.0) == ("reject", None, "draining")
    assert srv.close(timeout=1.0)                 # idempotent


def test_quarantine_replans_onto_smaller_buckets():
    """A model whose bucket-4 call raises: after the retry budget the
    bucket is quarantined and the batch completes on [2, 2]."""
    def fn(x):
        if x.shape[0] == 4 and calls["warm"]:
            raise RuntimeError("bucket 4 broken")
        return x @ W

    calls = {"warm": False}
    srv = _server(fn, batch_wait_ms=50.0, max_retries=1)
    srv.start()
    calls["warm"] = True
    try:
        handles = [srv.submit(r) for r in _rows(4)]
        outs = [h.outcome(timeout=5.0) for h in handles]
        assert all(o is not None and o[0] == "result" for o in outs), outs
        assert srv.stats()["quarantined"] == [4]
        assert srv.state() == serve.DEGRADED
        assert srv.reset_quarantine() == [4]
    finally:
        srv.close()
