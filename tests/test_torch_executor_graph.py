"""The captured Executor on the CPU: ``Executor.forward``/``backward``
through one ``cuda_graph.CapturedPair`` a key (a forward-only ``Captured``
for ``is_train=False``), ``Module.fit`` and ``BucketingModule`` on top of
it, against the JAX package's jitted Executor and its ``jax.vjp``, from
the same numpy weights and batches.  On the CPU the pair runs its body
with autograd on the bound arrays each call: the protocol of the card
without the capture (``chip_smoke.py``'s compiled training phase holds the
replays there, to the bits of the eager walk).

The graph: ``FullyConnected`` + ``BatchNorm`` + ``Activation`` +
``FullyConnected`` + ``SoftmaxOutput``, batch 4 of 6 features, float32.

- Three training steps of the bound Executor (forward, backward, the
  weights moved by the gradients through ``copy_params_from``): outputs,
  gradients and moving statistics within rtol 1e-5, atol 1e-6 (the same
  float32 arithmetic, summed in another order); one pair built, reported
  once to ``telemetry.record_compile``; the bound arrays keep their
  storage; a predict forward is a key of its own, within the same
  tolerance.
- ``grad_req="add"`` with head gradients: two backwards add up, as the
  JAX package's.
- ``reshape`` makes an executor with graphs of its own: two pending
  forwards (an executor and a same-shape reshape of it, which shares its
  arrays; or a reshape to another batch) each give the JAX package's
  gradients of their own batch, also when the other one was fed between
  a forward and its backward, as the JAX package's vjp keeps the values
  its forward saw.  A copy into a weight between a forward and its
  backward makes the backward raise, where the JAX package differentiates
  the forward's weights (the one divergence, ``ROADMAP.md`` queue 3).
- ``Module.forward`` over batches of 4, 2 and 4 rows: the outputs within
  rtol 1e-5, atol 1e-6 of the JAX package's, and the third batch finds
  the executor, and the pair, of the first (no build).
- ``Module.fit`` (2 epochs of 4 batches, SGD with momentum 0.9 and wd
  1e-4): weights and moving statistics within a relative L2 error of 1e-5
  of the JAX package's (as tests/test_torch_module.py), one pair built in
  the 8 steps; ``fc1_bias``, whose gradient BatchNorm makes 0 but for
  rounding, within 1e-6 of 0 in both.
- ``BucketingModule`` over two buckets (an ``Embedding``'s mean over 4 or
  6 positions feeding the graph above): 4 steps in turns, the weights
  within 1e-5 of the JAX package's after each, one pair a bucket, none
  built after a bucket's first step.
"""
import numpy as onp
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import telemetry
from test_torch_symbol import _both, _rel

F32 = dict(rtol=1e-5, atol=1e-6)
REL = 1e-5
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
BATCH, FEAT, CLASSES = 4, 6, 3


def _fc_bn(pkg, data=None):
    s = pkg.sym
    net = s.FullyConnected(data if data is not None else s.var("data"),
                           num_hidden=8, name="fc1")
    net = s.BatchNorm(net, fix_gamma=False, name="bn1")
    net = s.Activation(net, act_type="relu", name="relu1")
    net = s.FullyConnected(net, num_hidden=CLASSES, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


def _weights(sym, seed):
    rs = onp.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(BATCH, FEAT))
    args = {n: rs.uniform(-0.5, 0.5, s).astype("float32")
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (rs.uniform(0.5, 1.5, s) if "var" in n
               else rs.uniform(-0.1, 0.1, s)).astype("float32")
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _batches(seed, n):
    rs = onp.random.RandomState(seed)
    return [(rs.uniform(-1, 1, (BATCH, FEAT)).astype("float32"),
             rs.randint(0, CLASSES, BATCH).astype("float32"))
            for _ in range(n)]


def _bind(pkg, sym, args, aux, grad_req="write"):
    nd = pkg.nd
    shapes = dict(data=(BATCH, FEAT), softmax_label=(BATCH,))
    full = dict({k: nd.array(v) for k, v in args.items()},
                **{k: nd.zeros(v) for k, v in shapes.items()})
    grads = {k: nd.zeros(v.shape) for k, v in args.items()}
    return sym.bind(pkg.cpu(), full, args_grad=grads, grad_req=grad_req,
                    aux_states={k: nd.array(v) for k, v in aux.items()})


def _host(arrays):
    return {k: v.asnumpy() for k, v in arrays.items() if v is not None}


def _executor_steps(pkg, sym, args, aux, batches):
    """Forward, backward and an SGD move of the weights a batch: the
    outputs and gradients of each step, the executor."""
    ex = _bind(pkg, sym, args, aux)
    w = {k: v.copy() for k, v in args.items()}
    outs, grads = [], []
    for x, y in batches:
        ex.forward(is_train=True, data=pkg.nd.array(x),
                   softmax_label=pkg.nd.array(y))
        ex.backward()
        outs.append(ex.outputs[0].asnumpy())
        g = _host({k: ex.grad_dict[k] for k in args})
        grads.append(g)
        w = {k: w[k] - 0.1 * g[k] for k in w}
        ex.copy_params_from({k: pkg.nd.array(v) for k, v in w.items()})
    return outs, grads, ex


@pytest.fixture(scope="module")
def steps():
    j, t = _both(_fc_bn)
    args, aux = _weights(j, 0)
    batches = _batches(1, 3)
    want = _executor_steps(mx, j, args, aux, batches)
    with mxt.cpu():
        got = _executor_steps(mxt, t, args, aux, batches)
    return want, got, (j, t, args, aux)


def test_executor_steps_through_one_pair_as_jax(steps):
    (jouts, jgrads, jex), (touts, tgrads, tex), (j, t, args, aux) = steps
    for a, b in zip(touts, jouts):
        onp.testing.assert_allclose(a, b, **F32)
    for ga, gb in zip(tgrads, jgrads):
        for k in gb:
            onp.testing.assert_allclose(ga[k], gb[k], err_msg=k, **F32)
    for k, v in _host(jex.aux_dict).items():
        onp.testing.assert_allclose(tex.aux_dict[k].asnumpy(), v, err_msg=k,
                                    **F32)
    (key, (_, pair)), = tex._graphs.items()
    assert key[:2] == (True, True)
    assert not pair.busy and pair.gen == 3
    assert telemetry.compile_counts()["Executor[%x]" % id(tex)] == 1
    x, _ = _batches(2, 1)[0]
    ptrs = [a._data.data_ptr() for a in tex.arg_arrays]
    with mxt.cpu():
        tex.forward(is_train=False, data=mxt.nd.array(x))
    jex.forward(is_train=False, data=mx.nd.array(x))
    onp.testing.assert_allclose(tex.outputs[0].asnumpy(),
                                jex.outputs[0].asnumpy(), **F32)
    assert len(tex._graphs) == 2
    assert [a._data.data_ptr() for a in tex.arg_arrays] == ptrs


def test_grad_req_add_and_head_grads_as_jax():
    j, t = _both(_fc_bn)
    args, aux = _weights(j, 3)
    (x, y), = _batches(4, 1)
    heads = onp.random.RandomState(5).randn(BATCH, CLASSES) \
        .astype("float32")
    got = {}
    for key, pkg, sym in (("jax", mx, j), ("port", mxt, t)):
        with pkg.cpu():
            ex = _bind(pkg, sym, args, aux, grad_req="add")
            for _ in range(2):
                ex.forward(is_train=True, data=pkg.nd.array(x),
                           softmax_label=pkg.nd.array(y))
                ex.backward(out_grads=[pkg.nd.array(heads)])
            got[key] = _host({k: ex.grad_dict[k] for k in args})
    for k in args:
        onp.testing.assert_allclose(got["port"][k], got["jax"][k],
                                    err_msg=k, **F32)
        assert onp.abs(got["port"][k]).max() > 0


def test_reshape_takes_graphs_of_its_own_and_forwards_keep_their_feeds(
        steps):
    _, _, (j, t, args, aux) = steps
    (x, y), (x2, y2) = _batches(6, 2)
    got = []
    with mxt.cpu():
        ex = _bind(mxt, t, args, aux)
        twin = ex.reshape(data=(BATCH, FEAT), softmax_label=(BATCH,))
        assert twin._graphs is not ex._graphs
        # the twin shares every bound array: one feed serves both forwards
        ex.forward(is_train=True, data=mxt.nd.array(x),
                   softmax_label=mxt.nd.array(y))
        twin.forward(is_train=True)
        pairs = [p for e in (ex, twin) for _, p in e._graphs.values()]
        assert len(pairs) == 2 and all(p.busy for p in pairs)
        for e in (twin, ex):
            e.backward()
            got.append((0, _host({k: e.grad_dict[k] for k in args})))
        assert not any(p.busy for p in pairs)
        # a feed into the shared arrays between a forward and its
        # backward: each backward differentiates its own forward's batch
        ex.forward(is_train=True)
        twin.forward(is_train=True, data=mxt.nd.array(x2),
                     softmax_label=mxt.nd.array(y2))
        ex.backward()
        got.append((0, _host({k: ex.grad_dict[k] for k in args})))
        twin.backward()
        got.append((1, _host({k: twin.grad_dict[k] for k in args})))
        # a reshape to other shapes feeds arrays of its own
        small = ex.reshape(data=(2, FEAT), softmax_label=(2,))
        assert small._graphs is not ex._graphs
        ex.forward(is_train=True, data=mxt.nd.array(x),
                   softmax_label=mxt.nd.array(y))
        probs = small.forward(is_train=True, data=mxt.nd.array(x[:2]),
                              softmax_label=mxt.nd.array(y[:2]))[0]
        probs = probs.asnumpy()
        ex.backward()
        got.append((0, _host({k: ex.grad_dict[k] for k in args})))
        assert len(small._graphs) == 1 and len(ex._graphs) == 1
        # the divergence: a copy into a weight after the forward
        ex.forward(is_train=True)
        ex.copy_params_from({"fc1_bias": mxt.nd.zeros((8,))})
        with pytest.raises(mxt.base.MXNetError, match="forward again"):
            ex.backward()
    want = []
    for xb, yb in ((x, y), (x2, y2)):
        jex = _bind(mx, j, args, aux)
        jex.forward(is_train=True, data=mx.nd.array(xb),
                    softmax_label=mx.nd.array(yb))
        jex.backward()
        want.append(_host({k: jex.grad_dict[k] for k in args}))
    for b, g in got:
        for k in args:
            onp.testing.assert_allclose(g[k], want[b][k], err_msg=k, **F32)
    assert not all(onp.allclose(want[0][k], want[1][k]) for k in args)
    jsmall = _bind(mx, j, args, aux).reshape(data=(2, FEAT),
                                             softmax_label=(2,))
    jsmall.forward(is_train=True, data=mx.nd.array(x[:2]),
                   softmax_label=mx.nd.array(y[:2]))
    onp.testing.assert_allclose(probs, jsmall.outputs[0].asnumpy(), **F32)


def test_module_fit_through_one_pair_matches_jax(steps):
    _, _, (j, _, args, aux) = steps
    X = onp.concatenate([x for x, _ in _batches(7, 4)])
    Y = onp.concatenate([y for _, y in _batches(7, 4)])
    got = {}
    for key, pkg in (("jax", mx), ("port", mxt)):
        with pkg.name.NameManager(), pkg.cpu():
            sym = _fc_bn(pkg)
            it = pkg.io.NDArrayIter(X, Y, batch_size=BATCH,
                                    label_name="softmax_label")
            mod = pkg.mod.Module(sym, context=pkg.cpu())
            before = telemetry.compile_counts()
            mod.fit(it, num_epoch=2, optimizer="sgd", optimizer_params=SGD,
                    arg_params={k: pkg.nd.array(v) for k, v in args.items()},
                    aux_params={k: pkg.nd.array(v) for k, v in aux.items()})
            built = telemetry.compile_deltas(before)
            arg, aux2 = mod.get_params()
            got[key] = (_host(arg), _host(aux2), built, mod)
    for i in (0, 1):
        for k, v in got["jax"][i].items():
            if k == "fc1_bias":
                # BatchNorm takes the mean out: its gradient is 0 but for
                # rounding, and the bias stays within 1e-6 of 0
                assert onp.abs(got["port"][i][k]).max() <= 1e-6
                assert onp.abs(v).max() <= 1e-6
                continue
            assert _rel(got["port"][i][k], v) <= REL, k
    mod = got["port"][3]
    assert got["port"][2] == {"Executor[%x]" % id(mod._exec): 1}
    (_, pair), = mod._exec._graphs.values()
    assert pair.gen == 8


def test_module_reshape_back_finds_its_executor_and_graphs(steps):
    _, _, (j, _, args, aux) = steps
    rows = (BATCH, 2, BATCH)
    rs = onp.random.RandomState(11)
    batches = [(rs.uniform(-1, 1, (n, FEAT)).astype("float32"),
                rs.randint(0, CLASSES, n).astype("float32")) for n in rows]
    got = {}
    for key, pkg in (("jax", mx), ("port", mxt)):
        with pkg.name.NameManager(), pkg.cpu():
            mod = pkg.mod.Module(_fc_bn(pkg), context=pkg.cpu())
            mod.bind(data_shapes=[("data", (BATCH, FEAT))],
                     label_shapes=[("softmax_label", (BATCH,))])
            mod.init_params(
                arg_params={k: pkg.nd.array(v) for k, v in args.items()},
                aux_params={k: pkg.nd.array(v) for k, v in aux.items()})
            outs, built, execs = [], [], []
            for x, y in batches:
                before = telemetry.compile_counts()
                mod.forward(pkg.io.DataBatch([pkg.nd.array(x)],
                                             [pkg.nd.array(y)]),
                            is_train=True)
                mod.backward()
                built.append(sum(telemetry.compile_deltas(before).values()))
                outs.append(mod.get_outputs()[0].asnumpy())
                execs.append(mod._exec)
            got[key] = (outs, built, execs)
    for a, b in zip(got["port"][0], got["jax"][0]):
        onp.testing.assert_allclose(a, b, **F32)
    outs, built, execs = got["port"]
    assert built == [1, 1, 0]
    assert execs[2] is execs[0] and execs[1] is not execs[0]


def _bucket_gen(pkg):
    def gen(seq):
        s = pkg.sym
        emb = s.Embedding(s.var("data"), input_dim=11, output_dim=FEAT,
                          name="embed")
        return (_fc_bn(pkg, s.mean(emb, axis=1)), ("data",),
                ("softmax_label",))
    return gen


def test_bucketing_module_one_pair_a_bucket_matches_jax():
    with mx.name.NameManager():
        j = _bucket_gen(mx)(6)[0]
    rs = onp.random.RandomState(8)
    arg_shapes, _, aux_shapes = j.infer_shape(data=(BATCH, 6))
    args = {n: rs.uniform(-0.5, 0.5, s).astype("float32")
            for n, s in zip(j.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    buckets = (4, 6, 4, 6)
    got = {}
    for key, pkg in (("jax", mx), ("port", mxt)):
        rs = onp.random.RandomState(9)
        with pkg.name.NameManager(), pkg.cpu():
            bm = pkg.mod.BucketingModule(_bucket_gen(pkg),
                                         default_bucket_key=6,
                                         context=pkg.cpu())
            bm.bind(data_shapes=[("data", (BATCH, 6))],
                    label_shapes=[("softmax_label", (BATCH,))])
            bm.init_params(arg_params={k: pkg.nd.array(v)
                                       for k, v in args.items()})
            bm.init_optimizer(optimizer="sgd", optimizer_params=SGD)
            seen, after = [], []
            for b in buckets:
                x = rs.randint(0, 11, (BATCH, b)).astype("float32")
                y = rs.randint(0, CLASSES, BATCH).astype("float32")
                batch = pkg.io.DataBatch(
                    [pkg.nd.array(x)], [pkg.nd.array(y)], bucket_key=b,
                    provide_data=[pkg.io.DataDesc("data", (BATCH, b))],
                    provide_label=[pkg.io.DataDesc("softmax_label",
                                                   (BATCH,))])
                before = telemetry.compile_counts()
                bm.forward(batch, is_train=True)
                bm.backward()
                bm.update()
                after.append(sum(telemetry.compile_deltas(before).values()))
                seen.append(_host(bm.get_params()[0]))
            got[key] = (seen, after, bm)
    for tstep, jstep in zip(got["port"][0], got["jax"][0]):
        for k, v in jstep.items():
            assert _rel(tstep[k], v) <= REL, k
    bm = got["port"][2]
    assert got["port"][1] == [1, 1, 0, 0]
    for b in (4, 6):
        (_, pair), = bm._buckets[b]._exec._graphs.values()
        assert pair.gen == 2
