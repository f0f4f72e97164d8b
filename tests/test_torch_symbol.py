"""Port parity: the Symbolic API of ``mxnet_tpu_torch`` (``mx.sym``, shape
inference, the Executor, ``CONV_BN_FOLD``) against the JAX package's, on
the CPU, from the same numpy inputs and weights.

- Signatures: for every op both registries have, the port's symbol layer
  reads the JAX package's input slots (``_sig_input_params``) and
  attributes (``_sig_params``) from the op's signature, and treats the
  same ops as random nodes.  Exact.
- JSON: the same construction gives byte-identical ``tojson`` in both
  packages (the MLP, a graph of ``AttrScope``, variable attributes and
  arithmetic, the card's symbolic BERT encoder, ``train_imagenet.py``'s
  ResNet-50 against ``example/image_classification/symbols.py`` itself,
  the bucketing LM against ``example/rnn/bucketing_lm/train.py``'s
  ``sym_gen``), and each package loads the other's JSON back to the same
  bytes.
- ``infer_shape``: the same argument, output and auxiliary shapes,
  through the three kernel ops too (``flash_attention_bshd``, ``LayerNorm``
  with ``MXNET_FUSED_LAYERNORM=1``, ``BatchNormAddRelu``), whose wrappers
  answer ``meta`` tensors with their shape rule: the plain versions are
  patched to raise while the port infers.
- The Executor against the JAX package's: an MLP, a convolution +
  BatchNorm net (outputs, gradients, weights and moving statistics after
  two training steps) and a 2-layer encoder of the card's graph at T 128
  (``MXNET_FUSED_LAYERNORM=1``, so the kernels' plain versions run).
  Outputs within a relative L2 error of 1e-5, gradients within 1e-4 (the
  same float32 arithmetic summed in another order; 1e-7 to 3e-6
  measured); ``grad_req="add"``, ``out_grads`` and ``reshape`` likewise.
- ``CONV_BN_FOLD``: the folded graph's JSON is the JAX package's, its
  folded parameters within 1e-6, its inference output within 1e-5 of the
  graph it came from.
- Dropout: at p = 0 the output is the input exactly in training; at p =
  0.5 the kept share of 40,000 draws within 5 standard errors of 1/2 and
  every kept value doubled.
"""
import importlib.util
import inspect
import os
import sys

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu import symbol as jsym
from mxnet_tpu.ops.registry import get_op as jget, list_ops as jlist
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.ops import attention as TA
from mxnet_tpu_torch.ops import fused_norm as TFN
from mxnet_tpu_torch.ops import layernorm as TLN
from mxnet_tpu_torch.ops.registry import get_op as tget, list_ops as tlist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

OUT_REL, GRAD_REL = 1e-5, 1e-4


def _example(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(build):
    """``build(pkg)`` in each package under a fresh NameManager."""
    with mx.name.NameManager():
        j = build(mx)
    with mxt.name.NameManager():
        t = build(mxt)
    return j, t


def _rel(got, want):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    den = onp.sqrt((want ** 2).sum())
    return onp.sqrt(((got - want) ** 2).sum()) / (den if den else 1.0)


# -- signatures --------------------------------------------------------------

def test_symbol_layer_reads_the_jax_signatures_of_every_shared_op():
    shared = sorted(set(jlist()) & set(tlist()))
    assert len(shared) >= 290
    bad = []
    for n in shared:
        jo, to = jget(n), tget(n)
        got = (tsym._sig_params(to), tsym._sig_input_params(to),
               tsym._is_random(to), to.num_outputs)
        want = (jsym._sig_params(jo), jsym._sig_input_params(jo),
                jo.needs_rng, jo.num_outputs)
        if got != want:
            bad.append((n, got, want))
    assert bad == []


def test_builtin_bound_ops_take_the_jax_parameter_names():
    for n, names in (("broadcast_add", ["args", "out", "where"]),
                     ("_div", ["x1", "x2"]), ("abs", ["x"]),
                     ("arctan2", ["x1", "x2"]), ("maximum",
                                                 ["args", "out", "where"])):
        assert list(inspect.signature(tget(n).fn).parameters) == names, n
    with mxt.cpu():
        a, b = mxt.nd.array([[1.0, -2.0]]), mxt.nd.array([[3.0, 4.0]])
        onp.testing.assert_array_equal(mxt.nd.broadcast_add(a, b).asnumpy(),
                                       [[4.0, 2.0]])
        onp.testing.assert_array_equal(mxt.nd.maximum(a, b).asnumpy(),
                                       [[3.0, 4.0]])
        onp.testing.assert_allclose(mxt.nd.hypot(a, b).asnumpy(),
                                    [[10 ** 0.5, 20 ** 0.5]], rtol=1e-6)


def test_ufunc_bound_ops_take_no_symbol_inputs_as_in_the_jax_package():
    """A fault of the reference, followed: ``jnp.add`` and the other ufuncs
    have no named slots, so ``mx.sym.broadcast_add(a, b)`` raises in both
    packages (MXNet takes it); ``a + b`` builds the same node."""
    for pkg in (mx, mxt):
        a, b = pkg.sym.var("a"), pkg.sym.var("b")
        with pytest.raises(TypeError, match="too many Symbol inputs"):
            pkg.sym.broadcast_add(a, b)
        assert (a + b).list_arguments() == ["a", "b"]
        assert pkg.sym.elemwise_div(a, b).list_arguments() == ["a", "b"]


def test_initializer_takes_a_variables_init_attribute():
    """A variable made with ``init=`` is filled by that initializer, as
    the JAX package's ``Initializer.__call__`` does (the port ignored it
    before this slice and raised on names of no known pattern)."""
    shapes = {}
    for pkg in (mx, mxt):
        with pkg.name.NameManager(), pkg.cpu():
            v = pkg.sym.var("lstm_parameters", shape=(4, 3),
                            init=pkg.init.Constant(0.25))
            desc = pkg.init.InitDesc("lstm_parameters",
                                     v.attr_dict()["lstm_parameters"])
            arr = pkg.nd.zeros((4, 3))
            pkg.init.Xavier()(desc, arr)
            shapes[pkg] = arr.asnumpy()
    onp.testing.assert_array_equal(shapes[mxt], shapes[mx])
    onp.testing.assert_array_equal(shapes[mxt], onp.full((4, 3), 0.25))


# -- graphs, JSON and shapes -------------------------------------------------

def _mlp(pkg, hidden=8, classes=3):
    s = pkg.sym
    net = s.FullyConnected(s.var("data"), num_hidden=hidden, name="fc1")
    net = s.Activation(net, act_type="relu", name="relu1")
    net = s.FullyConnected(net, num_hidden=classes, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


def _conv_bn(pkg):
    s = pkg.sym
    net = s.Convolution(s.var("data"), kernel=(3, 3), pad=(1, 1),
                        num_filter=4, name="conv0")
    net = s.BatchNorm(net, fix_gamma=False, name="bn0")
    net = s.Activation(net, act_type="relu", name="relu0")
    net = s.Pooling(net, global_pool=True, pool_type="avg", kernel=(2, 2),
                    name="pool0")
    net = s.FullyConnected(s.Flatten(net), num_hidden=5, name="fc0")
    return s.SoftmaxOutput(net, name="softmax")


def _attrs_graph(pkg):
    s = pkg.sym
    with pkg.AttrScope(ctx_group="dev1"):
        x = s.var("x", lr_mult=2.0, wd_mult=0.5, shape=(2, 3),
                  dtype="float32", init=pkg.init.Xavier())
        y = s.var("y")
    z = (x * 2 + y) / (1 - y) ** 2 - x
    w = s.FullyConnected(z, num_hidden=4, attr={"foo": "bar"})
    return s.Group([w, s.relu(x), s.Concat(x, y, dim=1),
                    s.add_n(x, y, x), s.stack(x, y, axis=0)])


def _encoder(pkg, layers=2):
    return cs.bert_symbol(pkg.sym, layers, 32, 4, 64, 50, max_len=128)


ENC_SHAPES = dict(data=(2, 128), position_ids=(2, 128),
                  masked_positions=(6,), softmax_label=(6,))


def _graphs():
    lm_j = _example("example/rnn/bucketing_lm/train.py", "jlm").sym_gen_factory
    res_j = _example("example/image_classification/symbols.py", "jsym")
    return {
        "mlp": lambda pkg: _mlp(pkg),
        "conv_bn": _conv_bn,
        "attrs": _attrs_graph,
        "encoder": _encoder,
        "resnet50": lambda pkg: (res_j.get_resnet(50) if pkg is mx
                                 else cs.resnet_symbol(mxt.sym, 50)),
        "bucketing_lm": lambda pkg: (
            lm_j(11, 6, 8, 4)(12)[0] if pkg is mx
            else cs.bucketing_lm_sym_gen(mxt, 11, 6, 8, 4)(12)[0]),
    }


GRAPHS = ("mlp", "conv_bn", "attrs", "encoder", "resnet50", "bucketing_lm")


@pytest.mark.parametrize("name", GRAPHS)
def test_tojson_is_the_jax_packages_byte_for_byte(name):
    j, t = _both(_graphs()[name])
    assert t.tojson() == j.tojson()
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    assert t.attr_dict() == j.attr_dict()


@pytest.mark.parametrize("name", GRAPHS)
def test_each_package_loads_the_others_json(name):
    j, t = _both(_graphs()[name])
    assert tsym.load_json(j.tojson()).tojson() == j.tojson()
    assert jsym.load_json(t.tojson()).tojson() == t.tojson()


def test_save_and_load_files_across_packages(tmp_path):
    j, t = _both(_encoder)
    t.save(str(tmp_path / "t.json"))
    j.save(str(tmp_path / "j.json"))
    assert open(tmp_path / "t.json").read() == open(tmp_path / "j.json").read()
    assert jsym.load(str(tmp_path / "t.json")).tojson() == j.tojson()
    assert tsym.load(str(tmp_path / "j.json")).tojson() == t.tojson()
    # the write is atomic: nothing but the file is left beside it
    assert sorted(os.listdir(tmp_path)) == ["j.json", "t.json"]


@pytest.mark.parametrize("name, shapes", [
    ("mlp", dict(data=(4, 6))),
    ("conv_bn", dict(data=(2, 3, 8, 8))),
    ("encoder", ENC_SHAPES),
    ("bucketing_lm", dict(data=(4, 12), softmax_label=(4, 12))),
])
def test_infer_shape_matches_jax(name, shapes, monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_LAYERNORM", "1")
    j, t = _both(_graphs()[name])
    want = j.infer_shape(**shapes)
    got = t.infer_shape(**shapes)
    assert [list(map(tuple, g)) for g in got] == \
        [list(map(tuple, w)) for w in want]
    assert t.infer_type(**shapes) == j.infer_type(**shapes)


def _kernel_ops_graph(pkg):
    s = pkg.sym
    q, k, v = (s.var(n) for n in ("q", "k", "v"))
    att = s.contrib.flash_attention_bshd(q, k, v, name="att")
    ln = s.LayerNorm(s.var("x"), name="ln")
    bar = s.contrib.BatchNormAddRelu(s.var("y"), s.var("r"), name="bar")
    return att, ln, bar


def test_infer_shape_through_the_kernel_ops_takes_the_meta_rule(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_LAYERNORM", "1")
    (jatt, jln, jbar), (att, ln, bar) = _both(_kernel_ops_graph)
    qkv = dict(q=(2, 128, 4, 16), k=(2, 128, 4, 16), v=(2, 128, 4, 16))

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on meta tensors")
    for mod, name in ((TA, "_flash_attention_bshd_plain"),
                      (TLN, "_layer_norm_fwd_plain"),
                      (TFN, "fused_bn_add_relu_epilogue_plain")):
        monkeypatch.setattr(mod, name, refuse)
    launches = (TA.BSHD_LAUNCHES, TLN.LAUNCHES, TFN.LAUNCHES)
    assert att.infer_shape(**qkv) == jatt.infer_shape(**qkv)
    assert ln.infer_shape(x=(2, 5, 24)) == jln.infer_shape(x=(2, 5, 24))
    # BatchNormAddRelu has no parameter rule in either package: its gamma
    # and beta stay unknown, so only the partial inference answers
    yr = dict(y=(2, 4, 3, 3), r=(2, 4, 3, 3))
    assert bar.infer_shape_partial(**yr) == jbar.infer_shape_partial(**yr)
    full = dict(yr, bar_gamma=(4,), bar_beta=(4,), bar_moving_mean=(4,),
                bar_moving_var=(4,))
    got = bar.infer_shape(**full)
    assert got == jbar.infer_shape(**full)
    assert got[1] == [(2, 4, 3, 3), (4,), (4,)]
    assert (TA.BSHD_LAUNCHES, TLN.LAUNCHES, TFN.LAUNCHES) == launches


def test_meta_rule_gives_shapes_and_dtypes_of_the_plain_versions():
    m = dict(device="meta")
    q = torch.empty(2, 130, 3, 40, dtype=torch.bfloat16, **m)
    o, lse = TA.flash_attention_bshd_fwd(q, q, q)
    assert (o.shape, o.dtype, lse.shape, lse.dtype) == (
        q.shape, q.dtype, (2, 3, 130), torch.float32)
    x = torch.empty(7, 24, dtype=torch.float16, **m)
    g = torch.empty(24, dtype=torch.float32, **m)
    y, mu, rstd = TLN.layer_norm_fwd(x, g, g, 1e-5)
    assert (y.dtype, y.shape, mu.shape) == (torch.float32, (7, 24), (7, 1))
    xb = torch.empty(2, 4, 3, 3, **m)
    assert TFN.fused_bn_add_relu_epilogue(
        xb, torch.empty(4, **m), torch.empty(4, **m), xb, 1).shape == \
        xb.shape


# -- the Executor ------------------------------------------------------------

def _weights(sym, shapes, seed, ints=None):
    """Random float32 arrays for every argument and auxiliary state;
    ``ints`` maps argument names to (high, array) of integer ids."""
    rs = onp.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {n: rs.uniform(-0.5, 0.5, s).astype("float32")
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    for n, v in (ints or {}).items():
        args[n] = v
    aux = {n: (rs.uniform(0.5, 1.5, s) if "var" in n
               else rs.uniform(-0.1, 0.1, s)).astype("float32")
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _bind(pkg, sym, args, aux, grad_req="write", **kw):
    nd = pkg.nd
    return sym.bind(pkg.cpu(), {k: nd.array(v) for k, v in args.items()},
                    args_grad={k: nd.zeros(v.shape) for k, v in args.items()},
                    grad_req=grad_req,
                    aux_states={k: nd.array(v) for k, v in aux.items()}, **kw)


def _run_both(build, shapes, seed=0, ints=None, steps=1, grad_req="write",
              out_grads=None, lr=0.0):
    """``steps`` training forwards and backwards (a manual SGD step of
    ``lr`` after each) through each package's Executor: {"jax"|"port":
    (outputs, grads, args, aux)}."""
    j, t = _both(build)
    args, aux = _weights(j, shapes, seed, ints)
    res = {}
    for key, pkg, sym in (("jax", mx, j), ("port", mxt, t)):
        with pkg.cpu():
            ex = _bind(pkg, sym, args, aux, grad_req=grad_req)
            for _ in range(steps):
                outs = ex.forward(is_train=True)
                og = None if out_grads is None else \
                    [pkg.nd.array(g) for g in out_grads]
                ex.backward(og)
                if lr:
                    for n, g in ex.grad_dict.items():
                        if g is not None and n not in (ints or {}) \
                                and n != "softmax_label" and n != "data":
                            ex.arg_dict[n][:] = ex.arg_dict[n] - lr * g
            res[key] = ([o.asnumpy() for o in outs],
                        {n: g.asnumpy() for n, g in ex.grad_dict.items()
                         if g is not None},
                        {n: a.asnumpy() for n, a in ex.arg_dict.items()},
                        {n: a.asnumpy() for n, a in ex.aux_dict.items()})
    return res


def _assert_close(res, skip=()):
    (jo, jg, ja, jx), (to, tg, ta, tx) = res["jax"], res["port"]
    for a, b in zip(to, jo):
        assert _rel(a, b) <= OUT_REL
    assert set(tg) == set(jg)
    for n in jg:
        if n not in skip:
            assert _rel(tg[n], jg[n]) <= GRAD_REL, (n, _rel(tg[n], jg[n]))
    for n in ja:
        assert _rel(ta[n], ja[n]) <= OUT_REL, n
    for n in jx:
        assert _rel(tx[n], jx[n]) <= OUT_REL, n


def _labels(n, k, seed):
    return onp.random.RandomState(seed).randint(0, k, n).astype("float32")


def test_executor_mlp_matches_jax():
    res = _run_both(_mlp, dict(data=(4, 6)),
                    ints={"softmax_label": _labels(4, 3, 1)})
    _assert_close(res)
    # SoftmaxOutput ignores the ones head gradient: p - onehot
    assert abs(res["port"][1]["fc2_bias"]).sum() > 0


def test_executor_grad_req_add_accumulates_as_jax():
    res = _run_both(_mlp, dict(data=(4, 6)), steps=2, grad_req="add",
                    ints={"softmax_label": _labels(4, 3, 1)})
    _assert_close(res)
    one = _run_both(_mlp, dict(data=(4, 6)),
                    ints={"softmax_label": _labels(4, 3, 1)})
    onp.testing.assert_allclose(res["port"][1]["fc1_weight"],
                                2 * one["port"][1]["fc1_weight"], rtol=1e-6)


def _head(pkg):
    s = pkg.sym
    net = s.FullyConnected(s.var("data"), num_hidden=5, name="fc1")
    return s.Group([s.tanh(net), s.sum(net * net, axis=1)])


def test_executor_out_grads_match_jax():
    rs = onp.random.RandomState(7)
    res = _run_both(_head, dict(data=(3, 4)),
                    out_grads=[rs.randn(3, 5).astype("float32"),
                               rs.randn(3).astype("float32")])
    _assert_close(res)


def test_executor_conv_bn_two_training_steps_match_jax():
    res = _run_both(_conv_bn, dict(data=(2, 3, 8, 8)), steps=2, lr=0.1,
                    ints={"softmax_label": _labels(2, 5, 3)})
    # the convolution's bias before BatchNorm has a zero gradient in exact
    # arithmetic: both packages give rounding noise there
    _assert_close(res, skip=("conv0_bias",))
    for key in ("jax", "port"):
        assert abs(res[key][1]["conv0_bias"]).max() < 1e-6
    # the moving statistics moved, in both packages alike
    _, aux0 = _weights(_both(_conv_bn)[0], dict(data=(2, 3, 8, 8)), 0)
    assert not onp.allclose(res["port"][3]["bn0_moving_mean"],
                            aux0["bn0_moving_mean"])


def _enc_ids(seed):
    rs = onp.random.RandomState(seed)
    return {"data": rs.randint(0, 50, (2, 128)).astype("float32"),
            "position_ids": onp.tile(onp.arange(128, dtype="float32"),
                                     (2, 1)),
            "masked_positions": onp.array([3, 17, 64, 130, 200, 255],
                                          "float32"),
            "softmax_label": rs.randint(0, 50, 6).astype("float32")}


def test_executor_encoder_matches_jax(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_LAYERNORM", "1")
    res = _run_both(_encoder, ENC_SHAPES, ints=_enc_ids(5))
    # embedding rows no id reaches get zero gradients in both
    _assert_close(res)


def test_executor_reshape_matches_jax_and_shares_the_weights():
    j, t = _both(_mlp)
    args, aux = _weights(j, dict(data=(4, 6)), 0,
                         {"softmax_label": _labels(4, 3, 1)})
    x2 = onp.random.RandomState(9).rand(2, 6).astype("float32")
    outs = {}
    for key, pkg, sym in (("jax", mx, j), ("port", mxt, t)):
        with pkg.cpu():
            ex = _bind(pkg, sym, args, aux)
            ex2 = ex.reshape(data=(2, 6), softmax_label=(2,))
            assert ex2.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
            outs[key] = ex2.forward(data=pkg.nd.array(x2))[0].asnumpy()
            with pytest.raises(pkg.MXNetError, match="allow_up_sizing"):
                ex.reshape(data=(8, 6), softmax_label=(8,))
    assert outs["port"].shape == (2, 3)
    assert _rel(outs["port"], outs["jax"]) <= OUT_REL


def test_executor_without_gradients_refuses_backward():
    with mxt.cpu():
        ex = _mlp(mxt).simple_bind(ctx=mxt.cpu(), data=(2, 6),
                                   grad_req="null")
        ex.forward(is_train=True)
        with pytest.raises(mxt.MXNetError, match="backward"):
            ex.backward()


# -- CONV_BN_FOLD ------------------------------------------------------------

def test_conv_bn_fold_matches_jax():
    j, t = _both(_conv_bn)
    args, aux = _weights(j, dict(data=(2, 3, 8, 8)), 4,
                         {"softmax_label": _labels(2, 5, 3)})
    assert t.get_backend_symbol("CONV_BN_FOLD").tojson() == \
        j.get_backend_symbol("CONV_BN_FOLD").tojson()
    got = {}
    for key, pkg, sym in (("jax", mx, j), ("port", mxt, t)):
        with pkg.cpu():
            nd = pkg.nd
            fs, fa, fx = pkg.subgraph.optimize_for(
                sym, "CONV_BN_FOLD", {k: nd.array(v) for k, v in args.items()},
                {k: nd.array(v) for k, v in aux.items()})
            assert "BatchNorm" not in fs.tojson()
            plain = _bind(pkg, sym, args, aux).forward(is_train=False)[0]
            folded = fs.bind(pkg.cpu(), fa, aux_states=fx).forward()[0]
            assert _rel(folded.asnumpy(), plain.asnumpy()) <= OUT_REL
            got[key] = {k: v.asnumpy() for k, v in fa.items()}
    assert set(got["port"]) == set(got["jax"])
    for k, v in got["jax"].items():
        onp.testing.assert_allclose(got["port"][k], v, atol=1e-6)


# -- Dropout -----------------------------------------------------------------

def _dropout(pkg, p):
    return pkg.sym.Dropout(pkg.sym.var("data"), p=p, name="drop")


def test_dropout_p0_is_exact_and_p_half_keeps_half():
    x = onp.random.RandomState(0).uniform(1, 2, (200, 200)).astype("float32")
    for pkg in (mx, mxt):
        with pkg.cpu():
            ex = _dropout(pkg, 0.0).bind(pkg.cpu(), {"data": pkg.nd.array(x)})
            onp.testing.assert_array_equal(
                ex.forward(is_train=True)[0].asnumpy(), x)
    with mxt.cpu():
        mxt.random.seed(1)
        ex = _dropout(mxt, 0.5).bind(mxt.cpu(), {"data": mxt.nd.array(x)})
        y = ex.forward(is_train=True)[0].asnumpy()
        onp.testing.assert_array_equal(
            ex.forward(is_train=False)[0].asnumpy(), x)
    kept = y != 0
    n = kept.size
    assert abs(kept.mean() - 0.5) <= 5 * (0.25 / n) ** 0.5
    onp.testing.assert_allclose(y[kept], 2 * x[kept], rtol=1e-6)
