"""Port parity: ``Module``, ``BucketingModule``, ``SequentialModule``, the
checkpoints of ``model.py`` and the callbacks that write them,
``SymbolBlock``, and ``amp.convert_symbol``/``convert_model`` of
``mxnet_tpu_torch`` against the JAX package's, on the CPU, from the same
numpy weights and batches.

- ``Module.fit`` for 2 epochs (SGD, momentum 0.9, wd 1e-4, 4 batches of 4
  an epoch) of an MLP and of a convolution + BatchNorm net: the weights
  and moving statistics after it within a relative L2 error of 1e-5 of
  the JAX package's (8 steps of the same float32 arithmetic summed in
  another order; 1e-7 to 1e-6 measured), the training accuracy the same;
  ``predict`` within 1e-5, ``score`` the same; the input gradients of
  ``inputs_need_grad`` within 1e-4; a batch of another size re-binds and
  predicts within 1e-5.
- Checkpoints: ``save_checkpoint`` files (``do_checkpoint``,
  ``module_checkpoint``) of either package load in the other, and the
  loaded module predicts the saver's outputs within 1e-6 (the same
  weights); the optimizer states of ``module_checkpoint`` resume.
- ``BucketingModule`` on ``example/rnn/bucketing_lm``'s graph over the
  buckets 8, 12 and 16: one step a bucket, the weights within 1e-5 of the
  JAX package's after each; every bucket's Executor holds the default
  bucket's parameter NDArrays, one tensor each.
- ``SequentialModule`` (an MLP split in two, ``auto_wiring``,
  ``take_labels``): one epoch within 1e-5.  A Module over two contexts
  raises, naming the data-parallel waits.
- ``amp.convert_symbol``/``convert_model``: the JAX package's graph, byte
  for byte, for the MLP and the card's encoder; the converted encoder's
  bfloat16 outputs within a relative L2 error of 2e-2 of the JAX
  package's (both round the same ops' outputs to bfloat16, with float32
  sums in another order).
- The reference's faults, as the JAX package shows them: ``amp.init``
  leaves an Executor in float32 where ``mx.nd`` casts; ``Module.bind`` of
  a graph with ``BatchNormAddRelu`` raises ("underdetermined") and its
  Executor never updates the moving statistics; the zoo's ResNet and BERT
  cannot be called on a Symbol; the JAX package's ``SymbolBlock.imports``
  refuses a checkpoint's parameters (the port loads them, as MXNet does).
- ``SymbolBlock.imports`` of a checkpoint gives the Module's forward
  output with the same bits, and the JAX Module's within 1e-5; weights
  reach it through ``load_jax_params`` too.  A ``HybridBlock`` called on
  ``sym.var`` builds the JAX package's graph.
"""
import os
import sys

import numpy as onp
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu_torch.contrib import amp as tamp
from mxnet_tpu_torch.gluon.utils import load_jax_params
from test_torch_symbol import (_both, _conv_bn, _encoder, _enc_ids, _mlp,
                               _rel, _weights, ENC_SHAPES)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

REL = 1e-5
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


@pytest.fixture(autouse=True)
def amp_off():
    yield
    jamp.disable()
    tamp.disable()


def _data(shape, classes, seed, n=16):
    rs = onp.random.RandomState(seed)
    return (rs.uniform(-1, 1, (n,) + shape).astype("float32"),
            rs.randint(0, classes, n).astype("float32"))


def _nd(pkg, d):
    return {k: pkg.nd.array(v) for k, v in d.items()}


def _params(mod):
    arg, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


CASES = {"mlp": (_mlp, (6,), 3), "conv_bn": (_conv_bn, (3, 8, 8), 5)}
_FITS = {}


def _fit(case):
    """2 epochs of ``Module.fit`` in each package from the same weights:
    {"jax"|"port": (module, iterator, training accuracy)}."""
    if case in _FITS:
        return _FITS[case]
    build, shape, classes = CASES[case]
    X, Y = _data(shape, classes, 0)
    j, _ = _both(build)
    args, aux = _weights(j, dict(data=(4,) + shape), 1)
    args = {k: v for k, v in args.items()
            if k not in ("data", "softmax_label")}
    out = {}
    for key, pkg in (("jax", mx), ("port", mxt)):
        with pkg.name.NameManager(), pkg.cpu():
            sym = build(pkg)
            it = pkg.io.NDArrayIter(X, Y, batch_size=4,
                                    label_name="softmax_label")
            mod = pkg.mod.Module(sym, context=pkg.cpu())
            acc = pkg.metric.create("acc")
            mod.fit(it, num_epoch=2, optimizer="sgd", optimizer_params=SGD,
                    arg_params=_nd(pkg, args), aux_params=_nd(pkg, aux),
                    eval_metric=acc)
            out[key] = (mod, it, acc.get()[1])
    _FITS[case] = out
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_module_fit_matches_jax(case):
    r = _fit(case)
    (jarg, jaux), (targ, taux) = _params(r["jax"][0]), _params(r["port"][0])
    assert set(targ) == set(jarg) and set(taux) == set(jaux)
    for k in jarg:
        if k != "conv0_bias":     # its gradient is 0 before BatchNorm
            assert _rel(targ[k], jarg[k]) <= REL, (k, _rel(targ[k], jarg[k]))
    for k in jaux:
        assert _rel(taux[k], jaux[k]) <= REL, k
    assert r["port"][2] == r["jax"][2]


@pytest.mark.parametrize("case", sorted(CASES))
def test_module_predict_and_score_match_jax(case):
    r = _fit(case)
    with mxt.cpu():
        got = r["port"][0].predict(r["port"][1]).asnumpy()
        score = r["port"][0].score(r["port"][1], "acc")
    want = r["jax"][0].predict(r["jax"][1]).asnumpy()
    assert got.shape == want.shape == (16, CASES[case][2])
    assert _rel(got, want) <= REL
    assert score == r["jax"][0].score(r["jax"][1], "acc")


def _batch(pkg, x, y):
    return pkg.io.DataBatch([pkg.nd.array(x)], [pkg.nd.array(y)])


def test_module_input_gradients_and_batch_reshape_match_jax():
    X, Y = _data((6,), 3, 2, n=4)
    j, _ = _both(_mlp)
    args, _ = _weights(j, dict(data=(4, 6)), 3)
    args = {k: v for k, v in args.items()
            if k not in ("data", "softmax_label")}
    got = {}
    for key, pkg in (("jax", mx), ("port", mxt)):
        with pkg.name.NameManager(), pkg.cpu():
            mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
            mod.bind(data_shapes=[("data", (4, 6))],
                     label_shapes=[("softmax_label", (4,))],
                     inputs_need_grad=True)
            mod.init_params(arg_params=_nd(pkg, args))
            mod.forward_backward(_batch(pkg, X, Y))
            dx = mod.get_input_grads()[0].asnumpy()
            mod.forward(_batch(pkg, X[:2], Y[:2]), is_train=False)
            got[key] = (dx, mod.get_outputs()[0].asnumpy(),
                        mod._exec.arg_dict["data"].shape)
    assert _rel(got["port"][0], got["jax"][0]) <= 1e-4
    assert got["port"][1].shape == (2, 3) and got["port"][2] == (2, 6)
    assert _rel(got["port"][1], got["jax"][1]) <= REL


def _predict(pkg, mod, X, Y):
    with pkg.cpu():
        it = pkg.io.NDArrayIter(X, Y, batch_size=4,
                                label_name="softmax_label")
        return mod.predict(it).asnumpy()


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_checkpoints_load_in_the_other_package(saver, tmp_path):
    r = _fit("conv_bn")
    X, Y = _data((3, 8, 8), 5, 0)
    prefix = str(tmp_path / "ckpt")
    spkg, lpkg = (mx, mxt) if saver == "jax" else (mxt, mx)
    smod = r[saver][0]
    with spkg.cpu():
        arg, aux = smod.get_params()
        spkg.callback.do_checkpoint(prefix, period=2)(
            1, smod.symbol, arg, aux)
    assert sorted(os.listdir(tmp_path)) == ["ckpt-0002.params",
                                            "ckpt-symbol.json"]
    with lpkg.cpu():
        sym, larg, laux = lpkg.model.load_checkpoint(prefix, 2)
        assert sym.tojson() == smod.symbol.tojson()
        mod = lpkg.mod.Module.load(prefix, 2, context=lpkg.cpu())
        mod.bind(data_shapes=[("data", (4, 3, 8, 8))],
                 label_shapes=[("softmax_label", (4,))], for_training=False)
        mod.init_params()
    onp.testing.assert_allclose(_predict(lpkg, mod, X, Y),
                                _predict(spkg, smod, X, Y), atol=1e-6)


def test_module_checkpoint_resumes_with_optimizer_states(tmp_path):
    X, Y = _data((6,), 3, 4)
    prefix = str(tmp_path / "m")
    with mxt.name.NameManager(), mxt.cpu():
        it = mxt.io.NDArrayIter(X, Y, batch_size=4,
                                label_name="softmax_label")
        mod = mxt.mod.Module(_mlp(mxt), context=mxt.cpu())
        mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=SGD,
                initializer=mxt.init.Xavier())
        mxt.callback.module_checkpoint(mod, prefix, 1, True)(0)
        again = mxt.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                    context=mxt.cpu())
        again.fit(it, num_epoch=2, begin_epoch=1, optimizer="sgd",
                  optimizer_params=SGD)
        mod.fit(it, num_epoch=2, begin_epoch=1, optimizer="sgd",
                optimizer_params=SGD)
    (a, _), (b, _) = _params(mod), _params(again)
    for k in a:
        onp.testing.assert_array_equal(b[k], a[k])
    assert sorted(os.listdir(tmp_path)) == ["m-0001.params", "m-0001.states",
                                            "m-symbol.json"]


# -- BucketingModule ---------------------------------------------------------

BUCKETS = (8, 12, 16)


def _lm_batch(pkg, rs, b):
    x = rs.randint(1, 11, (4, b)).astype("float32")
    y = onp.concatenate([x[:, 1:], onp.zeros((4, 1), "float32")], 1)
    return pkg.io.DataBatch(
        [pkg.nd.array(x)], [pkg.nd.array(y)], bucket_key=b,
        provide_data=[pkg.io.DataDesc("data", (4, b))],
        provide_label=[pkg.io.DataDesc("softmax_label", (4, b))])


def test_bucketing_module_matches_jax_and_shares_parameters():
    lm = sys.modules["test_torch_symbol"]._example(
        "example/rnn/bucketing_lm/train.py", "jlm_mod")
    gens = {"jax": lm.sym_gen_factory(11, 6, 8, 4),
            "port": cs.bucketing_lm_sym_gen(mxt, 11, 6, 8, 4)}
    j = gens["jax"](16)[0]
    args, _ = _weights(j, dict(data=(4, 16), softmax_label=(4, 16)), 5)
    args = {k: v * 0.5 for k, v in args.items()
            if k not in ("data", "softmax_label")}
    got = {}
    for key, pkg in (("jax", mx), ("port", mxt)):
        rs = onp.random.RandomState(6)
        with pkg.cpu():
            bm = pkg.mod.BucketingModule(gens[key], default_bucket_key=16,
                                         context=pkg.cpu())
            bm.bind(data_shapes=[("data", (4, 16))],
                    label_shapes=[("softmax_label", (4, 16))])
            bm.init_params(arg_params=_nd(pkg, args))
            bm.init_optimizer(optimizer="sgd",
                              optimizer_params={"learning_rate": 0.5,
                                                "momentum": 0.9,
                                                "rescale_grad": 1.0 / 16})
            steps = []
            for b in BUCKETS:
                bm.forward(_lm_batch(pkg, rs, b), is_train=True)
                bm.backward()
                bm.update()
                steps.append(_params(bm)[0])
            got[key] = (bm, steps)
    for tsteps, jsteps in zip(got["port"][1], got["jax"][1]):
        for k in jsteps:
            assert _rel(tsteps[k], jsteps[k]) <= REL, k
    bm = got["port"][0]
    mods = bm._buckets
    assert sorted(mods) == list(BUCKETS)
    default = mods[16]._exec.arg_dict
    for b in BUCKETS:
        for k in args:
            arr = mods[b]._exec.arg_dict[k]
            assert arr is default[k], (b, k)
            assert arr._data.data_ptr() == default[k]._data.data_ptr()
    assert mods[8]._optimizer is mods[16]._optimizer
    assert mods[8]._updater is mods[16]._updater


# -- SequentialModule --------------------------------------------------------

def _halves(pkg):
    s = pkg.sym
    first = s.Activation(s.FullyConnected(s.var("data"), num_hidden=8,
                                          name="fc1"),
                         act_type="relu", name="relu1")
    second = s.SoftmaxOutput(s.FullyConnected(s.var("feat"), num_hidden=3,
                                              name="fc2"), name="softmax")
    return first, second


def test_sequential_module_matches_jax():
    X, Y = _data((6,), 3, 7)
    j, _ = _both(_mlp)
    args, _ = _weights(j, dict(data=(4, 6)), 8)
    args = {k: v for k, v in args.items()
            if k not in ("data", "softmax_label")}
    got = {}
    for key, pkg in (("jax", mx), ("port", mxt)):
        with pkg.name.NameManager(), pkg.cpu():
            first, second = _halves(pkg)
            seq = pkg.mod.SequentialModule()
            seq.add(pkg.mod.Module(first, label_names=None,
                                   context=pkg.cpu()))
            seq.add(pkg.mod.Module(second, data_names=("feat",),
                                   context=pkg.cpu()),
                    take_labels=True, auto_wiring=True)
            it = pkg.io.NDArrayIter(X, Y, batch_size=4,
                                    label_name="softmax_label")
            seq.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=SGD,
                    arg_params=_nd(pkg, args), aux_params={})
            got[key] = _params(seq)[0]
    for k in got["jax"]:
        assert _rel(got["port"][k], got["jax"][k]) <= REL, k


def test_module_over_two_contexts_raises():
    with pytest.raises(mxt.MXNetError, match="Data-parallel waits"):
        mxt.mod.Module(_mlp(mxt), context=[mxt.cpu(0), mxt.cpu(1)])


# -- amp.convert_symbol / convert_model --------------------------------------

@pytest.mark.parametrize("name", ["mlp", "encoder"])
def test_convert_symbol_gives_the_jax_graph(name):
    build = {"mlp": _mlp, "encoder": _encoder}[name]
    j, t = _both(build)
    assert tamp.convert_symbol(t, "bfloat16").tojson() == \
        jamp.convert_symbol(j, "bfloat16").tojson()
    assert tamp.convert_symbol(t, "float16", excluded_sym_names=["fc1"]) \
        .tojson() == jamp.convert_symbol(j, "float16",
                                         excluded_sym_names=["fc1"]).tojson()
    arg = {"fc1_weight": mxt.nd.array(onp.ones((2, 2)), ctx=mxt.cpu())}
    s2, a2, x2 = tamp.convert_model(t, arg, {}, "bfloat16")
    assert s2.tojson() == tamp.convert_symbol(t, "bfloat16").tojson()
    assert a2["fc1_weight"] is arg["fc1_weight"] and x2 == {}


def test_converted_encoder_outputs_match_jax(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_LAYERNORM", "1")
    j, t = _both(_encoder)
    args, aux = _weights(j, ENC_SHAPES, 11, _enc_ids(12))
    outs = {}
    for key, pkg, sym, amp in (("jax", mx, j, jamp), ("port", mxt, t, tamp)):
        with pkg.cpu():
            cs_, ca, cx = amp.convert_model(sym, _nd(pkg, args), {},
                                            target_dtype="bfloat16")
            ex = cs_.bind(pkg.cpu(), ca)
            outs[key] = ex.forward(is_train=False)[0].asnumpy()
    assert outs["port"].dtype == outs["jax"].dtype == onp.float32
    assert _rel(outs["port"], outs["jax"]) <= 2e-2


def test_convert_symbol_and_model_give_the_amp_cast_graph():
    with mxt.name.NameManager():
        t = _mlp(mxt)
    conv = tamp.convert_symbol(t)
    names = [n for n in conv.get_internals().list_outputs()
             if "amp_cast" in n]
    assert "fc1_data_amp_cast_bfloat16_output" in names
    assert "softmax_data_amp_cast_float32_output" in names


# -- the reference's faults, pinned ------------------------------------------

def test_amp_init_does_not_reach_the_executor():
    x = onp.random.RandomState(0).rand(2, 6).astype("float32")
    for pkg, amp in ((mx, jamp), (mxt, tamp)):
        with pkg.name.NameManager(), pkg.cpu():
            s = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=3,
                                       name="fc")
            amp.init("bfloat16")
            ex = s.simple_bind(ctx=pkg.cpu(), data=(2, 6), grad_req="null")
            out = ex.forward(data=pkg.nd.array(x))[0]
            nd_out = pkg.nd.FullyConnected(
                pkg.nd.array(x), ex.arg_dict["fc_weight"],
                ex.arg_dict["fc_bias"], num_hidden=3)
            amp.disable()
        assert str(out.dtype).replace("torch.", "") == "float32", pkg
        assert str(nd_out.dtype).replace("torch.", "") == "bfloat16", pkg


def _bar(pkg):
    s = pkg.sym
    y = s.Convolution(s.var("data"), kernel=(1, 1), num_filter=4,
                      no_bias=True, name="conv")
    out = s.contrib.BatchNormAddRelu(y, s.var("res"), name="bar")
    return s.make_loss(s.sum(out), name="loss")


def test_batchnorm_add_relu_in_the_executor_as_the_jax_package():
    shapes = dict(data=(2, 3, 4, 4), res=(2, 4, 4, 4), bar_gamma=(4,),
                  bar_beta=(4,), bar_moving_mean=(4,), bar_moving_var=(4,))
    moved = {}
    for pkg in (mx, mxt):
        with pkg.name.NameManager(), pkg.cpu():
            sym = _bar(pkg)
            mod = pkg.mod.Module(sym, data_names=("data", "res"),
                                 label_names=None, context=pkg.cpu())
            with pytest.raises(pkg.MXNetError, match="underdetermined"):
                mod.bind(data_shapes=[("data", (2, 3, 4, 4)),
                                      ("res", (2, 4, 4, 4))])
            ex = sym.simple_bind(ctx=pkg.cpu(), **shapes)
            for k, a in ex.arg_dict.items():
                a[:] = pkg.nd.array(onp.random.RandomState(1).rand(*a.shape))
            ex.forward(is_train=True)
            moved[pkg] = [abs(a.asnumpy()).sum()
                          for a in ex.aux_dict.values()]
    assert moved[mx] == moved[mxt] == [0.0, 0.0]


def test_zoo_models_cannot_be_called_on_a_symbol():
    from mxnet_tpu.gluon.model_zoo import bert as jbert
    from mxnet_tpu.gluon.model_zoo import vision as jvision
    from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
    from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
    for pkg, vision, bert in ((mx, jvision, jbert), (mxt, tvision, tbert)):
        with pytest.raises(ValueError, match="unpack"):
            vision.resnet18_v1(prefix="symres_")(pkg.sym.var("data"))
        with pytest.raises(AttributeError, match="shape"):
            bert.bert_small(prefix="symbert_", vocab_size=11, units=8,
                            hidden_size=16, num_layers=1,
                            max_length=16)(pkg.sym.var("data"))


def test_jax_symbol_block_imports_refuses_checkpoint_parameters(tmp_path):
    r = _fit("mlp")
    prefix = str(tmp_path / "mlp")
    r["jax"][0].save_checkpoint(prefix, 2)
    with pytest.raises(AssertionError, match="not present in this Block"):
        mx.gluon.SymbolBlock.imports(prefix + "-symbol.json",
                                     ["data", "softmax_label"],
                                     prefix + "-0002.params")


# -- SymbolBlock -------------------------------------------------------------

def test_symbol_block_imports_gives_the_modules_bits(tmp_path):
    r = _fit("conv_bn")
    X, Y = _data((3, 8, 8), 5, 0)
    prefix = str(tmp_path / "net")
    mod = r["port"][0]
    with mxt.cpu():
        mod.save_checkpoint(prefix, 2)
        mod.forward(_batch(mxt, X[:4], Y[:4]), is_train=False)
        want = mod.get_outputs()[0].asnumpy()
        sb = mxt.gluon.SymbolBlock.imports(prefix + "-symbol.json",
                                           ["data", "softmax_label"],
                                           prefix + "-0002.params")
        got = sb(mxt.nd.array(X[:4]), mxt.nd.array(Y[:4])).asnumpy()
        assert sorted(sb.collect_params().keys()) == sorted(
            list(mod.get_params()[0]) + list(mod.get_params()[1]))
        # the same graph through load_jax_params, from the JAX Module
        jarg, jaux = _params(r["jax"][0])
        sb2 = mxt.gluon.SymbolBlock(mod.symbol, [mxt.sym.var("data"),
                                                 mxt.sym.var("softmax_label")])
        sb2.initialize()
        sb2(mxt.nd.array(X[:4]), mxt.nd.array(Y[:4]))  # completes shapes
        load_jax_params(sb2, dict(jarg, **jaux))
        got2 = sb2(mxt.nd.array(X[:4]), mxt.nd.array(Y[:4])).asnumpy()
    onp.testing.assert_array_equal(got, want)
    r["jax"][0].forward(_batch(mx, X[:4], Y[:4]), is_train=False)
    jout = r["jax"][0].get_outputs()[0].asnumpy()
    assert _rel(got2, jout) <= REL


class _Small:
    """A two-layer ``hybrid_forward`` block in either package."""

    @staticmethod
    def make(pkg):
        class Small(pkg.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.weight = self.params.get("weight", shape=(4, 3))
                    self.bias = self.params.get("bias", shape=(4,),
                                                init=pkg.init.Zero())

            def hybrid_forward(self, F, x, weight, bias):
                h = F.FullyConnected(x, weight, bias, num_hidden=4)
                return F.softmax(F.relu(h) * 2 + 1)
        return Small(prefix="small_")


def test_hybrid_block_on_a_symbol_builds_the_jax_graph():
    def build(pkg):
        return _Small.make(pkg)(pkg.sym.var("data"))
    j, t = _both(build)
    assert t.tojson() == j.tojson()
    assert t.list_arguments() == ["data", "small_weight", "small_bias"]
    x = onp.random.RandomState(3).rand(2, 3).astype("float32")
    w = onp.random.RandomState(4).rand(4, 3).astype("float32")
    with mxt.cpu():
        blk = _Small.make(mxt)
        blk.initialize()
        blk.weight.set_data(mxt.nd.array(w))
        eager = blk(mxt.nd.array(x)).asnumpy()
        ex = t.bind(mxt.cpu(), {"data": mxt.nd.array(x),
                                "small_weight": mxt.nd.array(w),
                                "small_bias": mxt.nd.zeros((4,))})
        onp.testing.assert_array_equal(ex.forward()[0].asnumpy(), eager)
    with pytest.raises(NotImplementedError, match="get_symbol"):
        mxt.autograd.get_symbol(mxt.nd.array([1.0], ctx=mxt.cpu()))


# -- the rest of the surface -------------------------------------------------

def test_public_names_match_the_jax_package():
    for name in ("sym", "symbol", "mod", "module", "model", "executor",
                 "subgraph", "attribute", "name", "AttrScope"):
        assert hasattr(mx, name) and hasattr(mxt, name), name
    for jm, tm in ((mx.sym, mxt.sym), (mx.mod, mxt.mod),
                   (mx.model, mxt.model), (mx.subgraph, mxt.subgraph)):
        assert set(jm.__all__) <= set(dir(tm)), set(jm.__all__) - set(dir(tm))
    for n in ("do_checkpoint", "module_checkpoint"):
        assert callable(getattr(mxt.callback, n))
    assert mxt.subgraph.list_subgraph_properties() == \
        mx.subgraph.list_subgraph_properties()


def test_copy_params_from_and_output_dict_as_jax():
    j, t = _both(_mlp)
    args, _ = _weights(j, dict(data=(4, 6)), 13)
    outs = {}
    for key, pkg, sym in (("jax", mx, j), ("port", mxt, t)):
        with pkg.cpu():
            ex = sym.simple_bind(ctx=pkg.cpu(), data=(4, 6), grad_req="null")
            ex.copy_params_from(_nd(pkg, {k: v for k, v in args.items()
                                           if k != "data"}))
            with pytest.raises(pkg.MXNetError, match="not in arguments"):
                ex.copy_params_from({"nope": pkg.nd.zeros((1,))})
            ex.forward(data=pkg.nd.array(args["data"]))
            assert list(ex.output_dict) == ["softmax_output"]
            outs[key] = ex.output_dict["softmax_output"].asnumpy()
    assert _rel(outs["port"], outs["jax"]) <= REL
    # copied, not shared: a later change of the source leaves the executor
    with mxt.cpu():
        src = mxt.nd.array(args["fc1_weight"])
        ex = t.simple_bind(ctx=mxt.cpu(), data=(4, 6), grad_req="null")
        ex.copy_params_from({"fc1_weight": src}, allow_extra_params=True)
        src[:] = 0
        assert ex.arg_dict["fc1_weight"].asnumpy().any()


def test_module_updates_through_a_kvstore_as_locally():
    X, Y = _data((6,), 3, 14)
    j, _ = _both(_mlp)
    args, _ = _weights(j, dict(data=(4, 6)), 15)
    args = {k: v for k, v in args.items()
            if k not in ("data", "softmax_label")}
    got = []
    for kv in ("local", mxt.kv.create("local")):
        with mxt.name.NameManager(), mxt.cpu():
            it = mxt.io.NDArrayIter(X, Y, batch_size=4,
                                    label_name="softmax_label")
            mod = mxt.mod.Module(_mlp(mxt), context=mxt.cpu())
            mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=SGD,
                    arg_params=_nd(mxt, args), kvstore=kv)
            assert (mod._kvstore is None) == (kv == "local")
            got.append(_params(mod)[0])
    for k in got[0]:
        onp.testing.assert_allclose(got[1][k], got[0][k], rtol=1e-6,
                                    atol=1e-7)


def test_feedforward_fits_predicts_and_saves(tmp_path):
    X, Y = _data((6,), 3, 16)
    with mxt.name.NameManager(), mxt.cpu():
        mxt.random.seed(0)
        ff = mxt.model.FeedForward(_mlp(mxt), ctx=mxt.cpu(), num_epoch=2,
                                   numpy_batch_size=4, learning_rate=0.1)
        ff.fit(X, Y)
        p = ff.predict(mxt.io.NDArrayIter(X, Y, batch_size=4)).asnumpy()
        ff.save(str(tmp_path / "ff"))
        back = mxt.model.FeedForward.load(str(tmp_path / "ff"), 2)
    assert p.shape == (16, 3) and onp.isfinite(p).all()
    for k, v in ff.arg_params.items():
        onp.testing.assert_array_equal(back.arg_params[k].asnumpy(),
                                       v.asnumpy())


def test_elastic_and_monitor_hooks_name_their_wait():
    X, Y = _data((6,), 3, 17)
    with mxt.name.NameManager(), mxt.cpu():
        it = mxt.io.NDArrayIter(X, Y, batch_size=4,
                                label_name="softmax_label")
        mod = mxt.mod.Module(_mlp(mxt), context=mxt.cpu())
        with pytest.raises(mxt.MXNetError, match="queue 1, item 8"):
            mod.fit(it, num_epoch=1, elastic=object())
        with pytest.raises(mxt.MXNetError, match="queue 1, item 8"):
            mod.install_monitor(object())
        with pytest.raises(mxt.MXNetError, match="queue 1, item 9"):
            mxt.sym.Custom(mxt.sym.var("x"), op_type="mine")
