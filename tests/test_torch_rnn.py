"""Port parity: the ``RNN`` op (``ops/rnn.py``), the fused layers
(``gluon/rnn/rnn_layer.py``) and the cells (``gluon/rnn/rnn_cell.py``,
``gluon/contrib/rnn/rnn_cell.py``) of ``mxnet_tpu_torch`` against the JAX
package's, on the CPU, from the same seeded numpy inputs and weights.

Tolerances:

* float32 outputs and states: rtol 1e-5, atol 1e-6 (torch's native cells
  and XLA's scan sum the same products in another order);
* float32 gradients of the input, the states and the flat vector against
  ``jax.grad``: rtol 1e-4, atol 1e-5 (the backward sums over every step,
  so the forward's rounding differences add up over T);
* bfloat16: 4 bf16 ulps of values in [0.5, 1) (4 * 2^-8 = 0.0156)
  absolute; 2 were seen on seeds 0-3.  Both packages round every gate,
  carry and output to bf16 at each step, but at different points (the
  JAX package adds ``x W_i2h^T + b_i2h`` and then ``h W_h2h^T``, then
  ``b_h2h``; torch adds the two projections, each with its bias), so one
  step's values differ by about an ulp and the recurrence carries them
  on; the values lie in (-1, 1).

Every JAX-package block is built under an explicit prefix, so no global
name counter of the JAX package moves.  The layers cross by structural
name (``load_jax_params``); dropout masks are each package's own, so
dropout is compared at p = 0 and checked at p > 0 for its rate and
scaling from a seeded port generator.
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.gluon.contrib import rnn as jcrnn
from mxnet_tpu.ops import rnn as jops
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.gluon.contrib import rnn as tcrnn
from mxnet_tpu_torch.gluon.utils import load_jax_params
from mxnet_tpu_torch.ops import rnn as tops

T, N, C, H = 5, 3, 4, 6
F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL = 4 * 2.0 ** -8
MODES = ("rnn_relu", "rnn_tanh", "lstm", "gru")
CPU = mxt.cpu()


def _op_inputs(mode, layers, bidir, seed=0, scale=0.3):
    rs = onp.random.RandomState(seed)
    dirs = 2 if bidir else 1
    size = jops.rnn_param_size(layers, C, H, bidir, mode)
    assert size == tops.rnn_param_size(layers, C, H, bidir, mode)
    return {"x": rs.uniform(-1, 1, (T, N, C)).astype("float32"),
            "w": (rs.randn(size) * scale).astype("float32"),
            "h0": rs.uniform(-0.5, 0.5, (layers * dirs, N, H))
            .astype("float32"),
            "c0": rs.uniform(-0.5, 0.5, (layers * dirs, N, H))
            .astype("float32")}


def _attrs(mode, layers, bidir, **kw):
    return dict(state_size=H, num_layers=layers, bidirectional=bidir,
                mode=mode, state_outputs=True, **kw)


def _jax_op(inp, attrs, dtype="float32"):
    args = [mx.nd.array(inp[k]).astype(dtype) for k in ("x", "w", "h0")]
    if attrs["mode"] == "lstm":
        args.append(mx.nd.array(inp["c0"]).astype(dtype))
    return [o.astype("float32").asnumpy() for o in mx.nd.RNN(*args, **attrs)]


def _port_op(inp, attrs, dtype="float32"):
    args = [mxt.nd.array(inp[k], ctx=CPU).astype(dtype)
            for k in ("x", "w", "h0")]
    if attrs["mode"] == "lstm":
        args.append(mxt.nd.array(inp["c0"], ctx=CPU).astype(dtype))
    return [o.astype("float32").asnumpy()
            for o in mxt.nd.RNN(*args, **attrs)]


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_matches_jax(mode, layers, bidir):
    inp = _op_inputs(mode, layers, bidir)
    attrs = _attrs(mode, layers, bidir)
    want = _jax_op(inp, attrs)
    got = _port_op(inp, attrs)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        onp.testing.assert_allclose(g, w, **F32)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_op_bf16_matches_jax(mode):
    inp = _op_inputs(mode, 2, False, seed=1)
    attrs = _attrs(mode, 2, False)
    want = _jax_op(inp, attrs, "bfloat16")
    got = _port_op(inp, attrs, "bfloat16")
    out = mxt.nd.RNN(*[mxt.nd.array(inp[k], ctx=CPU).astype("bfloat16")
                       for k in ("x", "w", "h0", "c0")][:4 if mode == "lstm"
                                                          else 3], **attrs)
    assert all(o.dtype == torch.bfloat16 for o in out)
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_op_gradients_match_jax(mode):
    layers, bidir = 2, True
    inp = _op_inputs(mode, layers, bidir, seed=2)
    rs = onp.random.RandomState(3)
    dirs = 2 if bidir else 1
    cot = [rs.randn(T, N, dirs * H).astype("float32"),
           rs.randn(layers * dirs, N, H).astype("float32"),
           rs.randn(layers * dirs, N, H).astype("float32")]
    attrs = dict(state_size=H, num_layers=layers, bidirectional=bidir,
                 mode=mode)
    names = ["x", "w", "h0"] + (["c0"] if mode == "lstm" else [])

    def jloss(*vals):
        c0 = vals[3] if mode == "lstm" else None
        outs = jops.rnn_op(None, vals[0], vals[1], vals[2], c0, **attrs)
        n = 3 if mode == "lstm" else 2
        return sum(jnp.sum(o * w) for o, w in zip(outs[:n], cot[:n]))

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(len(names)))))(
        *[jnp.asarray(inp[k]) for k in names])
    ts = [torch.tensor(inp[k], requires_grad=True) for k in names]
    outs = tops.rnn(*ts, **attrs)
    n = 3 if mode == "lstm" else 2
    sum((o * torch.from_numpy(w)).sum()
        for o, w in zip(outs[:n], cot[:n])).backward()
    for name, t, w in zip(names, ts, want):
        onp.testing.assert_allclose(t.grad.numpy(), onp.asarray(w),
                                    err_msg=name, **GRAD)


def test_final_cell_state_clip_matches_jax():
    inp = _op_inputs("lstm", 2, False, seed=4, scale=1.5)
    attrs = _attrs("lstm", 2, False, lstm_state_clip_min=-0.2,
                   lstm_state_clip_max=0.2)
    want = _jax_op(inp, attrs)
    got = _port_op(inp, attrs)
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, **F32)
    free = _port_op(inp, _attrs("lstm", 2, False))
    # only the final cell state is clipped: the outputs and h are not
    onp.testing.assert_array_equal(got[0], free[0])
    onp.testing.assert_array_equal(got[1], free[1])
    assert onp.abs(free[2]).max() > 0.2
    onp.testing.assert_array_equal(got[2], onp.clip(free[2], -0.2, 0.2))


def test_use_sequence_length_raises():
    inp = _op_inputs("gru", 1, False)
    with pytest.raises(AssertionError):
        _jax_op(inp, _attrs("gru", 1, False, use_sequence_length=True))
    with pytest.raises(mxt.MXNetError):
        _port_op(inp, _attrs("gru", 1, False, use_sequence_length=True))


def _dropout_stack(p, training):
    """Two rnn_relu layers of identity weights on positive inputs: the
    output is the inter-layer dropout applied to the input itself."""
    rows, cols, width = 8, 64, 32
    x = onp.random.RandomState(5).uniform(0.5, 1.5, (rows, cols, width)) \
        .astype("float32")
    eye = onp.eye(width, dtype="float32").ravel()
    zero = onp.zeros(width * width, "float32")
    w = onp.concatenate([eye, zero, eye, zero,
                         onp.zeros(4 * width, "float32")])
    h0 = onp.zeros((2, cols, width), "float32")
    out, _, _ = tops.rnn(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(h0), state_size=width,
                         num_layers=2, mode="rnn_relu", p=p,
                         training=training)
    return x, out.numpy()


def test_inter_layer_dropout_rate_and_scaling_from_the_port_generator():
    x, same = _dropout_stack(0.0, True)
    onp.testing.assert_array_equal(same, x)
    _, off = _dropout_stack(0.5, False)
    onp.testing.assert_array_equal(off, x)
    mxt.random.seed(11)
    _, a = _dropout_stack(0.3, True)
    mxt.random.seed(11)
    _, b = _dropout_stack(0.3, True)
    onp.testing.assert_array_equal(a, b)
    dropped = a == 0
    assert abs(dropped.mean() - 0.3) < 0.02
    onp.testing.assert_allclose(a[~dropped], x[~dropped] / 0.7, rtol=1e-6)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

LAYERS = {"lstm": lambda pkg, **kw: pkg.LSTM(H, **kw),
          "gru": lambda pkg, **kw: pkg.GRU(H, **kw),
          "rnn_tanh": lambda pkg, **kw: pkg.RNN(H, activation="tanh", **kw)}


def _layer_pair(kind, seed=0, **kw):
    """The JAX layer (Xavier weights from ``seed``) and the port layer
    with its weights carried over by structural name."""
    mx.random.seed(seed)
    jl = LAYERS[kind](jrnn, prefix="rnnl_", **kw)
    jl.initialize(mx.init.Xavier())
    tl = LAYERS[kind](trnn, prefix="rnnl_", **kw)
    tl.initialize(ctx=CPU)
    return jl, tl


def _carry(jl, tl, x_shape):
    jl(mx.nd.zeros(x_shape))
    tl(mxt.nd.zeros(x_shape, ctx=CPU))
    arrays = {k: p.data().asnumpy()
              for k, p in jl._collect_params_with_prefix().items()}
    load_jax_params(tl, arrays)
    return arrays


@pytest.mark.parametrize("layout,with_states", [("TNC", False),
                                                ("NTC", True)])
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_layer_matches_jax(kind, layout, with_states):
    """Each layer in both layouts, once without states (the output alone)
    and once with them (the output and the final states)."""
    jl, tl = _layer_pair(kind, num_layers=2, layout=layout,
                         bidirectional=kind == "gru")
    shape = (T, N, C) if layout == "TNC" else (N, T, C)
    _carry(jl, tl, shape)
    rs = onp.random.RandomState(6)
    x = rs.uniform(-1, 1, shape).astype("float32")
    if not with_states:
        onp.testing.assert_allclose(tl(mxt.nd.array(x, ctx=CPU)).asnumpy(),
                                    jl(mx.nd.array(x)).asnumpy(), **F32)
        return
    states = [rs.uniform(-0.5, 0.5, s["shape"]).astype("float32")
              for s in jl.state_info(N)]
    jo, js = jl(mx.nd.array(x), [mx.nd.array(s) for s in states])
    to, ts = tl(mxt.nd.array(x, ctx=CPU),
                [mxt.nd.array(s, ctx=CPU) for s in states])
    onp.testing.assert_allclose(to.asnumpy(), jo.asnumpy(), **F32)
    assert len(ts) == len(js)
    for t, j in zip(ts, js):
        onp.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **F32)


def test_layer_state_shape_is_checked_and_names_match():
    jl, tl = _layer_pair("lstm", num_layers=2)
    arrays = _carry(jl, tl, (T, N, C))
    assert sorted(arrays) == sorted(tl._collect_params_with_prefix())
    assert "l1_h2h_bias" in arrays
    bad = [mxt.nd.zeros((1, N, H), ctx=CPU)] * 2
    with pytest.raises(ValueError):
        tl(mxt.nd.zeros((T, N, C), ctx=CPU), bad)


def test_lstm_bias_initializer_matches_jax():
    """``LSTMBias`` sets the forget gate's quarter of a bias, by instance
    and by name, as the JAX package's does."""
    init = dict(i2h_bias_initializer=mx.init.LSTMBias(forget_bias=2.5),
                h2h_bias_initializer="lstmbias")
    jl = jrnn.LSTM(H, input_size=C, prefix="lstmb_", **init)
    jl.initialize()
    tinit = dict(i2h_bias_initializer=mxt.init.LSTMBias(forget_bias=2.5),
                 h2h_bias_initializer="lstmbias")
    tl = trnn.LSTM(H, input_size=C, prefix="lstmb_", **tinit)
    tl.initialize(ctx=CPU)
    for name in ("l0_i2h_bias", "l0_h2h_bias"):
        want = jl._collect_params_with_prefix()[name].data().asnumpy()
        got = tl._collect_params_with_prefix()[name].data().asnumpy()
        onp.testing.assert_array_equal(got, want)
        assert set(got[H:2 * H]) == {2.5 if "i2h" in name else 1.0}
        assert not got[:H].any() and not got[2 * H:].any()


@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_unfused_cells_match_the_fused_layer_and_jax(kind):
    jl, tl = _layer_pair(kind, num_layers=2, input_size=C)
    _carry(jl, tl, (T, N, C))
    x = onp.random.RandomState(7).uniform(-1, 1, (T, N, C)) \
        .astype("float32")
    fused = tl(mxt.nd.array(x, ctx=CPU)).asnumpy()
    with mxt.cpu():
        touts, _ = tl._unfuse().unroll(T, mxt.nd.array(x), layout="TNC",
                                       merge_outputs=True)
    jouts, _ = jl._unfuse().unroll(T, mx.nd.array(x), layout="TNC",
                                   merge_outputs=True)
    onp.testing.assert_allclose(touts.asnumpy(), fused, **F32)
    onp.testing.assert_allclose(touts.asnumpy(), jouts.asnumpy(), **F32)


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------

def _lstm_stack(pkg, rnn, crnn):
    stack = rnn.SequentialRNNCell(prefix="seq_")
    with stack.name_scope():
        stack.add(rnn.LSTMCell(H, prefix="a_"))
        stack.add(rnn.DropoutCell(0.5, prefix="d_"))
        stack.add(rnn.LSTMCell(H, prefix="b_"))
    return stack


CELLS = {
    "rnn": lambda pkg, rnn, crnn: rnn.RNNCell(H, prefix="c_"),
    "rnn_relu": lambda pkg, rnn, crnn: rnn.RNNCell(H, activation="relu",
                                                   prefix="c_"),
    "lstm": lambda pkg, rnn, crnn: rnn.LSTMCell(H, prefix="c_"),
    "gru": lambda pkg, rnn, crnn: rnn.GRUCell(H, prefix="c_"),
    "sequential": _lstm_stack,
    "residual": lambda pkg, rnn, crnn: rnn.ResidualCell(
        rnn.GRUCell(C, prefix="c_")),
    "zoneout": lambda pkg, rnn, crnn: rnn.ZoneoutCell(
        rnn.LSTMCell(H, prefix="c_"), zoneout_outputs=0.3,
        zoneout_states=0.3),
    "bidirectional": lambda pkg, rnn, crnn: rnn.BidirectionalCell(
        rnn.LSTMCell(H, prefix="l_"), rnn.GRUCell(H, prefix="r_")),
    "vardrop": lambda pkg, rnn, crnn: crnn.VariationalDropoutCell(
        rnn.LSTMCell(H, prefix="c_"), drop_inputs=0.3, drop_states=0.3,
        drop_outputs=0.3),
    "lstmp": lambda pkg, rnn, crnn: crnn.LSTMPCell(H, 3, prefix="c_"),
}


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_unroll_matches_jax(name, valid):
    """Outside training the dropout, zoneout and variational-dropout
    cells pass their values through, in both packages."""
    rs = onp.random.RandomState(8)
    x = rs.uniform(-1, 1, (N, T, C)).astype("float32")
    lens = onp.array([T, 3, 1], "float32")
    mx.random.seed(0)
    jc = CELLS[name](mx, jrnn, jcrnn)
    jc.initialize(mx.init.Xavier())
    jv = mx.nd.array(lens) if valid else None
    jo, js = jc.unroll(T, mx.nd.array(x), layout="NTC", merge_outputs=True,
                       valid_length=jv)
    arrays = {k: p.data().asnumpy()
              for k, p in jc._collect_params_with_prefix().items()}
    with mxt.cpu():
        tc = CELLS[name](mxt, trnn, tcrnn)
        tc.initialize()
        tv = mxt.nd.array(lens) if valid else None
        tc.unroll(T, mxt.nd.array(x), layout="NTC", merge_outputs=True,
                  valid_length=tv)
        load_jax_params(tc, arrays)
        to, ts = tc.unroll(T, mxt.nd.array(x), layout="NTC",
                           merge_outputs=True, valid_length=tv)
    onp.testing.assert_allclose(to.asnumpy(), jo.asnumpy(), **F32)
    assert len(ts) == len(js)
    for t, j in zip(ts, js):
        onp.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **F32)


def test_dropout_and_zoneout_cells_draw_from_the_port_generator():
    """In training, at p > 0: the dropout cell zeroes about p of its input
    and scales the rest by 1 / (1 - p), the same mask for the same seed;
    a zoneout cell keeps the previous output where its mask says so."""
    x = onp.random.RandomState(9).uniform(0.5, 1.5, (64, 128)) \
        .astype("float32")
    with mxt.cpu():
        cell = trnn.DropoutCell(0.25, prefix="dc_")
        draws = []
        for _ in range(2):
            mxt.random.seed(3)
            with mxt.autograd.train_mode():
                draws.append(cell(mxt.nd.array(x), [])[0].asnumpy())
        onp.testing.assert_array_equal(draws[0], draws[1])
        dropped = draws[0] == 0
        assert abs(dropped.mean() - 0.25) < 0.02
        onp.testing.assert_allclose(draws[0][~dropped], x[~dropped] / 0.75,
                                    rtol=1e-6)
        with mxt.autograd.predict_mode():
            onp.testing.assert_array_equal(cell(mxt.nd.array(x), [])[0]
                                           .asnumpy(), x)
        zc = trnn.ZoneoutCell(trnn.RNNCell(8, prefix="zc_"),
                              zoneout_outputs=0.5)
        zc.initialize()
        inp = mxt.nd.array(x[:16, :6])
        with mxt.autograd.train_mode():
            outs, _ = zc.unroll(2, [inp] * 2, layout="TNC")
        # the states are the base cell's, unmasked: step by step, each
        # output entry is the new one or the previous output's
        h1 = zc.base_cell(inp, [mxt.nd.zeros((16, 8))])[0]
        h2 = zc.base_cell(inp, [h1])[0].asnumpy()
        o1, o2 = outs[0].asnumpy(), outs[1].asnumpy()
        assert onp.all((o1 == 0) | onp.isclose(o1, h1.asnumpy()))
        assert 0 < (o1 == 0).mean() < 1
        assert onp.all(onp.isclose(o2, h2) | onp.isclose(o2, o1))
