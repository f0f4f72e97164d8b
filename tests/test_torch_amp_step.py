"""Port parity: ``parallel.DataParallelStep`` under ``amp.init("bfloat16")``
in ``mxnet_tpu_torch`` against the JAX package's, on the CPU, from the same
float32 weights and batches.

``bert_small`` as in tests/test_torch_bert_train.py (2 layers, 64 units, 4
heads, 97 words, no pooler, ``MXNET_FUSED_LAYERNORM=1``), batch 2 x 128
with valid lengths (128, 65) and 5 masked positions a row, bench.py's
MLM loss, ``Adam(learning_rate=1e-4)``, 3 steps on 3 batches.  The cast
policy reaches the step's forward in both packages: the products run in
bfloat16, the LayerNorms and the softmax in float32, and the weights and
Adam's state stay float32.

- Each step's loss within rel 2e-2 (2 bfloat16 ulps of it: the same ops'
  outputs rounded to bfloat16 in both, float32 sums in another order;
  XLA's CPU fusions keep float32 inside a fusion where torch rounds each
  op).  The loss is bfloat16 in both.
- Adam's first moment after the 3 steps within a relative L2 error of
  5e-2 over all parameters (the gradients' bfloat16 roundings, as in
  tests/test_torch_amp.py); each weight within 6 lr of the JAX package's
  (3 steps of at most about 2 lr apart each), and the weights moved.
- The updates ``w - w0`` after the 3 steps within a relative L2 error of
  0.15 of the JAX package's over all parameters.  The sound step reads
  0.0705: Adam's early steps are about lr times the gradient's sign, and
  the bfloat16 roundings flip that sign where a gradient is near 0.  An
  update with its sign flipped reads 2.00, one without Adam's bias
  correction 2.97.  The unreached parameter stays put in both packages.
- The dtypes, as in the JAX step: the loss bfloat16 (the mean of the rows
  of the bfloat16 logits' cross entropy), the weights and both Adam
  moments float32.
"""
import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.gluon.model_zoo import bert as jbert
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.contrib import amp as tamp
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.utils import load_jax_params
from test_torch_bert_train import (CFG, LR, UNREACHED, _JaxMLMLoss,
                                   _PortMLMLoss, _dt, _inputs)

STEPS = 3
LOSS_RTOL = 2e-2
MOMENT_REL_L2 = 5e-2
UPDATE_REL_L2 = 0.15


@pytest.fixture(scope="module")
def steps():
    """3 steps of each package's DataParallelStep under amp.init:
    (w0, jax (losses, weights, states), port (losses, weights, states))."""
    batches = [_inputs(s) for s in range(STEPS)]
    try:
        jamp.init("bfloat16")
        mx.random.seed(3)
        net = jbert.bert_small(prefix="ampdp_", **CFG)
        net.initialize(mx.init.Xavier())
        tokens, lens, pos, _ = batches[0]
        net(mx.nd.array(tokens), None, None, mx.nd.array(lens, dtype="int32"),
            mx.nd.array(pos, dtype="int32"))
        w0 = {k: p.data().asnumpy()
              for k, p in net._collect_params_with_prefix().items()}
        step = mx.parallel.DataParallelStep(
            net, _JaxMLMLoss(), mx.optimizer.Adam(learning_rate=LR),
            mesh=None)
        jl = [step((mx.nd.array(t), None, None, mx.nd.array(l, dtype="int32"),
                    mx.nd.array(p, dtype="int32")), mx.nd.array(y))
              for t, l, p, y in batches]
        jparams = net._collect_params_with_prefix()
        names = {id(p): k for k, p in jparams.items()}
        jstates = {names[id(step._params[i])]: step._opt_states[slot]
                   for slot, i in enumerate(step._trainable)}
        jw = {k: p.data() for k, p in jparams.items()}
        jloss = [(_dt(v.dtype), float(v.astype("float32").asnumpy()))
                 for v in jl]
    finally:
        jamp.disable()
    mp = pytest.MonkeyPatch()
    mp.setenv("MXNET_FUSED_LAYERNORM", "1")
    try:
        with mxt.cpu():
            tamp.init("bfloat16")
            tnet = tbert.bert_small(**CFG)
            tnet.initialize()
            load_jax_params(tnet, w0)
            tstep = mxt.parallel.DataParallelStep(
                tnet, _PortMLMLoss(), mxt.optimizer.Adam(learning_rate=LR))
            tl = [tstep((mxt.nd.array(t), None, None,
                         mxt.nd.array(l, dtype="int32"),
                         mxt.nd.array(p, dtype="int32")), mxt.nd.array(y))
                  for t, l, p, y in batches]
            params = tnet._collect_params_with_prefix()
            tnames = {id(p): k for k, p in params.items()}
            tstates = {tnames[id(tstep._params[i])]: tstep._opt_states[slot]
                       for slot, i in enumerate(tstep._trainable)}
            tw = {k: p.data() for k, p in params.items()}
            tloss = [(_dt(v.dtype), float(v.astype("float32").asnumpy()))
                     for v in tl]
    finally:
        tamp.disable()
        mp.undo()
    return w0, (jloss, jw, jstates), (tloss, tw, tstates)


def test_amp_data_parallel_step_losses_match_jax(steps):
    _, (jloss, _, _), (tloss, _, _) = steps
    # the MLM loss's rows come from the bfloat16 logits of the decoder's
    # FullyConnected, so the mean loss is bfloat16 in both packages
    assert [d for d, _ in tloss] == [d for d, _ in jloss] == \
        ["bfloat16"] * STEPS
    for (_, got), (_, want) in zip(tloss, jloss):
        assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


def test_amp_data_parallel_step_moments_and_weights_match_jax(steps):
    w0, (_, jw, jstates), (_, tw, tstates) = steps
    assert set(tstates) == set(jstates)
    err2 = ref2 = 0.0
    for k, (m, v) in tstates.items():
        jm = onp.asarray(jstates[k][0], "float64")
        assert _dt(m.dtype) == _dt(v.dtype) == "float32", k
        assert str(onp.asarray(jstates[k][0]).dtype) == "float32", k
        if k in UNREACHED:
            assert not m.numpy().any() and not jm.any(), k
            continue
        d = m.numpy().astype("float64") - jm
        err2 += float((d * d).sum())
        ref2 += float((jm * jm).sum())
    assert (err2 / ref2) ** 0.5 <= MOMENT_REL_L2, (err2 / ref2) ** 0.5
    err2 = ref2 = 0.0
    for k, w in tw.items():
        assert _dt(w.dtype) == _dt(jw[k].dtype) == "float32", k
        got, want = w.asnumpy(), jw[k].asnumpy()
        assert abs(got.astype("float64") - want).max() <= 6 * LR, k
        if k in UNREACHED:
            assert onp.array_equal(got, w0[k]), k
            assert onp.array_equal(want, w0[k]), k
            continue
        assert not onp.array_equal(got, w0[k]), k
        d = got.astype("float64") - want
        du = want.astype("float64") - w0[k]
        err2 += float((d * d).sum())
        ref2 += float((du * du).sum())
    assert (err2 / ref2) ** 0.5 <= UPDATE_REL_L2, (err2 / ref2) ** 0.5
