"""Port parity: the losses of ``mxnet_tpu_torch.gluon.loss`` that the
rest-of-training slice added (SigmoidBinaryCrossEntropyLoss and its
alias SigmoidBCELoss, KLDivLoss, CTCLoss, HuberLoss, HingeLoss,
SquaredHingeLoss, LogisticLoss, TripletLoss, PoissonNLLLoss and
CosineEmbeddingLoss) against the JAX package's, on the CPU, from the same
numpy inputs made from a seed.

Each case compares the loss and the gradient of every float input
(through ``autograd.record``/``backward`` in both packages; the JAX
package differentiates its loss with ``jax.vjp``), with ``sample_weight``,
``batch_axis`` and each loss's options: values within rtol 1e-5, atol
1e-6, gradients within rtol 1e-4, atol 1e-6 (float32; the log-softmax and
log-sum-exp chains round in another order).  CTC runs both paddings
(0 and -1), ``label_lengths``, short ``pred_lengths``, repeated labels,
both layouts and one row whose labels cannot fit its input (a loss of
about 1e30, finite in both packages).
"""
import numpy as onp
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
N, K = 6, 5


def _rs(seed=0):
    return onp.random.RandomState(seed)


def _f(a):
    return onp.asarray(a, dtype="float32")


def _run(pkg, make, args, grads, extra):
    """The loss of ``args`` (numpy) and the gradients of the positions in
    ``grads``; ``extra`` holds the further positional arguments (arrays,
    None or numbers: the JAX package's blocks take no keywords)."""
    kw = {"ctx": mxt.cpu()} if pkg is mxt else {}
    nds = [pkg.nd.array(a, **kw) for a in args]
    for i in grads:
        nds[i].attach_grad()
    extra = [pkg.nd.array(v, **kw) if isinstance(v, onp.ndarray) else v
             for v in extra]
    loss = make(pkg)
    with pkg.autograd.record():
        out = loss(*nds, *extra)
    out.backward()
    return out.asnumpy(), [nds[i].grad.asnumpy() for i in grads]


def _check(make, args, grads=(0,), extra=()):
    want, wg = _run(mx, make, args, grads, extra)
    got, tg = _run(mxt, make, args, grads, extra)
    assert got.shape == want.shape
    onp.testing.assert_allclose(got, want, **VAL)
    for a, b in zip(tg, wg):
        onp.testing.assert_allclose(a, b, **GRAD)
    return got


def _logits(seed=0, shape=(N, K)):
    return _f(_rs(seed).randn(*shape) * 2)


def _binary(seed=1, shape=(N, K)):
    return _f(_rs(seed).randint(0, 2, shape))


def _signed(seed=1, shape=(N, K)):
    return _binary(seed, shape) * 2 - 1


SW = _f(_rs(9).uniform(0.5, 1.5, (N, 1)))


def test_sigmoid_bce_alias():
    assert mxt.gluon.loss.SigmoidBCELoss is \
        mxt.gluon.loss.SigmoidBinaryCrossEntropyLoss


@pytest.mark.parametrize("case", ["logits", "logits_sw", "pos_weight",
                                  "from_sigmoid", "from_sigmoid_pos_weight"])
def test_sigmoid_bce_matches_jax(case):
    def make(pkg):
        return pkg.gluon.loss.SigmoidBCELoss(
            from_sigmoid=case.startswith("from_sigmoid"), weight=0.7,
            prefix="bce_")
    pred = _logits()
    if case.startswith("from_sigmoid"):
        pred = _f(1 / (1 + onp.exp(-pred)))
    sw = SW if case == "logits_sw" else None
    pw = _f(_rs(4).uniform(0.5, 2, (K,))) if case.endswith("pos_weight") \
        else None
    _check(make, [pred, _binary()], extra=(sw, pw))


@pytest.mark.parametrize("from_logits,batch_axis", [(False, 0), (True, 0),
                                                    (False, 1)])
def test_kldiv_matches_jax(from_logits, batch_axis):
    def make(pkg):
        return pkg.gluon.loss.KLDivLoss(from_logits=from_logits,
                                        batch_axis=batch_axis, prefix="kl_")
    pred = _logits()
    if from_logits:
        pred = _f(pred - onp.log(onp.exp(pred).sum(-1, keepdims=True)))
    target = _f(_rs(2).dirichlet(onp.ones(K), N))
    _check(make, [pred, target], extra=(SW if batch_axis == 0 else None,))


@pytest.mark.parametrize("rho,batch_axis", [(1, 0), (0.5, 1)])
def test_huber_matches_jax(rho, batch_axis):
    def make(pkg):
        return pkg.gluon.loss.HuberLoss(rho=rho, batch_axis=batch_axis,
                                        prefix="hub_")
    _check(make, [_logits(), _logits(3)],
           extra=(SW if batch_axis == 0 else None,))


@pytest.mark.parametrize("squared", [False, True])
def test_hinge_losses_match_jax(squared):
    def make(pkg):
        cls = pkg.gluon.loss.SquaredHingeLoss if squared \
            else pkg.gluon.loss.HingeLoss
        return cls(margin=1.5, weight=2.0, prefix="hinge_")
    _check(make, [_logits(), _signed()], extra=(SW,))


@pytest.mark.parametrize("label_format", ["signed", "binary"])
def test_logistic_matches_jax(label_format):
    def make(pkg):
        return pkg.gluon.loss.LogisticLoss(label_format=label_format,
                                           prefix="logi_")
    label = _signed() if label_format == "signed" else _binary()
    _check(make, [_logits(), label], extra=(SW,))


def test_logistic_refuses_other_label_formats():
    with pytest.raises(ValueError, match="signed or binary"):
        mxt.gluon.loss.LogisticLoss(label_format="onehot")


def test_triplet_matches_jax():
    def make(pkg):
        return pkg.gluon.loss.TripletLoss(margin=0.5, prefix="trip_")
    shape = (N, 3, 2)
    _check(make, [_logits(0, shape), _logits(1, shape), _logits(2, shape)],
           grads=(0, 1, 2))


@pytest.mark.parametrize("case", ["logits", "probs_full", "probs_eps"])
def test_poisson_nll_matches_jax(case):
    def make(pkg):
        return pkg.gluon.loss.PoissonNLLLoss(
            from_logits=case == "logits",
            compute_full=case == "probs_full", prefix="pois_")
    rs = _rs(5)
    target = _f(rs.poisson(2.0, (N, K)))
    pred = _logits() * 0.3 if case == "logits" \
        else _f(rs.uniform(0.2, 3.0, (N, K)))
    extra = (SW if case == "logits" else None,
             1e-3 if case == "probs_eps" else 1e-08)
    out = _check(make, [pred, target], extra=extra)
    assert out.shape == ()


@pytest.mark.parametrize("margin", [0.0, 0.2])
def test_cosine_embedding_matches_jax(margin):
    def make(pkg):
        return pkg.gluon.loss.CosineEmbeddingLoss(margin=margin,
                                                  prefix="cos_")
    x1, x2 = _logits(0, (N, 2, 3)), _logits(1, (N, 2, 3))
    x2[0] = x1[0] * 0.5                 # cosine 1
    label = _signed(6, (N,))
    _check(make, [x1, x2, label], grads=(0, 1), extra=(SW[:, 0],))


T, C, L = 12, 6, 4


def _ctc_inputs(padding):
    rs = _rs(8)
    pred = _f(rs.randn(N, T, C))
    label = onp.full((N, L), padding, "float32")
    label[0] = [1, 2, 3, 4]
    label[1, :2] = [2, 2]               # a repeated label needs a blank
    label[2, :3] = [5, 1, 5]
    label[3, :1] = [3]
    label[4] = [1, 1, 1, 1]             # 7 steps
    label[5, :3] = [4, 4, 4]            # 5 steps: more than its input
    return pred, label


@pytest.mark.parametrize("padding", [0, -1])
def test_ctc_matches_jax_with_padding(padding):
    def make(pkg):
        return pkg.gluon.loss.CTCLoss(prefix="ctc_")
    pred, label = _ctc_inputs(padding)
    plen = _f([T, T, 9, 7, T, 4])
    out = _check(make, [pred, label], extra=(plen, None, SW[:, 0]))
    assert onp.isfinite(out).all()
    assert out[5] > 1e29 and out[:5].max() < 1e3


def test_ctc_matches_jax_with_label_lengths_and_tnc_layout():
    def make(pkg):
        return pkg.gluon.loss.CTCLoss(layout="TNC", label_layout="TN",
                                      weight=0.5, prefix="ctc_")
    pred, label = _ctc_inputs(0)
    # lengths cut rows 0 and 4 short; the padding is ignored
    llen = _f([3, 2, 3, 1, 2, 3])
    _check(make, [pred.transpose(1, 0, 2).copy(), label.T.copy()],
           extra=(None, llen))


def test_ctc_of_a_one_label_sequence_is_its_path_sum():
    """Two steps, label [1]: the paths 1-1, 1-blank and blank-1."""
    probs = onp.array([[0.2, 0.5, 0.3], [0.6, 0.1, 0.3]], "float32")
    pred = _f(onp.log(probs))[None]
    with mxt.cpu():
        loss = mxt.gluon.loss.CTCLoss()(mxt.nd.array(pred),
                                        mxt.nd.array([[1.0]]))
    want = -onp.log(0.5 * 0.1 + 0.5 * 0.6 + 0.2 * 0.1)
    onp.testing.assert_allclose(loss.asnumpy(), [want], rtol=1e-6)
