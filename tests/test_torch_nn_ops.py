"""Port parity: the ops of ``mxnet_tpu_torch/ops/nn.py`` that the zoo and
the layers of the vision slice brought in (every name of the JAX
package's ``mxnet_tpu/ops/nn.py`` that the port lacked, and the pooling
cases it refused), held against the JAX package's functions on the same
seeded numpy inputs: the forward, and the backward as ``jax.vjp`` of a
seeded cotangent against torch's autograd.  The output ops
(``SoftmaxOutput``, ``SVMOutput``, ``IdentityAttachKLSparseReg``) ignore
or extend the head gradient in both packages, so the same cotangent
reaches both custom backwards.

Tolerance: float32 forwards and gradients within 2e-5 relative to the
largest magnitude of the JAX result (the two sum windows, channels and
rows in other orders; cuDNN-style transposed convolutions and XLA's
dilated convolution do too); integer results exact.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

RTOL = 2e-5


def _rng(i):
    return onp.random.RandomState(100 + i)


def _close(got, want, what):
    got = onp.asarray(got)
    want = onp.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not onp.issubdtype(want.dtype, onp.floating):
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        onp.testing.assert_array_equal(got, want, err_msg=what)
        return
    both_inf = onp.isinf(want) & (got == want)
    g = onp.where(both_inf, 0.0, got).astype("float64")
    w = onp.where(both_inf, 0.0, want).astype("float64")
    assert (onp.isnan(g) == onp.isnan(w)).all(), what
    g, w = onp.nan_to_num(g), onp.nan_to_num(w)
    scale = max(float(onp.abs(w).max()), 1e-6)
    err = float(onp.abs(g - w).max())
    assert err <= RTOL * scale, "%s: max err %.3g > %.3g" % (
        what, err, RTOL * scale)


def _parity(name, arrays, kw=None, diff=(0,), outputs=None):
    """``name`` of both registries on ``arrays`` (numpy; None passes
    None): forwards equal, and for the float inputs at ``diff`` the vjp
    of a seeded cotangent on the float outputs (``outputs``: their
    indices, default all)."""
    kw = dict(kw or {})
    jfn, tfn = jreg.get_op(name).fn, treg.get_op(name).fn
    j_in = [None if a is None else jnp.asarray(a) for a in arrays]
    t_in = [None if a is None else torch.from_numpy(onp.array(a))
            for a in arrays]
    for i in diff:
        t_in[i].requires_grad_(True)
    j_out = jax.jit(lambda *a: jfn(*a, **kw))(*j_in)
    t_out = tfn(*t_in, **kw)
    many = isinstance(j_out, (tuple, list))
    j_out = list(j_out) if many else [j_out]
    t_out = list(t_out) if many else [t_out]
    assert len(j_out) == len(t_out), name
    for k, (a, b) in enumerate(zip(t_out, j_out)):
        _close(a.detach().numpy(), b, "%s out %d" % (name, k))
    if not diff:
        return
    keep = list(range(len(j_out))) if outputs is None else list(outputs)
    rs = _rng(7)
    cts = [rs.standard_normal(j_out[k].shape).astype("float32")
           for k in keep]

    def f(*d):
        args = list(j_in)
        for i, v in zip(diff, d):
            args[i] = v
        out = jfn(*args, **kw)
        out = list(out) if many else [out]
        return [out[k] for k in keep]
    j_grads = jax.jit(lambda d, c: jax.vjp(f, *d)[1](c))(
        [j_in[i] for i in diff], [jnp.asarray(c) for c in cts])
    t_grads = torch.autograd.grad(
        [t_out[k] for k in keep], [t_in[i] for i in diff],
        [torch.from_numpy(c) for c in cts])
    for i, a, b in zip(diff, t_grads, j_grads):
        _close(a.numpy(), b, "%s grad of input %d" % (name, i))


def _x(i, shape, lo=-1.0, hi=1.0):
    return _rng(i).uniform(lo, hi, shape).astype("float32")


# -- pooling ---------------------------------------------------------------

POOL_CASES = [
    ("max_valid_pad1", (2, 3, 9, 9), dict(kernel=(3, 3), stride=(2, 2),
                                          pad=(1, 1), pool_type="max")),
    ("max_full", (2, 3, 8, 8), dict(kernel=(3, 3), stride=(2, 2),
                                    pool_type="max",
                                    pooling_convention="full")),
    ("avg_full_include_pad", (2, 3, 8, 8),
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
          pooling_convention="full")),
    ("avg_exclude_pad", (2, 3, 7, 7),
     dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), pool_type="avg",
          count_include_pad=False)),
    ("avg_full_exclude_pad", (2, 3, 8, 8),
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
          pooling_convention="full", count_include_pad=False)),
    ("avg_include_pad_true", (2, 3, 6, 6),
     dict(kernel=(2, 2), stride=(2, 2), pad=(1, 1), pool_type="avg",
          count_include_pad=True)),
    ("sum", (2, 3, 6, 6), dict(kernel=(2, 3), stride=(2, 1),
                               pool_type="sum")),
    ("lp2", (2, 3, 6, 6), dict(kernel=(2, 2), pool_type="lp", p_value=2)),
    ("lp3_pad", (2, 3, 6, 6), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                   pool_type="lp", p_value=3)),
    ("max_pad_above_half", (2, 3, 5, 5),
     dict(kernel=(2, 2), stride=(2, 2), pad=(2, 2), pool_type="max")),
    ("avg_pad_above_half_full", (2, 3, 5, 5),
     dict(kernel=(3, 3), stride=(2, 2), pad=(2, 2), pool_type="avg",
          pooling_convention="full")),
    ("avg_1d_full", (2, 3, 9), dict(kernel=(3,), stride=(2,), pad=(1,),
                                    pool_type="avg",
                                    pooling_convention="full")),
    ("max_3d_full", (1, 2, 5, 6, 7), dict(kernel=(2, 2, 2), stride=(2, 2, 2),
                                          pool_type="max",
                                          pooling_convention="full")),
    ("global_max", (2, 3, 5, 5), dict(global_pool=True, pool_type="max")),
    ("global_avg", (2, 3, 5, 5), dict(global_pool=True, pool_type="avg")),
    ("global_sum", (2, 3, 5, 5), dict(global_pool=True, pool_type="sum")),
]


@pytest.mark.parametrize("case", POOL_CASES, ids=[c[0] for c in POOL_CASES])
def test_pooling(case):
    _, shape, kw = case
    _parity("Pooling", [_x(1, shape)], kw)


@pytest.mark.parametrize("conv", ["valid", "full"])
def test_pooling_integer_max(conv):
    x = _rng(2).randint(-50, 50, (2, 3, 7, 7)).astype("int32")
    _parity("Pooling", [x], dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                 pool_type="max", pooling_convention=conv),
            diff=())


def test_pooling_full_shape():
    """The reference's ceil convention: (2, 3, 6, 6), kernel 3, stride 2
    gives 3 x 3 windows (2 x 2 with ``valid``)."""
    x = mxt.nd.array(_x(3, (2, 3, 6, 6)), ctx=mxt.cpu())
    full = mxt.nd.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="avg",
                          pooling_convention="full")
    valid = mxt.nd.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="avg")
    assert full.shape == (2, 3, 3, 3) and valid.shape == (2, 3, 2, 2)


# -- transposed convolution and upsampling ----------------------------------

DECONV_CASES = [
    # (id, data shape, weight shape, attrs): the first route is one
    # conv_transpose call, "composed" has adj at or above stride and
    # dilation
    ("2d_adj1_bias", (2, 4, 5, 5), (4, 3, 3, 3),
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1),
          num_filter=3, no_bias=False)),
    ("2d_composed_groups", (2, 4, 5, 5), (4, 3, 3, 3),
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(2, 2),
          num_filter=6, num_group=2)),
    ("1d_dilate", (2, 3, 7), (3, 2, 4),
     dict(kernel=(4,), stride=(2,), pad=(1,), dilate=(2,), num_filter=2)),
    ("3d", (1, 2, 3, 4, 3), (2, 2, 2, 2, 2),
     dict(kernel=(2, 2, 2), stride=(2, 2, 2), num_filter=2)),
    ("pad_above_k", (2, 3, 6, 6), (3, 2, 2, 2),
     dict(kernel=(2, 2), stride=(2, 2), pad=(2, 2), num_filter=2)),
    ("composed_crop", (2, 3, 6, 6), (3, 2, 2, 2),
     dict(kernel=(2, 2), stride=(2, 2), pad=(2, 2), adj=(3, 1),
          num_filter=2, target_shape=(99, 99))),
]


@pytest.mark.parametrize("case", DECONV_CASES,
                         ids=[c[0] for c in DECONV_CASES])
def test_deconvolution(case):
    _, dshape, wshape, kw = case
    arrays = [_x(4, dshape), _x(5, wshape)]
    diff = (0, 1)
    if not kw.get("no_bias", True):
        arrays.append(_x(6, (kw["num_filter"],)))
        diff = (0, 1, 2)
    _parity("Deconvolution", arrays, kw, diff=diff)


@pytest.mark.parametrize("kw", [dict(scale=2, sample_type="nearest"),
                                dict(scale=2, sample_type="bilinear"),
                                dict(scale=3, sample_type="bilinear")],
                         ids=["nearest2", "bilinear2", "bilinear3"])
def test_upsampling(kw):
    _parity("UpSampling", [_x(7, (2, 3, 4, 5))], kw)


# -- normalization -----------------------------------------------------------

def test_group_norm():
    _parity("GroupNorm", [_x(8, (2, 6, 4, 4), -2, 3), _x(9, (6,)),
                          _x(10, (6,))], dict(num_groups=3, eps=1e-5),
            diff=(0, 1, 2))


def test_instance_norm():
    _parity("InstanceNorm", [_x(11, (2, 3, 5, 5), -2, 3), _x(12, (3,)),
                             _x(13, (3,))], dict(eps=1e-3), diff=(0, 1, 2))


@pytest.mark.parametrize("name", ["LRN", "lrn"])
def test_lrn(name):
    _parity(name, [_x(14, (2, 7, 4, 4))], dict(nsize=5, alpha=1e-2,
                                                beta=0.75, knorm=2.0))


def test_sync_batch_norm_without_group():
    """No group bound: BatchNorm over axis 1, the statistics returned."""
    c = 4
    arrays = [_x(15, (3, c, 5, 5), -1, 2), _x(16, (c,)), _x(17, (c,)),
              onp.zeros(c, "float32"), onp.ones(c, "float32")]
    for name in ("SyncBatchNorm", "_contrib_SyncBatchNorm"):
        _parity(name, arrays, dict(eps=1e-3, fix_gamma=False, ndev=2),
                diff=(0, 1, 2), outputs=(0,))
    _parity("SyncBatchNorm", arrays, dict(use_global_stats=True),
            diff=(0,), outputs=(0,))


def test_sync_batch_norm_on_a_bound_group():
    """Bound to a one-rank gloo group, the statistics go through the
    all-reduce and come back the same."""
    import torch.distributed as dist
    from mxnet_tpu_torch.ops.nn import cross_rank_batch_stats, sync_batch_norm
    c = 4
    arrays = [torch.from_numpy(a) for a in (
        _x(18, (3, c, 5, 5)), _x(19, (c,)), _x(20, (c,)),
        onp.zeros(c, "float32"), onp.ones(c, "float32"))]
    with mxt.cpu():
        mxt.parallel.initialize(backend="gloo")
    try:
        local = sync_batch_norm(*arrays, fix_gamma=False)
        with cross_rank_batch_stats(dist.group.WORLD, 1):
            synced = sync_batch_norm(*arrays, fix_gamma=False)
    finally:
        dist.destroy_process_group()
    for a, b in zip(local, synced):
        assert torch.equal(a, b)


# -- the softmax family and the output ops ----------------------------------

@pytest.mark.parametrize("kw", [{}, {"axis": 1, "temperature": 2.0}],
                         ids=["default", "axis1_t2"])
@pytest.mark.parametrize("name", ["log_softmax", "softmin"])
def test_log_softmax_softmin(name, kw):
    _parity(name, [_x(21, (3, 4, 5), -3, 3)], kw)


@pytest.mark.parametrize("name", ["log_softmax", "softmin"])
def test_integer_input_is_taken_as_float32(name):
    x = onp.array([[1, 2, 3], [4, 0, -2]], "int32")
    _parity(name, [x], diff=())


@pytest.mark.parametrize("mode", ["instance", "channel"])
def test_softmax_activation(mode):
    _parity("SoftmaxActivation", [_x(22, (2, 3, 4), -3, 3)],
            dict(mode=mode))


def _labels(i, n, k, ignore=-1.0):
    lab = _rng(i).randint(0, k, n).astype("float32")
    lab[::3] = ignore
    return lab


SMO_CASES = [
    ("null", dict()),
    ("batch", dict(normalization="batch", grad_scale=2.0)),
    ("valid", dict(normalization="valid")),
    ("ignore_null", dict(use_ignore=True, ignore_label=-1.0)),
    ("ignore_batch", dict(use_ignore=True, normalization="batch")),
    ("ignore_valid", dict(use_ignore=True, normalization="valid",
                          grad_scale=0.5)),
    ("smooth", dict(smooth_alpha=0.1, use_ignore=True)),
]


@pytest.mark.parametrize("case", SMO_CASES, ids=[c[0] for c in SMO_CASES])
@pytest.mark.parametrize("name", ["SoftmaxOutput", "Softmax",
                                  "softmax_output"])
def test_softmax_output(name, case):
    _, kw = case
    _parity(name, [_x(23, (8, 5), -2, 2), _labels(24, 8, 5)], kw)


def test_softmax_output_multi_output_and_shape():
    lab = _rng(25).randint(0, 5, (2, 3, 3)).astype("float32")
    _parity("SoftmaxOutput", [_x(26, (2, 5, 3, 3), -2, 2), lab],
            dict(multi_output=True, normalization="batch"))
    _parity("SoftmaxOutput", [_x(27, (4, 2, 3), -2, 2),
                              _labels(28, 4, 6)],
            dict(preserve_shape=True, normalization="valid"))


def test_softmax_output_gradient_ignores_the_head():
    """The gradient is (p - onehot) / batch whatever the head gradient."""
    x = torch.from_numpy(_x(29, (4, 3))).requires_grad_()
    lab = torch.tensor([0.0, 2.0, 1.0, 1.0])
    out = treg.get_op("SoftmaxOutput").fn(x, lab, normalization="batch")
    out.backward(torch.full_like(out, 123.0))
    want = (torch.softmax(x.detach(), -1)
            - torch.nn.functional.one_hot(lab.long(), 3)) / 4
    assert torch.allclose(x.grad, want, atol=1e-7)


@pytest.mark.parametrize("use_linear", [False, True])
@pytest.mark.parametrize("name", ["SVMOutput", "svm_output"])
def test_svm_output(name, use_linear):
    _parity(name, [_x(30, (6, 5), -2, 2), _labels(31, 6, 5, ignore=1.0)],
            dict(margin=0.5, regularization_coefficient=2.0,
                 use_linear=use_linear))


@pytest.mark.parametrize("with_avg", [False, True])
@pytest.mark.parametrize("name", ["IdentityAttachKLSparseReg",
                                  "identity_attach_KL_sparse_reg"])
def test_kl_sparse_reg(name, with_avg):
    x = _x(32, (6, 2, 2), 0.0, 1.0)
    arrays = [x, _x(33, (4,), 0.1, 0.9) if with_avg else None]
    _parity(name, arrays, dict(sparseness_target=0.2, penalty=0.01,
                               momentum=0.8))


def test_softmax_cross_entropy():
    _parity("softmax_cross_entropy", [_x(34, (6, 5), -2, 2),
                                      _labels(35, 6, 5)])


@pytest.mark.parametrize("name", [
    "LinearRegressionOutput", "linear_regression_output",
    "MAERegressionOutput", "LogisticRegressionOutput",
    "logistic_regression_output"])
def test_regression_outputs(name):
    _parity(name, [_x(36, (4, 3)), _x(37, (4, 3))], dict(grad_scale=2.0))


# -- sequence ops -----------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
def test_sequence_mask(axis):
    shape = (5, 3, 2) if axis == 0 else (3, 5, 2)
    lens = onp.array([2.0, 5.0, 0.0], "float32")
    _parity("SequenceMask", [_x(38, shape), lens],
            dict(use_sequence_length=True, value=-1.0, axis=axis))
    _parity("SequenceMask", [_x(38, shape), None], dict(axis=axis))


@pytest.mark.parametrize("lens", [None, [3.0, 1.0, 4.0], [0.0, 2.0, 4.0]],
                         ids=["no_lengths", "lengths", "zero_length"])
def test_sequence_reverse(lens):
    arrays = [_x(39, (4, 3, 2)),
              None if lens is None else onp.array(lens, "float32")]
    _parity("SequenceReverse", arrays,
            dict(use_sequence_length=lens is not None))


@pytest.mark.parametrize("kw", [dict(num_outputs=3, axis=1),
                                dict(num_outputs=3, axis=1,
                                     squeeze_axis=True),
                                dict(num_outputs=2, axis=0)],
                         ids=["axis1", "squeeze", "axis0"])
@pytest.mark.parametrize("name", ["SliceChannel", "slice_channel"])
def test_slice_channel(name, kw):
    _parity(name, [_x(40, (4, 3, 2))], kw)


# -- the registry -------------------------------------------------------------

@pytest.mark.parametrize("alias, name", [("BatchNorm_v1", "BatchNorm"),
                                         ("Convolution_v1", "Convolution"),
                                         ("Pooling_v1", "Pooling"),
                                         ("deconvolution", "Deconvolution")])
def test_aliases(alias, name):
    assert treg.get_op(alias) is treg.get_op(name)
    assert jreg.get_op(alias) is jreg.get_op(name)


def test_every_op_of_the_module_is_ported():
    names = [n for n in jreg.list_ops()
             if jreg.get_op(n).fn.__module__ == "mxnet_tpu.ops.nn"]
    assert [n for n in names if treg.get_op(n) is None] == []
    assert len(names) == 52


def test_through_nd_on_the_cpu():
    """The new ops as ``mx.nd`` calls: ``SliceChannel`` gives a list and
    ``SoftmaxOutput`` trains through ``autograd``."""
    x = mxt.nd.array(_x(41, (4, 6)), ctx=mxt.cpu())
    parts = mxt.nd.SliceChannel(x, num_outputs=2)
    assert [p.shape for p in parts] == [(4, 3), (4, 3)]
    lab = mxt.nd.array([0, 1, 2, 3], ctx=mxt.cpu())
    x.attach_grad()
    with mxt.autograd.record():
        out = mxt.nd.SoftmaxOutput(x, lab)
    out.backward()
    jx = mx.nd.array(_x(41, (4, 6)))
    jx.attach_grad()
    with mx.autograd.record():
        jout = mx.nd.SoftmaxOutput(jx, mx.nd.array([0, 1, 2, 3]))
    jout.backward()
    _close(x.grad.asnumpy(), jx.grad.asnumpy(), "nd SoftmaxOutput grad")
