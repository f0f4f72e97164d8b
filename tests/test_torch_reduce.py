"""Port parity: ``mxnet_tpu_torch/ops/reduce.py`` against the JAX package's
``mxnet_tpu/ops/reduce.py``, op by op, through ``nd.<op>`` on the same
seeded numpy input.

Tolerance: float32 results within 1e-6 relative (1e-6 absolute near 0;
the two sum in another order), integer results exact, and the dtypes
equal: the JAX package's dtypes are ``jax.numpy``'s with 64-bit types off
(an int32 sum is int32, an int32 mean float32).
"""
import numpy as onp
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.ops.registry import get_op

SHAPE = (3, 4, 5)


def _inputs():
    rng = onp.random.RandomState(7)
    f = rng.uniform(0.5, 1.5, SHAPE).astype("float32")
    f[rng.uniform(size=SHAPE) < 0.2] *= -1
    nan = f.copy()
    nan[0, 1, 2] = nan[2, 3, 0] = onp.nan
    i = rng.randint(-4, 5, SHAPE).astype("int32")
    return {"f32": f, "f32_nan": nan, "int32": i,
            "rhs": onp.zeros((2, 3, 4, 5), "float32"),
            "col": f[:, :1, :]}


# (op, input, attrs): every op the module registers, each alias once
CASES = []
for _op in ("sum", "mean", "prod", "min", "max"):
    for _kw in ({}, {"axis": 1}, {"axis": (0, 2), "keepdims": True},
                {"axis": 1, "exclude": True}, {"axis": ()}):
        CASES += [(_op, "f32", _kw), (_op, "int32", _kw)]
for _op in ("nansum", "nanprod"):
    CASES += [(_op, "f32_nan", {}), (_op, "f32_nan", {"axis": -1}),
              (_op, "int32", {"axis": 0})]
CASES += [
    ("sum_axis", "f32", {"axis": 2}), ("max_axis", "int32", {"axis": 0}),
    ("min_axis", "f32", {"axis": (1, 2)}),
    ("norm", "f32", {}), ("norm", "f32", {"ord": 1, "axis": 1}),
    ("norm", "f32", {"axis": (0, 1), "keepdims": True}),
    ("norm", "int32", {"axis": 2}),
    ("argmax", "f32", {}), ("argmax", "f32", {"axis": 1}),
    ("argmax", "int32", {"axis": -1, "keepdims": True}),
    ("argmin", "f32", {"axis": 2}), ("argmin", "f32", {"keepdims": True}),
    ("argmax_channel", "f32", {}),
    ("broadcast_axis", "col", {"axis": 1, "size": 4}),
    ("broadcast_axes", "col", {"axis": (1,), "size": (3,)}),
    ("broadcast_to", "col", {"shape": (0, 6, 0)}),
    ("broadcast_like", "col", {"rhs": "f32"}),
    ("broadcast_like", "f32", {"rhs": "rhs"}),
    ("broadcast_like", "col", {"rhs": "f32", "lhs_axes": (1,),
                               "rhs_axes": (1,)}),
    ("L2Normalization", "f32", {}),
    ("L2Normalization", "f32", {"mode": "channel"}),
    ("L2Normalization", "f32", {"mode": "spatial", "eps": 1e-3}),
    ("moments", "f32", {"axes": (0, 2)}),
    ("moments", "f32", {"axes": (1,), "keepdims": True}),
    ("moments", "int32", {}),
]


def _id(case):
    op, src, kw = case
    return "%s-%s-%s" % (op, src, "-".join("%s=%s" % i for i in
                                          sorted(kw.items())) or "default")


def _run(pkg, op, src, kw, inputs, ctx):
    arr = lambda a: pkg.nd.array(a, **ctx)
    kw = dict(kw)
    args = [arr(inputs[src])]
    if "rhs" in kw:
        args.append(arr(inputs[kw.pop("rhs")]))
    out = getattr(pkg.nd, op)(*args, **kw)
    return out if isinstance(out, (list, tuple)) else [out]


def test_every_registered_op_is_covered():
    ops = {c[0] for c in CASES}
    assert {get_op(o).name for o in ops} == {
        "sum", "mean", "prod", "min", "max", "nansum", "nanprod", "norm",
        "argmax", "argmin", "argmax_channel", "broadcast_axis",
        "broadcast_to", "broadcast_like", "L2Normalization", "moments"}


@pytest.mark.parametrize("op,src,kw", CASES, ids=[_id(c) for c in CASES])
def test_reduce_op_matches_jax(op, src, kw):
    inputs = _inputs()
    want = _run(mx, op, src, kw, inputs, {})
    got = _run(mxt, op, src, kw, inputs, {"ctx": mxt.cpu()})
    assert len(got) == len(want)
    for t, j in zip(got, want):
        t, j = t.asnumpy(), j.asnumpy()
        assert t.dtype == j.dtype and t.shape == j.shape, \
            (t.dtype, j.dtype, t.shape, j.shape)
        if onp.issubdtype(j.dtype, onp.floating):
            onp.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
        else:
            onp.testing.assert_array_equal(t, j)


def test_integer_mean_and_sum_methods_follow_jax_dtypes():
    """``NDArray.mean`` of int32 is the float32 mean, ``sum`` stays
    int32, as the JAX package's registered ops give them."""
    src = onp.array([1, 2], onp.int32)
    with mxt.cpu():
        a = mxt.nd.array(src)
        mean, total = a.mean(), a.sum()
    assert mean.dtype == onp.float32 and float(mean.asnumpy()) == 1.5
    assert total.dtype == onp.int32 and int(total.asnumpy()) == 3
    j = mx.nd.array(src)
    assert j.mean().dtype == mean.dtype and j.sum().dtype == total.dtype
    assert a.sum(axis=0, keepdims=True).shape == (1,)
