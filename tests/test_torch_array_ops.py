"""Port parity: every operator of ``mxnet_tpu_torch/ops/elemwise.py`` and
``ops/matrix.py`` against the JAX package's ``mxnet_tpu/ops/elemwise.py``
and ``ops/matrix.py``, op by op, through ``nd.<op>`` on the same seeded
numpy inputs on the CPU.

Tolerance: the dtype and shape of every output equal; integer, index,
shape, comparison, ordering and copy results exact; float32 results
within 2e-5 relative and 1e-6 absolute (XLA's CPU transcendentals and
torch's differ by a few ulps; sums and products of a few terms round in
another order); the linear-algebra solvers within 1e-4 relative (LAPACK
through two wrappers); bfloat16 and float16 results within one ulp of
their type (2**-7 and 2**-10 relative), as each package rounds the same
float32 value once.  The ordering ops give the JAX package's indices on
ties (``jax.lax.top_k``: the lower index first).  ``histogram``'s edges
agree within an ulp, not to the bit: XLA contracts and reassociates
``jnp.linspace``'s ``lo * (1 - t) + hi * t`` (its middle edge of
[-2, 2] is 1.5e-8, not 0), so its counts are compared exactly on data
with no value within an ulp of an inner edge, the outer edges included.
"""
import numpy as onp
import pytest

import jax.numpy as jnp
import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.contrib import amp as tamp
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL = 2e-5, 1e-6
LINALG_RTOL = 1e-4
ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def _inputs():
    rng = onp.random.RandomState(11)
    sgn = onp.where(rng.uniform(size=(3, 4, 5)) < 0.5, -1.0, 1.0)
    x = (sgn * rng.uniform(0.2, 2.0, (3, 4, 5))).astype("float32")
    y = rng.uniform(-2, 2, (3, 4, 5)).astype("float32")
    eq = onp.where(rng.uniform(size=x.shape) < 0.3, x, y).astype("float32")
    zeros = onp.where(rng.uniform(size=x.shape) < 0.3, 0, x).astype("float32")
    spd = rng.uniform(-1, 1, (2, 4, 4)).astype("float32")
    spd = (spd @ spd.transpose(0, 2, 1) + 4 * onp.eye(4)).astype("float32")
    low = onp.tril(rng.uniform(0.5, 1.5, (2, 4, 4))).astype("float32")
    ties = onp.array([[1, 3, 3, 0, 3, 1, 2, 2, 0, 1],
                      [5, 5, 5, 5, 4, 4, 6, 6, 0, 5],
                      [0, 0, 0, 0, 0, 0, 0, 0, 0, 0]], "float32")
    return {
        "x": x, "y": y, "eq": eq, "zeros": zeros,
        "yb": rng.uniform(-2, 2, (1, 4, 1)).astype("float32"),
        "ynz": (sgn * rng.uniform(0.5, 2.0, (3, 4, 5))).astype("float32"),
        "pos": rng.uniform(0.1, 3.0, (3, 4, 5)).astype("float32"),
        "posb": rng.uniform(0.5, 2.0, (1, 4, 1)).astype("float32"),
        "unit": rng.uniform(-0.9, 0.9, (3, 4, 5)).astype("float32"),
        "ge1": rng.uniform(1.1, 3.0, (3, 4, 5)).astype("float32"),
        "exps": rng.randint(-3, 4, (3, 4, 5)).astype("float32"),
        "halves": onp.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, -3.7],
                            "float32"),
        "i": rng.randint(-5, 6, (3, 4, 5)).astype("int32"),
        "i2": rng.randint(-5, 6, (3, 4, 5)).astype("int32"),
        "ipos": rng.randint(1, 4, (3, 4, 5)).astype("int32"),
        "m45": rng.uniform(-1, 1, (4, 5)).astype("float32"),
        "m53": rng.uniform(-1, 1, (5, 3)).astype("float32"),
        "m54": rng.uniform(-1, 1, (5, 4)).astype("float32"),
        "m35": rng.uniform(-1, 1, (3, 5)).astype("float32"),
        "v5": rng.uniform(-1, 1, (5,)).astype("float32"),
        "t234": rng.uniform(-1, 1, (2, 3, 4)).astype("float32"),
        "t245": rng.uniform(-1, 1, (2, 4, 5)).astype("float32"),
        "t456": rng.uniform(-1, 1, (4, 5, 6)).astype("float32"),
        "t45": rng.uniform(-1, 1, (4, 5)).astype("float32"),
        "t325": rng.uniform(-1, 1, (3, 2, 5)).astype("float32"),
        "m44": rng.uniform(-1, 1, (2, 4, 4)).astype("float32"),
        "m43": rng.uniform(-1, 1, (2, 4, 3)).astype("float32"),
        "m34": rng.uniform(-1, 1, (2, 3, 4)).astype("float32"),
        "spd": spd, "low": low,
        "sq1": rng.uniform(-1, 1, (3, 1, 5, 1)).astype("float32"),
        "img": rng.uniform(-1, 1, (2, 3, 4, 5)).astype("float32"),
        "d2s": onp.arange(48, dtype="float32").reshape(1, 8, 2, 3),
        "s2d": onp.arange(48, dtype="float32").reshape(1, 2, 4, 6),
        "take_idx": onp.array([[0, 2.7], [4, 9], [-1, -6]], "float32"),
        "pick_idx": onp.array([0, 4, 7], "float32"),
        "pick_idx0": onp.array([0, 2, 1, 5, -1], "float32"),
        "oh_idx": onp.array([[1, 0, -1], [5, 2.7, 3]], "float32"),
        "gnd_idx": onp.array([[0, 2, 1, -1, 2, 5], [3, 0, 1, 2, -2, 1]],
                             "float32"),
        "snd_idx": onp.array([[0, 2, 0, 1, 2, 0], [3, 0, 3, 1, 2, 3]],
                             "float32"),
        "snd_data": rng.uniform(-1, 1, (6,)).astype("float32"),
        "snd_idx1": onp.array([[1, 3, 1, 0]], "float32"),
        "snd_data1": rng.uniform(-1, 1, (4, 5)).astype("float32"),
        "snd_int": rng.randint(-9, 10, (6, 5)).astype("int32"),
        "cond": (rng.uniform(size=(3, 4, 5)) < 0.5).astype("float32"),
        "ties": ties,
        "ravel_idx": onp.array([[0, 1, 2, 1], [3, 0, 4, 2]], "float32"),
        "flat_idx": onp.array([0, 7, 13, 19], "float32"),
        "hist": onp.concatenate([rng.uniform(-2, 2, 98),
                                 [2.0, -2.0]]).astype("float32"),
        "shape_like": onp.zeros((2, 3, 4), "float32"),
        "gpos_data": rng.uniform(-1, 1, (2, 6, 3)).astype("float32"),
        "gpos": onp.array([[0, 5, 9], [2, -1, 3]], "float32"),
    }


INPUTS = _inputs()

# every case: (op, array inputs (input names, or (name, dtype)), attrs)
CASES = []


def _case(op, arrays, **attrs):
    CASES.append((op, tuple(arrays), attrs))


# --- elemwise: the unary table ---------------------------------------------
for _op in ("abs", "sign", "ceil", "floor", "trunc", "fix", "square", "cbrt",
            "rcbrt", "exp", "expm1", "sin", "cos", "arctan", "sinh", "cosh",
            "tanh", "arcsinh", "degrees", "radians", "reciprocal", "negative",
            "erf", "sigmoid", "relu", "softsign", "identity", "_copy",
            "stop_gradient_identity", "BlockGrad_inner", "BlockGrad",
            "stop_gradient", "hard_sigmoid"):
    _case(_op, ["x"])
for _op in ("sqrt", "rsqrt", "log", "log10", "log2", "log1p", "gamma",
            "gammaln"):
    _case(_op, ["pos"])
for _op in ("arcsin", "arccos", "arctanh", "erfinv", "tan"):
    _case(_op, ["unit"])
_case("arccosh", ["ge1"])
_case("rint", ["halves"])
_case("logical_not", ["zeros"])
# integer inputs: which keep their dtype and which become float32
for _op in ("abs", "sign", "rint", "ceil", "floor", "trunc", "fix", "square",
            "exp", "negative", "logical_not", "relu", "degrees", "erf",
            "identity", "cbrt", "softsign", "gamma", "hard_sigmoid"):
    _case(_op, [("i", "int32")])
_case("reciprocal", [("ipos", "int32")])
_case("sqrt", [("ipos", "int32")])
# 16-bit inputs keep their type
for _op in ("exp", "tanh", "sigmoid", "relu", "abs", "rint", "erf", "square",
            "softsign", "negative"):
    _case(_op, [("x", "bfloat16")])
    _case(_op, [("x", "float16")])
_case("log", [("pos", "bfloat16")])
_case("sqrt", [("pos", "float16")])
_case("hard_sigmoid", ["x"], alpha=0.3, beta=0.4)
_case("clip", ["x"], a_min=-0.5, a_max=1.0)
_case("clip", ["x"], a_min=0.0)
_case("clip", [("i", "int32")], a_min=-2, a_max=3)
_case("clip", [("i", "int32")], a_min=0.5, a_max=2.5)
_case("make_loss", ["x"])
_case("make_loss", ["x"], grad_scale=0.3, valid_thresh=0.1)
_case("smooth_l1", ["x"])
_case("smooth_l1", ["x"], scalar=1.5)

# --- the binary table -------------------------------------------------------
for _op in ("elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
            "maximum", "minimum", "hypot", "arctan2"):
    _case(_op, ["x", "y"])
for _op in ("broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
            "broadcast_maximum", "broadcast_minimum", "broadcast_hypot",
            "broadcast_plus", "broadcast_minus", "_add", "_plus", "_sub",
            "_minus", "_mul", "_div"):
    _case(_op, ["x", "yb"])
for _op in ("mod", "broadcast_mod", "_mod"):
    _case(_op, ["x", "ynz"])
for _op in ("power", "broadcast_power", "_power", "pow"):
    _case(_op, ["pos", "y"])
_case("broadcast_power", ["pos", "posb"])
_case("ldexp", ["x", "exps"])
_case("broadcast_add", [("i", "int32"), ("ipos", "int32")])
_case("broadcast_div", [("i", "int32"), ("ipos", "int32")])
_case("mod", [("i", "int32"), ("ipos", "int32")])
_case("mod", [("i", "int32"), ("x", "float32")])
_case("power", [("ipos", "int32"), ("ipos", "int32")])
_case("maximum", [("i", "int32"), ("y", "float32")])
_case("hypot", [("i", "int32"), ("i2", "int32")])
_case("elemwise_mul", [("x", "bfloat16"), ("y", "bfloat16")])
_case("broadcast_add", [("x", "float16"), ("yb", "float32")])
_case("broadcast_maximum", [("x", "bfloat16"), ("yb", "bfloat16")])

# --- comparisons and logic --------------------------------------------------
for _op in ("broadcast_equal", "broadcast_not_equal", "broadcast_greater",
            "broadcast_greater_equal", "broadcast_lesser",
            "broadcast_lesser_equal", "equal", "not_equal", "greater",
            "greater_equal", "lesser", "lesser_equal"):
    _case(_op, ["x", "eq"])
for _op in ("broadcast_logical_and", "broadcast_logical_or",
            "broadcast_logical_xor", "logical_and", "logical_or",
            "logical_xor"):
    _case(_op, ["zeros", "cond"])
_case("broadcast_equal", [("i", "int32"), ("i2", "int32")])
_case("broadcast_lesser", [("i", "int32"), ("x", "float32")])
_case("broadcast_greater", [("x", "bfloat16"), ("eq", "bfloat16")])
_case("logical_or", [("i", "int32"), ("i2", "int32")])

# --- scalar ops ---------------------------------------------------------------
for _op, _src, _s in (("_plus_scalar", "x", 1.5), ("_minus_scalar", "x", 1.5),
                      ("_rminus_scalar", "x", 1.5), ("_mul_scalar", "x", 1.5),
                      ("_div_scalar", "x", 1.5), ("_rdiv_scalar", "x", 1.5),
                      ("_mod_scalar", "x", 0.7), ("_mod_scalar", "x", -0.7),
                      ("_rmod_scalar", "ynz", 2.5),
                      ("_rmod_scalar", "ynz", -2.5),
                      ("_power_scalar", "pos", 2.5),
                      ("_rpower_scalar", "x", 1.5),
                      ("_maximum_scalar", "x", 0.3),
                      ("_minimum_scalar", "x", 0.3),
                      ("_hypot_scalar", "x", 1.5),
                      ("_equal_scalar", "halves", 0.5),
                      ("_not_equal_scalar", "halves", 0.5),
                      ("_greater_scalar", "x", 0.3),
                      ("_greater_equal_scalar", "halves", 0.5),
                      ("_lesser_scalar", "x", 0.3),
                      ("_lesser_equal_scalar", "halves", 0.5)):
    _case(_op, [_src], scalar=_s)
for _op, _s in (("_plus_scalar", 2), ("_plus_scalar", 1.5),
                ("_div_scalar", 2), ("_mod_scalar", 3), ("_mod_scalar", -3),
                ("_rmod_scalar", 7), ("_power_scalar", 2),
                ("_power_scalar", 0.5), ("_maximum_scalar", 2),
                ("_maximum_scalar", 1.5), ("_minimum_scalar", -1),
                ("_hypot_scalar", 2), ("_equal_scalar", 2),
                ("_greater_scalar", 1.5), ("_rminus_scalar", 4)):
    _case(_op, [("ipos" if _op in ("_rmod_scalar", "_power_scalar")
                 else "i", "int32")], scalar=_s)
for _op in ("_plus_scalar", "_mul_scalar", "_rdiv_scalar", "_maximum_scalar"):
    _case(_op, [("x", "bfloat16")], scalar=1.5)
_case("where", ["cond", "x", "y"])
_case("where", [("cond", "float32"), ("i", "int32"), ("x", "float32")])

# --- matrix: products and shapes ----------------------------------------------
_case("dot", ["m45", "m53"])
_case("dot", ["m54", "m53"], transpose_a=True)
_case("dot", ["m45", "m35"], transpose_b=True)
_case("dot", ["t234", "m45"])
_case("dot", ["t234", "t456"])
_case("dot", ["t325", "m35"], transpose_a=True)
_case("dot", ["v5", "v5"])
_case("dot", ["m45", "v5"])
_case("dot", [("m45", "bfloat16"), ("m53", "bfloat16")])
_case("batch_dot", ["t234", "t245"])
_case("batch_dot", ["m43", "m43"], transpose_a=True)
_case("batch_dot", ["t234", "m34"], transpose_b=True)
_case("transpose", ["x"])
_case("transpose", ["x"], axes=(1, 0, 2))
_case("swapaxes", ["x"], dim1=0, dim2=2)
_case("SwapAxis", ["x"], dim1=1, dim2=2)
_case("expand_dims", ["x"], axis=1)
_case("expand_dims", ["x"], axis=-1)
_case("squeeze", ["sq1"])
_case("squeeze", ["sq1"], axis=1)
_case("squeeze", ["sq1"], axis=(1, 3))
_case("Flatten", ["x"])
_case("flatten", ["img"])
for _shape, _kw in (((0, -1), {}), ((-2,), {}), ((-3, 0), {}),
                    ((-4, 1, 3, 0, 0), {}), ((0, 0, -4, 5, -1), {}),
                    ((-1, 5), {"reverse": True}), ((0, 2, 10), {"reverse": True}),
                    ((20, -1), {}), ((3, -4, 2, -1, 5), {})):
    _case("Reshape", ["x"], shape=_shape, **_kw)
_case("reshape", ["x"], shape=(0, -3))
_case("Reshape", ["x"], target_shape=(0, 10))
_case("Reshape", ["x"], target_shape=(5, 0, 2), keep_highest=True)
_case("slice", ["x"], begin=(0, 1), end=(2, 3))
_case("slice", ["x"], begin=(None, 3, 1), end=(None, 0, None),
      step=(1, -1, 2))
_case("slice", ["x"], begin=(2, None), end=(None, None), step=(-2, None))
_case("slice", ["x"], begin=(-1,), end=(None,), step=(-1,))
_case("slice_axis", ["x"], axis=1, begin=1, end=3)
_case("slice_axis", ["x"], axis=2, begin=-2, end=None)
_case("slice_axis", ["x"], axis=-1, begin=0, end=-1)
_case("slice_like", ["x", "shape_like"])
_case("slice_like", ["x", "shape_like"], axes=(0, 2))
_case("take", ["m54", "take_idx"])
_case("take", ["m54", "take_idx"], mode="wrap")
_case("take", ["x", "take_idx"], axis=2)
_case("take", ["x", "take_idx"], axis=-1, mode="wrap")
_case("pick", ["m35", "pick_idx"])
_case("pick", ["m35", "pick_idx"], keepdims=True)
_case("pick", ["m35", "pick_idx0"], axis=0)
_case("one_hot", ["oh_idx"], depth=4)
_case("one_hot", ["oh_idx"], depth=4, on_value=3.0, off_value=-1.0)
_case("one_hot", ["oh_idx"], depth=5, dtype="int32")
_case("one_hot", ["oh_idx"], depth=3, dtype="float16")
_case("gather_nd", ["x", "gnd_idx"])
_case("gather_nd", [("i", "int32"), ("gnd_idx", "int32")])
_case("gather_positions", ["gpos_data", "gpos"])
_case("_contrib_gather_positions", ["gpos_data", "gpos"])
_case("scatter_nd", ["snd_data", "snd_idx"], shape=(3, 4))
_case("scatter_nd", ["snd_data1", "snd_idx1"], shape=(4, 5))
_case("scatter_nd", [("snd_int", "int32"), ("gnd_idx", "int32")],
      shape=(3, 4, 5))
_case("repeat", ["t234"], repeats=2)
_case("repeat", ["t234"], repeats=3, axis=1)
_case("tile", ["t234"], reps=(2, 1, 3))
_case("tile", ["t234"], reps=(2,))
_case("reverse", ["x"], axis=1)
_case("reverse", ["x"], axis=(0, 2))
_case("flip", ["x"], axis=0)
for _mode in ("constant", "edge", "reflect"):
    _case("Pad", ["img"], mode=_mode, pad_width=(0, 0, 0, 0, 1, 2, 2, 1))
_case("pad", ["img"], mode="constant", pad_width=(0, 0, 1, 0, 0, 3, 1, 1),
      constant_value=1.5)
_case("pad", ["img"], mode="reflect", pad_width=(0, 0, 0, 0, 3, 3, 4, 4))
_case("Cast", ["x"], dtype="int32")
_case("cast", ["x"], dtype="float16")
_case("Cast", [("i", "int32")], dtype="bfloat16")
_case("amp_cast", ["x"], dtype="bfloat16")
_case("shape_array", ["x"])
_case("size_array", ["img"])
_case("zeros_like", [("i", "int32")])
_case("ones_like", ["x"])
_case("diag", ["v5"])
_case("diag", ["v5"], k=1)
_case("diag", ["m45"], k=-1)
_case("diag", ["x"], k=1, axis1=1, axis2=2)
_case("tril", ["m45"])
_case("tril", ["m45"], k=-1)
_case("tril", ["x"], k=1)

# --- ordering: ties to the lower index ----------------------------------------
for _src in ("ties", ("ties", "bfloat16"), ("ties", "int32")):
    _case("topk", [_src], k=3)
    _case("topk", [_src], k=4, ret_typ="both")
    _case("topk", [_src], k=3, ret_typ="value", is_ascend=True)
    _case("topk", [_src], k=2, ret_typ="indices", is_ascend=True,
          dtype="int32")
    _case("topk", [_src], k=2, ret_typ="mask")
    _case("topk", [_src], k=2, axis=0, ret_typ="both")
    _case("sort", [_src])
    _case("sort", [_src], is_ascend=False)
    _case("sort", [_src], axis=0, is_ascend=False)
    _case("argsort", [_src])
    _case("argsort", [_src], is_ascend=False)
    _case("argsort", [_src], axis=0, dtype="int32")
_case("topk", ["x"], k=2, axis=1, ret_typ="both")
_case("topk", ["x"], k=3, ret_typ="mask", is_ascend=True)
_case("depth_to_space", ["d2s"], block_size=2)
_case("space_to_depth", ["s2d"], block_size=2)
_case("histogram", ["hist"], bin_cnt=5)
_case("histogram", ["hist"], bin_cnt=7, range=(-1.0, 1.5))
_case("histogram", ["hist"])

# --- linalg and index arithmetic ------------------------------------------------
_case("linalg_gemm", ["m44", "m44", "m44"])
_case("linalg_gemm", ["m43", "m43", "m44"], transpose_b=True, alpha=0.5,
      beta=-2.0)
_case("linalg_gemm", ["m43", "m44", "m34"], transpose_a=True,
      transpose_b=True)
_case("linalg_gemm2", ["m44", "m43"])
_case("linalg_gemm2", ["m43", "m43"], transpose_a=True, alpha=3.0)
_case("linalg_potrf", ["spd"])
_case("linalg_potri", ["low"])
_case("linalg_trmm", ["low", "m43"])
_case("linalg_trmm", ["low", "m34"], rightside=True, transpose=True,
      alpha=2.0)
for _t in (False, True):
    for _r in (False, True):
        _case("linalg_trsm", ["low", "m34" if _r else "m43"], transpose=_t,
              rightside=_r, alpha=1.5)
_case("linalg_trsm", ["low", "m43"], lower=False, transpose=True)
_case("linalg_sumlogdiag", ["spd"])
_case("linalg_syrk", ["m43"])
_case("linalg_syrk", ["m43"], transpose=True, alpha=0.5)
_case("linalg_gelqf", ["m35"])
_case("linalg_gelqf", ["m34"])
_case("linalg_extractdiag", ["m44"])
_case("linalg_extractdiag", ["m44"], offset=1)
_case("linalg_makediag", ["m34"])
_case("linalg_makediag", ["m34"], offset=-1)
_case("linalg_inverse", ["spd"])
_case("linalg_det", ["spd"])
_case("linalg_det", ["m44"])
_case("linalg_slogdet", ["m44"])
_case("_ravel_multi_index", ["ravel_idx"], shape=(3, 5))
_case("ravel_multi_index", [("ravel_idx", "int32")], shape=(4, 6))
_case("_unravel_index", ["flat_idx"], shape=(4, 5))
_case("unravel_index", [("flat_idx", "int32")], shape=(2, 2, 5))

LINALG_SOLVERS = ("linalg_potrf", "linalg_potri", "linalg_trsm",
                  "linalg_inverse", "linalg_det", "linalg_slogdet",
                  "linalg_gelqf", "linalg_sumlogdiag")


def _id(case):
    op, arrays, attrs = case
    src = "-".join(a if isinstance(a, str) else "%s:%s" % a for a in arrays)
    kw = "-".join("%s=%s" % kv for kv in sorted(attrs.items()))
    return "%s[%s]%s" % (op, src, kw)


def _jax_array(a, dt):
    if dt == "bfloat16":
        return mx.nd.array(a, dtype=jnp.bfloat16)
    return mx.nd.array(a, dtype=dt)


def _run(pkg, op, arrays, attrs):
    args = []
    for a in arrays:
        name, dt = (a, "float32") if isinstance(a, str) else a
        if pkg is mx:
            args.append(_jax_array(INPUTS[name], dt))
        else:
            args.append(mxt.nd.array(INPUTS[name], ctx=mxt.cpu(), dtype=dt))
    out = getattr(pkg.nd, op)(*args, **attrs)
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _dtype(o):
    return str(o.dtype).replace("torch.", "")


def _values(o):
    return onp.asarray(o.astype("float32").asnumpy(), "float64") \
        if _dtype(o) in ("bfloat16", "float16") else o.asnumpy()


def _compare(op, j, p):
    assert len(j) == len(p)
    for jo, po in zip(j, p):
        jdt, pdt = _dtype(jo), _dtype(po)
        assert jdt == pdt, (jdt, pdt)
        assert tuple(jo.shape) == tuple(po.shape), (jo.shape, po.shape)
        jv, pv = _values(jo), _values(po)
        if jdt in ULP:
            big = onp.maximum(abs(jv), abs(pv))
            assert (abs(jv - pv) <= ULP[jdt] * big + 1e-7).all(), \
                abs(jv - pv).max()
        elif onp.issubdtype(jv.dtype, onp.floating):
            rtol = LINALG_RTOL if op in LINALG_SOLVERS else RTOL
            onp.testing.assert_allclose(pv, jv, rtol=rtol, atol=ATOL)
        else:
            onp.testing.assert_array_equal(pv, jv)


_JAX_OUT = {}


def _jax_outputs(i):
    """The JAX package's outputs of ``CASES[i]`` (each case runs once)."""
    if i not in _JAX_OUT:
        op, arrays, attrs = CASES[i]
        _JAX_OUT[i] = _run(mx, op, arrays, attrs)
    return _JAX_OUT[i]


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_id(c) for c in CASES])
def test_op_matches_jax(i):
    op, arrays, attrs = CASES[i]
    _compare(op, _jax_outputs(i), _run(mxt, op, arrays, attrs))


# exact for the results that are indices, orders, counts or copies
EXACT = ("topk", "sort", "argsort", "one_hot", "take", "pick", "gather_nd",
         "depth_to_space", "space_to_depth", "Reshape", "slice",
         "_unravel_index", "shape_array", "size_array", "reverse", "tile",
         "repeat", "Pad")


@pytest.mark.parametrize("op", EXACT)
def test_exact_ops_give_the_same_bits(op):
    """Every case of an op that moves, counts or orders values gives the
    JAX package's values bit for bit, float ones too."""
    cases = [i for i, c in enumerate(CASES) if c[0] == op]
    assert cases
    for i in cases:
        _, arrays, attrs = CASES[i]
        j, p = _jax_outputs(i), _run(mxt, op, arrays, attrs)
        for jo, po in zip(j, p):
            assert onp.array_equal(_values(jo), _values(po)), (op, attrs)


def _item1_names():
    """The JAX registry's names of ``ops/elemwise.py`` and ``ops/matrix.py``,
    those it registers straight from ``jax.numpy``, ``jax.nn`` and
    ``jax.scipy.special`` included."""
    out = []
    for name in jreg.list_ops():
        mod = getattr(jreg.get_op(name).fn, "__module__", "") or ""
        if mod in ("mxnet_tpu.ops.elemwise", "mxnet_tpu.ops.matrix") \
                or mod.startswith("jax"):
            out.append(name)
    return out


def test_every_elemwise_and_matrix_op_is_ported_and_has_a_case():
    names = _item1_names()
    assert len(names) == 181
    assert [n for n in names if treg.get_op(n) is None] == []
    covered = {c[0] for c in CASES}
    assert [n for n in names if n not in covered] == []


def test_registry_left_missing_only_later_modules():
    """Of the JAX registry, the port lacks only the ops of contrib,
    vision, quantization, detection and ``Custom`` (``ops/nn.py`` is
    whole)."""
    later = ("mxnet_tpu.ops.contrib_ops",
             "mxnet_tpu.ops.vision", "mxnet_tpu.ops.quantization",
             "mxnet_tpu.ops.detection", "mxnet_tpu.operator")
    missing = [n for n in jreg.list_ops() if treg.get_op(n) is None]
    assert len(missing) == 92
    assert [n for n in missing
            if jreg.get_op(n).fn.__module__ not in later] == []


def test_topk_ties_resolve_to_the_lower_index():
    """The smallest input of the fault: bfloat16 [1, 1, 1, 0], k = 2."""
    a = onp.array([1, 1, 1, 0], "float32")
    j = mx.nd.topk(mx.nd.array(a, dtype=jnp.bfloat16), k=2)
    p = mxt.nd.topk(mxt.nd.array(a, ctx=mxt.cpu(), dtype="bfloat16"), k=2)
    assert j.asnumpy().tolist() == p.asnumpy().tolist() == [0.0, 1.0]
    d = mxt.nd.argsort(mxt.nd.array(a, ctx=mxt.cpu()), is_ascend=False)
    assert d.asnumpy().tolist() == [2.0, 1.0, 0.0, 3.0]


def test_depth_to_space_order_is_not_pixel_shuffle():
    """The JAX package's channel order differs from torch's pixel_shuffle
    on a non-symmetric input; the port gives the JAX package's."""
    import torch
    x = INPUTS["d2s"]
    p = mxt.nd.depth_to_space(mxt.nd.array(x, ctx=mxt.cpu()), block_size=2)
    j = mx.nd.depth_to_space(mx.nd.array(x), block_size=2)
    assert onp.array_equal(p.asnumpy(), j.asnumpy())
    shuffled = torch.nn.functional.pixel_shuffle(torch.from_numpy(x), 2)
    assert not onp.array_equal(p.asnumpy(), shuffled.numpy())
    back = mxt.nd.space_to_depth(p, block_size=2)
    assert onp.array_equal(back.asnumpy(), x)


def test_scatter_nd_adds_duplicates():
    idx = onp.array([[0, 0, 1]], "float32")
    vals = onp.array([1.0, 2.0, 5.0], "float32")
    p = mxt.nd.scatter_nd(mxt.nd.array(vals, ctx=mxt.cpu()),
                          mxt.nd.array(idx, ctx=mxt.cpu()), shape=(3,))
    assert p.asnumpy().tolist() == [3.0, 5.0, 0.0]


def test_gelqf_signs_and_reconstruction():
    a = INPUTS["m35"]
    q, l = mxt.nd.linalg_gelqf(mxt.nd.array(a, ctx=mxt.cpu()))
    q, l = q.asnumpy(), l.asnumpy()
    assert (onp.diagonal(l, axis1=-2, axis2=-1) > 0).all()
    onp.testing.assert_allclose(l @ q, a, rtol=1e-5, atol=1e-5)
    onp.testing.assert_allclose(q @ q.T, onp.eye(3), atol=1e-5)


@pytest.fixture
def amp_off():
    yield
    jamp.disable()
    tamp.disable()


@pytest.mark.parametrize("op, arrays, dtypes", [
    ("exp", ["x"], ("float16",)),
    ("log", ["pos"], ("float16",)),
    ("rsqrt", ["pos"], ("float16",)),
    ("broadcast_add", ["x", "yb"], ("float16", "float32")),
    ("maximum", ["x", "y"], ("float32", "float16")),
    ("dot", ["m45", "m53"], ("float32", "float32")),
    ("relu", ["x"], ("float16",)),
])
def test_amp_policy_reaches_the_new_ops(amp_off, op, arrays, dtypes):
    """Under ``amp.init("float16")`` the new ops take the JAX package's
    dtypes: the float32 list (``exp``, ``log``, ``rsqrt``), the widest
    type (``broadcast_add``, ``maximum``), the target type (``dot``) and
    an op in no list (``relu``)."""
    jamp.init(target_dtype="float16")
    tamp.init(target_dtype="float16")
    arrays = [(a, d) for a, d in zip(arrays, dtypes)]
    _compare(op, _run(mx, op, arrays, {}), _run(mxt, op, arrays, {}))


@pytest.mark.parametrize("op, attrs, scale", [
    ("make_loss", {"grad_scale": 0.3}, 1.6),
    ("make_loss", {}, 3.0),
    ("BlockGrad", {}, 1.0),
    ("stop_gradient", {}, 1.0),
    ("identity", {}, 3.0),
    ("BlockGrad_inner", {}, 3.0),
])
def test_gradient_through_the_identity_ops_matches_jax(op, attrs, scale):
    """``make_loss`` passes ``grad_scale`` back, ``BlockGrad`` nothing,
    the identities everything: the gradient of ``sum(x + op(2 x))`` in
    both packages."""
    x = INPUTS["x"]
    grads = []
    for pkg, kw in ((mx, {}), (mxt, {"ctx": mxt.cpu()})):
        a = pkg.nd.array(x, **kw)
        a.attach_grad()
        with pkg.autograd.record():
            y = (a + getattr(pkg.nd, op)(a * 2, **attrs)).sum()
        y.backward()
        grads.append(a.grad.asnumpy())
    onp.testing.assert_allclose(grads[1], grads[0], rtol=RTOL)
    onp.testing.assert_allclose(grads[1], onp.full(x.shape, scale,
                                                   "float32"), rtol=RTOL)
