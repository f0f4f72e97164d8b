"""Port parity for NDArray's surface: ``mxnet_tpu_torch/ndarray/ndarray.py``
(methods, operators, indexing, item assignment, ``out=`` and the module's
constructors), ``ndarray/utils.py`` and ``ndarray/legacy_io.py`` (``save``
and ``load`` with bfloat16, ``save_dict``/``load_dict``, upstream MXNet's
binary format), ``base.py``, ``context.py`` and ``SequenceLast`` against
the JAX package on the CPU, on the same seeded numpy inputs.

Tolerance: dtypes and shapes equal; every value here is exact (copies,
indexing, integer and comparison results, float32 operators that round
once in both packages) except ``linspace`` and the operators that divide
or raise to a power, held to 1e-6 relative.
"""
import os
import struct

import numpy as onp
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
import mxnet_tpu_torch as mxt
from mxnet_tpu.ndarray import legacy_io as jlegacy
from mxnet_tpu_torch.ndarray import legacy_io as tlegacy

RTOL = 1e-6


def _x(shape=(2, 3, 4, 5), seed=3, dtype="float32"):
    rng = onp.random.RandomState(seed)
    return rng.uniform(-2, 2, shape).astype(dtype)


def _pair(a, dtype=None):
    """The same numpy array in both packages (the port's on the CPU)."""
    j = mx.nd.array(a, dtype=jnp.bfloat16 if dtype == "bfloat16" else dtype)
    return j, mxt.nd.array(a, ctx=mxt.cpu(), dtype=dtype)


def _dt(o):
    return str(o.dtype).replace("torch.", "")


def _same(j, p, rtol=0.0):
    assert _dt(j) == _dt(p), (_dt(j), _dt(p))
    assert tuple(j.shape) == tuple(p.shape), (j.shape, p.shape)
    jv = j.astype("float32").asnumpy() if _dt(j) == "bfloat16" else j.asnumpy()
    pv = p.astype("float32").asnumpy() if _dt(p) == "bfloat16" else p.asnumpy()
    if rtol:
        onp.testing.assert_allclose(pv, jv, rtol=rtol, atol=1e-7)
    else:
        onp.testing.assert_array_equal(pv, jv)


# --- methods -----------------------------------------------------------------
METHODS = [
    ("T", lambda a: a.T),
    ("copy", lambda a: a.copy()),
    ("flatten", lambda a: a.flatten()),
    ("expand_dims", lambda a: a.expand_dims(1)),
    ("squeeze", lambda a: a.reshape((2, 1, 12, 5)).squeeze()),
    ("squeeze_axis", lambda a: a.reshape((2, 1, 12, 5)).squeeze(axis=1)),
    ("broadcast_to", lambda a: a[:, :1].broadcast_to((3, 2, 3, 4, 5))),
    ("broadcast_like", lambda a: a[0, :, :1].broadcast_like(a[1])),
    ("reshape_like", lambda a: a.reshape_like(a.reshape((6, 20)))),
    ("zeros_like", lambda a: a.zeros_like()),
    ("ones_like", lambda a: a.ones_like()),
    ("tostype", lambda a: a.tostype("default")),
    ("op_exp", lambda a: a.exp()),
    ("op_topk", lambda a: a.topk(k=2, axis=1)),
    ("op_clip", lambda a: a.clip(a_min=-1.0, a_max=0.5)),
    ("op_one_hot", lambda a: (a[0, 0, 0] + 2).one_hot(depth=5)),
    ("op_sum", lambda a: a.sum(axis=1)),
    ("op_transpose", lambda a: a.transpose((1, 0, 3, 2))),
    ("op_pick", lambda a: a[0, 0].pick(a[0, 0, :, 0].abs(), axis=1)),
]


@pytest.mark.parametrize("name, fn", METHODS, ids=[m[0] for m in METHODS])
def test_method_matches_jax(name, fn):
    j, p = _pair(_x())
    _same(fn(j), fn(p), rtol=RTOL if name == "op_exp" else 0.0)


def test_scalar_properties_and_conversions():
    j, p = _pair(_x())
    assert p.ndim == j.ndim == 4
    assert p.stype == j.stype == "default"
    assert p.ctx == p.context == mxt.cpu()
    assert p.as_in_ctx(mxt.cpu()) is p
    one_j, one_p = _pair(onp.array([2.75], "float32"))
    assert one_p.item() == one_j.item() == 2.75
    assert float(one_p) == float(one_j) and int(one_p) == int(one_j) == 2
    assert bool(one_p) and not bool(_pair(onp.zeros(1, "float32"))[1])
    assert not bool(mxt.nd.zeros((0,), ctx=mxt.cpu()))
    with pytest.raises(ValueError):
        bool(p)
    with pytest.raises(ValueError):
        bool(j)
    with pytest.raises(AttributeError):
        p.tojson()
    with pytest.raises(AttributeError):
        p.no_such_op
    p.wait_to_write()
    with pytest.raises(mxt.MXNetError):
        p.tostype("csr")


# --- operators ----------------------------------------------------------------
OPERATORS = [
    ("matmul", lambda a, b: a[0, 0] @ b[0, 0].T, RTOL),
    ("pow", lambda a, b: abs(a) ** b, RTOL),
    ("pow_scalar", lambda a, b: a ** 2, 0.0),
    ("rpow", lambda a, b: 2.0 ** a, RTOL),
    ("mod", lambda a, b: a % b, RTOL),
    ("mod_scalar", lambda a, b: a % 0.7, RTOL),
    ("rmod", lambda a, b: 3.0 % a, RTOL),
    ("floordiv", lambda a, b: a // b, 0.0),
    ("floordiv_scalar", lambda a, b: a // 0.3, 0.0),
    ("rfloordiv", lambda a, b: 3.0 // a, 0.0),
    ("abs", lambda a, b: abs(a), 0.0),
    ("neg", lambda a, b: -a, 0.0),
    ("rsub", lambda a, b: 1.0 - a, 0.0),
    ("rtruediv", lambda a, b: 1.0 / a, RTOL),
    ("eq", lambda a, b: a == b, 0.0),
    ("eq_scalar", lambda a, b: (a * 0).abs() == 0, 0.0),
    ("ne", lambda a, b: a != b, 0.0),
    ("ne_scalar", lambda a, b: a != 1.0, 0.0),
    ("lt", lambda a, b: a < b, 0.0),
    ("ge_numpy", lambda a, b: a >= onp.zeros(5, "float32"), 0.0),
]


@pytest.mark.parametrize("name, fn, rtol", OPERATORS,
                         ids=[o[0] for o in OPERATORS])
def test_operator_matches_jax(name, fn, rtol):
    xa, xb = _x(seed=4), _x(seed=5)
    xb[0, 0] = xa[0, 0]                  # some equal elements
    ja, pa = _pair(xa)
    jb, pb = _pair(xb)
    _same(fn(ja, jb), fn(pa, pb), rtol=rtol)


@pytest.mark.parametrize("dtype", ["int32", "bfloat16"])
def test_operator_dtypes_match_jax(dtype):
    a = onp.array([[3, -7, 5], [8, 1, -2]], "float32")
    b = onp.array([[2, 3, -4], [5, 2, 7]], "float32")
    ja, pa = _pair(a, dtype)
    jb, pb = _pair(b, dtype)
    for fn in (lambda x, y: x % y, lambda x, y: x // y, lambda x, y: x ** 2,
               lambda x, y: x == y, lambda x, y: x != 3, lambda x, y: abs(x),
               lambda x, y: x % 3, lambda x, y: x * 2.5):
        _same(fn(ja, jb), fn(pa, pb))


def test_inplace_mod_rebinds():
    j, p = _pair(_x())
    pv = p[0]
    j %= 0.5
    p %= 0.5
    _same(j, p, rtol=RTOL)
    assert pv.shape == (3, 4, 5) and not (pv.asnumpy() == p[0].asnumpy()).all()


def test_equality_is_elementwise_and_containers_still_work():
    """``==`` is element-wise (an NDArray), the hash stays the identity's:
    dicts, sets and ``in`` on the identical object keep working (``in``
    past a different array raises, in both packages), and a Trainer finds
    and updates its parameters."""
    a = mxt.nd.array([1.0, 2.0], ctx=mxt.cpu())
    b = mxt.nd.array([1.0, 2.0], ctx=mxt.cpu())
    assert isinstance(a == b, mxt.nd.NDArray)
    assert (a == b).asnumpy().tolist() == [1.0, 1.0]
    assert (a == None) is False and (a != None) is True  # noqa: E711
    assert hash(a) != hash(b)
    d = {a: "a", b: "b"}
    assert d[a] == "a" and d[b] == "b" and len({a, b, a}) == 2
    assert a in [a, b]
    ja, jb = mx.nd.array([1.0, 2.0]), mx.nd.array([1.0, 2.0])
    for x, y in ((a, b), (ja, jb)):
        with pytest.raises(ValueError):
            y in [x, y]
    with mxt.cpu():
        net = mxt.gluon.nn.Dense(3, in_units=4, prefix="surf_")
        net.initialize()
        params = net.collect_params()
        w0 = params["surf_weight"].data().asnumpy().copy()
        tr = mxt.gluon.Trainer(params, "sgd", {"learning_rate": 0.5})
        x = mxt.nd.array(_x((2, 4)))
        with mxt.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(2)
    assert not onp.allclose(params["surf_weight"].data().asnumpy(), w0)


# --- indexing ----------------------------------------------------------------
def _nd(pkg, v, dtype=None):
    if pkg is mx:
        return mx.nd.array(v, dtype=dtype)
    return mxt.nd.array(v, ctx=mxt.cpu(), dtype=dtype)


INDEX = [
    ("nd_float", lambda pkg: _nd(pkg, [1, 0])),
    ("nd_int32", lambda pkg: _nd(pkg, [[0, 1], [1, 1]], "int32")),
    ("list", lambda pkg: onp.array([1, 0, 1]) if pkg is mx else [1, 0, 1]),
    ("numpy", lambda pkg: onp.array([1, -1])),
    ("int_and_nd", lambda pkg: (1, _nd(pkg, [0, 2]))),
    ("slice_list_step", lambda pkg: (slice(None), [0, 2], slice(None, None, 2))),
    ("ellipsis_nd", lambda pkg: (Ellipsis, _nd(pkg, [4, 0, 4]))),
    ("none_int", lambda pkg: (None, 1)),
    ("negative_step", lambda pkg: slice(None, None, -1)),
    ("negative_steps", lambda pkg: (slice(None), slice(2, 0, -1), 1,
                                    slice(None, None, -2))),
    ("clipped", lambda pkg: _nd(pkg, [5, -3])),
    ("two_arrays", lambda pkg: (_nd(pkg, [0, 1]), slice(None),
                                _nd(pkg, [3, 2]))),
    ("basic", lambda pkg: (1, slice(0, 2), -1)),
    ("bool_mask", lambda pkg: onp.array([True, False])),
]


@pytest.mark.parametrize("name, key", INDEX, ids=[i[0] for i in INDEX])
def test_getitem_matches_jax(name, key):
    j, p = _pair(_x())
    _same(j[key(mx)], p[key(mxt)])


def test_the_fault_case_gathers_along_the_first_axis():
    j, p = _pair(_x())
    out = p[mxt.nd.array([1, 0], ctx=mxt.cpu())]
    assert out.shape == j[mx.nd.array([1, 0])].shape == (2, 3, 4, 5)


SETITEM = [
    ("whole", lambda pkg: slice(None), lambda pkg: 1.5),
    ("whole_array", lambda pkg: slice(None),
     lambda pkg: _nd(pkg, _x((4, 5), seed=9))),
    ("slice", lambda pkg: slice(1, None), lambda pkg: -2.0),
    ("int", lambda pkg: 0, lambda pkg: _nd(pkg, _x((3, 4, 5), seed=8))),
    ("numpy_value", lambda pkg: (1, 2), lambda pkg: _x((4, 5), seed=7)),
    ("advanced", lambda pkg: (slice(None), _nd(pkg, [2, 0])), lambda pkg: 0.25),
    ("negative_step", lambda pkg: (0, slice(None, None, -1), 0),
     lambda pkg: _nd(pkg, _x((3, 5), seed=6))),
]


@pytest.mark.parametrize("name, key, value", SETITEM,
                         ids=[s[0] for s in SETITEM])
def test_setitem_matches_jax_and_rebinds(name, key, value):
    """``a[key] = v`` gives the JAX package's array, and a slice taken
    from ``a`` before keeps its old values, as the JAX package's does."""
    j, p = _pair(_x())
    jv, pv = j[1:], p[1:]
    before = pv.asnumpy().copy()
    j[key(mx)] = value(mx)
    p[key(mxt)] = value(mxt)
    _same(j, p)
    _same(jv, pv)
    onp.testing.assert_array_equal(pv.asnumpy(), before)


def test_setitem_on_a_variable():
    """A variable is written in place outside recording (it stays the
    leaf its gradient reaches) and refused while recording."""
    with mxt.cpu():
        w = mxt.nd.array([1.0, 2.0, 3.0])
        w.attach_grad()
        leaf = w.astorch()
        w[1] = 5.0
        assert w.astorch() is leaf and w.asnumpy().tolist() == [1, 5, 3]
        with mxt.autograd.record():
            with pytest.raises(mxt.MXNetError):
                w[0] = 0.0
            y = (w * w).sum()
        y.backward()
        assert w.grad.asnumpy().tolist() == [2.0, 10.0, 6.0]


def test_out_receives_the_result_and_rebinds():
    j, p = _pair(_x())
    jo, po = _pair(onp.zeros((2, 3, 4, 5), "float32"))
    keep = po[0]
    assert mxt.nd.exp(p, out=po) is po
    mx.nd.exp(j, out=jo)
    _same(jo, po, rtol=RTOL)
    assert (keep.asnumpy() == 0).all()
    jf, pf = _pair(onp.zeros((2, 2), "float32"))
    mx.nd.full((2, 2), 3.5, out=jf)
    assert mxt.nd.full((2, 2), 3.5, out=pf, ctx=mxt.cpu()) is pf
    _same(jf, pf)
    jq, jl = mx.nd.linalg_slogdet(mx.nd.array(_x((3, 3))))
    pq, pl = mxt.nd.zeros((), ctx=mxt.cpu()), mxt.nd.zeros((), ctx=mxt.cpu())
    mxt.nd.linalg_slogdet(mxt.nd.array(_x((3, 3)), ctx=mxt.cpu()),
                          out=[pq, pl])
    _same(jq, pq)
    _same(jl, pl, rtol=1e-5)


# --- module functions ----------------------------------------------------------
CONSTRUCTORS = [
    ("empty", lambda pkg, c: pkg.nd.empty((2, 3), **c)),
    ("full", lambda pkg, c: pkg.nd.full((2, 3), 7, **c)),
    ("full_int", lambda pkg, c: pkg.nd.full(4, 2, dtype="int32", **c)),
    ("linspace", lambda pkg, c: pkg.nd.linspace(-1, 2, 7, **c)),
    ("linspace_open", lambda pkg, c: pkg.nd.linspace(0, 1, 4, endpoint=False,
                                                     **c)),
    ("linspace_int", lambda pkg, c: pkg.nd.linspace(0, 10, 4, dtype="int32",
                                                    **c)),
    ("eye", lambda pkg, c: pkg.nd.eye(3, **c)),
    ("eye_mk", lambda pkg, c: pkg.nd.eye(3, 5, 2, **c)),
    ("eye_neg", lambda pkg, c: pkg.nd.eye(4, 3, -1, dtype="int32", **c)),
    ("from_numpy", lambda pkg, c: pkg.nd.from_numpy(_x((2, 2)), **c)),
    ("add_n", lambda pkg, c: pkg.nd.add_n(*[pkg.nd.array(_x((3,), s), **c)
                                            for s in range(4)])),
    ("add_n_list", lambda pkg, c: pkg.nd.add_n([pkg.nd.array(_x((3,), s), **c)
                                               for s in range(3)])),
]


@pytest.mark.parametrize("name, make", CONSTRUCTORS,
                         ids=[c[0] for c in CONSTRUCTORS])
def test_constructor_matches_jax(name, make):
    _same(make(mx, {}), make(mxt, {"ctx": mxt.cpu()}),
          rtol=RTOL if name.startswith("linspace") else 0.0)


def test_waitall_and_namespace():
    mxt.nd.waitall()
    for name in ("empty", "full", "eye", "linspace", "add_n", "waitall",
                 "from_numpy", "random", "linalg", "save_dict", "load_dict"):
        assert hasattr(mxt.nd, name), name
    for name in ("gemm", "gemm2", "potrf", "potri", "trmm", "trsm", "syrk",
                 "sumlogdiag", "extractdiag", "makediag", "inverse", "det",
                 "slogdet"):
        assert getattr(mxt.nd.linalg, name) is getattr(
            mxt.nd, "linalg_" + name)


def test_nd_linalg_matches_jax():
    a = _x((3, 3), seed=2)
    spd = (a @ a.T + 3 * onp.eye(3)).astype("float32")
    j, p = _pair(spd)
    _same(mx.nd.linalg.potrf(j), mxt.nd.linalg.potrf(p), rtol=1e-5)
    _same(mx.nd.linalg.gemm2(j, j, alpha=2.0),
          mxt.nd.linalg.gemm2(p, p, alpha=2.0), rtol=1e-6)


# --- save / load ---------------------------------------------------------------
def _arrays(pkg):
    c = {} if pkg is mx else {"ctx": mxt.cpu()}
    bf = jnp.bfloat16 if pkg is mx else "bfloat16"
    return {"w": pkg.nd.array(_x((3, 4)), dtype=bf, **c),
            "b": pkg.nd.array(_x((4,), seed=1), **c),
            "i": pkg.nd.array(onp.arange(6).reshape(2, 3), dtype="int32", **c)}


def _bits(v):
    if _dt(v) == "bfloat16":
        if isinstance(v, mxt.nd.NDArray):
            return v.astorch().view(torch.int16).numpy()
        return onp.asarray(v.asnumpy()).view(onp.int16)
    return v.asnumpy()


def test_bfloat16_dict_from_the_jax_package_loads_bit_for_bit(tmp_path):
    f = str(tmp_path / "jax.npz")
    src = _arrays(mx)
    mx.nd.save(f, src)
    got = mxt.nd.load(f, ctx=mxt.cpu())
    assert sorted(got) == sorted(src)
    for k in src:
        assert _dt(got[k]) == _dt(src[k])
        onp.testing.assert_array_equal(_bits(got[k]), _bits(src[k]))
    assert mxt.nd.load_dict(f, ctx=mxt.cpu()).keys() == got.keys()


def test_bfloat16_save_writes_the_jax_package_file(tmp_path):
    """The port stores bfloat16 as the JAX package does (the raw 2-byte
    values as numpy ``|V2``): the two files hold the same arrays, and the
    port reads its own back.  (The JAX package's ``load`` refuses ``|V2``
    from either package: a fault of the reference the port does not
    follow.)"""
    fj, fp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    mx.nd.save(fj, _arrays(mx))
    mxt.nd.save_dict(fp, _arrays(mxt))
    with onp.load(fj) as zj, onp.load(fp) as zp:
        assert sorted(zj.keys()) == sorted(zp.keys())
        for k in zj.keys():
            assert zj[k].dtype == zp[k].dtype
            assert zj[k].tobytes() == zp[k].tobytes()
    back = mxt.nd.load(fp, ctx=mxt.cpu())
    assert _dt(back["w"]) == "bfloat16"
    with pytest.raises(TypeError):
        mx.nd.load(fp)


def test_lists_and_float_dicts_cross_both_ways(tmp_path):
    f1, f2 = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    arrs = [mxt.nd.array(_x((2, 3), seed=s), ctx=mxt.cpu()) for s in range(3)]
    mxt.nd.save(f1, arrs)
    back = mx.nd.load(f1)
    assert isinstance(back, list) and len(back) == 3
    for a, b in zip(arrs, back):
        _same(b, a)
    mx.nd.save(f2, {"x": mx.nd.array(_x((5,)))})
    got = mxt.nd.load_dict(f2, ctx=mxt.cpu())
    _same(mx.nd.array(_x((5,))), got["x"])
    assert sorted(mxt.nd.load_dict(f1, ctx=mxt.cpu())) == ["0", "1", "2"]


def _v2_entry(a, type_flag):
    return (struct.pack("<I", 0xF993FAC9) + struct.pack("<i", 0)
            + struct.pack("<i", a.ndim) + struct.pack("<%dq" % a.ndim, *a.shape)
            + struct.pack("<ii", 1, 0) + struct.pack("<i", type_flag)
            + a.tobytes())


def _write_legacy(path, entries, names):
    chunks = [struct.pack("<QQ", 0x112, 0), struct.pack("<Q", len(entries))]
    chunks += entries
    chunks.append(struct.pack("<Q", len(names)))
    for n in names:
        chunks += [struct.pack("<Q", len(n)), n.encode()]
    with open(path, "wb") as f:
        f.write(b"".join(chunks))


def test_legacy_params_reader(tmp_path):
    """A file in upstream MXNet's binary format, written here byte by
    byte: V2 float32 and int64 entries (int64 narrows to int32), a V1
    entry and a pre-V1 one (its magic the number of dimensions)."""
    w = _x((2, 3))
    ids = onp.array([1, 2, 3], "int64")
    v1 = _x((4,), seed=2)
    old = onp.array([[1.5, 2.5]], "float32")
    entries = [_v2_entry(w, 0), _v2_entry(ids, 6),
               struct.pack("<I", 0xF993FAC8) + struct.pack("<i", 1)
               + struct.pack("<q", 4) + struct.pack("<iii", 1, 0, 0)
               + v1.tobytes(),
               struct.pack("<I", 2) + struct.pack("<II", 1, 2)
               + struct.pack("<iii", 1, 0, 0) + old.tobytes()]
    f = str(tmp_path / "model.params")
    _write_legacy(f, entries, ["arg:w", "aux:ids", "arg:v1", "arg:old"])
    got = mxt.nd.load(f, ctx=mxt.cpu())
    want = mx.nd.load(f)
    assert sorted(got) == sorted(want) == ["arg:old", "arg:v1", "arg:w",
                                           "aux:ids"]
    for k in want:
        _same(want[k], got[k])
    assert _dt(got["aux:ids"]) == "int32"
    f2 = str(tmp_path / "list.params")
    _write_legacy(f2, [_v2_entry(w, 0)], [])
    lst = mxt.nd.load(f2, ctx=mxt.cpu())
    assert isinstance(lst, list) and onp.array_equal(lst[0].asnumpy(), w)


def test_legacy_writer_round_trips_through_both_packages(tmp_path):
    f = str(tmp_path / "out.params")
    src = {"a": mxt.nd.array(_x((2, 2)), ctx=mxt.cpu()),
           "b": mxt.nd.array(onp.arange(3), ctx=mxt.cpu(), dtype="int32")}
    tlegacy.save_legacy(f, src)
    assert jlegacy.is_legacy_file(f) and tlegacy.is_legacy_file(f)
    want = mx.nd.load(f)
    for k, v in mxt.nd.load(f, ctx=mxt.cpu()).items():
        _same(want[k], v)
        _same(want[k], src[k])
    fj = str(tmp_path / "jax.params")
    jlegacy.save_legacy(fj, {k: mx.nd.array(v.asnumpy())
                             for k, v in src.items()})
    with open(f, "rb") as a, open(fj, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(mxt.MXNetError):
        tlegacy.save_legacy(str(tmp_path / "bf.params"),
                            [mxt.nd.ones((2,), ctx=mxt.cpu(),
                                         dtype="bfloat16")])


# --- SequenceLast, base and context ---------------------------------------------
@pytest.mark.parametrize("axis, lengths, dtype", [
    (0, [0, 2], "float32"), (0, [0, 5], "float32"), (0, [3, 1], "int32"),
    (1, [0, 3], "float32"), (1, [0, 5], "int32"), (1, [-1, 2], "float32")])
def test_sequence_last_with_lengths_out_of_range(axis, lengths, dtype):
    """A length of 0 gives the last step, as the JAX package's
    ``take_along_axis`` takes index -1; a length past the end gives its
    fill value (NaN, or the least int32)."""
    data = onp.arange(24, dtype="float32").reshape((3, 2, 4) if axis == 0
                                                   else (2, 3, 4))
    jd, pd = _pair(data, dtype)
    jl, pl = _pair(onp.array(lengths, "float32"))
    _same(mx.nd.SequenceLast(jd, jl, use_sequence_length=True, axis=axis),
          mxt.nd.SequenceLast(pd, pl, use_sequence_length=True, axis=axis))


def test_base_and_context_names(monkeypatch):
    from mxnet_tpu_torch import base, context
    assert base.string_types == (str,) and base.mx_real_t is onp.float32
    assert isinstance(onp.int64(3), base.integer_types)
    monkeypatch.setenv("MXNET_SURFACE_TEST", "yes")
    assert base.get_env("MXNET_SURFACE_TEST", typ=bool) is True
    monkeypatch.setenv("MXNET_SURFACE_TEST", "12")
    assert base.get_env("MXNET_SURFACE_TEST", typ=int) == 12
    assert base.get_env("MXNET_SURFACE_UNSET", 3) == 3
    assert context.cpu_pinned().torch_device == torch.device("cpu")
    assert context.num_gpus() == torch.cuda.device_count()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert context.num_gpus() == 0
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        context.gpu_memory_info(0)
    for name in ("cpu_pinned", "num_gpus", "gpu_memory_info"):
        assert hasattr(mx.context, name)
    assert os.environ.get("MXNET_SURFACE_UNSET") is None
