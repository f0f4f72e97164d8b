"""Port parity, in one process: the ZeRO flat layout and the optimizers'
pure steps of ``mxnet_tpu_torch`` against the JAX package's.

* ``padded_size``, ``flatten_pad`` and ``unflatten``: the same numbers,
  the same values and the same order, exactly;
* ``make_step`` followed by ``pin_update_dtypes``, as the JAX package's
  ``DataParallelStep`` runs them for one slot (the rate in the weight's
  dtype, or the fp32 master under ``multi_precision``), against the same
  JAX functions under ``jax.jit``: SGD with and without momentum and Adam,
  float32, bfloat16 and bfloat16 with fp32 masters, 4 steps from non-zero
  states, the same bits for the weight and every state;
* ``zero_sharded_update`` on a one-rank gloo group: the degenerate layout
  gives the bits of the replicated step (under ``multi_precision`` of the
  step given the fp32 gradient its fp32 reduce-scatter carries).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.optimizer.optimizer import pin_update_dtypes

STEPS = (1, 2, 3, 7)
N = 4099    # elements: enough for a rare rounding difference to show

OPTIMIZERS = [
    ("sgd", dict(learning_rate=0.1, wd=1e-4, rescale_grad=1 / 24)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
                 rescale_grad=1 / 24)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
                 clip_gradient=0.02, rescale_grad=1 / 24)),
    ("adam", dict(learning_rate=1e-3, wd=1e-4, rescale_grad=1 / 24)),
    ("adam", dict(learning_rate=1e-3, rescale_grad=0.5)),
]
OPT_IDS = ["sgd", "sgd_momentum", "sgd_momentum_clip", "adam_wd", "adam"]
MODES = [("float32", False), ("bfloat16", False), ("bfloat16", True)]
MODE_IDS = ["f32", "bf16", "bf16_mp"]


@pytest.mark.parametrize("size", [1, 5, 7, 64, 1000])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_flat_layout_matches_jax(size, n):
    import jax.numpy as jnp
    from mxnet_tpu.parallel import collectives as jc
    from mxnet_tpu_torch.parallel import collectives as tc
    assert tc.padded_size(size, n) == jc.padded_size(size, n)
    x = onp.random.RandomState(size + n).randn(size).astype("float32")
    shape = (size,) if size % 5 else (size // 5, 5)
    x = x.reshape(shape)
    got = tc.flatten_pad(torch.from_numpy(x), n)
    want = onp.asarray(jc.flatten_pad(jnp.asarray(x), n))
    onp.testing.assert_array_equal(got.numpy(), want)
    onp.testing.assert_array_equal(tc.unflatten(got, shape).numpy(), x)
    nd = tc.flatten_pad(mxt.nd.array(x, ctx=mxt.cpu()), n)
    assert isinstance(nd, mxt.nd.NDArray)
    onp.testing.assert_array_equal(nd.asnumpy(), want)


def _inputs(dtype):
    rs = onp.random.RandomState(0)
    w = (rs.randn(N) * 0.5).astype("float32")
    g = (rs.randn(N) * 0.3).astype("float32")
    m = (rs.randn(N) * 0.01).astype("float32")
    v = (rs.rand(N) * 0.01).astype("float32")
    return w, g, m, v


def _jax_steps(name, kw, dtype, mp):
    """The weight and states after each of STEPS, as the JAX step's slot
    update computes them."""
    import jax
    import jax.numpy as jnp
    import mxnet_tpu as mx
    from mxnet_tpu.optimizer.optimizer import pin_update_dtypes as pin
    opt = mx.optimizer.create(name, **kw)
    step = opt.make_step(0)

    def slot(w, g, t, lr, *st):
        if mp:
            master, rest = st[0], st[1:]
            res = step(master, g.astype(jnp.float32), t, lr, *rest)
            nm, ns = pin(res, master, rest)
            return nm.astype(w.dtype), [nm] + ns
        res = step(w, g, t, lr.astype(w.dtype), *st)
        return pin(res, w, st)
    fn = jax.jit(slot)
    w, g, m, v = _inputs(dtype)
    nstate = {"sgd": int(kw.get("momentum", 0) > 0), "adam": 2}[name]
    dt = jnp.dtype(dtype)
    W = jnp.asarray(w).astype(dt)
    st = [jnp.asarray(s).astype(jnp.float32 if mp else dt)
          for s in (m, v)[:nstate]]
    if mp:
        st = [W.astype(jnp.float32)] + st
    out = []
    for t in STEPS:
        W, st = fn(W, jnp.asarray(g).astype(dt), jnp.asarray(t, jnp.int32),
                   jnp.asarray(kw["learning_rate"], jnp.float32), *st)
        out.append([onp.asarray(W.astype(jnp.float32))]
                   + [onp.asarray(s.astype(jnp.float32)) for s in st])
    return out


def _port_steps(name, kw, dtype, mp, update=None, widen=False):
    """The same through the port's make_step (or ``update(step, w, g, t,
    lr, states)``, returning the new weight and states).  Under ``mp`` the
    step takes the half-width gradient and widens it, as the JAX step's
    does, or, with ``widen``, an fp32 one (the sum of the sharded
    update's fp32 reduce-scatter)."""
    opt = mxt.optimizer.create(name, **kw)
    step = opt.make_step(0)
    w, g, m, v = _inputs(dtype)
    dt = getattr(torch, dtype)
    nstate = {"sgd": int(kw.get("momentum", 0) > 0), "adam": 2}[name]
    W = torch.from_numpy(w).to(dt)
    G = torch.from_numpy(g).to(dt)
    st = [torch.from_numpy(s).to(torch.float32 if mp else dt)
          for s in (m, v)[:nstate]]
    if mp:
        st = [W.float()] + st
    out = []
    for t in STEPS:
        lr = kw["learning_rate"]
        if update is not None:
            W, st = update(step, W, G, t, lr, st)
        elif mp:
            res = step(st[0], G.float() if widen else G, t, lr, *st[1:])
            master, rest = pin_update_dtypes(res, st[0], st[1:])
            W, st = master.to(dt), [master] + rest
        else:
            W, st = pin_update_dtypes(step(W, G, t, lr, *st), W, st)
        out.append([W.float().numpy()] + [s.float().numpy() for s in st])
    return out


@pytest.mark.parametrize("dtype,mp", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=OPT_IDS)
def test_make_step_matches_jax_bits(name, kw, dtype, mp):
    want = _jax_steps(name, kw, dtype, mp)
    got = _port_steps(name, kw, dtype, mp)
    for t, (gs, ws) in zip(STEPS, zip(got, want)):
        assert len(gs) == len(ws)
        for k, (a, b) in enumerate(zip(gs, ws)):
            onp.testing.assert_array_equal(a, b, err_msg="t=%d leaf %d"
                                           % (t, k))


def test_make_step_leaves_its_inputs_and_nag_has_none():
    opt = mxt.optimizer.create("adam", learning_rate=0.1)
    w, g = torch.ones(4), torch.full((4,), 0.5)
    m, v = torch.zeros(4), torch.zeros(4)
    new = opt.make_step(0)(w, g, 1, 0.1, m, v)
    assert len(new) == 3 and not torch.equal(new[0], w)
    assert torch.equal(w, torch.ones(4)) and not m.any() and not v.any()
    import mxnet_tpu as mx
    for pkg in (mx, mxt):
        with pytest.raises(NotImplementedError):
            pkg.optimizer.create("nag", momentum=0.9).make_step(0)


@pytest.fixture
def one_rank_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    mxt.parallel.initialize(backend="gloo")
    yield mxt.parallel.device_mesh()
    dist.destroy_process_group()


@pytest.mark.parametrize("dtype,mp", MODES, ids=MODE_IDS)
def test_zero_update_on_one_rank_is_the_replicated_step(one_rank_group,
                                                        dtype, mp):
    mesh = one_rank_group
    assert mesh.size == 1 and mesh.rank == 0 and mesh.backend == "gloo"
    name, kw = OPTIMIZERS[3]

    def update(step, w, g, t, lr, st):
        return mxt.parallel.zero_sharded_update(
            step, w, g, st, t, lr, shape=tuple(w.shape), mp=mp,
            axis_size=1, mesh=mesh, average=True)
    want = _port_steps(name, kw, dtype, mp, widen=True)
    got = _port_steps(name, kw, dtype, mp, update=update)
    for gs, ws in zip(got, want):
        for a, b in zip(gs, ws):
            onp.testing.assert_array_equal(a, b)


def test_mesh_and_shard_batch_on_one_rank(one_rank_group):
    """The mesh is the process group's one ``dp`` axis: another size or
    another axis raises (the latter naming ROADMAP.md); ``shard_batch``
    keeps rank r's contiguous rows and refuses a batch the ranks do not
    divide; ``replicate`` and ``allreduce`` leave one rank's value."""
    par = mxt.parallel
    mesh = one_rank_group
    assert mesh.shape == {"dp": 1} and par.device_mesh((1,)).size == 1
    with pytest.raises(mxt.MXNetError, match="1 rank"):
        par.device_mesh((2,))
    with pytest.raises(mxt.MXNetError, match="ROADMAP"):
        par.device_mesh((1, 1), ("dp", "tp"))
    x = mxt.nd.array(onp.arange(12, dtype="float32").reshape(6, 2),
                     ctx=mxt.cpu())
    onp.testing.assert_array_equal(par.shard_batch(x, mesh).asnumpy(),
                                   x.asnumpy())
    assert par.shard_batch(x) is x          # no installed mesh
    mesh.size, mesh.rank = 4, 2             # rank 2 of 4, on paper
    try:
        onp.testing.assert_array_equal(par.shard_batch(x[:4], mesh)
                                       .asnumpy(), x.asnumpy()[2:3])
        with pytest.raises(mxt.MXNetError, match="evenly"):
            par.shard_batch(x, mesh)
    finally:
        mesh.size, mesh.rank = 1, 0
    assert par.replicate(x, mesh) is x and par.allreduce(x, mesh=mesh) is x
    onp.testing.assert_array_equal(par.psum(x, mesh=mesh).asnumpy(),
                                   x.asnumpy())
