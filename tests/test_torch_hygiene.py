"""Hygiene of the port: ``mxnet_tpu_torch/`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, the kernel wrappers have no ``try`` that
could fall back from a kernel to something else, and the port's default
(GPU) entry points raise without CUDA instead of running on the CPU."""
import ast
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.serve import AotModel, InferenceServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mxnet_tpu_torch")


def _port_files():
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py", "chip_diag.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "mxnet_tpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 20 and os.path.exists(files[0])
    bad = [(os.path.relpath(p, REPO), m) for p in files
           for m in _imported_modules(p) if _forbidden(m)]
    assert bad == []


def test_every_module_of_the_training_slice_is_checked():
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("autograd.py", "lr_scheduler.py", "metric.py",
                 "callback.py", "optimizer/optimizer.py", "io/io.py",
                 "gluon/loss.py", "gluon/trainer.py", "gluon/utils.py",
                 "gluon/data/dataset.py", "gluon/data/sampler.py",
                 "gluon/data/dataloader.py", "ops/rnn.py",
                 "ops/control_flow.py", "ndarray/contrib.py",
                 "gluon/rnn/__init__.py", "gluon/rnn/rnn_layer.py",
                 "gluon/rnn/rnn_cell.py", "gluon/contrib/rnn/__init__.py",
                 "gluon/contrib/rnn/rnn_cell.py",
                 "gluon/contrib/data/__init__.py",
                 "gluon/contrib/data/text.py",
                 "gluon/contrib/data/sampler.py", "contrib/__init__.py",
                 "contrib/text/__init__.py", "contrib/text/vocab.py",
                 "contrib/text/utils.py", "gluon/model_zoo/lm.py"):
        assert name in rel, name


def test_every_module_of_the_bert_slice_is_checked():
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("ops/attention.py", "ops/layernorm.py", "ops/matrix.py",
                 "ops/elemwise.py", "gluon/contrib/nn/transformer.py",
                 "gluon/model_zoo/bert.py"):
        assert name in rel, name


def test_every_module_of_the_bshd_slice_is_checked():
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("ops/attention.py", "ops/reduce.py",
                 "gluon/contrib/nn/transformer.py",
                 "optimizer/optimizer.py", "ndarray/ndarray.py"):
        assert name in rel, name


def test_every_module_of_the_data_parallel_slice_is_checked():
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("kvstore.py", "parallel/__init__.py", "parallel/mesh.py",
                 "parallel/collectives.py", "parallel/data_parallel.py",
                 "gluon/trainer.py", "gluon/parameter.py",
                 "optimizer/optimizer.py", "ops/nn.py"):
        assert name in rel, name


def test_every_module_of_the_amp_slice_is_checked():
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("contrib/__init__.py", "contrib/amp/__init__.py",
                 "contrib/amp/amp.py", "contrib/amp/lists.py",
                 "contrib/amp/loss_scaler.py", "ops/contrib_ops.py",
                 "ops/registry.py", "ops/matrix.py", "ndarray/__init__.py",
                 "ops/attention.py"):
        assert name in rel, name


def test_every_module_of_the_array_surface_slice_is_checked():
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("ops/elemwise.py", "ops/matrix.py", "ops/random_ops.py",
                 "ndarray/__init__.py", "ndarray/ndarray.py",
                 "ndarray/random.py", "ndarray/linalg.py",
                 "ndarray/utils.py", "ndarray/legacy_io.py", "base.py",
                 "context.py", "random.py", "ops/nn.py", "telemetry.py"):
        assert name in rel, name


def test_every_module_of_the_rest_of_training_slice_is_checked():
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("optimizer/optimizer.py", "gluon/loss.py", "metric.py",
                 "callback.py", "io/io.py", "gluon/data/dataloader.py",
                 "gluon/data/dataset.py", "gluon/data/vision/__init__.py",
                 "gluon/data/vision/datasets.py",
                 "gluon/data/vision/transforms.py",
                 "gluon/contrib/estimator/__init__.py",
                 "gluon/contrib/estimator/estimator.py",
                 "gluon/contrib/estimator/event_handler.py",
                 "gluon/utils.py", "ndarray/contrib.py", "__init__.py"):
        assert name in rel, name


def test_every_module_of_the_symbol_slice_is_checked():
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("name.py", "attribute.py", "symbol/__init__.py",
                 "symbol/symbol.py", "symbol/_eval.py", "symbol/_infer.py",
                 "symbol/contrib.py", "symbol/linalg.py", "symbol/random.py",
                 "executor.py", "subgraph.py", "model.py",
                 "module/__init__.py", "module/base_module.py",
                 "module/module.py", "module/bucketing_module.py",
                 "module/sequential_module.py", "gluon/block.py",
                 "gluon/parameter.py", "contrib/amp/amp.py", "callback.py",
                 "autograd.py", "initializer.py", "ops/elemwise.py",
                 "ops/random_ops.py", "ops/fused_norm.py", "ops/layernorm.py",
                 "ops/attention.py", "__init__.py"):
        assert name in rel, name


def test_symbol_slice_entry_points_raise_without_cuda():
    """A Module and a bound Executor default to the card: without one
    they raise, and never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    s = mxt.sym.FullyConnected(mxt.sym.var("data"), num_hidden=2, name="fc")
    mod = mxt.mod.Module(s, label_names=None)
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        mod.bind(data_shapes=[("data", (1, 3))])
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        s.simple_bind(data=(1, 3))


def test_meta_shape_rules_are_reached_by_meta_tensors_only():
    """Each kernel wrapper tests for the meta device itself before its
    shape rule: a CUDA tensor cannot take it."""
    for rel in ("ops/fused_norm.py", "ops/layernorm.py", "ops/attention.py"):
        with open(os.path.join(PKG, rel)) as f:
            src = f.read()
        assert 'type == "meta"' in src, rel


def test_optimizer_noise_draws_from_an_explicit_generator():
    """SGLD's noise is drawn with the port's generator of the weight's
    device, never torch's global one."""
    path = os.path.join(PKG, "optimizer", "optimizer.py")
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute)
             and n.func.attr in ("randn", "rand", "normal", "normal_")]
    assert len(calls) == 1
    assert any(k.arg == "generator" for k in calls[0].keywords)


def test_samplers_draw_only_from_an_explicit_generator():
    """Every torch sampler call in the sampling ops passes the generator
    the dispatch hands them, and nothing there uses torch.distributions
    (which draws from the global generator)."""
    path = os.path.join(PKG, "ops", "random_ops.py")
    with open(path) as f:
        src = f.read()
    tree = ast.parse(src, filename=path)
    draws = ("rand", "randn", "randint", "randperm", "multinomial",
             "poisson", "_standard_gamma", "exponential_")
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute) and n.func.attr in draws]
    assert len(calls) >= 8
    for c in calls:
        assert any(k.arg == "generator" for k in c.keywords), \
            ast.unparse(c)
    assert not any(isinstance(n, ast.Attribute) and n.attr == "distributions"
                   for n in ast.walk(tree))
    assert not any(m.startswith("torch.distributions")
                   for m in _imported_modules(path))


def test_kernel_wrappers_have_no_fallback_try():
    """A module that loads a kernel library launches its kernel or raises:
    no ``try`` around a launch that could run something else."""
    wrappers = []
    for path in _port_files():
        if not path.startswith(PKG):
            continue
        with open(path) as f:
            src = f.read()
        if "kernels.load(" not in src:
            continue
        wrappers.append(os.path.relpath(path, REPO))
        tree = ast.parse(src, filename=path)
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path
    for name in ("fused_norm", "attention", "layernorm"):
        assert "mxnet_tpu_torch/ops/%s.py" % name in wrappers


def test_rnn_path_has_no_try():
    """The RNN op and the recurrent layers run torch's RNN on the tensor's
    device or raise: no ``try`` that could run something else."""
    for name in ("ops/rnn.py", "gluon/rnn/rnn_layer.py",
                 "gluon/rnn/rnn_cell.py", "gluon/model_zoo/lm.py"):
        with open(os.path.join(PKG, name)) as f:
            tree = ast.parse(f.read())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), name


def test_every_module_of_the_compiled_execution_slice_is_checked():
    rel = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("cuda_graph.py", "gluon/block.py", "serve/buckets.py",
                 "serve/server.py", "parallel/data_parallel.py",
                 "random.py"):
        assert name in rel, name


def test_captured_paths_catch_no_failure():
    """A failed capture, build or launch raises: the capture helper and
    its owners catch nothing (the block's one handler completes deferred
    parameter shapes)."""
    for name in ("cuda_graph.py", "serve/buckets.py",
                 "parallel/data_parallel.py", "gluon/block.py"):
        with open(os.path.join(PKG, name)) as f:
            tree = ast.parse(f.read())
        caught = [ast.unparse(n.type) for n in ast.walk(tree)
                  if isinstance(n, ast.ExceptHandler)]
        want = ["DeferredInitializationError"] if name == "gluon/block.py" \
            else []
        assert caught == want, name


def test_forbidden_import_check_sees_the_spellings():
    for m in ("jax", "jax.numpy", "jaxlib.xla_client", "mxnet_tpu",
              "mxnet_tpu.ops.nn"):
        assert _forbidden(m)
    assert not _forbidden("mxnet_tpu_torch.ops.nn")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_context_is_the_gpu():
    assert mxt.current_context() == mxt.gpu(0)
    with mxt.cpu():
        assert mxt.current_context() == mxt.cpu()


def test_gpu_entry_points_raise_without_cuda(no_cuda):
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        mxt.gpu(0).torch_device
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        mxt.nd.zeros((2, 2))
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        mxt.nd.array(onp.zeros(3, "float32"))
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        tresnet.resnet18_v1().initialize()
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        AotModel(lambda x: x, feature_shape=(3,))
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        InferenceServer(lambda x: x, feature_shape=(3,))
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        mxt.nd.arange(0, 4)
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        mxt.gluon.rnn.LSTM(4).initialize()
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        mxt.io.NDArrayIter(onp.zeros((4, 2), "float32"), batch_size=2).next()
    # the CPU only when asked for
    assert mxt.nd.zeros((2,), ctx=mxt.cpu()).context == mxt.cpu()


def test_data_parallel_entry_points_raise_without_cuda(no_cuda):
    """The process group joins over NCCL, the card's, unless the caller
    asks for the CPU; without CUDA it raises, and nothing falls back to
    gloo or to one process."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        mxt.parallel.initialize()
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        mxt.kv.create("nccl")
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        mxt.parallel.initialize(num_processes=2, process_id=0,
                                coordinator_address="localhost:1")
    assert not dist.is_initialized()
    net = mxt.gluon.nn.Dense(3, in_units=4)
    with pytest.raises(mxt.MXNetError, match="CUDA"):
        net.initialize()                  # card parameters
        mxt.parallel.DataParallelStep(net, mxt.gluon.loss.L2Loss(),
                                      mxt.optimizer.SGD())
    # the CPU only when asked for: a step on CPU parameters runs
    with mxt.cpu():
        net.initialize(force_reinit=True)
        L = mxt.gluon.loss.L2Loss()
        step = mxt.parallel.DataParallelStep(
            net, lambda o, l: L(o, l), mxt.optimizer.SGD())
        loss = step(onp.ones((2, 4), "float32"), onp.zeros((2, 3), "float32"))
    assert loss.context == mxt.cpu() and loss.shape == ()
