"""mxnet_tpu_torch: the MXNet-style framework on PyTorch and CUDA.

The port of ``mxnet_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100,
kept in the same module layout and public names: ``mx.nd``,
``mx.autograd``, ``mx.gluon``, ``mx.init``, ``mx.random``,
``mx.optimizer`` (``mx.opt``), ``mx.lr_scheduler``, ``mx.metric``,
``mx.io``, ``mx.callback``, ``mx.kv``, ``mx.parallel``, ``mx.serve``,
``mx.contrib``, the Symbol API and ``Module`` (``mx.sym``,
``mx.executor``, ``mx.mod``, ``mx.model``, ``mx.subgraph``,
``mx.AttrScope``, ``mx.name``), ``mx.NDArray``, ``mx.num_gpus`` and
``mx.cpu_pinned``.
Its default context is the card (``mx.gpu(0)``); the CPU runs only when
the caller asks for ``mx.cpu()``.  When ``MXNET_TPU_COORDINATOR_ADDRESS``
is set, importing the package joins the process group
(``parallel.initialize``), as the JAX package joins its coordinator.  Hand-written CUDA kernels live in
``csrc/`` and are built at first use (``kernels.py``).  This package
imports neither JAX nor ``mxnet_tpu``.
"""
import os as _os

from . import base  # noqa: F401
from .base import MXNetError  # noqa: F401
from .context import (Context, cpu, cpu_pinned, current_context,  # noqa: F401
                      gpu, num_gpus)
from . import autograd  # noqa: F401
from . import random  # noqa: F401
from . import ops  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from . import initializer  # noqa: F401
from . import initializer as init  # noqa: F401
from . import telemetry  # noqa: F401
from . import lr_scheduler  # noqa: F401
from . import optimizer  # noqa: F401
from . import optimizer as opt  # noqa: F401
from . import metric  # noqa: F401
from . import io  # noqa: F401
from . import callback  # noqa: F401
from . import gluon  # noqa: F401
from . import kvstore  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import parallel  # noqa: F401
from . import serve  # noqa: F401
from . import contrib  # noqa: F401
from . import attribute  # noqa: F401
from . import name  # noqa: F401
from .attribute import AttrScope  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from . import executor  # noqa: F401
from . import subgraph  # noqa: F401
from . import model  # noqa: F401
from . import module  # noqa: F401
from . import module as mod  # noqa: F401
from .base import __version__  # noqa: F401
from .ndarray import NDArray  # noqa: F401

if _os.environ.get("MXNET_TPU_COORDINATOR_ADDRESS"):
    # launched as one rank of several: join before anything runs, and let a
    # failure raise (one process alone would train on 1/N of the data)
    parallel.initialize()
