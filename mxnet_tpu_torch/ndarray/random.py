"""``mx.nd.random`` (counterpart of ``mxnet_tpu/ndarray/random.py``): the
distribution draws, forwarded to the sampling ops of
``ops/random_ops.py`` through the ``mx.nd`` dispatch, which hands each the
generator of the device it draws on (``ctx=``, else the current
context)."""
from __future__ import annotations

__all__ = ["uniform", "normal", "randn", "randint", "gamma", "exponential",
           "poisson", "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle"]

# public name -> registered op name
_FORWARD = {
    "uniform": "random_uniform",
    "normal": "random_normal",
    "randint": "random_randint",
    "gamma": "random_gamma",
    "exponential": "random_exponential",
    "poisson": "random_poisson",
    "negative_binomial": "random_negative_binomial",
    "generalized_negative_binomial": "random_generalized_negative_binomial",
    "multinomial": "sample_multinomial",
    "shuffle": "shuffle",
}


def _op(name):
    from .. import ndarray as _nd
    return getattr(_nd, _FORWARD[name])


def __getattr__(name):
    if name in _FORWARD:
        return _op(name)
    raise AttributeError("module 'ndarray.random' has no attribute %r"
                         % name)


def randn(*shape, **kwargs):
    """Standard-normal draws of ``shape``: ``randn(2, 3)`` is
    ``normal(0, 1, shape=(2, 3))``."""
    loc = kwargs.pop("loc", 0.0)
    scale = kwargs.pop("scale", 1.0)
    return _op("normal")(loc, scale, shape=shape, **kwargs)
