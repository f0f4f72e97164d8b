"""Advanced activation layers.

Counterpart of ``mxnet_tpu/gluon/nn/activations.py``: ``LeakyReLU``,
``PReLU`` (a learned slope, one ``alpha`` parameter), ``ELU``, ``SELU``
and ``GELU`` through the ``LeakyReLU`` op, and ``Swish``.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU"]


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        if alpha < 0:
            raise ValueError("Slope coefficient for LeakyReLU must be no "
                             "less than 0.")
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return "LeakyReLU(%s)" % self._alpha


class PReLU(HybridBlock):
    """``x`` where positive, ``alpha * x`` elsewhere, ``alpha`` learned
    (shape (1,), ``alpha_initializer`` zeros by default)."""

    def __init__(self, alpha_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(1,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
