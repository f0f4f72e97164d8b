"""Contrib layers (counterpart of
``mxnet_tpu/gluon/contrib/nn/basic_layers.py``): ``Concurrent`` and
``HybridConcurrent`` (children on one input, outputs concatenated),
``Identity``, ``SyncBatchNorm`` (the ``_contrib_SyncBatchNorm`` op: batch
statistics all-reduced over the bound ``torch.distributed`` group) and
``PixelShuffle1D/2D/3D``.  ``SparseEmbedding`` raises: sparse storage is
not ported.
"""
from __future__ import annotations

import numpy as onp

from ....base import MXNetError
from ...block import HybridBlock
from ...nn import Sequential, HybridSequential, BatchNorm, Embedding

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]


class Concurrent(Sequential):
    """Each child on the same input, the outputs concatenated along
    ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x, *args):
        from .... import ndarray as nd
        out = [block(x) for block in self._children.values()]
        return nd.concat(*out, dim=self.axis)


class HybridConcurrent(HybridSequential):
    """The hybridizable :class:`Concurrent`."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x, *args):
        from .... import ndarray as nd
        out = [block(x) for block in self._children.values()]
        return nd.concat(*out, dim=self.axis)


class Identity(HybridBlock):
    """Its input, unchanged (a branch of a Concurrent)."""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Embedding):
    """An Embedding with a row-sparse gradient: it raises, since sparse
    storage is not ported (``ROADMAP.md``, queue 1, item 9)."""

    def __init__(self, input_dim, output_dim, dtype="float32", **kwargs):
        raise MXNetError("SparseEmbedding needs sparse storage, which is "
                         "not ported (ROADMAP.md, queue 1, item 9)")


class SyncBatchNorm(BatchNorm):
    """BatchNorm over axis 1 whose batch statistics are averaged over the
    ranks of the group bound by ``ops.nn.cross_rank_batch_stats``, and
    plain BatchNorm when none is bound (``num_devices`` is accepted).  The
    moving averages update as :class:`BatchNorm`'s."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", key="dp", **kwargs):
        super().__init__(
            axis=1, momentum=momentum, epsilon=epsilon, center=center,
            scale=scale, use_global_stats=use_global_stats,
            beta_initializer=beta_initializer,
            gamma_initializer=gamma_initializer,
            running_mean_initializer=running_mean_initializer,
            running_variance_initializer=running_variance_initializer,
            in_channels=in_channels, **kwargs)
        self._kwargs = {"eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats,
                        "ndev": num_devices if num_devices else 1,
                        "key": key}

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        out, mean, var = F._contrib_SyncBatchNorm(
            x, gamma, beta, running_mean, running_var, **self._kwargs)
        self._update_moving(running_mean, running_var, mean, var)
        return out


class _PixelShuffle(HybridBlock):
    """Depth to space: (N, C * f1 * ... * fk, d1, ..., dk) to (N, C,
    d1 * f1, ..., dk * fk), one reshape, transpose and reshape."""

    def __init__(self, factor, ndim, **kwargs):
        super().__init__(**kwargs)
        try:
            self._factors = (int(factor),) * ndim
        except TypeError:
            self._factors = tuple(int(f) for f in factor)
            if len(self._factors) != ndim:
                raise ValueError("factor must be a scalar or one value per "
                                 "spatial dim")
        self._ndim = ndim

    def hybrid_forward(self, F, x):
        f, k = self._factors, self._ndim
        n, c, spatial = x.shape[0], x.shape[1], tuple(x.shape[2:])
        c_out = c // int(onp.prod(f))
        x = F.reshape(x, (n, c_out) + f + spatial)
        perm = [0, 1]
        for i in range(k):
            perm += [2 + k + i, 2 + i]
        x = F.transpose(x, axes=tuple(perm))
        return F.reshape(x, (n, c_out) + tuple(d * fi for d, fi
                                               in zip(spatial, f)))

    def __repr__(self):
        return "%s(factors=%s)" % (type(self).__name__, (self._factors,))


class PixelShuffle1D(_PixelShuffle):
    """(N, C * f, W) to (N, C, W * f)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 1, **kwargs)


class PixelShuffle2D(_PixelShuffle):
    """(N, C * f1 * f2, H, W) to (N, C, H * f1, W * f2)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 2, **kwargs)


class PixelShuffle3D(_PixelShuffle):
    """(N, C * f1 * f2 * f3, D, H, W) to (N, C, D * f1, H * f2, W * f3)."""

    def __init__(self, factor, **kwargs):
        super().__init__(factor, 3, **kwargs)
