"""Random sampling operators on torch tensors.

Counterpart of ``mxnet_tpu/ops/random_ops.py``, every name it registers.
Each op takes a ``torch.Generator`` as its first argument, where the JAX
package's takes a PRNG key: the ``mx.nd`` dispatch passes the generator
of the output's device (``random.generator``), so ``mx.random.seed``,
``generator_scope`` and the generators a CUDA graph registers govern every
draw, and the samples land on the generator's device.  Only torch's
samplers that take an explicit generator are used (``torch.distributions``
would draw from the global one).  The two packages draw different numbers
from the same seed; they agree in distribution, shape and dtype.  The
samplers without an array input take ``ctx=`` as the JAX package's do;
the dispatch places the draw (``ctx`` picks the generator), so the
argument itself goes unused here.
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from .registry import register

__all__ = ["random_uniform", "random_normal", "random_gamma",
           "random_exponential", "random_poisson", "random_randint",
           "sample_multinomial", "shuffle"]


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def _gamma(gen, alpha, shape, device):
    """Gamma(alpha, 1) draws in float32; ``alpha`` a number or a tensor
    broadcast to ``shape``."""
    if isinstance(alpha, torch.Tensor):
        a = alpha.to(torch.float32).expand(shape).contiguous()
    else:
        a = torch.full(shape, float(alpha), device=device)
    return torch._standard_gamma(a, generator=gen)


def _poisson(gen, rate):
    return torch.poisson(rate, generator=gen)


@register("_random_uniform", needs_rng=True, differentiable=False,
          aliases=("random_uniform", "uniform"))
def random_uniform(gen, low: float = 0.0, high: float = 1.0, shape=None,
                   dtype="float32", ctx=None):
    u = torch.rand(_shape(shape), generator=gen, device=gen.device,
                   dtype=torch_dtype(dtype))
    return low + u * (high - low)


@register("_random_normal", needs_rng=True, differentiable=False,
          aliases=("random_normal", "normal"))
def random_normal(gen, loc: float = 0.0, scale: float = 1.0, shape=None,
                  dtype="float32", ctx=None):
    z = torch.randn(_shape(shape), generator=gen, device=gen.device,
                    dtype=torch_dtype(dtype))
    return loc + scale * z


@register("_random_gamma", needs_rng=True, differentiable=False,
          aliases=("random_gamma",))
def random_gamma(gen, alpha: float = 1.0, beta: float = 1.0, shape=None,
                 dtype="float32", ctx=None):
    g = _gamma(gen, alpha, _shape(shape), gen.device) * beta
    return g.to(torch_dtype(dtype))


@register("_random_exponential", needs_rng=True, differentiable=False,
          aliases=("random_exponential",))
def random_exponential(gen, lam: float = 1.0, shape=None, dtype="float32",
                       ctx=None):
    e = torch.empty(_shape(shape), device=gen.device,
                    dtype=torch_dtype(dtype)).exponential_(1.0, generator=gen)
    return e / lam


@register("_random_poisson", needs_rng=True, differentiable=False,
          aliases=("random_poisson",))
def random_poisson(gen, lam: float = 1.0, shape=None, dtype="float32",
                   ctx=None):
    rate = torch.full(_shape(shape), float(lam), device=gen.device)
    return _poisson(gen, rate).to(torch_dtype(dtype))


@register("_random_negative_binomial", needs_rng=True, differentiable=False,
          aliases=("random_negative_binomial",))
def random_negative_binomial(gen, k: int = 1, p: float = 1.0, shape=None,
                             dtype="float32", ctx=None):
    """NB(k, p) as Poisson(Gamma(k, (1 - p) / p)): failures before the
    k-th success at success rate p."""
    g = _gamma(gen, k, _shape(shape), gen.device) * ((1 - p) / p)
    return _poisson(gen, g).to(torch_dtype(dtype))


@register("_random_generalized_negative_binomial", needs_rng=True,
          differentiable=False,
          aliases=("random_generalized_negative_binomial",))
def random_gen_neg_binomial(gen, mu: float = 1.0, alpha: float = 1.0,
                            shape=None, dtype="float32", ctx=None):
    """Poisson(Gamma(1 / alpha, mu alpha)): mean ``mu``, variance ``mu +
    alpha mu²``."""
    r = 1.0 / alpha
    p = r / (r + mu)
    g = _gamma(gen, r, _shape(shape), gen.device) * ((1 - p) / p)
    return _poisson(gen, g).to(torch_dtype(dtype))


@register("_random_randint", needs_rng=True, differentiable=False,
          aliases=("random_randint", "randint"))
def random_randint(gen, low: int = 0, high: int = 1, shape=None,
                   dtype="int32", ctx=None):
    return torch.randint(int(low), int(high), _shape(shape), generator=gen,
                         device=gen.device, dtype=torch_dtype(dtype))


@register("_sample_multinomial", needs_rng=True, differentiable=False,
          aliases=("sample_multinomial", "multinomial"))
def sample_multinomial(gen, data, shape=None, get_prob: bool = False,
                       dtype="int32"):
    """Category draws from the distributions on the last axis of ``data``
    (``data.shape[:-1] + shape``); ``get_prob`` also returns the log of
    each drawn category's probability, as MXNet's op does."""
    n = _shape(shape)
    count = 1
    for d in n:
        count *= d
    probs = data.reshape(-1, data.shape[-1]).float()
    draws = torch.multinomial(torch.clamp_min(probs, 1e-30), count,
                              replacement=True, generator=gen)
    out = draws.reshape(data.shape[:-1] + n)
    if not get_prob:
        return out.to(torch_dtype(dtype))
    logp = torch.log(torch.gather(probs, 1, draws)).reshape(out.shape)
    return out.to(torch_dtype(dtype)), logp.to(data.dtype)


@register("shuffle", needs_rng=True, differentiable=False,
          aliases=("_shuffle",))
def shuffle(gen, data):
    """The rows of ``data`` (its first axis) in a random order."""
    perm = torch.randperm(data.shape[0], generator=gen, device=data.device)
    return data[perm]


# --- per-element-parameter samplers ----------------------------------------
def _param(p, s):
    """A parameter tensor with ``len(s)`` trailing axes of 1."""
    return p.reshape(p.shape + (1,) * len(s))


@register("_sample_uniform", needs_rng=True, differentiable=False,
          aliases=("sample_uniform",))
def sample_uniform(gen, low, high, shape=None, dtype="float32"):
    s = _shape(shape)
    u = torch.rand(low.shape + s, generator=gen, device=low.device,
                   dtype=torch_dtype(dtype))
    lo = _param(low, s)
    return lo + u * (_param(high, s) - lo)


@register("_sample_normal", needs_rng=True, differentiable=False,
          aliases=("sample_normal",))
def sample_normal(gen, mu, sigma, shape=None, dtype="float32"):
    s = _shape(shape)
    z = torch.randn(mu.shape + s, generator=gen, device=mu.device,
                    dtype=torch_dtype(dtype))
    return _param(mu, s) + z * _param(sigma, s)


@register("_sample_gamma", needs_rng=True, differentiable=False,
          aliases=("sample_gamma",))
def sample_gamma(gen, alpha, beta, shape=None, dtype="float32"):
    s = _shape(shape)
    g = _gamma(gen, _param(alpha, s), alpha.shape + s, alpha.device)
    return (g * _param(beta, s)).to(torch_dtype(dtype))
