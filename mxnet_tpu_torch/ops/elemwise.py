"""Elementwise unary, binary, scalar and comparison operators on torch
tensors.

Counterpart of ``mxnet_tpu/ops/elemwise.py``, every name it registers:
the unary table (its ``jax.numpy``, ``jax.nn`` and ``jax.scipy.special``
entries too), ``hard_sigmoid``, ``clip``, ``BlockGrad``, ``make_loss``,
the binary table with its aliases, the comparison and logical families,
the scalar and reversed-scalar ops, ``where`` and ``smooth_l1``.  The
dtypes are ``jax.numpy``'s with 64-bit types off: a function that only
floats have (``sqrt``, ``exp``, ``rint``...) turns an integer input into
float32, ``abs``, ``sign``, ``ceil`` and their kind keep it; a comparison
or logical op returns 1 or 0 in its first operand's dtype; a Python
scalar takes the array's dtype unless it is a float beside an integer
array (torch's rule for a 0-d operand is ``jnp``'s for a weak type).
``mod`` follows ``jnp.mod`` (the sign of the divisor, ``torch.remainder``)
and ``rint`` rounds half to even.

The ops bound to torch builtins are plain functions with the parameters
of the JAX package's op (``jnp.add`` is a ufunc called as ``(*args,
out=None, where=None)``, ``jnp.divide`` takes ``(x1, x2, /)``,
``jnp.abs`` ``(x, /)``), because the symbol layer reads an op's input
slots and attributes from its signature.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import alias, register

__all__ = ["hard_sigmoid", "clip", "block_grad", "make_loss", "where",
           "smooth_l1"]


def _inexact(x):
    """``x`` as a floating tensor: integers and booleans become float32,
    as ``jnp`` promotes them for a function only floats have."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _floats(fn):
    return lambda x: fn(_inexact(x))


def _rounding(fn):
    """``ceil``/``floor``/``trunc``: integers pass through unchanged."""
    return lambda x: fn(x) if x.is_floating_point() else x


def _cbrt(x):
    x = _inexact(x)
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def _ufunc(fn):
    """``fn`` called as a numpy ufunc, ``(*args, out=None, where=None)``:
    the signature of the JAX package's ``jnp.add``, ``jnp.maximum``..."""
    def k(*args, out=None, where=None):
        if out is not None or where is not None:
            raise MXNetError("out= and where= of a ufunc are not supported")
        return fn(*args)
    return k


def _x1_x2(fn):
    """``fn`` with the JAX package's ``(x1, x2, /)`` signature."""
    def k(x1, x2, /):
        return fn(x1, x2)
    return k


def _x(fn):
    """``fn`` with the JAX package's ``(x, /)`` signature."""
    def k(x, /):
        return fn(x)
    return k


def _identity(x):
    # a copy: a variable of the port is updated in place, and the JAX
    # package's identity is an array of its own
    return x.clone()


# --- unary table -----------------------------------------------------------
_UNARY = {
    "abs": _x(torch.abs),
    "sign": _x(torch.sign),
    "rint": _floats(torch.round),
    "ceil": _rounding(torch.ceil),
    "floor": _rounding(torch.floor),
    "trunc": _rounding(torch.trunc),
    "fix": _rounding(torch.trunc),
    "square": _x(torch.square),
    "sqrt": _floats(torch.sqrt),
    "rsqrt": _floats(torch.rsqrt),
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": _floats(torch.exp),
    "log": _floats(torch.log),
    "log10": _floats(torch.log10),
    "log2": _floats(torch.log2),
    "log1p": _floats(torch.log1p),
    "expm1": _floats(torch.expm1),
    "sin": _floats(torch.sin),
    "cos": _floats(torch.cos),
    "tan": _floats(torch.tan),
    "arcsin": _floats(torch.asin),
    "arccos": _floats(torch.acos),
    "arctan": _floats(torch.atan),
    "sinh": _floats(torch.sinh),
    "cosh": _floats(torch.cosh),
    "tanh": _floats(torch.tanh),
    "arcsinh": _floats(torch.asinh),
    "arccosh": _floats(torch.acosh),
    "arctanh": _floats(torch.atanh),
    "degrees": _floats(torch.rad2deg),
    "radians": _floats(torch.deg2rad),
    "reciprocal": _floats(torch.reciprocal),
    "negative": _ufunc(torch.neg),
    "logical_not": lambda x: (x == 0).to(x.dtype),
    "erf": _floats(torch.erf),
    "erfinv": _floats(torch.erfinv),
    # the JAX package's gamma is exp(gammaln): |Gamma(x)|
    "gamma": lambda x: torch.exp(torch.lgamma(_inexact(x))),
    "gammaln": _floats(torch.lgamma),
    "sigmoid": _floats(torch.sigmoid),
    "relu": _x(torch.relu),
    "softsign": lambda x: _inexact(x) / (1 + torch.abs(_inexact(x))),
    "identity": _identity,
}

for _name, _fn in _UNARY.items():
    register(_name)(_fn)

alias("identity", "_copy", "stop_gradient_identity", "BlockGrad_inner")


@register("hard_sigmoid")
def hard_sigmoid(x, alpha: float = 0.2, beta: float = 0.5):
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


@register("clip")
def clip(data, a_min: float = None, a_max: float = None):
    return torch.clamp(data, a_min, a_max)


@register("BlockGrad", differentiable=False, aliases=("stop_gradient",))
def block_grad(data):
    return data.detach()


@register("make_loss")
def make_loss(data, grad_scale: float = 1.0, valid_thresh: float = 0.0,
              normalization: str = "null"):
    """The value of ``data`` with gradient ``grad_scale``, by the JAX
    package's formula ``data * s - stop_gradient(data * (s - 1))`` (whose
    rounding it keeps); ``valid_thresh`` and ``normalization`` are accepted
    and unused there too."""
    if grad_scale == 1.0:
        return data
    return data * grad_scale - (data * (grad_scale - 1.0)).detach()


# --- binary table ----------------------------------------------------------
def _tensors(a, b):
    """Both operands as tensors in their common dtype: a Python scalar
    becomes a 0-d tensor, which torch promotes as ``jnp`` promotes a
    weakly typed scalar (a float beside an integer array gives float32,
    else the array's dtype wins)."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, device=a.device)
    dt = torch.result_type(a, b)
    return a.to(dt), b.to(dt)


def _promoted(fn):
    """``fn`` of two operands in their common dtype (``torch.maximum``
    takes neither mixed dtypes nor a Python scalar)."""
    return lambda a, b: fn(*_tensors(a, b))


def _promoted_floats(fn):
    """``fn`` of two operands in their common dtype, float32 for two
    integers (``hypot`` and ``arctan2`` take floats only)."""
    def k(x1, x2, /):
        a, b = _tensors(x1, x2)
        return fn(_inexact(a), _inexact(b))
    return k


_hypot = _promoted_floats(torch.hypot)
_arctan2 = _promoted_floats(torch.atan2)


_BINARY = {
    "elemwise_add": _ufunc(torch.add),
    "elemwise_sub": _ufunc(torch.sub),
    "elemwise_mul": _ufunc(torch.mul),
    "elemwise_div": _x1_x2(torch.div),
    "broadcast_add": _ufunc(torch.add),
    "broadcast_sub": _ufunc(torch.sub),
    "broadcast_mul": _ufunc(torch.mul),
    "broadcast_div": _x1_x2(torch.div),
    "broadcast_mod": _x1_x2(torch.remainder),
    "broadcast_power": _x1_x2(torch.pow),
    "broadcast_maximum": _ufunc(_promoted(torch.maximum)),
    "broadcast_minimum": _ufunc(_promoted(torch.minimum)),
    "broadcast_hypot": _hypot,
    "maximum": _ufunc(_promoted(torch.maximum)),
    "minimum": _ufunc(_promoted(torch.minimum)),
    "hypot": _hypot,
    "arctan2": _arctan2,
    # MXNet's ldexp takes a float exponent: lhs * 2 ** rhs
    "ldexp": lambda a, b: a * torch.pow(2.0, b),
    "power": _x1_x2(torch.pow),
    "mod": _x1_x2(torch.remainder),
}

for _name, _fn in _BINARY.items():
    register(_name)(_fn)

alias("broadcast_add", "broadcast_plus", "_add", "_plus")
alias("broadcast_sub", "broadcast_minus", "_sub", "_minus")
alias("broadcast_mul", "_mul")
alias("broadcast_div", "_div")
alias("broadcast_power", "_power", "pow")
alias("broadcast_mod", "_mod")


def _cmp(fn):
    """1 where ``fn`` holds, 0 elsewhere, in the first operand's dtype."""
    return lambda a, b: fn(a, b).to(a.dtype)


for _name, _fn in {
    "broadcast_equal": torch.eq,
    "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt,
    "broadcast_greater_equal": torch.ge,
    "broadcast_lesser": torch.lt,
    "broadcast_lesser_equal": torch.le,
    "broadcast_logical_and": lambda a, b: (a != 0) & (b != 0),
    "broadcast_logical_or": lambda a, b: (a != 0) | (b != 0),
    "broadcast_logical_xor": lambda a, b: (a != 0) ^ (b != 0),
}.items():
    register(_name, differentiable=False)(_cmp(_fn))

for _name in ("equal", "not_equal", "greater", "greater_equal", "lesser",
              "lesser_equal", "logical_and", "logical_or", "logical_xor"):
    alias("broadcast_" + _name, _name)


# --- scalar variants -------------------------------------------------------
def _scalar_op(fn, swap=False):
    """``fn(data, scalar)``, or ``fn(scalar, data)`` reversed: torch takes
    a Python scalar as a 0-d operand, promoted as ``jnp`` promotes it."""
    def k(data, scalar: float = 0.0):
        return fn(scalar, data) if swap else fn(data, scalar)
    return k


for _name, _fn, _swap in [
    ("_plus_scalar", torch.add, False),
    ("_minus_scalar", torch.sub, False),
    ("_rminus_scalar", torch.sub, True),
    ("_mul_scalar", torch.mul, False),
    ("_div_scalar", torch.div, False),
    ("_rdiv_scalar", torch.div, True),
    ("_mod_scalar", torch.remainder, False),
    ("_rmod_scalar", torch.remainder, True),
    ("_power_scalar", torch.pow, False),
    ("_rpower_scalar", torch.pow, True),
    ("_maximum_scalar", _promoted(torch.maximum), False),
    ("_minimum_scalar", _promoted(torch.minimum), False),
    ("_hypot_scalar", _hypot, False),
]:
    register(_name)(_scalar_op(_fn, _swap))

for _name, _fn in [
    ("_equal_scalar", torch.eq),
    ("_not_equal_scalar", torch.ne),
    ("_greater_scalar", torch.gt),
    ("_greater_equal_scalar", torch.ge),
    ("_lesser_scalar", torch.lt),
    ("_lesser_equal_scalar", torch.le),
]:
    register(_name, differentiable=False)(_scalar_op(_cmp(_fn)))


@register("where")
def where(condition, x, y):
    """``x`` where ``condition`` is nonzero, else ``y``."""
    return torch.where(condition != 0, x, y)


@register("smooth_l1")
def smooth_l1(data, scalar: float = 1.0):
    s2 = scalar * scalar
    a = torch.abs(data)
    return torch.where(a < 1.0 / s2, 0.5 * s2 * data * data, a - 0.5 / s2)
