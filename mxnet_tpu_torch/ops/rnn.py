"""The fused recurrent op ``RNN``: vanilla RNN, LSTM and GRU layers.

Counterpart of ``mxnet_tpu/ops/rnn.py``, with the same contract: every
layer's weights in ONE flat parameter vector (layer-major, direction-minor,
``W_i2h (G*H, in)`` and ``W_h2h (G*H, H)`` for each (layer, direction),
then ``b_i2h`` and ``b_h2h`` for each), states ``(L*dirs, N, H)``, input
(T, N, C), and outputs ``(out (T, N, dirs*H), h_T, c_T)``; gate orders
LSTM [i, f, g, o] and GRU [r, z, n] with r multiplying ``h W_hn + b_hn``.
Those are torch's own orders, so the flat vector's slices go to torch's
fused RNN entries (``torch._VF.lstm``/``gru``/``rnn_tanh``/``rnn_relu``)
as views, in torch's per-(layer, direction) order ``w_ih, w_hh, b_ih,
b_hh``.  The JAX package hoists the input projection out of a
``lax.scan``; here the whole recurrence is torch's.

Which implementation runs is torch's dispatch on the device and the dtype
(``use_cudnn`` in ATen's ``RNN.cpp``; :func:`backend` states it): on the
card cuDNN's fused RNN for float16, float32 and float64, and for bfloat16
where cuDNN takes it (cuDNN 8.1 or later on compute capability 8.0 or
later, so on an H100); torch's native per-timestep cells otherwise, and
for every dtype on the CPU.  cuDNN wants the weights in one buffer of its
own layout: given the flat vector's views it compacts them into such a
buffer on every call (and warns that it does).

Kept from the JAX package where cuDNN would differ:

* inter-layer dropout (on every layer's output but the last, in training)
  is drawn from the port's generator (``mx.random``) between per-layer
  calls; cuDNN's own dropout state is never used;
* ``lstm_state_clip_min``/``max`` clip the final cell state only, not
  every step;
* ``use_sequence_length`` raises.

cuDNN's backward needs a forward run in training mode, so the forward's
``train`` flag follows whether a gradient is being recorded, and dropout
follows the autograd training flag (``training``).
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import MXNetError
from .registry import register

__all__ = ["rnn_param_size", "backend", "rnn"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}
_CUDNN_DTYPES = (torch.float32, torch.float16, torch.float64)
_CUDNN_BF16 = (8100, (8, 0))     # cuDNN version, compute capability


def rnn_param_size(num_layers: int, input_size: int, state_size: int,
                   bidirectional: bool, mode: str,
                   projection_size=None) -> int:
    """The flat parameter vector's length."""
    if projection_size is not None:
        raise MXNetError("RNN: projection is not supported")
    g = _GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        size += dirs * (g * state_size * (in_sz + state_size)
                        + 2 * g * state_size)
    return size


def _split_params(params, num_layers, input_size, state_size, bidirectional,
                  mode):
    """Views of the flat vector: ``[(W_i2h, W_h2h), ...]`` and
    ``[(b_i2h, b_h2h), ...]``, layer-major, direction-minor."""
    g = _GATES[mode]
    dirs = 2 if bidirectional else 1
    h = state_size
    shapes = []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else h * dirs
        shapes += [(g * h, in_sz), (g * h, h)] * dirs
    shapes += [(g * h,)] * (2 * num_layers * dirs)
    sizes = [s[0] * (s[1] if len(s) == 2 else 1) for s in shapes]
    if sum(sizes) != params.shape[0]:
        raise MXNetError("RNN: the parameter vector has %d elements, the "
                         "layers need %d" % (params.shape[0], sum(sizes)))
    parts = [p.view(s) for p, s in zip(torch.split(params, sizes), shapes)]
    n = num_layers * dirs
    weights = list(zip(parts[0:2 * n:2], parts[1:2 * n:2]))
    biases = list(zip(parts[2 * n::2], parts[2 * n + 1::2]))
    return weights, biases


def backend(data) -> str:
    """``"cudnn"`` or ``"native"``: the implementation torch's fused RNN
    entry runs for ``data``, decided by its device and dtype (see the
    module docstring)."""
    cudnn = torch.backends.cudnn
    if not (data.is_cuda and cudnn.enabled and cudnn.is_available()):
        return "native"
    if data.dtype in _CUDNN_DTYPES:
        return "cudnn"
    version, capability = _CUDNN_BF16
    if data.dtype == torch.bfloat16 and cudnn.version() >= version \
            and torch.cuda.get_device_capability(data.device) >= capability:
        return "cudnn"
    return "native"


def _torch_rnn(mode, x, h0, c0, flat_weights, num_layers, bidirectional,
               train):
    """torch's fused multi-layer RNN, without dropout."""
    if mode == "lstm":
        out, h, c = torch._VF.lstm(x, (h0, c0), flat_weights, True,
                                   num_layers, 0.0, train, bidirectional,
                                   False)
        return out, h, c
    fn = {"gru": torch._VF.gru, "rnn_tanh": torch._VF.rnn_tanh,
          "rnn_relu": torch._VF.rnn_relu}[mode]
    out, h = fn(x, h0, flat_weights, True, num_layers, 0.0, train,
                bidirectional, False)
    return out, h, None


@register("RNN", num_outputs=3, needs_training=True)
def rnn(data, parameters, state, state_cell=None, training: bool = False,
        state_size: int = 0, num_layers: int = 1, bidirectional: bool = False,
        mode: str = "lstm", p: float = 0.0, state_outputs: bool = False,
        lstm_state_clip_min=None, lstm_state_clip_max=None,
        lstm_state_clip_nan: bool = False, use_sequence_length: bool = False):
    """Fused multi-layer RNN: data (T, N, C), state (L*dirs, N, H);
    returns ``(out (T, N, dirs*H), h_T, c_T)`` (``c_T`` zeros but for
    LSTM)."""
    if use_sequence_length:
        raise MXNetError("RNN: use_sequence_length is not supported; mask "
                         "with SequenceMask")
    if mode not in _GATES:
        raise MXNetError("RNN: unknown mode %r" % (mode,))
    dirs = 2 if bidirectional else 1
    weights, biases = _split_params(parameters, num_layers, data.shape[2],
                                    state_size, bidirectional, mode)
    flat = []
    for (w_i2h, w_h2h), (b_i2h, b_h2h) in zip(weights, biases):
        flat += [w_i2h, w_h2h, b_i2h, b_h2h]
    train = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (data, parameters, state, state_cell))
    lstm = mode == "lstm"
    if not (training and p > 0.0 and num_layers > 1):
        out, h, c = _torch_rnn(mode, data, state, state_cell if lstm
                               else None, flat, num_layers, bidirectional,
                               train)
    else:
        # one call a layer, the dropout mask drawn between them
        keep = 1.0 - p
        gen = _random.generator(data.device)
        x, hs, cs = data, [], []
        for layer in range(num_layers):
            sl = slice(layer * dirs, (layer + 1) * dirs)
            x, h, c = _torch_rnn(
                mode, x, state[sl], state_cell[sl] if lstm else None,
                flat[4 * dirs * layer:4 * dirs * (layer + 1)], 1,
                bidirectional, train)
            hs.append(h)
            cs.append(c)
            if layer != num_layers - 1:
                mask = torch.bernoulli(torch.full(x.shape, keep,
                                                  device=x.device),
                                       generator=gen)
                x = torch.where(mask != 0, x / keep, torch.zeros_like(x))
        out, h = x, torch.cat(hs)
        c = torch.cat(cs) if lstm else None
    if not lstm:
        return out, h, torch.zeros_like(h)
    if lstm_state_clip_min is not None and lstm_state_clip_max is not None:
        c = torch.clamp(c, lstm_state_clip_min, lstm_state_clip_max)
    return out, h, c
