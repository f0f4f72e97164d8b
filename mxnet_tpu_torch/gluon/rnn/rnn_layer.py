"""Fused recurrent layers ``RNN``, ``LSTM`` and ``GRU``.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py``.  Each layer owns
per-(layer, direction) parameters with the JAX package's names
(``l0_i2h_weight``, ``r0_h2h_bias``...), so ``load_jax_params`` carries
them by structural name, and concatenates them into the ``RNN`` op's flat
vector on every forward (``ops/rnn.py``: cuDNN's fused RNN on the card,
torch's native cells on the CPU).  Shapes are deferred
until the first forward; layouts TNC and NTC; ``forward`` takes optional
states and then returns them too; ``_unfuse`` gives the same network as
cells that share the parameters.
"""
from __future__ import annotations

from ...ops.rnn import _GATES
from ..block import HybridBlock
from . import rnn_cell

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """The fused multi-layer recurrent layer."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise ValueError("Invalid layout %s; must be one of ['TNC' or "
                             "'NTC']" % layout)
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer
        self._gates = _GATES[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                self._register_param("%s%d_i2h_weight" % (j, i),
                                     (ng * nh, ni), i2h_weight_initializer)
                self._register_param("%s%d_h2h_weight" % (j, i),
                                     (ng * nh, nh), h2h_weight_initializer)
                self._register_param("%s%d_i2h_bias" % (j, i), (ng * nh,),
                                     i2h_bias_initializer)
                self._register_param("%s%d_h2h_bias" % (j, i), (ng * nh,),
                                     h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        setattr(self, name, self.params.get(name, shape=shape, init=init,
                                            allow_deferred_init=True))

    def _cell_prefixes(self):
        """``l0_``, ``r0_``, ``l1_``...: layer-major, direction-minor."""
        return ["%s%d_" % (j, i) for i in range(self._num_layers)
                for j in ["l", "r"][:self._dir]]

    def infer_shape(self, x, *args):
        """The input size from the input's last axis."""
        ni = x.shape[-1]
        ng, nh = self._gates, self._hidden_size
        for i, p in enumerate(self._cell_prefixes()):
            if i and i % self._dir == 0:
                ni = nh * self._dir
            getattr(self, p + "i2h_weight")._finish_deferred_init(
                (ng * nh, ni))
            getattr(self, p + "h2h_weight")._finish_deferred_init(
                (ng * nh, nh))
            getattr(self, p + "i2h_bias")._finish_deferred_init((ng * nh,))
            getattr(self, p + "h2h_bias")._finish_deferred_init((ng * nh,))

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = "%s -> %s" % (shape[1] if shape[1] else None,
                                shape[0] // self._gates)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states (zeros unless ``func`` makes them)."""
        from ... import ndarray as nd
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            info = dict(info)
            info.update(kwargs)
            info.pop("__layout__", None)
            states.append(func(**info))
        return states

    def _unfuse(self):
        """The same network as a ``HybridSequentialRNNCell`` of per-layer
        cells (dropout cells between them) that share these parameters."""
        get_cell = {
            "rnn_relu": lambda **kw: rnn_cell.RNNCell(
                self._hidden_size, activation="relu", **kw),
            "rnn_tanh": lambda **kw: rnn_cell.RNNCell(
                self._hidden_size, activation="tanh", **kw),
            "lstm": lambda **kw: rnn_cell.LSTMCell(self._hidden_size, **kw),
            "gru": lambda **kw: rnn_cell.GRUCell(self._hidden_size, **kw),
        }[self._mode]
        stack = rnn_cell.HybridSequentialRNNCell(prefix=self.prefix,
                                                 params=self.params)
        with stack.name_scope():
            ni = self._input_size
            for i in range(self._num_layers):
                kwargs = {
                    "input_size": ni,
                    "i2h_weight_initializer": self._i2h_weight_initializer,
                    "h2h_weight_initializer": self._h2h_weight_initializer,
                    "i2h_bias_initializer": self._i2h_bias_initializer,
                    "h2h_bias_initializer": self._h2h_bias_initializer,
                }
                if self._dir == 2:
                    stack.add(rnn_cell.BidirectionalCell(
                        get_cell(prefix="l%d_" % i, **kwargs),
                        get_cell(prefix="r%d_" % i, **kwargs)))
                else:
                    stack.add(get_cell(prefix="l%d_" % i, **kwargs))
                if self._dropout > 0 and i != self._num_layers - 1:
                    stack.add(rnn_cell.DropoutCell(self._dropout))
                ni = self._hidden_size * self._dir
        return stack

    def forward(self, inputs, states=None):
        """The output, or ``(output, states)`` when ``states`` are given."""
        from ... import ndarray as nd
        batch_size = inputs.shape[self._layout.find("N")]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context,
                                      dtype=inputs.dtype)
        if isinstance(states, nd.NDArray):
            states = [states]
        for state, info in zip(states, self.state_info(batch_size)):
            if state.shape != info["shape"]:
                raise ValueError(
                    "Invalid recurrent state shape. Expecting %s, got %s." % (
                        str(info["shape"]), str(state.shape)))
        out = self._forward_kernel(inputs, states)
        return out[0] if skip_states else out

    def _flat_params(self):
        from ... import ndarray as nd
        cells = self._cell_prefixes()
        ws = [getattr(self, p + k).data().reshape(-1)
              for p in cells for k in ("i2h_weight", "h2h_weight")]
        bs = [getattr(self, p + k).data()
              for p in cells for k in ("i2h_bias", "h2h_bias")]
        return nd.concat(*(ws + bs), dim=0)

    def _forward_kernel(self, inputs, states):
        from ... import ndarray as nd
        if self._layout == "NTC":
            inputs = nd.swapaxes(inputs, dim1=0, dim2=1)
        if any(p._data is None for p in self.collect_params().values()):
            self.infer_shape(inputs)
        rnn_args = states[:2] if self._mode == "lstm" else states[:1]
        out, h, c = nd.RNN(
            inputs, self._flat_params(), *rnn_args,
            state_size=self._hidden_size, num_layers=self._num_layers,
            bidirectional=self._dir == 2, p=self._dropout,
            state_outputs=True, mode=self._mode)
        if self._layout == "NTC":
            out = nd.swapaxes(out, dim1=0, dim2=1)
        return out, ([h, c] if self._mode == "lstm" else [h])


class RNN(_RNNLayer):
    """Multi-layer Elman RNN with a ``relu`` or ``tanh`` activation."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "lstm", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}] * 2


class GRU(_RNNLayer):
    """Multi-layer GRU."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
