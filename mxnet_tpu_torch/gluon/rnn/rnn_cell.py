"""Recurrent cells and their modifiers.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``: single-step
``RNNCell``, ``LSTMCell`` (gates [i, f, g, o]) and ``GRUCell`` (gates
[r, z, n]) with the fused layers' gate orders, so ``_RNNLayer._unfuse``
gives cells that share the layer's weights; the sequential, dropout,
zoneout, residual and bidirectional cells; and ``unroll``, a Python loop
of cell calls over the time axis, with ``valid_length`` masking the
outputs past each row's length and taking each row's states at its last
valid step.  Dropout and zoneout masks come from the port's generator
(``mx.random``), through the ``Dropout`` op.
"""
from __future__ import annotations

from ..block import Block, HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge):
    """The unroll inputs as a list of steps (``merge=False``) or one array
    (``merge=True``), with the time axis and the batch size."""
    from ... import ndarray as nd
    from ...ndarray import NDArray
    if layout not in ("NTC", "TNC"):
        raise ValueError("unsupported layout %s" % layout)
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, NDArray):
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            if length is None:
                length = inputs.shape[axis]
            inputs = [x.reshape([s for i, s in enumerate(x.shape)
                                 if i != axis])
                      for x in nd.split(inputs, length, axis=axis)]
    else:
        batch_size = inputs[0].shape[0]
        if merge is True:
            inputs = nd.stack(*inputs, axis=axis)
    return inputs, axis, batch_size


def _valid_mask(valid_length, step, like):
    """1 where ``valid_length > step``, broadcast over ``like``'s rows."""
    return (valid_length > step).reshape((-1,) + (1,) * (len(like.shape) - 1))


class RecurrentCell(Block):
    """Base recurrent cell: ``cell(inputs, states) -> (output, states)``
    for one step."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset the step counters (before unrolling again)."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states (zeros unless ``func`` makes them)."""
        if self._modified:
            raise AssertionError(
                "After applying modifier cells the base cell cannot be "
                "called directly. Call the modifier cell instead.")
        from ... import ndarray as nd
        if func is None:
            func = nd.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            info.update(kwargs)
            states.append(func(**info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """The cell run over ``length`` steps of ``inputs``: (outputs, the
        final states).  Outputs are a list of steps, or one array with
        ``merge_outputs``."""
        from ... import ndarray as nd
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        states = begin_state
        outputs, all_states = [], []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [nd.SequenceLast(nd.stack(*ele_list, axis=0),
                                      sequence_length=valid_length,
                                      use_sequence_length=True, axis=0)
                      for ele_list in zip(*all_states)]
            outputs = [o * _valid_mask(valid_length, i, o)
                       for i, o in enumerate(outputs)]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)

    def _alias(self):
        return "recurrentcell"


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """A cell whose step is ``hybrid_forward(F, x, states, **params)``."""

    def forward(self, inputs, states):
        self._counter += 1
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, states, **kwargs):
        raise NotImplementedError


class _BaseGatedCell(HybridRecurrentCell):
    """The parameters of the RNN, LSTM and GRU cells."""

    def __init__(self, hidden_size, num_gates, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        g = num_gates
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(g * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(g * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(g * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(g * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)
        self._num_gates = g

    def infer_shape(self, x, *args):
        g = self._num_gates
        self.i2h_weight._finish_deferred_init(
            (g * self._hidden_size, x.shape[-1]))
        self.h2h_weight._finish_deferred_init(
            (g * self._hidden_size, self._hidden_size))
        self.i2h_bias._finish_deferred_init((g * self._hidden_size,))
        self.h2h_bias._finish_deferred_init((g * self._hidden_size,))


class RNNCell(_BaseGatedCell):
    """Elman cell: ``h' = act(W_i x + b_i + W_h h + b_h)``."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 **kwargs):
        super().__init__(hidden_size, 1, input_size, **kwargs)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(_BaseGatedCell):
    """LSTM cell, gates [i, f, g, o]."""

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 4, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}] * 2

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h = self._hidden_size
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias, num_hidden=4 * h)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * h)
        slices = F.split(i2h + h2h, num_outputs=4, axis=-1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = F.tanh(slices[2])
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(_BaseGatedCell):
    """GRU cell, gates [r, z, n]; r multiplies ``h W_hn + b_hn``."""

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 3, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        h = self._hidden_size
        prev = states[0]
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias, num_hidden=3 * h)
        h2h = F.FullyConnected(prev, h2h_weight, h2h_bias, num_hidden=3 * h)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=-1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=-1)
        reset = F.sigmoid(i2h_r + h2h_r)
        update = F.sigmoid(i2h_z + h2h_z)
        new = F.tanh(i2h_n + reset * h2h_n)
        next_h = (1 - update) * new + update * prev
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in turn, each on its own
    states."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        if self._modified:
            raise AssertionError("After applying modifier cells the base "
                                 "cell cannot be called directly.")
        return _cells_begin_state(self._children.values(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children.values():
            if isinstance(cell, BidirectionalCell):
                raise NotImplementedError(
                    "Bidirectional cannot be stepped. Please use unroll")
            n = len(cell.state_info())
            inputs, new_states = cell(inputs, states[p:p + n])
            p += n
            next_states.extend(new_states)
        return inputs, next_states

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)


class HybridSequentialRNNCell(SequentialRNNCell):
    pass


class ModifierCell(HybridRecurrentCell):
    """A cell wrapping a base cell, whose parameters it shares."""

    def __init__(self, base_cell):
        if base_cell._modified:
            raise AssertionError("Cell %s is already modified."
                                 % base_cell.name)
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        if self._modified:
            raise AssertionError("After applying modifier cells the base "
                                 "cell cannot be called directly.")
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class DropoutCell(HybridRecurrentCell):
    """Dropout on the input, states passed through."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout: each output and state entry keeps its previous value with
    probability ``zoneout_outputs``/``zoneout_states`` in training."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        if isinstance(base_cell, BidirectionalCell):
            raise AssertionError("BidirectionalCell doesn't support zoneout")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        p_outputs, p_states = self.zoneout_outputs, self.zoneout_states

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = F.where(mask(p_outputs, next_output), next_output,
                         prev_output) if p_outputs != 0.0 else next_output
        new_states = (
            [F.where(mask(p_states, ns), ns, s)
             for ns, s in zip(next_states, states)]
            if p_states != 0.0 else next_states)
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Two cells over opposite directions, their outputs concatenated; it
    runs through ``unroll`` only."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        if self._modified:
            raise AssertionError("After applying modifier cells the base "
                                 "cell cannot be called directly.")
        return _cells_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as nd
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        if begin_state is None:
            begin_state = self.begin_state(batch_size=batch_size)
        states = begin_state
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info(batch_size))
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[n_l:], layout=layout, merge_outputs=False,
            valid_length=valid_length)
        outputs = [nd.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, reversed(r_outputs))]
        if merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states
