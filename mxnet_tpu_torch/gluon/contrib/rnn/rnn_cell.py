"""Contrib recurrent cells (counterpart of
``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``; reference
``python/mxnet/gluon/contrib/rnn/rnn_cell.py``: VariationalDropoutCell :27,
LSTMPCell :197).  Dropout masks come from the port's generator
(``mx.random``) through the ``Dropout`` op."""
from __future__ import annotations

from ...rnn.rnn_cell import (HybridRecurrentCell, ModifierCell,
                             BidirectionalCell)

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell):
    """Variational (a.k.a. locked) dropout: ONE dropout mask per unroll,
    reused across every time step, applied to inputs/states/outputs
    (reference contrib/rnn/rnn_cell.py:27).
    """

    def __init__(self, base_cell, drop_inputs=0., drop_states=0.,
                 drop_outputs=0.):
        if drop_states and isinstance(base_cell, BidirectionalCell):
            raise AssertionError(
                "BidirectionalCell doesn't support variational state "
                "dropout; wrap the cells underneath instead.")
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _initialize_input_masks(self, F, inputs, states):
        if self.drop_states and self.drop_states_mask is None:
            self.drop_states_mask = F.Dropout(
                F.ones_like(states[0]), p=self.drop_states)
        if self.drop_inputs and self.drop_inputs_mask is None:
            self.drop_inputs_mask = F.Dropout(
                F.ones_like(inputs), p=self.drop_inputs)

    def _initialize_output_mask(self, F, output):
        if self.drop_outputs and self.drop_outputs_mask is None:
            self.drop_outputs_mask = F.Dropout(
                F.ones_like(output), p=self.drop_outputs)

    def hybrid_forward(self, F, inputs, states):
        cell = self.base_cell
        self._initialize_input_masks(F, inputs, states)
        if self.drop_states:
            # only the h state is dropped (reference :91-97)
            states = list(states)
            states[0] = states[0] * self.drop_states_mask
        if self.drop_inputs:
            inputs = inputs * self.drop_inputs_mask
        next_output, next_states = cell(inputs, states)
        self._initialize_output_mask(F, next_output)
        if self.drop_outputs:
            next_output = next_output * self.drop_outputs_mask
        return next_output, next_states

    def __repr__(self):
        return "VariationalDropoutCell(p_out=%s, p_state=%s)" % (
            self.drop_outputs, self.drop_states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs,
                              valid_length=valid_length)


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a projected hidden state (LSTMP, reference
    contrib/rnn/rnn_cell.py:197; gates [i, f, g, o], then
    h' = W_proj · (o * tanh(c'))).

    State shapes: h is ``projection_size``, c is ``hidden_size``.
    """

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None,
                 h2h_weight_initializer=None, h2r_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=h2r_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def infer_shape(self, x, *args):
        h, p = self._hidden_size, self._projection_size
        self.i2h_weight._finish_deferred_init((4 * h, x.shape[-1]))
        self.h2h_weight._finish_deferred_init((4 * h, p))
        self.h2r_weight._finish_deferred_init((p, h))
        self.i2h_bias._finish_deferred_init((4 * h,))
        self.h2h_bias._finish_deferred_init((4 * h,))

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        h = self._hidden_size
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias, num_hidden=4 * h)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * h)
        gates = i2h + h2h
        slices = F.split(gates, num_outputs=4, axis=-1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = F.tanh(slices[2])
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        hidden = out_gate * F.tanh(next_c)
        next_r = F.FullyConnected(hidden, h2r_weight, None, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]

    def __repr__(self):
        shape = self.i2h_weight.shape
        proj = self.h2r_weight.shape[0]
        return "LSTMPCell(%s -> %s -> %s)" % (
            shape[1] if shape[1] else None, shape[0], proj)
