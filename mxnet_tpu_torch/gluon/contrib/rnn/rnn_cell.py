"""``VariationalDropoutCell`` (Gal & Ghahramani 2016), port of
``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``: one dropout mask each for
the inputs, the first state and the outputs, drawn at the first step in
training mode after ``reset()`` from ``mx.nd.Dropout``'s device
generator and reused at every later step of the sequence."""
from __future__ import annotations

from ...rnn.rnn_cell import _ModifierCell

__all__ = ["VariationalDropoutCell"]


class VariationalDropoutCell(_ModifierCell):
    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self._drop_inputs = drop_inputs
        self._drop_states = drop_states
        self._drop_outputs = drop_outputs
        self._mask_inputs = None
        self._mask_states = None
        self._mask_outputs = None

    def reset(self):
        super().reset()
        self._mask_inputs = None
        self._mask_states = None
        self._mask_outputs = None

    def _mask(self, F, existing, rate, like):
        from .... import autograd
        if rate == 0.0 or not autograd.is_training():
            return existing, like
        if existing is None:
            existing = F.Dropout(F.ones_like(like), p=rate, mode="always")
        return existing, like * existing

    def hybrid_forward(self, F, x, states):
        self._mask_inputs, x = self._mask(F, self._mask_inputs,
                                          self._drop_inputs, x)
        if self._drop_states:
            self._mask_states, s0 = self._mask(F, self._mask_states,
                                               self._drop_states, states[0])
            states = [s0] + list(states[1:])
        out, next_states = self.base_cell(x, states)
        self._mask_outputs, out = self._mask(F, self._mask_outputs,
                                             self._drop_outputs, out)
        return out, next_states

    def __repr__(self):
        return (f"VariationalDropoutCell(in={self._drop_inputs}, "
                f"state={self._drop_states}, out={self._drop_outputs})")
