"""Unrolled recurrent cells.

Port of ``mxnet_tpu/gluon/rnn/rnn_cell.py``: ``RNNCell``/``LSTMCell``/
``GRUCell`` step functions written with ``hybrid_forward`` over
``mx.nd``, as the reference writes them, the ``SequentialRNNCell``/
``BidirectionalCell``/``DropoutCell``/``ResidualCell``/``ZoneoutCell``
wrappers and the ``unroll`` driver (a Python loop over time steps, with
``valid_length``: each sequence's state taken at its last valid step,
its outputs past it zeroed).  Gate orders match ``ops.rnn.fused_rnn``
(LSTM: i, f, g, o; GRU: r, z, n with ``n = tanh(i2h_n + r * h2h_n)``),
so cell and fused-layer parameters interchange.  The dropout and zoneout
masks come from ``mx.nd.Dropout``'s device generator, not threefry bits.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ResidualCell", "ZoneoutCell"]


class RecurrentCell(HybridBlock):
    """Base cell."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial states: a list of zeros."""
        from ... import ndarray as F
        if func is None:
            func = F.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            states.append(func(shape=info["shape"], **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run the cell ``length`` steps.  ``inputs`` is (N, T, C) for NTC
        (or a list of T arrays); returns (outputs, states)."""
        from ... import ndarray as F
        inputs, batch_size = _format_sequence(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch_size)
        states = begin_state
        outputs = []
        all_states = []
        for i in range(length):
            out, states = self(inputs[i], states)
            outputs.append(out)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [
                F.SequenceLast(F.stack(*[s[j] for s in all_states], axis=0),
                               sequence_length=valid_length,
                               use_sequence_length=True, axis=0)
                for j in range(len(states))]
            outputs = _mask_sequence(outputs, valid_length)
        outputs = _merge_sequence(outputs, layout, merge_outputs)
        return outputs, states

    _capture_runs = "forward"

    def forward(self, x, states):
        self._counter += 1
        return super().forward(x, states)


HybridRecurrentCell = RecurrentCell


def _format_sequence(length, inputs, layout):
    from ... import ndarray as F
    axis = layout.find("T")
    if isinstance(inputs, (list, tuple)):
        if length is not None and len(inputs) != length:
            raise MXNetError(f"unroll: len(inputs) {len(inputs)} != "
                             f"length {length}")
        return list(inputs), inputs[0].shape[layout.find("N")]
    batch = inputs.shape[layout.find("N")]
    seq = F.split(inputs, num_outputs=inputs.shape[axis], axis=axis,
                  squeeze_axis=True)
    return (seq if isinstance(seq, list) else [seq]), batch


def _mask_sequence(outputs, valid_length):
    masked = []
    for i, out in enumerate(outputs):
        keep = (valid_length > i).astype(out.dtype)
        masked.append(out * keep.reshape((-1,) + (1,) * (out.ndim - 1)))
    return masked


def _merge_sequence(outputs, layout, merge):
    from ... import ndarray as F
    if merge is False:
        return outputs
    return F.stack(*outputs, axis=layout.find("T"))


class _BaseCell(RecurrentCell):
    """Parameters shared by the RNN, LSTM and GRU cells."""

    _num_gates = 1

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        ng = self._num_gates
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(ng * hidden_size, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(ng * hidden_size, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(ng * hidden_size,),
                init=i2h_bias_initializer, allow_deferred_init=True)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(ng * hidden_size,),
                init=h2h_bias_initializer, allow_deferred_init=True)
        self._place(device)

    def infer_shape(self, x, *args):
        if self.i2h_weight.shape[1] == 0:
            self.i2h_weight.shape = (self.i2h_weight.shape[0], x.shape[-1])

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _linear(self, F, x, states, i2h_weight, h2h_weight, i2h_bias,
                h2h_bias):
        i2h = F.dot(x, i2h_weight, transpose_b=True) + i2h_bias
        h2h = F.dot(states[0], h2h_weight, transpose_b=True) + h2h_bias
        return i2h, h2h


class RNNCell(_BaseCell):
    """Elman cell: h' = act(W_i x + b_i + W_h h + b_h)."""

    _num_gates = 1

    def __init__(self, hidden_size, activation="tanh", **kwargs):
        super().__init__(hidden_size, **kwargs)
        self._activation = activation

    @property
    def _gate_names(self):
        return ("",)

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight, i2h_bias,
                       h2h_bias):
        i2h, h2h = self._linear(F, x, states, i2h_weight, h2h_weight,
                                i2h_bias, h2h_bias)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_BaseCell):
    """LSTM cell, gate order (i, f, g, o) as the fused op's."""

    _num_gates = 4

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight, i2h_bias,
                       h2h_bias):
        i2h, h2h = self._linear(F, x, states, i2h_weight, h2h_weight,
                                i2h_bias, h2h_bias)
        gi, gf, gg, go = F.split(i2h + h2h, num_outputs=4, axis=-1)
        c = F.sigmoid(gf) * states[1] + F.sigmoid(gi) * F.tanh(gg)
        h = F.sigmoid(go) * F.tanh(c)
        return h, [h, c]


class GRUCell(_BaseCell):
    """GRU cell, gate order (r, z, n) with ``n = tanh(i2h_n + r *
    h2h_n)``."""

    _num_gates = 3

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight, i2h_bias,
                       h2h_bias):
        i2h, h2h = self._linear(F, x, states, i2h_weight, h2h_weight,
                                i2h_bias, h2h_bias)
        i_r, i_z, i_n = F.split(i2h, num_outputs=3, axis=-1)
        h_r, h_z, h_n = F.split(h2h, num_outputs=3, axis=-1)
        r = F.sigmoid(i_r + h_r)
        z = F.sigmoid(i_z + h_z)
        n = F.tanh(i_n + r * h_n)
        h = (1 - z) * n + z * states[0]
        return h, [h]


class SequentialRNNCell(RecurrentCell):
    """Stacked cells; the state list is the concatenation of the
    children's."""

    def add(self, cell):
        self.register_child(cell)
        return self

    def state_info(self, batch_size=0):
        return sum((c.state_info(batch_size)
                    for c in self._children.values()), [])

    def begin_state(self, batch_size=0, func=None, **kwargs):
        return sum((c.begin_state(batch_size, func, **kwargs)
                    for c in self._children.values()), [])

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    _capture_runs = "forward"

    def forward(self, x, states):
        self._counter += 1
        next_states = []
        pos = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            x, new_states = cell(x, states[pos:pos + n])
            pos += n
            next_states.extend(new_states)
        return x, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Layer by layer: each cell unrolls the whole sequence."""
        if begin_state is None:
            _, batch = _format_sequence(length, inputs, layout)
            begin_state = self.begin_state(batch)
        pos = 0
        next_states = []
        cells = list(self._children.values())
        for i, cell in enumerate(cells):
            n = len(cell.state_info())
            inputs, states = cell.unroll(
                length, inputs, begin_state[pos:pos + n], layout,
                merge_outputs=None if i < len(cells) - 1 else merge_outputs,
                valid_length=valid_length)
            pos += n
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(RecurrentCell):
    """Dropout on each step's input."""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, x, states):
        if self._rate:
            x = F.Dropout(x, p=self._rate)
        return x, states


class _ModifierCell(RecurrentCell):
    """Base of the cells that wrap another cell."""

    def __init__(self, base_cell):
        super().__init__(prefix=None, params=None)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        return self.base_cell.begin_state(batch_size, func, **kwargs)


class ResidualCell(_ModifierCell):
    """out = base(x) + x."""

    def hybrid_forward(self, F, x, states):
        out, states = self.base_cell(x, states)
        return out + x, states


class ZoneoutCell(_ModifierCell):
    """Zoneout: keep the previous output and states at random, in
    training mode."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, x, states):
        from ... import autograd
        out, new_states = self.base_cell(x, states)
        if autograd.is_training():
            if self._zoneout_outputs:
                prev = self._prev_output
                if prev is None:
                    prev = F.zeros_like(out)
                mask = F.Dropout(F.ones_like(out), p=self._zoneout_outputs)
                out = F.where(mask, out, prev)
            if self._zoneout_states:
                new_states = [
                    F.where(F.Dropout(F.ones_like(ns),
                                      p=self._zoneout_states), ns, s)
                    for ns, s in zip(new_states, states)]
        self._prev_output = out.detach()
        return out, new_states


class BidirectionalCell(RecurrentCell):
    """Two cells over the sequence in opposite directions; only through
    ``unroll``."""

    def __init__(self, l_cell, r_cell):
        super().__init__(prefix=None, params=None)
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return (self.l_cell.state_info(batch_size) +
                self.r_cell.state_info(batch_size))

    def begin_state(self, batch_size=0, func=None, **kwargs):
        return (self.l_cell.begin_state(batch_size, func, **kwargs) +
                self.r_cell.begin_state(batch_size, func, **kwargs))

    def __call__(self, *args, **kwargs):
        raise MXNetError("BidirectionalCell cannot be stepped; use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as F
        inputs, batch = _format_sequence(length, inputs, layout)
        if begin_state is None:
            begin_state = self.begin_state(batch)
        nl = len(self.l_cell.state_info())
        inner = "TNC" if layout == "TNC" else "NTC"
        l_out, l_states = self.l_cell.unroll(
            length, inputs, begin_state[:nl], layout=inner,
            merge_outputs=False, valid_length=valid_length)
        r_out, r_states = self.r_cell.unroll(
            length, list(reversed(inputs)), begin_state[nl:], layout=inner,
            merge_outputs=False, valid_length=valid_length)
        outs = [F.concat(lo, ro, dim=-1)
                for lo, ro in zip(l_out, reversed(r_out))]
        return _merge_sequence(outs, layout, merge_outputs), \
            l_states + r_states
