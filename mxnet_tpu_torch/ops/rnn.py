"""The fused RNN op: the whole multi-layer (bi)directional recurrence as
one op.

Port of ``mxnet_tpu/ops/rnn.py``.  The reference runs a ``lax.scan``
over time a (layer, direction); the port runs the same recurrence as a
Python loop over time steps of plain PyTorch, which a captured program
(``Trainer.fused_step``, ``hybridize()``) records into one CUDA graph.
It is not a Pallas kernel in the reference, so there is no hand-written
kernel here.

Gate orders are the reference's: LSTM (i, f, g, o), so ``LSTMBias``'s
forget chunk is [H:2H]; GRU (r, z, n) with ``n = tanh(i2h_n + r *
h2h_n)``.  Each step sums ``gx + gh``, each a product plus its bias, as
the reference does (not ``torch.nn.LSTM``/cuDNN, whose bias and
summation order differ).  The input projection ``x @ wi.T + bi`` is
taken for all time steps in one product (each row is the same product
as the reference's per step).

Weight layout per (layer, direction), matching the layer's parameter
order: i2h_weight (G·H, in), h2h_weight (G·H, H), i2h_bias, h2h_bias;
the second direction runs over reversed time.  Inter-layer dropout
draws its masks from ``ops.nn.dropout``'s device generator (the
reference draws threefry bits from ``next_key()``), which a captured
program registers with its graph, so every replay draws fresh masks.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .nn import dropout as _dropout
from .registry import alias, op

__all__ = ["fused_rnn"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _rnn_step(mode, gx, h, c, wh, bh):
    """One time step from the input's projection ``gx`` (N, G·H) and
    h/c (N, H).  Returns (out, h, c)."""
    gh = h @ wh.t() + bh
    H = h.shape[-1]
    if mode == "rnn_relu":
        h = torch.relu(gx + gh)
        return h, h, c
    if mode == "rnn_tanh":
        h = torch.tanh(gx + gh)
        return h, h, c
    if mode == "lstm":
        g = gx + gh
        i = torch.sigmoid(g[:, :H])
        f = torch.sigmoid(g[:, H:2 * H])
        gg = torch.tanh(g[:, 2 * H:3 * H])
        o = torch.sigmoid(g[:, 3 * H:])
        c = f * c + i * gg
        h = o * torch.tanh(c)
        return h, h, c
    if mode == "gru":
        r = torch.sigmoid(gx[:, :H] + gh[:, :H])
        z = torch.sigmoid(gx[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gx[:, 2 * H:] + r * gh[:, 2 * H:])
        h = (1 - z) * n + z * h
        return h, h, c
    raise MXNetError(f"unknown rnn mode {mode}")


def _scan_direction(mode, x, h0, c0, wi, wh, bi, bh, reverse):
    """x (T, N, in) -> (out (T, N, H), h_n, c_n)."""
    T = x.shape[0]
    gxs = x @ wi.t() + bi                          # (T, N, G·H)
    h, c = h0, c0
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        outs[t], h, c = _rnn_step(mode, gxs[t], h, c, wh, bh)
    return torch.stack(outs), h, c


@op("fused_rnn", variadic=True, wrap=False)
def fused_rnn(*arrays, mode="lstm", num_layers=1, bidirectional=False,
              dropout=0.0, training=False, layout="TNC"):
    """arrays = [x, h0, (c0 if lstm), then per (layer, direction):
    i2h_weight, h2h_weight, i2h_bias, h2h_bias].

    x is (T, N, in) for layout TNC or (N, T, in) for NTC; h0/c0 are
    (num_layers·dirs, N, H).  Returns (out, h_n[, c_n])."""
    if mode not in _GATES:
        raise MXNetError(f"unknown rnn mode {mode}")
    if layout not in ("TNC", "NTC"):
        raise MXNetError(f"invalid layout {layout}; expected TNC or NTC")
    ndir = 2 if bidirectional else 1
    x = arrays[0]
    if layout == "NTC":
        x = x.transpose(0, 1)
    has_c = mode == "lstm"
    h0 = arrays[1]
    c0 = arrays[2] if has_c else None
    weights = arrays[3 if has_c else 2:]
    if len(weights) != 4 * num_layers * ndir:
        raise MXNetError(f"fused_rnn: expected {4 * num_layers * ndir} "
                         f"weight arrays, got {len(weights)}")

    inp = x
    h_states, c_states = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(ndir):
            idx = layer * ndir + d
            wi, wh, bi, bh = weights[4 * idx:4 * idx + 4]
            h_init = h0[idx]
            c_init = c0[idx] if has_c else torch.zeros_like(h_init)
            out, h_n, c_n = _scan_direction(mode, inp, h_init, c_init, wi,
                                            wh, bi, bh, reverse=(d == 1))
            outs.append(out)
            h_states.append(h_n)
            c_states.append(c_n)
        inp = outs[0] if ndir == 1 else torch.cat(outs, dim=-1)
        if dropout and training and layer < num_layers - 1:
            inp = _dropout(inp, dropout, True)

    out = inp if layout == "TNC" else inp.transpose(0, 1)
    h_n = torch.stack(h_states)
    if has_c:
        return out, h_n, torch.stack(c_states)
    return out, h_n


alias("RNN", "fused_rnn")
