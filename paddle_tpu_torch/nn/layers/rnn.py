"""RNN cells and layers (counterpart of paddle_tpu/nn/layers/rnn.py).

Every time step is written in plain torch ops, as the reference writes
it: the input product plus its bias, then the hidden product plus its
bias, ``(x W_ih^T + b_ih) + h W_hh^T + b_hh``, and the elementwise gates
in the reference's order (i, f, g, o for the LSTM; r, z, n for the GRU).
The multi-layer ``LSTM``/``GRU``/``SimpleRNN`` loop over time in Python
where the reference fuses the loop into one ``lax.scan``; neither uses
``torch.nn.LSTM``/``GRU`` or cuDNN's fused RNN, whose sums run in
another order.

As in the reference, the multi-layer layers apply no ``dropout`` between
layers, and no layer reads ``sequence_length``: every sequence runs all
its steps. A ``SimpleRNN``'s activation belongs to the instance (the
reference sets it on the class, so that building a ReLU one turns every
tanh one into ReLU).
"""
import math

import torch

from ...amp.auto_cast import cast_inputs
from .. import initializer as I
from ..layer import Layer

_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


def _create_weights(module, gates, hidden_size, input_size, suffix, attrs, device,
                    generator):
    """weight_ih [gates*H, in], weight_hh [gates*H, H], bias_ih and
    bias_hh [gates*H], each uniform in +-1/sqrt(H) unless its attr (of
    ``attrs``, in that order) says otherwise, registered under their names
    plus ``suffix``."""
    std = 1.0 / math.sqrt(hidden_size)
    init = I.Uniform(-std, std)
    for (name, shape), attr in zip((("weight_ih", [gates * hidden_size, input_size]),
                                    ("weight_hh", [gates * hidden_size, hidden_size]),
                                    ("bias_ih", [gates * hidden_size]),
                                    ("bias_hh", [gates * hidden_size])), attrs):
        module.add_parameter(name + suffix, module.create_parameter(
            shape, attr=attr, is_bias=name.startswith("bias"), default_initializer=init,
            device=device, generator=generator))


def _simple_step(x, h, wi, wh, bi, bh, activation):
    pre = x @ wi.T + bi + h @ wh.T + bh
    return torch.tanh(pre) if activation == "tanh" else torch.relu(pre)


def _lstm_step(x, h, c, wi, wh, bi, bh):
    gates = x @ wi.T + bi + h @ wh.T + bh
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def _gru_step(x, h, wi, wh, bi, bh):
    r_i, z_i, n_i = (x @ wi.T + bi).chunk(3, dim=-1)
    r_h, z_h, n_h = (h @ wh.T + bh).chunk(3, dim=-1)
    r = torch.sigmoid(r_i + r_h)
    z = torch.sigmoid(z_i + z_h)
    n = torch.tanh(n_i + r * n_h)
    return (1 - z) * n + z * h


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None, init_value=0.0,
                           batch_dim_idx=0):
        """[batch, hidden_size] filled with ``init_value`` (float32 unless
        ``dtype``) on ``batch_ref``'s device, the batch read from
        ``batch_ref``'s axis ``batch_dim_idx``."""
        dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        return torch.full((batch_ref.shape[batch_dim_idx], self.hidden_size),
                          float(init_value), dtype=dtype or torch.float32,
                          device=batch_ref.device)

    def _weights(self):
        return self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh


class SimpleRNNCell(RNNCellBase):
    """h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh), act tanh or relu.
    Returns (h', h')."""

    def __init__(self, input_size, hidden_size, activation="tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, generator=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        _create_weights(self, 1, hidden_size, input_size, "",
                        (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr), device,
                        generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        args = cast_inputs("simple_rnn_cell", inputs, states, *self._weights())
        h = _simple_step(*args, self.activation)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    """Gates i, f, g, o; c' = f c + i g, h' = o tanh(c'). ``states`` is
    (h, c); returns (h', (h', c'))."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        _create_weights(self, 4, hidden_size, input_size, "",
                        (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr), device,
                        generator)

    def forward(self, inputs, states=None):
        if states is None:
            h = self.get_initial_states(inputs)
            c = self.get_initial_states(inputs)
        else:
            h, c = states
        h_new, c_new = _lstm_step(*cast_inputs("lstm_cell", inputs, h, c, *self._weights()))
        return h_new, (h_new, c_new)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    """Gates r, z, n; h' = (1 - z) n + z h. Returns (h', h')."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        _create_weights(self, 3, hidden_size, input_size, "",
                        (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr), device,
                        generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = _gru_step(*cast_inputs("gru_cell", inputs, states, *self._weights()))
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class RNN(Layer):
    """Runs ``cell`` over the time axis (axis 1, or 0 when
    ``time_major``), backwards when ``is_reverse``. Returns (outputs
    stacked on the time axis, final states)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        time_axis = 0 if self.time_major else 1
        xs = inputs.unbind(time_axis)
        if self.is_reverse:
            xs = xs[::-1]
        states = initial_states
        outs = []
        for x in xs:
            out, states = self.cell(x, states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        return torch.stack(outs, dim=time_axis), states


class BiRNN(Layer):
    """``cell_fw`` forwards and ``cell_bw`` backwards over the same
    inputs; outputs concatenated on the last axis, states (fw, bw)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        st_fw, st_bw = initial_states if initial_states is not None else (None, None)
        out_fw, fw_states = self.rnn_fw(inputs, st_fw)
        out_bw, bw_states = self.rnn_bw(inputs, st_bw)
        return torch.cat(cast_inputs("concat", out_fw, out_bw), dim=-1), (fw_states, bw_states)


class _RNNBase(Layer):
    """Multi-layer, optionally bidirectional RNN over [batch, time, in]
    ([time, batch, in] when ``time_major``). Layer k's weights are
    ``weight_ih_l{k}``, ``weight_hh_l{k}``, ``bias_ih_l{k}``,
    ``bias_hh_l{k}``, with ``_rev`` for the backward direction. Initial
    and final states are [layers * directions, batch, hidden] ((h, c) for
    the LSTM)."""

    MODE = "LSTM"

    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *, device=None,
                 generator=None):
        super().__init__()
        attrs = (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self.mode = self.MODE
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.time_major = time_major
        self.dropout = dropout  # not applied, as in the reference
        ndir = 2 if self.bidirectional else 1
        for layer in range(num_layers):
            for d in range(ndir):
                in_size = input_size if layer == 0 else hidden_size * ndir
                _create_weights(self, _GATES[self.mode], hidden_size, in_size,
                                self._suffix(layer, d), attrs, device, generator)

    @staticmethod
    def _suffix(layer, d):
        return f"_l{layer}" + ("_rev" if d else "")

    def _zero_state(self, inputs):
        ndir = 2 if self.bidirectional else 1
        batch = inputs.shape[1 if self.time_major else 0]
        return torch.zeros((self.num_layers * ndir, batch, self.hidden_size),
                           device=inputs.device)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        lstm = self.mode == "LSTM"
        if initial_states is None:
            states = (self._zero_state(inputs),) * (2 if lstm else 1)
        else:
            states = tuple(initial_states) if lstm else (initial_states,)
        ndir = 2 if self.bidirectional else 1
        names = [self._suffix(layer, d) for layer in range(self.num_layers)
                 for d in range(ndir)]
        weights = [getattr(self, w + s) for s in names
                   for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        op = {"LSTM": "fused_lstm", "GRU": "fused_gru"}.get(self.mode, "fused_rnn")
        x, *rest = cast_inputs(op, inputs, *states, *weights)
        states, weights = rest[:len(states)], rest[len(states):]
        out = x if self.time_major else x.transpose(0, 1)  # [time, batch, in]
        finals = [[] for _ in states]
        for layer in range(self.num_layers):
            dir_outs = []
            for d in range(ndir):
                i = layer * ndir + d
                carry = [s[i] for s in states]
                ys = [None] * out.shape[0]
                for t in (range(out.shape[0] - 1, -1, -1) if d else range(out.shape[0])):
                    carry = self._step(out[t], carry, weights[4 * i:4 * i + 4])
                    ys[t] = carry[0]
                dir_outs.append(torch.stack(ys))
                for f, c in zip(finals, carry):
                    f.append(c)
            out = dir_outs[0] if ndir == 1 else torch.cat(dir_outs, dim=-1)
        if not self.time_major:
            out = out.transpose(0, 1)
        finals = tuple(torch.stack(f) for f in finals)
        return out, (finals if lstm else finals[0])

    def _step(self, x, carry, w):
        if self.mode == "LSTM":
            return _lstm_step(x, *carry, *w)
        if self.mode == "GRU":
            return [_gru_step(x, carry[0], *w)]
        return [_simple_step(x, carry[0], *w, "tanh" if self.mode == "RNN_TANH" else "relu")]


class LSTM(_RNNBase):
    MODE = "LSTM"


class GRU(_RNNBase):
    MODE = "GRU"


class SimpleRNN(_RNNBase):
    """``activation`` "tanh" or "relu", this instance's own."""

    MODE = "RNN_TANH"

    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, activation="tanh", **kwargs):
        super().__init__(input_size, hidden_size, num_layers, direction, time_major,
                         dropout, **kwargs)
        self.mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
