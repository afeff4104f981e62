"""The port's RNN cells and layers (paddle_tpu_torch/nn/layers/rnn.py)
against the JAX package's: SimpleRNNCell (tanh, relu), LSTMCell, GRUCell,
RNN and BiRNN over a cell, and the multi-layer LSTM, GRU and SimpleRNN,
2 layers, bidirectional, batch- and time-major. Weights are carried
across by convert.load_numpy_state under the reference's parameter names,
inputs come from a numpy seed; hidden 8. Tolerance 1e-5 in float32."""
import ast
import pathlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_numpy_state

torch.set_num_threads(1)

TOL = 1e-5
IN, HID, B, STEPS = 5, 8, 3, 6


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t.numpy())


def _pair(jlayer, tlayer):
    """Carry jlayer's weights into tlayer, under the same names."""
    state = {n: np.asarray(p.numpy()) for n, p in jlayer.named_parameters()}
    assert list(state) == [n for n, _ in tlayer.named_parameters()]
    load_numpy_state(tlayer, state)
    return jlayer, tlayer


def _close(got, want):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


def _run(jlayer, tlayer, *args):
    """Both layers on the same numpy inputs (tuples of arrays stay tuples)."""
    def conv(a, f):
        if isinstance(a, tuple):
            return tuple(conv(x, f) for x in a)
        return None if a is None else f(a)
    jout = jlayer(*[conv(a, paddle.to_tensor) for a in args])
    with torch.inference_mode():
        tout = tlayer(*[conv(a, torch.from_numpy) for a in args])
    _close(tout, jout)
    return tout


CELLS = {
    "simple_tanh": (lambda: jnn.SimpleRNNCell(IN, HID),
                    lambda: tnn.SimpleRNNCell(IN, HID, device="cpu")),
    "simple_relu": (lambda: jnn.SimpleRNNCell(IN, HID, activation="relu"),
                    lambda: tnn.SimpleRNNCell(IN, HID, activation="relu", device="cpu")),
    "lstm": (lambda: jnn.LSTMCell(IN, HID), lambda: tnn.LSTMCell(IN, HID, device="cpu")),
    "gru": (lambda: jnn.GRUCell(IN, HID), lambda: tnn.GRUCell(IN, HID, device="cpu")),
}


@pytest.mark.parametrize("kind", list(CELLS))
def test_cell(kind):
    j, t = _pair(CELLS[kind][0](), CELLS[kind][1]())
    gates = {"lstm": 4, "gru": 3}.get(kind, 1)
    assert tuple(t.weight_ih.shape) == (gates * HID, IN)
    assert t.state_shape == j.state_shape
    x = _x(B, IN, seed=1)
    h = _x(B, HID, seed=2)
    state = (h, _x(B, HID, seed=3)) if kind == "lstm" else h
    _run(j, t, x)  # zero initial states
    _run(j, t, x, state)
    init = t.get_initial_states(torch.zeros(4, 2), init_value=0.5)
    assert tuple(init.shape) == (4, HID) and init.dtype == torch.float32
    assert bool((init == 0.5).all())


@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("time_major", [False, True])
def test_rnn_and_birnn_over_cells(kind, time_major):
    jcls, tcls = CELLS[kind]
    j, t = _pair(jnn.RNN(jcls(), is_reverse=True, time_major=time_major),
                 tnn.RNN(tcls(), is_reverse=True, time_major=time_major))
    x = _x(STEPS, B, IN, seed=4) if time_major else _x(B, STEPS, IN, seed=4)
    _run(j, t, x)
    j, t = _pair(jnn.BiRNN(jcls(), jcls(), time_major=time_major),
                 tnn.BiRNN(tcls(), tcls(), time_major=time_major))
    out, _ = _run(j, t, x)
    assert out.shape[-1] == 2 * HID


LAYERS = {
    "lstm": (jnn.LSTM, tnn.LSTM),
    "gru": (jnn.GRU, tnn.GRU),
    "simple": (jnn.SimpleRNN, tnn.SimpleRNN),
}


@pytest.mark.parametrize("kind", list(LAYERS))
@pytest.mark.parametrize("direction,time_major", [("bidirect", False), ("forward", True)])
def test_multilayer_rnn(kind, direction, time_major):
    jcls, tcls = LAYERS[kind]
    j, t = _pair(jcls(IN, HID, 2, direction, time_major),
                 tcls(IN, HID, 2, direction, time_major, device="cpu"))
    ndir = 2 if direction == "bidirect" else 1
    assert tuple(t.weight_ih_l1.shape) == ({"lstm": 4, "gru": 3}.get(kind, 1) * HID,
                                           HID * ndir)
    x = _x(STEPS, B, IN, seed=5) if time_major else _x(B, STEPS, IN, seed=5)
    _run(j, t, x)  # zero initial states
    h0 = _x(2 * ndir, B, HID, seed=6)
    _run(j, t, x, (h0, _x(2 * ndir, B, HID, seed=7)) if kind == "lstm" else h0)


def test_relu_simple_rnn_keeps_its_mode_per_instance():
    """A ReLU SimpleRNN against the JAX one. The reference sets the mode on
    its class, so the JAX layer is built last, just before it runs, and
    the class's mode is restored after; the port's mode belongs to each
    instance."""
    t = tnn.SimpleRNN(IN, HID, 2, "bidirect", device="cpu", activation="relu")
    tanh = tnn.SimpleRNN(IN, HID, device="cpu")
    assert (t.mode, tanh.mode, tnn.SimpleRNN.MODE) == ("RNN_RELU", "RNN_TANH", "RNN_TANH")
    x = _x(B, STEPS, IN, seed=8)
    saved = jnn.SimpleRNN.MODE
    try:
        j = jnn.SimpleRNN(IN, HID, 2, "bidirect", activation="relu")
        _pair(j, t)
        out, _ = _run(j, t, x)
    finally:
        jnn.SimpleRNN.MODE = saved
    assert bool((out >= 0).all())


def test_no_library_rnn_kernel():
    """Each time step is written in plain torch ops: the module names no
    torch.nn RNN class and no fused RNN function."""
    src = pathlib.Path(tnn.LSTM.__module__.replace(".", "/") + ".py")
    path = pathlib.Path(__file__).resolve().parent.parent / src
    names = {n.attr for n in ast.walk(ast.parse(path.read_text())) if isinstance(n, ast.Attribute)}
    assert not names & {"LSTM", "GRU", "RNN", "RNNBase", "lstm", "gru", "rnn_tanh", "rnn_relu",
                        "_cudnn_rnn", "lstm_cell", "gru_cell"}
