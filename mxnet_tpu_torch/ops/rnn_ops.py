"""The fused ``RNN`` operator (counterpart of mxnet_tpu/ops/rnn_ops.py).

The reference's cuDNN-backed multi-layer RNN (src/operator/rnn-inl.h) in
all four modes (``rnn_relu``, ``rnn_tanh``, ``lstm``, ``gru``), with the
JAX op's structure: for each layer and direction, the input projection of
the whole sequence is one product, then a loop over time of the
recurrent product and the cell update (the JAX op's ``lax.scan``); the
reverse direction flips time. Dropout between layers draws from the op's
generator (``octx.rng``), in training only and not after the last layer.
torch's autograd differentiates the loop, as it does the port's other
ops. The op computes in its inputs' dtype. The JAX package has no Pallas
kernel here, so neither does the port: the loop's products and cell
updates are plain PyTorch ops.

Flat parameter layout, as cuDNN's and MXNet's: for each layer, each
direction, the input weights W (gates*H, in) then the recurrent weights R
(gates*H, H); after all of them, for each layer and direction, the input
bias bW (gates*H) then the recurrent bias bR (gates*H). Gate order: LSTM
i, f, g, o; GRU r, z, n, where n applies r to ``h R^T + bR``.

``lstm_state_clip_min`` / ``_max`` / ``_nan`` are accepted and, as in the
JAX op, have no effect (MXNet's own op clips the cell state).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import Param, register

__all__ = ["rnn_param_size"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    """Total flat parameter count (cuDNN's GetParamSize)."""
    g = _GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        size += dirs * g * state_size * (in_sz + state_size)  # W + R
        size += dirs * g * state_size * 2                      # bW + bR
    return size


def _unpack_params(params, num_layers, input_size, state_size, dirs, gates):
    """The flat vector as per-(layer, direction) [W, R, bW, bR] views."""
    ptr = 0
    gh = gates * state_size
    mats = []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        layer_mats = []
        for _ in range(dirs):
            w = params[ptr:ptr + gh * in_sz].view(gh, in_sz)
            ptr += gh * in_sz
            r = params[ptr:ptr + gh * state_size].view(gh, state_size)
            ptr += gh * state_size
            layer_mats.append([w, r, None, None])
        mats.append(layer_mats)
    for layer in range(num_layers):
        for d in range(dirs):
            mats[layer][d][2] = params[ptr:ptr + gh]
            ptr += gh
            mats[layer][d][3] = params[ptr:ptr + gh]
            ptr += gh
    return mats


def _run_layer(x, h0, c0, w, r, bw, br, mode, reverse):
    """One direction of one layer over time; x (T, N, in). Returns
    (outputs (T, N, H), last h, last c or None)."""
    if reverse:
        x = torch.flip(x, (0,))
    rt = r.t()
    h, c = h0, c0
    ys = []
    if mode == "gru":
        xw = F.linear(x, w, bw)                # the whole sequence at once
        for t in range(x.shape[0]):
            xr, xz, xn = xw[t].chunk(3, -1)
            hr, hz, hn = F.linear(h, r, br).chunk(3, -1)
            rg = torch.sigmoid(xr + hr)
            zg = torch.sigmoid(xz + hz)
            ng = torch.tanh(xn + rg * hn)
            h = (1 - zg) * ng + zg * h
            ys.append(h)
    else:
        # both biases enter every step's pre-activation: added once here
        xw = F.linear(x, w, bw + br)
        if mode == "lstm":
            H = h0.shape[-1]
            for t in range(x.shape[0]):
                gin = torch.addmm(xw[t], h, rt)
                s = torch.sigmoid(gin)
                i, f, o = s[:, :H], s[:, H:2 * H], s[:, 3 * H:]
                g = torch.tanh(gin[:, 2 * H:3 * H])
                c = f * c + i * g
                h = o * torch.tanh(c)
                ys.append(h)
        else:
            act = torch.tanh if mode == "rnn_tanh" else torch.relu
            for t in range(x.shape[0]):
                h = act(torch.addmm(xw[t], h, rt))
                ys.append(h)
    ys = torch.stack(ys)
    if reverse:
        ys = torch.flip(ys, (0,))
    return ys, h, c


def _rnn(attrs, octx, data, params, state, *rest):
    mode = attrs["mode"]
    if mode not in _GATES:
        raise MXNetError(f"RNN: unknown mode {mode}")
    state_size = attrs["state_size"]
    num_layers = attrs["num_layers"]
    dirs = 2 if attrs["bidirectional"] else 1
    state_cell = rest[0] if (mode == "lstm" and rest) else None
    T, N, input_size = data.shape
    want = rnn_param_size(num_layers, input_size, state_size,
                          attrs["bidirectional"], mode)
    if params.numel() != want:
        raise MXNetError(f"RNN: {params.numel()} parameters given, the "
                         f"{mode} layout needs {want}")
    mats = _unpack_params(params, num_layers, input_size, state_size, dirs,
                          _GATES[mode])
    p = attrs["p"]
    x = data
    h_states, c_states = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(dirs):
            idx = layer * dirs + d
            c0 = state_cell[idx] if state_cell is not None else None
            w, r, bw, br = mats[layer][d]
            ys, hT, cT = _run_layer(x, state[idx], c0, w, r, bw, br, mode,
                                    reverse=(d == 1))
            outs.append(ys)
            h_states.append(hT)
            if cT is not None:
                c_states.append(cT)
        x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
        if p > 0 and octx.is_train and layer < num_layers - 1 and \
                octx.rng is not None:
            keep = torch.empty(x.shape, dtype=torch.float32,
                               device=x.device).bernoulli_(
                                   1.0 - p, generator=octx.rng)
            x = torch.where(keep > 0, x / (1.0 - p),
                            torch.zeros((), dtype=x.dtype, device=x.device))
    outputs = [x, torch.stack(h_states)]
    if mode == "lstm":
        outputs.append(torch.stack(c_states))
    return tuple(outputs)


def _rnn_infer(attrs, in_shapes):
    ds = in_shapes[0]
    mode = attrs["mode"]
    state_size = attrs["state_size"]
    num_layers = attrs["num_layers"]
    dirs = 2 if attrs["bidirectional"] else 1
    in_shapes = list(in_shapes)
    if ds is None:
        return in_shapes, [None] * (3 if mode == "lstm" else 2)
    T, N, input_size = ds
    if in_shapes[1] is None:
        in_shapes[1] = (rnn_param_size(num_layers, input_size, state_size,
                                       attrs["bidirectional"], mode),)
    if in_shapes[2] is None:
        in_shapes[2] = (num_layers * dirs, N, state_size)
    if mode == "lstm" and len(in_shapes) > 3 and in_shapes[3] is None:
        in_shapes[3] = (num_layers * dirs, N, state_size)
    out = [(T, N, state_size * dirs), (num_layers * dirs, N, state_size)]
    if mode == "lstm":
        out.append((num_layers * dirs, N, state_size))
    return in_shapes, out


def _rnn_num_outputs(attrs):
    # output and h (and c for lstm) whatever state_outputs says, as the
    # JAX op: consumers take [0]
    return 3 if attrs["mode"] == "lstm" else 2


_rnn_schema = register(
    "RNN", _rnn,
    params={"state_size": Param("int", None, True),
            "num_layers": Param("int", None, True),
            "bidirectional": Param("bool", False),
            "mode": Param("str", None, True),
            "p": Param("float", 0.0),
            "state_outputs": Param("bool", False),
            "lstm_state_clip_min": Param("float", None),
            "lstm_state_clip_max": Param("float", None),
            "lstm_state_clip_nan": Param("bool", False)},
    inputs=("data", "parameters", "state", "state_cell"),
    num_outputs=_rnn_num_outputs, needs_rng=True, infer_shape=_rnn_infer)


def _rnn_inputs(attrs):
    if attrs["mode"] == "lstm":
        return ["data", "parameters", "state", "state_cell"]
    return ["data", "parameters", "state"]


_rnn_schema.list_inputs = _rnn_inputs
_rnn_schema.num_inputs = lambda attrs: 4 if attrs["mode"] == "lstm" else 3


def _state_zeros(attrs, octx, data):
    # begin states (num, N, dim), N from the TNC data: a hybridized RNN
    # layer traces without concrete states
    return (torch.zeros((attrs["num"], data.shape[1], attrs["dim"]),
                        dtype=data.dtype, device=data.device),)


def _state_zeros_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None]
    return in_shapes, [(attrs["num"], ds[1], attrs["dim"])]


register("_rnn_state_zeros", _state_zeros,
         params={"num": Param("int", None, True),
                 "dim": Param("int", None, True)},
         inputs=("data",), infer_shape=_state_zeros_infer)


def _cell_state_zeros(attrs, octx, data):
    # a cell's begin state (N, dim), N from its (N, ...) first input
    return (torch.zeros((data.shape[0], attrs["dim"]), dtype=data.dtype,
                        device=data.device),)


def _cell_state_zeros_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None]
    return in_shapes, [(ds[0], attrs["dim"])]


register("_cell_state_zeros", _cell_state_zeros,
         params={"dim": Param("int", None, True)},
         inputs=("data",), infer_shape=_cell_state_zeros_infer)
