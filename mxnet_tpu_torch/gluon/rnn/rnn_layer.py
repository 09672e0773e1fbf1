"""Fused RNN layers (counterpart of mxnet_tpu/gluon/rnn/rnn_layer.py; the
reference's python/mxnet/gluon/rnn/rnn_layer.py): RNN, LSTM and GRU over
whole sequences through the fused ``RNN`` op (``ops/rnn_ops.py``). The
per-gate parameters (``l0_i2h_weight`` ...) are packed into the op's flat
vector on each call, in cuDNN's layout: every W and R first, then every
bias. TNC or NTC layout; eager or hybridized through the executor.
"""
from __future__ import annotations

from ... import ndarray as ndmod
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            f"Invalid layout {layout}; must be one of ['TNC' or 'NTC']"
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

        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]

        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                self._register_param(f"{j}{i}_i2h_weight", (ng * nh, ni),
                                     i2h_weight_initializer)
                self._register_param(f"{j}{i}_h2h_weight", (ng * nh, nh),
                                     h2h_weight_initializer)
                self._register_param(f"{j}{i}_i2h_bias", (ng * nh,),
                                     i2h_bias_initializer)
                self._register_param(f"{j}{i}_h2h_bias", (ng * nh,),
                                     h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)

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
        mapping = f"{shape[1] if shape[1] else None} -> " \
                  f"{shape[0] // self._gates}"
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        if func is None:
            func = ndmod.zeros
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(name=f"{self.prefix}h0_{i}", **info))
        return states

    def hybrid_forward(self, F, inputs, states=None, **params):
        if self._layout == "NTC":
            inputs = inputs.swapaxes(0, 1)
        skip_states = states is None
        if skip_states:
            if F is ndmod or hasattr(inputs, "context"):
                batch_size = inputs.shape[1]  # inputs already TNC here
                states = self.begin_state(batch_size, ctx=inputs.context)
            else:
                # symbolic trace: derive state shapes from the data symbol
                n_state = 2 if self._mode == "lstm" else 1
                states = [F._rnn_state_zeros(
                              inputs, num=self._num_layers * self._dir,
                              dim=self._hidden_size)
                          for _ in range(n_state)]
        if not isinstance(states, (list, tuple)):
            states = [states]

        flat = []
        for i in range(self._num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                flat.append(params[f"{j}{i}_i2h_weight"].reshape((-1,)))
                flat.append(params[f"{j}{i}_h2h_weight"].reshape((-1,)))
        for i in range(self._num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                flat.append(params[f"{j}{i}_i2h_bias"])
                flat.append(params[f"{j}{i}_h2h_bias"])
        flat_params = F.Concat(*flat, dim=0)

        rnn_args = [inputs, flat_params] + list(states)
        out = F.RNN(*rnn_args, state_size=self._hidden_size,
                    num_layers=self._num_layers,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=True, mode=self._mode)
        if self._mode == "lstm":
            outputs, states = out[0], [out[1], out[2]]
        else:
            outputs, states = out[0], [out[1]]
        if self._layout == "NTC":
            outputs = outputs.swapaxes(0, 1)
        if skip_states:
            return outputs
        return outputs, states


class RNN(_RNNLayer):
    """Elman RNN (relu or tanh) over sequences."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
