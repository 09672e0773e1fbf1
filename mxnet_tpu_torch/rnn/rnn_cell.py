"""Symbolic RNN cells, ``mx.rnn`` (counterpart of
mxnet_tpu/rnn/rnn_cell.py; the reference's python/mxnet/rnn/rnn_cell.py).

``BaseRNNCell.unroll`` composes a cell's step over time into one Symbol;
``RNNCell``, ``LSTMCell`` and ``GRUCell`` step with ``FullyConnected``
and ``SliceChannel``; ``FusedRNNCell`` is the whole sequence as one
``RNN`` op (``ops/rnn_ops.py``), with ``unfuse`` to the equivalent stack
of cells; ``SequentialRNNCell``, ``BidirectionalCell``, ``DropoutCell``,
``ZoneoutCell`` and ``ResidualCell`` compose them. The executor runs the
unrolled graph (a ``BucketingModule`` binds one per sequence length).
"""
from __future__ import annotations

from .. import symbol

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ZoneoutCell", "ResidualCell", "ModifierCell"]


class RNNParams:
    """Container for holding variables (rnn_cell.py RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified, \
            "After applying modifier cells (e.g. DropoutCell) the base " \
            "cell cannot be called directly. Call the modifier cell instead."
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if info is None:
                state = func(name=f"{self._prefix}begin_state_"
                             f"{self._init_counter}", **kwargs)
            else:
                kwargs.update(info)
                state = func(name=f"{self._prefix}begin_state_"
                             f"{self._init_counter}", **kwargs)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Split fused parameter blobs into per-gate weights."""
        args = args.copy()
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ["i2h", "h2h"]:
            weight = args.pop(f"{self._prefix}{group_name}_weight")
            bias = args.pop(f"{self._prefix}{group_name}_bias")
            for j, gate in enumerate(self._gate_names):
                wname = f"{self._prefix}{group_name}{gate}_weight"
                args[wname] = weight[j * h:(j + 1) * h].copy()
                bname = f"{self._prefix}{group_name}{gate}_bias"
                args[bname] = bias[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        from ..ndarray.ndarray import concatenate
        args = args.copy()
        if not self._gate_names:
            return args
        for group_name in ["i2h", "h2h"]:
            weight = []
            bias = []
            for gate in self._gate_names:
                wname = f"{self._prefix}{group_name}{gate}_weight"
                weight.append(args.pop(wname))
                bname = f"{self._prefix}{group_name}{gate}_bias"
                bias.append(args.pop(bname))
            args[f"{self._prefix}{group_name}_weight"] = concatenate(weight)
            args[f"{self._prefix}{group_name}_bias"] = concatenate(bias)
        return args

    def _begin_state_like(self, first_input):
        """Symbolic zero states with batch size derived from the input
        symbol (static-shape realization of the reference's 0-unknown
        begin_state shapes)."""
        return [symbol._cell_state_zeros(first_input,
                                         dim=info["shape"][-1])
                for info in self.state_info]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll the cell over `length` steps (rnn_cell.py:295)."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self._begin_state_like(inputs[0])
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    assert inputs is not None
    axis = layout.find("T")
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, symbol.Symbol):
        if merge is False:
            assert len(inputs.list_outputs()) == 1, \
                "unroll doesn't allow grouped symbol as input. Please " \
                "convert to list with list(inputs) first or let unroll " \
                "handle splitting."
            inputs = list(symbol.SliceChannel(inputs, axis=in_axis,
                                              num_outputs=length,
                                              squeeze_axis=1))
    else:
        assert length is None or len(inputs) == length
        if merge is True:
            inputs = [i.expand_dims(axis=axis) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=axis)
    return inputs, axis


class RNNCell(BaseRNNCell):
    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=self._num_hidden,
                                    name=f"{name}h2h")
        output = self._get_activation(i2h + h2h, self._activation,
                                      name=f"{name}out")
        return output, [output]


class LSTMCell(BaseRNNCell):
    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        from ..initializer import LSTMBias
        self._iB = self.params.get("i2h_bias",
                                   init=LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name=f"{name}h2h")
        gates = i2h + h2h
        slice_gates = symbol.SliceChannel(gates, num_outputs=4, axis=-1,
                                          name=f"{name}slice")
        in_gate = symbol.Activation(slice_gates[0], act_type="sigmoid")
        forget_gate = symbol.Activation(slice_gates[1], act_type="sigmoid")
        in_transform = symbol.Activation(slice_gates[2], act_type="tanh")
        out_gate = symbol.Activation(slice_gates[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_r", "_z", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = f"{self._prefix}t{self._counter}_"
        prev_state_h = states[0]
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(prev_state_h, self._hW, self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name=f"{name}h2h")
        i2h_s = symbol.SliceChannel(i2h, num_outputs=3, axis=-1)
        h2h_s = symbol.SliceChannel(h2h, num_outputs=3, axis=-1)
        reset_gate = symbol.Activation(i2h_s[0] + h2h_s[0],
                                       act_type="sigmoid")
        update_gate = symbol.Activation(i2h_s[1] + h2h_s[1],
                                        act_type="sigmoid")
        next_h_tmp = symbol.Activation(i2h_s[2] + reset_gate * h2h_s[2],
                                       act_type="tanh")
        next_h = (1. - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Whole-sequence fused cell over the ``RNN`` op (the reference's
    rnn_cell.py:536, its cuDNN path)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0., get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = f"{mode}_"
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = 2 if bidirectional else 1
        self._parameter = self.params.get("parameters")

    @property
    def state_info(self):
        b = self._num_layers * self._directions
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": (b, 0, self._num_hidden), "__layout__": "LNC"}
                for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:  # NTC -> TNC for the op
            inputs = symbol.SwapAxis(inputs, dim1=0, dim2=1)
        if begin_state is None:
            n_state = 2 if self._mode == "lstm" else 1
            begin_state = [symbol._rnn_state_zeros(
                inputs, num=self._num_layers * self._directions,
                dim=self._num_hidden) for _ in range(n_state)]
        states = begin_state
        outs = symbol.RNN(inputs, self._parameter, *states,
                          state_size=self._num_hidden,
                          num_layers=self._num_layers,
                          bidirectional=self._bidirectional,
                          p=self._dropout, state_outputs=True,
                          mode=self._mode, name=f"{self._prefix}rnn")
        outputs = outs[0]
        if axis == 1:
            outputs = symbol.SwapAxis(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = list(symbol.SliceChannel(
                outputs, axis=axis, num_outputs=length, squeeze_axis=1))
        if self._get_next_state:
            states = [outs[i] for i in range(
                1, 3 if self._mode == "lstm" else 2)]
        else:
            states = []
        return outputs, states

    def unfuse(self):
        """Equivalent stack of unfused cells (rnn_cell.py unfuse)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden,
                                          activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                          activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell(f"{self._prefix}l{i}_"),
                    get_cell(f"{self._prefix}r{i}_"),
                    output_prefix=f"{self._prefix}bi_l{i}_"))
            else:
                stack.add(get_cell(f"{self._prefix}l{i}_"))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix=f"{self._prefix}_dropout{i}_"))
        return stack


class SequentialRNNCell(BaseRNNCell):
    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, \
                "Either specify params for SequentialRNNCell or child " \
                "cells, not both."
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n] if begin_state is not None \
                else None
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class BidirectionalCell(BaseRNNCell):
    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._cells = [l_cell, r_cell]
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        l_cell, r_cell = self._cells
        if begin_state is None:
            l_begin, r_begin = None, None
        else:
            l_begin = begin_state[:len(l_cell.state_info)]
            r_begin = begin_state[len(l_cell.state_info):]
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=l_begin, layout=layout,
            merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)), begin_state=r_begin,
            layout=layout, merge_outputs=False)
        outputs = [symbol.Concat(l_o, r_o, dim=1,
                                 name=f"{self._output_prefix}t{i}")
                   for i, (l_o, r_o) in enumerate(
                       zip(l_outputs, reversed(r_outputs)))]
        if merge_outputs:
            outputs, _ = _normalize_sequence(length, outputs, layout,
                                             merge_outputs)
        states = l_states + r_states
        return outputs, states


class ModifierCell(BaseRNNCell):
    def __init__(self, base_cell):
        base_cell._modified = True
        super().__init__()
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class DropoutCell(BaseRNNCell):
    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        assert isinstance(dropout, (int, float))
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(inputs, p=self.dropout)
        return inputs, states


class ZoneoutCell(ModifierCell):
    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell doesn't support zoneout. Please unfuse first."
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout since it doesn't " \
            "support step. Please add ZoneoutCell to the cells underneath " \
            "instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return symbol.Dropout(symbol.ones_like(like), p=p)
        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(next_output)
        output = (symbol.where(mask(p_outputs, next_output), next_output,
                               prev_output)
                  if p_outputs != 0. else next_output)
        states = ([symbol.where(mask(p_states, new_s), new_s, old_s)
                   for new_s, old_s in zip(next_states, states)]
                  if p_states != 0. else next_states)
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    def __init__(self, base_cell):
        super().__init__(base_cell)

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol.elemwise_add(output, inputs)
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)
        self.base_cell._modified = True
        merge_outputs = isinstance(outputs, symbol.Symbol) \
            if merge_outputs is None else merge_outputs
        inputs, _ = _normalize_sequence(length, inputs, layout,
                                        merge_outputs)
        if merge_outputs:
            outputs = symbol.elemwise_add(outputs, inputs)
        else:
            outputs = [symbol.elemwise_add(out, inp)
                       for out, inp in zip(outputs, inputs)]
        return outputs, states
