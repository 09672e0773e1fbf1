"""Gluon's recurrent cells (counterpart of mxnet_tpu/gluon/rnn/rnn_cell.py;
the reference's python/mxnet/gluon/rnn/rnn_cell.py): the
``RecurrentCell`` protocol (``state_info``, ``begin_state``, ``unroll``
with its layout and merge handling), the RNN, LSTM and GRU cells (the
reference's parameter names i2h/h2h and gate orders), and the
Sequential, Dropout, Zoneout, Residual and Bidirectional compositions.
A cell steps through ``hybrid_forward(F, ...)``: eagerly over ``mx.nd``,
or traced into a Symbol and run through the executor once hybridized.
"""
from __future__ import annotations

from ... import symbol as symmod
from ... import ndarray as ndmod
from ..block import Block, HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _get_begin_state(cell, F, begin_state, inputs, batch_size):
    if begin_state is None:
        if F is ndmod or (hasattr(F, "__name__") and "ndarray" in
                          getattr(F, "__name__", "")):
            ctx = inputs.context if hasattr(inputs, "context") else \
                inputs[0].context
            with ctx:
                begin_state = cell.begin_state(func=ndmod.zeros,
                                               batch_size=batch_size,
                                               ctx=ctx)
        else:
            begin_state = cell.begin_state(func=symmod.zeros,
                                           batch_size=batch_size)
    return begin_state


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    assert inputs is not None, \
        "unroll(inputs=None) is only supported for HybridBlock trace"
    axis = layout.find("T")
    batch_axis = layout.find("N")
    batch_size = 0
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, symmod.Symbol):
        F = symmod
        if merge is False:
            inputs = list(symmod.SliceChannel(
                inputs, axis=in_axis, num_outputs=length, squeeze_axis=1))
    elif hasattr(inputs, "shape"):  # NDArray
        F = ndmod
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            if length is None:
                length = inputs.shape[in_axis]
            inputs = list(ndmod.SliceChannel(inputs, axis=in_axis,
                                             num_outputs=length,
                                             squeeze_axis=1))
    else:
        assert length is None or len(inputs) == length
        if isinstance(inputs[0], symmod.Symbol):
            F = symmod
        else:
            F = ndmod
            batch_size = inputs[0].shape[batch_axis]
        if merge is True:
            inputs = [i.expand_dims(axis=axis) for i in inputs]
            inputs = F.Concat(*inputs, dim=axis)
    if isinstance(inputs, list):
        length = len(inputs)
    return inputs, axis, F, batch_size


class RecurrentCell(Block):
    """Abstract cell: a step, and ``unroll`` over time (the reference's
    BaseRNNCell model; one call unrolls a fixed length)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=None, **kwargs):
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called " \
            "directly. Call the modifier cell instead."
        if func is None:
            func = ndmod.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            state = func(name=f"{self._prefix}begin_state_"
                         f"{self._init_counter}", **info)
            states.append(state)
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, F, batch_size = _format_sequence(length, inputs,
                                                       layout, False)
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        states = begin_state
        outputs = []
        all_states = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [F.SequenceLast(F.stack(*ele_list, axis=0),
                                     sequence_length=valid_length,
                                     use_sequence_length=True, axis=0)
                      for ele_list in zip(*all_states)]
            outputs = [F.stack(*outputs, axis=axis)]
            outputs = F.SequenceMask(outputs[0], sequence_length=valid_length,
                                     use_sequence_length=True, axis=axis)
            return outputs, states
        if merge_outputs:
            outputs = [o.expand_dims(axis=axis) for o in outputs]
            outputs = F.Concat(*outputs, dim=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, inputs, states):
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class RNNCell(HybridRecurrentCell):
    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(hidden_size,), init=i2h_bias_initializer,
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(hidden_size,), init=h2h_bias_initializer,
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size)
        gates = i2h + h2h
        slices = F.SliceChannel(gates, num_outputs=4, axis=-1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = F.tanh(slices[2])
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(3 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(3 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(3 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(3 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size)
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size)
        i2h_slices = F.SliceChannel(i2h, num_outputs=3, axis=-1)
        h2h_slices = F.SliceChannel(h2h, num_outputs=3, axis=-1)
        reset_gate = F.sigmoid(i2h_slices[0] + h2h_slices[0])
        update_gate = F.sigmoid(i2h_slices[1] + h2h_slices[1])
        next_h_tmp = F.tanh(i2h_slices[2] + reset_gate * h2h_slices[2])
        next_h = (1. - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack of cells applied in sequence each step."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        assert all(not isinstance(cell, BidirectionalCell)
                   for cell in self._children.values())
        for cell in self._children.values():
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, _, F, batch_size = _format_sequence(length, inputs, layout,
                                                    None)
        num_cells = len(self._children)
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        p = 0
        next_states = []
        for i, cell in enumerate(self._children.values()):
            n = len(cell.state_info())
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs,
                valid_length=valid_length)
            next_states.extend(states)
        return inputs, next_states

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)

    def forward(self, *args):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, (int, float)), "rate must be a number"
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

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, _, F, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if isinstance(inputs, (ndmod.NDArray, symmod.Symbol)):
            return self.hybrid_forward(F, inputs, begin_state or [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs,
                              valid_length=valid_length)


class ModifierCell(HybridRecurrentCell):
    """Base for cells that modify another cell's behavior."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified. One cell cannot be modified " \
            "twice" % base_cell.name
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
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func or ndmod.zeros,
                                           **kwargs)
        self.base_cell._modified = True
        return begin

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. " \
            "Please add ZoneoutCell to the cells underneath instead."
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
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)
        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = F.where(mask(p_outputs, next_output), next_output,
                         prev_output) if p_outputs != 0. else next_output
        new_states = ([F.where(mask(p_states, new_s), new_s, old_s)
                       for new_s, old_s in zip(next_states, states)]
                      if p_states != 0. else next_states)
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    def __init__(self, base_cell):
        super().__init__(base_cell)

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)
        self.base_cell._modified = True
        merge_outputs = isinstance(outputs, (ndmod.NDArray, symmod.Symbol)) \
            if merge_outputs is None else merge_outputs
        inputs, axis, F, _ = _format_sequence(length, inputs, layout,
                                              merge_outputs)
        if merge_outputs:
            outputs = outputs + inputs
        else:
            outputs = [out + inp for out, inp in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
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
        assert not self._modified
        return _cells_begin_state(self._children.values(), **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, F, batch_size = _format_sequence(length, inputs,
                                                       layout, False)
        reversed_inputs = list(reversed(inputs))
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        states = begin_state
        l_cell, r_cell = self._children.values()
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info(batch_size))],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=reversed_inputs,
            begin_state=states[len(l_cell.state_info(batch_size)):],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        reversed_r_outputs = list(reversed(r_outputs))
        outputs = [F.Concat(l_o, r_o, dim=1, name=f"{self._output_prefix}t{i}_")
                   for i, (l_o, r_o) in enumerate(zip(l_outputs,
                                                      reversed_r_outputs))]
        if merge_outputs:
            outputs = [o.expand_dims(axis=axis) for o in outputs]
            outputs = F.Concat(*outputs, dim=axis)
        states = l_states + r_states
        return outputs, states

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError
