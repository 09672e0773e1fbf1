"""FLOPs and bytes of a Symbol's training step from its inferred shapes:
the port's counterpart of XLA's cost analysis (``compiled.cost_analysis()``,
which the JAX package's ``telemetry.devstats.extract`` reads).

A CUDA graph carries no cost analysis and PyTorch has none for eager
kernels, so the counts come from one rule per registry op name, evaluated
on the shapes shape inference gives every value:

* products are counted exactly: ``FullyConnected`` 2·M·N·K,
  ``Convolution`` 2·N·Co·(Ci/g)·KH·KW·OH·OW, ``Deconvolution`` the same
  product as the convolution it transposes (2·N·Ci·(Co/g)·KH·KW·IH·IW),
  ``dot`` / ``batch_dot`` 2·(output elements)·K, and
  ``_contrib_flash_attention`` 4·B·H·D a (query, key) pair forward, 6 for
  dQ and 8 for dK/dV in the backward (the causal half by pairs), as the
  flash kernels count them;
* elementwise ops, reductions, normalizations and softmax count a few
  FLOPs an element (``_PER_ELEM``: forward, backward);
* data movement (reshapes, slices, gathers) counts none;
* an op without a rule counts its output elements, forward and backward,
  and is listed (``GraphCosts.unruled``) so that a test can pin the list.

A training step is the forward, the backward (each op's own backward
rule: twice the forward for products) and the fused optimizer update
(``UPDATE_FLOPS`` an element, the ``parallel.dp._OPT_OPS`` op's). Bytes
are each op's inputs read and outputs written (the backward: its inputs
and its output's cotangent read, its inputs' cotangents written), and the
update's parameters, gradients and states.

Counts are per replica under a plan: the shapes are a replica's local
shapes from ``executor._tp_layout`` (the batch split over the data axis,
tensor-parallel values split over the model axis), so the same pass that
runs the tensor-parallel walk prices it, and its collectives' bytes are
the wire the step moves. The source launches nothing and allocates no
tensor: shape inference runs ops on torch's ``meta`` device.
"""
from __future__ import annotations

import math

__all__ = ["GraphCosts", "graph_costs", "update_costs", "step_costs",
           "UPDATE_FLOPS"]

# fused update ops: FLOPs an element (rescale, weight decay and the
# clip where the op has them, then the op's own arithmetic)
UPDATE_FLOPS = {
    "sgd_update": 4, "sgd_mom_update": 6, "adam_update": 14,
    "rmsprop_update": 10, "rmspropalex_update": 15, "ftrl_update": 15,
    "signsgd_update": 4, "signum_update": 7, "ftml_update": 18,
}

_REDUCE = {"sum", "mean", "max", "min", "prod", "nansum", "nanprod",
           "_square_sum", "norm", "argmax", "argmin", "argmax_channel",
           "sum_axis", "max_axis", "min_axis"}
_SOFTMAX = {"softmax", "log_softmax", "softmin", "SoftmaxOutput",
            "SoftmaxActivation", "Softmax"}
_NORM = {"BatchNorm", "LayerNorm", "InstanceNorm", "GroupNorm",
         "L2Normalization", "LRN"}
_MOVE = {"Reshape", "reshape", "Flatten", "flatten", "transpose",
         "SwapAxis", "swapaxes", "expand_dims", "squeeze", "slice",
         "slice_axis", "slice_like", "crop", "Concat", "concat", "stack",
         "split", "SliceChannel", "broadcast_to", "broadcast_like",
         "broadcast_axis", "broadcast_axes", "take", "pick", "Embedding",
         "one_hot", "tile", "repeat", "Pad", "pad", "_copy", "BlockGrad",
         "stop_gradient", "identity", "zeros_like", "ones_like", "Cast",
         "cast", "reverse", "flip", "gather_nd", "shape_array",
         "size_array", "MakeLoss", "make_loss", "_zeros", "_ones",
         "_full", "_arange", "arange", "zeros", "ones", "full"}
# forward, backward FLOPs an (output) element
_PER_ELEM = {"Activation": (1, 2), "LeakyReLU": (2, 3), "Dropout": (1, 1),
             "cumsum": (1, 1), "clip": (2, 2), "where": (1, 2),
             "LinearRegressionOutput": (1, 1),
             "LogisticRegressionOutput": (4, 1),
             "MAERegressionOutput": (1, 1), "SVMOutput": (3, 2),
             "smooth_l1": (3, 2), "add_n": (1, 1), "erf": (8, 6),
             "gamma": (8, 8), "gammaln": (8, 8), "erfinv": (8, 6)}


def _n(shape):
    return math.prod(shape) if shape else 1


class GraphCosts:
    """One graph's counts for a replica: forward / backward FLOPs and
    bytes, the activation bytes the backward keeps, the tensor-parallel
    walk's collective bytes a device, the op names without a rule, and
    per node (name, op, forward FLOPs, backward FLOPs)."""

    def __init__(self):
        self.fwd_flops = self.bwd_flops = 0.0
        self.fwd_bytes = self.bwd_bytes = 0.0
        self.act_bytes = 0.0
        self.wire_bytes = 0.0
        self.unruled = []
        self.nodes = []


def _flash_pairs(q, k, causal):
    s, sk = q[-2], k[-2]
    return s * (s + 1) // 2 if causal and s == sk else s * sk


def _op_flops(op, attrs, ins, outs):
    """(forward, backward) FLOPs of one op on these shapes, or None for
    an op without a rule."""
    name = op.name
    out = outs[0] if outs else None
    if name == "FullyConnected":
        w = ins[1]
        m = _n(out[:-1])
        f = 2.0 * m * w[0] * w[1]
        b = m * w[0] if not attrs["no_bias"] else 0
        return f + b, 2 * f + b
    if name == "Convolution":
        w = ins[1]
        f = 2.0 * out[0] * w[0] * _n(w[1:]) * _n(out[2:])
        b = _n(out) if not attrs["no_bias"] else 0
        return f + b, 2 * f + b
    if name == "Deconvolution":
        x, w = ins[0], ins[1]
        f = 2.0 * x[0] * w[0] * _n(w[1:]) * _n(x[2:])
        b = _n(out) if not attrs.get("no_bias", True) else 0
        return f + b, 2 * f + b
    if name == "dot":
        a = ins[0]
        k = a[0] if attrs.get("transpose_a") else a[-1]
        f = 2.0 * _n(out) * k
        return f, 2 * f
    if name == "batch_dot":
        a = ins[0]
        k = a[-2] if attrs.get("transpose_a") else a[-1]
        f = 2.0 * _n(out) * k
        return f, 2 * f
    if name == "_contrib_flash_attention":
        q, k = ins[0], ins[1]
        bhd = _n(q[:-2]) * q[-1]
        pairs = _flash_pairs(q, k, attrs["causal"])
        return 4.0 * bhd * pairs, 14.0 * bhd * pairs
    if name == "Pooling":
        if attrs.get("global_pool"):
            win = _n(ins[0][2:])
        else:
            win = _n(attrs.get("kernel") or (1,))
        return float(_n(out) * win), float(_n(out) * win)
    if name in _MOVE:
        return 0.0, 0.0
    if name in _REDUCE:
        return float(_n(ins[0])), float(_n(ins[0]))
    if name in _SOFTMAX:
        return 5.0 * _n(out), 4.0 * _n(out)
    if name in _NORM:
        return 5.0 * _n(out), 9.0 * _n(out)
    if name in _PER_ELEM:
        f, b = _PER_ELEM[name]
        return float(f * _n(out)), float(b * _n(out))
    from ..ops.tensor import ELEMENTWISE
    if name in ELEMENTWISE:
        return float(_n(out)), 2.0 * _n(out)
    return None


def graph_costs(symbol, shape_kwargs, sharded=(), diff=(), specs=None,
                d=1, t=1, itemsize=4, is_train=True):
    """Per-replica costs of one forward (and, with ``is_train``, its
    backward) of ``symbol`` at ``shape_kwargs`` (global shapes) on a
    d x t (data x model) replica grid: ``sharded`` inputs split over the
    data axis, ``specs`` (param name -> spec) over the model axis,
    ``diff`` the differentiated arguments. Values in the compute type's
    ``itemsize``. Returns a :class:`GraphCosts`."""
    from ..executor import _Plan, _node_shapes, _tp_layout
    plan = _Plan(symbol, is_train=is_train)
    shapes = _node_shapes(plan, {k: tuple(v)
                                 for k, v in shape_kwargs.items()})
    lay = _tp_layout(plan, shapes, specs, frozenset(sharded),
                     frozenset(diff), d, t, itemsize)
    gc = GraphCosts()
    for p, op, parsed, ins, n_out, aux_writes, name in plan.steps:
        if op is None:
            continue
        xs = [lay.local[(q, i)] for q, i in ins]
        os_ = [lay.local[(p, i)] for i in range(n_out)]
        if any(s is None for s in xs + os_):
            gc.unruled.append(op.name)
            continue
        st = lay.steps[p]
        if st.mode == "row" or (xs and st.acts[0] == "feat"):
            # the op sees its features cut (the weight's local shape)
            xs = list(xs)
            xs[0] = tuple(os_[0][:-1]) + (xs[1][1],)
        fb = _op_flops(op, parsed, xs, os_)
        if fb is None:
            gc.unruled.append(op.name)
            fb = (float(sum(_n(o) for o in os_)),) * 2
        in_b = itemsize * sum(_n(x) for x in xs)
        out_b = itemsize * sum(_n(o) for o in os_)
        gc.fwd_flops += fb[0]
        gc.fwd_bytes += in_b + out_b
        gc.nodes.append((name, op.name, fb[0], fb[1] if is_train else 0.0))
        if is_train and p in lay.grad:
            gc.bwd_flops += fb[1]
            gc.bwd_bytes += 2 * in_b + out_b
            gc.act_bytes += out_b
    gc.wire_bytes = lay.wire_bytes if is_train else sum(
        s.fwd_wire for s in lay.steps.values()) + lay.out_wire / 2
    return gc


def update_costs(opname, elems):
    """(FLOPs, bytes) of the fused update op ``opname`` over ``elems``
    float32 parameter elements (parameters, gradients and states read,
    parameters and states written)."""
    from ..ops.registry import get_op
    n_states = len(get_op(opname).input_names) - 2
    return (float(UPDATE_FLOPS.get(opname, 4) * elems),
            float(4 * (3 + 2 * n_states) * elems))


def step_costs(symbol, shape_kwargs, data_names, label_names, opname,
               axes=None, zero_stage=0, specs=None, itemsize=4,
               bucket_bytes=None, wire_itemsize=None):
    """A replica's costs of one training step under a plan: ``axes``
    ({"data": D[, "model": T]}, default one replica), ``zero_stage``
    (masters, states and the update split over all D·T replicas) and
    ``specs`` (tensor-parallel param specs, stage 0 only). Returns a dict:
    ``flops``, ``bytes`` (forward + backward + update), ``wire_bytes``
    (the walk's collectives + the gradient reduce, or ZeRO's gather and
    reduce), ``act_bytes``, ``param_bytes`` / ``state_bytes`` a replica
    holds, ``unruled`` and the parts."""
    from ..ops.registry import get_op
    axes = dict(axes or {"data": 1})
    d = int(axes.get("data", 1))
    t = int(axes.get("model", 1))
    n = d * t
    inputs = set(data_names) | set(label_names)
    arg_names = symbol.list_arguments()
    arg_shapes, _, _ = symbol.infer_shape(**shape_kwargs)
    shapes = dict(zip(arg_names, arg_shapes))
    params = [a for a in arg_names if a not in inputs]
    sharded = [a for a in arg_names if a in inputs]
    gc = graph_costs(symbol, shape_kwargs, sharded=sharded, diff=params,
                     specs=None if zero_stage else specs, d=d,
                     t=1 if zero_stage else t, itemsize=itemsize)
    from ..executor import _spec_dim
    n_states = len(get_op(opname).input_names) - 2
    elems = split = 0
    for a in params:
        e = _n(shapes[a])
        elems += e
        if not zero_stage and specs and t > 1 and _spec_dim(
                specs.get(a), len(shapes[a]), a) is not None:
            split += e
    if zero_stage:
        from ..parallel.zero import ZeroLayout, _resolve_bucket_bytes
        bb = bucket_bytes if bucket_bytes is not None \
            else _resolve_bucket_bytes()
        lay = ZeroLayout([shapes[a] for a in params], n, bb)
        local = sum(lay.padded) / n
        wire = lay.wire_bytes_per_step(zero_stage, itemsize,
                                       wire_itemsize or itemsize)
    else:
        local = (elems - split) + split / t
        # the gradients' all-reduce: replicated parameters over the whole
        # mesh, split ones over their data group
        wire = gc.wire_bytes
        if n > 1:
            wire += 2 * (n - 1) / n * (elems - split) * itemsize
        if d > 1 and split:
            wire += 2 * (d - 1) / d * (split / t) * itemsize
    uf, ub = update_costs(opname, local)
    return {"flops": gc.fwd_flops + gc.bwd_flops + uf,
            "bytes": gc.fwd_bytes + gc.bwd_bytes + ub,
            "wire_bytes": float(wire), "act_bytes": gc.act_bytes,
            "fwd_flops": gc.fwd_flops, "bwd_flops": gc.bwd_flops,
            "update_flops": uf, "param_bytes": 4.0 * local,
            "state_bytes": 4.0 * local * n_states,
            "unruled": sorted(set(gc.unruled))}
