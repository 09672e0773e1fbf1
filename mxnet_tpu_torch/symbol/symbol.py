"""Symbol — the declarative graph (counterpart of
mxnet_tpu/symbol/symbol.py).

A Symbol is a list of output entries (node, out_index) over a DAG of
_Node objects. ``bind`` / ``simple_bind`` hand it to the executor, which
walks it in topological order on every call. Missing op inputs
auto-create variables named ``{opname}_{input}`` as the reference's
symbol composition does, so ``simple_bind`` finds ``fc1_weight`` etc.
The JSON it writes and reads is the JAX package's (and the reference's,
through ``_upgrade_legacy_json``): a file either package writes loads in
the other.
"""
from __future__ import annotations

import json

from ..base import MXNetError, AttrScope, attr_to_string
from ..ops.registry import get_op

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json"]


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "user_attrs")

    def __init__(self, op, name, attrs, inputs, user_attrs=None):
        self.op = op            # OpSchema or None for variables
        self.name = name
        self.attrs = attrs      # raw kwargs (parsed lazily per use)
        self.inputs = inputs    # list of (node, out_idx)
        self.user_attrs = user_attrs or {}

    def num_outputs(self):
        if self.op is None:
            return 1
        parsed = self.op.parse_attrs(self.attrs)
        n = self.op.num_outputs
        return n(parsed) if callable(n) else n


class Symbol:
    def __init__(self, outputs):
        self._outputs = list(outputs)  # [(node, idx)]

    # -- introspection ------------------------------------------------------
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def _topo(self):
        order, seen = [], set()

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for (n2, _) in node.inputs:
                visit(n2)
            order.append(node)

        for (n, _) in self._outputs:
            visit(n)
        return order

    def _input_vars(self):
        """All variable nodes in topo order, split into (args, aux)."""
        args, aux = [], []
        seen = set()
        for node in self._topo():
            if node.op is not None:
                parsed = node.op.parse_attrs(node.attrs)
                aux_set = set(node.op.aux_indices)
                for i, (n2, _) in enumerate(node.inputs):
                    if n2.op is None and id(n2) not in seen and i in aux_set:
                        seen.add(id(n2))
                        aux.append(n2)
        for node in self._topo():
            if node.op is None and id(node) not in seen:
                seen.add(id(node))
                args.append(node)
        return args, aux

    def list_arguments(self):
        args, _ = self._input_vars()
        return [n.name for n in args]

    def list_auxiliary_states(self):
        _, aux = self._input_vars()
        return [n.name for n in aux]

    def list_outputs(self):
        names = []
        for (node, idx) in self._outputs:
            if node.op is None:
                names.append(node.name)
            elif node.num_outputs() == 1:
                names.append(f"{node.name}_output")
            else:
                names.append(f"{node.name}_output{idx}")
        return names

    def list_inputs(self):
        return self.list_arguments() + self.list_auxiliary_states()

    @property
    def num_outputs(self):
        return len(self._outputs)

    def __len__(self):
        return len(self._outputs)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError(f"no output named {index!r}")
            index = names.index(index)
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        return Symbol([self._outputs[index]])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def get_internals(self):
        outs = []
        for node in self._topo():
            for i in range(node.num_outputs()):
                outs.append((node, i))
        return Symbol(outs)

    def get_children(self):
        kids = []
        for (node, _) in self._outputs:
            kids.extend(node.inputs)
        return Symbol(kids) if kids else None

    def attr(self, key):
        node = self._outputs[0][0]
        return node.user_attrs.get(key)

    def attr_dict(self):
        out = {}
        for node in self._topo():
            if node.user_attrs:
                out[node.name] = dict(node.user_attrs)
        return out

    def _set_attr(self, **kwargs):
        self._outputs[0][0].user_attrs.update(
            {k: str(v) for k, v in kwargs.items()})

    def __repr__(self):
        name = self.name
        return f"<Symbol {name if name else 'Grouped'}>"

    # -- composition --------------------------------------------------------
    def __call__(self, *args, **kwargs):
        s = self.__copy__()
        s._compose(*args, **kwargs)
        return s

    def _compose(self, *args, **kwargs):
        """Replace variable placeholders with provided symbols by name."""
        name_map = {}
        if args:
            arg_names = self.list_arguments()
            for n, a in zip(arg_names, args):
                name_map[n] = a
        name_map.update(kwargs)
        mapping = {}
        for node in self._topo():
            if node.op is None and node.name in name_map:
                repl = name_map[node.name]
                mapping[id(node)] = repl._outputs[0]

        def rewrite(node, memo):
            if id(node) in memo:
                return memo[id(node)]
            if id(node) in mapping:
                memo[id(node)] = mapping[id(node)][0]
                return mapping[id(node)][0]
            new_inputs = [(rewrite(n2, memo), i2) for (n2, i2) in node.inputs]
            node.inputs = new_inputs
            memo[id(node)] = node
            return node

        memo = {}
        self._outputs = [(rewrite(n, memo), i) for (n, i) in self._outputs]

    def __copy__(self):
        # nodes are shared; Symbol copy is a new output list (reference
        # symbols are immutable handles, compose copies)
        return Symbol(list(self._outputs))

    def __deepcopy__(self, memo):
        return self.__copy__()

    # -- arithmetic sugar ---------------------------------------------------
    def _binop(self, other, op, scalar_op, reverse=False):
        from . import _create_symbol
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _create_symbol(op, [a, b], {})
        if isinstance(other, (int, float, bool)):
            if reverse:
                rmap = {"_plus_scalar": "_plus_scalar",
                        "_minus_scalar": "_rminus_scalar",
                        "_mul_scalar": "_mul_scalar",
                        "_div_scalar": "_rdiv_scalar",
                        "_power_scalar": "_rpower_scalar",
                        "_mod_scalar": "_rmod_scalar"}
                scalar_op = rmap.get(scalar_op, scalar_op)
            return _create_symbol(scalar_op, [self], {"scalar": float(other)})
        return NotImplemented

    def __add__(self, o):
        return self._binop(o, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binop(o, "elemwise_sub", "_minus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binop(o, "elemwise_div", "_div_scalar", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar",
                           reverse=True)

    def __neg__(self):
        return self._binop(-1.0, None, "_mul_scalar")

    # ordering comparisons (eq/ne intentionally left to identity semantics —
    # Symbols must stay hashable dict keys, matching the reference)
    def __gt__(self, o):
        return self._binop(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    def __getattr__(self, name):
        # symbol method sugar: sym.reshape(...), sym.sum(...) etc
        if name.startswith("_"):
            raise AttributeError(name)
        from . import _SYM_FUNCS
        fn = _SYM_FUNCS.get(name)
        if fn is None:
            raise AttributeError(name)
        def method(*args, **kwargs):
            return fn(self, *args, **kwargs)
        return method

    # -- inference ----------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        known = {}
        if args:
            for n, s in zip(self.list_arguments(), args):
                if s is not None:
                    known[n] = tuple(s)
        known.update({k: tuple(v) for k, v in kwargs.items() if v is not None})

        shapes = {}  # id(node) -> list of out shapes (or None)
        var_shape = {}  # id(var node) -> shape

        topo = self._topo()
        for _ in range(3):  # fixed-point: weight fills can cascade
            changed = False
            for node in topo:
                if node.op is None:
                    s = var_shape.get(id(node)) or known.get(node.name)
                    if s is not None and shapes.get(id(node)) != [tuple(s)]:
                        shapes[id(node)] = [tuple(s)]
                        var_shape[id(node)] = tuple(s)
                        changed = True
                    elif id(node) not in shapes:
                        shapes[id(node)] = [None]
                    continue
                in_shapes = []
                for (n2, i2) in node.inputs:
                    s2 = shapes.get(id(n2))
                    in_shapes.append(s2[i2] if s2 and i2 < len(s2) else None)
                parsed = node.op.parse_attrs(node.attrs)
                out = None
                if node.op.infer_shape is not None:
                    filled, out = node.op.infer_shape(parsed, list(in_shapes))
                    for (n2, i2), fs in zip(node.inputs, filled):
                        if fs is not None and n2.op is None and \
                                var_shape.get(id(n2)) is None:
                            var_shape[id(n2)] = tuple(fs)
                            changed = True
                    in_shapes = filled
                if (out is None or any(o is None for o in out)) and \
                        all(s is not None for s in in_shapes):
                    out = _eval_shape(node, parsed, in_shapes)
                if out is not None and shapes.get(id(node)) != out:
                    shapes[id(node)] = out
                    changed = True
                elif id(node) not in shapes:
                    shapes[id(node)] = [None] * node.num_outputs()
            if not changed:
                break

        args_n, aux_n = self._input_vars()
        arg_shapes = [var_shape.get(id(n)) for n in args_n]
        aux_shapes = [var_shape.get(id(n)) for n in aux_n]
        out_shapes = []
        for (node, idx) in self._outputs:
            s = shapes.get(id(node))
            out_shapes.append(s[idx] if s and idx < len(s) else None)
        if not partial and any(s is None for s in arg_shapes + out_shapes):
            missing = [n.name for n, s in zip(args_n, arg_shapes) if s is None]
            raise MXNetError(
                f"infer_shape: incomplete — cannot infer {missing}; "
                f"provide more input shapes")
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        import numpy as _np
        known = {}
        if args:
            for n, t in zip(self.list_arguments(), args):
                if t is not None:
                    known[n] = _np.dtype(t)
        known.update({k: _np.dtype(v) for k, v in kwargs.items()
                      if v is not None})
        default = _np.dtype("float32")
        args_n, aux_n = self._input_vars()
        arg_types = [known.get(n.name, default) for n in args_n]
        aux_types = [known.get(n.name, default) for n in aux_n]
        out_types = [default for _ in self._outputs]
        return arg_types, out_types, aux_types

    # -- serialization ------------------------------------------------------
    def tojson(self):
        topo = self._topo()
        nid = {id(n): i for i, n in enumerate(topo)}
        nodes = []
        for n in topo:
            entry = {
                "op": "null" if n.op is None else n.op.name,
                "name": n.name,
                "inputs": [[nid[id(n2)], i2, 0] for (n2, i2) in n.inputs],
            }
            attrs = {k: attr_to_string(v) for k, v in n.attrs.items()
                     if v is not None}
            attrs.update(n.user_attrs)
            if attrs:
                entry["attrs"] = attrs
            nodes.append(entry)
        return json.dumps({
            "nodes": nodes,
            "arg_nodes": [i for i, n in enumerate(topo) if n.op is None],
            "heads": [[nid[id(n)], i, 0] for (n, i) in self._outputs],
            "attrs": {"mxnet_tpu_version": "0.1.0"},
        }, indent=2)

    def save(self, fname):
        from ..base import atomic_write
        atomic_write(fname, self.tojson())

    # -- binding ------------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, mesh=None,
                    sharded_args=(), **kwargs):
        """Bind to arrays allocated from the inferred shapes on ``ctx``
        (default: the current context, the card)."""
        from ..executor import Executor
        return Executor._simple_bind(self, ctx, grad_req, type_dict, kwargs,
                                     mesh=mesh, sharded_args=sharded_args,
                                     group2ctx=group2ctx)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from ..executor import Executor
        return Executor._bind(self, ctx, args, args_grad, grad_req, aux_states,
                              group2ctx=group2ctx)

    def eval(self, ctx=None, **kwargs):
        ex = self.bind(ctx, kwargs)
        return ex.forward()

    def grad(self, wrt):
        raise MXNetError("Symbol.grad: use simple_bind + backward (the "
                         "reference's symbolic-grad helper is deprecated)")

    # -- misc parity helpers -------------------------------------------------
    def debug_str(self):
        lines = []
        for n in self._topo():
            op = "Variable" if n.op is None else n.op.name
            ins = ", ".join(f"{n2.name}[{i2}]" for (n2, i2) in n.inputs)
            lines.append(f"{op:>20s}  {n.name}({ins})")
        return "\n".join(lines)


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    if not isinstance(name, str):
        raise TypeError("Variable name must be a string")
    user_attrs = AttrScope.current().get(attr)
    if shape is not None:
        user_attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        user_attrs["__dtype__"] = str(dtype)
    if lr_mult is not None:
        user_attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        user_attrs["__wd_mult__"] = str(wd_mult)
    if init is not None:
        user_attrs["__init__"] = init if isinstance(init, str) else \
            init.dumps()
    node = _Node(None, name, {}, [], user_attrs)
    return Symbol([(node, 0)])


var = Variable


def Group(symbols):
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


# hidden node attrs the reference's C API strips/renames on save+load
# (c_api_symbolic.cc:40-42 kHiddenKeys)
_HIDDEN_KEYS = ("ctx_group", "lr_mult", "wd_mult", "force_mirroring",
                "mirror_stage")
_CURRENT_REF_VERSION = 10100    # the reference fork is MXNet ~1.1.0


def _upgrade_legacy_json(data):
    """Upgrade reference-era symbol JSON in place so old model files keep
    loading (role of src/nnvm/legacy_json_util.cc:1-228 + the kHiddenKeys
    handling in c_api_symbolic.cc). Files written by THIS repo
    (mxnet_tpu_version graph attr) pass through untouched. Applied
    passes, mirroring the reference's upgrader_list (:187-193):

    - FixParsing (any reference version): raw hidden keys on op nodes
      become `__key__` user attrs; `{arg}_{key}` forms move onto the
      matching input variable (legacy_json_util.cc:49-110)
    - 0.8->0.9: aux variables were not stored — append the missing input
      variables, named `{node_name}_{arg_name}`
      (legacy_json_util.cc:134-151)
    - 0.9.4->0.9.5: argmin/argmax axis=-1 meant "flatten" — drop the
      attr to recover the default (legacy_json_util.cc:173-184)
    """
    import logging
    graph_attrs = data.get("attrs", {})
    if "mxnet_tpu_version" in graph_attrs:
        return data
    ver = graph_attrs.get("mxnet_version")
    if isinstance(ver, (list, tuple)):     # nnvm graph-attr form ["int", N]
        ver = ver[-1]
    # aux-in-json arrived in 0.9.0 (the reference assumes 0.8.0 when the
    # version attr is absent, legacy_json_util.cc:198)
    ver = int(ver) if ver is not None else 800
    if ver > _CURRENT_REF_VERSION:
        logging.info(
            "Warning: loading symbol saved by MXNet version %d with this "
            "framework's reference parity at v%d. May cause undefined "
            "behavior.", ver, _CURRENT_REF_VERSION)
    elif ver < _CURRENT_REF_VERSION:
        logging.info(
            "Loading symbol saved by previous version v%d.%d.%d. "
            "Attempting to upgrade...", ver // 10000, (ver // 100) % 100,
            ver % 100)

    nodes = data["nodes"]
    arg_nodes = set(data.get("arg_nodes", ()))

    def _attrs(entry):
        return entry.setdefault("attrs", entry.pop("param", None) or {})

    # -- FixParsing: hidden keys --------------------------------------------
    for entry in nodes:
        attrs = _attrs(entry)
        if entry["op"] == "null":
            for key in _HIDDEN_KEYS:
                if key in attrs:
                    attrs[f"__{key}__"] = attrs.pop(key)
            continue
        try:
            in_names = get_op(entry["op"]).input_names
        except MXNetError:
            in_names = []
        for k in list(attrs):
            for key in _HIDDEN_KEYS:
                if k == key:
                    attrs[f"__{key}__"] = attrs.pop(k)
                    break
                if k.endswith("_" + key):
                    arg = k[:-(len(key) + 1)]
                    if arg in in_names:
                        idx = in_names.index(arg)
                        if idx < len(entry["inputs"]):
                            tgt = nodes[entry["inputs"][idx][0]]
                            if tgt["op"] == "null":
                                _attrs(tgt)[f"__{key}__"] = attrs.pop(k)
                    if k in attrs:
                        # unrelocatable (aux input not yet materialized /
                        # non-variable input): keep the data as a HIDDEN
                        # attr — left raw it would reach parse_attrs and
                        # fail the load as an unknown op param
                        attrs[f"__{k}__"] = attrs.pop(k)
                    break

    # -- 0.8 -> 0.9: materialize missing aux-variable inputs ----------------
    if ver < 900:
        # new variables must precede their consumer (the node list is
        # topo-ordered), so rebuild the list with an index remap
        pending = {}        # consumer old-id -> [new var entries]
        n_new = 0
        for j, entry in enumerate(nodes):
            if entry["op"] == "null":
                continue
            try:
                schema = get_op(entry["op"])
            except MXNetError:
                continue
            in_names = schema.input_names
            missing = range(len(entry["inputs"]), len(in_names))
            # ONLY aux states were unstored pre-0.9; a short input list
            # from an optional input (no_bias FullyConnected) must NOT
            # grow a phantom bias variable
            if not missing or not all(i in schema.aux_indices
                                      for i in missing):
                continue
            for i in missing:
                name = f"{entry['name']}_{in_names[i]}" \
                    if entry["name"] else in_names[i]
                var = {"op": "null", "name": name, "inputs": []}
                pending.setdefault(j, []).append(var)
                n_new += 1
                entry["inputs"].append([("new", id(var)), 0, 0])
        if n_new:
            new_nodes, remap = [], {}
            for j, entry in enumerate(nodes):
                for var in pending.get(j, ()):
                    remap[("new", id(var))] = len(new_nodes)
                    new_nodes.append(var)
                remap[j] = len(new_nodes)
                new_nodes.append(entry)
            for entry in new_nodes:
                entry["inputs"] = [[remap[i], k, *rest] for (i, k, *rest)
                                   in entry["inputs"]]
            arg_nodes = {remap[i] for i in arg_nodes} | {
                i for i, e in enumerate(new_nodes) if e["op"] == "null"}
            data["heads"] = [[remap[i], k, *rest] for (i, k, *rest)
                             in data.get("heads", [])]
            data["nodes"] = nodes = new_nodes

    # -- 0.9.4 -> 0.9.5: argmin/argmax axis flag change ---------------------
    if ver < 905:
        for entry in nodes:
            if entry["op"] in ("argmin", "argmax") and \
                    _attrs(entry).get("axis") == "-1":
                del entry["attrs"]["axis"]

    data["arg_nodes"] = sorted(arg_nodes)
    return data


def load_json(json_str):
    data = _upgrade_legacy_json(json.loads(json_str))
    nodes = []
    for entry in data["nodes"]:
        attrs = dict(entry.get("attrs", entry.get("param", {})))
        user_attrs = {k: v for k, v in attrs.items() if k.startswith("__")}
        op_attrs = {k: v for k, v in attrs.items() if not k.startswith("__")}
        if entry["op"] == "null":
            node = _Node(None, entry["name"], {}, [], user_attrs)
        else:
            schema = get_op(entry["op"])
            inputs = [(nodes[i], j) for (i, j, *_k) in entry["inputs"]]
            node = _Node(schema, entry["name"], op_attrs, inputs, user_attrs)
        nodes.append(node)
    heads = data.get("heads") or [[len(nodes) - 1, 0, 0]]
    return Symbol([(nodes[i], j) for (i, j, *_k) in heads])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def _eval_shape(node, parsed, in_shapes):
    """Forward-only shape inference: the op run on torch's ``meta``
    device (no data, no compute), the role of ``jax.eval_shape``."""
    import torch
    from ..ops.registry import OpCtx

    xs = [torch.empty(tuple(s), dtype=torch.float32, device="meta")
          for s in in_shapes]
    try:
        with torch.no_grad():
            out = node.op.fcompute(parsed, OpCtx(is_train=False,
                                                 device="meta"), *xs)
    except Exception:
        return None
    if not isinstance(out, tuple):
        out = (out,)
    return [tuple(o.shape) for o in out[:node.num_outputs()]]
