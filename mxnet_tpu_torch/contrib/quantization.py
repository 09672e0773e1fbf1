"""INT8 model quantization and post-training weight-only calibration
(counterpart of mxnet_tpu/contrib/quantization.py).

* :func:`quantize_model` — the reference's int8 graph rewrite
  (python/mxnet/contrib/quantization.py quantize_model and the C++ pass
  ``MXQuantizeSymbol``) and its calibration: the Symbol DAG is walked
  once, Convolution / FullyConnected / Pooling / Flatten become their
  ``_contrib_quantized_*`` twins, ``_contrib_quantize`` (fed by online
  ``min`` / ``max``) goes in front of float inputs, ``_contrib_requantize``
  after the int32-accumulating ops and ``_contrib_dequantize`` in front of
  float consumers; weights are quantized offline. Calibration runs the
  float graph on sample batches and pins the requantize thresholds: naive
  (|max|) or entropy (the KL-optimal threshold of a histogram, the same
  numpy search as the JAX package's, so the same histogram gives the same
  threshold). The rewritten node list is the JAX package's, name for name.
* :func:`calibrate_weights`, :func:`quantize_decode_artifact` and the
  command line::

    python -m mxnet_tpu_torch.contrib.quantization src.mxa dst.mxa --dtype int8

  read a float decode artifact and write its int8 (or fp8) twin, then
  print one JSON line. They run on the CPU: no card is needed.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import config as _config
from ..base import MXNetError
from ..context import current_context
from ..convert import load_decode_artifact, to_tensor
from ..ops.quantization import dequantize_rows, quantize_rows
from ..ops.registry import get_op
from ..symbol.symbol import Symbol, _Node

__all__ = ["quantize_model", "calibrate_weights", "quantize_decode_artifact",
           "main"]

# fp32 op -> quantized twin (quantize_graph_pass.cc FQuantizedOp registry)
_QUANTIZED_OP_MAP = {
    "Convolution": "_contrib_quantized_conv",
    "FullyConnected": "_contrib_quantized_fully_connected",
    "Pooling": "_contrib_quantized_pooling",
    "Flatten": "_contrib_quantized_flatten",
}
# ops whose quantized twin accumulates in int32 (FNeedRequantize)
_NEED_REQUANTIZE = {"_contrib_quantized_conv",
                    "_contrib_quantized_fully_connected"}
# Pooling configs that don't preserve int8 semantics are left in fp32
_POOL_OK = {"max", "avg"}


def _entry_name(node, idx):
    if node.op is None:
        return node.name
    if node.num_outputs() == 1:
        return f"{node.name}_output"
    return f"{node.name}_output{idx}"


class _Rewriter:
    """Mirror-map graph rewriter (role of QuantizeGraph's DFSVisit)."""

    def __init__(self, excluded):
        self.excluded = set(excluded or ())
        self.mirror = {}      # id(node) -> mirrored (fp) node
        # (id(node), idx) -> (q_entry, min_entry, max_entry)
        self.quantized = {}
        self.dequant_cache = {}

    def fp_entry(self, node, idx):
        """Entry in the mirrored fp32 graph, dequantizing if the mirrored
        producer is quantized-only."""
        key = (id(node), idx)
        if key in self.quantized:
            if key not in self.dequant_cache:
                q, mn, mx = self.quantized[key]
                deq = _Node(get_op("_contrib_dequantize"),
                            f"{_entry_name(node, idx)}_dequantize", {},
                            [q, mn, mx])
                self.dequant_cache[key] = (deq, 0)
            return self.dequant_cache[key]
        return (self.mirror[id(node)], idx)

    def q_entry(self, node, idx):
        """Quantized (int8) entry + (min, max) entries for an input,
        inserting an online _contrib_quantize if needed."""
        key = (id(node), idx)
        if key not in self.quantized:
            src = (self.mirror[id(node)], idx)
            base = _entry_name(node, idx)
            mn = _Node(get_op("min"), f"{base}_min", {}, [src])
            mx = _Node(get_op("max"), f"{base}_max", {}, [src])
            qz = _Node(get_op("_contrib_quantize"), f"{base}_quantize",
                       {"out_type": "int8"},
                       [src, (mn, 0), (mx, 0)])
            self.quantized[key] = ((qz, 0), (qz, 1), (qz, 2))
        return self.quantized[key]

    def quantizable(self, node):
        if node.op is None or node.name in self.excluded:
            return False
        qname = _QUANTIZED_OP_MAP.get(node.op.name)
        if qname is None:
            return False
        if node.op.name == "Pooling":
            pt = node.attrs.get("pool_type", "max")
            if pt not in _POOL_OK:
                return False
        return True

    def rewrite_node(self, node):
        if node.op is None:
            self.mirror[id(node)] = node      # variables are shared
            return
        if not self.quantizable(node):
            new = _Node(node.op, node.name, dict(node.attrs),
                        [self.fp_entry(n, i) for (n, i) in node.inputs],
                        dict(node.user_attrs))
            self.mirror[id(node)] = new
            return

        qop = get_op(_QUANTIZED_OP_MAP[node.op.name])
        opname = node.op.name
        if opname in ("Convolution", "FullyConnected"):
            parsed = node.op.parse_attrs(node.attrs)
            has_bias = not parsed["no_bias"]
            dat = self.q_entry(*node.inputs[0])
            wgt = self.q_entry(*node.inputs[1])
            ins = [dat[0], wgt[0]]
            if has_bias:
                bia = self.q_entry(*node.inputs[2])
                ins.append(bia[0])
            ins += [dat[1], dat[2], wgt[1], wgt[2]]
            if has_bias:
                ins += [bia[1], bia[2]]
            qnode = _Node(qop, f"quantized_{node.name}", dict(node.attrs),
                          ins, dict(node.user_attrs))
        else:   # Pooling / Flatten: (data, min, max) pass-through ranges
            dat = self.q_entry(*node.inputs[0])
            qnode = _Node(qop, f"quantized_{node.name}", dict(node.attrs),
                          [dat[0], dat[1], dat[2]], dict(node.user_attrs))

        if qop.name in _NEED_REQUANTIZE:
            rq = _Node(get_op("_contrib_requantize"),
                       f"{node.name}_requantize", {},
                       [(qnode, 0), (qnode, 1), (qnode, 2)])
            out = ((rq, 0), (rq, 1), (rq, 2))
        else:
            out = ((qnode, 0), (qnode, 1), (qnode, 2))
        # the fp32 view of this node is a dequantize of its int8 output
        self.quantized[(id(node), 0)] = out
        self.mirror[id(node)] = qnode


def _quantize_symbol(sym, excluded_symbols=None, offline_params=None):
    rw = _Rewriter(excluded_symbols)
    for node in sym._topo():
        rw.rewrite_node(node)
    outputs = [rw.fp_entry(n, i) for (n, i) in sym._outputs]
    qsym = Symbol(outputs)
    if offline_params:
        _offline_params(qsym, set(offline_params))
    return qsym


def _offline_params(qsym, offline):
    """Replace quantize(param)'s three outputs with precomputed variables
    `{param}_quantize{,_min,_max}` (quantize_graph_pass.cc OfflineParams)."""
    cache = {}

    def replacement(qnode, idx):
        name = qnode.inputs[0][0].name
        suffix = ["", "_min", "_max"][idx]
        key = (name, idx)
        if key not in cache:
            cache[key] = _Node(None, f"{name}_quantize{suffix}", {}, [])
        return (cache[key], 0)

    for node in qsym._topo():
        for j, (inode, idx) in enumerate(node.inputs):
            if (inode.op is not None and
                    inode.op.name == "_contrib_quantize" and
                    inode.inputs[0][0].op is None and
                    inode.inputs[0][0].name in offline):
                node.inputs[j] = replacement(inode, idx)


def _quantize_params(qsym, params):
    """Precompute int8 params for offline-quantized weights
    (python/mxnet/contrib/quantization.py:43)."""
    from .. import nd
    quantized_params = {}
    for name in qsym.list_arguments():
        if name.endswith("_quantize"):
            original = name[: -len("_quantize")]
            val = params[original]
            mn = nd.min(val)
            mx = nd.max(val)
            q, qmn, qmx = nd.contrib.quantize(val, mn, mx, out_type="int8")
            quantized_params[name] = q
            quantized_params[name + "_min"] = qmn
            quantized_params[name + "_max"] = qmx
        elif name in params:
            quantized_params[name] = params[name]
    return quantized_params


def _calibrate_quantized_sym(qsym, th_dict):
    """Pin requantize thresholds from the calibration table
    (python/mxnet/contrib/quantization.py:169)."""
    for node in qsym._topo():
        if node.op is not None and node.op.name == "_contrib_requantize":
            orig = node.name[: -len("_requantize")]
            key = orig + "_output"
            if key in th_dict:
                mn, mx = th_dict[key]
                node.attrs = dict(node.attrs,
                                  min_calib_range=float(mn),
                                  max_calib_range=float(mx))
    return qsym


def _collect_layer_outputs(sym, arg_params, aux_params, ctx, data_iter,
                           collect_names, max_num_examples,
                           data_name="data"):
    """Run the fp32 graph, returning {entry_name: [np arrays]} for the
    requested entries (role of _collect_layer_statistics via the executor
    monitor, quantization.py:194)."""
    nodes = {}
    for node in sym._topo():
        if node.op is not None:
            nodes[f"{node.name}_output"] = (node, 0)
    targets = [n for n in collect_names if n in nodes]
    group = Symbol([nodes[n] for n in targets])

    data_iter.reset()
    batch = data_iter.next()
    data_shape = batch.data[0].shape
    ex = group.simple_bind(ctx, grad_req="null",
                           **{data_name: data_shape})
    for k, v in {**arg_params, **aux_params}.items():
        if k in ex.arg_dict:
            ex.arg_dict[k][:] = v
        elif k in ex.aux_dict:
            ex.aux_dict[k][:] = v

    collected = {n: [] for n in targets}
    num = 0
    data_iter.reset()
    for batch in data_iter:
        ex.arg_dict[data_name][:] = batch.data[0]
        outs = ex.forward(is_train=False)
        for nme, out in zip(targets, outs):
            collected[nme].append(out.asnumpy())
        num += data_shape[0]
        if max_num_examples is not None and num >= max_num_examples:
            break
    return collected, num


def _smooth_distribution(p, eps=0.0001):
    """Kullback-Leibler smoothing (quantization.py:230): move eps mass from
    nonzero bins onto zero bins."""
    is_zeros = (p == 0).astype(np.float32)
    is_nonzeros = (p != 0).astype(np.float32)
    n_zeros = is_zeros.sum()
    n_nonzeros = p.size - n_zeros
    if not n_nonzeros:
        raise MXNetError("all-zero histogram cannot be smoothed")
    eps1 = eps * float(n_zeros) / float(n_nonzeros)
    hist = p.astype(np.float32)
    hist += eps * is_zeros + (-eps1) * is_nonzeros
    return hist


def _get_optimal_threshold(arr, num_bins=8001, num_quantized_bins=255):
    """Entropy calibration: the |threshold| whose clipped-then-quantized
    distribution minimizes KL divergence against the reference distribution
    (quantization.py:249, the TensorRT scheme)."""
    arr = np.asarray(arr).ravel()
    mn, mx = arr.min(), arr.max()
    th = max(abs(mn), abs(mx))
    if th == 0:
        return mn, mx, 0.0, 0.0
    hist, edges = np.histogram(arr, bins=num_bins, range=(-th, th))
    zero_bin = num_bins // 2
    best_divergence = np.inf
    best_th = th
    half_q = num_quantized_bins // 2
    for i in range(half_q, num_bins // 2 + 1):
        p_start, p_stop = zero_bin - i, zero_bin + i + 1
        sliced = hist[p_start:p_stop].astype(np.float32)
        p = sliced.copy()
        # outliers are absorbed into the boundary bins
        p[0] += hist[:p_start].sum()
        p[-1] += hist[p_stop:].sum()
        if p.sum() == 0:
            continue
        # quantize the sliced distribution into num_quantized_bins
        num_merged = sliced.size // num_quantized_bins
        q = np.zeros(sliced.size, np.float32)
        for j in range(num_quantized_bins):
            start = j * num_merged
            stop = sliced.size if j == num_quantized_bins - 1 else \
                start + num_merged
            total = sliced[start:stop].sum()
            nonzero = (sliced[start:stop] != 0).sum()
            if nonzero:
                q[start:stop] = np.where(sliced[start:stop] != 0,
                                         total / nonzero, 0)
        ps = _smooth_distribution(p / p.sum())
        try:
            qs = _smooth_distribution(q / max(q.sum(), 1e-20))
        except MXNetError:
            continue
        divergence = np.sum(ps * np.log(ps / qs))
        if divergence < best_divergence:
            best_divergence = divergence
            best_th = (i + 0.5) * (2 * th / num_bins)
    return mn, mx, -best_th, best_th


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   label_names=("softmax_label",), ctx=None,
                   excluded_sym_names=None, calib_mode="entropy",
                   calib_data=None, num_calib_examples=None,
                   calib_layer=None, quantized_dtype="int8",
                   logger=logging):
    """Quantize an fp32 model to int8 (quantization.py:401).

    Returns (quantized_symbol, quantized_arg_params, aux_params).
    calib_mode: 'none' (online requantize ranges), 'naive' (min/max over
    calib data), or 'entropy' (KL-optimal thresholds). The calibration
    forward runs on ``ctx``, the current context (the card) when None.
    """
    if quantized_dtype != "int8":
        raise MXNetError("quantized_dtype: only 'int8' is supported")
    ctx = ctx or current_context()
    excluded = list(excluded_sym_names or [])

    # weights/biases of quantized layers are quantized offline
    offline = set()
    for node in sym._topo():
        if node.op is not None and node.op.name in ("Convolution",
                                                    "FullyConnected") \
                and node.name not in excluded:
            for (inode, _) in node.inputs[1:]:
                if inode.op is None:
                    offline.add(inode.name)

    qsym = _quantize_symbol(sym, excluded_symbols=excluded,
                            offline_params=offline)

    if calib_mode and calib_mode != "none":
        if calib_data is None:
            raise MXNetError(f"calib_mode={calib_mode!r} requires calib_data")
        collect = []
        for node in sym._topo():
            if node.op is not None and \
                    node.op.name in ("Convolution", "FullyConnected") and \
                    node.name not in excluded:
                name = f"{node.name}_output"
                if calib_layer is None or calib_layer(name):
                    collect.append(name)
        collected, num = _collect_layer_outputs(
            sym, arg_params, aux_params, ctx, calib_data, collect,
            num_calib_examples, data_name=list(data_names)[0])
        logger.info("collected statistics from %d examples", num)
        th_dict = {}
        for name, arrs in collected.items():
            arr = np.concatenate([a.ravel() for a in arrs])
            if calib_mode == "naive":
                th = float(np.max(np.abs(arr)))
                th_dict[name] = (-th, th)
            elif calib_mode == "entropy":
                _, _, mn, mx = _get_optimal_threshold(arr)
                th_dict[name] = (mn, mx)
            else:
                raise MXNetError(f"unknown calib_mode {calib_mode!r}")
        qsym = _calibrate_quantized_sym(qsym, th_dict)

    qarg_params = _quantize_params(qsym, arg_params)
    return qsym, qarg_params, aux_params




def calibrate_weights(params, dtype=None, skip=("embed", "pos"),
                      min_ndim=2):
    """Weight-only calibration over a {name: array or tensor} dict.

    Every float param with ndim >= ``min_ndim`` whose name (or last
    dot-component) is not in ``skip`` is replaced by its quantized twin
    plus an f32 ``{name}__scale`` companion (per-output-channel symmetric
    scales, :func:`ops.quantization.quantize_rows`). ``skip`` defaults to
    the lookup tables, which are gathered, not multiplied. dtype defaults
    to MXNET_QUANT_DTYPE ("int8" | "fp8"). Tensors stay on their device.

    Returns (qparams, stats): stats maps each quantized name to its
    per-channel |w| max, scale range and RMS relative dequantization
    error."""
    dtype = dtype or str(_config.get("MXNET_QUANT_DTYPE"))
    skip = set(skip or ())
    out, stats = {}, {}
    for name, w in params.items():
        w = to_tensor(w)
        leaf = name.rsplit(".", 1)[-1]
        if (w.ndim < min_ndim or not w.is_floating_point()
                or name in skip or leaf in skip):
            out[name] = w
            continue
        wf = w.float()
        q, s = quantize_rows(wf, dtype)
        deq = dequantize_rows(q, s)
        denom = float(torch.sqrt(torch.mean(wf * wf))) or 1.0
        err = float(torch.sqrt(torch.mean((deq - wf) ** 2))) / denom
        out[name] = q
        out[name + "__scale"] = s
        stats[name] = {"shape": list(w.shape),
                       "amax": float(wf.abs().max()),
                       "scale_min": float(s.min()),
                       "scale_max": float(s.max()),
                       "rms_rel_err": err}
    if not stats:
        raise MXNetError("calibrate_weights: nothing to quantize "
                         f"(params={list(params)!r}, skip={sorted(skip)})")
    return out, stats


def quantize_decode_artifact(src, dst, dtype=None, skip=("embed", "pos")):
    """Load a float decode ``.mxa`` (``contrib.export.export_decode_model``
    of either package) and write its weight-only int8/fp8 twin to
    ``dst``. Returns the manifest's ``quant`` block as written."""
    from .export import export_decode_model

    cfg, params, name, quant = load_decode_artifact(str(src))
    if quant:
        raise MXNetError(f"{src}: already quantized ({quant.get('dtype')})")
    export_decode_model(dst, cfg, params, model_name=name,
                        quantize=dtype or True, quantize_skip=skip)
    return load_decode_artifact(str(dst))[3]


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.contrib.quantization",
        description="post-training weight-only calibration: float decode "
                    ".mxa -> int8/fp8 .mxa with per-channel scales in the "
                    "manifest")
    ap.add_argument("src", help="float decode .mxa artifact")
    ap.add_argument("dst", help="output quantized .mxa path")
    ap.add_argument("--dtype", default=None, choices=("int8", "fp8"),
                    help="target dtype (default: MXNET_QUANT_DTYPE)")
    ap.add_argument("--skip", default="embed,pos",
                    help="comma-separated param names (or last "
                         "dot-components) to keep float")
    args = ap.parse_args(argv)
    skip = tuple(s for s in args.skip.split(",") if s)
    quant = quantize_decode_artifact(args.src, args.dst,
                                     dtype=args.dtype, skip=skip)
    print(json.dumps({"metric": "quantize_decode_artifact",
                      "dst": args.dst, "dtype": quant["dtype"],
                      "params": len(quant["params"]), "ok": True}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
