"""Inference export: the ``.mxa`` artifact (counterpart of
mxnet_tpu/contrib/export.py).

**export_model** (the c_predict role: MXPredCreate binds a symbol and
its params to fixed input shapes) writes a zip of ``MANIFEST.json``,
``params.bin`` (the reference NDArray container) and the inference
program. The JAX package's program is StableHLO (``module.stablehlo``),
which torch cannot run; the port's is a ``torch.export``
ExportedProgram, saved by ``torch.export.save`` as ``module.<platform>.pt2``:
the executor's inference walk (``executor._Plan(symbol, is_train=False)``)
traced into one graph of ATen ops. It has the JAX function's inputs, in
its order: the inputs, then the packed params, then the aux states; under
``dtype="bfloat16"`` float inputs and float params with ndim > 1 are cast
to bf16 at the top, weight-only int8/fp8 params are dequantized at the
top (``q.float() * scale``), and float outputs come back as float32. The
program takes the params as inputs, so ``params.bin`` holds the only
copy of the weights. A traced program asserts the device its tensors
were traced on, so there is one program per platform: ``cpu`` traced on
the host, ``cuda`` on the card; ``platforms`` defaults to both, and
narrows to ``cpu`` (logged, and said by the manifest's ``platforms``)
only when the default was asked for and no card is present. The
manifest has the JAX package's keys; its ``devstats`` block, XLA's
analytics there, holds ``peak_bytes`` measured around one run of the
``cuda`` program (a CUDA graph capture), and is left out without one.
``MANIFEST.json`` and ``params.bin`` are byte-equal to the JAX
package's for the same params. Ops that launch a hand-written kernel
through ctypes (``_contrib_flash_attention``) cannot be traced:
export_model refuses them.

**export_decode_model** writes the decode artifact. A decode artifact is a zip of ``MANIFEST.json`` and ``params.bin`` (the
reference NDArray container, ``ndarray/container.py``), with no compiled
program: the decode engine compiles its plans at load from the
manifest's ``decode`` block (the :class:`~mxnet_tpu_torch.serving.decode.
DecodeModel` config plus ``param_names``). The JAX package and the port
write the same manifest and the same ``params.bin`` bytes for the same
params, and each loads the other's artifacts. fp8 weights are stored as
their uint8 bytes (the container has no fp8 type); the manifest's
``quant`` block names them.
"""
from __future__ import annotations

import io
import json
import logging
import os
import tempfile
import zipfile

import numpy as np
import torch

from .. import config as _config
from ..base import MXNetError, to_numpy
from ..ndarray import container

__all__ = ["export_model", "export_decode_model", "serving_buckets",
           "MANIFEST", "PARAMS_FILE", "PROGRAM_FILES", "FORMAT_VERSION"]

MANIFEST = "MANIFEST.json"
PARAMS_FILE = "params.bin"
# the JAX package's program, which does not cross (ROADMAP item 13)
STABLEHLO_FILE = "module.stablehlo"
PROGRAM_FILES = {"cpu": "module.cpu.pt2", "cuda": "module.cuda.pt2"}
DEFAULT_PLATFORMS = ("cpu", "cuda")
FORMAT_VERSION = 1
# ops whose fcompute launches a hand-written kernel through ctypes
KERNEL_OPS = ("_contrib_flash_attention",)

log = logging.getLogger("mxnet_tpu_torch.export")


def serving_buckets(max_batch):
    """Power-of-two batch-bucket ladder for a given exported batch:
    1, 2, 4, ... capped at (and always including) max_batch."""
    if max_batch < 1:
        raise MXNetError("serving_buckets: max_batch must be >= 1")
    buckets, b = [], 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(int(max_batch))
    return buckets


def _numpy(v):
    """A param as numpy: tensors leave the card; fp8 becomes its uint8
    bytes; float64 becomes float32 (as the JAX package stores it)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.float8_e4m3fn:
            v = v.view(torch.uint8)
        v = v.numpy()
    v = np.asarray(v)
    if v.dtype.name == "float8_e4m3fn":
        v = v.view(np.uint8)
    if v.dtype == np.float64:
        v = v.astype(np.float32)
    return np.ascontiguousarray(v)


def _resolve_qdtype(quantize):
    """True -> MXNET_QUANT_DTYPE, else the explicit 'int8'/'fp8'."""
    q = str(_config.get("MXNET_QUANT_DTYPE")) if quantize is True \
        else str(quantize)
    if q not in ("int8", "fp8"):
        raise MXNetError(f"quantize: dtype must be int8 or fp8, got {q!r}")
    return q


def _pack_quantized(param_names, param_vals, qdtype, skip):
    """Weight-only calibration over (names, vals): returns the packed
    name/value lists with each quantized weight immediately followed by
    its f32 ``{name}__scale`` companion, plus the manifest quant block.
    fp8 tensors are stored as their uint8 bytes."""
    from .quantization import calibrate_weights
    qparams, stats = calibrate_weights(
        dict(zip(param_names, param_vals)), dtype=qdtype, skip=skip)
    packed_names, packed_vals, qnames = [], [], []
    for n in param_names:
        s = qparams.get(n + "__scale")
        packed_names.append(n)
        packed_vals.append(_numpy(qparams[n]))
        if s is not None:
            qnames.append(n)
            packed_names.append(n + "__scale")
            packed_vals.append(_numpy(s))
    quant_meta = {"dtype": qdtype, "mode": "weight_only",
                  "params": qnames, "stats": stats}
    return packed_names, packed_vals, quant_meta


def export_decode_model(path, decode_config, params, model_name=None,
                        quantize=None, quantize_skip=("embed", "pos")):
    """Serialize a decode model to a ``.mxa`` artifact at ``path``.

    ``decode_config`` is a :meth:`DecodeModel.config` dict, ``params`` a
    {name: array or tensor} dict holding every name of
    :meth:`DecodeModel.param_names`. The manifest's ``devstats`` block
    carries the params' bytes and a peak estimate (params + the KV pool at
    the default slot count), so an admission check can read the
    footprint without loading the params. ``quantize`` ("int8" | "fp8" |
    True for ``MXNET_QUANT_DTYPE``) stores weight-only quantized weights
    with per-channel f32 ``{name}__scale`` companions and a ``quant``
    block. Returns ``path``."""
    from ..serving.decode import DecodeModel

    model = DecodeModel.from_config(dict(decode_config))
    names = model.param_names()
    missing = [n for n in names if n not in params]
    if missing:
        raise MXNetError(f"export_decode_model: missing params {missing}")
    param_vals = [_numpy(params[n]) for n in names]

    quant_meta = None
    packed_names, packed_vals = names, param_vals
    if quantize:
        packed_names, packed_vals, quant_meta = _pack_quantized(
            names, param_vals, _resolve_qdtype(quantize), quantize_skip)

    if model_name is None:
        model_name = os.path.splitext(os.path.basename(str(path)))[0] \
            or "model"
    params_bytes = sum(int(v.nbytes) for v in packed_vals)
    pool_bytes = int(_config.get("MXNET_DECODE_SLOTS")) \
        * model.session_cache_bytes()
    manifest = {
        "format_version": FORMAT_VERSION,
        "model_name": str(model_name),
        "decode": dict(model.config(), param_names=list(packed_names)),
        "devstats": {"params_bytes": params_bytes,
                     "peak_bytes": params_bytes + pool_bytes},
    }
    if quant_meta is not None:
        manifest["quant"] = quant_meta
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(str(path)))) as td:
        pfile = os.path.join(td, PARAMS_FILE)
        container.save_container(
            pfile, {f"arg:{n}": v
                    for n, v in zip(packed_names, packed_vals)})
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr(MANIFEST, json.dumps(manifest, indent=1))
            # stored: deflating random-looking float bytes costs seconds a
            # hundred MB and saves a few percent
            zf.write(pfile, PARAMS_FILE, compress_type=zipfile.ZIP_STORED)
    return path


class _InferenceProgram(torch.nn.Module):
    """The function export_model traces: the JAX package's ``fn``
    (inputs, packed params, aux states in; float32 outputs out) over the
    executor's inference walk."""

    def __init__(self, symbol, input_names, packed_names, param_names,
                 aux_names, fp8_names, bf16, device):
        super().__init__()
        from ..executor import _Plan
        self.plan = _Plan(symbol, is_train=False)
        self.input_names = list(input_names)
        self.packed_names = list(packed_names)
        self.param_names = list(param_names)
        self.aux_names = list(aux_names)
        self.fp8_names = set(fp8_names)
        self.bf16 = bf16
        self.device = device

    def forward(self, *flat):
        n_in, n_par = len(self.input_names), len(self.packed_names)
        args = {}
        for n, v in zip(self.input_names, flat[:n_in]):
            if self.bf16 and v.is_floating_point():
                v = v.to(torch.bfloat16)
            args[n] = v
        pv = dict(zip(self.packed_names, flat[n_in:n_in + n_par]))
        for n in self.param_names:
            v = pv[n]
            s = pv.get(n + "__scale")
            if s is not None:
                # weight-only dequant at the top of the program
                if n in self.fp8_names:
                    v = v.view(torch.float8_e4m3fn)
                v = v.float() * s
            if self.bf16 and v.ndim > 1 and v.is_floating_point():
                v = v.to(torch.bfloat16)
            args[n] = v
        aux = dict(zip(self.aux_names, flat[n_in + n_par:]))
        outs, _ = self.plan.run(args, aux, self.device)
        return tuple(o.float() if o.is_floating_point() else o
                     for o in outs)


def _platforms(platforms):
    """The platforms to trace: an explicit list must be met in full; the
    default narrows to ``cpu`` without a card, with the reason logged."""
    if platforms is not None:
        platforms = tuple(platforms)
        bad = [p for p in platforms if p not in PROGRAM_FILES]
        if bad or not platforms:
            raise MXNetError(f"export_model: platforms {platforms!r}; the "
                             f"port traces {sorted(PROGRAM_FILES)}")
        if "cuda" in platforms and not torch.cuda.is_available():
            raise MXNetError("export_model: platform 'cuda' asked for, but "
                             "no CUDA device is present to trace it on")
        return platforms
    if torch.cuda.is_available():
        return DEFAULT_PLATFORMS
    log.warning("export_model: no CUDA device, so the artifact holds the "
                "cpu program only (a traced program asserts its device); "
                "export on a card for the cuda program")
    return ("cpu",)


def _trace(program, feed):
    """torch.export of ``program`` on ``feed``: (the bytes of
    ``torch.export.save``, the ExportedProgram). The example inputs (the
    params among them) are left out of the file: params.bin holds the
    weights."""
    with torch.no_grad():
        ep = torch.export.export(program, tuple(feed), strict=False)
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue(), ep


def _measured_peak(module, feed, device):
    """Device bytes one run of the ``cuda`` program needs: its inputs,
    params and aux states on the card plus what a CUDA graph capture of
    one run adds to a fresh memory pool (the decode plans'
    ``capture_mark`` / ``capture_peak``), in full float32 as the
    predictor runs it."""
    from ..ops.nn import cudnn_f32
    from ..telemetry import devstats
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    on_card = [t.to(device) for t in feed]
    pool = torch.cuda.graph_pool_handle()
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.no_grad(), cudnn_f32(), torch.cuda.stream(stream):
        module(*on_card)                 # warm-up outside the graph
        stream.synchronize()
        mark = devstats.capture_mark(pool, device)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            outs = module(*on_card)
        finally:
            graph.capture_end()
    peak = devstats.capture_peak(pool, device, mark) - before
    del graph, outs, on_card
    torch.cuda.synchronize(device)
    return int(peak)


def export_model(path, symbol, arg_params, aux_params, data_shapes,
                 dtype="float32", platforms=None, model_name=None,
                 quantize=None, quantize_skip=()):
    """Serialize an inference-ready model to ``path`` (a ``.mxa``).

    data_shapes: {input_name: shape} for every non-parameter argument
    (MXPredCreate's input_shape contract). ``dtype`` "bfloat16" casts the
    inputs and weight matrices at the top of the program, as the JAX
    package's bf16 export does. ``platforms`` (module docstring) defaults
    to ("cpu", "cuda"). ``model_name`` labels the artifact for serving
    metrics (default: the file stem). ``quantize`` ("int8" | "fp8" |
    True for MXNET_QUANT_DTYPE) stores eligible params (float, ndim >= 2,
    not in ``quantize_skip``) weight-only quantized with per-channel
    float32 ``{name}__scale`` companions and a ``quant`` block, and the
    program dequantizes them at its top. Returns ``path``."""
    if dtype not in ("float32", "bfloat16"):
        raise MXNetError("export_model: dtype must be float32 or bfloat16")
    for node in symbol._topo():
        if node.op is not None and node.op.name in KERNEL_OPS:
            raise MXNetError(
                f"export_model: node {node.name!r} is {node.op.name}, which "
                "launches a hand-written CUDA kernel that torch.export "
                "cannot trace; exporting it waits for the kernels as "
                "torch.library custom ops (ROADMAP item 13(b))")
    arg_names = symbol.list_arguments()
    aux_names = symbol.list_auxiliary_states()
    input_names = [n for n in arg_names if n in data_shapes]
    if len(input_names) != len(data_shapes):
        missing = set(data_shapes) - set(input_names)
        raise MXNetError(f"export_model: data_shapes names {missing} are "
                         "not arguments of the symbol")
    param_names = [n for n in arg_names if n not in data_shapes]
    arg_shapes, _, _ = symbol.infer_shape(**dict(data_shapes))
    inferred = dict(zip(arg_names, arg_shapes))

    param_vals = []
    for n in param_names:
        if n in arg_params:
            param_vals.append(_numpy(to_numpy(arg_params[n])))
        else:
            # loss-head labels (SoftmaxOutput ignores them at inference)
            # are baked as zeros, as the reference predictor does
            if inferred.get(n) is None:
                raise MXNetError(
                    f"export_model: no value for argument {n!r} and its "
                    "shape is not inferable; pass it in data_shapes or "
                    "arg_params")
            param_vals.append(np.zeros(inferred[n], np.float32))
    aux_vals = [np.ascontiguousarray(to_numpy(aux_params[n]))
                for n in aux_names]

    quant_meta = None
    packed_names, packed_vals = param_names, param_vals
    if quantize:
        packed_names, packed_vals, quant_meta = _pack_quantized(
            param_names, param_vals, _resolve_qdtype(quantize),
            quantize_skip)
    fp8_names = set(quant_meta["params"]) \
        if quant_meta and quant_meta["dtype"] == "fp8" else set()

    platforms = _platforms(platforms)
    host_feed = [torch.zeros(tuple(data_shapes[n]), dtype=torch.float32)
                 for n in input_names]
    host_feed += [torch.from_numpy(v.copy()) for v in packed_vals]
    host_feed += [torch.from_numpy(v.copy()) for v in aux_vals]
    programs, peak = {}, None
    for plat in platforms:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if plat == "cuda" else torch.device("cpu")
        feed = [t.to(device) for t in host_feed]
        program = _InferenceProgram(symbol, input_names, packed_names,
                                    param_names, aux_names, fp8_names,
                                    dtype == "bfloat16", device)
        programs[plat], ep = _trace(program, feed)
        del feed
        if plat == "cuda":
            from ..telemetry import devstats
            if devstats.enabled():
                peak = _measured_peak(ep.module(), host_feed, device)
        del ep

    batch_sizes = {int(data_shapes[n][0]) for n in input_names
                   if len(data_shapes[n]) > 0}
    if model_name is None:
        model_name = os.path.splitext(os.path.basename(str(path)))[0] \
            or "model"
    manifest = {
        "format_version": FORMAT_VERSION,
        "model_name": str(model_name),
        "inputs": [{"name": n, "shape": list(data_shapes[n]),
                    "dtype": "float32"} for n in input_names],
        "param_names": list(packed_names),
        "aux_names": aux_names,
        "outputs": symbol.list_outputs(),
        "dtype": dtype,
        "platforms": list(platforms),
    }
    if len(batch_sizes) == 1:
        max_batch = batch_sizes.pop()
        manifest["serving"] = {"batch_axis": 0, "max_batch": max_batch,
                               "buckets": serving_buckets(max_batch),
                               "amp_dtype": dtype,
                               "model": str(model_name)}
    if quant_meta is not None:
        manifest["quant"] = quant_meta
    if peak is not None:
        manifest["devstats"] = {"peak_bytes": peak}
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(str(path)))) as td:
        pfile = os.path.join(td, PARAMS_FILE)
        save = {f"arg:{n}": v for n, v in zip(packed_names, packed_vals)}
        save.update({f"aux:{n}": v for n, v in zip(aux_names, aux_vals)})
        container.save_container(pfile, save)
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr(MANIFEST, json.dumps(manifest, indent=1))
            for plat, data in programs.items():
                zf.writestr(PROGRAM_FILES[plat], data)
            # weights do not deflate; stored, a load is a plain read
            zf.write(pfile, PARAMS_FILE, compress_type=zipfile.ZIP_STORED)
    return path
