"""The write side of the decode ``.mxa`` artifact (counterpart of
mxnet_tpu/contrib/export.py ``export_decode_model``).

A decode artifact is a zip of ``MANIFEST.json`` and ``params.bin`` (the
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

import json
import os
import tempfile
import zipfile

import numpy as np
import torch

from .. import config as _config
from ..base import MXNetError
from ..ndarray import container

__all__ = ["export_decode_model", "MANIFEST", "PARAMS_FILE",
           "FORMAT_VERSION"]

MANIFEST = "MANIFEST.json"
PARAMS_FILE = "params.bin"
FORMAT_VERSION = 1


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
            zf.write(pfile, PARAMS_FILE)
    return path
