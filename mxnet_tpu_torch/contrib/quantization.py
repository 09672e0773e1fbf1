"""Post-training weight-only calibration (counterpart of
mxnet_tpu/contrib/quantization.py ``calibrate_weights``)."""
from __future__ import annotations

import torch

from .. import config as _config
from ..base import MXNetError
from ..convert import to_tensor
from ..ops.quantization import dequantize_rows, quantize_rows

__all__ = ["calibrate_weights"]


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
