"""Post-training weight-only calibration (counterpart of
mxnet_tpu/contrib/quantization.py ``calibrate_weights``,
``quantize_decode_artifact`` and its command line)::

    python -m mxnet_tpu_torch.contrib.quantization src.mxa dst.mxa --dtype int8

reads a float decode artifact and writes its int8 (or fp8) twin, then
prints one JSON line. It runs on the CPU: no card is needed.
"""
from __future__ import annotations

import torch

from .. import config as _config
from ..base import MXNetError
from ..convert import load_decode_artifact, to_tensor
from ..ops.quantization import dequantize_rows, quantize_rows

__all__ = ["calibrate_weights", "quantize_decode_artifact", "main"]


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
