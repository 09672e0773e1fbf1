"""Standalone predictor for the port's exported ``.mxa`` artifacts — the
c_predict role (counterpart of mxnet_tpu/predictor.py).

Deployment-side counterpart of contrib/export.py's ``export_model``.
This file is SELF-CONTAINED: it imports the standard library, numpy and
torch, and nothing of mxnet_tpu_torch, so it can be copied out of the
package (the amalgamation role) and used on a host that has no operator
library, no symbol machinery and no training stack: the artifact holds
the program itself, a ``torch.export`` ExportedProgram a platform
(``module.cpu.pt2``, ``module.cuda.pt2``). The container reader below
duplicates ndarray/container.py's dense path for that reason.

The predictor runs on the card unless it is given ``device="cpu"``
(with mxnet_tpu_torch loaded, unless the package's current context is
the host), and runs the program of its device: given an artifact without that
program it raises, naming the missing file; it never runs another
platform's program instead. A JAX package artifact (StableHLO,
``module.stablehlo``) is refused: StableHLO does not cross. On the
card the program runs in full float32 (TF32 off in cuDNN and cuBLAS for
the call, as the port's convolutions do).

c_predict_api mapping:
  MXPredCreate            -> Predictor(path)        (shapes bound at
                             export time, as MXPredCreate binds them)
  MXPredSetInput          -> forward(name=array, ...)
  MXPredForward           -> forward(...)
  MXPredGetOutputShape    -> .output_shapes
  MXPredGetOutput         -> forward's return value
  MXPredFree              -> garbage collection

Run ``python -m mxnet_tpu_torch.predictor model.mxa input.npy`` (or the
file by path) for a smoke check: it prints the output shapes and the
argmax of each output (``--device cpu`` to run on the host).
"""
from __future__ import annotations

import contextlib
import io
import json
import struct
import sys
import threading
import zipfile

import numpy as np
import torch

_MANIFEST = "MANIFEST.json"
_PARAMS_FILE = "params.bin"
_PROGRAMS = {"cpu": "module.cpu.pt2", "cuda": "module.cuda.pt2"}
_STABLEHLO = "module.stablehlo"

# reference NDArray container constants (src/ndarray/ndarray.cc:1582-1808)
_LIST_MAGIC = 0x112
_V2_MAGIC = 0xF993FAC9
_FLAG_TO_DTYPE = {0: np.float32, 1: np.float64, 2: np.float16,
                  3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64}


class MXNetError(RuntimeError):
    """Refusals of this file when it is used alone; with mxnet_tpu_torch
    loaded, :func:`_error` raises the package's MXNetError instead."""


def _error(msg):
    base = sys.modules.get("mxnet_tpu_torch.base")
    return (base.MXNetError if base is not None else MXNetError)(msg)


def _read_container_dense(buf):
    """Minimal dense-only reader of the reference .params container."""
    pos = 0

    def take(n):
        nonlocal pos
        b = buf[pos:pos + n]
        if len(b) != n:
            raise ValueError("truncated container")
        pos += n
        return b

    def u32():
        return struct.unpack("<I", take(4))[0]

    def i32():
        return struct.unpack("<i", take(4))[0]

    def u64():
        return struct.unpack("<Q", take(8))[0]

    def shape():
        return tuple(np.frombuffer(take(8 * u32()), "<i8").tolist())

    if u64() != _LIST_MAGIC:
        raise ValueError("not an NDArray container")
    u64()
    arrays = []
    for _ in range(u64()):
        if u32() != _V2_MAGIC:
            raise ValueError("predictor: only V2 dense blobs supported")
        if i32() != 0:
            raise ValueError("predictor: sparse params unsupported")
        s = shape()
        i32(), i32()
        dt = np.dtype(_FLAG_TO_DTYPE[i32()])
        n = int(np.prod(s, dtype=np.int64))
        arrays.append(np.frombuffer(take(n * dt.itemsize),
                                    dt.newbyteorder("<")).reshape(s))
    names = [take(u64()).decode("utf-8") for _ in range(u64())]
    return dict(zip(names, arrays))


def _device(device):
    """None -> the card (raises without one), or, with mxnet_tpu_torch
    loaded, its current context (``with mx.cpu():`` scopes); else as
    given."""
    ctx = sys.modules.get("mxnet_tpu_torch.context")
    if device is None and ctx is not None:
        return ctx.resolve_device(None)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise _error("no CUDA device: the predictor runs on the card by "
                         "default; pass device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


_F32_LOCK = threading.Lock()
_F32_STATE = {"depth": 0, "saved": None}


@contextlib.contextmanager
def f32_scope():
    """cuDNN and cuBLAS in full float32 while any caller is inside (PyTorch
    lets cuDNN convolutions use TF32 by default); counted, so threads
    that overlap restore the flags once, after the last one leaves. The
    package's operators take the same scope (``ops.nn.cudnn_f32``)."""
    cd, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    with _F32_LOCK:
        if _F32_STATE["depth"] == 0:
            _F32_STATE["saved"] = (cd.allow_tf32, mm.allow_tf32)
            cd.allow_tf32 = mm.allow_tf32 = False
        _F32_STATE["depth"] += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _F32_STATE["depth"] -= 1
            if _F32_STATE["depth"] == 0:
                cd.allow_tf32, mm.allow_tf32 = _F32_STATE["saved"]


class Predictor:
    """Load an exported artifact and serve fixed-shape inference on one
    device (the card unless ``device="cpu"``)."""

    def __init__(self, path, device=None):
        dev = _device(device)
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
            self.manifest = json.loads(zf.read(_MANIFEST))
            if self.manifest.get("format_version") != 1:
                raise ValueError(
                    f"unsupported artifact version "
                    f"{self.manifest.get('format_version')}")
            prog = _PROGRAMS[dev.type]
            if prog not in names:
                if _STABLEHLO in names:
                    raise _error(
                        f"{path}: a JAX package artifact (its program is "
                        f"StableHLO, {_STABLEHLO}); StableHLO does not "
                        "cross to the port (ROADMAP item 13): export the "
                        "model with mxnet_tpu_torch.contrib.export."
                        "export_model")
                raise _error(
                    f"{path}: no {dev.type} program ({prog}); the artifact "
                    f"holds {self.manifest.get('platforms')}. Export it on "
                    f"a machine with a {dev.type} device to serve it there")
            ep = torch.export.load(io.BytesIO(zf.read(prog)))
            params = _read_container_dense(zf.read(_PARAMS_FILE))
        self._program = ep.module()
        out_node = next(n for n in ep.graph.nodes if n.op == "output")
        self._out_shapes = [tuple(v.meta["val"].shape)
                            for v in out_node.args[0]]
        self._input_names = [i["name"] for i in self.manifest["inputs"]]
        self._input_shapes = {i["name"]: tuple(i["shape"])
                              for i in self.manifest["inputs"]}
        keys = [f"arg:{n}" for n in self.manifest["param_names"]]
        keys += [f"aux:{n}" for n in self.manifest["aux_names"]]
        self._state = [torch.from_numpy(np.array(params[k])).to(dev)
                       for k in keys]
        self._dev = dev

    @property
    def input_info(self):
        return list(self.manifest["inputs"])

    @property
    def output_names(self):
        return list(self.manifest["outputs"])

    @property
    def output_shapes(self):
        return list(zip(self.manifest["outputs"], self._out_shapes))

    @property
    def batch_axis(self):
        return int(self.manifest.get("serving", {}).get("batch_axis", 0))

    @property
    def export_batch(self):
        """Batch dimension the artifact was bound at (MXPredCreate's
        fixed shape). Request batches up to this size are servable via
        the pad-and-slice path in forward()."""
        serving = self.manifest.get("serving", {})
        if "max_batch" in serving:
            return int(serving["max_batch"])
        ax = self.batch_axis
        return int(self._input_shapes[self._input_names[0]][ax])

    def _run(self, *feed):
        """The program on device tensors at the exported shapes (inputs in
        manifest order): its output tensors, on the device."""
        with torch.no_grad(), f32_scope():
            return list(self._program(*feed, *self._state))

    def forward(self, *args, **kwargs):
        """Run inference. Inputs positionally (manifest order) or by
        name; returns a list of numpy arrays (one per output).

        Request batches SMALLER than the exported batch are accepted:
        inputs whose shape matches the exported shape everywhere except a
        smaller batch axis are zero-padded up to the exported batch, and
        outputs carrying the batch axis are sliced back to the request
        batch. Padding rows are inert at inference (BatchNorm uses
        running stats; per-row heads never mix rows), so real rows are
        untouched. Larger or otherwise-mismatched shapes still raise the
        MXPredCreate fixed-shape contract error."""
        if args and kwargs:
            raise ValueError("pass inputs positionally or by name, "
                             "not both")
        if kwargs:
            try:
                args = [kwargs.pop(n) for n in self._input_names]
            except KeyError as e:
                raise ValueError(f"missing input {e.args[0]!r}; expects "
                                 f"{self._input_names}")
            if kwargs:
                raise ValueError(f"unknown inputs {sorted(kwargs)}; "
                                 f"expects {self._input_names}")
        if len(args) != len(self._input_names):
            raise ValueError(f"expected {len(self._input_names)} inputs "
                             f"{self._input_names}, got {len(args)}")
        ax = self.batch_axis
        exp_batch = self.export_batch
        feed, req_batch = [], None
        for n, a in zip(self._input_names, args):
            a = np.asarray(getattr(a, "asnumpy", lambda: a)(), np.float32)
            want = self._input_shapes[n]
            got = tuple(a.shape)
            if got != want:
                padded_ok = (
                    len(got) == len(want) and len(got) > ax and
                    got[ax] < want[ax] and got[ax] >= 1 and
                    want[ax] == exp_batch and
                    got[:ax] + got[ax + 1:] == want[:ax] + want[ax + 1:])
                if not padded_ok:
                    raise ValueError(
                        f"input {n!r}: shape {got} does not match "
                        f"the exported shape {want} (shapes "
                        "are bound at export time, as in MXPredCreate)")
                if req_batch is None:
                    req_batch = got[ax]
                elif req_batch != got[ax]:
                    raise ValueError(
                        f"input {n!r}: request batch {got[ax]} disagrees "
                        f"with other inputs' batch {req_batch}")
                pad = [(0, 0)] * len(got)
                pad[ax] = (0, want[ax] - got[ax])
                a = np.pad(a, pad)
            feed.append(torch.from_numpy(np.ascontiguousarray(a))
                        .to(self._dev))
        outs = [o.cpu().numpy() for o in self._run(*feed)]
        if req_batch is not None:
            outs = [o[(slice(None),) * ax + (slice(0, req_batch),)]
                    if o.ndim > ax and o.shape[ax] == exp_batch else o
                    for o in outs]
        return outs


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.predictor",
        description="run an exported .mxa artifact on inputs from .npy "
                    "files")
    ap.add_argument("model", help=".mxa artifact (export_model)")
    ap.add_argument("inputs", nargs="*", help=".npy input per model input")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    pred = Predictor(args.model, device=args.device)
    print("inputs :", pred.input_info)
    print("outputs:", pred.output_shapes)
    if args.inputs:
        outs = pred.forward(*[np.load(p) for p in args.inputs])
        for name, o in zip(pred.output_names, outs):
            print(f"{name}: shape {o.shape} argmax "
                  f"{np.asarray(o).reshape(o.shape[0], -1).argmax(-1)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
