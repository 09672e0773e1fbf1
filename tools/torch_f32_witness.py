"""Where a float32 training step of the PyTorch port loses precision.

Runs one training step (forward and backward) of two symbols through the
port's executor and prints, one JSON object a line, each step's errors
against the same step in float64 on the CPU: the largest element error
of each tensor over its largest magnitude, and the median and largest
norm-wise error over the tensors.

* LeNet with a BatchNorm + ReLU pair at batch 8, on the inputs of
  ``tests/test_torch_kernels_cuda.py::test_executor_on_the_card_matches_
  the_cpu``; ResNet-50 v1 at batch 2, 224², on the inputs of
  ``chip_smoke.py``'s batch-2 check.
* Steps: float32 on the CPU at one thread and at four (and one against
  the other), and float32 on the card in three modes: ``port`` (as the
  port runs it: cuDNN without TF32), ``cudnn_off`` (PyTorch's own
  convolutions), ``tf32`` (the port's per-call guard off and TF32
  allowed in cuDNN and cuBLAS).

Run from the repository root on a machine with a CUDA card:
``python3 tools/torch_f32_witness.py``.
"""
import contextlib
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import chip_smoke as cs  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402
from test_torch_kernels_cuda import _lenet_symbol  # noqa: E402


@contextlib.contextmanager
def _mode(mode):
    cd = torch.backends.cudnn
    old = cd.enabled
    if mode == "cudnn_off":
        cd.enabled = False
    try:
        with (cs._tf32_everywhere() if mode == "tf32"
              else contextlib.nullcontext()):
            yield
    finally:
        cd.enabled = old


def _step(sym, shape, args, aux, ctx, dtype, mode="port"):
    with _mode(mode):
        ex = sym.simple_bind(ctx=ctx, data=shape, type_dict={
            n: dtype for n in sym.list_arguments()})
        for a in ex.aux_dict.values():
            a._data = a._data.to(torch.float64 if dtype == "float64"
                                 else torch.float32)
        ex.copy_params_from(args, aux)
        ex.forward(is_train=True,
                   data=mx.nd.array(args["data"], ctx=mx.cpu()),
                   softmax_label=mx.nd.array(args["softmax_label"],
                                             ctx=mx.cpu()))
        ex.backward()
        if ctx.device_type == "gpu":
            torch.cuda.synchronize()
    out = {"output": ex.outputs[0]}
    out.update({"grad:" + n: g for n, g in ex.grad_dict.items()
                if n not in ("data", "softmax_label")})
    return {k: v.asnumpy().astype(np.float64) for k, v in out.items()}


def _errors(got, ref):
    elem = {k: cs._rel_err(got[k], v) for k, v in ref.items()}
    norm = [float(np.linalg.norm(got[k] - v) / max(1e-30, np.linalg.norm(v)))
            for k, v in ref.items()]
    return {"max_elem": max(elem.values()),
            "worst": sorted(elem.items(), key=lambda kv: -kv[1])[:3],
            "output": elem["output"],
            "norm_median": float(np.median(norm)), "norm_max": max(norm)}


def _cpu32(sym, shape, args, aux, threads):
    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return _step(sym, shape, args, aux, mx.cpu(), "float32")
    finally:
        torch.set_num_threads(old)


def _witness(name, sym, shape, args, aux):
    ref = _step(sym, shape, args, aux, mx.cpu(), "float64")
    one, four = (_cpu32(sym, shape, args, aux, n) for n in (1, 4))
    rows = [("cpu32_1_thread", _errors(one, ref)),
            ("cpu32_4_threads", _errors(four, ref)),
            ("cpu32_1_vs_4_threads", _errors(one, four))]
    for mode in ("port", "cudnn_off", "tf32"):
        rows.append(("card32_" + mode, _errors(
            _step(sym, shape, args, aux, mx.gpu(0), "float32", mode), ref)))
    for step, errs in rows:
        print(json.dumps({"symbol": name, "step": step, **errs}), flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "torch": torch.__version__,
                      "cudnn": torch.backends.cudnn.version()}), flush=True)
    sym = _lenet_symbol(mx)
    rng = np.random.RandomState(0)
    shape = (8, 1, 28, 28)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    args = {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    args["softmax_label"] = rng.randint(0, 10, shape[0]).astype(np.float32)
    aux = {n: np.ones(s, np.float32) for n, s in
           zip(sym.list_auxiliary_states(), aux_shapes)}
    _witness("lenet_bn", sym, shape, args, aux)

    with mx.NameManager():
        sym = cs.resnet_v1_symbol(mx.sym)
    shape = (cs.R50_CHECK_BATCH, 3, cs.R50_IMG, cs.R50_IMG)
    rng = np.random.RandomState(cs.SEED)
    host = sym.simple_bind(ctx=mx.cpu(), data=shape)
    cs._init_bound(host, mx, cs.SEED)
    args = {n: a.asnumpy() for n, a in host.arg_dict.items()}
    args["data"] = rng.uniform(0, 1, shape).astype(np.float32)
    args["softmax_label"] = rng.randint(0, 1000, shape[0]).astype(
        np.float32)
    aux = {n: a.asnumpy() for n, a in host.aux_dict.items()}
    _witness("resnet50_v1", sym, shape, args, aux)


if __name__ == "__main__":
    main()
