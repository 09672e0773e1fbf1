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

* ``--sweep``: the float32 weight gradient of one convolution over the
  shapes the ported models and tests use (input channels 1, 2, 3, 4, 8
  and 64; kernels 1, 3, 5 and 7; strides 1 and 2; LeNet's batches 8 and
  64 at 28 x 28 with 20 filters, ResNet-50's batches 2 and 128 at 56 x 56
  with 64 filters, plus ResNet-50's stem, 3 -> 64, 7 x 7 / 2 at 224 x 224)
  against float64 on the card, by route: ``cudnn`` (cuDNN's heuristic,
  no TF32), ``cudnn_off`` (PyTorch's own convolution), ``gemm``
  (``ops.nn._conv_wgrad_gemm``) and ``port`` (``_Conv.backward`` as the
  port routes it), each with its device time (CUDA events). One JSON
  line a shape into ``chiprun_out/f32_wgrad_sweep.jsonl``; the shapes
  whose cuDNN error passes 1e-5 printed. ``--sweep-resnet50``: the same
  for ResNet-50's 3 x 3 stride-1 convolutions (64, 128, 256 and 512
  channels at 56, 28, 14 and 7) at batches 2 and 128, into
  ``chiprun_out/f32_wgrad_sweep_resnet50.jsonl``.
* ``--route-ab``: ``chip_smoke.py``'s ``module_lenet`` and
  ``module_resnet50`` phases with the weight-gradient route as given
  (``ops.nn._WGRAD_GEMM_KERNELS``), then with 3 x 3 and 5 x 5 routed and
  with none, in the order A B C C B A, and LeNet's step through
  ``Module.forward_backward`` + ``update`` at batch 64: its wall time
  (synchronised each step) and its device time (``torch.profiler``).

Run from the repository root on a machine with a CUDA card:
``python3 tools/torch_f32_witness.py [--sweep]``.
"""
import contextlib
import json
import os
import sys
import time

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


SWEEP_CIN = (1, 2, 3, 4, 8, 64)
SWEEP_KERNELS = (1, 3, 5, 7)
SWEEP_STRIDES = (1, 2)
# (batch, spatial size, filters): LeNet's batches, then ResNet-50's
SWEEP_BATCHES = ((8, 28, 20), (64, 28, 20), (2, 56, 64), (128, 56, 64))
SWEEP_REPORT = 1e-5


def _wgrad(route, dy, x, w, stride, pad):
    from mxnet_tpu_torch.ops import nn as nnops
    if route == "gemm":
        with nnops.cudnn_f32():
            return nnops._conv_wgrad_gemm(dy, x, w.shape, stride, pad,
                                          (1, 1))
    if route == "port":
        wl = w.detach().requires_grad_(True)
        y = nnops._Conv.apply(x, wl, None, stride, pad, (1, 1), 1, False)
        return torch.autograd.grad(y, wl, dy)[0]
    cd = torch.backends.cudnn
    old = cd.enabled
    cd.enabled = route != "cudnn_off"
    try:
        with nnops.cudnn_f32():
            return torch.ops.aten.convolution_backward(
                dy, x, w, None, list(stride), list(pad), [1, 1], False,
                [0, 0], 1, [False, True, False])[1]
    finally:
        cd.enabled = old


def _event_ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(iters):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / iters


def _sweep_shapes():
    for n, hw, co in SWEEP_BATCHES:
        for ci in SWEEP_CIN:
            for k in SWEEP_KERNELS:
                for s in SWEEP_STRIDES:
                    yield n, ci, co, hw, k, s
    for n in (2, 128):
        yield n, 3, 64, 224, 7, 2


def _resnet50_shapes():
    for n in (2, 128):
        for c, hw in ((64, 56), (128, 28), (256, 14), (512, 7)):
            yield n, c, c, hw, 3, 1


def sweep(shapes=None, name="f32_wgrad_sweep.jsonl"):
    gen = torch.Generator(device="cuda").manual_seed(0)
    path = os.path.join(ROOT, "chiprun_out", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lossy = []
    with open(path, "w") as f:
        for n, ci, co, hw, k, s in shapes or _sweep_shapes():
            pad = (k // 2, k // 2)
            x = torch.rand(n, ci, hw, hw, device="cuda", generator=gen)
            w = torch.randn(co, ci, k, k, device="cuda", generator=gen)
            ho = (hw + 2 * pad[0] - k) // s + 1
            dy = torch.randn(n, co, ho, ho, device="cuda", generator=gen)
            ref = _wgrad("cudnn", dy.double(), x.double(), w.double(),
                         (s, s), pad).cpu()
            row = {"batch": n, "c_in": ci, "c_out": co, "hw": hw,
                   "kernel": k, "stride": s}
            for route in ("cudnn", "cudnn_off", "gemm", "port"):
                got = _wgrad(route, dy, x, w, (s, s), pad)
                row[route + "_err"] = cs._rel_err(got.cpu(), ref)
                row[route + "_ms"] = _event_ms(
                    lambda: _wgrad(route, dy, x, w, (s, s), pad))
            f.write(json.dumps(row) + "\n")
            if row["cudnn_err"] > SWEEP_REPORT:
                lossy.append(row)
            del x, w, dy, ref
            torch.cuda.empty_cache()
    print(json.dumps({"sweep": path, "report_above": SWEEP_REPORT,
                      "lossy": lossy}), flush=True)


def _lenet_step_costs(steps=50):
    """LeNet's per-batch step through Module on the card: wall ms a step
    (synchronised) and device ms a step (the profiler's sum)."""
    from torch.profiler import ProfilerActivity, profile
    x, y = cs.synthetic_mnist(cs.LENET_N, cs.SEED)
    b = cs.LENET_BATCH
    batch = mx.io.DataBatch([mx.nd.array(x[:b], ctx=mx.cpu())],
                            [mx.nd.array(y[:b], ctx=mx.cpu())])
    with mx.NameManager():
        mod = mx.mod.Module(cs.lenet_symbol(mx.sym), context=mx.gpu(0))
    mod.bind(data_shapes=[("data", (b, 1, 28, 28))],
             label_shapes=[("softmax_label", (b,))])
    mx.random.seed(cs.SEED)
    mod.init_params(mx.init.Uniform(0.01))
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": cs.LENET_LR, "momentum": 0.9,
        "rescale_grad": 1.0 / b})
    walls = []
    for i in range(steps + 5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        if i >= 5:
            walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
    rows = cs._device_rows(prof, 1)
    return {"wall_ms_median": float(np.median(walls)),
            "wall_ms_min": min(walls),
            "device_ms": sum(r[1] for r in rows),
            "kernels": sum(r[2] for r in rows),
            "top": [[k[:80], t, c] for k, t, c in rows[:6]]}


def route_ab():
    from mxnet_tpu_torch.ops import nn as nnops
    routes = {"as_given": nnops._WGRAD_GEMM_KERNELS,
              "3x3_and_5x5": ((3, 3), (5, 5)), "none": ()}
    order = ("as_given", "3x3_and_5x5", "none", "none", "3x3_and_5x5",
             "as_given")
    keep = nnops._WGRAD_GEMM_KERNELS
    try:
        for tag in order:
            nnops._WGRAD_GEMM_KERNELS = routes[tag]
            row = {"route": tag, "kernels": routes[tag]}
            for ph in (cs.phase_module_lenet, cs.phase_module_resnet50):
                try:
                    r = ph()
                except AssertionError as e:
                    r = {"failed": str(e)[:600]}
                row[ph.__name__] = {k: r.get(k) for k in (
                    "fit_s", "epoch_s", "val_accuracy", "check_max_rel_err",
                    "img_per_s", "step_ms", "step_ms_each",
                    "device_ms_per_step", "host_enqueue_ms",
                    "host_step_ms_batch2", "failed")}
            row["lenet_step"] = _lenet_step_costs()
            print(json.dumps(row), flush=True)
            cs._free_card()
    finally:
        nnops._WGRAD_GEMM_KERNELS = keep


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi(),
                      "torch": torch.__version__,
                      "cudnn": torch.backends.cudnn.version()}), flush=True)
    argv = sys.argv[1:]
    if "--sweep" in argv:
        sweep()
    if "--sweep-resnet50" in argv:
        sweep(list(_resnet50_shapes()), "f32_wgrad_sweep_resnet50.jsonl")
    if "--route-ab" in argv:
        route_ab()
    if argv:
        return
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
