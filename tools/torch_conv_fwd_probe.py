#!/usr/bin/env python3
"""Where the port's float32 forward convolution loses precision on the
card, and what the float64 GEMM route (``ops.nn._fwd_route``) costs.

    python3 tools/torch_conv_fwd_probe.py          # needs a CUDA device

For each 3 x 3 convolution shape of SSD300-VGG16 (chip_smoke.py's
``ssd300_vgg16_symbol``, batch 32) and of ResNet-50 (batch 128): the
forward's largest error against float64 over the output's largest
magnitude at batch 2, on the host (oneDNN) and on the card through
cuDNN and through ``ops.nn._conv_fwd_gemm``; and the forward's device
ms at the full batch by each route (CUDA events, 5 calls after one).
Then SSD300's whole batch-2 forward (chip_smoke.py's check inputs), the
class probabilities' error against the host's float64 walk, with the
route as the port takes it, with every forward on cuDNN, and on the
host; and a Module training step (forward, backward, SGD update; median
of 4 after 1) of SSD300 at batch 32 and of ResNet-50 v1 at batch 128,
float32, with the route and with every forward on cuDNN, in this one
process. One JSON line a shape, then one for the whole forward, then
one for the steps; prints nothing and exits 2 without a card.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, batch, C_in, C_out, map side, stride, pad, dilation)
SHAPES = (
    ("ssd_conv1_2", 32, 64, 64, 300, 1, 1, 1),
    ("ssd_conv2_2", 32, 128, 128, 150, 1, 1, 1),
    ("ssd_conv3_2", 32, 256, 256, 75, 1, 1, 1),
    ("ssd_conv4_2", 32, 512, 512, 38, 1, 1, 1),
    ("ssd_conv5_1", 32, 512, 512, 19, 1, 1, 1),
    ("ssd_fc6", 32, 512, 1024, 19, 1, 6, 6),
    ("ssd_extra2_3x3", 32, 256, 512, 19, 2, 1, 1),
    ("ssd_head0_cls", 32, 512, 84, 38, 1, 1, 1),
    ("ssd_head1_cls", 32, 1024, 126, 19, 1, 1, 1),
    ("r50_3x3_56", 128, 64, 64, 56, 1, 1, 1),
    ("r50_3x3_28", 128, 128, 128, 28, 1, 1, 1),
    ("r50_3x3_14", 128, 256, 256, 14, 1, 1, 1),
    ("r50_3x3_7", 128, 512, 512, 7, 1, 1, 1),
)


def _err(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def _timed(fn, iters=5):
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def shape_rows():
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import nn
    for name, n, ci, co, side, s, p, d in SHAPES:
        g = torch.Generator().manual_seed(0)
        x = torch.rand(n, ci, side, side, generator=g)
        w = torch.randn(co, ci, 3, 3, generator=g) * (2.0 / (ci * 9)) ** .5
        st, pd, dl = (s, s), (p, p), (d, d)
        ref = F.conv2d(x[:2].double(), w.double(), None, st, pd, dl)
        row = {"shape": name, "batch": n, "K": ci * 9,
               "route": "gemm" if nn._fwd_gemm_shape(
                   x.shape, w.shape, 1, (s, s), (p, p), (d, d)) else "cudnn",
               "host_err": _err(F.conv2d(x[:2], w, None, st, pd, dl), ref)}
        xc, wc = x.cuda(), w.cuda()
        with nn.cudnn_f32():
            row["cudnn_err"] = _err(F.conv2d(xc[:2], wc, None, st, pd,
                                             dl).cpu(), ref)
            row["gemm64_err"] = _err(nn._conv_fwd_gemm(
                xc[:2], wc, None, st, pd, dl).cpu(), ref)
            row["cudnn_ms"] = _timed(lambda: F.conv2d(xc, wc, None, st, pd,
                                                      dl))
            row["gemm64_ms"] = _timed(lambda: nn._conv_fwd_gemm(
                xc, wc, None, st, pd, dl))
        print(json.dumps(row), flush=True)
        del x, xc, wc
        torch.cuda.empty_cache()


def whole_forward():
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import nn
    with mx.NameManager():
        sym = cs.ssd300_vgg16_symbol(mx.sym)
    xb, yb = cs.synthetic_detection(cs.SSD_CHECK_BATCH, seed=cs.SEED + 1)
    shapes, _, _ = sym.infer_shape(data=xb.shape, label=yb.shape)
    params = cs._ssd_params(dict(zip(sym.list_arguments(), shapes)))
    host = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in params.items()}

    def run(ctx, dt):
        ex = sym.simple_bind(ctx=ctx, data=xb.shape, label=yb.shape,
                             type_dict={k: dt for k in
                                        sym.list_arguments()})
        ex.copy_params_from(host, {})
        ex.forward(is_train=True, data=mx.nd.array(xb, ctx=mx.cpu()),
                   label=mx.nd.array(yb, ctx=mx.cpu()))
        return torch.tensor(ex.outputs[0].asnumpy().astype(np.float64))

    ref = run(mx.cpu(), "float64")
    out = {"ssd300_forward_batch": int(xb.shape[0]),
           "host_err": _err(run(mx.cpu(), "float32"), ref),
           "card_routed_err": _err(run(mx.gpu(0), "float32"), ref)}
    route = nn._fwd_route
    nn._fwd_route = lambda *args: "cudnn"
    try:
        out["card_cudnn_err"] = _err(run(mx.gpu(0), "float32"), ref)
    finally:
        nn._fwd_route = route
    print(json.dumps(out), flush=True)


def _module_step_ms(mx, sym, dshape, lname, label, params=None):
    import time
    import numpy as np
    import torch
    mod = mx.mod.Module(sym, data_names=("data",), label_names=(lname,),
                        context=mx.gpu(0))
    mod.bind(data_shapes=[("data", dshape)],
             label_shapes=[(lname, label.shape)])
    if params is None:
        mod.init_params(mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2))
    else:
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in params.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.001, "momentum": 0.9})
    x = np.random.RandomState(0).uniform(-1, 1, dshape).astype(np.float32)
    batch = mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())],
                            [mx.nd.array(label, ctx=mx.cpu())])
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    del mod
    torch.cuda.empty_cache()
    return float(np.median(times[1:]))


def steps():
    import numpy as np
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import nn
    with mx.NameManager():
        ssd = cs.ssd300_vgg16_symbol(mx.sym)
    with mx.NameManager():
        r50 = cs.resnet_v1_symbol(mx.sym)
    _, y = cs.synthetic_detection(32, seed=cs.SEED)
    shapes, _, _ = ssd.infer_shape(data=(32, 3, 300, 300), label=y.shape)
    params = cs._ssd_params(dict(zip(ssd.list_arguments(), shapes)))
    labels = np.random.RandomState(0).randint(0, 1000, 128) \
        .astype(np.float32)
    out = {}
    route = nn._fwd_route
    for tag in ("routed", "cudnn", "routed_again"):
        if tag == "cudnn":
            nn._fwd_route = lambda *args: "cudnn"
        try:
            out["ssd300_b32_" + tag + "_ms"] = _module_step_ms(
                mx, ssd, (32, 3, 300, 300), "label", y, params)
            out["r50_b128_" + tag + "_ms"] = _module_step_ms(
                mx, r50, (128, 3, 224, 224), "softmax_label", labels)
        finally:
            nn._fwd_route = route
    print(json.dumps(out), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_conv_fwd_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    shape_rows()
    whole_forward()
    steps()
    return 0


if __name__ == "__main__":
    sys.exit(main())
