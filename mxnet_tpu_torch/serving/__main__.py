"""Serving CLI + selftest load generator (counterpart of
mxnet_tpu/serving/__main__.py).

    python -m mxnet_tpu_torch.serving model.mxa --selftest
    python -m mxnet_tpu_torch.serving --selftest      # built-in tiny convnet
    python -m mxnet_tpu_torch.serving --selftest --device cpu

The selftest runs a closed-loop load generator (C client threads, each
issuing single-row requests back-to-back) through the DynamicBatcher and
times the same request stream through the raw single-request Predictor
loop, in alternating rounds (medians compared), then prints ONE JSON
line:

    {"metric": "serving_selftest", "batched_qps": ..., "sequential_qps":
     ..., "speedup": ..., "p50_ms": ..., "p99_ms": ..., "batch_hist": ...}

and exits non-zero when the batched speedup misses --min-speedup
(default 2.0 — the acceptance bar; micro-batching onto the export batch
should beat pad-to-full single-request serving by far more).

Uses stdlib + numpy only on the client side; the built-in model export
path imports mxnet_tpu_torch lazily (pass an existing .mxa to skip it).
The engine and the predictor run on the card unless ``--device cpu``.
The scrape checks the registry's native series (queue depth, the
latency histogram, plan bytes) and the snapshot fields the metrics'
profiler hook exports (completed, qps, p50 / p99, shed), as the JAX
package's does.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time

import numpy as np

# sequential + batched rounds a selftest (the loops of one round last
# tens of milliseconds on the host, so one round's ratio is noisy)
_ROUNDS = 5

def _export_tiny_convnet(batch=8):
    """Train-free tiny convnet -> .mxa in a temp dir (the ci smoke
    model; Xavier init is enough — serving cares about shapes, not
    weights)."""
    import os
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib.export import export_model

    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8, name="c1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Pooling(net, pool_type="max", kernel=(2, 2),
                         stride=(2, 2))
    net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=10,
                                name="fc")
    sym = mx.sym.SoftmaxOutput(net, name="softmax")
    shapes = (batch, 3, 16, 16)
    mod = mx.mod.Module(sym, context=mx.cpu(0))
    mod.bind(data_shapes=[("data", shapes)],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(mx.init.Xavier())
    args, auxs = mod.get_params()
    path = os.path.join(tempfile.mkdtemp(prefix="mxa_selftest_"),
                        "model.mxa")
    export_model(path, sym, args, auxs, {"data": shapes})
    return path


def _sequential_qps(pred, sample, requests):
    """Baseline: the pre-serving deployment story — one Predictor, one
    request per forward (padded to the export batch, as any fixed-shape
    artifact must)."""
    t0 = time.perf_counter()
    for _ in range(requests):
        pred.forward(sample)
    return requests / (time.perf_counter() - t0)


def _batched_qps(batcher, sample, requests, concurrency):
    """Closed-loop load gen: C threads, each issuing single-row
    requests back-to-back until the shared budget is spent."""
    remaining = [requests]
    lock = threading.Lock()
    errors = []
    start = threading.Barrier(concurrency + 1)

    def client():
        start.wait()
        while True:
            with lock:
                if remaining[0] <= 0:
                    return
                remaining[0] -= 1
            try:
                batcher.infer(sample, timeout_ms=30000)
            except Exception as e:               # pragma: no cover
                with lock:
                    errors.append(repr(e))
                return

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(concurrency)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"load generator hit errors: {errors[:3]}")
    return requests / dt


def selftest(path=None, requests=256, concurrency=8, max_wait_us=2000,
             queue_depth=256, min_speedup=2.0, device=None):
    """Run the sequential-vs-batched comparison: _ROUNDS rounds, each the
    sequential loop then the batched one, so both meet the same machine
    load; the speedup is the ratio of their medians. Returns the result
    dict."""
    from . import DynamicBatcher, ServingEngine
    from ..predictor import Predictor
    if path is None:
        path = _export_tiny_convnet()
    eng = ServingEngine(path, device=device)     # builds its plan
    shape = tuple(eng._pred._input_shapes[eng.input_names[0]])
    sample = np.random.RandomState(0) \
        .uniform(0, 1, (1,) + shape[1:]).astype(np.float32)
    pred = Predictor(path, device=device)
    pred.forward(sample)                         # warm the program
    seq, bat = [], []
    with DynamicBatcher(eng, max_wait_us=max_wait_us,
                        queue_depth=queue_depth) as batcher:
        for _ in range(_ROUNDS):
            seq.append(_sequential_qps(pred, sample, min(requests, 64)))
            bat.append(_batched_qps(batcher, sample, requests,
                                    concurrency))
        snap = batcher.metrics.snapshot()
        # closed-loop observability check: scrape our own /metrics while
        # the batcher is still live and confirm the serving counters made
        # it through the registry -> Prometheus path
        scrape = _self_scrape(batcher.metrics.name)
    seq_qps, bat_qps = float(np.median(seq)), float(np.median(bat))
    speedup = bat_qps / seq_qps if seq_qps else float("inf")
    return {
        "metric": "serving_selftest",
        "model": path,
        "device": str(eng.device),
        "requests": requests,
        "rounds": _ROUNDS,
        "concurrency": concurrency,
        "max_batch": eng.max_batch,
        "buckets": eng.buckets,
        "max_wait_us": max_wait_us,
        "batched_qps": round(bat_qps, 2),
        "sequential_qps": round(seq_qps, 2),
        "speedup": round(speedup, 2),
        "p50_ms": snap["p50_ms"],
        "p99_ms": snap["p99_ms"],
        "avg_batch_rows": snap["avg_batch_rows"],
        "batch_hist": snap["batch_hist"],
        "shed": snap["shed"],
        "timeouts": snap["timeouts"],
        "telemetry_port": scrape["port"],
        "telemetry_scrape_ok": scrape["ok"],
        "ok": speedup >= min_speedup and scrape["ok"],
    }


def _self_scrape(metrics_name):
    """Start (or reuse) the telemetry exporter, GET /metrics, and verify
    this batcher's completed/qps/p50/p99/shed counters are present in
    Prometheus text form. Returns {"port", "ok", "missing"}."""
    import urllib.request
    from ..telemetry import start_server
    mname = metrics_name.replace("#", "_")
    expect = [f"mxnet_{mname}_{k}" for k in
              ("completed", "qps", "p50_ms", "p99_ms", "shed",
               "queue_depth", "plan_resident_bytes")] + \
             [f"mxnet_{mname}_request_latency_seconds_bucket"]
    try:
        srv = start_server()
        body = urllib.request.urlopen(srv.url + "/metrics",
                                      timeout=10).read().decode()
        missing = [e for e in expect if e not in body]
        return {"port": srv.port, "ok": not missing, "missing": missing}
    except Exception as e:                       # pragma: no cover
        return {"port": None, "ok": False, "missing": [repr(e)]}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.serving",
        description="serve / selftest an exported .mxa artifact")
    ap.add_argument("model", nargs="?", default=None,
                    help=".mxa artifact (selftest exports a tiny "
                         "convnet when omitted)")
    ap.add_argument("--selftest", action="store_true",
                    help="closed-loop load test; print one perf JSON "
                         "line")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--max-wait-us", type=int, default=2000)
    ap.add_argument("--queue-depth", type=int, default=256)
    ap.add_argument("--min-speedup", type=float, default=2.0,
                    help="exit non-zero when batched/sequential falls "
                         "below this (default 2.0)")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    if not args.selftest:
        ap.error("only --selftest mode is implemented; a network "
                 "frontend is python -m mxnet_tpu_torch.serving.frontend")
    res = selftest(args.model, requests=args.requests,
                   concurrency=args.concurrency,
                   max_wait_us=args.max_wait_us,
                   queue_depth=args.queue_depth,
                   min_speedup=args.min_speedup, device=args.device)
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
