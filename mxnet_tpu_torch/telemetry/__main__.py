"""Telemetry selftest CLI (counterpart of mxnet_tpu/telemetry/__main__.py).

    python -m mxnet_tpu_torch.telemetry --selftest [--ctx cpu]

End-to-end proof of the observability stack, printing ONE JSON line:

  1. registry smoke: concurrent counter increments land exactly, the
     Prometheus render is well-formed;
  2. closed-loop scrape: a short Gluon ``fused_fit`` runs with the HTTP
     exporter up (checkpointing on, a ServingMetrics instance driven
     synthetically) and the process scrapes its own ``/metrics``: step
     histograms, serving, device_feed, checkpoint, amp and devstats
     series appear, and ``/healthz`` lists the subsystems;
  3. JSONL event log: ``MXNET_TELEMETRY_LOG`` captured run_start / step /
     run_end records with the documented fields;
  4. A/B: the same fit with ``MXNET_TELEMETRY=0`` gives bit-identical
     parameters, and the telemetry-on best wall time is within
     ``--max-overhead-pct`` (default 2%) of telemetry-off;
  5. watchdog: with a 0.4 s stall limit armed and beats stopped, the
     all-thread stack dump lands in the configured file and the
     ``mxnet_watchdog_stall_dumps_total`` counter ticks.

Exit code 0 iff all hold. The fit runs on the card unless ``--ctx cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time


def _registry_smoke():
    """8 threads x 10k increments on one counter must land exactly, and
    the render must carry the histogram's cumulative buckets."""
    from .registry import Registry
    reg = Registry(absorb_profiler=False)
    c = reg.counter("smoke_total")
    h = reg.histogram("smoke_seconds", buckets=(0.1, 1.0))
    threads = [threading.Thread(
        target=lambda: [c.inc() for _ in range(10000)])
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    text = reg.render_prometheus()
    return (c.value() == 80000
            and 'smoke_seconds_bucket{le="+Inf"} 3' in text
            and "smoke_total 80000" in text)


def _build_net(sample, ctx):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu"))
    net.add(gluon.nn.Dense(4))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net(sample)             # finish deferred init (shapes from the batch)
    return net


def _snap_params(net):
    import numpy as np
    return {n: np.asarray(p.data().asnumpy()).copy()
            for n, p in net.collect_params().items()}


def _set_params(net, snap, ctx):
    from mxnet_tpu_torch.ndarray.ndarray import array as nd_array
    for n, p in net.collect_params().items():
        p.set_data(nd_array(snap[n], ctx=ctx))


def _fit_once(net, data, ctx, ckpt_dir=None):
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.trainer import fused_fit
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    t0 = time.perf_counter()
    losses = fused_fit(net, loss, data, num_epoch=1, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05},
                       steps_per_dispatch=8, contexts=[ctx],
                       checkpoint_dir=ckpt_dir)
    return time.perf_counter() - t0, losses


def selftest(max_overhead_pct=2.0, batches=64, attempts=3, ctx_name="gpu"):
    import numpy as np
    import urllib.request
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray.ndarray import array as nd_array
    from . import start_server, watchdog
    from .registry import get_registry

    ctx = mx.gpu() if ctx_name == "gpu" else mx.cpu()
    results = {"metric": "telemetry_selftest", "ctx": ctx_name}
    results["registry_smoke"] = _registry_smoke()

    rng = np.random.RandomState(0)
    data = [(nd_array(rng.normal(size=(32, 8)).astype(np.float32), ctx=ctx),
             nd_array(rng.randint(0, 4, size=(32,)).astype(np.float32),
                      ctx=ctx))
            for _ in range(batches)]
    net = _build_net(data[0][0], ctx)
    init = _snap_params(net)

    # --- telemetry-on fit with exporter up, JSONL log, checkpointing ---
    srv = start_server(0)
    log_path = os.path.join(tempfile.mkdtemp(prefix="telemetry_"),
                            "steps.jsonl")
    os.environ["MXNET_TELEMETRY_LOG"] = log_path
    os.environ.pop("MXNET_TELEMETRY", None)
    try:
        with tempfile.TemporaryDirectory(prefix="telemetry_ckpt_") as ck:
            _set_params(net, init, ctx)
            _fit_once(net, data, ctx, ckpt_dir=ck)  # warm-up + counters
        params_on = _snap_params(net)
    finally:
        os.environ.pop("MXNET_TELEMETRY_LOG", None)

    # synthetic serving traffic: the registry path is a live
    # DynamicBatcher's (the same ServingMetrics methods) without an
    # exported artifact; python -m mxnet_tpu_torch.serving --selftest
    # covers the live closed loop
    from mxnet_tpu_torch.serving.metrics import ServingMetrics
    sm = ServingMetrics()
    for i in range(32):
        sm.record_submit()
        sm.record_queue_depth(i % 5)
        sm.record_done(0.002 + 0.0001 * i)
    sm.record_batch(8)
    sm.record_shed()
    mname = sm.name.replace("#", "_")

    body = urllib.request.urlopen(srv.url + "/metrics",
                                  timeout=10).read().decode()
    health = json.loads(urllib.request.urlopen(
        srv.url + "/healthz", timeout=10).read().decode())
    expect = ["mxnet_step_time_seconds_bucket",
              "mxnet_steps_total", "mxnet_samples_total",
              f"mxnet_{mname}_queue_depth",
              f"mxnet_{mname}_request_latency_seconds_bucket",
              f"mxnet_{mname}_completed",
              f"mxnet_{mname}_shed",
              "mxnet_device_feed_feed_batches",
              "mxnet_checkpoint_ckpt_commits",
              "mxnet_amp_amp_cast_bytes_saved",
              "mxnet_devstats_programs"]
    missing = [e for e in expect if e not in body]
    results["scrape_port"] = srv.port
    results["scrape_missing"] = missing
    results["scrape_ok"] = not missing
    results["healthz_ok"] = (health.get("status") == "ok"
                             and "checkpoint" in health.get(
                                 "subsystems", [])
                             and health.get("metrics", 0) > 0)
    # back-export: the registry's own metrics ride profiler.dump()'s
    # counter surface under the "telemetry" hook
    from mxnet_tpu_torch import profiler
    tele = profiler.export_counters().get("telemetry") or {}
    results["profiler_backexport_ok"] = "mxnet_steps_total" in tele

    # --- JSONL schema ---
    with open(log_path) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    events = [r.get("event") for r in recs]
    steps = [r for r in recs if r.get("event") == "step"]
    results["jsonl_records"] = len(recs)
    results["jsonl_ok"] = (
        "run_start" in events and "run_end" in events and steps != []
        and all(k in steps[0] for k in
                ("phase", "step", "wall_s", "samples", "loss",
                 "amp_scale", "feed_overlap_frac", "ckpt_save_us", "ts")))

    # --- A/B: bit-identical params, overhead within budget ---
    os.environ["MXNET_TELEMETRY"] = "0"
    try:
        _set_params(net, init, ctx)
        _fit_once(net, data, ctx)
        params_off = _snap_params(net)
    finally:
        os.environ.pop("MXNET_TELEMETRY", None)
    results["bit_identical"] = bool(
        set(params_on) == set(params_off)
        and all(np.array_equal(params_on[k], params_off[k])
                for k in params_on))

    # min-of-N per arm: the minimum estimates what the code costs when
    # nothing else interferes; medians of sub-second fits carry
    # scheduler jitter larger than the 2% budget
    overhead = None
    for attempt in range(attempts):
        t_on, t_off = [], []
        for _ in range(4):
            os.environ["MXNET_TELEMETRY"] = "0"
            _set_params(net, init, ctx)
            t_off.append(_fit_once(net, data, ctx)[0])
            os.environ.pop("MXNET_TELEMETRY", None)
            _set_params(net, init, ctx)
            t_on.append(_fit_once(net, data, ctx)[0])
        best_on, best_off = min(t_on), min(t_off)
        overhead = (best_on - best_off) / best_off * 100.0
        if overhead < max_overhead_pct:
            break
    results["fit_s_on"] = round(best_on, 4)
    results["fit_s_off"] = round(best_off, 4)
    results["overhead_pct"] = round(overhead, 3)
    results["overhead_ok"] = overhead < max_overhead_pct

    # --- watchdog: stall -> stack dump in the file, counter ticks ---
    dump_path = os.path.join(tempfile.mkdtemp(prefix="telemetry_wd_"),
                             "stall.txt")
    c = get_registry().counter("mxnet_watchdog_stall_dumps_total")
    before = c.value()
    watchdog.install(stall_s=0.4, path=dump_path)
    watchdog.beat("selftest")
    time.sleep(1.3)                 # no beats: the monitor must fire once
    watchdog.uninstall()
    try:
        with open(dump_path) as f:
            dump = f.read()
    except OSError:
        dump = ""
    results["watchdog_dump_ok"] = ("watchdog: step stalled" in dump
                                   and "Thread" in dump
                                   and c.value() == before + 1)

    ok = all(results[k] for k in
             ("registry_smoke", "scrape_ok", "healthz_ok",
              "profiler_backexport_ok", "jsonl_ok", "bit_identical",
              "overhead_ok", "watchdog_dump_ok"))
    results["ok"] = bool(ok)
    print(json.dumps(results), flush=True)
    print("TELEMETRY-SELFTEST-OK" if ok else "TELEMETRY-SELFTEST-FAIL",
          flush=True)
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mxnet_tpu_torch.telemetry")
    ap.add_argument("--selftest", action="store_true",
                    help="run the observability smoke checks")
    ap.add_argument("--ctx", default="gpu", choices=("gpu", "cpu"))
    ap.add_argument("--max-overhead-pct", type=float, default=2.0,
                    help="fail when the telemetry-on fit is this much "
                         "slower than telemetry-off (default 2%%)")
    ap.add_argument("--batches", type=int, default=64)
    args = ap.parse_args(argv)
    if not args.selftest:
        ap.print_help()
        return 2
    return selftest(max_overhead_pct=args.max_overhead_pct,
                    batches=args.batches, ctx_name=args.ctx)


if __name__ == "__main__":
    sys.exit(main())
