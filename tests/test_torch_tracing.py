"""mxnet_tpu_torch.telemetry's tracing, step log, flight recorder and
watchdog against the JAX package's mxnet_tpu.telemetry, on the CPU.

  - ``synth_shards`` with a fixed ``base_wall`` in each package: each
    package merges its own shards and the other's, and the merged events
    and ``format_summary`` text are equal across packages (torn and
    missing shards too).
  - span / traced / event / set_step semantics: nesting, per-thread
    stacks, the error name, trace ids, phase totals, the bounded ring.
  - ``MXNET_TRACE=0`` (with the flight recorder off) reads no clock.
  - The StepLogger's JSONL records of the same Module.fit (tracing on)
    have the same keys in both packages (``MXNET_DEVSTATS=0``: the JAX
    package's MFU fields come from XLA's cost analysis, which the port
    has not); tracing on or off, the fit is bit-identical.
  - Flight recorder record / snapshot / dump / tail, the excepthook dump
    with the flusher running (the box read back is whole and the crash's),
    and the watchdog's ``dump_now``, stall dump and ``dump_after``.
Every test restores what it installs (excepthook, SIGTERM and SIGUSR1
handlers, threads) and empties the rings.
"""
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.telemetry import tracing as jtr
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.telemetry import flightrec, tracing, watchdog

BASE_WALL = 1.7e9


@pytest.fixture(autouse=True)
def _clean_slate():
    hooks = (sys.excepthook, signal.getsignal(signal.SIGTERM))
    for mod in (tmx, jmx):
        mod.profiler.clear_events()
    flightrec.reset()
    tracing.reset_phase_totals()
    yield
    flightrec.uninstall()
    watchdog.uninstall()
    watchdog.cancel_deadline()
    profiler.set_max_events(200000)
    for mod in (tmx, jmx):
        mod.profiler.clear_events()
    flightrec.reset()
    tracing.reset_phase_totals()
    tracing.set_step(None, None)
    assert (sys.excepthook, signal.getsignal(signal.SIGTERM)) == hooks


def _trace_events():
    return [e for e in profiler.events_snapshot()
            if e.get("cat", "").startswith("trace:")]


# -- merge parity --------------------------------------------------------------

def _shards(tmp_path):
    kw = dict(ranks=6, steps=4, base_wall=BASE_WALL, quiet_rank=2,
              quiet_after_step=1, slow_rank=4)
    return {"torch": tracing.synth_shards(str(tmp_path / "torch"), **kw),
            "jax": jtr.synth_shards(str(tmp_path / "jax"), **kw)}


def _merged(mod, shards, out):
    path, summary = mod.merge(shards, out_path=out)
    with open(path) as f:
        return json.load(f), mod.format_summary(summary)


@pytest.mark.parametrize("source", ["torch", "jax"])
def test_merge_matches_jax_on_either_package_shards(source, tmp_path):
    shards = _shards(tmp_path)
    for a, b in zip(shards["torch"], shards["jax"]):
        with open(a) as fa, open(b) as fb:
            assert json.load(fa) == json.load(fb)
    ours = _merged(tracing, shards[source], str(tmp_path / "m_t.json"))
    ref = _merged(jtr, shards[source], str(tmp_path / "m_j.json"))
    assert ours == ref
    text = ours[1]
    assert "quiet first: rank 2" in text
    assert "slowest in  compute: rank 4" in text


def test_merge_reports_torn_and_missing_shards_as_jax(tmp_path):
    paths = tracing.synth_shards(str(tmp_path / "s"), ranks=4, steps=2,
                                 base_wall=BASE_WALL)
    os.remove(paths[1])
    with open(paths[3], "w") as f:
        f.write('{"traceEvents": [')
    ours = _merged(tracing, str(tmp_path / "s"), str(tmp_path / "a.json"))
    ref = _merged(jtr, str(tmp_path / "s"), str(tmp_path / "b.json"))
    assert ours == ref
    assert "MISSING: no shard for ranks [1]" in ours[1]
    assert "TORN: rank 3" in ours[1]
    with pytest.raises(FileNotFoundError):
        tracing.merge(str(tmp_path / "empty_dir_that_is_absent"))


# -- span semantics ------------------------------------------------------------

def test_span_traced_event_and_set_step(monkeypatch):
    monkeypatch.setenv("MXNET_TRACE", "1")
    seen = {}

    def worker():
        with tracing.span("outer.t2", phase="compute"):
            seen["t2"] = tracing.current_stack()

    @tracing.traced(name="deco", phase="ckpt")
    def deco():
        seen["deco"] = tracing.current_stack()

    tracing.set_step("tid0", 3)
    with tracing.span("outer", phase="compute", k=1):
        with tracing.span("inner", phase="feed"):
            seen["stack"] = tracing.current_stack()
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        deco()
    t0 = time.perf_counter()
    tracing.event("serve.queue", t0 - 0.002, phase="serve", rows=2)
    with pytest.raises(KeyError):
        with tracing.span("boom", phase="compute"):
            raise KeyError("x")
    assert seen == {"stack": ("outer", "inner"), "t2": ("outer.t2",),
                    "deco": ("outer", "deco")}
    assert tracing.current_stack() == ()
    by = {e["name"]: e for e in _trace_events()}
    assert set(by) == {"outer", "inner", "outer.t2", "deco", "serve.queue",
                       "boom"}
    outer, inner = by["outer"], by["inner"]
    assert outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1.0
    assert by["outer.t2"]["tid"] != outer["tid"]
    assert outer["cat"] == "trace:compute" and outer["ph"] == "X"
    assert outer["args"] == {"k": 1, "trace_id": "tid0", "step": 3}
    assert by["boom"]["args"]["error"] == "KeyError"
    assert by["serve.queue"]["dur"] >= 2000.0
    assert by["deco"]["cat"] == "trace:ckpt"
    totals, counts = tracing.phase_totals(), tracing.phase_counts()
    assert counts == {"compute": 3, "feed": 1, "ckpt": 1, "serve": 1}
    assert totals["serve"] >= 2000.0
    # the flight recorder saw the spans too
    assert {"outer", "inner", "serve.queue"} <= \
        {e["name"] for e in flightrec.snapshot()}


def test_ring_bound_and_drop_accounting(monkeypatch):
    monkeypatch.setenv("MXNET_TRACE", "1")
    profiler.set_max_events(32)
    for i in range(100):
        with tracing.span(f"burst{i}", phase="compute"):
            pass
    assert len(profiler.events_snapshot()) == 32
    assert profiler.dropped_events() == 68


class _NoClock:
    def perf_counter(self):
        raise AssertionError("a clock was read with tracing off")

    time = perf_counter


def test_trace_off_reads_no_clock(monkeypatch):
    monkeypatch.setenv("MXNET_TRACE", "0")
    monkeypatch.setenv("MXNET_FLIGHTREC", "0")
    monkeypatch.setattr(tracing, "time", _NoClock())
    assert tracing.span("ghost", phase="compute") is tracing._NULL
    with tracing.span("ghost", phase="compute"):
        pass
    tracing.event("ghost.event", 0.0, phase="serve")

    @tracing.traced(phase="compute")
    def f():
        return 5
    assert f() == 5
    assert _trace_events() == [] and flightrec.snapshot() == []
    assert tracing.dump() is None


def test_shard_dump_and_clock(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_TRACE", "1")
    with tracing.span("real.step", phase="compute"):
        pass
    assert tracing.exchange_clock() == 0.0
    with pytest.raises(NotImplementedError, match="dist.py"):
        tracing.exchange_clock(client=object())
    p = tracing.dump(path=str(tmp_path / "d" / "trace-rank-0.json"))
    with open(p) as f:
        shard = json.load(f)
    meta = shard["metadata"]
    assert meta["rank"] == 0 and meta["clock_skew_us"] == 0.0
    assert meta["phase_totals_us"]["compute"] > 0
    assert [e["name"] for e in shard["traceEvents"]][:3] == \
        ["process_name", "process_sort_index", "real.step"]
    assert not [n for n in os.listdir(tmp_path / "d") if ".tmp." in n]
    assert tracing._selftest() == 0


# -- the step log ----------------------------------------------------------------

def _mlp_sym(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, name="fc1", num_hidden=16)
    act1 = mx.sym.Activation(fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(act1, name="fc2", num_hidden=4)
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def _fit_log(mx, log, monkeypatch, trace="1"):
    monkeypatch.setenv("MXNET_TRACE", trace)
    monkeypatch.setenv("MXNET_DEVSTATS", "0")
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    monkeypatch.setenv("MXNET_TELEMETRY_LOG", str(log))
    mx.random.seed(7)
    np.random.seed(7)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (80, 8)).astype(np.float32)
    y = rng.randint(0, 4, (80,)).astype(np.float32)
    it = mx.io.NDArrayIter(x, y, batch_size=40, shuffle=False)
    ctx = tmx.cpu() if mx is tmx else jmx.cpu()
    mod = mx.mod.Module(_mlp_sym(mx), context=ctx)
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mx.init.Xavier())
    monkeypatch.delenv("MXNET_TELEMETRY_LOG")
    with open(log) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    args, _ = mod.get_params()
    return recs, {n: a.asnumpy() for n, a in args.items()}


def _same_step_log_state():
    """Make both packages' process-wide step-log state equal, whatever
    ran before in this process: a step record carries zero_* / embed_*
    keys once a ZeRO / embedding trainer of its package has registered
    that counter export, and mfu / roofline_frac / model_flops_per_s
    once devstats holds a step cost. Register both exports in both
    packages and forget both packages' step costs."""
    from mxnet_tpu.parallel import embedding as jembed, zero as jzero
    from mxnet_tpu.telemetry import devstats as jdev
    from mxnet_tpu_torch.parallel import embedding as tembed, zero as tzero
    from mxnet_tpu_torch.telemetry import devstats as tdev
    for mod in (jzero, tzero, jembed, tembed):
        mod._ensure_hook()
    jdev.reset()
    tdev.reset()


def test_step_log_keys_match_after_one_packages_embed_hook(monkeypatch,
                                                           tmp_path):
    """An earlier test that built only the port's embedding trainer (its
    "embed" export registered, the JAX package's not) leaves the keys
    comparable."""
    from mxnet_tpu_torch.parallel import embedding as tembed
    tembed._ensure_hook()
    _same_step_log_state()
    ours, _ = _fit_log(tmx, tmp_path / "t.jsonl", monkeypatch)
    ref, _ = _fit_log(jmx, tmp_path / "j.jsonl", monkeypatch)
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b), (a["event"], a, b)
    assert any("embed_wire_bytes" in r for r in ours)


def test_step_log_keys_match_jax_and_tracing_changes_nothing(
        monkeypatch, tmp_path):
    _same_step_log_state()
    ours, params = _fit_log(tmx, tmp_path / "t.jsonl", monkeypatch)
    ref, _ = _fit_log(jmx, tmp_path / "j.jsonl", monkeypatch)
    assert [r["event"] for r in ours] == [r["event"] for r in ref] == \
        ["run_start"] + ["step"] * 4 + ["run_end"]
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b), (a["event"], a, b)
    steps = [r for r in ours if r["event"] == "step"]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    assert all(r["samples"] == 40 and r["compute_us"] > 0 for r in steps)
    assert all(0.0 <= r["feed_compute_overlap_frac"] <= 1.0 for r in steps)
    _, off = _fit_log(tmx, tmp_path / "o.jsonl", monkeypatch, trace="0")
    for n in params:
        np.testing.assert_array_equal(params[n], off[n], err_msg=n)


def test_step_logger_breakdown_and_null_logger(monkeypatch, tmp_path):
    from mxnet_tpu_torch.telemetry import StepLogger, maybe_step_logger
    from mxnet_tpu_torch.telemetry.registry import get_registry
    log = tmp_path / "steps.jsonl"
    monkeypatch.setenv("MXNET_TRACE", "1")
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    monkeypatch.setenv("MXNET_TELEMETRY_LOG", str(log))
    slog = StepLogger("tracing_test")
    with tracing.span("feed.wait", phase="feed"):
        time.sleep(0.004)
    with tracing.span("step.fused_dispatch", phase="compute"):
        time.sleep(0.002)
    slog.step(samples=8, loss=0.5)
    slog.close()
    recs = [json.loads(line) for line in open(log)]
    (step,) = [r for r in recs if r["event"] == "step"]
    assert step["trace_id"] == slog.trace_id and step["loss"] == 0.5
    assert step["feed_us"] >= 3000 and step["compute_us"] >= 1500
    assert step["comm_us"] == step["ckpt_us"] == 0
    assert step["feed_compute_overlap_frac"] < 1.0
    g = get_registry().get("mxnet_trace_feed_compute_overlap_frac")
    assert g.value() == step["feed_compute_overlap_frac"]
    monkeypatch.setenv("MXNET_TELEMETRY", "0")
    null = maybe_step_logger("off")
    assert not isinstance(null, StepLogger)
    age = watchdog.last_beat_age()
    null.step(samples=1)
    assert watchdog.last_beat_age() is not None
    assert age is None or watchdog.last_beat_age() <= age
    assert tmx.telemetry.log_event("custom", x=1)
    assert json.loads(open(log).read().splitlines()[-1])["event"] == "custom"


# -- flight recorder ---------------------------------------------------------------

def test_flightrec_record_snapshot_dump_tail(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_FLIGHTREC", "1")
    for i in range(10):
        flightrec.record("event", f"beat{i}", step=i)
    flightrec.record("span", "ckpt.seal", dur_us=1234, step=7)
    assert len(flightrec.snapshot()) == 11
    assert [e["name"] for e in flightrec.snapshot(last_s=3600)][-1] == \
        "ckpt.seal"
    st = flightrec.stats()
    assert st["events"] == st["total"] == 11 and st["dropped"] == 0
    p = flightrec.dump(path=str(tmp_path / "fr.json"), reason="test")
    with open(p) as f:
        box = json.load(f)
    assert box["reason"] == "test" and len(box["events"]) == 11
    assert box["last_event_t"] == box["events"][-1]["t"]
    text = flightrec.tail_text()
    assert "beat9" in text and "1.234ms" in text
    monkeypatch.setenv("MXNET_FLIGHTREC", "0")
    flightrec.record("event", "hidden")
    assert len(flightrec.snapshot()) == 11
    assert flightrec.dump(path=str(tmp_path / "no.json")) is None


def test_flightrec_excepthook_dump_is_whole_beside_the_flusher(
        monkeypatch, tmp_path):
    """The flusher snapshots the ring every 10 ms while the excepthook
    dumps: each dump has a temporary file of its own and they take turns,
    so the box read back is whole JSON, and the flusher does not write a
    periodic box over the crash's."""
    monkeypatch.setenv("MXNET_FLIGHTREC", "1")
    monkeypatch.setenv("MXNET_FLIGHTREC_FLUSH_S", "0.01")
    seen = []
    monkeypatch.setattr(sys, "excepthook",
                        lambda *a: seen.append(a[0].__name__))
    assert flightrec.install(directory=str(tmp_path))
    box_path = tmp_path / "flightrec-rank-0.json"
    for i in range(50):
        flightrec.record("event", f"filler{i}", payload="x" * 200)
        time.sleep(0.001)
    flightrec.record("event", "last_breath")
    try:
        raise RuntimeError("simulated crash")
    except RuntimeError:
        sys.excepthook(*sys.exc_info())
    for _ in range(5):                     # the flusher keeps running
        time.sleep(0.02)
        box = json.loads(box_path.read_text(encoding="utf-8"))
        assert box["reason"].startswith("uncaught exception: RuntimeError")
    names = [e["name"] for e in box["events"]]
    assert "last_breath" in names and "uncaught:RuntimeError" in names
    assert seen == ["RuntimeError"]
    flightrec.uninstall()
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]


# -- watchdog ------------------------------------------------------------------------

def test_watchdog_dump_now_stall_and_deadline(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_FLIGHTREC", "1")
    flightrec.record("span", "ckpt.seal", dur_us=1234, step=7)
    out = tmp_path / "dump.txt"
    with open(out, "w") as f:
        header = watchdog.dump_now(reason="test-stall", file=f)
    text = out.read_text()
    assert "watchdog: test-stall" in header and header in text
    assert "flight recorder tail" in text and "ckpt.seal" in text
    assert "Thread" in text and "File" in text
    # a stall: beats stop, one dump lands in the file, the counter ticks
    from mxnet_tpu_torch.telemetry.registry import get_registry
    c = get_registry().counter("mxnet_watchdog_stall_dumps_total")
    before = c.value()
    stall = tmp_path / "stall.txt"
    watchdog.install(stall_s=0.2, path=str(stall), sigusr1=False)
    watchdog.beat("test loop")
    deadline = time.time() + 5
    while c.value() == before and time.time() < deadline:
        time.sleep(0.05)
    watchdog.uninstall()
    assert c.value() == before + 1
    assert "step stalled" in stall.read_text()
    assert "(test loop)" in stall.read_text()
    # a deadline dump fires without beats
    later = tmp_path / "later.txt"
    with open(later, "w") as f:
        watchdog.dump_after(1.0, file=f)
        time.sleep(1.4)
        watchdog.cancel_deadline()
    assert "File" in later.read_text()
