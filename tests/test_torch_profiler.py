"""mxnet_tpu_torch.profiler and .engine against the JAX package's
mxnet_tpu.profiler and .engine, on the CPU.

  - The same imperative ops and one symbolic forward and backward run in
    both packages with profiling on: the dumped chrome traces hold the
    same multiset of (name, cat, ph), and ``dumps(format="json")`` the
    same names and counts.
  - Domain / Task / Counter / Marker / Frame record the same events.
  - ``export_counters`` / ``dump()`` carry the registered hooks.
  - ``MXNET_PROFILER_AUTOSTART`` starts the profiler at startup, and
    ``MXNET_ENGINE_TYPE=NaiveEngine`` makes every imperative op wait for
    its device (the port: ``engine.sync_device`` after each op).
  - The kernel lane (``set_config(xplane_dir=...)``) writes a
    ``torch.profiler`` chrome trace naming the ops that ran.
Each test restores the profiler's state (stopped, empty, default
config) and the engine's type and bulk size.
"""
import collections
import json
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

PKGS = {"jax": jmx, "torch": tmx}


@pytest.fixture(autouse=True)
def _fresh_profilers():
    saved = {n: dict(mx.profiler._config) for n, mx in PKGS.items()}
    bulk = {n: mx.engine._bulk_size for n, mx in PKGS.items()}
    for mx in PKGS.values():
        mx.profiler.set_state("stop")
        mx.profiler.clear_events()
        mx.profiler.dumps(reset=True)
    yield
    for n, mx in PKGS.items():
        mx.profiler.set_state("stop")
        mx.profiler.resume()
        mx.profiler.clear_events()
        mx.profiler.dumps(reset=True)
        mx.profiler._config.clear()
        mx.profiler._config.update(saved[n])
        mx.engine.set_engine_type("ThreadedEnginePerDevice")
        mx.engine.set_bulk_size(bulk[n])


def _kw(mx):
    return {"ctx": tmx.cpu()} if mx is tmx else {}


def _workload(mx):
    """Imperative ops, then one symbolic forward and backward."""
    a = mx.nd.array(np.linspace(-1, 1, 64, dtype=np.float32)
                    .reshape(8, 8), **_kw(mx))
    b = mx.nd.dot(a, a)
    c = mx.nd.relu(b)
    d = mx.nd.sum(c, axis=1)
    e = mx.nd.exp(d * 0.01)
    e.wait_to_read()
    sym = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                                name="fc")
    ctx = tmx.cpu() if mx is tmx else jmx.cpu()
    ex = sym.simple_bind(ctx, data=(2, 8))
    ex.arg_dict["data"][:] = np.ones((2, 8), np.float32)
    ex.forward(is_train=True)
    ex.backward()
    return e.asnumpy()


def _profiled(mx, path):
    mx.profiler.set_config(filename=str(path), profile_all=True,
                           aggregate_stats=True)
    mx.profiler.set_state("run")
    out = _workload(mx)
    mx.profiler.set_state("stop")
    with open(mx.profiler.dump()) as f:
        trace = json.load(f)
    return out, trace, json.loads(mx.profiler.dumps(format="json"))


def test_op_and_executor_events_match_jax(tmp_path):
    got = {n: _profiled(mx, tmp_path / f"{n}.json")
           for n, mx in PKGS.items()}
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], rtol=1e-5)
    events = {n: collections.Counter(
        (e["name"], e.get("cat"), e["ph"]) for e in g[1]["traceEvents"])
        for n, g in got.items()}
    assert events["torch"] == events["jax"]
    assert ("Forward(fc)", "operator", "X") in events["torch"]
    assert ("Backward(fc)", "operator", "X") in events["torch"]
    assert ("dot", "operator", "X") in events["torch"]
    stats = {n: sorted((r["name"], r["count"]) for r in g[2])
             for n, g in got.items()}
    assert stats["torch"] == stats["jax"]
    for r in got["torch"][2]:
        assert 0 <= r["min_us"] <= r["avg_us"] <= r["max_us"]


def _objects(mx):
    p = mx.profiler
    p.set_state("run")
    dom = p.Domain("dom")
    with dom.new_task("task1"):
        pass
    frame = p.Frame(dom, "frame1")
    frame.start()
    frame.stop()
    cnt = dom.new_counter("cnt", 5)
    cnt.increment(3)
    cnt.decrement()
    dom.new_marker("mark").mark()
    p.pause()
    dom.new_marker("hidden").mark()          # paused: not recorded
    cnt.increment()
    p.resume()
    p.set_state("stop")
    return cnt.value, [
        (e["name"], e.get("cat"), e["ph"], sorted(e.get("args", {}).items()))
        for e in p.events_snapshot()]


def test_domain_task_counter_marker_frame_match_jax():
    got = {n: _objects(mx) for n, mx in PKGS.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 8
    names = [e[0] for e in got["torch"][1]]
    assert names == ["task1", "frame1", "cnt", "cnt", "cnt", "mark"]


def test_counter_exports_ride_dump(tmp_path):
    p = tmx.profiler
    p.register_counter_export("probe", lambda: {"hits": 3})
    p.register_counter_export("broken", lambda: 1 / 0)
    try:
        snap = p.export_counters()
        assert snap["probe"] == {"hits": 3}
        assert snap["broken"]["error"].startswith("ZeroDivisionError")
        assert p.export_counter("probe") == {"hits": 3}
        assert p.export_counter("absent") is None
        assert json.loads(p.export_counters(format="json"))["probe"] == \
            {"hits": 3}
        for hook in ("device_feed", "amp", "devstats"):
            assert hook in snap
        p.set_config(filename=str(tmp_path / "c.json"))
        with open(p.dump()) as f:
            trace = json.load(f)
        assert trace["counters"]["probe"] == {"hits": 3}
        assert trace["metadata"]["dropped_events"] == 0
        with pytest.raises(ValueError, match="callable"):
            p.register_counter_export("bad", 3)
        with pytest.raises(ValueError, match="unknown options"):
            p.set_config(nope=1)
    finally:
        p.unregister_counter_export("probe")
        p.unregister_counter_export("broken")


# startup effects other than the two under test stay off: another test
# may leave these in os.environ
_OTHER_STARTUP = ("MXNET_AMP", "MXNET_TELEMETRY_PORT", "MXNET_TRACE",
                  "MXNET_TELEMETRY_STALL_S", "MXNET_FLIGHTREC_DIR",
                  "MXNET_COMPILE_CACHE", "DMLC_NUM_WORKER")


def test_autostart_and_naive_engine(monkeypatch):
    for k in _OTHER_STARTUP:
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(tmx.engine, "sync_device",
                        lambda dev: calls.append(dev))
    monkeypatch.setenv("MXNET_PROFILER_AUTOSTART", "1")
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    for mx in PKGS.values():
        mx.config._apply_startup()
        assert mx.profiler.is_running()
        assert mx.engine._sync_mode
    a = tmx.nd.array(np.ones((4, 4), np.float32), ctx=tmx.cpu())
    tmx.nd.relu(tmx.nd.dot(a, a)).wait_to_read()
    assert [d.type for d in calls] == ["cpu", "cpu"]
    monkeypatch.setenv("MXNET_PROFILER_AUTOSTART", "0")
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice")
    for mx in PKGS.values():
        mx.config._apply_startup()
        assert not mx.engine._sync_mode
    calls.clear()
    tmx.nd.relu(a).wait_to_read()
    assert calls == []
    assert tmx.engine.set_bulk_size(4) == 15
    with tmx.engine.bulk(8):
        assert tmx.engine._bulk_size == 8
    assert tmx.engine._bulk_size == 4
    tmx.engine.waitall()


def test_kernel_lane_writes_a_torch_trace(tmp_path):
    p = tmx.profiler
    p.set_config(xplane_dir=str(tmp_path / "lane"),
                 filename=str(tmp_path / "ops.json"))
    p.set_state("run")
    a = tmx.nd.array(np.ones((16, 16), np.float32), ctx=tmx.cpu())
    tmx.nd.dot(a, a).wait_to_read()
    p.set_state("stop")
    session, path = p.kernel_profile()
    assert session is not None and os.path.dirname(path) == \
        str(tmp_path / "lane")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in session.key_averages())
