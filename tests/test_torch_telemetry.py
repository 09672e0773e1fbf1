"""mxnet_tpu_torch.telemetry (registry, exporter) against the JAX
package's mxnet_tpu.telemetry.

One script of operations is applied to the port's and the JAX package's
``Registry(absorb_profiler=False)`` (each package's profiler hooks are
its own); the two must render the same Prometheus text and the same
snapshot. A registry that absorbs renders the port's profiler hooks
after its own metrics. The exporter is scraped on an ephemeral port on
localhost. The decode engines of both packages, given the same
submissions, must leave the same values in their registry series.
"""
import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest

from mxnet_tpu.serving import decode as JD
from mxnet_tpu.telemetry import registry as JR
from mxnet_tpu_torch.serving.decode import DecodeEngine, DecodeModel
from mxnet_tpu_torch.telemetry import exporter as TE, registry as TR

SCRIPTS = {
    "counters": [("counter", "req_total", "requests", None, None, 3),
                 ("counter", "req_total", "requests", None, None, 2),
                 ("counter", "bytes_total", "", {"dev": "0"}, None, 7)],
    "gauges_series": [
        ("gauge", "occ", "occupancy", {"engine": "a"}, "a", ("set", 3)),
        ("gauge", "occ", "occupancy", {"engine": "b"}, "b", ("set", 1.5)),
        ("gauge", "occ", "occupancy", {"engine": "a"}, "a", ("inc", 2)),
        ("gauge", "occ", "occupancy", {"engine": "b"}, "b", ("dec", 0.25)),
        ("gauge", "temp", "", None, None, ("set", -1e-7))],
    "histograms": [
        ("histogram", "lat_s", "latency", None, None, None,
         [0.0003, 0.002, 0.002, 0.7, 200.0]),
        ("histogram", "sz", "sizes", {"k": "v"}, None, (1, 10, 100),
         [0, 1, 5, 50, 500, 1e6])],
    "constant_labels": [
        ("const", {"rank": "1", "host": "h0"}),
        ("counter", "steps_total", "steps", {"engine": "x"}, "x", 4),
        ("histogram", "step_s", "", {"engine": "x"}, "x", None,
         [0.01, 0.02])],
    "escapes_and_names": [
        ("counter", "9bad-name.total", 'help "q"', {"p a": 'v"\\'}, None, 1),
        ("gauge", "nan_gauge", "", None, None, ("set", float("nan"))),
        ("gauge", "inf_gauge", "", None, None, ("set", float("inf"))),
        ("gauge", "big", "", None, None, ("set", 1e20))],
    "decode_engine_shape": [
        ("counter", "mxnet_decode_tokens_total", "greedy tokens",
         {"engine": "e1"}, "e1", 40),
        ("gauge", "mxnet_decode_kv_occupancy", "slots", {"engine": "e1"},
         "e1", ("set", 0)),
        ("gauge", "mxnet_decode_kv_cache_bytes", "pool",
         {"engine": "e1"}, "e1", ("set", 1 << 30)),
        ("histogram", "mxnet_decode_step_seconds", "step",
         {"engine": "e1"}, "e1", None, [0.0021, 0.003, 0.0125])],
}


def _apply(reg, script):
    for op in script:
        kind = op[0]
        if kind == "const":
            reg.set_constant_labels(op[1])
        elif kind == "counter":
            _, name, help_, labels, series, n = op
            reg.counter(name, help=help_, labels=labels,
                        series=series).inc(n)
        elif kind == "gauge":
            _, name, help_, labels, series, (meth, v) = op
            getattr(reg.gauge(name, help=help_, labels=labels,
                              series=series), meth)(v)
        else:
            _, name, help_, labels, series, buckets, obs = op
            h = reg.histogram(name, help=help_, buckets=buckets,
                              labels=labels, series=series)
            for v in obs:
                h.observe(v)
    return reg


def _pair(script):
    return (_apply(TR.Registry(absorb_profiler=False), script),
            _apply(JR.Registry(absorb_profiler=False), script))


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_registry_renders_the_jax_text(name):
    ours, ref = _pair(SCRIPTS[name])
    assert ours.render_prometheus() == ref.render_prometheus()


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_registry_snapshot_matches_jax(name):
    ours, ref = _pair(SCRIPTS[name])
    assert _same(ours.snapshot(), ref.snapshot())
    assert ours.constant_labels() == ref.constant_labels()


@pytest.mark.parametrize("p", [0, 1, 50, 90, 99, 100])
def test_histogram_percentiles_match_jax(p):
    obs = np.random.RandomState(0).lognormal(-5, 2, size=200)
    ours, ref = TR.Histogram("h"), JR.Histogram("h")
    assert ours.percentile(p) is None and ref.percentile(p) is None
    for v in obs:
        ours.observe(v)
        ref.observe(v)
    assert ours.percentile(p) == ref.percentile(p)
    assert ours.snapshot() == ref.snapshot()


def test_registry_refusals_match_jax():
    for mod in (TR, JR):
        reg = mod.Registry(absorb_profiler=False)
        reg.counter("m")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("m")
        with pytest.raises(ValueError, match="negative"):
            reg.counter("m").inc(-1)
        # empty buckets mean the default latency bounds in both
        assert reg.histogram("h", buckets=()).bounds == JR.DEFAULT_BUCKETS
    ours, ref = _pair(SCRIPTS["gauges_series"])
    # get-or-create hands back the registered instance
    assert ours.gauge("temp").value() == ref.gauge("temp").value() == -1e-7
    assert len(ours.own_metrics()) == len(ref.own_metrics()) == 3
    # absorption renders the profiler's counter exports; off, nothing
    assert TR.Registry(absorb_profiler=False).render_prometheus() == "\n"
    text = TR.Registry(absorb_profiler=True).render_prometheus()
    assert "# TYPE mxnet_device_feed_feed_batches gauge" in text
    assert "mxnet_amp_amp_cast_bytes_saved" in text


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def test_exporter_serves_metrics_and_healthz_on_localhost():
    reg = TR.get_registry()
    _apply(reg, SCRIPTS["decode_engine_shape"][:1])
    with TE.TelemetryServer(port=0, host="127.0.0.1") as srv:
        assert srv.url == f"http://127.0.0.1:{srv.port}"
        status, ctype, body = _get(srv.url + "/metrics")
        assert status == 200 and ctype == TE.CONTENT_TYPE_METRICS
        assert body == reg.render_prometheus()
        assert 'mxnet_decode_tokens_total{engine="e1"}' in body
        status, ctype, body = _get(srv.url + "/healthz")
        health = json.loads(body)
        assert status == 200 and ctype == "application/json"
        assert health["status"] == "ok"
        assert health["subsystems"] == sorted(reg.absorbed())
        assert {"amp", "device_feed", "devstats"} <= \
            set(health["subsystems"])
        assert health["metrics"] == len(reg.own_metrics())
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.url + "/nope")
        assert ei.value.code == 404


def test_start_server_is_idempotent():
    try:
        srv = TE.start_server(0, host="127.0.0.1")
        assert TE.start_server(0, host="127.0.0.1") is srv
        assert TE.get_server() is srv
        assert _get(srv.url + "/")[0] == 200
    finally:
        TE.stop_server()
    assert TE.get_server() is None


CFG = dict(vocab=48, layers=2, d_model=32, heads=4, kv_heads=2, d_ff=64,
           max_len=32)


def _series(mod, kind, name, engine):
    """The engine's series (get-or-create returns the registered one)."""
    return getattr(mod.get_registry(), kind)(name, series=engine)


@pytest.mark.parametrize("lens,new", [([4, 9, 1], 5), ([20, 3], 7)])
def test_engine_series_match_the_jax_engines(lens, new):
    jmodel = JD.DecodeModel(**CFG)
    params = jmodel.init_params(seed=9)
    rng = np.random.RandomState(len(lens))
    prompts = [rng.randint(0, CFG["vocab"], size=n).tolist() for n in lens]
    tag = f"tm-{len(lens)}-{new}"
    with JD.DecodeEngine(jmodel, params, num_slots=2, name=tag + "-j",
                         warmup=False) as je:
        ref_out = [je.generate(p, max_new_tokens=new) for p in prompts]
        ref_steps = je.step_executions
    with DecodeEngine(DecodeModel(**CFG), params, num_slots=2,
                      name=tag + "-t", device="cpu") as te:
        out = [te.generate(p, max_new_tokens=new) for p in prompts]
        steps = te.step_executions
    assert out == ref_out and steps == ref_steps
    for kind, name in (("counter", "mxnet_decode_tokens_total"),
                       ("gauge", "mxnet_decode_kv_occupancy"),
                       ("gauge", "mxnet_decode_kv_cache_bytes")):
        ours = _series(TR, kind, name, tag + "-t").value()
        ref = _series(JR, kind, name, tag + "-j").value()
        assert ours == ref, name
    assert _series(TR, "counter", "mxnet_decode_tokens_total",
                   tag + "-t").value() == len(lens) * new
    hist = _series(TR, "histogram", "mxnet_decode_step_seconds", tag + "-t")
    assert hist.snapshot()["count"] == steps == \
        _series(JR, "histogram", "mxnet_decode_step_seconds",
                tag + "-j").snapshot()["count"]
    assert hist.labels == {"engine": tag + "-t"}
