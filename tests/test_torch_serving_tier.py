"""The serving tier of the port: ServingEngine, DynamicBatcher,
ServingMetrics, EnginePool, ModelRouter, ServingFrontend and the serving
CLI (counterparts of tests/test_serving.py and tests/test_frontend.py),
on the CPU.

- ServingEngine: every bucket's rows equal the port Predictor's, and the
  engine's outputs the JAX predictor's (same Symbol, params and inputs,
  within 1e-5); its HBM preflight refuses a bucket before it is cached;
- the batcher: concurrent clients, multi-row requests, a deadline
  timeout, queue-full shedding;
- router and pool: LRU eviction by resident bytes, a preflight-rejected
  load that leaves the router unchanged, the max_models bound,
  concurrent load/unload, least-loaded dispatch; admission-class shed
  order, interactive before batch, timeouts by class; the HTTP status
  mapping; the frontend end to end over sockets against the engine;
- ``python -m mxnet_tpu_torch.serving --selftest --device cpu``.

The scheduling contracts run over fake engines and pools, as the JAX
package's tests do.
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.contrib.export import export_model as j_export
from mxnet_tpu.predictor import Predictor as JPredictor

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.contrib.export import export_model
from mxnet_tpu_torch.predictor import Predictor
from mxnet_tpu_torch.serving import (DynamicBatcher, EnginePool, ModelRouter,
                                     ServingEngine, ServingQueueFull,
                                     UnknownModel)
from mxnet_tpu_torch.serving.batcher import RequestTimeout
from mxnet_tpu_torch.serving.frontend import ServingFrontend, status_for
from mxnet_tpu_torch.telemetry import devstats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8
SHAPE = (BATCH, 3, 16, 16)


@pytest.fixture(autouse=True)
def _hold_settings(monkeypatch):
    """Two torch threads; none of the JAX planner's or the serving
    budget's settings another test may leave in os.environ."""
    from mxnet_tpu.parallel.planner import AUTO_KNOB_VARS
    for k in AUTO_KNOB_VARS + ("MXNET_PLAN", "MXNET_SERVING_HBM_BUDGET",
                               "MXNET_DEVSTATS_HBM_BYTES",
                               "MXNET_SERVING_MAX_MODELS",
                               "MXNET_SERVING_REPLICAS"):
        if k in os.environ:
            monkeypatch.delenv(k)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _convnet(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8, name="c1")
    net = mx.sym.BatchNorm(net, name="bn1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=10,
                                name="fc")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _draws():
    rng = np.random.RandomState(0)
    sym = _convnet(tmx)
    shapes, _, aux_shapes = sym.infer_shape(data=SHAPE)
    args = {n: rng.normal(0, .2, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    auxs = {n: (rng.uniform(.5, 1.5, s) if "var" in n
                else rng.normal(0, .1, s)).astype(np.float32)
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, auxs


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The same model exported by each package: (jax path, port path)."""
    args, auxs = _draws()
    d = tmp_path_factory.mktemp("serving")
    jp, tp = str(d / "jax.mxa"), str(d / "model.mxa")
    j_export(jp, _convnet(jmx), {k: jmx.nd.array(v) for k, v in
                                 args.items()},
             {k: jmx.nd.array(v) for k, v in auxs.items()},
             {"data": SHAPE}, platforms=("cpu",))
    export_model(tp, _convnet(tmx), args, auxs, {"data": SHAPE})
    return jp, tp


@pytest.fixture(scope="module")
def engine(artifacts):
    return ServingEngine(artifacts[1], device="cpu")


def test_engine_buckets_match_predictor_and_the_jax_package(artifacts,
                                                            engine):
    jp, tp = artifacts
    x = np.random.RandomState(1).uniform(0, 1, SHAPE).astype(np.float32)
    full = Predictor(tp, device="cpu").forward(x)[0]
    np.testing.assert_allclose(full, JPredictor(jp).forward(x)[0],
                               rtol=0, atol=1e-5)
    assert engine.buckets == [1, 2, 4, 8]
    assert engine.plan_compiles == 1          # warmup built the one plan
    padded = engine.padded_rows
    for n in (1, 2, 3, 5, 8):
        out = engine.infer(x[:n])
        assert out[0].shape == (n, 10)
        np.testing.assert_allclose(out[0], full[:n], rtol=1e-5, atol=1e-6)
    # stale rows of a larger request never reach a smaller one's answer
    np.testing.assert_allclose(engine.infer(x[4:5])[0], full[4:5],
                               rtol=1e-5, atol=1e-6)
    assert engine.plan_compiles == 1          # cache hits only
    assert engine.padded_rows - padded == sum(BATCH - n for n in
                                              (1, 2, 3, 5, 8, 1))
    assert engine.bucket_for(3) == 4 and engine.bucket_for(8) == 8
    with pytest.raises(ValueError):
        engine.bucket_for(9)
    with pytest.raises(ValueError):
        engine.infer(np.zeros((9,) + SHAPE[1:], np.float32))
    st = engine.stats()
    assert st["plans"] == 1 and st["plan_resident_bytes"] == sum(
        st["plan_bytes"].values()) > 0
    assert st["buckets"] == [1, 2, 4, 8]
    # on the host the plan calls the program: no graph
    assert [p.graph for p in engine._plans.values()] == [None]


def test_engine_preflight_refuses_a_bucket_before_caching_it(
        artifacts, monkeypatch):
    monkeypatch.setenv("MXNET_DEVSTATS_HBM_BYTES", "128")
    eng = ServingEngine(artifacts[1], device="cpu", warmup=False)
    with pytest.raises(devstats.HBMPreflightError, match="over by"):
        eng.infer(np.zeros((1,) + SHAPE[1:], np.float32))
    assert eng.plan_bytes == {} and eng.plan_compiles == 0


class SlowEngine:
    """Identity engine for the batcher's scheduling tests, optionally
    slow or gated on an event."""

    def __init__(self, max_batch=8, delay_s=0.0, gate=None):
        self.max_batch = max_batch
        self.input_names = ["data"]
        self.delay_s = delay_s
        self.gate = gate
        self.calls = 0

    def infer(self, x):
        self.calls += 1
        if self.gate is not None:
            self.gate.wait(timeout=10)
        if self.delay_s:
            time.sleep(self.delay_s)
        return [np.asarray(x)]



def test_batcher_concurrent_clients(engine):
    """8 concurrent single-row clients coalesce into fewer engine
    executions, and every client gets ITS row's output back."""
    x = np.random.RandomState(2).uniform(0, 1, SHAPE).astype(np.float32)
    full = engine.infer(x)[0]
    execs_before = engine.executions
    results = [None] * BATCH
    start = threading.Barrier(BATCH)

    with DynamicBatcher(engine, max_wait_us=20000,
                        queue_depth=32) as bat:
        def client(i):
            start.wait()
            results[i] = bat.infer(x[i:i + 1], timeout_ms=10000)[0]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(BATCH)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        snap = bat.metrics.snapshot()
    got = np.concatenate(results, axis=0)
    np.testing.assert_allclose(got, full, rtol=1e-5, atol=1e-6)
    batches = engine.executions - execs_before
    assert batches < BATCH                    # coalescing happened
    assert snap["requests"] == BATCH
    assert snap["completed"] == BATCH
    assert snap["batches"] == batches
    assert snap["batched_rows"] == BATCH
    assert sum(int(k) * v for k, v in snap["batch_hist"].items()) == BATCH
    assert snap["shed"] == 0 and snap["timeouts"] == 0
    assert snap["p50_ms"] is not None and snap["p99_ms"] >= snap["p50_ms"]


def test_batcher_multirow_requests(engine):
    """Requests carrying several rows coalesce too; a request that
    doesn't fit the current batch waits for the next one."""
    x = np.random.RandomState(3).uniform(0, 1, SHAPE).astype(np.float32)
    full = engine.infer(x)[0]
    with DynamicBatcher(engine, max_wait_us=20000) as bat:
        f1 = bat.submit(x[:3])
        f2 = bat.submit(x[3:6])
        f3 = bat.submit(x[6:8])
        np.testing.assert_allclose(f1.result(10)[0], full[:3],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(f2.result(10)[0], full[3:6],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(f3.result(10)[0], full[6:8],
                                   rtol=1e-5, atol=1e-6)
        with pytest.raises(ValueError):
            bat.submit(np.zeros((9, 3, 16, 16), np.float32))


def test_batcher_deadline_timeout():
    """A request whose deadline expires while the worker is busy fails
    with RequestTimeout and never reaches the engine."""
    eng = SlowEngine(delay_s=0.25)
    with DynamicBatcher(eng, max_wait_us=0, queue_depth=8) as bat:
        slow = bat.submit(np.zeros((1, 4), np.float32))   # occupies worker
        time.sleep(0.05)                                  # worker now busy
        doomed = bat.submit(np.zeros((1, 4), np.float32), timeout_ms=50)
        assert slow.result(5)[0].shape == (1, 4)
        with pytest.raises(RequestTimeout):
            doomed.result(5)
        snap = bat.metrics.snapshot()
    assert snap["timeouts"] == 1
    assert snap["completed"] == 1
    assert eng.calls == 1                     # the doomed one never ran


def test_batcher_queue_full_sheds():
    """Bounded queue: submits past queue_depth raise ServingQueueFull
    (load shedding) and are counted; accepted requests still complete."""
    gate = threading.Event()
    eng = SlowEngine(gate=gate)
    depth = 4
    with DynamicBatcher(eng, max_wait_us=0, queue_depth=depth,
                        max_batch=1) as bat:
        first = bat.submit(np.zeros((1, 4), np.float32))  # worker blocks
        time.sleep(0.05)
        futures = [bat.submit(np.zeros((1, 4), np.float32))
                   for _ in range(depth)]                  # fills the queue
        with pytest.raises(ServingQueueFull):
            bat.submit(np.zeros((1, 4), np.float32))
        snap_mid = bat.metrics.snapshot()
        assert snap_mid["shed"] == 1
        assert snap_mid["queue_depth"] == depth
        gate.set()                                         # drain
        assert first.result(5)[0].shape == (1, 4)
        for f in futures:
            assert f.result(5)[0].shape == (1, 4)
        snap = bat.metrics.snapshot()
    assert snap["completed"] == depth + 1
    assert snap["requests"] == depth + 1      # shed submits aren't accepted


class FakeEngine:
    """Identity engine, optionally gated so a replica stays busy."""

    def __init__(self, max_batch=8, gate=None, model_name=None):
        self.max_batch = max_batch
        self.input_names = ["data"]
        self.gate = gate
        self.model_name = model_name
        self.calls = 0
        self.seen = []                    # first scalar of each batch

    def infer(self, x):
        self.calls += 1
        self.seen.append(float(np.asarray(x).flat[0]))
        if self.gate is not None:
            self.gate.wait(timeout=10)
        return [np.asarray(x)]


class _FakeFuture:
    def __init__(self, value=None, exc=None):
        self._value, self._exc = value, exc

    def result(self, timeout=None):
        if self._exc is not None:
            raise self._exc
        return self._value


class FakePool:
    """Router-facing pool double: fixed resident bytes, scripted
    predict behavior, close-exactly-once accounting."""

    def __init__(self, path, resident=0, behavior="ok"):
        self.path = path
        self.resident = resident
        self.behavior = behavior
        self.model_name = "fake"
        self.closed = 0
        self._lock = threading.Lock()

    def resident_bytes(self):
        return self.resident

    def plan_compiles(self):
        return 1

    def depth(self):
        return 0

    def stats(self):
        return {"model": self.model_name, "replicas": 1, "depth": 0,
                "resident_bytes": self.resident, "plans": 1,
                "requests": 0, "completed": 0, "shed": 0, "timeouts": 0,
                "per_replica": []}

    def submit(self, *arrays, timeout_ms=None, priority="interactive"):
        if self.behavior == "shed":
            raise ServingQueueFull("scripted shed")
        if self.behavior == "timeout":
            return _FakeFuture(exc=RequestTimeout("scripted timeout")), 0
        return _FakeFuture(value=[np.asarray(a) for a in arrays]), 0

    def close(self, drain=True):
        with self._lock:
            self.closed += 1


def _fake_router(sizes, budget=None, max_models=0, behaviors=None,
                 created=None):
    """ModelRouter over FakePools: `sizes[path]` is both the admission
    estimate (need_fn) and the measured resident."""
    behaviors = behaviors or {}

    def factory(path, replicas=1):
        p = FakePool(path, resident=sizes[path],
                     behavior=behaviors.get(path, "ok"))
        if created is not None:
            created.append(p)
        return p

    return ModelRouter(budget=budget, max_models=max_models, replicas=1,
                       pool_factory=factory,
                       need_fn=lambda path: sizes[path], device="cpu")


# --------------------------------------------------------------- router


def test_router_lru_eviction_order_by_resident_bytes():
    sizes = {"p1": 40, "p2": 40, "p3": 40, "p4": 100}
    created = []
    r = _fake_router(sizes, budget=100, created=created)
    r.load("m1", "p1")
    r.load("m2", "p2")
    assert r.models() == ["m1", "m2"]
    assert r.resident_bytes() == 80
    # touch m1 so m2 becomes the LRU victim
    r.predict("m1", [np.zeros((1, 2), np.float32)]).result()
    r.load("m3", "p3")                    # 80 + 40 > 100: evict ONE
    assert set(r.models()) == {"m1", "m3"}
    assert created[1].closed == 1 and created[0].closed == 0
    # a model that needs the whole budget evicts everything LRU-first
    r.load("m4", "p4")
    assert r.models() == ["m4"]
    assert [p.closed for p in created] == [1, 1, 1, 0]
    r.close()
    assert created[3].closed == 1


def test_preflight_rejected_load_leaves_router_state_unchanged():
    sizes = {"small": 40, "huge": 1000}
    created = []
    r = _fake_router(sizes, budget=100, created=created)
    r.load("m1", "small")
    before = (r.models(), r.resident_bytes())
    with pytest.raises(devstats.HBMPreflightError):
        r.load("whale", "huge")           # estimate alone > budget
    # rejected BEFORE eviction and BEFORE any pool was built
    assert (r.models(), r.resident_bytes()) == before
    assert len(created) == 1 and created[0].closed == 0
    with pytest.raises(UnknownModel):
        r.predict("whale", [np.zeros((1, 2), np.float32)])
    r.close()


def test_router_max_models_bound_evicts_lru():
    sizes = {"p1": 1, "p2": 1, "p3": 1}
    created = []
    r = _fake_router(sizes, max_models=2, created=created)
    r.load("m1", "p1")
    r.load("m2", "p2")
    r.load("m3", "p3")
    assert set(r.models()) == {"m2", "m3"}
    assert created[0].closed == 1
    r.close()


def test_concurrent_load_unload_races():
    sizes = {f"p{i}": 10 for i in range(4)}
    created = []
    r = _fake_router(sizes, created=created)
    stop = time.monotonic() + 1.0
    errors = []

    def churn(k):
        name, path = f"m{k % 2}", f"p{k % 4}"
        while time.monotonic() < stop:
            try:
                r.load(name, path)
                r.predict(name,
                          [np.zeros((1, 2), np.float32)]).result()
                r.unload(name)
            except (UnknownModel, RuntimeError):
                pass                      # lost a race: fine
            except Exception as e:        # pragma: no cover
                errors.append(repr(e))
                return

    threads = [threading.Thread(target=churn, args=(k,), daemon=True)
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    r.close()
    assert not errors
    assert created, "no pools were ever built"
    # every pool the router ever built is closed exactly once
    assert all(p.closed == 1 for p in created), \
        [(p.path, p.closed) for p in created]


# ----------------------------------------------------------------- pool


def test_least_loaded_dispatch_picks_idle_replica():
    gates = [threading.Event(), threading.Event()]
    pool = EnginePool(
        "x", replicas=2,
        engine_factory=lambda model, replica: FakeEngine(
            gate=gates[replica]),
        max_wait_us=0)
    try:
        f0, i0 = pool.submit(np.zeros((1, 2), np.float32))
        # wait until the worker has TAKEN it (depth = inflight, not
        # queued) so the replica reads as busy, then dispatch again
        deadline = time.monotonic() + 5
        while pool.engines[i0].calls == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        assert pool.batchers[i0].depth() == 1
        f1, i1 = pool.submit(np.zeros((1, 2), np.float32))
        assert i1 != i0, "dispatch piled onto the busy replica"
        for g in gates:
            g.set()
        assert f0.result(timeout=10)[0].shape == (1, 2)
        assert f1.result(timeout=10)[0].shape == (1, 2)
    finally:
        for g in gates:
            g.set()
        pool.close()


# -------------------------------------------------------- admission class


def test_admission_class_shed_ordering():
    gate = threading.Event()
    eng = FakeEngine(max_batch=4, gate=gate)
    b = DynamicBatcher(eng, max_wait_us=0, queue_depth=4,
                       batch_queue_depth=1)
    try:
        first = b.submit(np.zeros((1, 2), np.float32))
        deadline = time.monotonic() + 5
        while eng.calls == 0 and time.monotonic() < deadline:
            time.sleep(0.005)             # worker now blocked in infer
        ok_batch = b.submit(np.zeros((1, 2), np.float32),
                            priority="batch")
        with pytest.raises(ServingQueueFull):
            b.submit(np.zeros((1, 2), np.float32), priority="batch")
        # interactive still has headroom after batch started shedding
        ok_inter = b.submit(np.zeros((1, 2), np.float32))
        snap = b.metrics.snapshot()
        assert snap["shed_by_class"] == {"batch": 1}
        assert snap["shed"] == 1
        gate.set()
        for f in (first, ok_batch, ok_inter):
            f.result(timeout=10)
        # the per-class counter reached the registry with class labels
        from mxnet_tpu_torch.telemetry import get_registry
        text = get_registry().render_prometheus()
        assert any("shed_total" in ln and 'class="batch"' in ln
                   for ln in text.splitlines()
                   if not ln.startswith("#"))
    finally:
        gate.set()
        b.close()


def test_interactive_drained_before_batch():
    gate = threading.Event()
    eng = FakeEngine(max_batch=1, gate=gate)
    b = DynamicBatcher(eng, max_wait_us=0, queue_depth=8,
                       batch_queue_depth=8)
    try:
        first = b.submit(np.full((1, 1), 0.0, np.float32))
        deadline = time.monotonic() + 5
        while eng.calls == 0 and time.monotonic() < deadline:
            time.sleep(0.005)             # worker blocked on request 0
        fb = b.submit(np.full((1, 1), 1.0, np.float32),
                      priority="batch")
        fi = b.submit(np.full((1, 1), 2.0, np.float32))
        gate.set()
        for f in (first, fb, fi):
            f.result(timeout=10)
        # max_batch=1: each request ran alone, and the later-queued
        # interactive one (2.0) was taken before the batch one (1.0)
        assert eng.seen == [0.0, 2.0, 1.0]
    finally:
        gate.set()
        b.close()


def test_timeout_records_class():
    gate = threading.Event()
    eng = FakeEngine(max_batch=1, gate=gate)
    b = DynamicBatcher(eng, max_wait_us=0, queue_depth=8,
                       batch_queue_depth=8)
    try:
        first = b.submit(np.zeros((1, 1), np.float32))
        deadline = time.monotonic() + 5
        while eng.calls == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        doomed = b.submit(np.zeros((1, 1), np.float32),
                          priority="batch", timeout_ms=10)
        time.sleep(0.05)                  # let the deadline lapse queued
        gate.set()
        first.result(timeout=10)
        with pytest.raises(RequestTimeout):
            doomed.result(timeout=10)
        deadline = time.monotonic() + 5
        while not b.metrics.snapshot()["timeouts"] \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        assert b.metrics.snapshot()["timeouts_by_class"] == {"batch": 1}
    finally:
        gate.set()
        b.close()


# ------------------------------------------------------------- frontend


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read().decode() or "{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def test_http_status_mapping():
    sizes = {"ok": 10, "shed": 10, "slow": 10}
    r = _fake_router(sizes, behaviors={"shed": "shed",
                                       "slow": "timeout"})
    fe = ServingFrontend(router=r)
    try:
        u = fe.url
        for name in sizes:
            assert _post(f"{u}/v1/models/{name}:load",
                         {"path": name})[0] == 200
        row = {"inputs": [[[1.0, 2.0]]]}
        code, out = _post(f"{u}/v1/models/ok:predict", row)
        assert code == 200 and out["outputs"] == [[[1.0, 2.0]]]
        assert _post(f"{u}/v1/models/ghost:predict", row)[0] == 404
        assert _post(f"{u}/v1/models/shed:predict", row)[0] == 429
        assert _post(f"{u}/v1/models/slow:predict", row)[0] == 504
        assert _post(f"{u}/v1/models/ok:predict", {})[0] == 400
        assert _post(f"{u}/v1/models/ok:frobnicate", {})[0] == 400
        assert _post(f"{u}/v1/models/ghost:unload", {})[0] == 404
        assert _get(f"{u}/healthz")[0] == 200
        assert _get(f"{u}/metrics")[0] == 200
        assert _get(f"{u}/nope")[0] == 404
        code, models = _post(f"{u}/v1/models/ok:unload", {})
        assert code == 200
        assert _post(f"{u}/v1/models/ok:predict", row)[0] == 404
    finally:
        fe.close()
        r.close()


def test_status_for_exception_order():
    # the serving exceptions subclass stdlib ones; mapping must see the
    # specific class first
    assert status_for(UnknownModel("x")) == 404        # KeyError
    assert status_for(ServingQueueFull("x")) == 429    # RuntimeError
    assert status_for(RequestTimeout("x")) == 504      # TimeoutError
    assert status_for(devstats.HBMPreflightError("x")) == 507
    assert status_for(ValueError("x")) == 400
    assert status_for(KeyError("x")) == 400
    assert status_for(RuntimeError("x")) == 409
    assert status_for(Exception("x")) == 500


def test_frontend_close_idempotent_and_joined():
    r = _fake_router({"p": 1})
    fe = ServingFrontend(router=r)
    fe.close()
    fe.close()                            # idempotent
    assert not fe._thread.is_alive()
    r.close()


def test_frontend_end_to_end_matches_engine(tmp_path):
    from mxnet_tpu_torch.serving.frontend import _export_mlp
    path = _export_mlp(str(tmp_path), "e2e")
    eng = ServingEngine(path, buckets=[1, 8], device="cpu")
    row = np.linspace(0, 1, 16, dtype=np.float32).reshape(1, 16)
    want = eng.infer(row)[0]
    fe = ServingFrontend(replicas=1, buckets=[1, 8], device="cpu")
    try:
        assert _post(f"{fe.url}/v1/models/e2e:load",
                     {"path": path})[0] == 200
        code, out = _post(f"{fe.url}/v1/models/e2e:predict",
                          {"inputs": [row.tolist()],
                           "timeout_ms": 30000})
        assert code == 200
        got = np.asarray(out["outputs"][0], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        # dict-shaped inputs resolve by input name too
        code, out2 = _post(f"{fe.url}/v1/models/e2e:predict",
                           {"inputs": {"data": row.tolist()}})
        assert code == 200
        np.testing.assert_allclose(
            np.asarray(out2["outputs"][0], np.float32), want,
            rtol=1e-5, atol=1e-6)
    finally:
        fe.close()


def test_serving_selftest_cli_on_the_cpu():
    """python -m mxnet_tpu_torch.serving --selftest --device cpu: what the
    batcher does, and nothing it measures against the wall clock. With 8
    clients in a closed loop, the other clients' requests queue while a
    batch runs, so the batches of 96 requests average well above one
    row: at least 2 (a quarter of the clients; each batch holds at most
    8). Nothing is shed or timed out, every request is answered, and
    /metrics carries the serving series. The CLI's own 2x bar (batched
    against one Predictor call a request) is a ratio of two wall-clock
    loops that thread wake-ups set on a shared host (0.9-5.4 under
    pytest-xdist), so it is passed 0 here; chip_smoke.py's serving_net
    phase holds the card to its default."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.serving", "--selftest",
         "--device", "cpu", "--requests", "96", "--min-speedup", "0"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr)
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["ok"] and res["device"] == "cpu"
    assert res["telemetry_scrape_ok"]
    assert res["shed"] == 0 and res["timeouts"] == 0
    hist = {int(k): v for k, v in res["batch_hist"].items()}
    rows = sum(k * v for k, v in hist.items())
    assert rows == res["rounds"] * 96
    assert max(hist) <= res["concurrency"]
    assert rows / sum(hist.values()) >= 2.0, hist
