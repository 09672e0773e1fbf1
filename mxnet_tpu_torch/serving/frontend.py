"""ServingFrontend — the network front door: HTTP/1.1 JSON over a
ModelRouter (counterpart of mxnet_tpu/serving/frontend.py).

    python -m mxnet_tpu_torch.serving.frontend model_a.mxa model_b.mxa
    python -m mxnet_tpu_torch.serving.frontend --selftest [--device cpu]
    python -m mxnet_tpu_torch.serving.frontend --bench [--device cpu]

Stdlib-only (threaded `http.server`, JSON wire format), one server per
frontend on a daemon thread, one ModelRouter behind it:

    POST /v1/models/<name>:predict   {"inputs": [...], "priority":
                                      "interactive"|"batch",
                                      "timeout_ms": N}
                                  -> {"model": ..., "outputs": [...]}
    POST /v1/models/<name>:generate  {"tokens": [...], "max_new_tokens":
                                      N} (a decode artifact: the port's
                                      DecodeEngine)
    POST /v1/models/<name>:load      {"path": "/path/to/model.mxa"}
    POST /v1/models/<name>:unload    {}
    GET  /v1/models                  router table + per-model stats
    GET  /healthz                    liveness + model count
    GET  /metrics                    telemetry registry (Prometheus)

Status mapping is the overload contract on the wire: 404 unknown model,
429 `ServingQueueFull` (shed — the batch class sheds first), 504
`RequestTimeout` (deadline passed in queue), 507 `HBMPreflightError`
(model rejected by the admission preflight before any plan compiled),
400 malformed request, 409 racing a closed router/batcher.

`--selftest` drives the whole tier through real sockets: 64+ concurrent
client threads against two hot models (p99 within the interactive
deadline), a mixed-priority overload proving batch sheds before
interactive, and a budget-bound load -> LRU-evict -> reload cycle where
an over-budget model 507s with the router table provably untouched.
The models are served on the card unless ``device="cpu"`` (``--device
cpu``) is given.
"""
from __future__ import annotations

import argparse
import atexit
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .batcher import RequestTimeout, ServingQueueFull
from .router import ModelRouter, UnknownModel, manifest_need_bytes
from ..telemetry import devstats
from ..telemetry.registry import get_registry

__all__ = ["ServingFrontend", "status_for"]

_JSON = "application/json"
_METRICS_CTYPE = "text/plain; version=0.0.4; charset=utf-8"


def status_for(exc):
    """Exception -> HTTP status. Order matters: the serving exceptions
    subclass RuntimeError/KeyError, so they are matched first."""
    if isinstance(exc, UnknownModel):
        return 404
    if isinstance(exc, ServingQueueFull):
        return 429
    if isinstance(exc, RequestTimeout):
        return 504
    if isinstance(exc, devstats.HBMPreflightError):
        return 507
    if isinstance(exc, (ValueError, KeyError, TypeError)):
        return 400
    if isinstance(exc, RuntimeError):
        return 409              # closed router/batcher, table full
    return 500


class _Handler(BaseHTTPRequestHandler):
    server_version = "mxnet-tpu-torch-serving/1.0"
    protocol_version = "HTTP/1.1"

    # -- plumbing ------------------------------------------------------------

    def _reply(self, code, body, ctype=_JSON):
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _fail(self, exc):
        code = status_for(exc)
        self._reply(code, {"error": type(exc).__name__,
                           "message": str(exc)})

    def _body(self):
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        if not raw:
            return {}
        out = json.loads(raw.decode("utf-8"))
        if not isinstance(out, dict):
            raise ValueError("request body must be a JSON object")
        return out

    def log_message(self, fmt, *args):
        if os.environ.get("MXNET_TELEMETRY_HTTP_LOG"):
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    @property
    def frontend(self):
        return self.server.frontend

    # -- routes --------------------------------------------------------------

    def do_GET(self):                               # noqa: N802 (stdlib api)
        path = self.path.split("?", 1)[0]
        try:
            if path == "/healthz":
                router = self.frontend.router
                self._reply(200, {
                    "status": "ok", "pid": os.getpid(),
                    "models": router.models(),
                    "resident_bytes": router.resident_bytes(),
                })
            elif path == "/metrics":
                self._reply(200,
                            get_registry().render_prometheus().encode(),
                            ctype=_METRICS_CTYPE)
            elif path == "/v1/models":
                self._reply(200, self.frontend.router.stats())
            elif path.startswith("/v1/models/"):
                name = path[len("/v1/models/"):]
                self._reply(200, self.frontend.router.stats(name))
            else:
                self._reply(404, {"error": "NotFound", "message":
                                  "try /v1/models, /healthz, /metrics"})
        except Exception as e:
            self._fail(e)

    def do_POST(self):                              # noqa: N802 (stdlib api)
        path = self.path.split("?", 1)[0]
        try:
            if not path.startswith("/v1/models/") or ":" not in path:
                raise UnknownModel(f"no POST route {path!r}")
            name, _, verb = path[len("/v1/models/"):].rpartition(":")
            if not name:
                raise ValueError("empty model name")
            body = self._body()
            if verb == "predict":
                self._predict(name, body)
            elif verb == "generate":
                self._generate(name, body)
            elif verb == "load":
                st = self.frontend.router.load(name, str(body["path"]))
                self._reply(200, st)
            elif verb == "unload":
                self.frontend.router.unload(name)
                self._reply(200, {"unloaded": name})
            else:
                raise ValueError(f"unknown verb {verb!r}")
        except Exception as e:
            self._fail(e)

    def _predict(self, name, body):
        inputs = body.get("inputs")
        if inputs is None:
            raise ValueError("predict body needs 'inputs'")
        # positional list of arrays (batch axis first on each), or
        # {input_name: array}
        if isinstance(inputs, dict):
            order = self.frontend.input_names(name)
            try:
                inputs = [inputs[k] for k in order]
            except KeyError as e:
                raise ValueError(f"missing input {e.args[0]!r} "
                                 f"(expects {order})")
        elif not isinstance(inputs, list):
            raise ValueError("inputs must be a list (one array per "
                             "model input) or a name->array object")
        arrays = [np.asarray(a, np.float32) for a in inputs]
        priority = str(body.get("priority") or "interactive")
        timeout_ms = body.get("timeout_ms")
        fut = self.frontend.router.predict(
            name, arrays, timeout_ms=timeout_ms, priority=priority)
        outs = fut.result()
        self._reply(200, {"model": name,
                          "outputs": [np.asarray(o).tolist()
                                      for o in outs]})

    def _generate(self, name, body):
        """Decode-model session API: {"tokens": [...], "max_new_tokens":
        N, "eos_id": E, "timeout_ms": T} -> the greedy completion. The
        session blocks this handler thread only (ThreadingHTTPServer);
        the decode loop packs it with every other live session."""
        tokens = body.get("tokens")
        if tokens is None:
            raise ValueError("generate body needs 'tokens' (prompt ids)")
        if not isinstance(tokens, list):
            raise ValueError("'tokens' must be a list of token ids")
        sess = self.frontend.router.generate(
            name, tokens,
            max_new_tokens=body.get("max_new_tokens"),
            eos_id=body.get("eos_id"),
            timeout_ms=body.get("timeout_ms"))
        out = sess.result()
        self._reply(200, {"model": name, "session": sess.sid,
                          "prompt_tokens": len(tokens),
                          "tokens": out})


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # a burst of N concurrent clients all connect before the accept loop
    # catches up; the stdlib default backlog (5) resets the overflow
    request_queue_size = 256


class ServingFrontend:
    """HTTP server + ModelRouter. `port=None` reads MXNET_SERVING_PORT
    (0 = ephemeral; `self.port` has the bound one). Extra kwargs build
    the router (budget, replicas, queue_depth, buckets, ...); passing
    `router=` uses yours and leaves its lifecycle to you."""

    def __init__(self, router=None, host="127.0.0.1", port=None,
                 **router_kw):
        if port is None:
            from .. import config
            raw = config.get("MXNET_SERVING_PORT")
            port = int(raw) if raw not in (None, "") else 0
        self._owns_router = router is None
        self.router = router if router is not None \
            else ModelRouter(**router_kw)
        self._closed = False
        self._close_lock = threading.Lock()
        self._httpd = _Server((host, int(port)), _Handler)
        self._httpd.frontend = self
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.25},
            name="mxnet_tpu_torch-serving-frontend", daemon=True)
        self._thread.start()
        _FRONTENDS.add(self)
        _install_atexit()

    @property
    def url(self):
        host = "127.0.0.1" if self.host in ("0.0.0.0", "::") else self.host
        return f"http://{host}:{self.port}"

    def input_names(self, model):
        """Input order of a loaded model (for dict-shaped predict
        bodies)."""
        with self.router._lock:
            entry = self.router._models.get(str(model))
            pool = entry.pool if entry is not None else None
        if pool is None:
            raise UnknownModel(f"model {model!r} is not loaded")
        return list(getattr(pool.engines[0], "input_names", []))

    def close(self):
        """Idempotent: stop accepting, join the server thread, then
        close the router (owned routers only) — every batcher worker
        joins before this returns."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:               # pragma: no cover
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)
        if self._owns_router:
            self.router.close()

    __enter__ = lambda self: self

    def __exit__(self, *exc):
        self.close()
        return False


# interpreter exit: close every live frontend exactly once (WeakSet —
# a collected frontend already closed; registration is install-once)
_FRONTENDS = weakref.WeakSet()
_atexit_lock = threading.Lock()
_atexit_installed = [False]


def _close_all():
    for fe in list(_FRONTENDS):
        fe.close()


def _install_atexit():
    with _atexit_lock:
        if not _atexit_installed[0]:
            atexit.register(_close_all)
            _atexit_installed[0] = True


# ---------------------------------------------------------------- selftest

def _export_mlp(dirpath, name, batch=8, in_dim=16, hidden=16):
    """Tiny MLP -> .mxa named `name` (Xavier init; serving cares about
    shapes and plan sizes, not weights). Its params are drawn on the
    host; the artifact holds the programs of every platform present."""
    import mxnet_tpu_torch as mx
    from ..contrib.export import export_model

    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=hidden, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=8, name="fc2")
    sym = mx.sym.SoftmaxOutput(net, name="softmax")
    mod = mx.mod.Module(sym, context=mx.cpu(0))
    mod.bind(data_shapes=[("data", (batch, in_dim))],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(mx.init.Xavier())
    args, auxs = mod.get_params()
    path = os.path.join(dirpath, f"{name}.mxa")
    export_model(path, sym, args, auxs, {"data": (batch, in_dim)},
                 model_name=name)
    return path


def _http(method, url, body=None, timeout=60):
    """(status, parsed-json) — HTTPError bodies parse too; transport
    failures come back as status 0 instead of raising (a load-gen
    thread must count them, not die). ``body`` is a JSON value, or its
    encoded bytes."""
    import urllib.error
    import urllib.request
    data = body if isinstance(body, bytes) or body is None \
        else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": _JSON} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read().decode()
            code = r.status
    except urllib.error.HTTPError as e:
        raw = e.read().decode()
        code = e.code
    except OSError as e:
        return 0, {"error": type(e).__name__, "message": str(e)}
    try:
        return code, json.loads(raw or "{}")
    except ValueError:
        return code, {"raw": raw}


def _closed_loop(base, jobs):
    """Run len(jobs) client threads; each job is (model, priority,
    timeout_ms, n_requests, row). Returns per-class dicts of status
    counts and sorted 200-latencies (ms). Each distinct request body is
    JSON-encoded once, before the clock starts: the encoding is the
    clients' cost, and the clients share the server's process."""
    lock = threading.Lock()
    counts = {}                 # (klass, status) -> n
    lats = {}                   # klass -> [ms]
    start = threading.Barrier(len(jobs) + 1)
    bodies = {}
    for model, priority, timeout_ms, _n, row in jobs:
        key = (priority, timeout_ms, id(row))
        if key not in bodies:
            bodies[key] = json.dumps({"inputs": row, "priority": priority,
                                      "timeout_ms": timeout_ms}).encode()

    def client(model, priority, timeout_ms, n, row):
        url = f"{base}/v1/models/{model}:predict"
        body = bodies[(priority, timeout_ms, id(row))]
        start.wait()
        for _ in range(n):
            t0 = time.perf_counter()
            code, _payload = _http("POST", url, body)
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                counts[(priority, code)] = \
                    counts.get((priority, code), 0) + 1
                if code == 200:
                    lats.setdefault(priority, []).append(ms)

    threads = [threading.Thread(target=client, args=j, daemon=True)
               for j in jobs]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    for v in lats.values():
        v.sort()
    return counts, lats, dt


def _pctl(sorted_ms, p):
    if not sorted_ms:
        return None
    i = min(len(sorted_ms) - 1,
            int(round(p / 100.0 * (len(sorted_ms) - 1))))
    return round(sorted_ms[i], 2)


def _phase_throughput(res, paths, requests, concurrency, replicas,
                      deadline_ms, device=None):
    """>=64 concurrent interactive clients, 2 hot models, all 200, p99
    within deadline."""
    fe = ServingFrontend(replicas=replicas, queue_depth=max(concurrency,
                                                            64),
                         max_wait_us=1000, buckets=[1, 4, 8], device=device)
    try:
        for name, path in paths.items():
            code, payload = _http("POST",
                                  f"{fe.url}/v1/models/{name}:load",
                                  {"path": path})
            assert code == 200, f"load {name}: {code} {payload}"
        names = list(paths)
        per = max(1, requests // concurrency)
        row = [[[0.5] * 16]]
        jobs = [(names[i % len(names)], "interactive", deadline_ms, per,
                 row) for i in range(concurrency)]
        counts, lats, dt = _closed_loop(fe.url, jobs)
        n_ok = counts.get(("interactive", 200), 0)
        total = sum(counts.values())
        assert n_ok == total, f"non-200 under open load: {counts}"
        p99 = _pctl(lats["interactive"], 99)
        assert p99 is not None and p99 <= deadline_ms, \
            f"interactive p99 {p99}ms over the {deadline_ms}ms deadline"
        code, models = _http("GET", f"{fe.url}/v1/models")
        assert code == 200 and set(models["models"]) == set(names)
        code, health = _http("GET", f"{fe.url}/healthz")
        assert code == 200 and set(health["models"]) == set(names)
        res.update({
            "throughput_requests": total,
            "throughput_concurrency": concurrency,
            "qps": round(total / dt, 2),
            "p50_ms": _pctl(lats["interactive"], 50),
            "p99_ms": p99,
            "deadline_ms": deadline_ms,
        })
        return fe
    except BaseException:
        fe.close()
        raise


def _phase_overload(res, fe, model, deadline_ms):
    """Mixed-priority flood of ONE model with a tiny batch-class quota:
    batch sheds (429s) while interactive stays whole and in-deadline."""
    with fe.router._lock:
        pools = [e.pool for e in fe.router._models.values() if e.pool]
    for p in pools:
        for b in p.batchers:
            b.batch_queue_depth = 2  # overload knob: shed batch early
        for e in p.engines:
            # a cpu-tick MLP never builds a queue: give every coalesced
            # batch a real service time so the closed loop overloads
            orig = e.infer

            def slowed(*arrays, _orig=orig):
                time.sleep(0.02)
                return _orig(*arrays)

            e.infer = slowed
    row = [[[0.5] * 16]]
    jobs = [(model, "interactive", deadline_ms, 24, row)
            for _ in range(24)] + \
           [(model, "batch", deadline_ms, 24, row) for _ in range(24)]
    counts, lats, _dt = _closed_loop(fe.url, jobs)

    def frac(klass, code):
        tot = sum(n for (k, c), n in counts.items() if k == klass)
        return (sum(n for (k, c), n in counts.items()
                    if k == klass and c == code) / tot) if tot else 0.0

    shed_b, shed_i = frac("batch", 429), frac("interactive", 429)
    assert counts.get(("batch", 429), 0) > 0, \
        f"overload never shed batch: {counts}"
    assert shed_b > shed_i, \
        f"batch shed frac {shed_b:.3f} !> interactive {shed_i:.3f}"
    p99_i = _pctl(lats.get("interactive", []), 99)
    assert p99_i is not None and p99_i <= deadline_ms, \
        f"interactive p99 {p99_i}ms over deadline under overload"
    # the per-class counters made it to /metrics with model labels
    code, _ = _http("GET", f"{fe.url}/healthz")
    assert code == 200
    import urllib.request
    text = urllib.request.urlopen(fe.url + "/metrics",
                                  timeout=30).read().decode()
    shed_lines = [ln for ln in text.splitlines()
                  if "shed_total{" in ln and 'class="batch"' in ln
                  and f'model="{model}"' in ln]
    assert shed_lines, "no per-class shed series on /metrics"
    res.update({
        "overload_counts": {f"{k}:{c}": n
                            for (k, c), n in sorted(counts.items())},
        "overload_shed_frac_batch": round(shed_b, 3),
        "overload_shed_frac_interactive": round(shed_i, 3),
        "overload_p99_interactive_ms": p99_i,
    })


def _phase_lru_cycle(res, tmp, paths, device=None):
    """Budget-bound router over HTTP: load -> LRU-evict -> reload, and
    an over-budget model 507s BEFORE any plan enters any cache."""
    # probe: measured resident of one tiny model at replicas=1 — the
    # artifacts are architecturally identical, so r is each model's cost
    with ServingFrontend(replicas=1, buckets=[1, 8], device=device) as probe:
        code, st = _http("POST", f"{probe.url}/v1/models/pa:load",
                         {"path": paths["alpha"]})
        assert code == 200, f"probe load: {code} {st}"
        r = int(st["resident_bytes"])
        plans_each = int(st["plans"])
        code, st_b = _http("POST", f"{probe.url}/v1/models/pb:load",
                           {"path": paths["beta"]})
        assert code == 200 and int(st_b["resident_bytes"]) == r, \
            "identical artifacts measured different plan residents"
    need = int(manifest_need_bytes(paths["alpha"]))
    assert r > 0 and need > 0
    budget = 2 * r + need - 1   # alpha+beta fit; a third forces evicts
    gamma = _export_mlp(tmp, "gamma")
    # wide enough that its weights alone pass the budget (a card's plans
    # hold whole allocator segments, so the budget is larger there)
    omega = _export_mlp(tmp, "omega", in_dim=256,
                        hidden=max(2048, 2 * budget // (4 * 256)))
    need_omega = int(manifest_need_bytes(omega))
    assert need_omega > budget, \
        f"omega estimate {need_omega} does not exceed budget {budget}"
    fe = ServingFrontend(replicas=1, buckets=[1, 8], budget=budget,
                         device=device)
    try:
        u = fe.url
        assert _http("POST", f"{u}/v1/models/alpha:load",
                     {"path": paths["alpha"]})[0] == 200
        assert _http("POST", f"{u}/v1/models/beta:load",
                     {"path": paths["beta"]})[0] == 200
        # touch beta so alpha is the LRU victim
        row = [[[0.5] * 16]]
        assert _http("POST", f"{u}/v1/models/beta:predict",
                     {"inputs": row})[0] == 200
        code, _ = _http("POST", f"{u}/v1/models/gamma:load",
                        {"path": gamma})
        assert code == 200, f"gamma load: {code}"
        code, models = _http("GET", f"{u}/v1/models")
        held = set(models["models"])
        assert held == {"beta", "gamma"}, \
            f"expected alpha LRU-evicted, table = {held}"
        # reload alpha: the cycle closes (beta is now the LRU victim)
        assert _http("POST", f"{u}/v1/models/alpha:load",
                     {"path": paths["alpha"]})[0] == 200
        code, models = _http("GET", f"{u}/v1/models")
        held = set(models["models"])
        assert held == {"gamma", "alpha"}, f"reload cycle broke: {held}"
        assert _http("POST", f"{u}/v1/models/alpha:predict",
                     {"inputs": row})[0] == 200
        # over-budget model: 507 from the admission preflight BEFORE
        # eviction and BEFORE any plan compiles — table/caches untouched
        before = _http("GET", f"{u}/v1/models")[1]
        plans_before = sum(m.get("plans", 0)
                           for m in before["models"].values())
        code, payload = _http("POST", f"{u}/v1/models/omega:load",
                              {"path": omega})
        assert code == 507, f"over-budget load gave {code}: {payload}"
        after = _http("GET", f"{u}/v1/models")[1]
        assert set(after["models"]) == held, \
            f"507 mutated the table: {set(after['models'])}"
        plans_after = sum(m.get("plans", 0)
                          for m in after["models"].values())
        assert plans_after == plans_before == 2 * plans_each
        assert after["resident_bytes"] == before["resident_bytes"] \
            == 2 * r
        assert _http("GET", f"{u}/v1/models/omega")[0] == 404
        res.update({
            "lru_budget_bytes": budget,
            "lru_resident_per_model": r,
            "lru_evictions_seen": 2,
            "overbudget_status": code,
            "overbudget_need_bytes": need_omega,
        })
    finally:
        fe.close()


def selftest(requests=512, concurrency=64, replicas=2,
             deadline_ms=15000, device=None):
    """The acceptance run. Returns the result dict; "ok" gates exit."""
    res = {"metric": "serving_frontend_selftest",
           "concurrency": concurrency, "replicas": replicas}
    tmp = tempfile.mkdtemp(prefix="mxa_frontend_")
    try:
        paths = {"alpha": _export_mlp(tmp, "alpha"),
                 "beta": _export_mlp(tmp, "beta")}
        fe = _phase_throughput(res, paths, requests, concurrency,
                               replicas, deadline_ms, device)
        try:
            _phase_overload(res, fe, "alpha", deadline_ms)
        finally:
            fe.close()
        _phase_lru_cycle(res, tmp, paths, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["ok"] = True
    return res


def bench(requests=768, concurrency=64, replicas=2, batch_frac=0.25,
          deadline_ms=15000, device=None):
    """One mixed-priority closed loop for bench.py's serving_net lane:
    prints QPS / p50 / p99 / shed fraction at `concurrency`."""
    tmp = tempfile.mkdtemp(prefix="mxa_frontend_bench_")
    try:
        paths = {"alpha": _export_mlp(tmp, "alpha"),
                 "beta": _export_mlp(tmp, "beta")}
        return _bench_run(paths, requests, concurrency, replicas,
                          batch_frac, deadline_ms, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _bench_run(paths, requests, concurrency, replicas, batch_frac,
               deadline_ms, device=None):
    n_batch = int(concurrency * batch_frac)
    n_inter = concurrency - n_batch
    with ServingFrontend(replicas=replicas, queue_depth=16,
                         batch_queue_depth=4, max_wait_us=1000,
                         buckets=[1, 4, 8], device=device) as fe:
        for name, path in paths.items():
            code, payload = _http("POST",
                                  f"{fe.url}/v1/models/{name}:load",
                                  {"path": path})
            if code != 200:
                raise RuntimeError(f"load {name}: {code} {payload}")
        names = list(paths)
        per = max(1, requests // concurrency)
        row = [[[0.5] * 16]]
        jobs = [(names[i % 2], "interactive", deadline_ms, per, row)
                for i in range(n_inter)] + \
               [(names[i % 2], "batch", deadline_ms, per, row)
                for i in range(n_batch)]
        counts, lats, dt = _closed_loop(fe.url, jobs)
    total = sum(counts.values())
    ok = sum(n for (_, c), n in counts.items() if c == 200)
    shed = sum(n for (_, c), n in counts.items() if c == 429)
    inter = lats.get("interactive", [])
    return {
        "metric": "serving_net",
        "device": str(fe.router.device),
        "concurrency": concurrency,
        "replicas": replicas,
        "models": len(names),
        "requests": total,
        "completed": ok,
        "qps": round(ok / dt, 2),
        "p50_ms": _pctl(inter, 50),
        "p99_ms": _pctl(inter, 99),
        "shed_frac": round(shed / total, 4) if total else 0.0,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.serving.frontend",
        description="HTTP serving front door over a ModelRouter")
    ap.add_argument("models", nargs="*", default=[],
                    help=".mxa artifacts to pre-load (named by their "
                         "manifest model_name / file stem)")
    ap.add_argument("--selftest", action="store_true",
                    help="socket-level acceptance run; one JSON line")
    ap.add_argument("--bench", action="store_true",
                    help="closed-loop load numbers; one JSON line")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--replicas", type=int, default=None)
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--concurrency", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    if args.selftest:
        try:
            res = selftest(requests=args.requests or 512,
                           concurrency=args.concurrency,
                           replicas=args.replicas or 2, device=args.device)
        except AssertionError as e:
            res = {"metric": "serving_frontend_selftest", "ok": False,
                   "error": str(e)}
        print(json.dumps(res), flush=True)
        return 0 if res.get("ok") else 1
    if args.bench:
        res = bench(requests=args.requests or 768,
                    concurrency=args.concurrency,
                    replicas=args.replicas or 2, device=args.device)
        print(json.dumps(res), flush=True)
        return 0
    fe = ServingFrontend(host=args.host, port=args.port,
                         replicas=args.replicas, device=args.device)
    for path in args.models:
        name = os.path.splitext(os.path.basename(path))[0]
        fe.router.load(name, path)
    print(json.dumps({"serving": fe.url,
                      "models": fe.router.models()}), flush=True)
    try:
        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        return 0
    finally:
        fe.close()


if __name__ == "__main__":
    sys.exit(main())
