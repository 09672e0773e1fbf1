"""Metrics registry: the process-wide store of Prometheus-shaped metrics.

Counterpart of mxnet_tpu/telemetry/registry.py. Three metric types:

  - ``Counter``   monotonically increasing total (tokens emitted)
  - ``Gauge``     point-in-time value that can go either way (occupancy)
  - ``Histogram`` bounded-bucket distribution (step latency): a fixed tuple
    of upper bounds, one int cell per bucket plus +Inf, running sum/count.

Everything is host-side Python ints/floats behind one small lock per
metric: recording never touches the card and never synchronises it.

The registry also absorbs the profiler's counter-export hooks
(``profiler.register_counter_export``: serving, device_feed, checkpoint,
amp, devstats, embed register there): ``render_prometheus()`` snapshots
every hook and flattens its numeric fields into ``mxnet_<hook>_<key>``
gauges, so one ``/metrics`` scrape carries every subsystem. The
registry's own metrics go back the other way through a ``"telemetry"``
profiler hook, so ``profiler.dump()`` embeds them too.
"""
from __future__ import annotations

import bisect
import math
import re
import threading

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "get_registry",
           "counter", "gauge", "histogram"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name):
    """Prometheus metric-name charset ([a-zA-Z_:][a-zA-Z0-9_:]*)."""
    name = _NAME_RE.sub("_", str(name))
    if not name or name[0].isdigit():
        name = "_" + name
    return name


class _Metric:
    """Shared shell: name, help text, one lock. `labels` are constant
    per-metric labels stamped on every rendered sample (e.g. serving's
    model="resnet") — identity the metric NAME shouldn't carry."""

    kind = "untyped"

    def __init__(self, name, help="", labels=None):
        self.name = _sanitize(name)
        self.help = help
        self.labels = {}
        for k, v in dict(labels or {}).items():
            v = str(v).replace("\\", "\\\\").replace('"', '\\"')
            self.labels[_sanitize(str(k))] = v
        self._lock = threading.Lock()

    def _labeled(self, lines):
        if not self.labels:
            return lines
        return [_with_labels(line, self.labels) for line in lines]


class Counter(_Metric):
    """Monotonic total. `inc` only — a counter that goes down is a gauge."""

    kind = "counter"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels=labels)
        self._value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"Counter {self.name}: inc by negative {n}")
        with self._lock:
            self._value += n

    def value(self):
        with self._lock:
            return self._value

    def _render(self):
        return self._labeled([f"{self.name} {_fmt(self.value())}"])

    def _snapshot(self):
        return self.value()


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels=labels)
        self._value = 0.0

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    def value(self):
        with self._lock:
            return self._value

    def _render(self):
        return self._labeled([f"{self.name} {_fmt(self.value())}"])

    def _snapshot(self):
        return self.value()


# Latency-flavored default bounds (seconds): sub-ms serving hops through
# multi-minute stalls. 17 buckets — the whole histogram is ~20 machine
# words, bounded forever.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


class Histogram(_Metric):
    """Fixed-bound bucket histogram (Prometheus semantics: `le` upper
    bounds, cumulative at render time, +Inf implicit last)."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=None, labels=None):
        super().__init__(name, help, labels=labels)
        bounds = tuple(sorted(float(b) for b in (buckets or
                                                 DEFAULT_BUCKETS)))
        if not bounds:
            raise ValueError(f"Histogram {self.name}: needs >=1 bucket")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)      # last cell = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v):
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self):
        with self._lock:
            return {"buckets": dict(zip(self.bounds, self._counts)),
                    "inf": self._counts[-1], "sum": self._sum,
                    "count": self._count}

    def percentile(self, p):
        """Bucket-resolution percentile estimate (upper bound of the
        bucket holding the p-th sample); None when empty. Exact enough
        for healthz/step summaries — /metrics exports the raw buckets so
        real quantiles happen server-side."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if not total:
            return None
        target = max(1, math.ceil(p / 100.0 * total))
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= target:
                return self.bounds[i] if i < len(self.bounds) \
                    else float("inf")
        return float("inf")

    def _render(self):
        with self._lock:
            counts = list(self._counts)
            s, n = self._sum, self._count
        lines = []
        acc = 0
        for bound, c in zip(self.bounds, counts):
            acc += c
            lines.append(f'{self.name}_bucket{{le="{_fmt(bound)}"}} {acc}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {n}')
        lines.append(f"{self.name}_sum {_fmt(s)}")
        lines.append(f"{self.name}_count {n}")
        return self._labeled(lines)

    def _snapshot(self):
        snap = self.snapshot()
        snap["p50"] = self.percentile(50)
        snap["p99"] = self.percentile(99)
        return {"count": snap["count"], "sum": round(snap["sum"], 6),
                "p50": snap["p50"], "p99": snap["p99"]}


def _fmt(v):
    """Prometheus float formatting: integers render bare, floats use
    repr (full precision), non-finite use +Inf/-Inf/NaN."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _with_labels(line, labels):
    """Merge constant labels into one exposition sample line (comment
    lines pass through; existing labels like histogram `le` keep their
    place after the constants)."""
    if not line or line.startswith("#"):
        return line
    name, sep, value = line.partition(" ")
    if not sep:                             # pragma: no cover - malformed
        return line
    pairs = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    if "{" in name:
        name = name.replace("{", "{" + pairs + ",", 1)
    else:
        name = f"{name}{{{pairs}}}"
    return f"{name} {value}"


class Registry:
    """Name -> metric store. `counter/gauge/histogram` are get-or-create
    (same name + same kind returns the existing instance, so any module
    can grab a handle without coordination; a kind clash raises).

    `series=` registers ANOTHER instance under the same metric name —
    the Prometheus shape of one name rendered with different constant
    label sets (one decode engine's series beside another's). The store
    key becomes (name, series); rendering emits the HELP/TYPE header once
    per name and every series' samples under it."""

    def __init__(self, absorb_profiler=True):
        self._absorb = absorb_profiler
        self._lock = threading.Lock()
        self._metrics = {}          # insertion-ordered
        self._const_labels = {}     # stamped on every rendered sample

    # -- constant labels -----------------------------------------------------

    def set_constant_labels(self, labels):
        """Labels attached to EVERY sample this registry renders —
        process-wide identity, e.g. {"rank": "1"}, so a multi-rank scrape
        distinguishes the ranks' series. Replaces the previous set; {}
        clears."""
        clean = {}
        for k, v in dict(labels or {}).items():
            v = str(v).replace("\\", "\\\\").replace('"', '\\"')
            clean[_sanitize(str(k))] = v
        with self._lock:
            self._const_labels = clean

    def constant_labels(self):
        with self._lock:
            return dict(self._const_labels)

    # -- creation -----------------------------------------------------------

    def _get_or_create(self, cls, name, help, series=None, **kw):
        name = _sanitize(name)
        key = name if series is None else f"{name}\x00{series}"
        with self._lock:
            m = self._metrics.get(key)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"requested {cls.kind}")
                return m
            m = cls(name, help=help, **kw)
            # snapshot() needs one flat key per instance; the rendered
            # metric NAME stays shared across series
            m.snapshot_name = name if series is None \
                else _sanitize(f"{name}__{series}")
            self._metrics[key] = m
            return m

    def counter(self, name, help="", labels=None, series=None):
        return self._get_or_create(Counter, name, help, series=series,
                                   labels=labels)

    def gauge(self, name, help="", labels=None, series=None):
        return self._get_or_create(Gauge, name, help, series=series,
                                   labels=labels)

    def histogram(self, name, help="", buckets=None, labels=None,
                  series=None):
        return self._get_or_create(Histogram, name, help, series=series,
                                   buckets=buckets, labels=labels)

    # -- reading ------------------------------------------------------------

    def own_metrics(self):
        with self._lock:
            return list(self._metrics.values())

    def get(self, name):
        with self._lock:
            return self._metrics.get(_sanitize(name))

    def snapshot(self):
        """{name: value-or-histogram-summary} of the registry's own
        metrics (a series under ``{name}__{series}``): what flows back
        into ``profiler.dump()`` through the "telemetry" hook (absorbed
        hooks are not exported again)."""
        return {getattr(m, "snapshot_name", m.name): m._snapshot()
                for m in self.own_metrics()}

    def absorbed(self):
        """Snapshot of every profiler counter-export hook but the
        registry's own "telemetry" one; {} when absorption is off."""
        if not self._absorb:
            return {}
        from .. import profiler
        out = profiler.export_counters()
        out.pop("telemetry", None)
        return out

    def render_prometheus(self):
        """The /metrics payload (text exposition format 0.0.4): the
        registry's metrics with their HELP/TYPE headers, then every
        absorbed profiler hook flattened to ``mxnet_<hook>_<key>`` gauges
        (a nested one-level dict becomes labeled series, e.g.
        ``batch_hist{bucket="8"}``); a native name wins a collision.
        Constant labels go on every sample."""
        lines = []
        seen = set()
        for m in self.own_metrics():
            # series instances share a metric name: header once per name
            if m.name not in seen:
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m._render())
            seen.add(m.name)
        for hook, snap in sorted(self.absorbed().items()):
            if not isinstance(snap, dict):
                continue
            prefix = _sanitize(f"mxnet_{hook}")
            for key, val in snap.items():
                name = _sanitize(f"{prefix}_{key}")
                if name in seen:
                    continue
                if isinstance(val, dict):
                    series = [(str(k), v) for k, v in sorted(val.items())
                              if isinstance(v, (int, float))
                              and not isinstance(v, bool)]
                    if not series:
                        continue
                    seen.add(name)
                    lines.append(f"# TYPE {name} gauge")
                    for k, v in series:
                        k = k.replace("\\", "\\\\").replace('"', '\\"')
                        lines.append(f'{name}{{bucket="{k}"}} {_fmt(v)}')
                elif isinstance(val, (int, float, bool)):
                    seen.add(name)
                    lines.append(f"# TYPE {name} gauge")
                    lines.append(f"{name} {_fmt(val)}")
        const = self.constant_labels()
        if const:
            lines = [_with_labels(line, const) for line in lines]
        return "\n".join(lines) + "\n"

_default = Registry()
_hook_registered = [False]


def _ensure_profiler_backexport():
    """The registry's own snapshot as the profiler's "telemetry" counter
    hook, so ``profiler.dump()`` / ``export_counters()`` carry it."""
    if _hook_registered[0]:
        return
    from .. import profiler
    profiler.register_counter_export("telemetry", _default.snapshot)
    _hook_registered[0] = True


def get_registry():
    _ensure_profiler_backexport()
    return _default


def counter(name, help="", labels=None, series=None):
    return get_registry().counter(name, help=help, labels=labels,
                                  series=series)


def gauge(name, help="", labels=None, series=None):
    return get_registry().gauge(name, help=help, labels=labels,
                                series=series)


def histogram(name, help="", buckets=None, labels=None, series=None):
    return get_registry().histogram(name, help=help, buckets=buckets,
                                    labels=labels, series=series)
