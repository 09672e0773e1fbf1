"""Monitor: per-op output introspection during training (counterpart of
mxnet_tpu/monitor.py; the reference's python/mxnet/monitor.py).

The tap point is the executor's monitor callback
(``Executor.set_monitor_callback``: the unfused walk of the graph calls
it with each node's outputs, and with ``monitor_all`` each node's inputs
first). The monitor is a window recorder: ``tic()`` opens a window every
``interval`` steps, the executor's callbacks append (step, name, stat)
records while it is open, and ``toc()`` closes it, appends the final
outputs' stats, and renders them.
"""
from __future__ import annotations

import logging
import re

from .ndarray.ndarray import NDArray

__all__ = ["Monitor"]


def _mean_abs(x):
    """Default statistic: mean(|x|)."""
    return x.abs().mean()


def _render_stat(value):
    """Render a stat result (NDArray or list of NDArrays) to text."""
    values = value if isinstance(value, list) else [value]
    parts = []
    for v in values:
        if not isinstance(v, NDArray):
            parts.append(str(v))
        elif v.shape in ((1,), ()):
            parts.append(str(v.asscalar()))
        else:
            parts.append(str(v.asnumpy()))
    return "\t".join(parts) + "\t"


class Monitor:
    """Record statistics of intermediate outputs every `interval` batches.

    stat_func: NDArray -> NDArray (or list), default mean(|x|).
    pattern: regex filtering tapped entry names.
    sort: sort records by entry name before rendering.
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 monitor_all=False):
        self.interval = interval
        self.stat_func = stat_func or _mean_abs
        self.sort = sort
        self.monitor_all = monitor_all
        self._name_filter = re.compile(pattern)
        self._records = []
        self._window_open = False
        self.step = 0
        self._executors = []

    # Executor callback contract: fn(entry_name, NDArray)
    def __call__(self, name, array):
        if self._window_open and self._name_filter.match(name):
            self._records.append((self.step, name, self.stat_func(array)))

    # legacy attribute alias (reference exposes .stat_helper)
    @property
    def stat_helper(self):
        return self

    def install(self, exe):
        """Attach to an executor (the monitor itself is the callback)."""
        exe.set_monitor_callback(self, self.monitor_all)
        self._executors.append(exe)

    def _drain(self):
        """Wait until the attached executors' parameters are written on
        the card, so the stats reflect this step (the engine WaitToRead
        role)."""
        for exe in self._executors:
            for arr in exe.arg_arrays:
                arr.wait_to_read()

    def tic(self):
        """Open a recording window if this step is on the interval."""
        if self.step % self.interval == 0:
            self._drain()
            self._records = []
            self._window_open = True
        self.step += 1

    def toc(self):
        """Close the window; returns [(step, name, rendered_stat)]."""
        if not self._window_open:
            return []
        self._drain()
        for exe in self._executors:
            for name, out in zip(exe._output_names, exe.outputs):
                self._records.append((self.step, name, self.stat_func(out)))
        self._window_open = False
        records = sorted(self._records, key=lambda r: r[1]) if self.sort \
            else list(self._records)
        self._records = []
        return [(step, name, _render_stat(val))
                for (step, name, val) in records]

    def toc_print(self):
        """toc() + log each record."""
        for step, name, text in self.toc():
            logging.info("Batch: %7d %30s %s", step, name, text)
