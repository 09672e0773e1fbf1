"""CheckpointManager — fault-tolerant, asynchronous checkpoints
(counterpart of mxnet_tpu/checkpoint/manager.py, format 2).

Commit protocol (crash-consistent at every instant):

    <dir>/.staging-step-XXXXXXXXXX.<pid>/
        shard-00000-of-0000N/                (1) per shard: the payload
            arrays.nd  [optimizer.bin]           files, each fsynced
            MANIFEST.json                    (2) the shard's manifest
        shard-00001-of-0000N/ ...                LAST (sha256 and size
                                                 of every payload)
        TOPOLOGY.json                        (3) the step's seal LAST:
                                                 topology, the shard set
                                                 with each manifest's
                                                 sha256, the array ->
                                                 shard map, the meta
    <dir>/step-XXXXXXXXXX/                   (4) os.replace(staging,
                                                 final), then fsync of
                                                 the parent directory
    old steps                                (5) retention: keep-last-N
                                                 and best-k by metric,
                                                 counted per commit

``kill -9`` before (4) leaves a ``.staging-*`` directory, swept by the
next manager; after (4) the step is durable. Restore takes the newest
``step-*`` whose shard set is complete against its TOPOLOGY.json and
whose checksums all hold, and falls back a step past a torn, missing or
bit-rotted one (``ckpt_fallback_total``). Shards are host-side splits
(axis 0 when it divides, else whole arrays), so a restore reassembles
the logical arrays for any shard count. Format-1 directories (one
MANIFEST.json) still restore. The JAX package reads these commits, and
the port reads its commits (``state.py`` says which payloads cross).

Shard I/O retries transient OSErrors with exponential backoff
(``MXNET_CHECKPOINT_RETRIES`` attempts from ``MXNET_CHECKPOINT_BACKOFF_S``
seconds; ``ckpt_retry_total``).

Async saves: the capture copies the state (``state.py``); a saver thread
moves the copies to the host, serializes, writes and fsyncs while
training goes on, one snapshot in flight at most, its exception raised
on the training thread at the next save or wait.

SIGTERM (``install_sigterm_hook``) sets ``preempted``; the fits take one
final blocking checkpoint at the next batch boundary and exit 143.

Crash injection (``python -m mxnet_tpu_torch.checkpoint --selftest``):
``MXNET_CHECKPOINT_INJECT_CRASH=<point>@<step>``, point one of
``mid-arrays`` (torn payload), ``pre-rename`` (staging complete, no
commit), ``post-rename`` (committed), SIGKILLs the process there.

One process writes every shard. A commit records ``ckpt.stage`` /
``ckpt.seal`` spans (phase "ckpt") and a ``ckpt.commit`` event in the
trace, the saver thread beats the stall watchdog per shard, and the
counters export through ``profiler.register_counter_export("checkpoint")``.
The JAX package's cooperative commit of several processes
(``sharded=True`` over ``dist``) waits for ROADMAP queue 1 item 16.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import signal
import threading
import time

from .. import profiler
from ..base import MXNetError
from ..telemetry import tracing as _tracing
from ..telemetry import watchdog as _watchdog
from .state import TrainingState

_STEP_PREFIX = "step-"
_STAGING_PREFIX = ".staging-"
_MANIFEST = "MANIFEST.json"
_TOPOLOGY = "TOPOLOGY.json"
_SHARD_PREFIX = "shard-"
_FORMAT = 2


def last_sealed_commit(directory):
    """The newest sealed commit under ``directory``, found without a
    manager: a ``step-N`` directory holding the seal its committer wrote
    last (TOPOLOGY.json for format 2, MANIFEST.json for format 1), so a
    commit torn before its seal is never offered as a restart point.
    Returns {"step", "path", "sealed"}, or None. Presence only:
    ``restore()`` still checks the checksums and falls back past a
    damaged commit."""
    try:
        entries = os.listdir(directory)
    except OSError:
        return None
    best = None
    for name in entries:
        if not name.startswith(_STEP_PREFIX):
            continue
        body = name[len(_STEP_PREFIX):]
        if ".r" in body:                    # pre-elastic partial dirs
            continue
        try:
            step = int(body)
        except ValueError:
            continue
        path = os.path.join(directory, name)
        seal = None
        for fname in (_TOPOLOGY, _MANIFEST):
            if os.path.isfile(os.path.join(path, fname)):
                seal = fname
                break
        if seal is None:
            continue
        if best is None or step > best["step"]:
            best = {"step": step, "path": path, "sealed": seal}
    return best


def _crash_requested(point, step):
    spec = os.environ.get("MXNET_CHECKPOINT_INJECT_CRASH")
    if not spec:
        return False
    want, _, at = spec.partition("@")
    if want != point:
        return False
    return not at or int(at) == int(step)


def _maybe_crash(point, step):
    if _crash_requested(point, step):
        os.kill(os.getpid(), signal.SIGKILL)


def _fsync_dir(path):
    """Make a rename durable: fsync the containing directory."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class CheckpointManager:
    """Atomic, asynchronous, retained checkpoints under one directory.

    Parameters
    ----------
    directory : checkpoint root (created if missing)
    keep_last_n : committed steps to retain by recency (default
        `MXNET_CHECKPOINT_KEEP`, 3; <=0 keeps everything)
    keep_best_k : additionally retain the best k steps by the `metric`
        passed to save() (default `MXNET_CHECKPOINT_BEST_K`, 0)
    best_mode : "max" (default) or "min" — what "best" means
    async_save : overlap serialization/write with training on a saver
        thread (default `MXNET_CHECKPOINT_ASYNC`, on)
    num_shards : shards a commit (default `MXNET_CHECKPOINT_SHARDS`;
        <=0: the visible cards, 1 without one)
    sharded : the JAX package's cooperative commit of several processes;
        one process writes every shard here, so True changes nothing
        (several processes wait for ROADMAP queue 1 item 16)
    """

    def __init__(self, directory, keep_last_n=None, keep_best_k=None,
                 best_mode="max", async_save=None, num_shards=None,
                 sharded=False, logger=None):
        from .. import config
        self.directory = os.path.abspath(os.fspath(directory))
        self.keep_last_n = int(config.get("MXNET_CHECKPOINT_KEEP")
                               if keep_last_n is None else keep_last_n)
        self.keep_best_k = int(config.get("MXNET_CHECKPOINT_BEST_K")
                               if keep_best_k is None else keep_best_k)
        if best_mode not in ("max", "min"):
            raise ValueError("best_mode must be 'max' or 'min'")
        self.best_mode = best_mode
        self.sharded = bool(sharded)
        self.logger = logger or logging.getLogger(
            "mxnet_tpu_torch.checkpoint")
        n = int(config.get("MXNET_CHECKPOINT_SHARDS")
                if num_shards is None else num_shards)
        if n <= 0:
            import torch
            n = max(1, torch.cuda.device_count())
        self.num_shards = n
        self._retries = max(0, int(config.get("MXNET_CHECKPOINT_RETRIES")))
        self._backoff_s = float(config.get("MXNET_CHECKPOINT_BACKOFF_S"))
        self._inject_io = int(os.environ.get(
            "MXNET_CHECKPOINT_INJECT_IO_FAIL", "0") or 0)
        self._async = bool(config.get("MXNET_CHECKPOINT_ASYNC")) \
            if async_save is None else bool(async_save)

        self._cond = threading.Condition()
        self._job = None          # (state, step, metric) pending
        self._thread = None
        self._err = None
        self._closed = False
        self._counters = {"ckpt_commits": 0, "ckpt_failures": 0,
                          "ckpt_bytes": 0, "ckpt_save_us": 0,
                          "ckpt_wait_us": 0, "ckpt_last_step": -1,
                          "ckpt_retained": 0, "ckpt_retry_total": 0,
                          "ckpt_fallback_total": 0}
        self._preempted = threading.Event()
        self._prev_sigterm = None

        os.makedirs(self.directory, exist_ok=True)
        self._sweep_staging()
        profiler.register_counter_export("checkpoint", self.counters)

    # -- naming --------------------------------------------------------------

    def _step_dirname(self, step):
        return f"{_STEP_PREFIX}{int(step):010d}"

    def _shard_dirname(self, k):
        return f"{_SHARD_PREFIX}{int(k):05d}-of-{self.num_shards:05d}"

    def _parse_step(self, name):
        """step int for a committed dir, else None. Pre-elastic per-rank
        `step-N.r<rank>` dirs are partial states — skipped."""
        if not name.startswith(_STEP_PREFIX):
            return None
        body = name[len(_STEP_PREFIX):]
        if ".r" in body:
            return None
        try:
            return int(body)
        except ValueError:
            return None

    def _sweep_staging(self):
        """Remove leftover staging dirs from crashed runs (never-committed
        partial writes — exactly what the protocol makes discardable)."""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return
        for name in entries:
            if name.startswith(_STAGING_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # -- public API ----------------------------------------------------------

    def save(self, state, step, metric=None, blocking=None):
        """Commit `state` as checkpoint `step`. Async by default: returns
        once the (cheap, reference-holding) snapshot is handed to the
        saver thread, blocking only while a PREVIOUS save is still in
        flight (bounded memory: one snapshot). `blocking=True` forces the
        commit to finish before returning (final/preemption saves)."""
        if not isinstance(state, TrainingState):
            raise TypeError("save() takes a TrainingState "
                            "(checkpoint.state.capture_module_state, "
                            "capture_trainer_state, capture_fused_state)")
        self._raise_pending()
        if blocking is None:
            blocking = not self._async
        step = int(step)
        state.meta.setdefault("step", step)
        if blocking:
            # drain an async commit in flight first: two overlapping
            # commits race on staging directories and retention sweeps
            self.wait()
            t0 = time.perf_counter()
            try:
                self._commit_local(state, step, metric)
            finally:
                with self._cond:
                    self._counters["ckpt_wait_us"] += int(
                        (time.perf_counter() - t0) * 1e6)
        else:
            self._enqueue(state, step, metric)

    def wait(self):
        """Drain any in-flight async save (re-raising its error here)."""
        with self._cond:
            t0 = time.perf_counter()
            while self._job is not None:
                self._cond.wait(0.2)
            self._counters["ckpt_wait_us"] += int(
                (time.perf_counter() - t0) * 1e6)
        self._raise_pending()

    def close(self):
        """Drain + stop the saver thread (idempotent)."""
        try:
            self.wait()
        finally:
            # _thread is handed off under _cond everywhere (_enqueue
            # starts it under the lock); join OUTSIDE the lock — the
            # saver loop takes _cond to finish, so joining while holding
            # it would deadlock
            with self._cond:
                self._closed = True
                self._cond.notify_all()
                t = self._thread
            if t is not None:
                t.join(timeout=60)
                with self._cond:
                    if self._thread is t:
                        self._thread = None

    def steps(self):
        """Committed step numbers visible to this process, ascending.
        (Presence of the final dir name — restore() additionally
        validates checksums.)"""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return []
        out = []
        for name in entries:
            s = self._parse_step(name)
            if s is not None and (
                    os.path.isfile(os.path.join(self.directory, name,
                                                _TOPOLOGY))
                    or os.path.isfile(os.path.join(self.directory, name,
                                                   _MANIFEST))):
                out.append(s)
        return sorted(out)

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step=None):
        """Load the newest committed checkpoint (or exactly `step`),
        VALIDATING shard-set completeness against TOPOLOGY.json and every
        per-shard manifest checksum — a commit with a missing, torn or
        bit-rotted shard is skipped (warned, `ckpt_fallback_total`) and
        the next-newest valid one is returned. None when nothing
        restorable exists. Arrays come back as reassembled host numpy:
        feeding them to init_params / import_training_state reshards
        them onto the CURRENT mesh, whatever its size."""
        self.wait()
        candidates = self.steps()
        if step is not None:
            candidates = [s for s in candidates if s == int(step)]
        for s in sorted(candidates, reverse=True):
            path = os.path.join(self.directory, self._step_dirname(s))
            st = self._load_validated(path)
            if st is not None:
                return st
            with self._cond:
                self._counters["ckpt_fallback_total"] += 1
            self.logger.warning(
                "checkpoint: %s failed validation; falling back to the "
                "previous committed step", path)
        return None

    # -- preemption hook -----------------------------------------------------

    def install_sigterm_hook(self):
        """Arm graceful preemption: SIGTERM sets `preempted`, which the
        training loop polls at batch boundaries to take ONE final
        blocking checkpoint and exit. (Deferred-flag design: saving from
        inside a signal handler could observe a cursor/params pair from
        mid-update.) Main-thread only (signal module contract); returns
        False elsewhere. Idempotent: a second install would capture our
        own hook as `_prev_sigterm`, and _on_sigterm's chain-to-previous
        would then recurse forever when the signal finally arrived."""
        if self._prev_sigterm is not None:
            return True
        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM,
                                               self._on_sigterm)
            return True
        except ValueError:
            return False

    def remove_sigterm_hook(self):
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
            self._prev_sigterm = None

    def _on_sigterm(self, signum, frame):
        self.logger.warning(
            "checkpoint: SIGTERM — will take a final checkpoint at the "
            "next batch boundary and exit")
        self._preempted.set()
        if callable(self._prev_sigterm):
            self._prev_sigterm(signum, frame)

    @property
    def preempted(self):
        return self._preempted.is_set()

    # -- counters ------------------------------------------------------------

    def counters(self):
        with self._cond:
            c = dict(self._counters)
        save_us = c["ckpt_save_us"]
        c["ckpt_overlap_frac"] = round(
            1.0 - min(c["ckpt_wait_us"], save_us) / save_us, 4) \
            if save_us else None
        return c

    # -- saver thread --------------------------------------------------------

    def _raise_pending(self):
        with self._cond:
            err, self._err = self._err, None
        if err is not None:
            raise RuntimeError("checkpoint: async save failed") from err

    def _enqueue(self, state, step, metric):
        with self._cond:
            if self._thread is None or not self._thread.is_alive():
                self._closed = False
                self._thread = threading.Thread(
                    target=self._saver_loop,
                    name="mxnet-torch-checkpoint-saver", daemon=True)
                self._thread.start()
            t0 = time.perf_counter()
            while self._job is not None and self._err is None:
                self._cond.wait(0.2)
            self._counters["ckpt_wait_us"] += int(
                (time.perf_counter() - t0) * 1e6)
        self._raise_pending()
        with self._cond:
            self._job = (state, step, metric)
            self._cond.notify_all()

    def _saver_loop(self):
        while True:
            with self._cond:
                while self._job is None and not self._closed:
                    self._cond.wait(0.2)
                if self._job is None:
                    return
                job = self._job
            try:
                self._commit_local(*job)
            except BaseException as e:     # re-raised on the train thread
                with self._cond:
                    self._err = e
                    self._counters["ckpt_failures"] += 1
            finally:
                with self._cond:
                    self._job = None
                    self._cond.notify_all()

    # -- shard I/O (retries, fault injection) ---------------------------------

    def _with_retries(self, fn, what):
        """Run one shard I/O operation, retrying transient OSErrors
        MXNET_CHECKPOINT_RETRIES times with exponential backoff from
        MXNET_CHECKPOINT_BACKOFF_S. Retries tick `ckpt_retry_total`."""
        for i in range(self._retries + 1):
            try:
                return fn()
            except OSError as e:
                if i >= self._retries:
                    raise
                with self._cond:
                    self._counters["ckpt_retry_total"] += 1
                delay = self._backoff_s * (2 ** i)
                self.logger.warning(
                    "checkpoint: transient I/O failure (%s: %s) — retry "
                    "%d/%d in %.2fs", what, e, i + 1, self._retries,
                    delay)
                time.sleep(delay)

    def _write_file(self, path, payload):
        def _write():
            inject = False
            with self._cond:
                if self._inject_io > 0:  # selftest/CI fault injection
                    self._inject_io -= 1
                    inject = True
            if inject:
                raise OSError(f"injected I/O failure "
                              f"(MXNET_CHECKPOINT_INJECT_IO_FAIL): {path}")
            with open(path, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
        self._with_retries(_write, f"write {os.path.basename(path)}")

    def _read_file(self, path):
        def _read():
            with open(path, "rb") as f:
                return f.read()
        return self._with_retries(_read, f"read {os.path.basename(path)}")

    # -- commit protocol -----------------------------------------------------

    def _current_topology(self, state):
        import torch
        topo = {"device_count": max(1, torch.cuda.device_count()),
                "process_count": 1, "process_index": 0,
                "num_shards": self.num_shards}
        mesh_axes = (state.meta.get("trainer") or {}).get("mesh")
        if mesh_axes:
            topo["mesh_axes"] = mesh_axes
        return topo

    def _write_shard(self, parent, k, files, step):
        """Write one shard dir (payload files fsynced, shard MANIFEST
        last). Returns (dirname, manifest_sha256, payload_bytes)."""
        sname = self._shard_dirname(k)
        sdir = os.path.join(parent, sname)
        os.makedirs(sdir, exist_ok=True)
        manifest_files = {}
        nbytes = 0
        for fname, payload in files:
            path = os.path.join(sdir, fname)
            if _crash_requested("mid-arrays", step) \
                    and fname.startswith("arrays"):
                with open(path, "wb") as f:      # torn payload, then die
                    f.write(payload[:max(1, len(payload) // 2)])
                    f.flush()
                    os.fsync(f.fileno())
                os.kill(os.getpid(), signal.SIGKILL)
            self._write_file(path, payload)
            manifest_files[fname] = {
                "sha256": hashlib.sha256(payload).hexdigest(),
                "bytes": len(payload)}
            nbytes += len(payload)
        mpayload = json.dumps(
            {"format": _FORMAT, "shard": int(k),
             "num_shards": self.num_shards, "files": manifest_files},
            indent=1).encode("utf-8")
        self._write_file(os.path.join(sdir, _MANIFEST), mpayload)
        # a long commit reads as alive to the stall watchdog
        _watchdog.beat(f"checkpoint_saver step {step} shard {k}")
        return sname, hashlib.sha256(mpayload).hexdigest(), nbytes

    def _seal_step(self, staging, state, step, metric, shards, shard_map):
        """TOPOLOGY.json LAST — the step's global commit record."""
        topo = {"format": _FORMAT, "step": int(step),
                "metric": None if metric is None else float(metric),
                "wall_time": time.time(), "meta": state.meta,
                "topology": self._current_topology(state),
                "shards": shards, "shard_map": shard_map}
        self._write_file(os.path.join(staging, _TOPOLOGY),
                         json.dumps(topo, indent=1).encode("utf-8"))

    @staticmethod
    def _zero_ownership(state):
        """A trainer's {array name: owning shard} map when the snapshot
        carries one (the JAX package's ZeRO and sharded-embedding
        trainers: meta.trainer.zero / .embed): their arrays stay whole in
        the shard that owns them."""
        tmeta = state.meta.get("trainer") or {}
        merged = {}
        for sub in ("zero", "embed"):
            own = (tmeta.get(sub) or {}).get("ownership")
            if isinstance(own, dict):
                merged.update(own)
        return merged or None

    def _commit_local(self, state, step, metric):
        t0 = time.perf_counter()
        _watchdog.beat(f"checkpoint_saver step {step}")
        final = os.path.join(self.directory, self._step_dirname(step))
        staging = os.path.join(
            self.directory,
            f"{_STAGING_PREFIX}{os.path.basename(final)}.{os.getpid()}")
        if os.path.isdir(staging):
            shutil.rmtree(staging)
        os.makedirs(staging)
        shard_files, shard_map = state.to_shard_files(
            self.num_shards, ownership=self._zero_ownership(state))
        shards = {}
        nbytes = 0
        # the "ckpt" phase spans cover stage and seal; the enclosing
        # commit event has no phase, so StepLogger counts each committed
        # microsecond once
        t_stage = time.perf_counter()
        for k, files in enumerate(shard_files):
            sname, msha, n = self._write_shard(staging, k, files, step)
            shards[sname] = {"manifest_sha256": msha}
            nbytes += n
        _tracing.event("ckpt.stage", t_stage, phase="ckpt", step=int(step))
        t_seal = time.perf_counter()
        self._seal_step(staging, state, step, metric, shards, shard_map)
        _maybe_crash("pre-rename", step)
        if os.path.isdir(final):               # re-save of the same step
            shutil.rmtree(final)
        os.replace(staging, final)
        _fsync_dir(self.directory)
        _tracing.event("ckpt.seal", t_seal, phase="ckpt", step=int(step))
        _maybe_crash("post-rename", step)
        _tracing.event("ckpt.commit", t0, step=int(step))
        self._finish_commit(step, nbytes, time.perf_counter() - t0)

    def _finish_commit(self, step, nbytes, save_s):
        with self._cond:
            self._counters["ckpt_commits"] += 1
            self._counters["ckpt_bytes"] += nbytes
            self._counters["ckpt_save_us"] += int(save_s * 1e6)
            self._counters["ckpt_last_step"] = int(step)
        from ..telemetry.registry import histogram
        histogram("mxnet_checkpoint_save_seconds",
                  help="wall time per committed checkpoint "
                       "(serialize+fsync+rename)").observe(save_s)
        self._apply_retention()

    # -- load/validate -------------------------------------------------------

    def _load_validated(self, path):
        """The state of one commit, or None when it is damaged (a missing
        or torn file, a checksum that does not hold). A payload that is
        whole but that this package cannot read raises (MXNetError)."""
        try:
            if os.path.isfile(os.path.join(path, _TOPOLOGY)):
                return self._load_sharded(path)
            return self._load_format1(path)
        except MXNetError:
            raise
        except Exception as e:
            self.logger.warning("checkpoint: cannot load %s (%s)", path, e)
            return None

    def _load_sharded(self, path):
        """Elastic (format 2) loader: the shard SET must be complete
        against TOPOLOGY.json — an absent shard dir/file is a hard
        validation failure (caller falls back a step), never a raw
        FileNotFoundError at array-load time."""
        topo = json.loads(
            self._read_file(os.path.join(path, _TOPOLOGY)).decode("utf-8"))
        shard_blobs = []
        for sname in sorted(topo.get("shards") or {}):
            sdir = os.path.join(path, sname)
            mpath = os.path.join(sdir, _MANIFEST)
            if not os.path.isfile(mpath):
                raise ValueError(f"{sname}: shard manifest absent")
            mpayload = self._read_file(mpath)
            want = topo["shards"][sname].get("manifest_sha256")
            if want and hashlib.sha256(mpayload).hexdigest() != want:
                raise ValueError(f"{sname}: manifest checksum mismatch")
            manifest = json.loads(mpayload.decode("utf-8"))
            blobs = {}
            for fname, info in manifest["files"].items():
                fpath = os.path.join(sdir, fname)
                if not os.path.isfile(fpath):
                    raise ValueError(f"{sname}/{fname}: shard file absent")
                payload = self._read_file(fpath)
                if len(payload) != int(info["bytes"]) or \
                        hashlib.sha256(payload).hexdigest() != \
                        info["sha256"]:
                    raise ValueError(f"{sname}/{fname}: checksum mismatch")
                blobs[fname] = payload
            shard_blobs.append(blobs)
        st = TrainingState.from_shard_blobs(shard_blobs, topo)
        st.meta.setdefault("topology", topo.get("topology") or {})
        return st

    def _load_format1(self, path):
        """The format-1 layout (one MANIFEST.json): still read."""
        with open(os.path.join(path, _MANIFEST), "rb") as f:
            manifest = json.loads(f.read().decode("utf-8"))
        blobs = {}
        for fname, info in manifest["files"].items():
            payload = self._read_file(os.path.join(path, fname))
            if len(payload) != int(info["bytes"]) or \
                    hashlib.sha256(payload).hexdigest() != \
                    info["sha256"]:
                raise ValueError(f"{fname}: checksum mismatch")
            blobs[fname] = payload
        return TrainingState.from_files(blobs, manifest)

    # -- retention -----------------------------------------------------------

    def _read_metric(self, step):
        d = os.path.join(self.directory, self._step_dirname(step))
        for fname in (_TOPOLOGY, _MANIFEST):
            try:
                with open(os.path.join(d, fname), "rb") as f:
                    return json.loads(
                        f.read().decode("utf-8")).get("metric")
            except Exception:
                continue
        return None

    def _apply_retention(self):
        steps = self.steps()
        if self.keep_last_n <= 0:
            with self._cond:
                self._counters["ckpt_retained"] = len(steps)
            return
        keep = set(steps[-self.keep_last_n:])
        if self.keep_best_k > 0:
            scored = [(s, self._read_metric(s)) for s in steps]
            scored = [(s, m) for s, m in scored if m is not None]
            scored.sort(key=lambda sm: sm[1],
                        reverse=(self.best_mode == "max"))
            keep.update(s for s, _ in scored[:self.keep_best_k])
        for s in steps:
            if s not in keep:
                shutil.rmtree(
                    os.path.join(self.directory, self._step_dirname(s)),
                    ignore_errors=True)
        with self._cond:
            self._counters["ckpt_retained"] = len(keep)
