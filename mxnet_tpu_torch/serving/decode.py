"""Decode-mode serving: per-session KV-cache pool + continuous batching.

Counterpart of mxnet_tpu/serving/decode.py on PyTorch. A prompt is
*prefilled* once into its session's block of a preallocated KV pool; then
one fixed-shape *decode step* (q_len = 1) advances every live session by
one token. The invariants carry over, restated for the port:

* **One fixed-shape step over all ``num_slots`` rows, any occupancy.**
  Sessions join at prefill and leave at EOS / token budget / max_len by
  flipping a per-slot ``active`` flag; the step's shapes never change.
  Every per-slot op is row-independent (masked writes, per-row attention,
  per-row argmax), so a session's logits do not depend on who else is
  resident.
* **Caches are pool memory, sized up front.** The pool (layers x {K,V} x
  num_slots x kv_heads x max_len x head_dim, f32) is allocated once, after
  a preflight against the device-memory budget; a submit that finds no
  block and no queue seat raises :class:`SessionPoolFull`. The port
  updates the pool in place (JAX donated it between steps), so one pool
  exists in steady state.

* **Each plan is compiled once.** On the card the step is one CUDA graph
  and each prompt bucket another, captured into one memory pool and
  replayed in order on the engine's stream: the step and the smallest
  bucket at construction, every other bucket at its first use (the JAX
  engine's AOT-compiled plans). A step's host work is one copy of the
  (3, N) token/length/active state into the step graph's static input,
  one replay and one copy of (2, N) next tokens and lengths back. Slot
  and prompt length reach a prefill graph as device scalars, so neither
  re-keys it. A capture or replay that fails raises; nothing falls back
  to eager dispatch. On the CPU a plan calls the model eagerly and is
  counted as compiled at its first use all the same.

Attention goes through ``ops.attention``: the flash kernel for prefill,
the decode kernel for steps. A weight with a ``{name}__scale`` companion
(weight-only int8/fp8 from ``contrib.quantization.calibrate_weights``)
goes through ``ops.quantization.quantized_matmul``. The float matmuls of
an unquantized model are ``torch.matmul`` in full float32:
``torch.backends.cuda.matmul.allow_tf32`` stays False, its default.

``python -m mxnet_tpu_torch.serving.decode --selftest [--device cpu]``
decodes 8 staggered sessions on a small GQA model and checks the streams
are identical to one-at-a-time decode.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from collections import deque

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import _build
from .. import config as _config
from ..base import MXNetError
from ..context import resolve_device
from ..convert import load_decode_artifact, to_torch_params
from ..ops.launches import add as _add_launches, counts as _launch_counts
from ..ops.attention import decode_attention, flash_attention
from ..ops.quantization import quantized_matmul
from ..telemetry import counter, devstats, gauge, histogram
from .batcher import Future

__all__ = ["DecodeModel", "DecodeEngine", "Session", "SessionPool",
           "SessionPoolFull", "prompt_buckets"]


def _int_knob(name):
    v = _config.get(name)
    return int(v) if v is not None else None


def prompt_buckets(max_len, lo=8):
    """Power-of-two prompt-bucket ladder: lo, 2*lo, ... capped at (and
    always including) max_len."""
    if max_len < 1:
        raise MXNetError("prompt_buckets: max_len must be >= 1")
    buckets, b = [], lo
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(int(max_len))
    return buckets


def _index1(v, device):
    """An int or a 0-d integer tensor as a (1,) int64 index on ``device``."""
    return torch.as_tensor(v, device=device).reshape(1).long()


# -- model ------------------------------------------------------------------

class DecodeModel(nn.Module):
    """GQA transformer LM: pre-norm RMSNorm blocks, learned positions,
    tanh-GELU MLP, no biases, untied head.

    Its parameters carry the names :meth:`param_names` gives ("embed",
    "l0.wq", ..., "head"), plus a ``{name}__scale`` companion for each
    weight-only quantized matrix; :meth:`load_params` installs them.
    Every linear goes through :meth:`_mm`, which takes the fused
    quantized matmul when the companion exists. The kernels run on the
    card and their plain versions on the CPU.
    """

    def __init__(self, vocab, layers=2, d_model=64, heads=4, kv_heads=None,
                 d_ff=None, max_len=None):
        super().__init__()
        kv_heads = int(kv_heads) if kv_heads else int(heads)
        if heads % kv_heads:
            raise MXNetError("DecodeModel: heads % kv_heads != 0")
        if d_model % heads:
            raise MXNetError("DecodeModel: d_model % heads != 0")
        self.vocab = int(vocab)
        self.layers = int(layers)
        self.d_model = int(d_model)
        self.heads = int(heads)
        self.kv_heads = kv_heads
        self.d_ff = int(d_ff) if d_ff else 4 * self.d_model
        self.max_len = int(max_len) if max_len \
            else _int_knob("MXNET_DECODE_MAX_LEN")
        self.head_dim = self.d_model // self.heads
        for i in range(self.layers):
            self.add_module(f"l{i}", nn.Module())

    def config(self):
        """Manifest-serializable architecture block."""
        return {"vocab": self.vocab, "layers": self.layers,
                "d_model": self.d_model, "heads": self.heads,
                "kv_heads": self.kv_heads, "d_ff": self.d_ff,
                "max_len": self.max_len}

    @classmethod
    def from_config(cls, cfg, **kw):
        return cls(vocab=cfg["vocab"], layers=cfg["layers"],
                   d_model=cfg["d_model"], heads=cfg["heads"],
                   kv_heads=cfg["kv_heads"], d_ff=cfg["d_ff"],
                   max_len=cfg["max_len"], **kw)

    def param_names(self):
        names = ["embed", "pos"]
        for i in range(self.layers):
            names += [f"l{i}.ln1", f"l{i}.wq", f"l{i}.wk", f"l{i}.wv",
                      f"l{i}.wo", f"l{i}.ln2", f"l{i}.w1", f"l{i}.w2"]
        names += ["lnf", "head"]
        return names

    def init_params(self, seed=0):
        """Random numpy params from ``seed`` — the JAX package's recipe,
        so both packages start from the same values."""
        rng = np.random.RandomState(seed)
        d, h, hkv, hd = self.d_model, self.heads, self.kv_heads, \
            self.head_dim

        def w(*shape):
            return (rng.standard_normal(shape)
                    / np.sqrt(shape[0])).astype(np.float32)

        p = {"embed": w(self.vocab, d), "pos": 0.1 * w(self.max_len, d),
             "lnf": np.ones(d, np.float32), "head": w(d, self.vocab)}
        for i in range(self.layers):
            p[f"l{i}.ln1"] = np.ones(d, np.float32)
            p[f"l{i}.wq"] = w(d, h * hd)
            p[f"l{i}.wk"] = w(d, hkv * hd)
            p[f"l{i}.wv"] = w(d, hkv * hd)
            p[f"l{i}.wo"] = w(h * hd, d)
            p[f"l{i}.ln2"] = np.ones(d, np.float32)
            p[f"l{i}.w1"] = w(d, self.d_ff)
            p[f"l{i}.w2"] = w(self.d_ff, d)
        return p

    def load_params(self, params):
        """Install {name: array or tensor} as this module's parameters
        (replacing any installed before). Every name of
        :meth:`param_names` is required; ``{name}__scale`` companions
        are the only other names accepted."""
        names = set(self.param_names())
        missing = sorted(names - set(params))
        extra = sorted(n for n in params if n not in names
                       and not (n.endswith("__scale")
                                and n[:-len("__scale")] in names))
        if missing or extra:
            raise MXNetError(f"DecodeModel.load_params: missing {missing}, "
                             f"unknown {extra}")
        for mod in self.modules():
            mod._parameters.clear()
        for name, t in to_torch_params(params).items():
            owner, _, leaf = name.rpartition(".")
            mod = self.get_submodule(owner) if owner else self
            mod.register_parameter(leaf, nn.Parameter(t, requires_grad=False))
        return self

    def session_cache_bytes(self, dtype_size=4):
        """Per-session KV block: layers x {K,V} x kv_heads x max_len x
        head_dim — the unit the pool admission math is denominated in."""
        return (self.layers * 2 * self.kv_heads * self.max_len
                * self.head_dim * dtype_size)

    def init_cache(self, num_slots, device=None):
        """(kc, vc): per-layer lists of (num_slots, kv_heads, max_len,
        head_dim) f32 zeros on ``device`` (default: the params')."""
        if device is None:
            device = self.embed.device
        shape = (num_slots, self.kv_heads, self.max_len, self.head_dim)
        kc = [torch.zeros(shape, dtype=torch.float32, device=device)
              for _ in range(self.layers)]
        vc = [torch.zeros(shape, dtype=torch.float32, device=device)
              for _ in range(self.layers)]
        return kc, vc

    # -- building blocks ----------------------------------------------------

    def _mm(self, p, name, x):
        w = p[name]
        s = p.get(name + "__scale")
        if s is not None:
            return quantized_matmul(x, w, s)
        return torch.matmul(x, w)

    @staticmethod
    def _norm(x, g):
        var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + 1e-6)).to(x.dtype) * g

    def _mlp(self, p, pfx, x):
        hn2 = self._norm(x, p[pfx + "ln2"])
        return x + self._mm(p, pfx + "w2", F.gelu(
            self._mm(p, pfx + "w1", hn2), approximate="tanh"))

    # -- prefill ------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, kc, vc, tokens, true_len, slot):
        """One prompt into one pool slot. tokens (1, S_b) integer tensor
        padded to its bucket; positions >= ``true_len`` are pad, which
        causal masking keeps out of every valid row and the decode
        step's length mask keeps dead. Writes K/V for all S_b positions
        into ``slot`` of kc/vc IN PLACE. ``true_len`` and ``slot`` are
        ints or 0-d integer tensors on the cache's device (the engine's
        plans pass tensors: indexing by them reads nothing back to the
        host, so one CUDA graph a bucket serves every slot and length).
        Returns (kc, vc, first_token, last_logits) with the logits of row
        ``true_len - 1`` only."""
        p = dict(self.named_parameters())
        s_b = tokens.shape[1]
        h, hkv, hd = self.heads, self.kv_heads, self.head_dim
        slot = _index1(slot, kc[0].device)
        last = _index1(true_len, tokens.device) - 1
        x = p["embed"][tokens.long()] + p["pos"][None, :s_b]
        for i in range(self.layers):
            pfx = f"l{i}."
            hn = self._norm(x, p[pfx + "ln1"])
            q, k, v = (self._mm(p, pfx + w, hn).reshape(1, s_b, n, hd)
                       .transpose(1, 2).contiguous()
                       for w, n in (("wq", h), ("wk", hkv), ("wv", hkv)))
            a = flash_attention(q, k, v, causal=True)
            x = x + self._mm(p, pfx + "wo",
                             a.transpose(1, 2).reshape(1, s_b, h * hd))
            x = self._mlp(p, pfx, x)
            kc[i][:, :, :s_b].index_copy_(0, slot, k)
            vc[i][:, :, :s_b].index_copy_(0, slot, v)
        # logits of the LAST VALID position only: the vocab projection
        # runs on one row, not the bucket
        xlast = x[0].index_select(0, last)
        logits = self._mm(p, "head", self._norm(xlast, p["lnf"]))
        tok0 = torch.argmax(logits[0], dim=-1).to(torch.int32)
        return kc, vc, tok0, logits[0]

    # -- decode step --------------------------------------------------------

    @torch.no_grad()
    def step(self, kc, vc, tokens, lengths, active):
        """Advance every slot one token. tokens/lengths (N,) int32,
        active (N,) bool tensors. Writes each row's K/V at position
        lengths[n] IN PLACE, attends over lengths[n]+1 cached positions,
        emits the greedy next token. Inactive rows pass their token and
        length through; their cache writes land in their own retired
        block, which the next prefill overwrites before any read.
        Returns (kc, vc, next_tokens, new_lengths, logits)."""
        p = dict(self.named_parameters())
        n = tokens.shape[0]
        h, hkv, hd = self.heads, self.kv_heads, self.head_dim
        pos = lengths.clamp(0, self.max_len - 1)
        att_len = (pos + 1).clamp(max=self.max_len).to(torch.int32)
        x = p["embed"][tokens.long()] + p["pos"][pos.long()]
        rows = torch.arange(n, device=tokens.device)
        cols = pos.long()
        for i in range(self.layers):
            pfx = f"l{i}."
            hn = self._norm(x, p[pfx + "ln1"])
            q = self._mm(p, pfx + "wq", hn).reshape(n, h, hd)
            k = self._mm(p, pfx + "wk", hn).reshape(n, hkv, hd)
            v = self._mm(p, pfx + "wv", hn).reshape(n, hkv, hd)
            kc[i][rows, :, cols] = k
            vc[i][rows, :, cols] = v
            a = decode_attention(q, kc[i], vc[i], att_len)
            x = x + self._mm(p, pfx + "wo", a.reshape(n, h * hd))
            x = self._mlp(p, pfx, x)
        logits = self._mm(p, "head", self._norm(x, p["lnf"]))
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(active, nxt, tokens)
        new_len = torch.where(active, pos + 1, lengths)
        return kc, vc, nxt, new_len, logits


# -- sessions ---------------------------------------------------------------

class SessionPoolFull(devstats.HBMPreflightError):
    """No free KV block and the wait queue is at capacity (HTTP 507: the
    block the session needs is pool memory)."""


class Session:
    """One generation request: prompt in, greedy token stream out.
    ``t_emit`` holds the perf_counter time of each emitted token;
    ``logits`` (when the submit asked for them) each token's logits row
    as a float32 numpy array."""

    __slots__ = ("sid", "prompt", "max_new", "eos_id", "tokens", "slot",
                 "future", "t_submit", "t_done", "t_emit", "logits")

    def __init__(self, sid, prompt, max_new, eos_id, deadline,
                 keep_logits=False):
        self.sid = sid
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.tokens = []
        self.slot = None
        self.future = Future(deadline)
        self.t_submit = time.monotonic()
        self.t_done = None
        self.t_emit = []
        self.logits = [] if keep_logits else None

    def result(self, timeout=None):
        return self.future.result(timeout)


class SessionPool:
    """Slot bookkeeping for the KV pool: free list, wait queue, admission.

    The caller (DecodeEngine) holds its lock around every method. A
    session is admitted iff a block or a queue seat exists; it binds to a
    concrete slot at prefill time and frees it at retirement."""

    def __init__(self, num_slots, max_len, session_bytes, queue_depth=None):
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.session_bytes = int(session_bytes)
        self.queue_depth = (2 * self.num_slots if queue_depth is None
                            else int(queue_depth))
        self._free = list(range(self.num_slots - 1, -1, -1))
        self._by_slot = {}
        self._pending = deque()
        self.admitted = 0
        self.rejected = 0
        self.retired = 0

    def occupancy(self):
        return self.num_slots - len(self._free)

    def depth(self):
        return len(self._pending)

    def admit(self, sess):
        if len(self._pending) >= self.queue_depth and not self._free:
            self.rejected += 1
            raise SessionPoolFull(
                f"decode pool full: {self.num_slots} KV blocks "
                f"({self.session_bytes} B each) busy and wait queue at "
                f"{self.queue_depth}")
        self._pending.append(sess)
        self.admitted += 1

    def assign(self):
        """Bind queued sessions to free slots; returns the newly bound."""
        out = []
        while self._pending and self._free:
            sess = self._pending.popleft()
            sess.slot = self._free.pop()
            self._by_slot[sess.slot] = sess
            out.append(sess)
        return out

    def retire(self, slot):
        sess = self._by_slot.pop(slot)
        self._free.append(slot)
        self.retired += 1
        return sess

    def active_sessions(self):
        return dict(self._by_slot)


# -- plans ------------------------------------------------------------------

class _Plan:
    """One compiled plan of an engine: ``fn(static_in) -> (out, logits)``
    over a static int32 input buffer on the device, ``out`` an int32
    tensor and ``logits`` (rows, vocab).

    On the card the plan is a CUDA graph (:meth:`capture`): its inputs
    and outputs keep their addresses for the engine's lifetime, so the
    routes the kernel wrappers chose from addresses and shapes at capture
    stay right. :meth:`run` copies ``host_in`` (pinned) to the card,
    replays (or, on the CPU, calls ``fn``) and queues the copy of ``out``
    into ``host_out``; the caller synchronises before reading it. The
    plans of one engine share one memory pool, in which one graph's
    temporaries may lie where another's outputs do: a plan's outputs are
    copied out before any other plan of its engine runs."""

    def __init__(self, name, fn, in_shape, out_shape, device):
        cuda = device.type == "cuda"
        self.name = name
        self.fn = fn
        self.device = device
        self.host_in = torch.zeros(in_shape, dtype=torch.int32,
                                   pin_memory=cuda)
        self.host_out = torch.zeros(out_shape, dtype=torch.int32,
                                    pin_memory=cuda)
        self.host_logits = None
        self.static_in = torch.zeros(in_shape, dtype=torch.int32,
                                     device=device)
        self.out = self.logits = self.graph = None
        self.launches = {}          # counter -> launches a replay makes
        self.replays = 0
        self.capture_s = 0.0
        self.peak_bytes = 0

    def capture(self, stream, pool):
        """A warm-up call on ``stream`` outside any graph (it loads every
        kernel the plan launches, sizes cuBLAS's workspace for the stream
        and creates decode attention's arrival counters for it, none of
        which may happen under capture), then the capture into ``pool``.
        ``launches`` is what the counters moved by across the capture:
        launches by other threads during it would be counted with it."""
        dev = self.device
        t0 = time.perf_counter()
        torch.cuda.synchronize(dev)
        with torch.cuda.stream(stream):
            self.static_in.copy_(self.host_in, non_blocking=True)
            self.fn(self.static_in)
        stream.synchronize()
        before = _launch_counts()
        mark = devstats.capture_mark(pool, dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            # "thread_local": a capture runs on the engine's loop thread
            # (a prompt bucket at its first use) while callers' threads
            # may allocate or synchronise on the card. Under "global"
            # their calls would fail, or break the capture; a call of
            # this thread that is unsafe under capture still raises
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                self.out, self.logits = self.fn(self.static_in)
            finally:
                graph.capture_end()
        after = _launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        self.peak_bytes = devstats.capture_peak(pool, dev, mark)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def run(self, rows=()):
        """Run the plan on ``host_in``; queue ``out`` and the logits
        ``rows`` to the host (``host_out``, ``host_logits``)."""
        self.static_in.copy_(self.host_in, non_blocking=True)
        if self.graph is None:
            self.out, self.logits = self.fn(self.static_in)
        else:
            self.graph.replay()
            _add_launches(self.launches)
        self.replays += 1
        self.host_out.copy_(self.out, non_blocking=True)
        if rows and self.host_logits is None:
            self.host_logits = torch.empty(
                self.logits.shape, dtype=self.logits.dtype,
                pin_memory=self.device.type == "cuda")
        for r in rows:
            # before the next replay overwrites the static logits
            self.host_logits[r].copy_(self.logits[r], non_blocking=True)

    def release(self):
        """Drop the graph and its outputs (their pool memory with them)."""
        self.graph = self.out = self.logits = None


# -- engine -----------------------------------------------------------------

class DecodeEngine:
    """Continuous-batching decode runtime over one :class:`DecodeModel`.

    A background loop owns the device state (params, KV pool, per-slot
    token/length/active vectors): it prefills queued sessions into free
    slots, then runs the decode-step plan while anyone is active. Callers
    use :meth:`submit` (non-blocking; returns a :class:`Session` whose
    future resolves to the token list) or :meth:`generate` (blocking).

    Accepts a (model, params) pair — params a {name: array or tensor}
    dict, or None when the model already holds its parameters — or a
    decode ``.mxa`` path (``contrib.export.export_decode_model`` of
    either package). ``device=None`` is the card and raises without CUDA;
    pass ``device="cpu"`` for the plain versions on the host.

    Plans (module docstring): ``step_compiles`` stays 1 whatever the
    occupancy; ``plan_compiles`` counts the step and every prompt bucket
    compiled; ``plan_resident_bytes`` is the bytes of the CUDA graphs'
    memory pool after the last capture (0 on the CPU, where no graph
    exists). The graphs hold the addresses of the model's parameters and
    of the KV pool: load no other params into the model while the engine
    is open; :meth:`close` releases them. The engine's series in the
    telemetry registry are the JAX
    engine's: ``mxnet_decode_tokens_total``, ``mxnet_decode_kv_occupancy``,
    ``mxnet_decode_kv_cache_bytes`` and ``mxnet_decode_step_seconds``,
    labelled ``engine=<name>``."""

    def __init__(self, model, params=None, num_slots=None, max_len=None,
                 queue_depth=None, name=None, device=None):
        self.device = resolve_device(device)
        if isinstance(model, (str, os.PathLike)):
            cfg, params, mname, _quant = load_decode_artifact(str(model))
            if max_len is not None:
                cfg = dict(cfg, max_len=int(max_len))
            model = DecodeModel.from_config(cfg)
            name = name or mname
        if params is not None:
            model.load_params(params)
        elif not dict(model.named_parameters()):
            raise MXNetError("DecodeEngine: params required with a model "
                             "that holds none")
        self.model = model
        self.name = str(name) if name else "decode"
        self.num_slots = int(num_slots) if num_slots \
            else _int_knob("MXNET_DECODE_SLOTS")
        self.max_len = model.max_len
        self.max_prompt = self.max_len - 1   # >= 1 token must be generable
        self._names = sorted(n for n, _ in model.named_parameters())
        self.params_bytes = sum(t.numel() * t.element_size()
                                for t in model.parameters())
        self.session_bytes = model.session_cache_bytes()
        self.cache_bytes = self.num_slots * self.session_bytes
        # pool admission: the whole KV pool + weights must fit the device
        # memory budget BEFORE anything is allocated on the card
        if devstats.enabled():
            devstats.preflight("%s.pool" % self.name,
                               self.cache_bytes + self.params_bytes,
                               what="decode KV pool + weights",
                               device=self.device)
        model.to(self.device)
        self._k, self._v = model.init_cache(self.num_slots, self.device)
        self._tokens = np.zeros(self.num_slots, np.int32)
        self._lengths = np.zeros(self.num_slots, np.int32)
        self._active = np.zeros(self.num_slots, np.bool_)

        self.pool = SessionPool(self.num_slots, self.max_len,
                                self.session_bytes, queue_depth)
        self._buckets = prompt_buckets(self.max_len)
        self._step_plan = None
        self._prefill_plans = {}
        self.plan_compiles = 0
        self.step_compiles = 0      # stays 1: occupancy never re-keys
        self.plan_resident_bytes = 0
        self.step_executions = 0
        self.prefill_executions = 0
        self.tokens_generated = 0
        self.sessions_done = 0
        self._t0 = time.monotonic()
        self._seq = 0
        self._cv = threading.Condition()
        self._closed = False

        # one series per engine name under shared metric names, so
        # concurrent engines never fight over label sets
        labels = {"engine": self.name}
        self._m_tokens = counter(
            "mxnet_decode_tokens_total",
            help="greedy tokens emitted across all sessions",
            labels=labels, series=self.name)
        self._m_occ = gauge(
            "mxnet_decode_kv_occupancy",
            help="KV-pool slots holding a live session", labels=labels,
            series=self.name)
        self._m_cache = gauge(
            "mxnet_decode_kv_cache_bytes",
            help="bytes preallocated for the KV pool", labels=labels,
            series=self.name)
        self._m_step = histogram(
            "mxnet_decode_step_seconds",
            help="wall time of one decode-step dispatch", labels=labels,
            series=self.name)
        self._m_cache.set(self.cache_bytes)
        self._m_occ.set(0)

        self._stream = self._pool = None
        if self.device.type == "cuda":
            _build.library("flash_attention")   # builds every kernel
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        self._ensure_step_plan()
        self._prefill_plan(self._buckets[0])
        self._thread = threading.Thread(target=self._loop,
                                        name=f"{self.name}-loop",
                                        daemon=True)
        self._thread.start()

    # -- plans --------------------------------------------------------------

    def _pool_bytes(self):
        """Bytes of the segments the graphs' memory pool holds."""
        if self._pool is None:
            return 0
        return devstats.pool_bytes(self._pool, self.device)

    def _compile(self, plan, label):
        """Capture ``plan`` (on the card) and account for it, as the JAX
        engine's ``_record_plan``: record it, preflight its peak against
        what the plans already hold, note the compile."""
        if self._stream is not None:
            plan.capture(self._stream, self._pool)
        self.plan_compiles += 1
        pool = self._pool_bytes()
        if devstats.enabled():
            pname = f"{self.name}.{label}"
            devstats.record_program(
                pname, {"peak_bytes": plan.peak_bytes,
                        "resident_bytes": pool - self.plan_resident_bytes},
                kind="serving")
            devstats.preflight(pname, plan.peak_bytes,
                               resident_bytes=self.plan_resident_bytes,
                               what="decode plan", device=self.device)
            devstats.note_compile(pname)
        self.plan_resident_bytes = pool

    def _step_fn(self, state):
        _, _, nxt, new_len, logits = self.model.step(
            self._k, self._v, state[0], state[1], state[2].bool())
        return torch.stack([nxt, new_len]), logits

    def _prefill_fn(self, bucket, inp):
        # inp: the bucket's tokens, then the true length, then the slot
        _, _, tok0, logits = self.model.prefill(
            self._k, self._v, inp[:bucket].view(1, bucket), inp[bucket],
            inp[bucket + 1])
        return tok0.reshape(1), logits.reshape(1, -1)

    def _ensure_step_plan(self):
        if self._step_plan is None:
            n = self.num_slots
            plan = _Plan(f"{self.name}.step", self._step_fn, (3, n), (2, n),
                         self.device)
            self._compile(plan, "step")
            self.step_compiles += 1
            self._step_plan = plan
        return self._step_plan

    def _prefill_plan(self, bucket, slot=0):
        """The plan of prompt bucket ``bucket``, compiled at its first
        use; the warm-up call ahead of its capture writes a one-token
        prompt into ``slot``, which must hold no live session (the slot
        being prefilled: its prefill then overwrites it)."""
        plan = self._prefill_plans.get(bucket)
        if plan is None:
            plan = _Plan(f"{self.name}.prefill.b{bucket}",
                         functools.partial(self._prefill_fn, bucket),
                         (bucket + 2,), (1,), self.device)
            plan.host_in[bucket] = 1
            plan.host_in[bucket + 1] = slot
            self._compile(plan, "prefill.b%d" % bucket)
            self._prefill_plans[bucket] = plan
        return plan

    def _bucket_for(self, n):
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _stream_ctx(self):
        return contextlib.nullcontext() if self._stream is None \
            else torch.cuda.stream(self._stream)

    def _sync(self):
        if self._stream is not None:
            self._stream.synchronize()

    def plans(self):
        """One record a compiled plan: name, capture seconds, peak bytes,
        replays, and the launches one replay makes by counter (empty on
        the CPU)."""
        plans = [self._step_plan] + [self._prefill_plans[b]
                                     for b in sorted(self._prefill_plans)]
        return [{"name": p.name, "graph": p.graph is not None,
                 "capture_s": p.capture_s, "peak_bytes": p.peak_bytes,
                 "replays": p.replays, "launches": dict(p.launches)}
                for p in plans]

    def graph_launches(self):
        """{"captured": launches recorded in the graphs (each graph once),
        "replayed": launches their replays made}, by counter."""
        cap, rep = {}, {}
        for p in [self._step_plan, *self._prefill_plans.values()]:
            for k, n in p.launches.items():
                cap[k] = cap.get(k, 0) + n
                rep[k] = rep.get(k, 0) + n * p.replays
        return {"captured": cap, "replayed": rep}

    # -- public API ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens=None, eos_id=None,
               timeout_ms=None, keep_logits=False):
        """Queue one generation; returns a :class:`Session` immediately.
        Raises ValueError on a malformed/oversized prompt and
        :class:`SessionPoolFull` when no KV block or queue seat exists.
        ``keep_logits`` records each emitted token's logits row."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("decode: empty prompt")
        if any(t < 0 or t >= self.model.vocab for t in prompt):
            raise ValueError("decode: prompt token outside vocab "
                             f"[0, {self.model.vocab})")
        if len(prompt) > self.max_prompt:
            raise ValueError(
                f"decode: prompt length {len(prompt)} exceeds "
                f"max_len-1 = {self.max_prompt} (KV block holds "
                f"{self.max_len} positions incl. generated tokens)")
        max_new = int(max_new_tokens) if max_new_tokens \
            else _int_knob("MXNET_DECODE_MAX_NEW")
        if max_new < 1:
            raise ValueError("decode: max_new_tokens must be >= 1")
        deadline = (time.monotonic() + timeout_ms / 1000.0
                    if timeout_ms else None)
        with self._cv:
            if self._closed:
                raise RuntimeError("DecodeEngine is closed")
            self._seq += 1
            sess = Session(self._seq, prompt, max_new, eos_id, deadline,
                           keep_logits)
            self.pool.admit(sess)
            self._cv.notify_all()
        return sess

    def generate(self, prompt, max_new_tokens=None, eos_id=None,
                 timeout_ms=None):
        """Blocking submit: returns the generated token list."""
        return self.submit(prompt, max_new_tokens, eos_id,
                           timeout_ms).result()

    def stats(self):
        dt = max(time.monotonic() - self._t0, 1e-9)
        with self._cv:
            occ, depth = self.pool.occupancy(), self.pool.depth()
        return {"engine": self.name, "device": str(self.device),
                "num_slots": self.num_slots,
                "max_len": self.max_len, "occupancy": occ,
                "queue_depth": depth,
                "sessions_admitted": self.pool.admitted,
                "sessions_rejected": self.pool.rejected,
                "sessions_done": self.sessions_done,
                "tokens_generated": self.tokens_generated,
                "tokens_per_s": self.tokens_generated / dt,
                "step_executions": self.step_executions,
                "prefill_executions": self.prefill_executions,
                "plan_compiles": self.plan_compiles,
                "plan_resident_bytes": self.plan_resident_bytes,
                "session_cache_bytes": self.session_bytes,
                "kv_cache_bytes": self.cache_bytes,
                "params_bytes": self.params_bytes}

    def resident_bytes(self):
        return self.cache_bytes + self.params_bytes \
            + self.plan_resident_bytes

    def close(self, drain=True):
        with self._cv:
            if self._closed:
                return
            self._closed = True
            if not drain:
                while self.pool._pending:
                    sess = self.pool._pending.popleft()
                    sess.future._set_exception(
                        RuntimeError("DecodeEngine closed"))
            self._cv.notify_all()
        self._thread.join(timeout=60.0)
        if not self._thread.is_alive():
            for plan in [self._step_plan, *self._prefill_plans.values()]:
                plan.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- decode loop --------------------------------------------------------

    def _loop(self):
        # every plan runs on the engine's stream, one after another (the
        # graphs share one memory pool)
        with self._stream_ctx():
            self._serve_forever()

    def _serve_forever(self):
        while True:
            with self._cv:
                while (not self.pool._pending and not self.pool._by_slot
                       and not self._closed):
                    self._cv.wait()
                if (self._closed and not self.pool._pending
                        and not self.pool._by_slot):
                    return
                newly = self.pool.assign()
                self._m_occ.set(self.pool.occupancy())
            for sess in newly:
                try:
                    self._do_prefill(sess)
                except Exception as e:           # noqa: BLE001
                    self._fail(sess, e)
            if self._active.any():
                try:
                    self._do_step()
                except Exception as e:           # noqa: BLE001
                    # a failed step leaves every live stream without its
                    # next token: fail them all rather than hang callers
                    with self._cv:
                        live = [s for slot, s in self.pool._by_slot.items()
                                if self._active[slot]]
                    for sess in live:
                        self._fail(sess, e)

    def _fail(self, sess, exc):
        with self._cv:
            self.pool.retire(sess.slot)
            self._active[sess.slot] = False
            self._m_occ.set(self.pool.occupancy())
        sess.future._set_exception(exc)

    def _do_prefill(self, sess):
        n, slot = len(sess.prompt), sess.slot
        bucket = self._bucket_for(n)
        plan = self._prefill_plan(bucket, slot)
        inp = plan.host_in.numpy()
        inp[:] = 0
        inp[:n] = sess.prompt
        inp[bucket], inp[bucket + 1] = n, slot
        plan.run((0,) if sess.logits is not None else ())
        self._sync()
        self.prefill_executions += 1
        tok0 = int(plan.host_out[0])
        self._tokens[slot] = tok0
        self._lengths[slot] = n
        self._active[slot] = True
        if sess.logits is not None:
            sess.logits.append(plan.host_logits[0].float().numpy().copy())
        self._emit(sess, tok0)

    def _do_step(self):
        t0 = time.perf_counter()
        with self._cv:
            live = [(slot, s) for slot, s in self.pool._by_slot.items()
                    if self._active[slot]]
        rows = [slot for slot, s in live if s.logits is not None]
        plan = self._ensure_step_plan()
        state = plan.host_in.numpy()
        state[0], state[1], state[2] = \
            self._tokens, self._lengths, self._active
        plan.run(rows)
        self._sync()
        out = plan.host_out.numpy()
        self._tokens = out[0].copy()
        self._lengths = out[1].copy()
        self.step_executions += 1
        self._m_step.observe(time.perf_counter() - t0)
        for slot, sess in live:
            if sess.logits is not None:
                sess.logits.append(
                    plan.host_logits[slot].float().numpy().copy())
            self._emit(sess, int(self._tokens[slot]))

    def _emit(self, sess, tok):
        """Record one generated token; retire the session when its stream
        is complete (EOS, token budget, or cache exhausted)."""
        sess.tokens.append(tok)
        sess.t_emit.append(time.perf_counter())
        self.tokens_generated += 1
        self._m_tokens.inc()
        done = (len(sess.tokens) >= sess.max_new
                or (sess.eos_id is not None and tok == sess.eos_id)
                # the next step would write this token's K/V at position
                # lengths — no position left means the stream ends here
                or int(self._lengths[sess.slot]) >= self.max_len)
        if done:
            with self._cv:
                self.pool.retire(sess.slot)
                self._active[sess.slot] = False
                self._m_occ.set(self.pool.occupancy())
            sess.t_done = time.monotonic()
            self.sessions_done += 1
            sess.future._set(list(sess.tokens))


# -- selftest ---------------------------------------------------------------

def _selftest(sessions=8, new_tokens=40, stagger_ms=1.0, device=None):
    """8 concurrent staggered sessions vs the same prompts decoded one at
    a time through the SAME engine: the token streams must be identical
    and batched tokens/s higher."""
    model = DecodeModel(vocab=64, layers=2, d_model=64, heads=4,
                        kv_heads=2, d_ff=128, max_len=64)
    params = model.init_params(seed=7)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, model.vocab, size=rng.randint(3, 8)).tolist()
               for _ in range(sessions)]
    eng = DecodeEngine(model, params, num_slots=sessions, name="selftest",
                       device=device)
    try:
        eng.generate(prompts[0], max_new_tokens=2)

        t0 = time.perf_counter()
        seq = [eng.generate(p, max_new_tokens=new_tokens)
               for p in prompts]
        t_seq = time.perf_counter() - t0

        t0 = time.perf_counter()
        pending = []
        for p in prompts:
            pending.append(eng.submit(p, max_new_tokens=new_tokens))
            time.sleep(stagger_ms / 1000.0)   # staggered joins
        conc = [s.result(timeout=120.0) for s in pending]
        t_conc = time.perf_counter() - t0

        n_tok = sessions * new_tokens
        seq_tps = n_tok / t_seq
        conc_tps = n_tok / t_conc
        identical = conc == seq
        stats = eng.stats()
    finally:
        eng.close()
    return {"metric": "decode_selftest", "device": str(eng.device),
            "sessions": sessions, "new_tokens": new_tokens,
            "identical": bool(identical),
            "seq_tokens_per_s": seq_tps,
            "batched_tokens_per_s": conc_tps,
            "speedup": conc_tps / seq_tps,
            "step_executions": stats["step_executions"],
            "plan_compiles": stats["plan_compiles"],
            "kv_cache_bytes": stats["kv_cache_bytes"],
            "ok": bool(identical and conc_tps > seq_tps)}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.serving.decode",
        description="continuous-batching decode engine selftest")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if not args.selftest:
        ap.error("nothing to do (pass --selftest)")
    out = _selftest(sessions=args.sessions, new_tokens=args.new_tokens,
                    device=args.device)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
