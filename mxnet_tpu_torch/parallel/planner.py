"""Cost-model sharding planner over dp / ZeRO / tensor parallelism
(counterpart of mxnet_tpu/parallel/planner.py, ``mx.parallel.planner``).

One :class:`Plan` names a mesh shape over the axis vocabulary
(``mesh.AXIS_NAMES``), a per-parameter layout and the runtime knob
settings; :func:`plan_auto` picks one by its priced cost:

  candidates   dp, ZeRO-1, ZeRO-2 (1-D data mesh), dpK.tpT (tensor
               parallelism: ``param_specs`` on a data x model mesh) and
               dpK.tpT+zero2 (masters and optimizer state split jointly
               over both axes). pp is listed as unsupported: a generic
               Symbol carries no stage partition map.
  prefilter    an analytic per-replica memory lower bound
               (:func:`estimate_hbm_bytes`) against the budget
               (``devstats.hbm_budget``); a plan over it is rejected
               before anything else, and no trainer is built.
  scoring      a replica's step is priced from ``telemetry.costs`` (FLOPs
               and bytes from the Symbol's shapes, the collectives' bytes
               from the tensor-parallel layout pass the step itself walks),
               on the ``devstats.peaks`` table:

                 cost_s = max(flops/peak_flops, bytes/peak_bw)
                        + wire_bytes/wire_bw

               wire_bw is MXNET_PLAN_WIRE_GBPS (default 25 GB/s). Its peak
               bytes (the residency at the plan's shards plus the
               activations the backward keeps) over the budget rejects it
               too. Nothing runs and no training state is allocated.
  selection    argmin over (cost_s, name): two runs always agree.

``MXNET_PLAN=auto|dp|zero1|zero2|dpK.tpT[+zero1|+zero2]|tpT[...]``
selects the plan (auto = the planner); the chosen plan writes the six
runtime knobs (MXNET_ZERO_STAGE, MXNET_ZERO_BUCKET_MB,
MXNET_GRAD_COMPRESS, MXNET_DEVICE_FEED, MXNET_DEVICE_FEED_DEPTH,
MXNET_FUSED_K), each only where the user has not set it ("auto unless
set"). Degenerate plans (pure dp, pure ZeRO) construct the very trainers
a direct construction gives, so float32 training under the planner is
bit-identical to them.

The JAX package scores each plan from XLA's compiled program (cost
analysis, HLO collectives); its choice on a CPU mesh is not the port's,
whose wire is priced from the layout rather than read from HLO.

CLI: ``python -m mxnet_tpu_torch.parallel.planner --selftest | --explain
| --bench [--devices N] [--ctx cpu]`` over N replicas of the card (or of
the host); ``--hlo-audit`` reads XLA's HLO in the JAX package and exits 2.
"""
from __future__ import annotations

import os

import numpy as _np

from ..base import MXNetError
from .mesh import build_mesh

__all__ = ["Plan", "PlanReport", "ModelSpec", "parse_plan",
           "resolve_plan", "enumerate_candidates", "tp_param_specs",
           "estimate_hbm_bytes", "estimate_wire_bytes", "build_trainer",
           "score_plan", "plan_auto", "make_trainer", "resolve_wire_bw",
           "AUTO_KNOB_VARS"]

# the six runtime knobs a chosen plan writes ("auto unless set")
AUTO_KNOB_VARS = ("MXNET_ZERO_STAGE", "MXNET_ZERO_BUCKET_MB",
                  "MXNET_GRAD_COMPRESS", "MXNET_DEVICE_FEED",
                  "MXNET_DEVICE_FEED_DEPTH", "MXNET_FUSED_K")

_BUILT = [0]     # trainers build_trainer has constructed (tests read it)


def resolve_plan(value=None):
    """Plan spec string: the explicit argument, else MXNET_PLAN, else
    auto."""
    if value is None:
        from .. import config
        value = config.get("MXNET_PLAN", "auto")
    spec = str(value or "auto").strip().lower()
    return spec or "auto"


def resolve_wire_bw(value=None):
    """Cross-device wire bandwidth in bytes/s for the cost model
    (MXNET_PLAN_WIRE_GBPS, default 25 GB/s)."""
    if value is None:
        from .. import config
        value = config.get("MXNET_PLAN_WIRE_GBPS", "25")
    try:
        bw = float(value) * 1e9
    except (TypeError, ValueError):
        raise MXNetError(
            f"MXNET_PLAN_WIRE_GBPS must be a number, got {value!r}")
    if bw <= 0:
        raise MXNetError(
            f"MXNET_PLAN_WIRE_GBPS must be > 0, got {value!r}")
    return bw


class Plan:
    """One point of the planner's space: a named mesh shape plus the
    sharding mode and knob settings that make a trainer.

    ``axes`` is an ordered {axis_name: size} ("data" first, "model" when
    tensor parallelism is on); ``zero_stage`` > 0 splits masters and
    optimizer state jointly over all mesh axes (``parallel.zero``);
    ``param_specs`` (name -> spec tuple) is the tensor-parallel layout of
    a stage-0 plan. The knob fields feed :meth:`apply_env`.
    """

    def __init__(self, name, axes, zero_stage=0, param_specs=None,
                 compress="none", bucket_mb=None, fused_k=None,
                 feed_depth=2):
        self.name = str(name)
        self.axes = dict(axes)
        self.zero_stage = int(zero_stage)
        self.param_specs = dict(param_specs) if param_specs else None
        self.compress = compress
        self.bucket_mb = bucket_mb
        self.fused_k = fused_k
        self.feed_depth = int(feed_depth)
        if "data" not in self.axes:
            raise MXNetError(f"plan {name!r}: no data axis in {axes}")
        if self.zero_stage and self.param_specs:
            raise MXNetError(
                f"plan {name!r}: ZeRO plans split masters jointly over "
                "the mesh and keep compute model-replicated; param_specs "
                "only apply to stage-0 plans")

    @property
    def n_devices(self):
        n = 1
        for s in self.axes.values():
            n *= int(s)
        return n

    @property
    def model_factor(self):
        return self.n_devices // int(self.axes["data"])

    def mesh(self, devices=None):
        return build_mesh(self.axes, devices=devices)

    def knobs(self):
        """The knob values this plan writes."""
        return {
            "MXNET_ZERO_STAGE": str(self.zero_stage),
            "MXNET_ZERO_BUCKET_MB": str(self.bucket_mb
                                        if self.bucket_mb else 4),
            "MXNET_GRAD_COMPRESS": str(self.compress),
            "MXNET_DEVICE_FEED": "1",
            "MXNET_DEVICE_FEED_DEPTH": str(self.feed_depth),
            "MXNET_FUSED_K": str(self.fused_k if self.fused_k else 8),
        }

    def apply_env(self):
        """Write the knob values into os.environ, each only where the user
        has NOT set it ("auto unless set"). Returns the ones written."""
        applied = {}
        for k, v in self.knobs().items():
            if os.environ.get(k) in (None, ""):
                os.environ[k] = v
                applied[k] = v
        return applied

    def to_dict(self):
        return {"name": self.name, "axes": dict(self.axes),
                "zero_stage": self.zero_stage,
                "tp_params": sorted(self.param_specs)
                if self.param_specs else [],
                "knobs": self.knobs()}

    def __repr__(self):
        return f"Plan({self.name!r}, axes={self.axes}, " \
               f"zero_stage={self.zero_stage})"


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


def parse_plan(spec, n_dev, model=None):
    """A non-auto MXNET_PLAN spec as a Plan.

    Grammar: ``dp`` | ``zero1`` | ``zero2`` | ``dpK.tpT`` | ``tpT``, with
    ``+zero1`` / ``+zero2`` after a tp form. K·T must be the device count
    (K inferred when the dp factor is left out). ``model`` (a ModelSpec)
    gives the tp layout; a stage-0 tp plan needs it.
    """
    spec = str(spec).strip().lower()
    if not spec or spec == "auto":
        raise MXNetError("parse_plan: 'auto' is resolved by plan_auto")
    stage = 0
    base = spec
    if "+" in spec:
        base, suffix = spec.split("+", 1)
        if suffix not in ("zero1", "zero2"):
            raise MXNetError(f"MXNET_PLAN: unknown suffix +{suffix} "
                             f"in {spec!r} (want +zero1|+zero2)")
        stage = int(suffix[-1])
    if base == "dp":
        if stage:
            return Plan(spec, {"data": n_dev}, zero_stage=stage)
        return Plan("dp", {"data": n_dev})
    if base in ("zero1", "zero2"):
        if stage:
            raise MXNetError(f"MXNET_PLAN: {spec!r} names zero twice")
        return Plan(base, {"data": n_dev}, zero_stage=int(base[-1]))
    dp_k, tp_t = None, None
    for tok in base.split("."):
        if tok.startswith("dp") and tok[2:].isdigit():
            dp_k = int(tok[2:])
        elif tok.startswith("tp") and tok[2:].isdigit():
            tp_t = int(tok[2:])
        else:
            raise MXNetError(
                f"MXNET_PLAN: cannot parse {tok!r} in {spec!r} (want "
                "auto|dp|zero1|zero2|dpK.tpT[+zero1|+zero2]|tpT[...])")
    if tp_t is None:
        raise MXNetError(f"MXNET_PLAN: no tp factor in {spec!r}")
    if dp_k is None:
        if n_dev % tp_t:
            raise MXNetError(
                f"MXNET_PLAN: tp{tp_t} does not divide {n_dev} devices")
        dp_k = n_dev // tp_t
    if dp_k * tp_t != n_dev:
        raise MXNetError(
            f"MXNET_PLAN: {spec!r} spans {dp_k * tp_t} devices but the "
            f"mesh has {n_dev}")
    name = f"dp{dp_k}.tp{tp_t}" + (f"+zero{stage}" if stage else "")
    axes = {"data": dp_k, "model": tp_t}
    if stage:
        return Plan(name, axes, zero_stage=stage)
    if model is None:
        raise MXNetError(
            f"MXNET_PLAN: {spec!r} needs a model spec for the tp "
            "layout (construct through planner.make_trainer)")
    specs, sharded, total = tp_param_specs(model.param_names,
                                           model.param_shapes, tp_t)
    if not specs:
        raise MXNetError(
            f"MXNET_PLAN: {spec!r}: no parameter dimension divides by "
            f"tp={tp_t}; pick a divisor of the layer widths")
    return Plan(name, axes, param_specs=specs)


def tp_param_specs(param_names, param_shapes, t):
    """Megatron-style layout heuristic over a generic Symbol's params.

    2-D weights alternate column-parallel / row-parallel in declaration
    order. FullyConnected stores its weight as (num_hidden, in_dim) and
    computes x @ W.T, so column-parallel (split the output features) is
    ``("model", None)`` and row-parallel (split the input features)
    ``(None, "model")``; a column-parallel layer's 1-D bias splits with
    its output features (``("model",)``). Dimensions t does not divide
    stay replicated (the layout pass keeps any mix correct; the
    alternation only saves collectives). Returns (specs, split bytes,
    total bytes)."""
    specs, col_next = {}, True
    sharded = total = 0
    bias_of = {}        # "<prefix>_bias" -> column-split?
    for n, s in zip(param_names, param_shapes):
        sz = 4 * max(1, int(_np.prod(s)) if s else 1)
        total += sz
        if len(s) == 2:
            if col_next and s[0] % t == 0:
                specs[n] = ("model", None)
                if n.endswith("_weight"):
                    bias_of[n[:-len("_weight")] + "_bias"] = True
                sharded += sz
                col_next = False
            elif not col_next and s[1] % t == 0:
                specs[n] = (None, "model")
                sharded += sz
                col_next = True
        elif len(s) == 1 and bias_of.get(n) and s[0] % t == 0:
            specs[n] = ("model",)
            sharded += sz
    return specs, sharded, total


class ModelSpec:
    """Everything the planner needs to size, price and build a trainer
    for one Symbol: inferred parameter shapes, the optimizer's state
    count, the batch geometry, and the trainer kwargs."""

    def __init__(self, symbol, shape_kwargs, data_names=("data",),
                 label_names=("softmax_label",), optimizer="sgd",
                 dtype="float32", **trainer_kwargs):
        from .dp import _OPT_OPS
        from ..ops.registry import get_op
        self.symbol = symbol
        self.shape_kwargs = dict(shape_kwargs)
        self.data_names = tuple(data_names)
        self.label_names = tuple(label_names)
        self.optimizer = optimizer
        self.dtype = dtype
        self.trainer_kwargs = dict(trainer_kwargs)
        arg_names = symbol.list_arguments()
        input_names = set(self.data_names) | set(self.label_names)
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape_kwargs)
        shapes = dict(zip(arg_names, arg_shapes))
        self.param_names = [n for n in arg_names if n not in input_names]
        self.param_shapes = [tuple(shapes[n]) for n in self.param_names]
        self.aux_shapes = [tuple(s) for s in aux_shapes]
        self.input_shapes = [tuple(shapes[n]) for n in arg_names
                             if n in input_names]
        self.batch = int(shape_kwargs[self.data_names[0]][0])
        opt_op = _OPT_OPS.get(optimizer)
        if opt_op is None:
            raise MXNetError(f"planner: no fused op for {optimizer!r}")
        hp = dict(trainer_kwargs)
        self.opname = opt_op(hp) if callable(opt_op) else opt_op
        self.n_states = len(get_op(self.opname).input_names) - 2
        self.param_elems = sum(max(1, int(_np.prod(s)) if s else 1)
                               for s in self.param_shapes)
        self.param_bytes = 4 * self.param_elems

    def compute_itemsize(self):
        return 2 if self.dtype in ("bfloat16", "float16") else 4


# -- analytic estimates ---------------------------------------------------------

def estimate_hbm_bytes(model, plan):
    """Analytic per-replica memory LOWER BOUND of one training step under
    ``plan``: masters + optimizer state at their split residency, one
    compute-type parameter copy + one gradient, and the local batch. A
    plan rejected on it alone can never fit (the JAX package's formula,
    byte for byte)."""
    pb = model.param_bytes
    ci = model.compute_itemsize()
    n = plan.n_devices
    t = plan.model_factor
    if plan.zero_stage > 0:
        master_opt = pb * (1 + model.n_states) / n
    elif plan.param_specs:
        _, sharded, total = tp_param_specs(model.param_names,
                                           model.param_shapes, t)
        shard_b = sharded / t + (total - sharded)
        master_opt = shard_b * (1 + model.n_states)
    else:
        master_opt = pb * (1 + model.n_states)
    live = 2 * pb * ci / 4
    if plan.param_specs:
        live /= t
    batch_local = 0
    for s in model.input_shapes:
        elems = max(1, int(_np.prod(s)) if s else 1)
        batch_local += 4 * elems / int(plan.axes["data"])
    return int(master_opt + live + batch_local)


def estimate_wire_bytes(model, plan, bucket_bytes=None):
    """Analytic per-replica collective bytes of one step: ZeRO plans
    ``ZeroLayout``'s ring accounting, stage-0 dp one all-reduce of the
    whole gradient. Stage-0 tp has no closed form for a generic Symbol
    (the activations' collectives depend on the graph): None, and the
    planner prices the layout pass's count (:func:`score_plan`)."""
    ci = model.compute_itemsize()
    n = plan.n_devices
    if plan.zero_stage > 0:
        from .zero import ZeroLayout, _resolve_bucket_bytes
        bb = bucket_bytes if bucket_bytes is not None \
            else _resolve_bucket_bytes(plan.bucket_mb)
        lay = ZeroLayout(model.param_shapes, n, bb)
        return lay.wire_bytes_per_step(plan.zero_stage, ci, ci)
    if plan.param_specs:
        return None
    return int(2 * (n - 1) / n * model.param_bytes * ci / 4)


# -- candidate space -------------------------------------------------------------

def enumerate_candidates(model, n_dev, max_tp=8):
    """The candidate compositions for one model at one device count:
    [(plan or None, reject reason or None)], in a fixed order. pp rides
    along as an explained rejection."""
    out = [(Plan("dp", {"data": n_dev}), None)]
    if n_dev > 1:
        out.append((Plan("zero1", {"data": n_dev}, zero_stage=1), None))
        out.append((Plan("zero2", {"data": n_dev}, zero_stage=2), None))
    for t in _divisors(n_dev):
        if t == 1 or t == n_dev or t > max_tp:
            continue
        k = n_dev // t
        specs, sharded, total = tp_param_specs(model.param_names,
                                               model.param_shapes, t)
        if not specs:
            out.append((None, (f"dp{k}.tp{t}: no parameter dimension "
                               f"divides by tp={t}")))
            continue
        out.append((Plan(f"dp{k}.tp{t}", {"data": k, "model": t},
                         param_specs=specs), None))
        out.append((Plan(f"dp{k}.tp{t}+zero2", {"data": k, "model": t},
                         zero_stage=2), None))
    if n_dev > 1:
        out.append((None, f"pp{n_dev}: generic Symbol has no stage "
                          "partition map (use parallel.pp directly)"))
    return out


# -- trainer construction ---------------------------------------------------------

def _auto_bucket_mb(model):
    """Bucket threshold targeting ~4 gradient buckets, clamped to
    [1, 32] MB."""
    mb = model.param_bytes / (1 << 20)
    return max(1, min(32, int(round(mb / 4)) or 1))


def _auto_fused_k(model):
    """Small-step models amortize dispatch deeper: K=16 under 8 MB of
    params, K=8 above."""
    return 16 if model.param_bytes < (8 << 20) else 8


def _finalize_knobs(plan, model):
    if plan.bucket_mb is None:
        plan.bucket_mb = _auto_bucket_mb(model)
    if plan.fused_k is None:
        plan.fused_k = _auto_fused_k(model)
    return plan


def _devices(n_dev, devices=None, ctx=None):
    """The plan's replica devices: ``devices`` as given, else ``n_dev``
    host replicas (``ctx`` cpu), else the cards in turn, each listed
    again when there are fewer cards than replicas."""
    if devices is not None:
        return list(devices)
    from ..context import Context
    if ctx == "cpu" or (isinstance(ctx, Context)
                        and ctx.device_type == "cpu"):
        return ["cpu"] * int(n_dev)
    import torch
    if not torch.cuda.is_available():
        raise MXNetError("no CUDA device: pass ctx=cpu() (or devices=) "
                         "for host replicas")
    cards = torch.cuda.device_count()
    if n_dev is None:
        n_dev = cards
    return [torch.device("cuda", i % cards) for i in range(int(n_dev))]


def build_trainer(model, plan, devices=None):
    """The trainer a Plan describes. Degenerate plans call the very
    constructors a direct construction does (bit-identical); tp plans
    hand dp their param_specs; a zero_stage > 0 plan builds a ZeroTrainer
    over the plan's (possibly N-D) mesh. The trainer keeps the plan as
    ``_sharding_plan``."""
    from .dp import DataParallelTrainer
    from .zero import ZeroTrainer
    _finalize_knobs(plan, model)
    mesh = plan.mesh(devices)
    kw = dict(model.trainer_kwargs, optimizer=model.optimizer,
              dtype=model.dtype, data_names=model.data_names,
              label_names=model.label_names)
    if plan.zero_stage > 0:
        tr = ZeroTrainer(model.symbol, mesh, zero_stage=plan.zero_stage,
                         grad_compress=plan.compress,
                         zero_bucket_mb=plan.bucket_mb, **kw)
    else:
        tr = DataParallelTrainer(model.symbol, mesh, zero_stage=0,
                                 param_specs=plan.param_specs, **kw)
    _BUILT[0] += 1
    tr._sharding_plan = plan
    return tr


# -- pricing ------------------------------------------------------------------------

def score_plan(model, plan, wire_bw=None):
    """Price one candidate's step: its record dict (FLOPs, bytes, the
    counted wire and the analytic estimate beside it, peak bytes,
    cost_s). Builds no trainer, runs nothing, allocates no training
    state."""
    from ..telemetry import devstats
    from ..telemetry.costs import step_costs
    from .zero import _resolve_bucket_bytes, WIRE_DTYPES
    import torch
    wire_bw = wire_bw or resolve_wire_bw()
    _finalize_knobs(plan, model)
    bb = _resolve_bucket_bytes(plan.bucket_mb)
    ci = model.compute_itemsize()
    wi = ci if plan.compress in (None, "none") else \
        torch.empty((), dtype=WIRE_DTYPES[plan.compress]).element_size()
    c = step_costs(model.symbol, model.shape_kwargs, model.data_names,
                   model.label_names, model.opname, axes=plan.axes,
                   zero_stage=plan.zero_stage, specs=plan.param_specs,
                   itemsize=ci, bucket_bytes=bb, wire_itemsize=wi)
    pf, pb, src = devstats.peaks(model.dtype)
    wire = c["wire_bytes"]
    cost = max(c["flops"] / pf, c["bytes"] / pb) + wire / wire_bw
    return {"plan": plan, "trainer": None, "flops": c["flops"],
            "bytes": c["bytes"],
            "peak_bytes": int(estimate_hbm_bytes(model, plan)
                              + c["act_bytes"]),
            "wire_bytes": int(round(wire)),
            "wire_bytes_estimate": estimate_wire_bytes(model, plan,
                                                       bucket_bytes=bb),
            "act_bytes": c["act_bytes"], "unruled": c["unruled"],
            "peak_source": src, "cost_s": cost}


class PlanReport:
    """The planner's decision record: the chosen Plan plus one entry a
    candidate: scored (cost_s ...), rejected_hbm (the prefilter said it
    cannot fit), rejected_peak (its priced peak is over the budget) or
    unsupported (no layout). ``compiled`` counts the candidates priced
    (the JAX package's executables compiled), ``built`` the trainers
    built while planning (none)."""

    def __init__(self, chosen, entries, compiled, budget, built=0):
        self.chosen = chosen
        self.entries = entries
        self.compiled = compiled
        self.budget = budget
        self.built = built

    def to_dict(self):
        return {"chosen": self.chosen.name if self.chosen else None,
                "budget_bytes": self.budget,
                "compiled": self.compiled, "built": self.built,
                "candidates": [
                    {k: v for k, v in e.items()
                     if k not in ("plan", "trainer")}
                    | {"name": e["plan"].name if e.get("plan") else
                       e.get("name")}
                    for e in self.entries]}


def plan_auto(model, n_dev=None, devices=None, budget=None,
              wire_bw=None, max_tp=8):
    """Enumerate -> prefilter -> price -> argmin. Returns a PlanReport
    whose ``chosen`` plan minimizes (cost_s, name); raises MXNetError
    (with ``.report``) when every candidate is rejected."""
    from ..telemetry import devstats
    if devices is not None:
        n_dev = len(devices)
    if n_dev is None:
        n_dev = len(_devices(None))
    if budget is None:
        budget = devstats.hbm_budget(
            devices[0] if devices is not None and str(devices[0]) != "cpu"
            else None)
    built0 = _BUILT[0]
    entries, priced = [], 0
    for plan, reason in enumerate_candidates(model, n_dev, max_tp):
        if plan is None:
            entries.append({"name": reason.split(":")[0],
                            "status": "unsupported", "reason": reason})
            continue
        _finalize_knobs(plan, model)
        need = estimate_hbm_bytes(model, plan)
        try:
            devstats.preflight(plan.name, need, budget=budget, what="plan")
        except devstats.HBMPreflightError as e:
            entries.append({"plan": plan, "status": "rejected_hbm",
                            "need_bytes": need, "reason": str(e)})
            continue
        rec = score_plan(model, plan, wire_bw)
        priced += 1
        if budget is not None and rec["peak_bytes"] > budget:
            rec |= {"status": "rejected_peak",
                    "reason": f"priced peak {rec['peak_bytes']} over "
                              f"budget {budget}"}
        else:
            rec["status"] = "scored"
        entries.append(rec)
    built = _BUILT[0] - built0
    scored = [e for e in entries if e.get("status") == "scored"]
    if not scored:
        err = MXNetError(
            "planner: no feasible plan — every candidate was rejected "
            f"({[e.get('reason') for e in entries]})")
        err.report = PlanReport(None, entries, priced, budget, built)
        raise err
    best = min(scored, key=lambda e: (e["cost_s"], e["plan"].name))
    best["status"] = "selected"
    return PlanReport(best["plan"], entries, priced, budget, built)


def make_trainer(symbol, shape_kwargs, plan=None, devices=None,
                 n_dev=None, data_names=("data",),
                 label_names=("softmax_label",), optimizer="sgd",
                 dtype="float32", apply_knobs=True, budget=None, ctx=None,
                 **trainer_kwargs):
    """The MXNET_PLAN front door: the trainer the (possibly auto-)
    selected plan describes. ``plan`` overrides the environment's spec;
    "auto" runs the planner. ``devices`` (or ``n_dev`` replicas: of the
    host with ``ctx=cpu()``, else of the cards in turn) make the mesh.
    The chosen plan's knobs land in the environment ("auto unless set")
    unless ``apply_knobs=False``. The trainer keeps ``_sharding_plan``
    and ``_plan_report`` (auto only)."""
    model = ModelSpec(symbol, shape_kwargs, data_names=data_names,
                      label_names=label_names, optimizer=optimizer,
                      dtype=dtype, **trainer_kwargs)
    devices = _devices(n_dev, devices, ctx)
    n = len(devices)
    spec = resolve_plan(plan)
    report = None
    if spec == "auto":
        report = plan_auto(model, devices=devices, budget=budget)
        chosen = report.chosen
    else:
        chosen = parse_plan(spec, n, model)
    tr = build_trainer(model, chosen, devices)
    if apply_knobs:
        chosen.apply_env()
    tr._plan_report = report
    return tr


# ============================================================================
# CLI: --selftest / --explain / --bench / --hlo-audit
# ============================================================================

def _bench_sym(dim=256, hidden=2048, nclass=16):
    """The bench arm: a wide FC stack whose parameter gather / reduce
    wire dwarfs the small per-replica batch's compute."""
    from .zero import _wide_sym
    return _wide_sym(dim=dim, hidden=hidden, nclass=nclass)


def _small_model(batch=16, dim=32, hidden=64, nclass=8,
                 optimizer="sgd"):
    from .zero import _wide_sym
    sym = _wide_sym(dim=dim, hidden=hidden, nclass=nclass)
    kw = {"learning_rate": 0.1, "rescale_grad": 1.0 / batch}
    if optimizer == "sgd":
        kw["momentum"] = 0.9
    return ModelSpec(sym, {"data": (batch, dim),
                           "softmax_label": (batch,)},
                     optimizer=optimizer, **kw), batch, dim, nclass


def selftest(devices=8, ctx="gpu"):
    """One ``planner_selftest`` JSON line:

      1. determinism: two plan_auto runs agree on the choice and on the
         whole (name, cost) ordering;
      2. pruning: a 16 KB budget rejects every candidate in the
         prefilter, with nothing priced and no trainer built;
      3. degenerate construction: plan="dp" is a plain
         DataParallelTrainer, plan="zero2" a stage-2 ZeroTrainer;
      4. ZeRO over dp x tp: dpK.tp2+zero2 trains the selftest model within
         8 float32 ulps of pure dp after 10 steps (parameters and losses),
         its masters split 1/(D·T).
    """
    import json
    devs = _devices(devices, ctx=ctx)
    n_dev = len(devs)
    model, batch, dim, nclass = _small_model()
    results = {"metric": "planner_selftest", "devices": n_dev,
               "device": str(devs[0])}

    r1 = plan_auto(model, devices=devs, budget=None)
    r2 = plan_auto(model, devices=devs, budget=None)
    key = lambda r: [(e["plan"].name, e["cost_s"])
                     for e in r.entries if "cost_s" in e]
    results["auto_choice"] = r1.chosen.name
    results["deterministic"] = bool(r1.chosen.name == r2.chosen.name
                                    and key(r1) == key(r2))
    results["candidates_scored"] = r1.compiled

    built0 = _BUILT[0]
    try:
        plan_auto(model, devices=devs, budget=1 << 14)
        results["pruned_all"] = False
        results["pruned_compiles"] = -1
    except MXNetError as e:
        rep = getattr(e, "report", None)
        results["pruned_all"] = bool(rep is not None and all(
            x.get("status") == "rejected_hbm"
            for x in rep.entries if x.get("plan") is not None))
        results["pruned_compiles"] = rep.compiled if rep else -1
    results["pruned_built"] = _BUILT[0] - built0

    from .dp import DataParallelTrainer
    from .zero import ZeroTrainer
    kw = dict(optimizer=model.optimizer, **model.trainer_kwargs)
    tr_dp = make_trainer(model.symbol, model.shape_kwargs, plan="dp",
                         devices=devs, apply_knobs=False, **kw)
    tr_z2 = make_trainer(model.symbol, model.shape_kwargs, plan="zero2",
                         devices=devs, apply_knobs=False, **kw)
    results["degenerate_dp"] = bool(type(tr_dp) is DataParallelTrainer)
    results["degenerate_zero2"] = bool(
        isinstance(tr_z2, ZeroTrainer) and tr_z2._zero_stage == 2)

    rng = _np.random.RandomState(0)
    x = rng.normal(size=(batch, dim)).astype(_np.float32)
    y = rng.randint(0, nclass, size=(batch,)).astype(_np.float32)

    def _train(tr, steps=10):
        params, states, aux = tr.init_state(model.shape_kwargs)
        inputs = tr.shard_inputs([x, y])
        losses = []
        for _ in range(steps):
            params, states, aux, loss, _ = tr.step(params, states, aux,
                                                   inputs)
            losses.append(float(loss))
        return tr.host_params(params), losses

    t = 2 if n_dev % 2 == 0 and n_dev > 2 else 1
    if t > 1:
        tr_tz = make_trainer(model.symbol, model.shape_kwargs,
                             plan=f"dp{n_dev // t}.tp{t}+zero2",
                             devices=devs, apply_knobs=False, **kw)
        h_dp, l_dp = _train(tr_dp)
        h_tz, l_tz = _train(tr_tz)
        ulp = max(float(_np.abs(h_dp[n] - h_tz[n]).max())
                  / (float(_np.abs(h_dp[n]).max()) * 2.0 ** -23 + 1e-30)
                  for n in h_dp)
        results["zero_tp_param_ulp"] = ulp
        results["zero_tp_close"] = bool(ulp <= 8.0)
        results["zero_tp_loss_close"] = bool(all(
            abs(a - b) <= 8 * 2.0 ** -23 * max(abs(a), 1.0)
            for a, b in zip(l_dp, l_tz)))
        results["zero_tp_model_factor"] = tr_tz._model_factor
        L = tr_tz.layout
        results["zero_tp_shard_frac"] = L.shard_len[0] / L.padded[0]
        results["zero_tp_sharded"] = bool(
            L.shard_len[0] * n_dev == L.padded[0])
    else:
        results["zero_tp_close"] = True
        results["zero_tp_loss_close"] = True
        results["zero_tp_sharded"] = True

    ok = (results["deterministic"] and results["pruned_all"]
          and results["pruned_compiles"] == 0
          and results["pruned_built"] == 0
          and results["degenerate_dp"] and results["degenerate_zero2"]
          and results["zero_tp_close"] and results["zero_tp_loss_close"]
          and results["zero_tp_sharded"])
    results["ok"] = bool(ok)
    print(json.dumps(results), flush=True)
    return 0 if ok else 1


def explain(plan_spec="auto", devices=8, ctx="gpu"):
    """Print the per-candidate score table (the --explain CLI) and one
    ``planner_explain`` JSON line."""
    import json
    devs = _devices(devices, ctx=ctx)
    model, _, _, _ = _small_model(batch=32, dim=64, hidden=256,
                                  nclass=16, optimizer="adam")
    report = plan_auto(model, devices=devs)
    for e in report.entries:
        name = e["plan"].name if e.get("plan") else e["name"]
        if "cost_s" in e:
            print(f"{name:>16}  {e['status']:>13}  "
                  f"cost={e['cost_s'] * 1e3:8.3f}ms  "
                  f"flops={e['flops'] / 1e6:8.1f}M  "
                  f"wire={e['wire_bytes'] / 1e6:7.2f}MB  "
                  f"peak={e['peak_bytes'] / 1e6:7.1f}MB")
        else:
            print(f"{name:>16}  {e['status']:>13}  {e['reason']}")
    print(f"{'-' * 72}\nselected: {report.chosen.name}  "
          f"knobs: {report.chosen.knobs()}")
    rec = {"metric": "planner_explain", "devices": len(devs)}
    rec.update(report.to_dict())
    print(json.dumps(rec, default=str), flush=True)
    return 0


def bench(devices=8, steps=8, ctx="gpu"):
    """The JAX CLI's `plan` lane: MXNET_PLAN=auto against hand-picked dp
    and zero2 on the wide FC arm (256 -> 1024 -> 1024 -> 16, batch 16,
    Adam) over ``devices`` replicas: steps/s an arm (the median of 3
    windows after 2 warm-up steps, each window ending on a read of its
    last loss), the planner's choice and its predicted order. One
    ``plan_bench`` JSON line."""
    import json
    import time
    devs = _devices(devices, ctx=ctx)
    n_dev = len(devs)
    batch, dim, nclass, hidden = 16, 256, 16, 1024
    sym = _bench_sym(dim=dim, hidden=hidden, nclass=nclass)
    shape_kwargs = {"data": (batch, dim), "softmax_label": (batch,)}
    kw = dict(optimizer="adam", learning_rate=1e-3,
              rescale_grad=1.0 / batch)
    model = ModelSpec(sym, shape_kwargs, **kw)
    rng = _np.random.RandomState(0)
    x = rng.normal(size=(batch, dim)).astype(_np.float32)
    y = rng.randint(0, nclass, size=(batch,)).astype(_np.float32)

    report = plan_auto(model, devices=devs)
    predicted = sorted(
        ((e["plan"].name, e["cost_s"]) for e in report.entries
         if "cost_s" in e), key=lambda kv: (kv[1], kv[0]))

    def _measure(plan_spec):
        tr = make_trainer(sym, shape_kwargs, plan=plan_spec,
                          devices=devs, apply_knobs=False, **kw)
        params, states, aux = tr.init_state(shape_kwargs)
        inputs = tr.shard_inputs([x, y])
        for _ in range(2):
            params, states, aux, loss, _ = tr.step(params, states, aux,
                                                   inputs)
        float(loss)
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(steps):
                params, states, aux, loss, _ = tr.step(params, states,
                                                       aux, inputs)
            float(loss)
            rates.append(steps / (time.perf_counter() - t0))
        return sorted(rates)[1]

    arms = {"dp": _measure("dp"), "zero2": _measure("zero2"),
            "auto": _measure(report.chosen.name)}
    measured = sorted(arms.items(), key=lambda kv: (-kv[1], kv[0]))
    best_hand = max(arms["dp"], arms["zero2"])
    rec = {"metric": "plan_bench", "devices": n_dev,
           "device": str(devs[0]),
           "params": int(model.param_elems), "optimizer": "adam",
           "batch": batch, "steps_per_window": steps,
           "auto_choice": report.chosen.name,
           "predicted_rank": [n for n, _ in predicted],
           "predicted_cost_s": {n: c for n, c in predicted},
           "dp_steps_per_s": arms["dp"],
           "zero2_steps_per_s": arms["zero2"],
           "auto_steps_per_s": arms["auto"],
           "measured_rank": [n for n, _ in measured],
           "auto_beats_hand": bool(arms["auto"] >= 0.95 * best_hand),
           "speedup_vs_dp": arms["auto"] / arms["dp"]}
    print(json.dumps(rec), flush=True)
    return 0


def main(argv=None):
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.parallel.planner")
    ap.add_argument("--selftest", action="store_true",
                    help="determinism / pruning / degenerate parity / "
                         "ZeRO over dp x tp")
    ap.add_argument("--explain", action="store_true",
                    help="per-candidate score table for the auto plan")
    ap.add_argument("--bench", action="store_true",
                    help="auto vs hand dp / zero2 steps/s")
    ap.add_argument("--hlo-audit", action="store_true",
                    help="(the JAX package's HLO audit: not available)")
    ap.add_argument("--plan", default="auto")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--ctx", default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args(argv)
    if args.hlo_audit:
        print("planner --hlo-audit reads the compiled step's collectives "
              "out of XLA's HLO; the port compiles no HLO (its wire is "
              "the layout pass's count, which score_plan prices)",
              file=sys.stderr)
        return 2
    if args.bench:
        return bench(devices=args.devices, steps=args.steps, ctx=args.ctx)
    if args.explain:
        return explain(args.plan, args.devices, ctx=args.ctx)
    if args.selftest:
        return selftest(args.devices, ctx=args.ctx)
    ap.print_help()
    return 2


if __name__ == "__main__":
    import sys
    sys.exit(main())
