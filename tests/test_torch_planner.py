"""The port's sharding planner (``mxnet_tpu_torch.parallel.planner``),
tensor parallelism (``DataParallelTrainer(param_specs=)``) and ZeRO over a
data x model mesh, against the JAX package's on the CPU.

The JAX side runs on the 8 CPU devices tests/conftest.py gives it; its
ZeRO over an N-D mesh runs through ``jax.shard_map(check_vma=False)``
rebound on ``mxnet_tpu.parallel.zero.shard_map`` (jax 0.9's replication
check rejects that step, as it rejects the embedding trainer's). The
port's replicas are 8 host replicas (``"cpu"`` listed 8 times).

Tolerances, stated before the runs:

* grammar, layouts, estimates and candidates: equal to the JAX
  package's, exactly;
* a plan's training against the JAX package's same plan (10 steps, sgd
  with momentum): ``rtol=2e-4, atol=1e-5`` on the parameters and the
  optimizer states, as
  tests/test_torch_zero.py holds ZeRO against JAX (the products and the
  collectives sum in another order than XLA's);
* against the port's own dp: ZeRO over dp x tp within 8 float32 ulps of
  each tensor's largest element (the JAX selftest's bar), stage-0 tensor
  parallelism within 1e-6 of it;
* the planner's dp / zero2 against the direct trainers, and a dp commit
  resumed under zero1 against uninterrupted dp: bit for bit.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu.parallel import planner as jpl
from mxnet_tpu.parallel import zero as jzero
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import (DataParallelTrainer, ZeroTrainer,
                                      build_mesh, mesh as tmesh)
from mxnet_tpu_torch.parallel import planner as tpl

N_DEV = 8
CPU8 = ["cpu"] * N_DEV
RTOL, ATOL = 2e-4, 1e-5
STEPS = 10
LM_CFG = dict(vocab_size=64, units=32, hidden_size=64, num_heads=4,
              num_layers=2, max_length=16)
LM_SHAPES = {"data": (4, 16), "label": (4, 16)}


@pytest.fixture(autouse=True)
def _no_planner_settings(monkeypatch):
    """The knobs a plan writes ("auto unless set"), and MXNET_PLAN, are
    cleared for each test (another test of the process may set them)."""
    for k in tpl.AUTO_KNOB_VARS + ("MXNET_PLAN", "MXNET_DEVSTATS_HBM_BYTES"):
        if k in os.environ:
            monkeypatch.delenv(k)


@pytest.fixture
def jax_nd_zero(monkeypatch):
    monkeypatch.setattr(jzero, "shard_map",
                        functools.partial(jax.shard_map, check_vma=False))


def _lm_sym(mx):
    nm = mx.base.NameManager if hasattr(mx.base, "NameManager") \
        else mx.NameManager
    with nm():
        enc = mx.gluon.nn.TransformerEncoder(**LM_CFG, prefix="lm_")
        head = mx.gluon.nn.Dense(LM_CFG["vocab_size"], flatten=False,
                                 prefix="head_")
        net = mx.gluon.nn.HybridSequential()
        net.add(enc, head)
        out = net(mx.sym.Variable("data"))
        return mx.gluon.loss.SoftmaxCrossEntropyLoss()(
            out, mx.sym.Variable("label"))


def _models(which):
    """(JAX ModelSpec, port ModelSpec) of one of the three models."""
    if which == "small":
        return jpl._small_model()[0], tpl._small_model()[0]
    if which == "bench":
        kw = dict(optimizer="adam", learning_rate=1e-3,
                  rescale_grad=1.0 / 16)
        sk = {"data": (16, 256), "softmax_label": (16,)}
        return (jpl.ModelSpec(jpl._bench_sym(dim=256, hidden=1024), sk,
                              **kw),
                tpl.ModelSpec(tpl._bench_sym(dim=256, hidden=1024), sk,
                              **kw))
    kw = dict(optimizer="adam", learning_rate=1e-3, label_names=("label",))
    return (jpl.ModelSpec(_lm_sym(jmx), LM_SHAPES, **kw),
            tpl.ModelSpec(_lm_sym(tmx), LM_SHAPES, **kw))


def _plan_key(p):
    if p is None:
        return None
    specs = None if p.param_specs is None else {
        k: tuple(v) for k, v in p.param_specs.items()}
    return (p.name, p.axes, p.zero_stage, specs)


# -- grammar, layouts, estimates ------------------------------------------------

GRAMMAR = ["dp", "zero1", "zero2", "dp2.tp4", "dp2.tp4+zero2", "tp4",
           "dp4.tp2+zero1", "tp2+zero2", "dp+zero2",
           "dp3.tp5", "dp2.tp9", "pp2", "zero3", "banana", "dp2.tp4+zero7",
           "zero2+zero1", "dp8", "auto"]


@pytest.mark.parametrize("spec", GRAMMAR)
def test_parse_plan_matches_jax(spec):
    """Every form of tests/test_planner.py's grammar parses to the JAX
    package's plan, and what it refuses the port refuses."""
    jm, tm = _models("small")
    try:
        want = jpl.parse_plan(spec, N_DEV, jm)
    except jmx.base.MXNetError:
        want = "raises"
    try:
        got = tpl.parse_plan(spec, N_DEV, tm)
    except MXNetError:
        got = "raises"
    if want == "raises":
        assert got == "raises"
    else:
        assert _plan_key(got) == _plan_key(want)
        assert got.knobs() == want.knobs() and got.to_dict() == \
            want.to_dict()


@pytest.mark.parametrize("which", ["small", "bench", "lm"])
def test_layouts_and_estimates_match_jax(which):
    """tp_param_specs, estimate_hbm_bytes, estimate_wire_bytes and
    enumerate_candidates: the JAX package's, number for number."""
    jm, tm = _models(which)
    assert tm.param_names == jm.param_names
    assert tm.param_shapes == jm.param_shapes
    assert (tm.n_states, tm.param_bytes) == (jm.n_states, jm.param_bytes)
    for t in (2, 4, 8):
        js, jsh, jtot = jpl.tp_param_specs(jm.param_names,
                                           jm.param_shapes, t)
        ts, tsh, ttot = tpl.tp_param_specs(tm.param_names,
                                           tm.param_shapes, t)
        assert ts == {k: tuple(v) for k, v in js.items()}
        assert (tsh, ttot) == (jsh, jtot)
    jc = jpl.enumerate_candidates(jm, N_DEV)
    tc = tpl.enumerate_candidates(tm, N_DEV)
    assert [(_plan_key(p), r) for p, r in tc] == \
        [(_plan_key(p), r) for p, r in jc]
    for (jp, _), (tp, _) in zip(jc, tc):
        if jp is None:
            continue
        jpl._finalize_knobs(jp, jm)
        tpl._finalize_knobs(tp, tm)
        assert tp.knobs() == jp.knobs()
        assert tpl.estimate_hbm_bytes(tm, tp) == \
            jpl.estimate_hbm_bytes(jm, jp)
        assert tpl.estimate_wire_bytes(tm, tp) == \
            jpl.estimate_wire_bytes(jm, jp)


def test_knobs_auto_unless_set(monkeypatch):
    """Plan.apply_env writes each of the six knobs only where the
    environment leaves it unset, as the JAX package's (each knob set
    through monkeypatch first, "" meaning unset, so none outlives the
    test)."""
    for k in tpl.AUTO_KNOB_VARS:
        monkeypatch.setenv(k, "")
    monkeypatch.setenv("MXNET_ZERO_BUCKET_MB", "7")
    _, tm = _models("small")
    plan = tpl.parse_plan("zero2", N_DEV, tm)
    tpl._finalize_knobs(plan, tm)
    wrote = plan.apply_env()
    assert os.environ["MXNET_ZERO_STAGE"] == "2"
    assert os.environ["MXNET_ZERO_BUCKET_MB"] == "7"
    assert "MXNET_ZERO_BUCKET_MB" not in wrote
    assert os.environ["MXNET_DEVICE_FEED_DEPTH"] == "2"
    for k in tpl.AUTO_KNOB_VARS:
        assert os.environ.get(k) not in (None, ""), k
    assert tpl.resolve_plan() == "auto"
    monkeypatch.setenv("MXNET_PLAN", " DP2.TP4 ")
    assert tpl.resolve_plan() == jpl.resolve_plan() == "dp2.tp4"
    assert tpl.resolve_wire_bw() == jpl.resolve_wire_bw() == 25e9
    with pytest.raises(MXNetError):
        tpl.resolve_wire_bw("0")


# -- the planner's pricing -------------------------------------------------------

def test_plan_auto_deterministic_and_builds_nothing():
    """Two runs agree on the choice and on the whole (name, cost) order
    (the JAX package's own test of this is red on jax 0.9), every
    candidate is priced, pp is listed unsupported, and no trainer is
    built."""
    _, tm = _models("small")
    built = tpl._BUILT[0]
    r1 = tpl.plan_auto(tm, devices=CPU8)
    r2 = tpl.plan_auto(tm, devices=CPU8)
    key = lambda r: [(e["plan"].name, e["cost_s"], e["status"])
                     for e in r.entries if "cost_s" in e]
    assert r1.chosen.name == r2.chosen.name and key(r1) == key(r2)
    assert len(key(r1)) == 7 and r1.compiled == 7 and r1.built == 0
    assert [e["status"] for e in r1.entries].count("selected") == 1
    assert r1.entries[-1]["status"] == "unsupported"
    assert tpl._BUILT[0] == built


def test_pruning_builds_nothing(monkeypatch):
    """A 16 KB budget (MXNET_DEVSTATS_HBM_BYTES, as the JAX test) is under
    every candidate's lower bound: all are rejected in the prefilter,
    nothing is priced and no trainer is built."""
    monkeypatch.setenv("MXNET_DEVSTATS_HBM_BYTES", str(1 << 14))
    _, tm = _models("small")
    built = tpl._BUILT[0]
    with pytest.raises(MXNetError) as ei:
        tpl.plan_auto(tm, devices=CPU8)
    rep = ei.value.report
    assert rep.compiled == 0 and rep.built == 0 and rep.budget == 1 << 14
    assert {e["status"] for e in rep.entries} == {"rejected_hbm",
                                                  "unsupported"}
    assert tpl._BUILT[0] == built


def _train(tr, model, steps=STEPS, data=None):
    params, states, aux = tr.init_state(model.shape_kwargs)
    x, y = data or _small_data()
    inputs = tr.shard_inputs([x, y])
    losses = []
    for _ in range(steps):
        params, states, aux, loss, _ = tr.step(params, states, aux, inputs)
        losses.append(float(np.asarray(loss)))
    host = tr.host_params(params) if hasattr(tr, "host_params") else {
        n: np.asarray(p) for n, p in zip(tr.param_names, params)}
    return host, losses, (params, states, aux)


def _small_data():
    rng = np.random.RandomState(0)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    y = rng.randint(0, 8, size=(16,)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("plan", ["dp", "zero1", "zero2", "dp4.tp2",
                                  "dp2.tp4", "dp4.tp2+zero2"])
def test_counted_wire_is_the_step_wire(plan):
    """The wire a plan is priced at (score_plan: telemetry.costs' layout
    pass plus the gradients' reduce, or ZeRO's layout) equals the
    analytic estimate where the JAX package has one, and equals what the
    mesh's wire counter moves in one real step."""
    _, tm = _models("small")
    p = tpl.parse_plan(plan, N_DEV, tm)
    rec = tpl.score_plan(tm, p)
    if rec["wire_bytes_estimate"] is not None:
        assert rec["wire_bytes"] == rec["wire_bytes_estimate"]
    tr = tpl.build_trainer(tm, p, CPU8)
    state = tr.init_state(tm.shape_kwargs)
    inputs = tr.shard_inputs(list(_small_data()))
    tmesh.reset_wire()
    tr.step(*state, inputs)
    assert abs(tmesh.wire_bytes() - rec["wire_bytes"]) < 1.0
    assert rec["unruled"] == []


# -- training under a plan ---------------------------------------------------------

def test_degenerate_plans_are_the_direct_trainers():
    """plan="dp" / "zero2" build the very trainers a direct construction
    does: float32 parameters after 10 steps equal bit for bit."""
    _, tm = _models("small")
    kw = dict(optimizer=tm.optimizer, **tm.trainer_kwargs)
    mesh = build_mesh({"data": N_DEV}, CPU8)
    tr_p = tpl.make_trainer(tm.symbol, tm.shape_kwargs, plan="dp",
                            devices=CPU8, apply_knobs=False, **kw)
    assert type(tr_p) is DataParallelTrainer
    hp, _, _ = _train(tr_p, tm)
    hd, _, _ = _train(DataParallelTrainer(tm.symbol, mesh, **kw), tm)
    assert all(np.array_equal(hp[n], hd[n]) for n in hd)
    tz = tpl.make_trainer(tm.symbol, tm.shape_kwargs, plan="zero2",
                          devices=CPU8, apply_knobs=False, **kw)
    assert isinstance(tz, ZeroTrainer) and tz._zero_stage == 2
    hz, _, _ = _train(tz, tm)
    hzd, _, _ = _train(ZeroTrainer(tm.symbol, mesh, zero_stage=2,
                                   zero_bucket_mb=tpl._auto_bucket_mb(tm),
                                   **kw), tm)
    assert all(np.array_equal(hz[n], hzd[n]) for n in hzd)


def _jax_run(tr, model, steps=STEPS):
    """(initial export, final export, losses) of a JAX trainer."""
    params, states, aux = tr.init_state(model.shape_kwargs)
    init = tr.export_training_state(params, states, aux)
    x, y = _small_data()
    inputs = tr.shard_inputs([x, y])
    losses = []
    for _ in range(steps):
        params, states, aux, loss, _ = tr.step(params, states, aux, inputs)
        losses.append(float(np.asarray(loss)))
    return init, tr.export_training_state(params, states, aux), losses


@pytest.mark.parametrize("plan", ["dp4.tp2", "dp2.tp4", "dp4.tp2+zero2"])
def test_plans_match_jax(plan, jax_nd_zero):
    """The port's trainer under a plan against the JAX package's under
    the same plan: the JAX trainer's initial state carried in with
    ``convert.dp_state_from_jax`` (full tensors in, each replica takes
    its shard), 10 steps, the state carried out with
    ``convert.dp_state_to_numpy``: parameters and optimizer states within
    rtol 2e-4 / atol 1e-5, losses likewise."""
    from mxnet_tpu_torch import convert
    jm, tm = _models("small")
    jtr = jpl.make_trainer(jm.symbol, jm.shape_kwargs, plan=plan,
                           n_dev=N_DEV, apply_knobs=False,
                           optimizer=jm.optimizer, **jm.trainer_kwargs)
    (init, imeta), (want, _), wloss = _jax_run(jtr, jm)
    ttr = tpl.make_trainer(tm.symbol, tm.shape_kwargs, plan=plan,
                           devices=CPU8, apply_knobs=False,
                           optimizer=tm.optimizer, **tm.trainer_kwargs)
    state = convert.dp_state_from_jax(
        ttr, {k: np.asarray(v) for k, v in init.items()}, imeta)
    inputs = ttr.shard_inputs(list(_small_data()))
    loss = []
    for _ in range(STEPS):
        *state, l, _ = ttr.step(*state, inputs)
        loss.append(float(l))
    got, meta = convert.dp_state_to_numpy(ttr, *state)
    assert meta["t"] == STEPS
    np.testing.assert_allclose(loss, wloss, rtol=RTOL, atol=ATOL)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def _rel(got, ref):
    return max(float(np.abs(got[n] - ref[n]).max())
               / float(np.abs(ref[n]).max()) for n in ref)


@pytest.mark.parametrize("plan,bar", [
    ("dp4.tp2+zero2", 8 * 2.0 ** -23), ("dp2.tp4+zero1", 8 * 2.0 ** -23),
    ("dp4.tp2", 1e-6), ("dp2.tp4", 1e-6)])
def test_plans_match_the_ports_dp(plan, bar):
    """Against the port's dp on the same 8 replicas: ZeRO over dp x tp
    within 8 float32 ulps of each tensor's largest element, stage-0
    tensor parallelism within 1e-6 of it; the ZeRO masters split
    1/(D·T)."""
    _, tm = _models("small")
    kw = dict(optimizer=tm.optimizer, apply_knobs=False, devices=CPU8,
              **tm.trainer_kwargs)
    ref, _, _ = _train(tpl.make_trainer(tm.symbol, tm.shape_kwargs,
                                        plan="dp", **kw), tm)
    tr = tpl.make_trainer(tm.symbol, tm.shape_kwargs, plan=plan, **kw)
    got, _, _ = _train(tr, tm)
    assert _rel(got, ref) <= bar
    if isinstance(tr, ZeroTrainer):
        L = tr.layout
        assert all(s * N_DEV == p for s, p in zip(L.shard_len, L.padded))


def test_lm_under_tensor_parallelism():
    """The 2-layer LM (embeddings, attention on the flash op, LayerNorm,
    the cross-entropy head) trained under dp2.tp4 and dp4.tp2+zero2
    against the port's dp over the same replicas (3 Adam steps): within
    1e-5 of each tensor's largest element; the layout gathers the
    attention's split inputs."""
    tm = tpl.ModelSpec(_lm_sym(tmx), LM_SHAPES, optimizer="adam",
                       learning_rate=1e-3, label_names=("label",))
    rng = np.random.RandomState(1)
    x = rng.randint(0, 64, LM_SHAPES["data"]).astype(np.float32)
    y = rng.randint(0, 64, LM_SHAPES["label"]).astype(np.float32)
    kw = dict(optimizer="adam", learning_rate=1e-3, label_names=("label",),
              apply_knobs=False, devices=["cpu"] * 4)
    ref, rl, _ = _train(tpl.make_trainer(tm.symbol, LM_SHAPES, plan="dp",
                                         **kw), tm, 3, (x, y))
    for plan in ("dp2.tp2", "dp2.tp2+zero2"):
        tr = tpl.make_trainer(tm.symbol, LM_SHAPES, plan=plan, **kw)
        got, gl, _ = _train(tr, tm, 3, (x, y))
        assert _rel(got, ref) <= 1e-5, plan
        np.testing.assert_allclose(gl, rl, rtol=1e-5)


def test_resume_dp_to_zero1_bitwise():
    """Train under plan="dp", export, import into a plan="zero1" trainer
    and keep training: equal to the uninterrupted dp run bit for bit
    (the JAX package's test_cross_plan_resume_dp_to_zero1_bitwise); a
    tensor-parallel commit holds full tensors and resumes under dp."""
    _, tm = _models("small")
    kw = dict(optimizer=tm.optimizer, apply_knobs=False, devices=CPU8,
              **tm.trainer_kwargs)
    tr_a = tpl.make_trainer(tm.symbol, tm.shape_kwargs, plan="dp", **kw)
    _, _, (pa, sa, xa) = _train(tr_a, tm, 4)
    arrays, meta = tr_a.export_training_state(pa, sa, xa)
    arrays = {k: v.clone() for k, v in arrays.items()}
    inputs = tr_a.shard_inputs(list(_small_data()))
    for _ in range(4):
        pa, sa, xa, _, _ = tr_a.step(pa, sa, xa, inputs)
    tr_b = tpl.make_trainer(tm.symbol, tm.shape_kwargs, plan="zero1", **kw)
    pb, sb, xb = tr_b.import_training_state(arrays, meta)
    inputs = tr_b.shard_inputs(list(_small_data()))
    for _ in range(4):
        pb, sb, xb, _, _ = tr_b.step(pb, sb, xb, inputs)
    ha, hb = tr_a.host_params(pa), tr_b.host_params(pb)
    assert all(np.array_equal(ha[n], hb[n]) for n in ha)
    tr_t = tpl.make_trainer(tm.symbol, tm.shape_kwargs, plan="dp4.tp2",
                            **kw)
    st = tr_t.import_training_state(arrays, meta)
    assert any(isinstance(p, tuple) for p in st[0])
    back, _ = tr_t.export_training_state(*st)
    for k, v in arrays.items():
        assert torch.equal(back[k], v), k


def test_resolve_stage_routes_like_jax(monkeypatch):
    """resolve_stage returns 0 for every plan name but zero1|zero2, as
    the JAX function does."""
    from mxnet_tpu_torch.parallel import zero
    for plan in ("auto", "dp", "dp2.tp4", "tp2+zero2", "zero1", "zero2"):
        monkeypatch.setenv("MXNET_PLAN", plan)
        assert zero.resolve_stage() == jzero.resolve_stage(), plan


def test_selftest_cli():
    """``--selftest --ctx cpu`` passes; ``--hlo-audit`` exits 2 naming
    XLA."""
    assert tpl.main(["--selftest", "--ctx", "cpu", "--devices", "8"]) == 0
    assert tpl.main(["--hlo-audit"]) == 2
