"""The port's cost source (``mxnet_tpu_torch.telemetry.costs``) and the
devstats surface that publishes it (``telemetry.devstats``), against hand
counts and the JAX package on the CPU.

Tolerances, stated before the runs:

* the product rules (FullyConnected, Convolution, Deconvolution, dot,
  batch_dot, the flash attention op) equal a hand count exactly;
* a training step's FLOPs on the bench arm (FC 256 -> 1024 -> 1024 -> 16,
  batch 16, Adam) within 15% of XLA's count read by the JAX package's
  ``devstats.extract`` from the compiled step, for dp on 1 replica, dp on
  8 and zero2 on 8 (XLA's elementwise and update counts are its own; the
  products agree exactly);
* ``peaks`` / ``mfu`` / ``roofline_frac`` / ``step_sample`` /
  ``fit_summary`` equal the JAX functions on the same inputs.
"""
import json
import os

import numpy as np
import pytest

import jax
import mxnet_tpu as jmx
from mxnet_tpu.parallel import planner as jpl
from mxnet_tpu.telemetry import devstats as jds
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.parallel import planner as tpl
from mxnet_tpu_torch.parallel import zero as tzero
from mxnet_tpu_torch.telemetry import costs, devstats as tds

BENCH_SK = {"data": (16, 256), "softmax_label": (16,)}
BENCH_KW = dict(optimizer="adam", learning_rate=1e-3, rescale_grad=1.0 / 16)
FLOPS_TOL = 0.15


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in tpl.AUTO_KNOB_VARS + ("MXNET_PLAN", "MXNET_DEVSTATS",
                                   "MXNET_DEVSTATS_PEAK_TFLOPS",
                                   "MXNET_DEVSTATS_PEAK_GBPS",
                                   "MXNET_DEVSTATS_HBM_BYTES"):
        if k in os.environ:
            monkeypatch.delenv(k)
    tds.reset()
    jds.reset()
    yield
    tds.reset()
    jds.reset()


def _node(sym, shapes, name):
    gc = costs.graph_costs(sym, shapes, is_train=True)
    return next(n for n in gc.nodes if n[0] == name), gc


@pytest.mark.parametrize("flatten", [True, False])
def test_fully_connected_exact(flatten):
    x = tmx.sym.Variable("data")
    y = tmx.sym.FullyConnected(x, num_hidden=24, flatten=flatten, name="fc")
    (_, _, f, b), _ = _node(y, {"data": (6, 5, 7)}, "fc")
    m, k = (6, 35) if flatten else (30, 7)
    prod = 2 * m * 24 * k
    assert f == prod + m * 24 and b == 2 * prod + m * 24


@pytest.mark.parametrize("groups", [1, 2])
def test_convolution_exact(groups):
    x = tmx.sym.Variable("data")
    y = tmx.sym.Convolution(x, kernel=(3, 3), num_filter=8, pad=(1, 1),
                            stride=(2, 2), num_group=groups, name="conv")
    (_, _, f, b), _ = _node(y, {"data": (2, 4, 9, 9)}, "conv")
    oh = ow = 5
    prod = 2 * 2 * 8 * (4 // groups) * 3 * 3 * oh * ow
    bias = 2 * 8 * oh * ow
    assert f == prod + bias and b == 2 * prod + bias


def test_deconvolution_exact():
    x = tmx.sym.Variable("data")
    y = tmx.sym.Deconvolution(x, kernel=(4, 4), num_filter=6, stride=(2, 2),
                              name="dec")
    (_, _, f, b), _ = _node(y, {"data": (2, 3, 5, 5)}, "dec")
    prod = 2 * 2 * 3 * 6 * 4 * 4 * 5 * 5
    bias = 2 * 6 * 12 * 12 if "dec_bias" in y.list_arguments() else 0
    assert f == prod + bias and b == 2 * prod + bias


def test_dots_exact():
    a, c = tmx.sym.Variable("a"), tmx.sym.Variable("c")
    y = tmx.sym.dot(a, c, transpose_a=True, name="d")
    (_, _, f, b), _ = _node(y, {"a": (7, 3), "c": (7, 5)}, "d")
    assert f == 2 * 3 * 5 * 7 and b == 2 * f
    y = tmx.sym.batch_dot(a, c, name="bd")
    (_, _, f, _), _ = _node(y, {"a": (4, 3, 6), "c": (4, 6, 2)}, "bd")
    assert f == 2 * 4 * 3 * 2 * 6


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_exact(causal):
    """4·B·H·D a (query, key) pair forward, 6 + 8 in the backward (dQ,
    dK/dV), the causal half by pairs: the flash kernels' own count."""
    q, k, v = (tmx.sym.Variable(n) for n in "qkv")
    y = tmx.sym.contrib.flash_attention(q, k, v, causal=causal, name="fa")
    s = 12
    shapes = {n: (2, 3, s, 16) for n in "qkv"}
    (_, _, f, b), _ = _node(y, shapes, "fa")
    pairs = s * (s + 1) // 2 if causal else s * s
    assert f == 4 * 2 * 3 * 16 * pairs and b == 14 * 2 * 3 * 16 * pairs


def test_unruled_ops_are_listed():
    """An op without a rule counts its output elements and is listed: the
    2-layer LM's graph and the SSD-style heads have none left."""
    from test_torch_planner import LM_SHAPES, _lm_sym
    gc = costs.graph_costs(_lm_sym(tmx), LM_SHAPES,
                           sharded=("data", "label"))
    assert gc.unruled == []
    x = tmx.sym.Variable("data")
    y = tmx.sym.topk(x, k=2, name="tk")
    gc = costs.graph_costs(y, {"data": (3, 8)}, is_train=False)
    assert gc.unruled == ["topk"] and gc.fwd_flops == 3 * 2


def _xla_flops(plan, n):
    jm = jpl.ModelSpec(jpl._bench_sym(dim=256, hidden=1024), BENCH_SK,
                       **BENCH_KW)
    p = jpl.parse_plan(plan, n, jm)
    rec = jpl.score_plan(jm, p, devices=jax.devices()[:n])
    return rec["flops"]


@pytest.mark.parametrize("plan,n", [("dp", 1), ("dp", 8), ("zero2", 8)])
def test_step_flops_within_15pct_of_xla(plan, n):
    tm = tpl.ModelSpec(tpl._bench_sym(dim=256, hidden=1024), BENCH_SK,
                       **BENCH_KW)
    p = tpl.parse_plan(plan, n, tm)
    got = tpl.score_plan(tm, p)["flops"]
    want = _xla_flops(plan, n)
    assert abs(got / want - 1) <= FLOPS_TOL, (got, want)
    # the products alone are the hand count, exactly
    gc = costs.graph_costs(tm.symbol, BENCH_SK, sharded=("data",
                                                         "softmax_label"),
                           diff=tm.param_names, d=n)
    prods = sum(f for name, op, f, _ in gc.nodes if op == "FullyConnected")
    hand = 2 * (16 // n) * (256 * 1024 + 1024 * 1024 + 1024 * 16)
    assert prods == hand + (16 // n) * (1024 + 1024 + 16)


def test_peaks_mfu_roofline_equal_jax(monkeypatch):
    assert tds.peaks() == jds.peaks()
    for fps in (1e9, 3.5e10, 2e11):
        assert tds.mfu(fps) == jds.mfu(fps)
        assert tds.roofline_frac(fps, 5e9, 1e9) == \
            jds.roofline_frac(fps, 5e9, 1e9)
        assert tds.roofline_frac(fps, 5e9, 0) == \
            jds.roofline_frac(fps, 5e9, 0)
    monkeypatch.setenv("MXNET_DEVSTATS_PEAK_TFLOPS", "1.0")
    monkeypatch.setenv("MXNET_DEVSTATS_PEAK_GBPS", "100.0")
    assert tds.peaks() == jds.peaks() == (1e12, 1e11, "env")
    for mod in (tds, jds):
        mod.set_step_costs("p.step", 5.0e9, 1.0e9)
    assert tds.step_sample(0.01, 2) == jds.step_sample(0.01, 2)
    assert tds.step_sample(0.01, 2)["mfu"] == 1.0
    assert tds.fit_summary() == jds.fit_summary()
    assert tds.step_costs() == jds.step_costs()
    monkeypatch.setenv("MXNET_DEVSTATS", "0")
    assert tds.step_sample(0.01, 2) is None and tds.fit_summary() == {}


def test_h100_rows():
    """The card's table: f32 FMA 67, TF32 495, bf16 989 TFLOP/s and
    3.35 TB/s (the rates chip_smoke.py's bounds use)."""
    rows = tds._PEAKS
    assert rows[("H100", "float32")] == (67e12, 3.35e12)
    assert rows[("H100", "tf32")] == (495e12, 3.35e12)
    assert rows[("H100", "bfloat16")] == (989e12, 3.35e12)


def test_extract_keys_equal_jax():
    prog = {"flops": 10.0, "bytes": 20.0, "param_bytes": 8,
            "state_bytes": 16, "input_bytes": 4, "act_bytes": 12}
    got = tds.extract(prog)
    assert set(got) == set(jds.extract(object()))
    assert got["argument_bytes"] == 28 and got["alias_bytes"] == 24
    assert got["generated_code_bytes"] == 0
    assert got["peak_bytes"] == 28 + 24 + 12 - 24


def test_zero_flops_and_dispatch_costs():
    """A ZeRO step sets zero_flops_per_step to the cost source's count,
    and devstats records the step program under the JAX package's name
    (synchronously, once per shape signature)."""
    tm = tpl._small_model()[0]
    tr = tzero.ZeroTrainer(tm.symbol, tpl.build_mesh({"data": 4},
                                                     ["cpu"] * 4),
                           zero_stage=2, optimizer="sgd",
                           **tm.trainer_kwargs)
    state = tr.init_state(tm.shape_kwargs)
    rng = np.random.RandomState(0)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    y = rng.randint(0, 8, 16).astype(np.float32)
    tr.step(*state, tr.shard_inputs([x, y]))
    flops = tzero.counters()["zero_flops_per_step"]
    want = tpl.score_plan(tm, tpl.parse_plan("zero2", 4, tm))["flops"]
    assert flops > 0 and flops == want
    assert tds.step_costs()["name"] == "zero2.step"
    assert tds.program_stats("zero2.step")["flops"] == flops


def test_fused_fit_rows_carry_mfu(tmp_path, monkeypatch):
    """The step log's rows of a fused fit carry mfu / roofline_frac /
    model_flops_per_s, and its run_end the fit summary."""
    log = tmp_path / "steps.jsonl"
    monkeypatch.setenv("MXNET_TELEMETRY_LOG", str(log))
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.trainer import fused_fit
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu", in_units=8))
    net.add(gluon.nn.Dense(4, in_units=16))
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    rng = np.random.RandomState(0)
    data = [(tmx.nd.array(rng.normal(size=(8, 8)), ctx=tmx.cpu()),
             tmx.nd.array(rng.randint(0, 4, 8), ctx=tmx.cpu()))
            for _ in range(8)]
    fused_fit(net, gluon.loss.SoftmaxCrossEntropyLoss(), data, num_epoch=1,
              optimizer="sgd", optimizer_params={"learning_rate": 0.1},
              steps_per_dispatch=4, contexts=[tmx.cpu()])
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    steps = [r for r in rows if r["event"] == "step"]
    assert steps and all("mfu" in r and "roofline_frac" in r
                         for r in steps)
    end = [r for r in rows if r["event"] == "run_end"][-1]
    assert end["devstats_program"] == "dp.step_k4"
    assert end["devstats_peak_source"] == "table:cpu"


def test_devstats_selftest_cli():
    """``python -m mxnet_tpu_torch.telemetry.devstats --selftest --ctx
    cpu``: on/off fits bit-identical (its overhead gate is read on the
    card; the host's is noise at this size)."""
    rc = tds._selftest("cpu", max_overhead_pct=1e9)
    assert rc == 0
