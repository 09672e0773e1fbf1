"""The port's ZeRO trainer (``mxnet_tpu_torch.parallel.zero``) against the
JAX package's, on the CPU.

Each JAX ``ZeroTrainer`` runs once a module on a 4-device virtual CPU
mesh (cached by configuration); the port's runs over 4 host replicas
(``cpu(0..3)``) from the JAX trainer's initial arrays, on the same
seeded numpy batch, for 4 steps. Tolerances, stated before the runs:

* float32 (sgd with momentum, adam; stages 1 and 2): ``rtol=2e-4,
  atol=1e-5`` on parameters and optimizer states, as the port's dp test
  holds dp (tests/test_torch_dp.py): the products sum in another order
  than XLA's.
* compressed wires: the update of the parameters (after - before) within
  2^-6 (bf16) or 2^-2 (fp8) of its norm, norm-wise. The wire sum rounds
  every partial sum to the wire dtype (8 bits of mantissa for bf16, 2^-8
  relative a rounding; 3 for fp8, 2^-3), and XLA's CPU all-reduce may
  take the replicas in another order and keep a wider sum, so a few
  roundings of the summed gradient may differ. The residuals are held
  to the same bound after the first step (from the same state the local
  gradients agree to float32 rounding, and the residual is acc minus its
  rounding). After several steps a residual moves by the whole change
  of the local gradient, which follows the parameters' small difference
  above while the residual itself is one wire ulp (at bf16 a 1e-3
  difference of the parameters moves the residuals ~20% norm-wise): it
  is not compared there.
* BatchNorm (local statistics, aux pmean'd): float32's bound.

The port's own contracts are held exactly: float32 stage 1 bit-identical
to the port's dp (the sums from the last replica to the first, autograd's
order), stage 2 to stage 1, a skipped fp16 step changing nothing but the
scaler, resumes across stages and into dp bit for bit.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import ml_dtypes
import mxnet_tpu as jmx
from mxnet_tpu.parallel.planner import AUTO_KNOB_VARS
from mxnet_tpu.parallel import data_parallel_mesh as jmesh
from mxnet_tpu.parallel import zero as jzero
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import DataParallelTrainer, ZeroTrainer, \
    build_mesh, mesh_for_contexts, zero
from mxnet_tpu_torch.parallel.mesh import cast_wire

N = 4
BATCH, DIM, NCLASS = 16, 24, 8
STEPS = 4
RTOL, ATOL = 2e-4, 1e-5
WIRE_TOL = {"bf16": 2.0 ** -6, "fp8": 2.0 ** -2}
BUCKET_MB = 0.002          # several buckets for the small nets


@pytest.fixture(autouse=True)
def _no_planner_settings(monkeypatch):
    """Another test in this process may leave the JAX planner's settings
    in os.environ (tests/test_planner.py's ``test_knobs_auto_unless_set``
    leaves ``MXNET_ZERO_STAGE``): each one set is removed for the test."""
    for k in AUTO_KNOB_VARS + ("MXNET_PLAN",):
        if k in os.environ:
            monkeypatch.delenv(k)


def _mlp(mx):
    with mx.NameManager():
        net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=32,
                                    name="zfc1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=NCLASS, name="zfc2")
        return mx.sym.SoftmaxOutput(net, name="softmax")


def _bn(mx):
    with mx.NameManager():
        net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=32,
                                    name="zfc1")
        net = mx.sym.BatchNorm(net, fix_gamma=False, name="zbn")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=NCLASS, name="zfc2")
        return mx.sym.SoftmaxOutput(net, name="softmax")


NETS = {"mlp": _mlp, "bn": _bn}
SHAPES = {"data": (BATCH, DIM), "softmax_label": (BATCH,)}


def _data(seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    x = (scale * rng.normal(size=(BATCH, DIM))).astype(np.float32)
    y = rng.randint(0, NCLASS, size=(BATCH,)).astype(np.float32)
    return x, y


def _kw(optimizer, dtype):
    kw = dict(optimizer=optimizer, rescale_grad=1.0 / BATCH, dtype=dtype,
              learning_rate=0.1 if optimizer == "sgd" else 0.01)
    if optimizer == "sgd":
        kw["momentum"] = 0.9
    return kw


def _jax_trainer(net, stage, compress, optimizer, dtype):
    mesh = jmesh(N, jax.devices()[:N])
    kw = _kw(optimizer, dtype)
    if stage == 0:
        return jmx.parallel.DataParallelTrainer(NETS[net](jmx), mesh,
                                                zero_stage=0, **kw)
    return jzero.ZeroTrainer(NETS[net](jmx), mesh, zero_stage=stage,
                             grad_compress=compress,
                             zero_bucket_mb=BUCKET_MB, **kw)


def _port_trainer(net, stage, compress, optimizer, dtype, mesh=None):
    mesh = mesh or mesh_for_contexts([tmx.cpu(i) for i in range(N)])
    kw = _kw(optimizer, dtype)
    if stage == 0:
        return DataParallelTrainer(NETS[net](tmx), mesh, zero_stage=0, **kw)
    return DataParallelTrainer(NETS[net](tmx), mesh, zero_stage=stage,
                               grad_compress=compress,
                               zero_bucket_mb=BUCKET_MB, **kw)


def _np_state(arrays):
    return {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v,
                          np.float32) for k, v in arrays.items()}


_JAX_RUNS = {}


def _jax_run(net, stage, compress="none", optimizer="sgd",
             dtype="float32"):
    """(initial export, export after STEPS steps, losses) of the JAX
    trainer, once a module per configuration."""
    key = (net, stage, compress, optimizer, dtype)
    if key not in _JAX_RUNS:
        tr = _jax_trainer(net, stage, compress, optimizer, dtype)
        params, states, aux = tr.init_state(SHAPES)
        init = tr.export_training_state(params, states, aux)
        inputs = tr.shard_inputs(list(_data()))
        losses, first = [], None
        for i in range(STEPS):
            params, states, aux, loss, _ = tr.step(params, states, aux,
                                                   inputs)
            losses.append(float(np.asarray(loss)))
            if i == 0:
                first = _np_state(tr.export_training_state(
                    params, states, aux)[0])
        arrays, meta = tr.export_training_state(params, states, aux)
        _JAX_RUNS[key] = (init, (_np_state(arrays), meta), losses, first)
    return _JAX_RUNS[key][:3]


def _port_run(tr, init, steps=STEPS, data=None):
    params, states, aux = tr.import_training_state(
        _np_state(init[0]), dict(init[1]))
    inputs = tr.shard_inputs(list(data or _data()))
    losses = []
    for _ in range(steps):
        params, states, aux, loss, _ = tr.step(params, states, aux, inputs)
        losses.append(float(loss))
    arrays, meta = tr.export_training_state(params, states, aux)
    return _np_state(arrays), meta, losses


def _assert_f32(got, want, keys=None):
    for k in keys or want:
        if k.startswith("zero_resid"):
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


# -- the layout ---------------------------------------------------------------

@pytest.mark.parametrize("shapes,n,bucket", [
    ([(64, 64), (64,), (64, 16), (16,)], 4, 4 * 64 * 64),
    ([(3, 5), (7,), (1,), (), (130, 3), (2, 2, 2)], 8, 64),
    ([(1000,), (10, 10), (33,)], 3, 1 << 20),
])
def test_layout_equals_jax(shapes, n, bucket):
    """Buckets, offsets, padding, shard lengths, ownership, wire bytes and
    the overlap share: the JAX package's, number for number."""
    J = jzero.ZeroLayout(shapes, n, bucket)
    T = zero.ZeroLayout(shapes, n, bucket)
    for attr in ("buckets", "offsets", "totals", "padded", "shard_len",
                 "sizes"):
        assert getattr(T, attr) == getattr(J, attr), attr
    names = [f"p{i}" for i in range(len(shapes))]
    assert T.ownership(names, 2) == J.ownership(names, 2)
    for stage in (1, 2):
        for ci, wi in ((4, 4), (2, 2), (2, 1)):
            assert T.wire_bytes_breakdown(stage, ci, wi) == \
                J.wire_bytes_breakdown(stage, ci, wi)
            assert T.wire_bytes_per_step(stage, ci, wi) == \
                J.wire_bytes_per_step(stage, ci, wi)
    assert T.overlap_frac() == J.overlap_frac()


# -- the steps against the JAX package ------------------------------------------

@pytest.mark.parametrize("stage,optimizer", [(1, "sgd"), (2, "sgd"),
                                             (1, "adam"), (2, "adam")])
def test_float32_steps_match_jax(stage, optimizer):
    init, (want, wmeta), wloss = _jax_run("mlp", stage, optimizer=optimizer)
    tr = _port_trainer("mlp", stage, "none", optimizer, "float32")
    assert isinstance(tr, ZeroTrainer) and tr._zero_stage == stage
    got, meta, losses = _port_run(tr, init)
    assert set(got) == set(want)
    _assert_f32(got, want)
    np.testing.assert_allclose(losses, wloss, rtol=1e-5)
    assert meta["t"] == wmeta["t"] == STEPS
    assert meta["zero"]["ownership"] == wmeta["zero"]["ownership"]
    assert meta["zero"]["stage"] == stage


def _update_close(got, want, init, tol, prefix):
    keys = [k for k in want if k.startswith(prefix)]
    assert keys
    d = np.concatenate([(got[k] - want[k]).ravel() for k in keys])
    u = np.concatenate([(want[k] - init[k]).ravel() for k in keys]) \
        if init is not None else np.concatenate(
            [want[k].ravel() for k in keys])
    assert np.linalg.norm(d) <= tol * np.linalg.norm(u), \
        (prefix, np.linalg.norm(d) / np.linalg.norm(u))


@pytest.mark.parametrize("compress", ["bf16", "fp8"])
def test_compressed_wire_matches_jax(compress):
    """Stage 2 with the wire cast and its error-feedback residual."""
    init, (want, _), wloss = _jax_run("mlp", 2, compress)
    first = _JAX_RUNS[("mlp", 2, compress, "sgd", "float32")][3]
    tol = WIRE_TOL[compress]
    got1, _, _ = _port_run(_port_trainer("mlp", 2, compress, "sgd",
                                         "float32"), init, steps=1)
    _update_close(got1, first, None, tol, "zero_resid:")
    assert sum(float(np.abs(got1[k]).sum()) for k in got1
               if k.startswith("zero_resid")) > 0
    tr = _port_trainer("mlp", 2, compress, "sgd", "float32")
    got, meta, losses = _port_run(tr, init)
    _update_close(got, want, _np_state(init[0]), tol, "param:")
    np.testing.assert_allclose(losses, wloss, rtol=tol)


def test_batchnorm_local_statistics_match_jax():
    """BatchNorm statistics are each replica's own under ZeRO, the aux
    states pmean'd after: the JAX package's semantics, which the port's
    dp (whole-batch statistics) must miss."""
    init, (want, _), _ = _jax_run("bn", 2)
    got, _, _ = _port_run(_port_trainer("bn", 2, "none", "sgd", "float32"),
                          init)
    _assert_f32(got, want)
    dp, _, _ = _port_run(_port_trainer("bn", 0, "none", "sgd", "float32"),
                         init)
    assert any(not np.allclose(dp[k], want[k], rtol=RTOL, atol=ATOL)
               for k in want if k.startswith("param:"))


# -- the port's own contracts -----------------------------------------------------

def _port_steps(tr, steps, data=None):
    params, states, aux = tr.init_state(SHAPES)
    inputs = tr.shard_inputs(list(data or _data()))
    for _ in range(steps):
        params, states, aux, loss, outs = tr.step(params, states, aux,
                                                  inputs)
    return params, states, aux, loss, outs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage1_equals_dp_and_stage2_equals_stage1(dtype):
    """The sums run from the last replica to the first, the order in
    which autograd sums dp's replicas: float32 and bfloat16 stage 1 are
    dp bit for bit, and stage 2 (the same sums a slice a replica) stage 1."""
    trs = [_port_trainer("mlp", s, "none", "sgd", dtype) for s in (0, 1, 2)]
    host = []
    for tr in trs:
        params, _, _, _, _ = _port_steps(tr, 5)
        host.append(tr.host_params(params))
    for h in host[1:]:
        assert h.keys() == host[0].keys()
        for n in h:
            assert np.array_equal(h[n], host[0][n]), n


def test_fp16_scaler_skip_changes_nothing_but_the_scaler():
    """A non-finite fp16 step: masters, optimizer states, residuals and
    aux unchanged, t not advanced, the scale backed off and the skip
    counted, as the JAX trainer does on the same inputs."""
    big = _data(scale=1e5)
    scalers = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            tr = _jax_trainer("bn", 2, "bf16", "sgd", "float16")
        else:
            tr = _port_trainer("bn", 2, "bf16", "sgd", "float16")
        params, states, aux = tr.init_state(SHAPES)
        params, states, aux, _, _ = tr.step(params, states, aux,
                                            tr.shard_inputs(list(_data())))
        before = _np_state(tr.export_training_state(params, states,
                                                    aux)[0])
        params, states, aux, _, _ = tr.step(params, states, aux,
                                            tr.shard_inputs(list(big)))
        arrays, meta = tr.export_training_state(params, states, aux)
        after = _np_state(arrays)
        assert meta["t"] == 1.0
        assert tr.skipped_steps == 1
        for k in before:
            assert np.array_equal(before[k], after[k]), (pkg, k)
        scalers.append(meta["loss_scaler"])
    assert scalers[0] == scalers[1]


def test_routing_and_refusals(monkeypatch):
    """MXNET_ZERO_STAGE and the pure-zero plans route a plain
    construction; every other plan name routes to stage 0 as the JAX
    package's ``resolve_stage`` does; param_specs build a tensor-parallel
    trainer on a data x model mesh and a ZeroTrainer takes an N-D mesh
    (the planner's compositions, tests/test_torch_planner.py)."""
    sym = _mlp(tmx)
    mesh = mesh_for_contexts([tmx.cpu(i) for i in range(N)])
    monkeypatch.setenv("MXNET_ZERO_STAGE", "2")
    tr = DataParallelTrainer(sym, mesh)
    assert isinstance(tr, ZeroTrainer) and tr._zero_stage == 2
    monkeypatch.setenv("MXNET_ZERO_STAGE", "0")
    monkeypatch.setenv("MXNET_PLAN", "zero2")
    assert not isinstance(DataParallelTrainer(sym, mesh), ZeroTrainer)
    monkeypatch.delenv("MXNET_ZERO_STAGE")
    tr = DataParallelTrainer(sym, mesh)
    assert isinstance(tr, ZeroTrainer) and tr._zero_stage == 2
    monkeypatch.setenv("MXNET_PLAN", "zero1")
    assert DataParallelTrainer(sym, mesh)._zero_stage == 1
    for plan in ("dp2.tp2", "dp2.tp2+zero2", "tp2", "dp", "auto"):
        monkeypatch.setenv("MXNET_PLAN", plan)
        assert zero.resolve_stage() == jzero.resolve_stage() == 0, plan
        assert not isinstance(DataParallelTrainer(sym, mesh), ZeroTrainer)
    monkeypatch.delenv("MXNET_PLAN")
    monkeypatch.setenv("MXNET_ZERO_STAGE", "7")
    with pytest.raises(MXNetError, match="0|1|2"):
        DataParallelTrainer(sym, mesh)
    monkeypatch.delenv("MXNET_ZERO_STAGE")
    monkeypatch.setenv("MXNET_GRAD_COMPRESS", "fp8")
    monkeypatch.setenv("MXNET_ZERO_BUCKET_MB", "0.5")
    tr = DataParallelTrainer(sym, mesh, zero_stage=1)
    assert tr._compress == "fp8" and tr._bucket_bytes == 1 << 19
    assert isinstance(ZeroTrainer(sym, mesh), ZeroTrainer)
    monkeypatch.delenv("MXNET_GRAD_COMPRESS")
    mesh2 = build_mesh({"data": 2, "model": 2}, ["cpu"] * 4)
    tr = DataParallelTrainer(sym, mesh2, param_specs={
        "zfc1_weight": ("model", None), "zfc1_bias": ("model",),
        "zfc2_weight": (None, "model")})
    params, _, _ = tr.init_state(SHAPES)
    assert [len(p) if isinstance(p, tuple) else 1 for p in params] == \
        [2, 2, 2, 1]
    tz = ZeroTrainer(sym, mesh2, zero_stage=2)
    assert tz._model_factor == 2 and tz._program_tag == "zstep_t2s2n"
    masters, _, _ = tz.init_state(SHAPES)
    assert all(len(b) == 4 for b in masters)


def test_resume_across_stage_change_and_into_dp():
    """A ZeRO-1 export restores into ZeRO-2 (the same parameters) and into
    plain dp, whose next step equals ZeRO-1's bit for bit."""
    tr1 = _port_trainer("mlp", 1, "none", "adam", "float32")
    p1, s1, a1, _, _ = _port_steps(tr1, 3)
    arrays, meta = tr1.export_training_state(p1, s1, a1)
    assert meta["zero"]["stage"] == 1
    tr2 = _port_trainer("mlp", 2, "none", "adam", "float32")
    p2, _, _ = tr2.import_training_state(arrays, meta)
    h1 = tr1.host_params(p1)
    for n, v in tr2.host_params(p2).items():
        assert np.array_equal(v, h1[n]), n
    trd = _port_trainer("mlp", 0, "none", "adam", "float32")
    pd, sd, ad = trd.import_training_state(arrays, meta)
    x = tr1.shard_inputs(list(_data()))
    p1, s1, a1, _, _ = tr1.step(p1, s1, a1, x)
    pd, sd, ad, _, _ = trd.step(pd, sd, ad, trd.shard_inputs(list(_data())))
    hd = trd.host_params(pd)
    for n, v in tr1.host_params(p1).items():
        assert np.array_equal(v, hd[n]), n
    # a compressed trainer restoring an uncompressed snapshot starts its
    # residuals at zero
    tr8 = _port_trainer("mlp", 2, "fp8", "adam", "float32")
    p8, s8, a8 = tr8.import_training_state(arrays, meta)
    assert all(float(r.abs().sum()) == 0 for rs in tr8._resid for r in rs)
    # and a compressed snapshot restores with compression off: the
    # residuals are dropped, the parameters kept
    p8, s8, a8, _, _ = tr8.step(p8, s8, a8, tr8.shard_inputs(list(_data())))
    arrays8, meta8 = tr8.export_training_state(p8, s8, a8)
    assert any(k.startswith("zero_resid:") for k in arrays8)
    trn = _port_trainer("mlp", 1, "none", "adam", "float32")
    pn, _, _ = trn.import_training_state(arrays8, meta8)
    assert trn._resid == ()
    h8 = tr8.host_params(p8)
    for n, v in trn.host_params(pn).items():
        assert np.array_equal(v, h8[n]), n


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_cross_the_packages(tmp_path, direction):
    """A ZeRO-2 fp8 commit of one package restores into the other's ZeRO
    trainer (residuals included) and the next step agrees; the commit
    places each optimizer array whole in the shard that owns it."""
    from mxnet_tpu.checkpoint import CheckpointManager as JManager
    from mxnet_tpu.checkpoint import TrainingState as JState
    from mxnet_tpu_torch.checkpoint import CheckpointManager, TrainingState
    init, _, _ = _jax_run("mlp", 2, "fp8")
    d = str(tmp_path / "ckpt")
    x, y = _data(seed=3)
    if direction == "jax_to_port":
        src = _jax_trainer("mlp", 2, "fp8", "sgd", "float32")
        params, states, aux = src.init_state(SHAPES)
        params, states, aux, _, _ = src.step(params, states, aux,
                                             src.shard_inputs([x, y]))
        arrays, meta = src.export_training_state(params, states, aux)
        JManager(d, async_save=False, num_shards=N).save(
            JState(arrays=arrays, meta={"step": 1, "trainer": meta}), step=1)
        restored = CheckpointManager(d).restore()
        dst = _port_trainer("mlp", 2, "fp8", "sgd", "float32")
    else:
        src = _port_trainer("mlp", 2, "fp8", "sgd", "float32")
        params, states, aux = src.import_training_state(
            _np_state(init[0]), dict(init[1]))
        params, states, aux, _, _ = src.step(params, states, aux,
                                             src.shard_inputs([x, y]))
        arrays, meta = src.export_training_state(params, states, aux)
        mgr = CheckpointManager(d, async_save=False, num_shards=N)
        mgr.save(TrainingState(arrays=arrays,
                               meta={"step": 1, "trainer": meta}), step=1)
        mgr.close()
        restored = JManager(d).restore()
        dst = _jax_trainer("mlp", 2, "fp8", "sgd", "float32")
        dst.init_state(SHAPES)
    import glob
    with open(glob.glob(os.path.join(d, "*", "TOPOLOGY.json"))[0]) as f:
        smap = json.load(f)["shard_map"]
    own = meta["zero"]["ownership"]
    for k, shard in own.items():
        if k.startswith("opt:"):
            assert smap[k] == {"mode": "whole", "shard": shard}, k
    tmeta = restored.meta["trainer"]
    p, s, a = dst.import_training_state(restored.arrays, tmeta)
    p, s, a, _, _ = dst.step(p, s, a, dst.shard_inputs([x, y]))
    p0, s0, a0, _, _ = src.step(params, states, aux,
                                src.shard_inputs([x, y]))
    want = _np_state(src.export_training_state(p0, s0, a0)[0])
    got = _np_state(dst.export_training_state(p, s, a)[0])
    _update_close(got, want, _np_state(arrays), WIRE_TOL["fp8"], "param:")


def test_counters_and_steplog_zero_keys(tmp_path, monkeypatch):
    """``counters()`` grows by the layout's wire bytes a step, and the
    step log's records carry the zero_* keys once the export is hooked."""
    from mxnet_tpu_torch.telemetry.steplog import StepLogger
    tr = _port_trainer("mlp", 2, "fp8", "sgd", "float32")
    c0 = zero.counters()
    _port_steps(tr, 2)
    c1 = zero.counters()
    assert c1["zero_steps"] - c0["zero_steps"] == 2
    assert c1["zero_wire_bytes"] - c0["zero_wire_bytes"] == \
        2 * tr.layout.wire_bytes_per_step(2, 4, 1)
    assert c1["zero_compress_bits"] == 8 and c1["zero_stage"] == 2
    assert c1["zero_buckets"] == tr.layout.n_buckets
    log = tmp_path / "steps.jsonl"
    monkeypatch.setenv("MXNET_TELEMETRY_LOG", str(log))
    slog = StepLogger("test_zero")
    zero._COUNTERS["zero_wire_bytes"] += 12345
    zero._COUNTERS["zero_overlap_frac"] = 0.5
    slog.step(samples=4)
    slog.close()
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    steps = [r for r in recs if r.get("event") == "step"]
    assert steps and steps[0]["zero_wire_bytes"] == 12345
    assert steps[0]["zero_overlap_frac"] == 0.5


def test_fp8_cast_pinned_to_ml_dtypes():
    """The wire cast rounds as ml_dtypes' float8_e4m3fn (and XLA's):
    ties to even, NaN beyond ±464 and for ±inf, where torch's own cast
    saturates to ±448."""
    v = np.array([447, 448, 449, 456, 460, 463.9, 464, 464.1, 470, 480, 500,
                  1e4, -448, -464, -464.5, -1e4, np.inf, -np.inf, 17, 19,
                  1.0625, 1.1875, 2.0 ** -9 * 1.5, 2.0 ** -10, 0.0, -0.0],
                 np.float32)
    want = v.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)
    got = cast_wire(torch.from_numpy(v), torch.float8_e4m3fn) \
        .to(torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    bf = cast_wire(torch.from_numpy(v), torch.bfloat16).to(torch.float32)
    np.testing.assert_array_equal(
        bf.numpy(), v.astype(ml_dtypes.bfloat16).astype(np.float32))


def _tiny_lm(mx):
    """Embedding, a ReLU MLP and the softmax cross-entropy over a small
    vocabulary: the card's zero_lm loss (the Gluon LM) in miniature."""
    with mx.NameManager():
        x = mx.sym.Embedding(mx.sym.Variable("data"), input_dim=LM_VOCAB,
                             output_dim=32, name="zemb")
        h = mx.sym.FullyConnected(x, num_hidden=128, flatten=False,
                                  name="zfc1")
        h = mx.sym.Activation(h, act_type="relu")
        out = mx.sym.FullyConnected(h, num_hidden=LM_VOCAB, flatten=False,
                                    name="zfc2")
        return mx.gluon.loss.SoftmaxCrossEntropyLoss()(
            out, mx.sym.Variable("label"))


LM_VOCAB, LM_SEQ = 256, 16
LM_KW = dict(optimizer="adam", learning_rate=1e-3, rescale_grad=1.0 / BATCH,
             data_names=("data",), label_names=("label",), zero_stage=2)


def test_fp8_loss_gap_matches_jax(capsys):
    """The fp8 wire's loss gap to float32 (stage 2, Adam at ten times the
    card's zero_lm learning rate, so that the gap stands well above the
    losses' float32 rounding) is the JAX package's: e4m3 without a scale
    sends a summed gradient element under 2^-10 as 0 (into the residual)
    in both, so the fp8 arm trails and the gap grows over the first
    steps. Each step's relative gap within 1e-2 of the JAX package's
    (the wire sums may round a few elements differently) plus 2^-21, four
    float32 ulps of a loss (the gap is a difference of two). A step whose
    residual is never added back (zeroed after every step) must leave
    the fp8 arm's losses from the third on."""
    rng = np.random.RandomState(5)
    x = rng.randint(0, LM_VOCAB, size=(BATCH, LM_SEQ)).astype(np.float32)
    y = rng.randint(0, LM_VOCAB, size=(BATCH, LM_SEQ)).astype(np.float32)
    shapes = {"data": x.shape, "label": y.shape}
    losses = {}
    for comp in ("none", "fp8", "fp8 no feedback"):
        wire = comp.split()[0]
        if comp != "fp8 no feedback":
            jt = jzero.ZeroTrainer(_tiny_lm(jmx), jmesh(N, jax.devices()[:N]),
                                   grad_compress=wire, **LM_KW)
            p, s, a = jt.init_state(shapes)
            init = jt.export_training_state(p, s, a)
            inputs = jt.shard_inputs([x, y])
            jl = []
            for _ in range(STEPS):
                p, s, a, loss, _ = jt.step(p, s, a, inputs)
                jl.append(float(np.asarray(loss)))
            losses[("jax", comp)] = jl
        tr = DataParallelTrainer(
            _tiny_lm(tmx), mesh_for_contexts([tmx.cpu(i) for i in range(N)]),
            grad_compress=wire, **LM_KW)
        st = tr.import_training_state(_np_state(init[0]), dict(init[1]))
        inputs = tr.shard_inputs([x, y])
        pl = []
        for _ in range(STEPS):
            *st, loss, _ = tr.step(*st, inputs)
            pl.append(float(loss))
            if comp == "fp8 no feedback":
                for rs in tr._resid:
                    for r in rs:
                        r.zero_()
        losses[("port", comp)] = pl
    gap = {pkg: [(a - b) / b for a, b in zip(losses[(pkg, "fp8")],
                                            losses[(pkg, "none")])]
           for pkg in ("jax", "port")}
    with capsys.disabled():
        print("\nfp8 relative loss gap to float32 by step: jax %s, port %s"
              % (gap["jax"], gap["port"]))
    np.testing.assert_allclose(gap["port"], gap["jax"], rtol=1e-2,
                               atol=2.0 ** -21)
    assert gap["jax"][0] == 0 and 0 < gap["jax"][1] < gap["jax"][-1]
    nofb, fb = losses[("port", "fp8 no feedback")], losses[("port", "fp8")]
    assert nofb[:2] == fb[:2] and nofb[2] != fb[2]


def test_fused_fit_writes_back_the_zero_parameters(monkeypatch):
    """Gluon ``fused_fit`` under MXNET_ZERO_STAGE=1 on host replicas writes
    the trained parameters into the net (a ZeRO trainer's params are flat
    bucket shards: the write-back goes through ``device_params``): the
    same parameters as the plain-dp fit, bit for bit."""
    nn = tmx.gluon.nn
    rng = np.random.RandomState(4)
    batches = [(tmx.nd.array(rng.normal(size=(16, 10)).astype(np.float32),
                             ctx=tmx.cpu()),
                tmx.nd.array(rng.randint(0, 3, 16).astype(np.float32),
                             ctx=tmx.cpu())) for _ in range(4)]
    got = {}
    for stage in ("0", "1"):
        monkeypatch.setenv("MXNET_ZERO_STAGE", stage)
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(16, activation="relu"))
            net.add(nn.Dense(3))
        net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
        net(batches[0][0])
        prng = np.random.RandomState(1)
        for _, p in net.collect_params().items():
            p.set_data(tmx.nd.array(
                prng.normal(0, 0.3, p.shape).astype(np.float32),
                ctx=tmx.cpu()))
        with tmx.cpu():
            tmx.gluon.trainer.fused_fit(
                net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), batches, 2,
                optimizer="sgd", optimizer_params={"learning_rate": 0.2,
                                                   "momentum": 0.9},
                steps_per_dispatch=2,
                contexts=[tmx.cpu(i) for i in range(N)])
        got[stage] = [p.data().asnumpy()
                      for _, p in net.collect_params().items()]
    for a, b in zip(got["0"], got["1"]):
        assert np.array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(
        got["1"], [np.random.RandomState(1).normal(0, 0.3, a.shape)
                   for a in got["1"]]))


def test_module_fused_fit_under_zero_resumes_across_a_stage_change(
        tmp_path, monkeypatch):
    """Module.fit(steps_per_dispatch=2) over 4 host contexts: under
    MXNET_ZERO_STAGE=1 it trains dp's parameters bit for bit, its epoch
    callbacks see them (host_params), and a ZeRO-1 commit resumed under
    ZeRO-2 ends where the uninterrupted run does."""
    rng = np.random.RandomState(42)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    y = rng.randint(0, 4, size=(32,)).astype(np.float32)

    def fit(stage, epochs, ckpt=None, resume=False):
        monkeypatch.setenv("MXNET_ZERO_STAGE", stage)
        np.random.seed(0)
        tmx.random.seed(0)
        seen = []
        mod = tmx.mod.Module(_mlp(tmx),
                             context=[tmx.cpu(i) for i in range(N)])
        mod.fit(tmx.io.NDArrayIter(x, y, batch_size=8, shuffle=False),
                num_epoch=epochs, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=tmx.init.Xavier(rnd_type="gaussian"),
                steps_per_dispatch=2, checkpoint_dir=ckpt, resume=resume,
                epoch_end_callback=lambda e, s, a, x_: seen.append(
                    {n: v.asnumpy() for n, v in a.items()}))
        assert type(mod.fused_trainer).__name__ == (
            "ZeroTrainer" if stage != "0" else "DataParallelTrainer")
        args = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
        return args, seen

    base, _ = fit("0", 4)
    z1, seen = fit("1", 4)
    for n in base:
        assert np.array_equal(z1[n], base[n]), n
        assert np.array_equal(seen[-1][n], base[n]), n
    d = str(tmp_path / "ckpt")
    fit("1", 2, ckpt=d)
    resumed, _ = fit("2", 4, ckpt=d, resume=True)
    for n in base:
        assert np.array_equal(resumed[n], base[n]), n
