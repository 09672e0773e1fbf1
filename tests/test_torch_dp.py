"""The port's DataParallelTrainer against the JAX package's, on the CPU.

Both trainers start from the same ``init_state`` draw (the JAX package's
``np.random.RandomState(seed)`` N(0, 0.01) in parameter order) and take
the same seeded numpy batches; the JAX trainer runs over the conftest's
virtual CPU devices, the port's over ``cpu(i)`` replicas (one walk of the
graph over the replicas, the whole batch's BatchNorm statistics). Float32
parameters, optimizer states and aux states are held to JAX's own
``rtol=2e-4, atol=1e-5`` (tests/test_parallel.py) after 3 steps; a
per-replica BatchNorm (the reference MXNet's executor group) must miss
that bound. Adam runs at lr 0.01: it moves every element by up to lr
whatever its gradient, so an element whose gradient is at rounding level
takes lr-sized steps of either sign in the two packages.

bfloat16 (fp32 masters) is held one step at a time from the same state:
the update of each parameter within BF16_TOL of its largest element
(torch's and XLA's CPU bf16 products round at other places; a bf16 value
carries 8 bits), and 40 steps must learn as JAX's own test requires.
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu.parallel import DataParallelTrainer as JTrainer, \
    data_parallel_mesh as jmesh
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import dp_state_from_jax, dp_state_to_numpy
from mxnet_tpu_torch.ops.registry import get_op
from mxnet_tpu_torch.parallel import DataParallelTrainer as TTrainer, \
    mesh_for_contexts

RTOL, ATOL = 2e-4, 1e-5
BF16_TOL = 2 ** -5
STEPS = 3
BATCH = 8


def mlp(mx):
    with mx.NameManager():
        data = mx.sym.Variable("data")
        f1 = mx.sym.FullyConnected(data, name="fc1", num_hidden=16)
        a1 = mx.sym.Activation(f1, act_type="relu")
        f2 = mx.sym.FullyConnected(a1, name="fc2", num_hidden=3)
        return mx.sym.SoftmaxOutput(f2, name="softmax")


def convbn(mx):
    """conv -> BN -> ReLU -> pool -> FC: the BN statistics need the whole
    batch (2 samples a replica at 4 replicas)."""
    with mx.NameManager():
        data = mx.sym.Variable("data")
        c = mx.sym.Convolution(data, kernel=(3, 3), num_filter=6,
                               pad=(1, 1), name="c1")
        b = mx.sym.BatchNorm(c, fix_gamma=False, name="bn1")
        r = mx.sym.Activation(b, act_type="relu")
        p = mx.sym.Pooling(r, kernel=(2, 2), stride=(2, 2), pool_type="max")
        f = mx.sym.FullyConnected(p, num_hidden=3, name="fc")
        return mx.sym.SoftmaxOutput(f, name="softmax")


NETS = {"mlp": (mlp, (BATCH, 8)), "convbn": (convbn, (BATCH, 2, 6, 6))}
OPTS = {"sgd": dict(optimizer="sgd", learning_rate=0.1, momentum=0.9,
                    wd=1e-3, clip_gradient=0.5),
        "adam": dict(optimizer="adam", learning_rate=0.01, wd=1e-3,
                     clip_gradient=0.5)}


def _batch(shape, seed=0, k=None):
    rng = np.random.RandomState(seed)
    lead = (k,) if k else ()
    x = rng.standard_normal(lead + shape).astype(np.float32)
    y = rng.randint(0, 3, lead + shape[:1]).astype(np.float32)
    return x, y


def _pair(net, n, **kw):
    build, shape = NETS[net]
    kw.setdefault("rescale_grad", 1.0 / BATCH)
    jt = JTrainer(build(jmx), jmesh(n, jax.devices()[:n]), **kw)
    tt = TTrainer(build(tmx), mesh_for_contexts(
        [tmx.cpu(i) for i in range(n)]), **kw)
    shapes = {"data": shape, "softmax_label": shape[:1]}
    return jt, tt, jt.init_state(shapes), tt.init_state(shapes), shape


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _assert_state(jstate, tstate, **tol):
    tol = tol or dict(rtol=RTOL, atol=ATOL)
    jp, js, ja = jstate
    tp, ts, ta = tstate
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(_np(b), _np(a), **tol)
    for sa, sb in zip(js, ts):
        for a, b in zip(sa, sb):
            np.testing.assert_allclose(_np(b), _np(a), **tol)
    for a, b in zip(ja, ta):
        np.testing.assert_allclose(_np(b), _np(a), **tol)


def _run(trainer, state, inputs, steps=STEPS):
    p, s, a = state
    for _ in range(steps):
        p, s, a, loss, outs = trainer.step(p, s, a, inputs)
    return (p, s, a), loss, outs


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("n", [1, 2, 4])
def test_trainer_matches_jax(n, net, opt):
    jt, tt, js, ts, shape = _pair(net, n, **OPTS[opt])
    x, y = _batch(shape)
    jstate, jloss, jouts = _run(jt, js, jt.shard_inputs([x, y]))
    tstate, tloss, touts = _run(tt, ts, tt.shard_inputs([x, y]))
    _assert_state(jstate, tstate)
    # the loss is the head's sum: SoftmaxOutput's probabilities sum to
    # the batch size (the reference's quirk, kept)
    assert abs(float(tloss) - float(jloss)) <= 1e-4 * BATCH
    np.testing.assert_allclose(_np(touts[0]), _np(jouts[0]), rtol=RTOL,
                               atol=ATOL)
    assert tt.param_names == jt.param_names
    assert tt.input_names == jt.input_names
    assert tt.aux_names == jt.aux_names


def test_per_replica_batchnorm_misses_the_bound(monkeypatch):
    """The control: BatchNorm's statistics per replica (its mesh hook
    replaced by the one-device op on each replica) is the reference
    MXNet's executor group, not the JAX package; at 2 samples a replica
    it must fail the parity bound."""
    jt, tt, js, ts, shape = _pair("convbn", 4, **OPTS["sgd"])
    x, y = _batch(shape)
    jstate, _, _ = _run(jt, js, jt.shard_inputs([x, y]))
    bn = get_op("BatchNorm")
    monkeypatch.setattr(bn, "fmesh", lambda attrs, octx, reps: [
        bn.fcompute(attrs, octx, *xs) for xs in reps])
    tstate, _, _ = _run(tt, ts, tt.shard_inputs([x, y]))
    with pytest.raises(AssertionError):
        _assert_state(jstate, tstate)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("n", [1, 2])
def test_bf16_step_matches_jax(n, net):
    """One bf16 step at a time from the same fp32 state (the JAX state
    carried into the port through ``dp_state_from_jax`` before each)."""
    kw = dict(OPTS["sgd"], dtype="bfloat16")
    jt, tt, js, _, shape = _pair(net, n, **kw)
    x, y = _batch(shape)
    ji, ti = jt.shard_inputs([x, y]), tt.shard_inputs([x, y])
    jp, jst, ja = js
    for _ in range(STEPS):
        arrays, meta = jt.export_training_state(jp, jst, ja)
        tp, tst, ta, _, _ = tt.step(*dp_state_from_jax(tt, arrays, meta),
                                    ti)
        jp, jst, ja, _, _ = jt.step(jp, jst, ja, ji)
        for name, a, b in zip(jt.param_names, jp, tp):
            before = np.asarray(arrays["param:" + name])
            dj, dt = np.asarray(a) - before, _np(b) - before
            assert np.abs(dt - dj).max() <= BF16_TOL * np.abs(dj).max() \
                + 1e-7, name
            assert b.dtype == torch.float32         # fp32 masters
        for name, a, b in zip(jt.aux_names, ja, ta):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-2,
                                       atol=1e-3)


def test_bf16_learns_as_jax_requires():
    """tests/test_parallel.py::test_dp_trainer_bf16_multiprecision on the
    port, over 4 host replicas."""
    sym = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        tmx.sym.Variable("data"), num_hidden=4, name="fc"), name="softmax")
    tr = TTrainer(sym, mesh_for_contexts([tmx.cpu(i) for i in range(4)]),
                  optimizer="sgd", learning_rate=0.1, momentum=0.9,
                  dtype="bfloat16", rescale_grad=1.0 / 16)
    rng = np.random.RandomState(0)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    w = rng.normal(size=(4, 8)).astype(np.float32)
    y = (x @ w.T).argmax(1).astype(np.float32)
    params, states, aux = tr.init_state({"data": (16, 8),
                                         "softmax_label": (16,)})
    inputs = tr.shard_inputs([x, y])
    for _ in range(40):
        params, states, aux, loss, outs = tr.step(params, states, aux,
                                                  inputs)
    assert params[0].dtype == torch.float32
    assert outs[0].dtype == torch.bfloat16
    acc = (_np(outs[0]).argmax(1) == y).mean()
    assert acc >= 0.9


@pytest.mark.parametrize("n", [1, 2])
def test_input_preproc_runs_before_the_cast(n):
    def pre(name, v):
        return v * 0.5 - 0.25 if name == "data" else v
    jt, tt, js, ts, shape = _pair("convbn", n, input_preproc=pre,
                                  **OPTS["sgd"])
    x, y = _batch(shape)
    jstate, _, _ = _run(jt, js, jt.shard_inputs([x, y]))
    tstate, _, _ = _run(tt, ts, tt.shard_inputs([x, y]))
    _assert_state(jstate, tstate)


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_set_learning_rate_mid_run(opt):
    jt, tt, js, ts, shape = _pair("mlp", 2, **OPTS[opt])
    x, y = _batch(shape)
    ji, ti = jt.shard_inputs([x, y]), tt.shard_inputs([x, y])
    jstate, _, _ = _run(jt, js, ji, 2)
    tstate, _, _ = _run(tt, ts, ti, 2)
    jt.set_learning_rate(0.02)
    tt.set_learning_rate(0.02)
    assert tt.learning_rate == jt.learning_rate == 0.02
    jstate, _, _ = _run(jt, jstate, ji, 2)
    tstate, _, _ = _run(tt, tstate, ti, 2)
    _assert_state(jstate, tstate)


def test_step_k_is_k_steps():
    """step_k over a (K, batch, ...) block equals K step calls from the
    same state: the same losses and parameters (bit for bit on the CPU),
    and t advanced by K (tests/test_multistep.py's invariant)."""
    k = 4
    _, ta, _, s0, shape = _pair("convbn", 2, **OPTS["adam"])
    _, tb, _, _, _ = _pair("convbn", 2, **OPTS["adam"])
    x, y = _batch(shape, k=k)
    state = tuple(tuple(t.clone() for t in part) if part and
                  isinstance(part[0], torch.Tensor) else
                  tuple(tuple(s.clone() for s in st) for st in part)
                  for part in s0)
    p, s, a, losses, outs = ta.step_k(*s0, ta.shard_inputs([x, y],
                                                          stacked=True))
    assert outs == () and tuple(losses.shape) == (k,)
    step_losses = []
    pb, sb, ab = state
    for i in range(k):
        pb, sb, ab, loss, _ = tb.step(pb, sb, ab,
                                      tb.shard_inputs([x[i], y[i]]))
        step_losses.append(float(loss))
    np.testing.assert_array_equal(_np(losses), np.float32(step_losses))
    for u, v in zip(p, pb):
        np.testing.assert_array_equal(_np(u), _np(v))
    assert ta.export_training_state(p, s, a)[1]["t"] == k
    assert tb.export_training_state(pb, sb, ab)[1]["t"] == k


@pytest.mark.parametrize("mode", ["none", "all"])
@pytest.mark.parametrize("n", [1, 2])
def test_step_k_matches_jax(n, mode):
    k = 3
    jt, tt, js, ts, shape = _pair("convbn", n, **OPTS["sgd"])
    x, y = _batch(shape, k=k)
    jp, jst, ja, jl, jo = jt.step_k(*js, jt.shard_inputs([x, y],
                                                         stacked=True),
                                    outputs_mode=mode)
    tp, tst, ta, tl, to = tt.step_k(*ts, tt.shard_inputs([x, y],
                                                         stacked=True),
                                    outputs_mode=mode)
    _assert_state((jp, jst, ja), (tp, tst, ta))
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5)
    assert len(to) == len(jo) == (1 if mode == "all" else 0)
    for a, b in zip(jo, to):
        assert tuple(b.shape) == tuple(a.shape) == (k, BATCH, 3)
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)


def test_state_carries_across_packages_both_ways():
    """A JAX run exported after 2 Adam steps continues in the port as in
    JAX (t carried: Adam's bias correction), and a port run exported
    after 2 steps continues in JAX as in the port."""
    jt, tt, js, ts, shape = _pair("convbn", 2, **OPTS["adam"])
    x, y = _batch(shape)
    ji, ti = jt.shard_inputs([x, y]), tt.shard_inputs([x, y])
    jstate, _, _ = _run(jt, js, ji, 2)
    arrays, meta = jt.export_training_state(*jstate)
    assert meta["t"] == 2.0
    tstate, _, _ = _run(tt, dp_state_from_jax(tt, arrays, meta), ti, 2)
    jstate, _, _ = _run(jt, jstate, ji, 2)
    _assert_state(jstate, tstate)

    jt2, tt2, _, ts2, _ = _pair("convbn", 2, **OPTS["adam"])
    tstate, _, _ = _run(tt2, ts2, ti, 2)
    arrays, meta = dp_state_to_numpy(tt2, *tstate)
    assert meta["t"] == 2.0 and meta["mesh"] == {"data": 2}
    assert sorted(arrays) == sorted(jt.export_training_state(
        *jstate)[0])
    jstate, _, _ = _run(jt2, jt2.import_training_state(arrays, meta), ji, 2)
    tstate, _, _ = _run(tt2, tstate, ti, 2)
    _assert_state(jstate, tstate)


def test_step_returns_the_trainers_state_tensors():
    """The port's donation: a step returns the trainer's own tensors,
    updated in place; other tensors handed in are copied into them."""
    _, tt, _, ts, shape = _pair("mlp", 1, **OPTS["sgd"])
    x, y = _batch(shape)
    inputs = tt.shard_inputs([x, y])
    p1, s1, a1, _, _ = tt.step(*ts, inputs)
    assert all(u is not v for u, v in zip(p1, ts[0]))
    kept = [t.clone() for t in p1]
    p2, _, _, _, _ = tt.step(p1, s1, a1, inputs)
    assert all(u is v for u, v in zip(p1, p2))
    assert any(not torch.equal(u, v) for u, v in zip(p2, kept))
    p3, _, _, _, _ = tt.step(tuple(kept), s1, a1, inputs)
    assert all(u is v for u, v in zip(p3, p2))


@pytest.mark.parametrize("kw", [
    dict(dtype="float16"), dict(zero_stage=1), dict(zero_stage=2),
    dict(param_specs={"fc1_weight": None}), dict(optimizer="rmsprop"),
    dict(optimizer="ftml"), dict(optimizer="nadam"),
    dict(dtype="float64")],
    ids=["float16", "zero1", "zero2", "param_specs", "rmsprop", "ftml",
         "unknown_opt", "float64"])
def test_unsupported_configurations_raise(kw):
    with pytest.raises(MXNetError):
        TTrainer(mlp(tmx), mesh_for_contexts([tmx.cpu(0)]), **kw)


def test_zero_stage_from_the_environment_raises(monkeypatch):
    monkeypatch.setenv("MXNET_ZERO_STAGE", "1")
    with pytest.raises(MXNetError, match="item 15"):
        TTrainer(mlp(tmx), mesh_for_contexts([tmx.cpu(0)]))
    monkeypatch.setenv("MXNET_ZERO_STAGE", "0")
    TTrainer(mlp(tmx), mesh_for_contexts([tmx.cpu(0)]))


def test_a_batch_that_does_not_divide_raises():
    _, tt, _, _, _ = _pair("mlp", 4, **OPTS["sgd"])
    with pytest.raises(MXNetError):
        tt.shard_inputs([np.zeros((6, 8), np.float32)])
    with pytest.raises(MXNetError):
        tt.shard_inputs([np.zeros((2, 6, 8), np.float32)], stacked=True)


def test_a_reduction_over_the_sharded_batch_raises():
    """A sum over the batch axis would see one shard a replica; on a mesh
    it raises instead (a loss head and BatchNorm reduce the whole
    batch)."""
    with tmx.NameManager():
        data = tmx.sym.Variable("data")
        f = tmx.sym.FullyConnected(data, num_hidden=3, name="fc")
        head = tmx.sym.SoftmaxOutput(
            tmx.sym.broadcast_sub(f, tmx.sym.mean(f, axis=0, keepdims=True)),
            name="softmax")
    tt = TTrainer(head, mesh_for_contexts([tmx.cpu(i) for i in range(2)]))
    params, states, aux = tt.init_state({"data": (4, 5),
                                         "softmax_label": (4,)})
    x, y = _batch((4, 5))
    with pytest.raises(MXNetError, match="batch axis"):
        tt.step(params, states, aux, tt.shard_inputs([x, y]))


def _mixing(mx, case):
    """A symbol whose ``case`` op mixes samples on the batch axis."""
    with mx.NameManager():
        data = mx.sym.Variable("data")
        f = mx.sym.FullyConnected(data, num_hidden=3, name="fc",
                                  flatten=False)
        bmul = mx.sym.broadcast_mul
        if case == "transpose_sum":     # the batch moved to axis 1
            f = bmul(f, mx.sym.transpose(mx.sym.sum(
                mx.sym.transpose(f, axes=(1, 0)), axis=1, keepdims=True),
                axes=(1, 0)))
        elif case == "softmax_axis0":
            f = mx.sym.softmax(f, axis=0)
        elif case == "concat_dim0":
            f = mx.sym.Concat(f, f, dim=0)
        elif case == "slice_axis0":
            f = bmul(mx.sym.slice_axis(f, axis=0, begin=0, end=1), f)
        elif case == "dot_transpose_a":     # (3, 3): a sum over samples
            f = mx.sym.dot(f, mx.sym.dot(f, f, transpose_a=True))
        elif case == "argmax_axis0":
            f = bmul(f, mx.sym.argmax(f, axis=0, keepdims=True))
        return mx.sym.SoftmaxOutput(f, name="softmax")


@pytest.mark.parametrize("case", ["transpose_sum", "softmax_axis0",
                                  "concat_dim0", "slice_axis0",
                                  "dot_transpose_a", "argmax_axis0"])
def test_an_op_that_mixes_samples_raises(case):
    """Any op that would compute across samples (or move the batch off
    axis 0) on one shard a replica raises on a mesh, not only the
    reductions; on one device the same symbol runs."""
    shapes = {"data": (4, 5), "softmax_label": (4,)}
    x, y = _batch((4, 5))
    tt = TTrainer(_mixing(tmx, case),
                  mesh_for_contexts([tmx.cpu(i) for i in range(2)]))
    state = tt.init_state(shapes)
    with pytest.raises(MXNetError, match="batch axis"):
        tt.step(*state, tt.shard_inputs([x, y]))
    if case != "concat_dim0":       # 8 outputs for 4 labels
        one = TTrainer(_mixing(tmx, case), mesh_for_contexts([tmx.cpu(0)]))
        one.step(*one.init_state(shapes), one.shard_inputs([x, y]))


def _per_sample(mx):
    """Ops that keep each sample to itself with the batch on axis 0: FC
    over the last axis, transpose keeping axis 0, reductions and softmax
    off axis 0, Reshape keeping dim 0, Concat on axis 1, expand_dims /
    squeeze off axis 0, a scalar op."""
    with mx.NameManager():
        data = mx.sym.Variable("data")
        f = mx.sym.FullyConnected(data, num_hidden=5, flatten=False,
                                  name="fc1")
        t = mx.sym.tanh(mx.sym.transpose(f, axes=(0, 2, 1)))
        s = mx.sym.log_softmax(t, axis=-1)
        r = mx.sym.Reshape(mx.sym.sum(s * t, axis=2), shape=(0, -1))
        m = mx.sym.squeeze(mx.sym.expand_dims(mx.sym.mean(t, axis=1),
                                              axis=1), axis=1)
        c = mx.sym.Concat(r, m, dim=1)
        c = c * 0.5
        out = mx.sym.FullyConnected(c, num_hidden=3, name="fc2")
        return mx.sym.SoftmaxOutput(out, name="softmax")


@pytest.mark.parametrize("n", [2, 4])
def test_per_sample_ops_run_on_a_mesh_as_jax(n):
    shape = (BATCH, 4, 6)
    x, y = _batch(shape)
    out = []
    for mx, T, mesh in ((jmx, JTrainer, jmesh(n, jax.devices()[:n])),
                        (tmx, TTrainer, mesh_for_contexts(
                            [tmx.cpu(i) for i in range(n)]))):
        tr = T(_per_sample(mx), mesh, learning_rate=0.1, momentum=0.9,
               rescale_grad=1.0 / BATCH)
        state = tr.init_state({"data": shape, "softmax_label": (BATCH,)})
        out.append(_run(tr, state, tr.shard_inputs([x, y]))[0])
    _assert_state(*out)


@pytest.mark.parametrize("norm", ["batch", "valid"])
def test_loss_head_normalises_by_the_whole_batch(norm):
    """SoftmaxOutput's ``batch`` / ``valid`` normalisation (with ignored
    labels) divides by the whole batch's count on a mesh, as the JAX
    package's one global array does."""
    def build(mx):
        with mx.NameManager():
            f = mx.sym.FullyConnected(mx.sym.Variable("data"), name="fc",
                                      num_hidden=3)
            return mx.sym.SoftmaxOutput(f, name="softmax",
                                        normalization=norm,
                                        use_ignore=True, ignore_label=2)
    x, y = _batch((BATCH, 8))
    out = []
    for mx, T, mesh in ((jmx, JTrainer, jmesh(4, jax.devices()[:4])),
                        (tmx, TTrainer, mesh_for_contexts(
                            [tmx.cpu(i) for i in range(4)]))):
        tr = T(build(mx), mesh, learning_rate=0.5)
        state = tr.init_state({"data": (BATCH, 8),
                               "softmax_label": (BATCH,)})
        out.append(_run(tr, state, tr.shard_inputs([x, y]))[0])
    _assert_state(*out)
