"""The port's 17 optimizers and its six newer update ops against the JAX
package's, on the CPU.

Each optimizer, created by name with ``mx.optimizer.create`` in both
packages (weight decay, a gradient rescale and a clip where it takes
them; the names' ``*_weight`` / ``*_bias`` decay rule), updates two
weights through its ``Updater`` for 5 steps of the same seeded
gradients: weights and states within RTOL (1e-6) of each tensor's largest
magnitude, in float32. SGLD's noise is taken out of both packages for
that (each draws from its own generator), and its noise is held to
N(0, lr) by its moments over 10^5 draws. Updater states (with the
optimizer) saved by either package load in the other, and a step after
loading matches the step the saver would take.

Then ``DataParallelTrainer`` with the six optimizers it fuses since the
update ops were ported: ``step_k(K)`` equals K ``step`` calls, and 3
steps equal the JAX trainer's (tests/test_torch_dp.py's harness and
tolerance). Last, the seven update ops those optimizers fuse, on
float64 and float32 tensors, against the JAX ops in the same type
(float64 within 1e-12: the ops cast each beta to the state's type).
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.parallel.planner import AUTO_KNOB_VARS
import mxnet_tpu_torch as tmx

from test_torch_dp import _assert_state, _batch, _np, _pair, _run

RTOL = 1e-6
STEPS = 5
NAMES = {0: "fc1_weight", 1: "fc1_bias"}
SHAPES = {0: (6, 5), 1: (6,)}

# name -> constructor kwargs (the optimizer's own hyper-parameters where
# it has them, beside the common wd / rescale / clip)
COMMON = dict(wd=0.01, rescale_grad=0.5, clip_gradient=0.8)
OPTIMIZERS = {
    "sgd": dict(COMMON, learning_rate=0.1, momentum=0.9),
    "signum": dict(COMMON, learning_rate=0.01, momentum=0.9, wd_lh=0.01),
    "signsgd": dict(COMMON, learning_rate=0.01),
    "ftml": dict(COMMON, learning_rate=0.01, beta1=0.6, beta2=0.99),
    "dcasgd": dict(COMMON, learning_rate=0.1, momentum=0.9, lamda=0.1),
    "nag": dict(COMMON, learning_rate=0.1, momentum=0.9),
    "sgld": dict(COMMON, learning_rate=0.05),
    "ccsgd": dict(COMMON, learning_rate=0.1, momentum=0.5),
    "adam": dict(COMMON, learning_rate=0.01),
    "adagrad": dict(COMMON, learning_rate=0.1, eps=1e-6),
    "rmsprop": dict(COMMON, learning_rate=0.01, gamma1=0.9,
                    clip_weights=0.6),
    "rmsprop_centered": dict(COMMON, learning_rate=0.01, gamma1=0.9,
                             gamma2=0.8, centered=True),
    "adadelta": dict(COMMON, rho=0.9, epsilon=1e-5),
    "ftrl": dict(COMMON, learning_rate=0.1, lamda1=0.01, beta=1.0),
    "adamax": dict(COMMON, learning_rate=0.01),
    "nadam": dict(COMMON, learning_rate=0.01),
    "lbsgd": dict(COMMON, learning_rate=0.1, momentum=0.9,
                  warmup_epochs=1, updates_per_epoch=4, batch_scale=4),
    "test": dict(rescale_grad=0.5),
}


def _opt_name(key):
    return key.split("_")[0]


@pytest.fixture(autouse=True)
def _no_planner_settings(monkeypatch):
    """The JAX planner's settings another test may leave in os.environ
    change what a trainer does: each one set is removed for the test."""
    for k in AUTO_KNOB_VARS + ("MXNET_PLAN",):
        if k in os.environ:
            monkeypatch.delenv(k)


@pytest.fixture
def _no_sgld_noise(monkeypatch):
    """SGLD without its noise in both packages."""
    monkeypatch.setattr(jmx.ndarray.random, "normal",
                        lambda loc=0, scale=1, shape=(1,), ctx=None,
                        dtype="float32", **kw: jmx.nd.zeros(shape,
                                                            dtype=dtype))
    monkeypatch.setattr(tmx.optimizer, "_sgld_noise",
                        lambda w, lr: torch.zeros_like(w))


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return {i: rng.uniform(-1, 1, s).astype(np.float32)
            for i, s in SHAPES.items()}


def _grads(step):
    rng = np.random.RandomState(100 + step)
    return {i: rng.standard_normal(s).astype(np.float32) * 2
            for i, s in SHAPES.items()}


def _make(pkg, key):
    opt = pkg.optimizer.create(_opt_name(key), param_idx2name=NAMES,
                               **OPTIMIZERS[key])
    return opt, pkg.optimizer.get_updater(opt)


def _leaves(x):
    """The arrays of a state (None, an NDArray or nested tuples)."""
    if x is None:
        return []
    if isinstance(x, (tuple, list)):
        return [a for s in x for a in _leaves(s)]
    return [x.asnumpy()]


def _steps(pkg, key, weights, upd, first, last):
    for step in range(first, last):
        for i, g in _grads(step).items():
            upd(i, pkg.nd.array(g, ctx=pkg.cpu()), weights[i])


def _start(pkg, key):
    opt, upd = _make(pkg, key)
    weights = {i: pkg.nd.array(w, ctx=pkg.cpu())
               for i, w in _weights().items()}
    return opt, upd, weights


def _close(got, want, what):
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * max(scale, 1e-30), err_msg=what)


def _assert_same(jw, tw, jupd, tupd, key):
    for i in SHAPES:
        _close(tw[i].asnumpy(), jw[i].asnumpy(), "%s weight %d" % (key, i))
        ja, ta = _leaves(jupd.states.get(i)), _leaves(tupd.states.get(i))
        assert len(ja) == len(ta), (key, i)
        for k, (a, b) in enumerate(zip(ja, ta)):
            _close(b, a, "%s state %d.%d" % (key, i, k))


@pytest.mark.parametrize("key", sorted(OPTIMIZERS))
def test_optimizer_against_jax(key, _no_sgld_noise):
    with tmx.cpu():
        _, jupd, jw = _start(jmx, key)
        _, tupd, tw = _start(tmx, key)
        _steps(jmx, key, jw, jupd, 0, STEPS)
        _steps(tmx, key, tw, tupd, 0, STEPS)
    _assert_same(jw, tw, jupd, tupd, key)
    moved = [np.abs(tw[i].asnumpy() - w).max() for i, w in _weights().items()]
    assert max(moved) > 0, key


def test_every_jax_optimizer_name_is_registered():
    assert set(tmx.optimizer.Optimizer.opt_registry) \
        == set(jmx.optimizer.Optimizer.opt_registry)
    assert len(tmx.optimizer.Optimizer.opt_registry) == 17
    assert {_opt_name(k) for k in OPTIMIZERS} \
        == set(tmx.optimizer.Optimizer.opt_registry)


def test_sgld_noise_is_normal_with_variance_lr():
    """A zero gradient and no decay: SGLD moves each weight by its noise
    alone, N(0, lr), drawn from the port's seeded generator (moments
    within 5 standard errors over 10^5 draws; the same seed draws the
    same noise)."""
    lr, n = 0.04, 100_000
    moves = []
    for _ in range(2):
        tmx.random.seed(11)
        opt = tmx.optimizer.create("sgld", learning_rate=lr)
        w = tmx.nd.zeros((n,), ctx=tmx.cpu())
        opt.update(0, w, tmx.nd.zeros((n,), ctx=tmx.cpu()), None)
        moves.append(w.asnumpy().astype(np.float64))
    np.testing.assert_array_equal(moves[0], moves[1])
    x = moves[0]
    assert abs(x.mean()) < 5 * np.sqrt(lr / n)
    # the variance of a sample variance of n normals: 2 sigma^4 / (n - 1)
    assert abs(x.var() - lr) < 5 * lr * np.sqrt(2.0 / (n - 1))


def test_adagrad_refuses_a_row_sparse_gradient():
    """Sparse storage is ported: AdaGrad takes a row_sparse gradient as
    the JAX class does, densely (rows without gradient still decay),
    and matches it within RTOL."""
    from mxnet_tpu.ndarray import sparse as jsp
    from mxnet_tpu_torch.ndarray import sparse as tsp
    rng = np.random.RandomState(5)
    w0 = rng.normal(size=(6, 3)).astype(np.float32)
    data = rng.normal(size=(2, 3)).astype(np.float32)
    rows = np.array([1, 4])
    out = []
    for mx, sp, ctx in ((jmx, jsp, None), (tmx, tsp, tmx.cpu())):
        opt = mx.optimizer.create("adagrad", learning_rate=0.1, wd=0.01,
                                  rescale_grad=0.5)
        kw = {} if ctx is None else {"ctx": ctx}
        w = mx.nd.array(w0, **kw)
        g = sp.row_sparse_array((data, rows), shape=(6, 3), **kw)
        state = opt.create_state(0, w)
        for _ in range(2):
            opt.update(0, w, g, state)
        out.append((w.asnumpy(), state.asnumpy()))
    for got, want in zip(out[1], out[0]):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL * np.abs(want).max())
    assert not np.array_equal(out[1][0][0], w0[0])    # decayed, no grad


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("key", sorted(OPTIMIZERS))
def test_states_cross_between_the_packages(key, direction, _no_sgld_noise):
    """2 steps in the saving package; its Updater's states and optimizer
    loaded by the other package's Updater, whose next step equals the
    saver's own next step."""
    src, dst = (tmx, jmx) if direction == "port_to_jax" else (jmx, tmx)
    with tmx.cpu():
        _, supd, sw = _start(src, key)
        _steps(src, key, sw, supd, 0, 2)
        blob = supd.get_states(dump_optimizer=True)
        _, dupd, _ = _start(dst, key)
        dupd.set_states(blob)
        dw = {i: dst.nd.array(w.asnumpy(), ctx=dst.cpu())
              for i, w in sw.items()}
        assert type(dupd.optimizer).__name__ == type(supd.optimizer).__name__
        _steps(src, key, sw, supd, 2, 3)
        _steps(dst, key, dw, dupd, 2, 3)
    jw, tw = (dw, sw) if direction == "port_to_jax" else (sw, dw)
    jupd, tupd = (dupd, supd) if direction == "port_to_jax" \
        else (supd, dupd)
    _assert_same(jw, tw, jupd, tupd, key)


# ---------------------------------------------------------------------------
# DataParallelTrainer with the six newer fused optimizers
# ---------------------------------------------------------------------------

FUSED = {
    "rmsprop": dict(optimizer="rmsprop", learning_rate=0.01, gamma1=0.9,
                    wd=1e-3, clip_gradient=0.5),
    "rmspropalex": dict(optimizer="rmspropalex", learning_rate=0.01,
                        gamma1=0.9, gamma2=0.8, wd=1e-3),
    # a small l1: FTRL zeroes the weights whose |z| is under it, and a z
    # at that boundary to rounding level decides whether a hidden unit's
    # bias is 0 or 1e-12, which flips its ReLU's gradient
    "ftrl": dict(optimizer="ftrl", learning_rate=0.1, lamda1=1e-6,
                 wd=1e-3),
    "signsgd": dict(optimizer="signsgd", learning_rate=0.01, wd=1e-3),
    "signum": dict(optimizer="signum", learning_rate=0.01, momentum=0.9,
                   wd=1e-3, wd_lh=1e-3),
    "ftml": dict(optimizer="ftml", learning_rate=0.01, beta1=0.6,
                 beta2=0.99, wd=1e-3),
}


def _clone_state(s0):
    p, s, a = s0
    return (tuple(t.clone() for t in p),
            tuple(tuple(x.clone() for x in st) for st in s),
            tuple(t.clone() for t in a))


@pytest.mark.parametrize("opt", sorted(FUSED))
def test_fused_step_k_is_k_steps(opt):
    """step_k over a (K, batch, ...) block equals K step calls from the
    same state: losses and parameters bit for bit on the CPU, t advanced
    by K."""
    k = 4
    _, ta, _, s0, shape = _pair("convbn", 2, **FUSED[opt])
    _, tb, _, _, _ = _pair("convbn", 2, **FUSED[opt])
    x, y = _batch(shape, k=k)
    pb, sb, ab = _clone_state(s0)
    p, s, a, losses, _ = ta.step_k(*s0, ta.shard_inputs([x, y],
                                                        stacked=True))
    step_losses = []
    for i in range(k):
        pb, sb, ab, loss, _ = tb.step(pb, sb, ab,
                                      tb.shard_inputs([x[i], y[i]]))
        step_losses.append(float(loss))
    np.testing.assert_array_equal(_np(losses), np.float32(step_losses))
    for u, v in zip(p, pb):
        np.testing.assert_array_equal(_np(u), _np(v))
    for su, sv in zip(s, sb):
        for u, v in zip(su, sv):
            np.testing.assert_array_equal(_np(u), _np(v))
    assert ta.export_training_state(p, s, a)[1]["t"] == k


@pytest.mark.parametrize("opt", sorted(FUSED))
def test_fused_optimizer_matches_jax(opt):
    jt, tt, js, ts, shape = _pair("mlp", 2, **FUSED[opt])
    x, y = _batch(shape)
    jstate, _, _ = _run(jt, js, jt.shard_inputs([x, y]))
    tstate, _, _ = _run(tt, ts, tt.shard_inputs([x, y]))
    _assert_state(jstate, tstate)
    assert any(float(np.abs(_np(a) - _np(b)).max()) > 0
               for a, b in zip(tstate[0], ts[0]))


# -- the update ops in the state's own type ----------------------------------

UPDATE_OPS = {
    "adam_update": (dict(lr=0.01, beta1=0.9, beta2=0.999, epsilon=1e-8,
                         wd=0.01, rescale_grad=0.5), 2),
    "rmsprop_update": (dict(lr=0.01, gamma1=0.95, wd=0.01), 1),
    "rmspropalex_update": (dict(lr=0.01, gamma1=0.95, gamma2=0.9), 3),
    "ftrl_update": (dict(lr=0.1, lamda1=0.01, beta=1.0), 2),
    "signsgd_update": (dict(lr=0.01, wd=0.01), 0),
    "signum_update": (dict(lr=0.01, momentum=0.9, wd=0.01, wd_lh=0.01), 1),
    "ftml_update": (dict(lr=0.01, beta1=0.6, beta2=0.999, t=3), 3),
}
# float64 against float64: the reference casts each beta / gamma to the
# state's type, so 1 - beta is exact in float64 (in float32 it is
# float32(1 - float32(beta)), 1.3e-5 relative off 1 - 0.999); a float32
# 1 - beta in a float64 update lies ~1e-5 off
UPDATE_RTOL = {"float64": 1e-12, "float32": 1e-6}


@pytest.mark.parametrize("dtype", sorted(UPDATE_RTOL))
@pytest.mark.parametrize("name", sorted(UPDATE_OPS))
def test_update_op_against_jax_in_the_states_type(name, dtype):
    """Each update op of the fused optimizers on float64 and float32
    weights, gradients and states against the JAX op (under
    ``jax.enable_x64`` for float64): every output within UPDATE_RTOL of
    its largest magnitude."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as treg
    attrs, n_states = UPDATE_OPS[name]
    rng = np.random.RandomState(sorted(UPDATE_OPS).index(name))
    ins = [rng.standard_normal((6, 5)).astype(dtype) for _ in range(2)]
    ins += [np.abs(rng.standard_normal((6, 5))).astype(dtype) * 0.1
            for _ in range(n_states)]
    if name == "ftml_update":
        ins[2] = ins[2] + np.asarray(1.0, dtype)         # d > 0
    js = jreg.get_op(name)
    ts = treg.get_op(name)
    with jax.enable_x64(True):
        want = [np.asarray(o) for o in js.fcompute(
            js.parse_attrs(attrs), jreg.OpCtx(is_train=True),
            *[jnp.asarray(x) for x in ins])]
    got = [o.numpy() for o in ts.fcompute(
        ts.parse_attrs(attrs), treg.OpCtx(device=torch.device("cpu")),
        *[torch.tensor(x) for x in ins])]
    assert len(got) == len(want) == 1 + n_states
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype == np.dtype(dtype), (name, k, a.dtype,
                                                       b.dtype)
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=UPDATE_RTOL[dtype] * scale,
                                   err_msg="%s output %d" % (name, k))
