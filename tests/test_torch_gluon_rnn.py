"""The port's gluon.rnn against the JAX package's, on the CPU: the fused
RNN, LSTM and GRU layers (TNC and NTC, one and two layers, one and two
directions, with and without given states) and the recurrent cells
unrolled (RNN, LSTM, GRU, Sequential, Bidirectional,
Residual, Dropout, Zoneout, ``valid_length``), eager and hybridized.

Each case builds the block in both packages with the same prefix,
initializes the JAX one, runs it once to finish deferred shapes, and
carries its parameters into the port by ``collect_params`` name
(``convert.load_gluon_params``). The same seeded input and output
cotangents go through both inside ``autograd.record()``: the outputs
(and returned states), the input's gradient and every parameter's
gradient are compared within rtol 1e-5 / atol 1e-6 (float32 sums over
time in another order). Parameter files cross between the packages.
"""
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu, gluon as tgluon
from mxnet_tpu_torch.convert import load_gluon_params

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = cpu()


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _keep_global_rng():
    """The tests draw from np.random and random (BucketSentenceIter
    shuffles by them) and seed both packages' global generators: other
    tests in this process must find them all as they were."""
    np_state, py_state = np.random.get_state(), random.getstate()
    j_state, t_state = jmx.random.get_state(), tmx.random.get_state()
    yield
    np.random.set_state(np_state)
    random.setstate(py_state)
    jmx.random.set_state(j_state)
    tmx.random.set_state(t_state)


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out]


def _pair(make, x, run):
    jb, tb = make(jgluon), make(tgluon)
    jmx.random.seed(7)
    jb.initialize(jmx.init.Xavier())
    run(jmx, jb, jmx.nd.array(x), {})          # finish deferred shapes
    vals = {n: p.data().asnumpy() for n, p in jb.collect_params().items()}
    load_gluon_params(tb, vals, ctx=CPU)
    return jb, tb


def _record(mx, block, x, run, cts, states, ctx=None, train=True):
    """(outputs, x grad, {param: grad}) of one recorded call of ``run``
    and backward of sum(outputs x cotangents)."""
    kw = {} if ctx is None else {"ctx": ctx}
    xa = mx.nd.array(x, **kw)
    xa.attach_grad()
    st = {k: mx.nd.array(v, **kw) for k, v in states.items()}
    with mx.autograd.record(train_mode=train):
        outs = _flat(run(mx, block, xa, st))
        loss = None
        for o, c in zip(outs, cts):
            term = (o * mx.nd.array(c, **kw)).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    grads = {n: p.grad().asnumpy() for n, p in
             block.collect_params().items() if p.grad_req != "null"}
    return [o.asnumpy() for o in outs], xa.grad.asnumpy(), grads


def _check(make, x, run, states=None, hybrid=False, train=True):
    states = states or {}
    jb, tb = _pair(make, x, run)
    outs = _flat(run(jmx, jb, jmx.nd.array(x),
                     {k: jmx.nd.array(v) for k, v in states.items()}))
    rng = np.random.RandomState(1)
    cts = [rng.standard_normal(o.shape).astype(np.float32) for o in outs]
    want = _record(jmx, jb, x, run, cts, states, train=train)
    if hybrid:
        tb.hybridize()
    got = _record(tmx, tb, x, run, cts, states, ctx=CPU, train=train)
    assert len(got[0]) == len(want[0])
    for i, (a, b) in enumerate(zip(got[0], want[0])):
        np.testing.assert_allclose(a, b, err_msg=f"out{i}", **TOL)
    np.testing.assert_allclose(got[1], want[1], err_msg="dx", **TOL)
    assert sorted(got[2]) == sorted(want[2])
    for n in want[2]:
        np.testing.assert_allclose(got[2][n], want[2][n],
                                   err_msg=f"grad {n}", **TOL)
    return tb


# ---------------------------------------------------------------------------
# fused layers
# ---------------------------------------------------------------------------

LAYERS = [
    ("lstm", lambda g, **k: g.rnn.LSTM(6, prefix="l_", **k)),
    ("gru", lambda g, **k: g.rnn.GRU(6, prefix="l_", **k)),
    ("rnn_tanh", lambda g, **k: g.rnn.RNN(6, activation="tanh",
                                          prefix="l_", **k)),
    ("rnn_relu", lambda g, **k: g.rnn.RNN(6, activation="relu",
                                          prefix="l_", **k)),
]
SHAPES = [
    ("tnc_1", dict(layout="TNC", num_layers=1), (5, 3, 4)),
    ("ntc_2_bi", dict(layout="NTC", num_layers=2, bidirectional=True),
     (3, 5, 4)),
    ("tnc_2", dict(layout="TNC", num_layers=2), (4, 2, 3)),
]


def _call(mx, block, x, states):
    if states:
        return block(x, [states[k] for k in sorted(states)])
    return block(x)


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("shape_id,kw,shape", SHAPES,
                         ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("mode,make", LAYERS, ids=[m[0] for m in LAYERS])
def test_layer_matches_jax(mode, make, shape_id, kw, shape, hybrid):
    kw = dict(kw, input_size=shape[-1])
    x = np.random.RandomState(len(shape_id)).uniform(
        -1, 1, shape).astype(np.float32)
    tb = _check(lambda g: make(g, **kw), x, _call, hybrid=hybrid)
    if hybrid:
        assert tb._cached_graph


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("mode,make", LAYERS, ids=[m[0] for m in LAYERS])
def test_layer_with_states_matches_jax(mode, make, hybrid):
    """Given begin states: (outputs, new states), and the states'
    shapes from ``begin_state``."""
    T, N, C, L = 4, 3, 5, 2
    kw = dict(layout="NTC", num_layers=L, bidirectional=True, input_size=C)
    n_states = 2 if mode == "lstm" else 1
    rng = np.random.RandomState(2)
    states = {f"s{i}": rng.uniform(-0.5, 0.5, (2 * L, N, 6))
              .astype(np.float32) for i in range(n_states)}
    x = rng.uniform(-1, 1, (N, T, C)).astype(np.float32)
    _check(lambda g: make(g, **kw), x, _call, states=states, hybrid=hybrid)
    layer = make(tgluon, **kw)
    got = layer.begin_state(batch_size=N, ctx=CPU)
    want = make(jgluon, **kw).begin_state(batch_size=N)
    assert [s.shape for s in got] == [s.shape for s in want]


def test_layer_packs_the_per_gate_parameters():
    """The layer's l{i}_/r{i}_ parameters, packed into the op's flat
    vector (every W and R first, then every bias), give the RNN op's
    output on that vector."""
    layer = tgluon.rnn.LSTM(4, num_layers=2, bidirectional=True,
                            input_size=3, prefix="p_")
    layer.initialize(tmx.init.Uniform(0.5), ctx=CPU)
    x = tmx.nd.array(np.random.RandomState(0).uniform(-1, 1, (5, 2, 3)),
                     ctx=CPU)
    out = layer(x).asnumpy()
    p = layer.collect_params()
    flat = [p[f"p_{d}{i}_{k}_weight"].data().asnumpy().ravel()
            for i in range(2) for d in "lr" for k in ("i2h", "h2h")]
    flat += [p[f"p_{d}{i}_{k}_bias"].data().asnumpy()
             for i in range(2) for d in "lr" for k in ("i2h", "h2h")]
    z = tmx.nd.zeros((4, 2, 4), ctx=CPU)
    want = tmx.nd.RNN(x, tmx.nd.array(np.concatenate(flat), ctx=CPU), z, z,
                      state_size=4, num_layers=2, bidirectional=True,
                      mode="lstm")[0].asnumpy()
    np.testing.assert_array_equal(out, want)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _stack(g):
    s = g.rnn.SequentialRNNCell(prefix="s_")
    with s.name_scope():
        s.add(g.rnn.LSTMCell(5, input_size=4))
        s.add(g.rnn.DropoutCell(0.0))
        s.add(g.rnn.ResidualCell(g.rnn.GRUCell(5, input_size=5)))
    return s


CELLS = [
    ("rnn", lambda g: g.rnn.RNNCell(5, activation="relu", input_size=4,
                                    prefix="c_")),
    ("lstm", lambda g: g.rnn.LSTMCell(5, input_size=4, prefix="c_")),
    ("gru", lambda g: g.rnn.GRUCell(5, input_size=4, prefix="c_")),
    ("sequential", _stack),
    ("bidirectional", lambda g: g.rnn.BidirectionalCell(
        g.rnn.LSTMCell(3, input_size=4, prefix="bl_"),
        g.rnn.GRUCell(3, input_size=4, prefix="br_"))),
    ("residual", lambda g: g.rnn.ResidualCell(
        g.rnn.GRUCell(4, input_size=4, prefix="c_"))),
]


def _unroll(merge, layout="NTC", valid=None):
    def run(mx, cell, x, states):
        t = x.shape[layout.find("T")]
        kw = {}
        if valid is not None:
            kw["valid_length"] = mx.nd.array(valid, ctx=x.context)
        outs, st = cell.unroll(t, x, layout=layout, merge_outputs=merge,
                               **kw)
        return [outs, st]
    return run


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("merge", [True, False], ids=["merged", "steps"])
@pytest.mark.parametrize("kind,make", CELLS, ids=[c[0] for c in CELLS])
def test_cell_unroll_matches_jax(kind, make, merge, hybrid):
    x = np.random.RandomState(3).uniform(-1, 1, (3, 4, 4)) \
        .astype(np.float32)
    _check(make, x, _unroll(merge), hybrid=hybrid)


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
def test_cell_unroll_valid_length(hybrid):
    """``valid_length`` (stack, SequenceLast, SequenceMask) in the TNC
    layout: the JAX package's sequence ops read time on axis 0 whatever
    their ``axis`` (the port's do the same), so NTC does not take it."""
    x = np.random.RandomState(4).uniform(-1, 1, (3, 4, 4)) \
        .astype(np.float32)
    valid = np.array([3, 1, 2, 3], np.float32)
    _check(CELLS[1][1], x, _unroll(True, "TNC", valid), hybrid=hybrid)


def test_zoneout_and_dropout_cells_in_prediction():
    """Zoneout and Dropout cells outside training: the masks are ones
    (training masks are the Dropout op's draws, which differ by
    package)."""
    x = np.random.RandomState(5).uniform(-1, 1, (2, 3, 4)) \
        .astype(np.float32)
    for make in (lambda g: g.rnn.ZoneoutCell(
            g.rnn.LSTMCell(5, input_size=4, prefix="z_"), 0.3, 0.2),
            lambda g: g.rnn.DropoutCell(0.4, prefix="d_")):
        _check(make, x, _unroll(False), train=False)


def test_dropout_cell_law_in_training():
    """DropoutCell in training: each element kept with 1 - p, scaled by
    1 / (1 - p); one generator seed, one mask."""
    cell = tgluon.rnn.DropoutCell(0.3, prefix="d_")
    x = tmx.nd.ones((400, 50), ctx=CPU)
    outs = []
    for _ in range(2):
        tmx.random.seed(11)
        with tmx.autograd.record():
            outs.append(cell(x, [])[0].asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    vals = np.unique(outs[0])
    np.testing.assert_allclose(vals, [0.0, 1.0 / 0.7], rtol=1e-6)
    assert abs((outs[0] > 0).mean() - 0.7) < 0.01


# ---------------------------------------------------------------------------
# parameter files
# ---------------------------------------------------------------------------

def test_layer_parameter_files_cross(tmp_path):
    x = np.random.RandomState(6).uniform(-1, 1, (4, 2, 3)) \
        .astype(np.float32)
    kw = dict(num_layers=2, bidirectional=True, input_size=3, prefix="f_")
    jl = jgluon.rnn.LSTM(5, **kw)
    jl.initialize(jmx.init.Xavier())
    want = jl(jmx.nd.array(x)).asnumpy()
    jl.save_parameters(str(tmp_path / "jax.params"))
    tl = tgluon.rnn.LSTM(5, **kw)
    tl.load_parameters(str(tmp_path / "jax.params"), ctx=CPU)
    np.testing.assert_allclose(tl(tmx.nd.array(x, ctx=CPU)).asnumpy(),
                               want, **TOL)
    for p in tl.collect_params().values():
        p.set_data(p.data() * 0.5)
    tl.save_parameters(str(tmp_path / "port.params"))
    back = jgluon.rnn.LSTM(5, **kw)
    back.load_parameters(str(tmp_path / "port.params"))
    np.testing.assert_allclose(back(jmx.nd.array(x)).asnumpy(),
                               tl(tmx.nd.array(x, ctx=CPU)).asnumpy(),
                               **TOL)
