"""The port's RNN op, sequence ops, initializers, ``mx.rnn`` cells and
``BucketSentenceIter`` against the JAX package's, on the CPU; and the
bench lane's trainer (``step_k(unroll=2)``).

The same seeded numpy inputs go to both packages. Tolerances:
  - the ``RNN`` op (4 modes, one and two directions, 2 layers): outputs
    and the gradients of random cotangents for data, parameters and both
    states within RTOL of each tensor's largest magnitude in float32
    (sums over time in another order), F64_RTOL in float64 (the JAX side
    under ``jax.enable_x64``);
  - ``mx.rnn`` cells unrolled into Symbols, bound on the CPU with the
    same parameters: outputs and gradients within RTOL;
  - the sequence ops, ``SliceChannel``, ``stack``, ``BucketSentenceIter``
    batches, ``pack_weights`` / ``unpack_weights``: exact;
  - the initializers by the JAX package's law: ``Bilinear``,
    ``LSTMBias`` and ``FusedRNN`` over a deterministic initializer
    exactly, ``Orthogonal`` by its properties (the draws differ: each
    package has its own generators).
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops.rnn_ops import rnn_param_size

RTOL = 1e-5
F64_RTOL = 1e-12
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")


@pytest.fixture(autouse=True)
def _two_threads():
    """Torch at 2 intra-op threads: several test processes share the
    host's cores."""
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


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1e-30, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


# ---------------------------------------------------------------------------
# the RNN op
# ---------------------------------------------------------------------------

def _rnn_case(mode, bidirectional, T=5, N=3, I=4, H=6, L=2, seed=0):
    rng = np.random.RandomState(seed)
    dirs = 2 if bidirectional else 1
    st = (L * dirs, N, H)
    ins = [rng.uniform(-1, 1, (T, N, I)),
           rng.uniform(-0.4, 0.4, rnn_param_size(L, I, H, bidirectional,
                                                 mode)),
           rng.uniform(-0.5, 0.5, st)]
    if mode == "lstm":
        ins.append(rng.uniform(-0.5, 0.5, st))
    n_out = 3 if mode == "lstm" else 2
    shapes = [(T, N, H * dirs)] + [st] * (n_out - 1)
    cts = [rng.standard_normal(s) for s in shapes]
    attrs = dict(state_size=H, num_layers=L, bidirectional=bidirectional,
                 mode=mode, state_outputs=True)
    return attrs, ins, cts


def _rnn_jax(attrs, ins, cts, dtype):
    js = jreg.get_op("RNN")
    ja = js.parse_attrs(attrs)

    def f(*xs):
        return js.fcompute(ja, jreg.OpCtx(is_train=True), *xs)
    outs, vjp = jax.vjp(f, *[jnp.asarray(x, dtype) for x in ins])
    grads = vjp(tuple(jnp.asarray(c, dtype) for c in cts))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _rnn_port(attrs, ins, cts, dtype):
    ts = treg.get_op("RNN")
    ta = ts.parse_attrs(attrs)
    tx = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in ins]
    outs = ts.fcompute(ta, treg.OpCtx(is_train=True, device="cpu"), *tx)
    grads = torch.autograd.grad(outs, tx, [torch.tensor(c, dtype=dtype)
                                           for c in cts])
    return ([o.detach().numpy() for o in outs],
            [g.numpy() for g in grads])


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_float32(mode, bidirectional):
    attrs, ins, cts = _rnn_case(mode, bidirectional)
    jo, jg = _rnn_jax(attrs, ins, cts, jnp.float32)
    to, tg = _rnn_port(attrs, ins, cts, torch.float32)
    assert len(to) == len(jo) == (3 if mode == "lstm" else 2)
    for i, (a, b) in enumerate(zip(to, jo)):
        _close(a, b, RTOL, f"out{i}")
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, b, RTOL, f"grad{i}")


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_float64(mode, bidirectional):
    attrs, ins, cts = _rnn_case(mode, bidirectional, seed=1)
    with jax.enable_x64(True):
        jo, jg = _rnn_jax(attrs, ins, cts, jnp.float64)
    to, tg = _rnn_port(attrs, ins, cts, torch.float64)
    for i, (a, b) in enumerate(zip(to + tg, jo + jg)):
        assert np.asarray(b).dtype == np.float64
        _close(a, b, F64_RTOL, f"tensor{i}")


def test_rnn_op_computes_in_its_inputs_dtype():
    attrs, ins, _ = _rnn_case("lstm", False)
    ts = treg.get_op("RNN")
    outs = ts.fcompute(ts.parse_attrs(attrs), treg.OpCtx(),
                       *[torch.tensor(x, dtype=torch.bfloat16) for x in ins])
    assert all(o.dtype == torch.bfloat16 for o in outs)
    want = ts.fcompute(ts.parse_attrs(attrs), treg.OpCtx(),
                       *[torch.tensor(x) for x in ins])
    _close(outs[0].double().numpy(), want[0].numpy(), 5e-2, "bf16 output")


def test_rnn_op_schema_and_shapes():
    ts, js = treg.get_op("RNN"), jreg.get_op("RNN")
    for mode in MODES:
        a = dict(state_size=6, num_layers=2, mode=mode)
        assert ts.list_inputs(ts.parse_attrs(a)) == \
            js.list_inputs(js.parse_attrs(a))
        assert ts.num_inputs(ts.parse_attrs(a)) == \
            js.num_inputs(js.parse_attrs(a))
        assert ts.n_outputs(ts.parse_attrs(a)) == \
            js.num_outputs(js.parse_attrs(a))
    shapes = {}
    for name, mx in (("port", tmx), ("jax", jmx)):
        with mx.NameManager():
            out = mx.sym.RNN(mx.sym.Variable("data"), state_size=6,
                             num_layers=2, bidirectional=True, mode="gru",
                             name="rnn")
        shapes[name] = out.infer_shape(data=(5, 3, 4))
    assert shapes["port"] == shapes["jax"]
    with pytest.raises(tmx.MXNetError):
        with tmx.cpu():
            tmx.nd.RNN(tmx.nd.zeros((2, 1, 3)), tmx.nd.zeros((7,)),
                       tmx.nd.zeros((1, 1, 4)), state_size=4, num_layers=1,
                       mode="rnn_tanh")


def test_rnn_op_dropout_law():
    """p > 0 between layers, training: the op's output is layer 1 of the
    layer-0 output masked by a Bernoulli(1 - p) draw of the op's
    generator and scaled by 1 / (1 - p); the same seed gives the same
    mask, another seed another; the last layer's output is not dropped
    (a 1-layer op ignores p)."""
    T, N, I, H, p = 4, 64, 3, 16, 0.4
    rng = np.random.RandomState(3)
    size0 = rnn_param_size(1, I, H, False, "rnn_tanh")
    size1 = rnn_param_size(1, H, H, False, "rnn_tanh")
    w0 = rng.uniform(-0.5, 0.5, size0 - 2 * H)
    w1 = rng.uniform(-0.5, 0.5, size1 - 2 * H)
    b0, b1 = rng.uniform(-0.1, 0.1, 2 * H), rng.uniform(-0.1, 0.1, 2 * H)
    x = torch.tensor(rng.uniform(-1, 1, (T, N, I)))
    s = torch.tensor(rng.uniform(-0.5, 0.5, (2, N, H)))
    ts = treg.get_op("RNN")

    def run(layers, params, state, pp, seed, x_=x):
        a = ts.parse_attrs(dict(state_size=H, num_layers=layers,
                                mode="rnn_tanh", p=pp))
        g = torch.Generator().manual_seed(seed)
        return ts.fcompute(a, treg.OpCtx(is_train=True, rng=g),
                           x_, torch.tensor(params), state)[0]
    two = np.concatenate([w0, w1, b0, b1])
    y = run(2, two, s, p, 7)
    torch.testing.assert_close(run(2, two, s, p, 7), y, rtol=0, atol=0)
    assert not torch.equal(run(2, two, s, p, 8), y)
    y0 = run(1, np.concatenate([w0, b0]), s[:1], 0.0, 0)
    keep = torch.empty(y0.shape, dtype=torch.float32).bernoulli_(
        1 - p, generator=torch.Generator().manual_seed(7))
    frac = float(keep.mean())
    assert abs(frac - (1 - p)) < 0.03, frac
    x1 = torch.where(keep > 0, y0 / (1 - p), torch.zeros((), dtype=y0.dtype))
    want = run(1, np.concatenate([w1, b1]), s[1:], 0.0, 0, x_=x1)
    torch.testing.assert_close(y, want, rtol=1e-12, atol=1e-12)
    one = np.concatenate([w0, b0])
    torch.testing.assert_close(run(1, one, s[:1], p, 7),
                               run(1, one, s[:1], 0.0, 7))


def test_state_zeros_ops():
    for name, attrs, shape, want in (
            ("_rnn_state_zeros", dict(num=4, dim=5), (7, 3, 2), (4, 3, 5)),
            ("_cell_state_zeros", dict(dim=5), (3, 2), (3, 5))):
        for reg in (treg, jreg):
            s = reg.get_op(name)
            _, outs = s.infer_shape(s.parse_attrs(attrs), [shape])
            assert tuple(outs[0]) == want
        t = treg.get_op(name)
        out = t.fcompute(t.parse_attrs(attrs), treg.OpCtx(),
                         torch.ones(shape, dtype=torch.float64))[0]
        assert out.shape == want and out.dtype == torch.float64
        assert not out.any()


# ---------------------------------------------------------------------------
# sequence ops, SliceChannel, stack
# ---------------------------------------------------------------------------

def _nd_both(name, arrays, **attrs):
    with tmx.cpu():
        t = getattr(tmx.nd, name)(*[tmx.nd.array(a) for a in arrays],
                                  **attrs)
    j = getattr(jmx.nd, name)(*[jmx.nd.array(a) for a in arrays], **attrs)
    t = t if isinstance(t, (list, tuple)) else [t]
    j = j if isinstance(j, (list, tuple)) else [j]
    return [a.asnumpy() for a in t], [a.asnumpy() for a in j]


SEQ_CASES = [
    ("SequenceMask", {}), ("SequenceMask", dict(use_sequence_length=True)),
    ("SequenceMask", dict(use_sequence_length=True, value=-2.5)),
    ("SequenceLast", {}), ("SequenceLast", dict(use_sequence_length=True)),
    ("SequenceReverse", {}),
    ("SequenceReverse", dict(use_sequence_length=True)),
]


@pytest.mark.parametrize("case", range(len(SEQ_CASES)))
def test_sequence_ops(case):
    name, attrs = SEQ_CASES[case]
    rng = np.random.RandomState(case)
    x = rng.standard_normal((5, 4, 3)).astype(np.float32)
    lens = np.array([5, 1, 3, 4], np.float32)
    arrays = [x, lens] if attrs.get("use_sequence_length") else [x]
    got, want = _nd_both(name, arrays, **attrs)
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("axis,squeeze", [(1, False), (-1, False),
                                          (0, True), (2, True)])
def test_slice_channel(axis, squeeze):
    x = np.arange(4 * 6 * 6, dtype=np.float32).reshape(4, 6, 6)
    n = 2 if axis == 0 else 3
    if squeeze:
        n = x.shape[axis]
    got, want = _nd_both("SliceChannel", [x], num_outputs=n, axis=axis,
                         squeeze_axis=squeeze)
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    got2, _ = _nd_both("split", [x], num_outputs=n, axis=axis,
                       squeeze_axis=squeeze)
    for a, b in zip(got2, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_stack(axis):
    rng = np.random.RandomState(0)
    xs = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(3)]
    got, want = _nd_both("stack", xs, axis=axis)
    np.testing.assert_array_equal(got[0], want[0])


def test_new_ops_registered():
    ops = set(treg.list_ops())
    for name in ("RNN", "_rnn_state_zeros", "_cell_state_zeros",
                 "SliceChannel", "stack", "SequenceMask", "SequenceLast",
                 "SequenceReverse"):
        assert name in ops
    assert treg.get_op("split") is treg.get_op("SliceChannel")


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _init_both(init_t, init_j, name, shape):
    t = tmx.nd.zeros(shape, ctx=tmx.cpu())
    init_t(tmx.init.InitDesc(name), t)
    j = jmx.nd.zeros(shape)
    init_j(jmx.init.InitDesc(name), j)
    return t.asnumpy(), j.asnumpy()


def test_bilinear_lstmbias_exact():
    got, want = _init_both(tmx.init.Bilinear(), jmx.init.Bilinear(),
                           "up_weight", (2, 3, 4, 4))
    np.testing.assert_array_equal(got, want)
    got, want = _init_both(tmx.init.LSTMBias(forget_bias=2.5),
                           jmx.init.LSTMBias(forget_bias=2.5),
                           "lstm_i2h_weight", (16,))
    np.testing.assert_array_equal(got, want)
    assert tmx.init.create("lstmbias").forget_bias == 1.0


def test_fused_rnn_initializer():
    shape = (rnn_param_size(2, 4, 6, False, "lstm"),)
    got, want = _init_both(
        tmx.init.FusedRNN(tmx.init.One(), 6, 2, "lstm"),
        jmx.init.FusedRNN(jmx.init.One(), 6, 2, "lstm"),
        "lstm_parameters_weight", shape)
    np.testing.assert_array_equal(got, want)
    # a dumps() string as the inner initializer, the draws its law's
    fr = tmx.init.FusedRNN(tmx.init.Uniform(0.1).dumps(), 6, 2, "lstm",
                           generator=torch.Generator().manual_seed(0))
    t = tmx.nd.zeros(shape, ctx=tmx.cpu())
    fr(tmx.init.InitDesc("lstm_parameters_weight"), t)
    a = t.asnumpy()
    assert np.abs(a).max() <= 0.1 and a.std() > 0.05


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(6, 10), (10, 6), (4, 2, 3)])
def test_orthogonal_law(shape, rand_type):
    """The JAX package's law: scale times the orthonormal factor of the
    (n_out, fan_in) matrix, so its rows (n_out <= fan_in) or columns are
    orthonormal up to scale; both packages' draws obey it."""
    scale = 1.7
    got, want = _init_both(
        tmx.init.Orthogonal(scale, rand_type,
                            generator=torch.Generator().manual_seed(1)),
        jmx.init.Orthogonal(scale, rand_type), "w_weight", shape)
    for a in (got, want):
        m = a.reshape(shape[0], -1).astype(np.float64)
        g = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        np.testing.assert_allclose(g, scale ** 2 * np.eye(len(g)),
                                   atol=1e-5)
    assert not np.allclose(got, want)


# ---------------------------------------------------------------------------
# mx.rnn cells
# ---------------------------------------------------------------------------

def _cells(mx, kind):
    R = mx.rnn
    if kind == "rnn":
        return R.RNNCell(6, activation="relu", prefix="r_")
    if kind == "lstm":
        return R.LSTMCell(6, prefix="l_", forget_bias=0.5)
    if kind == "gru":
        return R.GRUCell(6, prefix="g_")
    if kind == "fused_lstm":
        return R.FusedRNNCell(6, num_layers=2, mode="lstm", prefix="f_",
                              get_next_state=True)
    if kind == "fused_gru_bi":
        return R.FusedRNNCell(6, num_layers=2, mode="gru",
                              bidirectional=True, prefix="fg_",
                              get_next_state=True)
    if kind == "fused_tanh":
        return R.FusedRNNCell(6, num_layers=1, mode="rnn_tanh",
                              prefix="ft_")
    if kind == "sequential":
        s = R.SequentialRNNCell()
        s.add(R.LSTMCell(6, prefix="s0_"))
        s.add(R.DropoutCell(0.0, prefix="sd_"))
        s.add(R.ResidualCell(R.GRUCell(6, prefix="s1_")))
        return s
    if kind == "bidirectional":
        return R.BidirectionalCell(R.LSTMCell(5, prefix="bl_"),
                                   R.GRUCell(5, prefix="br_"))
    if kind == "zoneout":
        return R.ZoneoutCell(R.LSTMCell(6, prefix="z_"),
                             zoneout_outputs=0.3, zoneout_states=0.2)
    if kind == "unfused":
        return R.FusedRNNCell(6, num_layers=2, mode="lstm", prefix="u_",
                              bidirectional=True).unfuse()
    raise ValueError(kind)


CELL_KINDS = ["rnn", "lstm", "gru", "fused_lstm", "fused_gru_bi",
              "fused_tanh", "sequential", "bidirectional", "zoneout",
              "unfused"]


def _unroll_run(mx, kind, layout, x, params, is_train, ctx):
    with mx.NameManager():
        cell = _cells(mx, kind)
        outs, states = cell.unroll(x.shape[layout.find("T")],
                                   inputs=mx.sym.Variable("data"),
                                   layout=layout, merge_outputs=True)
        sym = mx.sym.Group([outs] + list(states))
    shapes = {"data": x.shape}
    ex = sym.simple_bind(ctx=ctx, grad_req="write", **shapes)
    names = [n for n in sym.list_arguments() if n != "data"]
    if params is None:
        rng = np.random.RandomState(5)
        params = {n: rng.uniform(-0.4, 0.4, ex.arg_dict[n].shape)
                  .astype(np.float32) for n in names}
    for n in names:
        ex.arg_dict[n][:] = params[n]
    ex.arg_dict["data"][:] = x
    outs = [o.asnumpy() for o in ex.forward(is_train=is_train)]
    if not is_train:
        return outs, {}, params
    ct = [np.random.RandomState(9 + i).standard_normal(o.shape)
          .astype(np.float32) for i, o in enumerate(outs)]
    ex.backward([mx.nd.array(c, ctx=ctx) for c in ct])
    return (outs, {n: ex.grad_dict[n].asnumpy()
                   for n in sorted(ex.grad_dict)}, params)


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
@pytest.mark.parametrize("kind", CELL_KINDS)
def test_cell_unroll_against_jax(kind, layout):
    """Every cell's unroll, bound on the CPU with the same parameters and
    data: outputs (merged) and final states, and every gradient. Zoneout
    runs forward in inference (its masks are the Dropout op's draws)."""
    x = np.random.RandomState(0).uniform(-1, 1, (3, 4, 5) if layout ==
                                         "NTC" else (4, 3, 5)) \
        .astype(np.float32)
    is_train = kind != "zoneout"
    jo, jg, params = _unroll_run(jmx, kind, layout, x, None, is_train,
                                 jmx.cpu())
    to, tg, _ = _unroll_run(tmx, kind, layout, x, params, is_train,
                            tmx.cpu())
    assert len(to) == len(jo)
    for i, (a, b) in enumerate(zip(to, jo)):
        _close(a, b, RTOL, f"{kind} out{i}")
    assert sorted(tg) == sorted(jg)
    for n in tg:
        _close(tg[n], jg[n], RTOL, f"{kind} grad {n}")


def test_cell_state_info_and_begin_state():
    for kind in ("lstm", "gru", "fused_lstm", "sequential",
                 "bidirectional"):
        with tmx.NameManager():
            tc = _cells(tmx, kind)
        with jmx.NameManager():
            jc = _cells(jmx, kind)
        assert tc.state_info == jc.state_info, kind
        assert [s.name for s in tc.begin_state()] == \
            [s.name for s in jc.begin_state()], kind
    assert sorted(_cells(tmx, "unfused").params._params) == \
        sorted(_cells(jmx, "unfused").params._params)


def test_fused_unpack_pack_weights():
    """FusedRNNCell.unfuse's cells, their unpack_weights / pack_weights
    (per-gate blobs and back) as the JAX package's, exactly."""
    rng = np.random.RandomState(2)
    for mx in (tmx, jmx):
        mx._w = None
    shapes = {"u_l0_i2h_weight": (24, 5), "u_l0_h2h_weight": (24, 6),
              "u_l0_i2h_bias": (24,), "u_l0_h2h_bias": (24,),
              "u_r0_i2h_weight": (24, 5), "u_r0_h2h_weight": (24, 6),
              "u_r0_i2h_bias": (24,), "u_r0_h2h_bias": (24,)}
    vals = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
    res = {}
    for name, mx in (("port", tmx), ("jax", jmx)):
        with mx.NameManager():
            stack = mx.rnn.FusedRNNCell(6, num_layers=1, mode="lstm",
                                        prefix="u_",
                                        bidirectional=True).unfuse()
        if mx is tmx:
            args = {n: mx.nd.array(v, ctx=mx.cpu()) for n, v in vals.items()}
        else:
            args = {n: mx.nd.array(v) for n, v in vals.items()}
        un = stack.unpack_weights(args)
        back = stack.pack_weights(un)
        res[name] = ({n: a.asnumpy() for n, a in un.items()},
                     {n: a.asnumpy() for n, a in back.items()})
    for i in range(2):
        assert sorted(res["port"][i]) == sorted(res["jax"][i])
        for n in res["port"][i]:
            np.testing.assert_array_equal(res["port"][i][n],
                                          res["jax"][i][n])
    for n, v in vals.items():
        np.testing.assert_array_equal(res["port"][1][n], v)


# ---------------------------------------------------------------------------
# BucketSentenceIter
# ---------------------------------------------------------------------------

def _batches(mx, sentences, seed, **kw):
    np.random.seed(seed)
    random.seed(seed)
    it = mx.rnn.BucketSentenceIter(sentences, **kw)
    out = []
    for epoch in range(2):
        for b in it:
            # copied as each batch comes: the JAX package's host arrays
            # may share the bucket matrices that the next reset shuffles
            out.append((b.bucket_key, np.array(b.data[0].asnumpy()),
                        np.array(b.label[0].asnumpy()),
                        b.provide_data[0].shape, b.provide_label[0].shape))
        it.reset()
    return it, out


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_jax(layout):
    rng = np.random.RandomState(4)
    words = ["a", "b", "c", "d", "e"]
    sents = [[words[i] for i in rng.randint(0, 5, rng.randint(1, 9))]
             for _ in range(90)]
    tcoded, tvocab = tmx.rnn.encode_sentences(sents, start_label=1)
    jcoded, jvocab = jmx.rnn.encode_sentences(sents, start_label=1)
    assert tcoded == jcoded and tvocab == jvocab
    kw = dict(batch_size=6, buckets=None if layout == "NT" else [3, 6, 8],
              invalid_label=0, layout=layout)
    with tmx.cpu():
        tit, tb = _batches(tmx, tcoded, 11, **kw)
    jit, jb = _batches(jmx, jcoded, 11, **kw)
    assert tit.buckets == jit.buckets
    assert tit.default_bucket_key == jit.default_bucket_key
    assert tit.provide_data[0].shape == jit.provide_data[0].shape
    assert len(tb) == len(jb) > 0
    for a, b in zip(tb, jb):
        assert a[0] == b[0] and a[3] == b[3] and a[4] == b[4]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])


def test_encode_sentences_unknown_token():
    vocab = {"\n": -1, "a": 0, "b": 1}
    for mx in (tmx, jmx):
        coded, _ = mx.rnn.encode_sentences([["a", "z"]], vocab=dict(vocab),
                                           unknown_token="b")
        assert coded == [[0, 1]]
        with pytest.raises(mx.MXNetError):
            mx.rnn.encode_sentences([["z"]], vocab=dict(vocab))


# ---------------------------------------------------------------------------
# bench.py's lstm_lm trainer: step_k(unroll=)
# ---------------------------------------------------------------------------

def _lane_symbol(mx, vocab=30, hidden=8, layers=2):
    """bench.py's lstm_lm symbol (bench.py:218-238)."""
    sym = mx.sym
    data = sym.Variable("data")
    emb = sym.Embedding(data, input_dim=vocab, output_dim=hidden,
                        name="emb")
    emb_t = sym.transpose(emb, axes=(1, 0, 2))
    rnn = sym.RNN(emb_t, sym.Variable("rnn_params"),
                  sym.transpose(sym.Variable("state"), axes=(1, 0, 2)),
                  sym.transpose(sym.Variable("state_cell"), axes=(1, 0, 2)),
                  state_size=hidden, num_layers=layers, mode="lstm",
                  name="lstm")
    out = sym.transpose(rnn, axes=(1, 0, 2))
    logits = sym.FullyConnected(sym.reshape(out, shape=(-1, hidden)),
                                num_hidden=vocab, name="dec")
    return sym.SoftmaxOutput(logits, name="softmax", multi_output=False)


def _lane_run(mx, mesh, k, unroll, batch=4, seq=5, vocab=30, hidden=8):
    from importlib import import_module
    DPT = import_module(mx.__name__ + ".parallel").DataParallelTrainer
    with mx.NameManager():
        sym = _lane_symbol(mx, vocab, hidden)
    tr = DPT(sym, mesh, data_names=("data", "state", "state_cell"),
             label_names=("softmax_label",), optimizer="sgd",
             learning_rate=0.1, rescale_grad=1.0 / (batch * seq))
    st = (batch, 2, hidden)
    params, states, aux = tr.init_state(
        {"data": (batch, seq), "state": st, "state_cell": st,
         "softmax_label": (batch * seq,)})
    rng = np.random.RandomState(0)
    xs = rng.randint(0, vocab, (k, batch, seq)).astype(np.float32)
    hs = rng.uniform(-0.3, 0.3, (k,) + st).astype(np.float32)
    cs = rng.uniform(-0.3, 0.3, (k,) + st).astype(np.float32)
    ys = rng.randint(0, vocab, (k, batch * seq)).astype(np.float32)
    inputs = tr.shard_inputs([xs, hs, cs, ys], stacked=True)
    kw = {} if unroll is None else {"unroll": unroll}
    params, _, _, losses, _ = tr.step_k(params, states, aux, inputs, **kw)
    return [np.asarray(p.cpu() if hasattr(p, "cpu") else p).copy()
            for p in params]


def test_step_k_unroll_on_the_lane():
    """The port's step_k takes unroll= as the JAX package's does (it
    raised TypeError), with the same result as without it and as the
    JAX package's trainer from the same init_state draw."""
    from jax.sharding import Mesh
    from mxnet_tpu_torch.parallel import data_parallel_mesh
    mesh = data_parallel_mesh(1, ["cpu"])
    base = _lane_run(tmx, mesh, 3, None)
    for unroll in (2, True, 1):
        got = _lane_run(tmx, mesh, 3, unroll)
        for a, b in zip(got, base):
            np.testing.assert_array_equal(a, b)
    jmesh = Mesh(np.array(jax.devices("cpu")[:1]), ("data",))
    want = _lane_run(jmx, jmesh, 3, 2)
    for a, b in zip(base, want):
        _close(a, b, RTOL, "lane parameters")
    with pytest.raises((TypeError, ValueError)):
        _lane_run(tmx, mesh, 1, "x")


def test_rnn_graph_over_several_contexts_is_refused():
    """The RNN op carries the batch on axis 1 (TNC): a walk over a mesh of
    contexts refuses the graph, naming ROADMAP item 12, rather than run
    each replica's shard through ops that would mix samples."""
    with tmx.NameManager():
        sym = _lane_symbol(tmx)
    mod = tmx.mod.Module(sym, data_names=("data", "state", "state_cell"),
                         context=[tmx.cpu(0), tmx.cpu(1)])
    st = (4, 2, 8)
    mod.bind(data_shapes=[("data", (4, 5)), ("state", st),
                          ("state_cell", st)],
             label_shapes=[("softmax_label", (20,))])
    rng = np.random.RandomState(0)
    mod.set_params({n: tmx.nd.array(rng.uniform(-0.1, 0.1,
                                                mod._exec.arg_dict[n].shape),
                                    ctx=tmx.cpu())
                    for n in mod._param_names}, {})
    with tmx.cpu():
        batch = tmx.io.DataBatch(
            data=[tmx.nd.zeros((4, 5)), tmx.nd.zeros(st), tmx.nd.zeros(st)],
            label=[tmx.nd.zeros((20,))])
    with pytest.raises(tmx.MXNetError, match="item 12"):
        mod.forward(batch, is_train=True)
