"""Every layer of the port's gluon.nn basic and conv layers, and every
loss, against the JAX package's, on the CPU: eager (through
``mx.nd``) and hybridized (the traced Symbol run by the executor's walk).

Each case builds the layer in both packages with the same prefix,
initializes the JAX one, runs it once to finish deferred shapes, and
carries its weights into the port by ``collect_params`` name
(``convert.load_gluon_params``). The same seeded numpy input and output
cotangent then go through both inside ``autograd.record()``: the
outputs, the input's gradient (``attach_grad``), every parameter's
gradient and, after a training call, BatchNorm's moving statistics are
compared. Tolerance rtol 1e-5 / atol 1e-6: float32 sums of at most a
few hundred terms in another order.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu, gluon as tgluon
from mxnet_tpu_torch.convert import load_gluon_params

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = cpu()


def _seq(g):
    net = g.nn.HybridSequential(prefix="hs_")
    with net.name_scope():
        net.add(g.nn.Dense(6, activation="tanh"), g.nn.Dense(3))
    return net


def _eager_seq(g):
    net = g.nn.Sequential(prefix="s_")
    with net.name_scope():
        net.add(g.nn.Dense(6, activation="relu"), g.nn.Dense(3))
    return net


# (id, builder(gluon), input shape, input kind, train mode)
LAYERS = [
    ("dense", lambda g: g.nn.Dense(5, activation="relu", prefix="l_"),
     (3, 4, 2), "f", True),
    ("dense_noflat", lambda g: g.nn.Dense(5, flatten=False, use_bias=False,
                                          prefix="l_"), (3, 4, 2), "f", True),
    ("dropout_predict", lambda g: g.nn.Dropout(0.5, prefix="l_"), (4, 5),
     "f", False),
    ("batchnorm", lambda g: g.nn.BatchNorm(prefix="l_"), (4, 3, 5, 5), "f",
     True),
    ("batchnorm_inference", lambda g: g.nn.BatchNorm(prefix="l_"),
     (4, 3, 5), "f", False),
    ("batchnorm_fixed", lambda g: g.nn.BatchNorm(scale=False, center=False,
                                                 axis=1, prefix="l_"),
     (4, 3, 6), "f", True),
    ("instancenorm", lambda g: g.nn.InstanceNorm(prefix="l_"), (2, 3, 7),
     "f", True),
    ("instancenorm_axis2", lambda g: g.nn.InstanceNorm(
        axis=2, scale=True, prefix="l_"), (2, 5, 3, 4), "f", True),
    ("layernorm", lambda g: g.nn.LayerNorm(prefix="l_"), (3, 4, 6), "f",
     True),
    ("layernorm_axis1", lambda g: g.nn.LayerNorm(axis=1, prefix="l_"),
     (3, 4, 6), "f", True),
    ("embedding", lambda g: g.nn.Embedding(10, 4, prefix="l_"), (3, 5),
     "ids", True),
    ("flatten", lambda g: g.nn.Flatten(prefix="l_"), (3, 2, 4), "f", True),
    ("act_relu", lambda g: g.nn.Activation("relu", prefix="l_"), (3, 7),
     "f", True),
    ("act_sigmoid", lambda g: g.nn.Activation("sigmoid", prefix="l_"),
     (3, 7), "f", True),
    ("act_tanh", lambda g: g.nn.Activation("tanh", prefix="l_"), (3, 7),
     "f", True),
    ("act_softrelu", lambda g: g.nn.Activation("softrelu", prefix="l_"),
     (3, 7), "f", True),
    ("act_softsign", lambda g: g.nn.Activation("softsign", prefix="l_"),
     (3, 7), "f", True),
    ("leakyrelu", lambda g: g.nn.LeakyReLU(0.1, prefix="l_"), (3, 7), "f",
     True),
    ("prelu", lambda g: g.nn.PReLU(prefix="l_"), (3, 4, 5), "f", True),
    ("elu", lambda g: g.nn.ELU(0.7, prefix="l_"), (3, 7), "f", True),
    ("swish", lambda g: g.nn.Swish(1.5, prefix="l_"), (3, 7), "f", True),
    ("hybridlambda_name", lambda g: g.nn.HybridLambda("tanh", prefix="l_"),
     (3, 7), "f", True),
    ("hybridlambda_fn", lambda g: g.nn.HybridLambda(
        lambda F, x: F.relu(x) * 2.0, prefix="l_"), (3, 7), "f", True),
    ("hybridsequential", _seq, (4, 5), "f", True),
    ("conv1d", lambda g: g.nn.Conv1D(4, 3, strides=2, padding=1,
                                     activation="relu", prefix="l_"),
     (2, 3, 11), "f", True),
    ("conv2d", lambda g: g.nn.Conv2D(4, (3, 2), strides=(1, 2),
                                     padding=(1, 0), dilation=(2, 1),
                                     prefix="l_"), (2, 3, 9, 8), "f", True),
    ("conv2d_groups", lambda g: g.nn.Conv2D(6, 3, groups=3, use_bias=False,
                                            padding=1, prefix="l_"),
     (2, 3, 6, 6), "f", True),
    ("conv3d", lambda g: g.nn.Conv3D(3, 2, strides=1, prefix="l_"),
     (1, 2, 5, 4, 4), "f", True),
    ("conv1dtranspose", lambda g: g.nn.Conv1DTranspose(
        4, 3, strides=2, padding=1, output_padding=1, prefix="l_"),
     (2, 3, 6), "f", True),
    ("conv2dtranspose", lambda g: g.nn.Conv2DTranspose(
        4, (3, 2), strides=(2, 1), padding=(1, 0), prefix="l_"),
     (2, 3, 5, 4), "f", True),
    ("conv2dtranspose_groups", lambda g: g.nn.Conv2DTranspose(
        4, 3, strides=2, groups=2, use_bias=False, prefix="l_"),
     (2, 4, 3, 3), "f", True),
    ("conv3dtranspose", lambda g: g.nn.Conv3DTranspose(
        2, 2, strides=2, prefix="l_"), (1, 3, 3, 2, 3), "f", True),
    ("maxpool1d", lambda g: g.nn.MaxPool1D(3, 2, 1, prefix="l_"),
     (2, 3, 10), "f", True),
    ("maxpool2d_ceil", lambda g: g.nn.MaxPool2D(3, 2, ceil_mode=True,
                                                prefix="l_"),
     (2, 3, 8, 9), "f", True),
    ("maxpool3d", lambda g: g.nn.MaxPool3D(2, prefix="l_"), (1, 2, 4, 4, 6),
     "f", True),
    ("avgpool1d", lambda g: g.nn.AvgPool1D(3, 2, 1, prefix="l_"),
     (2, 3, 10), "f", True),
    ("avgpool2d_nopad", lambda g: g.nn.AvgPool2D(
        3, 2, 1, count_include_pad=False, prefix="l_"), (2, 3, 7, 8), "f",
     True),
    ("avgpool3d", lambda g: g.nn.AvgPool3D(2, ceil_mode=True, prefix="l_"),
     (1, 2, 5, 4, 5), "f", True),
    ("globalmaxpool1d", lambda g: g.nn.GlobalMaxPool1D(prefix="l_"),
     (2, 3, 7), "f", True),
    ("globalmaxpool2d", lambda g: g.nn.GlobalMaxPool2D(prefix="l_"),
     (2, 3, 5, 6), "f", True),
    ("globalmaxpool3d", lambda g: g.nn.GlobalMaxPool3D(prefix="l_"),
     (2, 3, 2, 3, 4), "f", True),
    ("globalavgpool1d", lambda g: g.nn.GlobalAvgPool1D(prefix="l_"),
     (2, 3, 7), "f", True),
    ("globalavgpool2d", lambda g: g.nn.GlobalAvgPool2D(prefix="l_"),
     (2, 3, 5, 6), "f", True),
    ("globalavgpool3d", lambda g: g.nn.GlobalAvgPool3D(prefix="l_"),
     (2, 3, 2, 3, 4), "f", True),
    ("reflectionpad2d", lambda g: g.nn.ReflectionPad2D(2, prefix="l_"),
     (2, 3, 5, 6), "f", True),
]


def _input(shape, kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "ids":
        return rng.randint(-1, 12, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _run(mx, net, x, ct, train, ctx=None):
    """(out, x grad or None, {param: grad}, {null param: value}) of one
    recorded call and backward of sum(out * ct)."""
    kw = {} if ctx is None else {"ctx": ctx}
    xa = mx.nd.array(x, **kw)
    diff = x.dtype == np.float32 and not np.all(x == np.round(x))
    if diff:
        xa.attach_grad()
    with mx.autograd.record(train_mode=train):
        out = net(xa)
        loss = (out * mx.nd.array(ct, **kw)).sum()
    loss.backward()
    params = net.collect_params()
    grads = {n: p.grad().asnumpy() for n, p in params.items()
             if p.grad_req != "null"}
    nulls = {n: p.data().asnumpy() for n, p in params.items()
             if p.grad_req == "null"}
    return (out.asnumpy(), xa.grad.asnumpy() if diff else None, grads,
            nulls)


def _pair(make, x):
    jb, tb = make(jgluon), make(tgluon)
    jmx.random.seed(7)
    jb.initialize(jmx.init.Xavier())
    jb(jmx.nd.array(x))                       # finish deferred shapes
    params = jb.collect_params()
    vals = {n: p.data().asnumpy() for n, p in params.items()}
    for n, p in params.items():               # non-trivial statistics
        if n.endswith("running_var"):
            vals[n] = np.linspace(0.5, 2.0, p.shape[0]).astype(np.float32)
            p.set_data(jmx.nd.array(vals[n]))
        elif n.endswith("running_mean") or n.endswith("_beta"):
            vals[n] = np.linspace(-0.3, 0.4, p.shape[0]).astype(np.float32)
            p.set_data(jmx.nd.array(vals[n]))
    load_gluon_params(tb, vals, ctx=CPU)
    return jb, tb


def _compare(got, want, what):
    out, gx, grads, nulls = got
    jout, jgx, jgrads, jnulls = want
    np.testing.assert_allclose(out, jout, err_msg=what + " out", **TOL)
    if jgx is not None:
        np.testing.assert_allclose(gx, jgx, err_msg=what + " dx", **TOL)
    assert sorted(grads) == sorted(jgrads)
    for n in jgrads:
        np.testing.assert_allclose(grads[n], jgrads[n],
                                   err_msg=f"{what} grad {n}", **TOL)
    assert sorted(nulls) == sorted(jnulls)
    for n in jnulls:
        np.testing.assert_allclose(nulls[n], jnulls[n],
                                   err_msg=f"{what} {n}", **TOL)


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("name,make,shape,kind,train", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layer_matches_jax(name, make, shape, kind, train, hybrid):
    x = _input(shape, kind, seed=len(name))
    jb, tb = _pair(make, x)
    jout = jb(jmx.nd.array(x)).asnumpy()
    ct = np.random.RandomState(1).standard_normal(jout.shape).astype(
        np.float32)
    want = _run(jmx, jb, x, ct, train)
    if hybrid:
        tb.hybridize()
    got = _run(tmx, tb, x, ct, train, ctx=CPU)
    _compare(got, want, name)
    if hybrid:
        assert tb._cached_graph, "the hybridized call traced no graph"


def test_sequential_and_lambda_eager():
    # Sequential and Lambda are Blocks (no hybrid_forward): eager only
    x = _input((4, 5), "f", 3)
    jb, tb = _pair(_eager_seq, x)
    ct = np.ones((4, 3), np.float32)
    _compare(_run(tmx, tb, x, ct, True, ctx=CPU),
             _run(jmx, jb, x, ct, True), "sequential")
    jl, tl = (g.nn.Lambda("relu", prefix="lam_") for g in (jgluon, tgluon))
    np.testing.assert_array_equal(
        tl(tmx.nd.array(x, ctx=CPU)).asnumpy(),
        jl(jmx.nd.array(x)).asnumpy())


def test_selu_is_the_reference_formula():
    # the JAX package's LeakyReLU op has no "selu" branch, so its SELU
    # layer raises; the port's follows the reference's definition
    import torch
    x = _input((3, 7), "f", 5)
    net = tgluon.nn.SELU(prefix="selu_")
    for hybrid in (False, True):
        net.hybridize(hybrid)
        xa = tmx.nd.array(x, ctx=CPU)
        xa.attach_grad()
        with tmx.autograd.record():
            y = net(xa)
        y.backward()
        tx = torch.from_numpy(x).requires_grad_(True)
        ty = torch.selu(tx)
        ty.sum().backward()
        np.testing.assert_allclose(y.asnumpy(), ty.detach().numpy(), **TOL)
        np.testing.assert_allclose(xa.grad.asnumpy(), tx.grad.numpy(),
                                   **TOL)


def test_dropout_trains_with_keep_scaling_eager_and_hybridized():
    x = np.ones((300, 40), np.float32)
    net = tgluon.nn.Dropout(0.25, prefix="drop_")
    for hybrid in (False, True):
        net.hybridize(hybrid)
        tmx.random.seed(3)
        with tmx.autograd.record():
            y = net(tmx.nd.array(x, ctx=CPU)).asnumpy()
        kept = y != 0
        np.testing.assert_allclose(y[kept], 1 / 0.75, rtol=1e-6)
        assert abs(kept.mean() - 0.75) < 0.02
        np.testing.assert_array_equal(
            net(tmx.nd.array(x, ctx=CPU)).asnumpy(), x)   # predict mode


# -- the hybridize contract --------------------------------------------------

class _TwoIn:
    """A block taking (x, [a, b]): nested argument lists are flattened
    to data0.. for the trace and regrouped."""

    @staticmethod
    def make(g):
        class Net(g.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.fc = g.nn.Dense(3, in_units=4)

            def hybrid_forward(self, F, x, states):
                a, b = states
                return self.fc(x) + a * b, a - b
        return Net(prefix="two_")


def test_hybridize_contract():
    rng = np.random.RandomState(0)
    x, a, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 4), (2, 3), (2, 3)))
    jb, tb = _TwoIn.make(jgluon), _TwoIn.make(tgluon)
    jb.initialize(jmx.init.Xavier())
    load_gluon_params(tb, {n: p.data().asnumpy() for n, p in
                           jb.collect_params().items()}, ctx=CPU)
    nd = lambda v: tmx.nd.array(v, ctx=CPU)        # noqa: E731
    want = [o.asnumpy() for o in jb(jmx.nd.array(x), [jmx.nd.array(a),
                                                      jmx.nd.array(b)])]
    eager = [o.asnumpy() for o in tb(nd(x), [nd(a), nd(b)])]
    tb.hybridize()
    got = [o.asnumpy() for o in tb(nd(x), [nd(a), nd(b)])]
    for g, e, w in zip(got, eager, want):
        np.testing.assert_allclose(g, w, **TOL)
        np.testing.assert_allclose(e, w, **TOL)
    inputs, graph = tb._cached_graph
    assert [i.name for i in inputs] == ["data0", "data1", "data2"]
    # another argument structure is refused, not silently re-used
    with pytest.raises(ValueError, match="does not match"):
        tb(nd(x), [nd(a), nd(b), nd(b)])
    # hybridize() again re-traces: a new graph for the next call
    tb.hybridize()
    assert not tb._cached_graph
    tb(nd(x), [nd(a), nd(b)])
    assert tb._cached_graph and tb._cached_graph[1] is not graph
    # and hybridize(False) runs eagerly again
    tb.hybridize(False)
    np.testing.assert_allclose(tb(nd(x), [nd(a), nd(b)])[0].asnumpy(),
                               want[0], **TOL)


def test_infer_shape_fills_deferred_shapes():
    for g, mx, kw in ((tgluon, tmx, {"ctx": CPU}), (jgluon, jmx, {})):
        net = g.nn.HybridSequential(prefix="inf_")
        with net.name_scope():
            net.add(g.nn.Conv2D(4, 3), g.nn.BatchNorm(), g.nn.Dense(5))
        net.initialize(**kw)
        x = mx.nd.array(np.zeros((2, 3, 6, 6), np.float32), **kw)
        net.infer_shape(x)
        shapes = {n: p.shape for n, p in net.collect_params().items()}
        assert shapes == {
            "inf_conv0_weight": (4, 3, 3, 3), "inf_conv0_bias": (4,),
            "inf_batchnorm0_gamma": (4,), "inf_batchnorm0_beta": (4,),
            "inf_batchnorm0_running_mean": (4,),
            "inf_batchnorm0_running_var": (4,),
            "inf_dense0_weight": (5, 64), "inf_dense0_bias": (5,)}
    # deferred parameters resolve on the first hybridized call too
    net = tgluon.nn.Dense(4, prefix="d_")
    net.initialize(ctx=CPU)
    net.hybridize()
    out = net(tmx.nd.array(np.ones((2, 3, 5)), ctx=CPU))
    assert out.shape == (2, 4) and net.weight.shape == (4, 15)


def test_cast_apply_hooks_and_parameter_ndarrays():
    net = tgluon.nn.HybridSequential(prefix="c_")
    with net.name_scope():
        net.add(tgluon.nn.Dense(3, in_units=2), tgluon.nn.BatchNorm(
            in_channels=3))
    net.initialize(ctx=CPU)
    # Parameter.data() / grad() are NDArrays over the one leaf
    w = net[0].weight
    assert isinstance(w.data(), tmx.nd.NDArray) and w.data() is w.data()
    assert w.list_data()[0] is w.data() and w.data()._data is w._data
    assert isinstance(w.grad(), tmx.nd.NDArray)
    # apply returns the block and visits every child, then the block
    seen = []
    assert net.apply(lambda b: seen.append(b.name)) is net
    assert seen == ["c_dense0", "c_batchnorm0", "c"]
    # hooks: called with (block, args[, out]); their return is ignored
    calls = []
    h1 = net.register_forward_pre_hook(
        lambda b, args: calls.append(("pre", len(args))) or "ignored")
    h2 = net.register_forward_hook(
        lambda b, args, out: calls.append(("post", out.shape)) or "x")
    out = net(tmx.nd.array(np.ones((4, 2)), ctx=CPU))
    assert isinstance(out, tmx.nd.NDArray)
    assert calls == [("pre", 1), ("post", (4, 3))]
    h1.detach()
    h2.detach()
    net(tmx.nd.array(np.ones((4, 2)), ctx=CPU))
    assert len(calls) == 2
    # cast casts the Gluon parameters (BatchNorm's statistics stay f32
    # under a half type, as in the JAX package)
    net.cast("float64")
    assert w.data().dtype == np.float64 and w.grad().dtype == np.float64
    net.hybridize()
    y = net(tmx.nd.array(np.ones((4, 2)), ctx=CPU, dtype="float64"))
    assert y.dtype == np.float64
    net.cast("float16")
    assert w.data().dtype == np.float16
    assert net[1].running_mean.data().dtype == np.float32


def test_summary_prints_the_reference_table(capsys):
    # the JAX package's summary() is a stub that raises; the port prints
    # the reference's table: each layer's output shape and parameters
    jnet = jgluon.nn.HybridSequential(prefix="sm_")
    with jnet.name_scope():
        jnet.add(jgluon.nn.Dense(8, activation="relu"), jgluon.nn.Dense(4))
    jnet.initialize()
    with pytest.raises(NotImplementedError):
        jnet.summary(jmx.nd.array(np.ones((2, 5))))
    net = tgluon.nn.HybridSequential(prefix="sm_")
    with net.name_scope():
        net.add(tgluon.nn.Dense(8, activation="relu"), tgluon.nn.Dense(4))
    net.initialize(ctx=CPU)
    net.summary(tmx.nd.array(np.ones((2, 5)), ctx=CPU))
    text = capsys.readouterr().out
    fmt = "{:>20}  {:>42} {:>15}"
    want = "\n".join([
        "-" * 80, fmt.format("Layer (type)", "Output Shape", "Param #"),
        "=" * 80, fmt.format("Input", "(2, 5)", 0),
        fmt.format("Activation-1", "(2, 8)", 0),
        fmt.format("Dense-2", "(2, 8)", 48),
        fmt.format("Dense-3", "(2, 4)", 36), "=" * 80,
        "Parameters in forward computation graph, duplicate included",
        "   Total params: 84", "   Trainable params: 84",
        "   Non-trainable params: 0",
        "Shared params in forward computation graph: 0",
        "Unique parameters in model: 84", "-" * 80]) + "\n"
    assert text == want
    net.hybridize()
    with pytest.raises(AssertionError, match="hybridized"):
        net.summary(tmx.nd.array(np.ones((2, 5)), ctx=CPU))


# -- losses ------------------------------------------------------------------

LOSSES = [
    ("l2", lambda g: g.loss.L2Loss(), "f", None),
    ("l2_weight_axis1", lambda g: g.loss.L2Loss(weight=0.5, batch_axis=1),
     "f", None),
    ("l1", lambda g: g.loss.L1Loss(weight=2.0), "f", "sw"),
    ("sigmoid_bce", lambda g: g.loss.SigmoidBinaryCrossEntropyLoss(),
     "01", None),
    ("sigmoid_bce_from_sigmoid", lambda g:
     g.loss.SigmoidBinaryCrossEntropyLoss(from_sigmoid=True), "01", "sw"),
    ("softmax_ce", lambda g: g.loss.SoftmaxCrossEntropyLoss(), "ids", None),
    ("softmax_ce_dense", lambda g: g.loss.SoftmaxCrossEntropyLoss(
        sparse_label=False, weight=0.3), "prob", "sw"),
    ("softmax_ce_logits_axis1", lambda g: g.loss.SoftmaxCELoss(
        axis=1, from_logits=True, batch_axis=0), "ids1", None),
    ("kldiv", lambda g: g.loss.KLDivLoss(), "prob", None),
    ("kldiv_softmax", lambda g: g.loss.KLDivLoss(from_logits=False), "prob",
     "sw"),
    ("huber", lambda g: g.loss.HuberLoss(rho=0.7), "f", None),
    ("hinge", lambda g: g.loss.HingeLoss(margin=0.5), "pm1", "sw"),
    ("squared_hinge", lambda g: g.loss.SquaredHingeLoss(), "pm1", None),
    ("logistic_signed", lambda g: g.loss.LogisticLoss(), "pm1", None),
    ("logistic_binary", lambda g: g.loss.LogisticLoss(
        label_format="binary"), "01", "sw"),
    ("triplet", lambda g: g.loss.TripletLoss(margin=0.3), "triplet", None),
]


def _loss_inputs(kind, sw, seed):
    rng = np.random.RandomState(seed)
    shape = (4, 3, 5)
    pred = rng.standard_normal(shape).astype(np.float32)
    if kind == "f":
        label = rng.standard_normal(shape).astype(np.float32)
    elif kind == "01":
        pred = rng.uniform(0.05, 0.95, shape).astype(np.float32) \
            if sw else pred
        label = (rng.rand(*shape) > 0.5).astype(np.float32)
    elif kind == "pm1":
        label = np.where(rng.rand(*shape) > 0.5, 1.0, -1.0).astype(
            np.float32)
    elif kind == "ids":
        label = rng.randint(0, 5, (4, 3)).astype(np.float32)
    elif kind == "ids1":
        label = rng.randint(0, 3, (4, 5)).astype(np.float32)
    elif kind == "prob":
        label = rng.dirichlet(np.ones(5), (4, 3)).astype(np.float32)
    else:                       # triplet: positive and negative
        label = rng.standard_normal(shape).astype(np.float32)
    args = [pred, label]
    if kind == "triplet":
        args.append(rng.standard_normal(shape).astype(np.float32))
    if sw:
        args.append(rng.rand(4, 1, 1).astype(np.float32))
    return args


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("name,make,kind,sw", LOSSES,
                         ids=[c[0] for c in LOSSES])
def test_loss_matches_jax(name, make, kind, sw, hybrid):
    args = _loss_inputs(kind, sw, seed=len(name))
    jl, tl = make(jgluon), make(tgluon)
    if hybrid:
        tl.hybridize()
    res = []
    for mx, loss, kw in ((jmx, jl, {}), (tmx, tl, {"ctx": CPU})):
        arrs = [mx.nd.array(a, **kw) for a in args]
        arrs[0].attach_grad()
        with mx.autograd.record():
            out = loss(*arrs)
            total = (out * mx.nd.array(np.arange(1, out.shape[0] + 1,
                                                 dtype=np.float32), **kw)
                     ).sum()
        total.backward()
        res.append((out.asnumpy(), arrs[0].grad.asnumpy()))
    (jo, jg), (to, tg) = res
    assert to.shape == jo.shape
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)


def test_ctc_loss_raises_naming_its_item():
    """CTCLoss raised before its op was ported; now it is the JAX
    package's loss (blank last, -1 padding, NTC), eager and hybridized:
    the losses and the prediction's gradient within TOL."""
    rng = np.random.RandomState(31)
    pred = rng.normal(size=(2, 6, 5)).astype(np.float32)
    label = np.array([[0, 3, -1], [1, 1, 2]], np.float32)
    for hybrid in (False, True):
        res = []
        for g, mx, kw in ((jgluon, jmx, {}), (tgluon, tmx, {"ctx": CPU})):
            loss = g.loss.CTCLoss()
            if hybrid:
                loss.hybridize()
            x = mx.nd.array(pred, **kw)
            x.attach_grad()
            with mx.autograd.record():
                out = loss(x, mx.nd.array(label, **kw))
            out.backward()
            res.append((out.asnumpy(), x.grad.asnumpy()))
        (jo, jg), (to, tg) = res
        np.testing.assert_allclose(to, jo, **TOL)
        np.testing.assert_allclose(tg, jg, **TOL)
