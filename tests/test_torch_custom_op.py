"""The port's Custom operator (``mx.operator``) against the JAX
package's, on the CPU: the JAX package's four cases (imperative with its
gradient, inside a Symbol graph, several outputs, a hybridized Gluon net
that trains) run on the port and are compared with the JAX package's
results from the same seeded inputs (within 1e-5); one user class body
serves both packages (numpy in its forward and backward). Then what the
port adds: one operator created per forward and per backward (a
sampling op seeded in its constructor draws alike in both packages),
the backward given the forward's own outputs, auxiliary states refused,
and a graph holding Custom trained by Module.fit and by
DataParallelTrainer (whose step runs eagerly and says why).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

CALLS = {"create": 0, "forward": 0, "backward": 0}


def _register(mx):
    """The test ops, registered with package ``mx`` (names of their own:
    the JAX package's tests register ``scaled_square`` in the same
    process)."""

    class ScaledSquare(mx.operator.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], self.scale * in_data[0] ** 2)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        2.0 * self.scale * in_data[0] * out_grad[0])

    @mx.operator.register("parity_scaled_square")
    class ScaledSquareProp(mx.operator.CustomOpProp):
        def __init__(self, scale=1.0):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return ScaledSquare(self.scale)

    class Twin(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] + 1.0)
            self.assign(out_data[1], req[1], in_data[0] - 1.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] + out_grad[1])

    @mx.operator.register("parity_twin_outputs")
    class TwinProp(mx.operator.CustomOpProp):
        def list_outputs(self):
            return ["plus", "minus"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Twin()

    class Dropish(mx.operator.CustomOp):
        """A mask drawn from a RandomState seeded at construction; the
        backward reuses the forward's output (out / x) as its mask."""

        def __init__(self):
            self.rng = np.random.RandomState(7)
            CALLS["create"] += 1

        def forward(self, is_train, req, in_data, out_data, aux):
            CALLS["forward"] += 1
            mask = self.rng.uniform(size=in_data[0].shape) > 0.5
            self.assign(out_data[0], req[0], in_data[0] * mask)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            CALLS["backward"] += 1
            mask = out_data[0] != 0
            self.assign(in_grad[0], req[0], out_grad[0] * mask)

    @mx.operator.register("parity_seeded_drop")
    class DropProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Dropish()

    @mx.operator.register("parity_with_aux")
    class AuxProp(mx.operator.CustomOpProp):
        def list_auxiliary_states(self):
            return ["state"]

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Twin()


_register(jmx)
_register(tmx)


def _both(fn):
    """fn(mx, ctx) in both packages: (port's, JAX's)."""
    with tmx.cpu():
        t = fn(tmx, tmx.cpu())
    return t, fn(jmx, jmx.cpu())


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_custom_imperative_and_grad():
    def run(mx, ctx):
        x = mx.nd.array(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32),
                        ctx=ctx)
        y = mx.nd.Custom(x, scale=3.0, op_type="parity_scaled_square")
        x.attach_grad()
        with mx.autograd.record():
            z = mx.nd.Custom(x, scale=2.0, op_type="parity_scaled_square")
        z.backward()
        return y.asnumpy(), x.grad.asnumpy()
    t, j = _both(run)
    _close(t, j)
    np.testing.assert_allclose(t[1], 4.0 * np.array([[1, 2], [3, 4]]))


def test_custom_symbolic_train():
    def run(mx, ctx):
        data = mx.sym.Variable("data")
        net = mx.sym.FullyConnected(data, num_hidden=4, name="fc")
        net = mx.sym.Custom(net, scale=1.5, op_type="parity_scaled_square")
        net = mx.sym.sum(net)
        ex = net.simple_bind(ctx, data=(2, 3))
        rng = np.random.RandomState(0)
        ex.arg_dict["data"][:] = rng.normal(size=(2, 3))
        ex.arg_dict["fc_weight"][:] = rng.normal(size=(4, 3)) * 0.3
        ex.arg_dict["fc_bias"][:] = 0
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        return out, ex.grad_dict["fc_weight"].asnumpy()
    t, j = _both(run)
    _close(t, j)


def test_custom_multi_output():
    def run(mx, ctx):
        x = mx.nd.array(np.ones((2, 2), np.float32), ctx=ctx)
        a, b = mx.nd.Custom(x, op_type="parity_twin_outputs")
        return a.asnumpy(), b.asnumpy()
    t, j = _both(run)
    _close(t, j)
    np.testing.assert_allclose(t[0], 2.0)
    np.testing.assert_allclose(t[1], 0.0)


def test_custom_in_hybridized_gluon():
    def run(mx, ctx):
        class Net(mx.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.fc = mx.gluon.nn.Dense(4, in_units=5)

            def hybrid_forward(self, F, x):
                return F.Custom(self.fc(x), scale=2.0,
                                op_type="parity_scaled_square")

        net = Net()
        net.initialize(ctx=ctx)
        rng = np.random.RandomState(2)
        net.fc.weight.set_data(mx.nd.array(rng.normal(0, 0.3, (4, 5)),
                                           ctx=ctx))
        net.hybridize()
        x = mx.nd.array(np.random.RandomState(1).normal(size=(3, 5)),
                        ctx=ctx)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.005})
        losses = []
        for _ in range(8):
            with mx.autograd.record():
                loss = mx.nd.sum(net(x))
            loss.backward()
            trainer.step(1)
            losses.append(float(loss.asnumpy()))
        return np.array(losses), net.fc.weight.data().asnumpy()
    t, j = _both(run)
    _close(t, j)
    assert t[0][-1] < t[0][0]


def test_one_operator_per_call_and_the_forwards_outputs():
    """Each forward and each backward creates its own operator (seeded
    alike: the mask drawn equals the JAX package's), and the backward
    gets the forward's outputs: the forward runs once."""
    def run(mx, ctx):
        x = mx.nd.array(np.arange(1, 13, dtype=np.float32).reshape(3, 4),
                        ctx=ctx)
        x.attach_grad()
        for k in CALLS:
            CALLS[k] = 0
        with mx.autograd.record():
            y = mx.nd.Custom(x, op_type="parity_seeded_drop")
        y.backward()
        return (y.asnumpy(), x.grad.asnumpy(),
                np.array([CALLS["create"], CALLS["forward"],
                          CALLS["backward"]]))
    t, j = _both(run)
    _close(t[:2], j[:2])
    np.testing.assert_array_equal(t[2], [2, 1, 1])
    np.testing.assert_array_equal(t[1], (t[0] != 0).astype(np.float32))


def test_auxiliary_states_are_refused():
    x = tmx.nd.array(np.ones((2, 2), np.float32), ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="auxiliary"):
        tmx.nd.Custom(x, op_type="parity_with_aux")
    with pytest.raises(MXNetError, match="not registered"):
        tmx.nd.Custom(x, op_type="no_such_custom_op")


def _custom_mlp(mx):
    data = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    h = mx.sym.Custom(h, scale=0.5, op_type="parity_scaled_square", name="sq")
    h = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _init(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.normal(0, 0.3, (8, 6)).astype(np.float32),
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": rng.normal(0, 0.3, (3, 8)).astype(np.float32),
            "fc2_bias": np.zeros(3, np.float32)}


def test_module_fit_over_a_graph_with_custom():
    rng = np.random.RandomState(1)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    y = rng.randint(0, 3, 32).astype(np.float32)

    def run(mx, ctx):
        it = mx.io.NDArrayIter(x, y, batch_size=8, shuffle=False)
        mod = mx.mod.Module(_custom_mlp(mx), context=ctx)
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                arg_params={k: mx.nd.array(v, ctx=ctx)
                            for k, v in _init().items()})
        return [v.asnumpy() for _, v in sorted(mod.get_params()[0].items())]
    t, j = _both(run)
    _close(t, j)


def test_data_parallel_trainer_runs_a_custom_graph_eagerly():
    """DataParallelTrainer.step_k over a graph holding Custom: the same
    parameters as K steps, no capture, and the reason in graph_stats()
    naming the op."""
    from mxnet_tpu_torch.parallel import DataParallelTrainer
    from mxnet_tpu_torch.parallel.mesh import mesh_for_contexts
    rng = np.random.RandomState(2)
    xs = rng.normal(size=(3, 8, 6)).astype(np.float32)
    ys = rng.randint(0, 3, (3, 8)).astype(np.float32)
    shapes = {"data": (8, 6), "softmax_label": (8,)}
    out = []
    for fused in (True, False):
        tr = DataParallelTrainer(_custom_mlp(tmx),
                                 mesh_for_contexts([tmx.cpu()]),
                                 optimizer="sgd", learning_rate=0.1,
                                 momentum=0.9)
        p, st, a = tr.init_state(shapes, arg_params={
            k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in _init().items()})
        inputs = tr.shard_inputs([xs, ys], stacked=True)
        if fused:
            p, st, a, _, _ = tr.step_k(p, st, a, inputs)
        else:
            for i in range(3):
                p, st, a, _, _ = tr.step(p, st, a, (inputs[0][i],
                                                    inputs[1][i]))
        out.append({n: t.detach().numpy().copy()
                    for n, t in tr.device_params(p).items()})
        stats = tr.graph_stats()
        assert stats["captures"] == 0
        assert "parity_scaled_square" in stats["eager_reason"]
    for n in out[0]:
        np.testing.assert_allclose(out[0][n], out[1][n], rtol=1e-6,
                                   atol=1e-7)
    # and the JAX package's trainer over the same graph
    jt = jmx.parallel.DataParallelTrainer(
        _custom_mlp(jmx), jmx.parallel.data_parallel_mesh(1),
        optimizer="sgd", learning_rate=0.1, momentum=0.9)
    jp, js, ja = jt.init_state(shapes, arg_params={
        k: jmx.nd.array(v) for k, v in _init().items()})
    jin = jt.shard_inputs([xs, ys], stacked=True)
    jp, js, ja, _, _ = jt.step_k(jp, js, ja, jin)
    for n, v in zip(jt.param_names, jp):
        np.testing.assert_allclose(out[0][n], np.asarray(v), rtol=1e-5,
                                   atol=1e-6)


def test_module_fit_steps_per_dispatch_over_a_custom_graph():
    """Module.fit(steps_per_dispatch=2) (its DataParallelTrainer) over the
    graph with Custom: the parameters of the plain fit."""
    rng = np.random.RandomState(3)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    y = rng.randint(0, 3, 32).astype(np.float32)
    out = []
    for k in (None, 2):
        it = tmx.io.NDArrayIter(x, y, batch_size=8, shuffle=False)
        mod = tmx.mod.Module(_custom_mlp(tmx), context=tmx.cpu())
        kw = {} if k is None else {"steps_per_dispatch": k}
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                arg_params={n: tmx.nd.array(v, ctx=tmx.cpu())
                            for n, v in _init().items()}, **kw)
        out.append({n: v.asnumpy() for n, v in mod.get_params()[0].items()})
    for n in out[0]:
        np.testing.assert_allclose(out[1][n], out[0][n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_gluon_fused_fit_over_a_custom_block_matches_jax():
    """gluon.trainer.fused_fit (DataParallelTrainer.step_k underneath)
    over a HybridBlock holding Custom, in both packages from the same
    parameters: the epoch losses and the parameters within 1e-5."""
    rng = np.random.RandomState(4)
    batches = [(rng.normal(size=(8, 6)).astype(np.float32),
                rng.randint(0, 3, 8).astype(np.float32)) for _ in range(4)]
    init = _init()
    res = []
    for mx, kw in ((tmx, {"ctx": tmx.cpu()}), (jmx, {})):
        class Net(mx.gluon.HybridBlock):
            def __init__(self, **k):
                super().__init__(**k)
                with self.name_scope():
                    self.fc1 = mx.gluon.nn.Dense(8, in_units=6)
                    self.fc2 = mx.gluon.nn.Dense(3, in_units=8)

            def hybrid_forward(self, F, x):
                return self.fc2(F.Custom(self.fc1(x), scale=0.5,
                                         op_type="parity_scaled_square"))

        net = Net(prefix="net_")
        net.initialize(**kw)
        for name, p in (("fc1_weight", net.fc1.weight),
                        ("fc1_bias", net.fc1.bias),
                        ("fc2_weight", net.fc2.weight),
                        ("fc2_bias", net.fc2.bias)):
            p.set_data(mx.nd.array(init[name], **kw))
        data = [(mx.nd.array(x, **kw), mx.nd.array(y, **kw))
                for x, y in batches]
        if mx is tmx:
            with tmx.cpu():
                losses = mx.gluon.trainer.fused_fit(
                    net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), data, 2,
                    optimizer="sgd", optimizer_params={"learning_rate": 0.1},
                    steps_per_dispatch=2)
        else:
            losses = mx.gluon.trainer.fused_fit(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), data, 2,
                optimizer="sgd", optimizer_params={"learning_rate": 0.1},
                steps_per_dispatch=2)
        res.append((np.asarray(losses, np.float64),
                    [net.fc1.weight.data().asnumpy(),
                     net.fc2.weight.data().asnumpy()]))
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=1e-5)
    for a, b in zip(res[0][1], res[1][1]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
