"""NDArray autograd of the port against the JAX package's, on the CPU:
``attach_grad`` with "write" and "add" over two backwards,
``backward(out_grad)``, ``autograd.grad``, ``mark_variables``, a custom
``autograd.Function``, and the Gluon snippet every script has
(``net(mx.nd.array(x))``, ``x.attach_grad()``, ``net.hybridize()``,
``loss.backward()``) written once and run in both packages with only the
import changed. The same seeded numpy inputs go to both; tolerance
rtol 1e-5 / atol 1e-6 (float32 elementwise chains and sums of a few
terms).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-5, atol=1e-6)
PACKAGES = [(jmx, {}), (tmx, {"ctx": tmx.cpu()})]


def _x(seed, shape=(3, 4)):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _both(fn):
    """fn(mx, array) for each package; array(v) puts v on the CPU."""
    return [fn(mx, lambda v, kw=kw, mx=mx: mx.nd.array(v, **kw))
            for mx, kw in PACKAGES]


def _close(pair):
    j, t = pair
    for a, b in zip(j if isinstance(j, (list, tuple)) else [j],
                    t if isinstance(t, (list, tuple)) else [t]):
        np.testing.assert_allclose(b, a, **TOL)


@pytest.mark.parametrize("req", ["write", "add"])
def test_attach_grad_over_two_backwards(req):
    a, b = _x(0), _x(1)

    def run(mx, arr):
        x = arr(a)
        x.attach_grad(grad_req=req)
        g0 = x.grad.asnumpy()
        seen = []
        for k, other in enumerate((a, b)):
            with mx.autograd.record():
                y = (mx.nd.exp(x * 0.5) * arr(other)).sum() + (x * x).sum()
            y.backward()
            seen.append(x.grad.asnumpy())
        return [g0] + seen
    _close(_both(run))
    j = _both(run)[1]
    assert not j[0].any()                   # the buffer starts at zeros
    if req == "add":
        assert not np.allclose(j[2], j[1])


def test_backward_with_out_grad_and_retain_graph():
    a, og = _x(2), _x(3)

    def run(mx, arr):
        x = arr(a)
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.tanh(x) * 3.0
        y.backward(arr(og), retain_graph=True)
        first = x.grad.asnumpy()
        y.backward(arr(og * 2))
        return [first, x.grad.asnumpy(), y.asnumpy()]
    _close(_both(run))


def test_autograd_grad_returns_and_writes():
    a, b = _x(4), _x(5)

    def run(mx, arr):
        x, w = arr(a), arr(b)
        x.attach_grad()
        with mx.autograd.record():
            y = (mx.nd.sigmoid(x) * w).sum(axis=1)
        gx, = mx.autograd.grad(y, [x], head_grads=[arr(np.arange(
            3, dtype=np.float32))], retain_graph=True)
        return [gx.asnumpy(), x.grad.asnumpy()]
    _close(_both(run))
    j = _both(run)[1]
    np.testing.assert_array_equal(j[0], j[1])


def test_mark_variables_with_own_buffers():
    a = _x(6)

    def run(mx, arr):
        x = arr(a)
        g = arr(np.full(a.shape, 10.0, np.float32))
        mx.autograd.mark_variables([x], [g], "add")
        with mx.autograd.record():
            y = (x * x * x).mean()
        y.backward()
        return [x.grad.asnumpy(), g.asnumpy()]
    _close(_both(run))


def test_recording_scopes_and_errors():
    for mx, kw in PACKAGES:
        x = mx.nd.array(_x(7), **kw)
        x.attach_grad()
        assert not mx.autograd.is_recording()
        with mx.autograd.record():
            assert mx.autograd.is_recording() and mx.autograd.is_training()
            with mx.autograd.pause():
                assert not mx.autograd.is_recording()
            with mx.autograd.predict_mode():
                assert not mx.autograd.is_training()
        with pytest.raises(mx.base.MXNetError, match="not recorded"):
            (x * 2).backward()                  # nothing was recorded


class _Sigmoid:
    """The custom Function of the reference's docs, for either package."""

    @staticmethod
    def make(mx):
        class Sigmoid(mx.autograd.Function):
            def forward(self, x):
                y = 1 / (1 + mx.nd.exp(-x))
                self.y = y
                return y

            def backward(self, dy):
                y = self.y
                return dy * y * (1 - y) * 2.0      # deliberately not d/dx
        return Sigmoid()


def test_custom_function():
    a, og = _x(8), _x(9)

    def run(mx, arr):
        x = arr(a)
        x.attach_grad()
        f = _Sigmoid.make(mx)
        with mx.autograd.record():
            y = f(x)
            z = y * arr(og)
        z.backward()
        return [y.asnumpy(), x.grad.asnumpy()]
    _close(_both(run))
    y, gx = _both(run)[1]
    s = 1 / (1 + np.exp(-a))
    np.testing.assert_allclose(gx, og * s * (1 - s) * 2.0, **TOL)


def _snippet(mx, arr, hybrid):
    """The Gluon snippet of a user's script."""
    net = mx.gluon.nn.HybridSequential(prefix="snip_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(8, activation="relu"),
                mx.gluon.nn.Dense(3))
    return net


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
def test_gluon_snippet_runs_in_both_packages(hybrid):
    from mxnet_tpu_torch.convert import load_gluon_params
    x, y = _x(10, (5, 4)), np.array([0, 2, 1, 1, 0], np.float32)
    jnet = _snippet(jmx, None, hybrid)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    weights = {n: p.data().asnumpy() for n, p in
               jnet.collect_params().items()}
    tnet = _snippet(tmx, None, hybrid)
    tnet.initialize(ctx=tmx.cpu())
    load_gluon_params(tnet, weights, ctx=tmx.cpu())
    res = []
    for mx, kw, net in ((jmx, {}, jnet), (tmx, {"ctx": tmx.cpu()}, tnet)):
        if hybrid:
            net.hybridize()
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9})
        out = []
        for _ in range(2):
            xb = mx.nd.array(x, **kw)
            xb.attach_grad()
            with mx.autograd.record():
                loss = loss_fn(net(xb), mx.nd.array(y, **kw))
            loss.backward()
            trainer.step(x.shape[0])
            out += [loss.asnumpy(), xb.grad.asnumpy()]
        out += [p.data().asnumpy() for p in net.collect_params().values()]
        res.append(out)
    _close(res)
