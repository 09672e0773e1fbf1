"""The legacy ``mx.model.FeedForward`` of the port against the JAX
package's, on the CPU: the JAX package's three FeedForward cases run on
the port (fit / predict / score / save / load, create over a DataIter,
predict with its data), the two packages' fits from the same initial
parameters compared (probabilities within 1e-5), and checkpoints read
across the packages both ways.

``tests/data/feedforward_jax-*`` is a FeedForward checkpoint the JAX
package wrote (an 8 -> 16 -> 3 MLP after 2 epochs) with its own
predictions beside it; ``chip_smoke.py``'s feedforward phase loads it on
the card, where there is no JAX. :func:`write_fixture` rebuilds it
(only on purpose).
"""
import os
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "feedforward_jax")


def _mlp(mx):
    data = mx.sym.Variable("data")
    f1 = mx.sym.FullyConnected(data, name="fc1", num_hidden=16)
    a1 = mx.sym.Activation(f1, act_type="relu")
    f2 = mx.sym.FullyConnected(a1, name="fc2", num_hidden=3)
    return mx.sym.SoftmaxOutput(f2, name="softmax")


def _toy(n=256, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-2, 2, size=(3, 8)).astype(np.float32)
    y = rng.randint(0, 3, size=n)
    x = centers[y] + rng.normal(0, 0.3, (n, 8)).astype(np.float32)
    return x.astype(np.float32), y.astype(np.float32)


def test_feedforward_fit_predict_score(tmp_path):
    x, y = _toy()
    with pytest.warns(DeprecationWarning):
        model = tmx.model.FeedForward(
            _mlp(tmx), ctx=tmx.cpu(0), num_epoch=8, numpy_batch_size=32,
            learning_rate=0.2, momentum=0.9,
            initializer=tmx.init.Xavier())
    model.fit(x, y)
    probs = model.predict(x)
    assert probs.shape == (len(x), 3)
    acc = (probs.argmax(1) == y).mean()
    assert acc > 0.9, acc
    assert model.score(x, y) > 0.9
    prefix = str(tmp_path / "ff")
    model.save(prefix)
    with pytest.warns(DeprecationWarning):
        loaded = tmx.model.FeedForward.load(prefix, 8, ctx=tmx.cpu(0))
    np.testing.assert_array_equal(probs, loaded.predict(x))


def test_feedforward_create_with_iter():
    x, y = _toy(128, seed=1)
    it = tmx.io.NDArrayIter(x, y, batch_size=32, shuffle=True,
                            label_name="softmax_label")
    with pytest.warns(DeprecationWarning):
        model = tmx.model.FeedForward.create(
            _mlp(tmx), it, ctx=tmx.cpu(0), num_epoch=4, learning_rate=0.2,
            initializer=tmx.init.Xavier())
    assert model.arg_params and "fc1_weight" in model.arg_params
    assert model.predict(x).shape == (128, 3)


def test_feedforward_predict_return_data():
    x, y = _toy(64, seed=2)
    with pytest.warns(DeprecationWarning):
        model = tmx.model.FeedForward(_mlp(tmx), ctx=tmx.cpu(0),
                                      num_epoch=1, numpy_batch_size=32,
                                      learning_rate=0.1)
    model.fit(x, y)
    probs, xs, ys = model.predict(x, return_data=True)
    assert xs.shape == x.shape and ys.shape == y.shape
    assert probs.shape == (64, 3)
    np.testing.assert_array_equal(np.sort(xs, 0), np.sort(x, 0))


def _fit_both(x, y, epochs):
    """Both packages' FeedForward fitted from the same initial parameters
    (unshuffled batches): their predictions on x."""
    rng = np.random.RandomState(3)
    init = {"fc1_weight": rng.normal(0, 0.3, (16, 8)),
            "fc1_bias": np.zeros(16), "fc2_weight": rng.normal(0, 0.3,
                                                               (3, 16)),
            "fc2_bias": np.zeros(3)}
    out = []
    for mx in (tmx, jmx):
        it = mx.io.NDArrayIter(x, y, batch_size=32, shuffle=False,
                               label_name="softmax_label")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            model = mx.model.FeedForward(
                _mlp(mx), ctx=mx.cpu(0), num_epoch=epochs,
                learning_rate=0.2, momentum=0.9,
                arg_params={k: mx.nd.array(v.astype(np.float32),
                                           ctx=mx.cpu())
                            for k, v in init.items()})
        model.fit(it)
        out.append(model.predict(x))
    return out


def test_feedforward_fit_matches_jax():
    x, y = _toy(128, seed=4)
    got, want = _fit_both(x, y, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def write_fixture():
    """Rebuild tests/data/feedforward_jax-* with the JAX package."""
    x, y = _toy(32, seed=5)
    jmx.random.seed(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        model = jmx.model.FeedForward(_mlp(jmx), ctx=jmx.cpu(0),
                                      num_epoch=2, numpy_batch_size=16,
                                      learning_rate=0.2,
                                      initializer=jmx.init.Xavier())
    model.fit(x, y)
    model.save(FIXTURE)
    np.savez(FIXTURE + "-expected.npz", x=x, probs=model.predict(x))


def test_the_jax_fixture_is_the_jax_packages_and_loads_in_the_port():
    """The committed checkpoint's stored probabilities are what the JAX
    package predicts from it, and the port's FeedForward.load predicts
    them too."""
    with np.load(FIXTURE + "-expected.npz") as z:
        x, probs = z["x"], z["probs"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jm = jmx.model.FeedForward.load(FIXTURE, 2, ctx=jmx.cpu(0))
        tm = tmx.model.FeedForward.load(FIXTURE, 2, ctx=tmx.cpu(0))
    np.testing.assert_allclose(jm.predict(x), probs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.predict(x), probs, rtol=0, atol=1e-6)


def test_a_port_checkpoint_loads_in_the_jax_package(tmp_path):
    x, y = _toy(64, seed=6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        model = tmx.model.FeedForward(_mlp(tmx), ctx=tmx.cpu(0),
                                      num_epoch=2, numpy_batch_size=32,
                                      learning_rate=0.2,
                                      initializer=tmx.init.Xavier())
        model.fit(x, y)
        prefix = str(tmp_path / "port")
        model.save(prefix)
        jm = jmx.model.FeedForward.load(prefix, 2, ctx=jmx.cpu(0))
    np.testing.assert_allclose(jm.predict(x), model.predict(x), rtol=0,
                               atol=1e-6)
