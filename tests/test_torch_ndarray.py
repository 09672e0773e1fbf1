"""The port's NDArray and ``mx.nd`` against the JAX package's, on the CPU.

Mutation (``[:] =``, item and slice assignment, ``+=``, ``copyto``,
``as_in_context``), Reshape's special codes, the generated ``mx.nd``
functions (positional params, ``out=``, the optimizer update ops writing
their states back), and ``nd.save`` / ``nd.load``: the port's bytes are
the JAX package's, and each package loads the other's files. Values
that pass through unchanged are compared exactly, computed ones within
1e-6 (one float32 operation in another fusion).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

CPU = tmx.cpu()


def _t(a, dtype=None):
    return tmx.nd.array(a, ctx=CPU, dtype=dtype)


def test_mutation_api():
    x = _t(np.zeros((3, 4)))
    x[:] = 2.5
    x[1] = np.arange(4)
    x[2, 1:3] = _t([7.0, 8.0])
    y = x[0:2]                       # a view, as the reference's slices
    y[:] = y * 2.0
    x += 1.0
    x *= _t(np.full((3, 4), 2.0))
    want = np.full((3, 4), 2.5)
    want[1] = np.arange(4)
    want[2, 1:3] = [7, 8]
    want[0:2] *= 2
    want = (want + 1) * 2
    np.testing.assert_array_equal(x.asnumpy(), want)
    z = _t(np.zeros((3, 4)))
    assert x.copyto(z) is z
    np.testing.assert_array_equal(z.asnumpy(), want)
    assert x.as_in_context(CPU) is x
    assert x.copyto(CPU).asnumpy().tolist() == want.tolist()
    assert _t([3.0]).asscalar() == 3.0
    assert x.dtype == np.float32 and x.context == CPU
    x.wait_to_read()


def test_ops_on_ndarrays_match_jax():
    rng = np.random.RandomState(0)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    ja, jb = jmx.nd.array(a), jmx.nd.array(b)
    ta, tb = _t(a), _t(b)
    pairs = [
        (ja + jb, ta + tb), (2.0 - ja, 2.0 - ta), (ja / 2.0, ta / 2.0),
        (ja ** 2.0, ta ** 2.0), (ja > 0, ta > 0), (-ja, -ta),
        (ja.sum(axis=1), ta.sum(axis=1)), (ja.mean(), ta.mean()),
        (ja.max(axis=0, keepdims=True), ta.max(axis=0, keepdims=True)),
        (ja.argmax(axis=1), ta.argmax(axis=1)), (ja.T, ta.T),
        (ja.reshape((0, 2, -1)), ta.reshape((0, 2, -1))),
        (ja.reshape(-3), ta.reshape(-3)),
        (ja.reshape((-4, 1, 3, 0)), ta.reshape((-4, 1, 3, 0))),
        (ja.clip(-0.5, 0.5), ta.clip(-0.5, 0.5)),
        (ja.expand_dims(0), ta.expand_dims(0)),
        (ja.dot(jb), ta.dot(tb)), (ja.softmax(), ta.softmax()),
        (jmx.nd.clip(ja, -0.1, 0.1), tmx.nd.clip(ta, -0.1, 0.1)),
        (jmx.nd.FullyConnected(ja, jmx.nd.array(a), num_hidden=3,
                               no_bias=True),
         tmx.nd.FullyConnected(ta, _t(a), num_hidden=3, no_bias=True)),
        (jmx.nd.concatenate([ja, ja]), tmx.nd.concatenate([ta, ta])),
        (jmx.nd.one_hot(jmx.nd.array([1, 3]), 4),
         tmx.nd.one_hot(_t([1, 3]), 4)),
        (jmx.nd.arange(0, 5, 2), tmx.nd.arange(0, 5, 2, ctx=CPU)),
    ]
    for i, (j, t) in enumerate(pairs):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=str(i))
        assert t.asnumpy().dtype == j.asnumpy().dtype, i


def test_out_and_state_write_back_match_jax():
    rng = np.random.RandomState(1)
    w, g, m = (rng.standard_normal(5).astype(np.float32) for _ in range(3))
    jw, jm = jmx.nd.array(w), jmx.nd.array(m)
    tw, tm = _t(w), _t(m)
    keep = tw._data
    kw = dict(lr=0.1, momentum=0.9, wd=0.01, rescale_grad=0.5)
    jmx.nd.sgd_mom_update(jw, jmx.nd.array(g), jm, out=jw, **kw)
    r = tmx.nd.sgd_mom_update(tw, _t(g), tm, out=tw, **kw)
    assert r is tw and tw._data is keep       # updated in place
    # XLA fuses the update's multiply-adds: a float32 ulp apart
    np.testing.assert_allclose(tw.asnumpy(), jw.asnumpy(), rtol=2e-7)
    np.testing.assert_allclose(tm.asnumpy(), jm.asnumpy(), rtol=2e-7)


def test_nd_random_draws_from_the_seeded_generator():
    tmx.random.seed(7)
    a = tmx.nd.random.uniform(-1, 1, shape=(50,), ctx=CPU).asnumpy()
    b = tmx.nd.random.normal(0, 2, shape=(50,), ctx=CPU).asnumpy()
    tmx.random.seed(7)
    np.testing.assert_array_equal(
        tmx.nd.random.uniform(-1, 1, shape=(50,), ctx=CPU).asnumpy(), a)
    np.testing.assert_array_equal(
        tmx.nd.random.normal(0, 2, shape=(50,), ctx=CPU).asnumpy(), b)
    assert (a >= -1).all() and (a < 1).all() and not np.array_equal(a, b)
    out = _t(np.zeros(4))
    assert tmx.nd.random.uniform(shape=(4,), out=out) is out


@pytest.mark.parametrize("kind", ["dict", "list"])
def test_save_is_byte_identical_and_loads_across(tmp_path, kind):
    rng = np.random.RandomState(2)
    vals = {"arg:w": rng.standard_normal((3, 2)).astype(np.float32),
            "aux:m": rng.standard_normal(4).astype(np.float32),
            "i": np.arange(5, dtype=np.int32),
            "h": rng.standard_normal(3).astype(np.float16)}
    if kind == "dict":
        jdata = {k: jmx.nd.array(v, dtype=v.dtype) for k, v in vals.items()}
        tdata = {k: _t(v, dtype=v.dtype) for k, v in vals.items()}
    else:
        jdata = [jmx.nd.array(v, dtype=v.dtype) for v in vals.values()]
        tdata = [_t(v, dtype=v.dtype) for v in vals.values()]
    jf, tf = tmp_path / "j.params", tmp_path / "t.params"
    jmx.nd.save(str(jf), jdata)
    tmx.nd.save(str(tf), tdata)
    assert tf.read_bytes() == jf.read_bytes()
    from_t = jmx.nd.load(str(tf))
    from_j = tmx.nd.load(str(jf))
    assert type(from_j) is type(from_t) is (dict if kind == "dict"
                                            else list)
    seq = zip(vals, vals.values())
    for i, (k, v) in enumerate(seq):
        key = k if kind == "dict" else i
        np.testing.assert_array_equal(from_t[key].asnumpy(), v)
        np.testing.assert_array_equal(from_j[key].asnumpy(), v)
        assert from_j[key].dtype == v.dtype


def test_default_context_is_the_card():
    assert tmx.current_context() == tmx.gpu(0)
    with tmx.cpu():
        assert tmx.current_context() == CPU
        x = tmx.nd.zeros((2,))
    assert x._data.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError, match="no CUDA device"):
            tmx.nd.zeros((2,))


def test_unported_ndarray_gradients_raise():
    x = _t([1.0])
    with pytest.raises(tmx.MXNetError, match="item 5"):
        x.attach_grad()
