"""Gluon over several contexts, the port against the JAX package (its
8-device CPU mesh from conftest.py; the port's mesh of cpu(i) contexts is
8 host replicas).

- The counterpart of tests/test_parallel.py::
  test_gluon_trainer_mesh_parity: a hybridized net initialized on 8
  contexts and fed ``split_and_load`` batches trains as on one context,
  in both packages (2e-4, the JAX test's bound), with and without
  BatchNorm (the mesh walk's whole-batch statistics); the port's 8-way
  run also matches the JAX package's to 1e-5 and goes through the mesh
  walk. An eager net computes the whole batch on the first context.
- ``split_and_load``: even (sharded), uneven with ``even_split=False``
  (replicated) and the error; ``Parameter.data(ctx)`` / ``list_data``
  / ``list_grad`` / ``reset_ctx`` / ``load`` over contexts.
- ``Trainer`` with kvstore "device" and "local", ``update_on_kvstore``
  true and false and 2-bit compression, each against the JAX package
  over 3 steps (1e-5); ``allreduce_grads`` + ``update``; the assertions
  with ``update_on_kvstore``; ``save_states`` / ``load_states`` through
  the kvstore, read by the other package.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.parallel.planner import AUTO_KNOB_VARS
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import executor as texecutor


@pytest.fixture(autouse=True)
def _no_planner_settings(monkeypatch):
    """Another test in this process may leave the JAX planner's settings
    in os.environ (``Plan.apply_env`` writes them; tests/test_planner.py's
    ``test_knobs_auto_unless_set``): the ZeRO stage and the fused K change
    what a trainer here does. Each one set is removed for the test and,
    recorded by monkeypatch, put back after it."""
    for k in AUTO_KNOB_VARS + ("MXNET_PLAN",):
        if k in os.environ:
            monkeypatch.delenv(k)


BATCH = 32
N = 8
PKGS = {"jax": jmx, "torch": tmx}
RTOL = 1e-5


def _data():
    rng = np.random.RandomState(5)
    return (rng.normal(size=(BATCH, 10)).astype(np.float32),
            rng.randint(0, 3, size=BATCH).astype(np.float32))


def _ctxs(mx, n):
    return [mx.cpu(i) for i in range(n)]


def _net(mx, ctxs, bn=False, hybridize=True):
    gluon = mx.gluon
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu"))
    if bn:
        net.add(gluon.nn.BatchNorm())
    net.add(gluon.nn.Dense(3))
    net.initialize(mx.init.Xavier(rnd_type="gaussian"), ctx=ctxs)
    if hybridize:
        net.hybridize()
    x, _ = _data()
    with ctxs[0]:
        net(gluon.utils.split_and_load(x, ctxs)[0])   # deferred init
    for i, (_, p) in enumerate(net.collect_params().items()):
        prng = np.random.RandomState(100 + i)
        p.set_data(mx.nd.array(prng.normal(0, 0.1, size=p.shape)
                               .astype(np.float32), ctx=ctxs[0]))
    return net


def _train(mx, n, bn=False, hybridize=True, steps=3, split=False,
           **trainer_kw):
    ctxs = _ctxs(mx, n)
    gluon, autograd = mx.gluon, mx.autograd
    net = _net(mx, ctxs, bn, hybridize)
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9},
                       **trainer_kw)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    X, Y = _data()
    for _ in range(steps):
        for x, y in zip(gluon.utils.split_and_load(X, ctxs),
                        gluon.utils.split_and_load(Y, ctxs)):
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
        if split:
            tr.allreduce_grads()
            tr.update(BATCH)
        else:
            tr.step(BATCH)
    return [p.data(ctxs[0]).asnumpy()
            for _, p in net.collect_params().items()], tr


def _close(got, want, rtol, what=""):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * np.abs(
            w).max(), err_msg=f"{what} param {i}")


@pytest.fixture
def mesh_walks(monkeypatch):
    """Counts the port's mesh walks over more than one replica."""
    calls = []
    real = texecutor._run_mesh

    def counted(plan, args, aux, devices, sharded, rng=None):
        if len(devices) > 1:
            calls.append(len(devices))
        return real(plan, args, aux, devices, sharded, rng)
    monkeypatch.setattr(texecutor, "_run_mesh", counted)
    return calls


@pytest.mark.parametrize("bn", [False, True], ids=["mlp", "batchnorm"])
def test_gluon_trainer_mesh_parity(mesh_walks, bn):
    j1, _ = _train(jmx, 1, bn)
    j8, _ = _train(jmx, N, bn)
    t1, _ = _train(tmx, 1, bn)
    assert not mesh_walks
    t8, tr = _train(tmx, N, bn)
    # 3 steps and the deferred-init call, each a forward over 8 replicas
    assert mesh_walks == [N] * 4
    _close(j8, j1, 2e-4, "jax 8 vs 1")
    _close(t8, t1, 2e-4, "torch 8 vs 1")
    _close(t8, j8, RTOL, "torch 8 vs jax 8")
    # kvstore "device" over 8 contexts updates on the store
    assert tr._kvstore is not None and tr._update_on_kvstore


def test_eager_net_on_a_mesh_batch(mesh_walks):
    j8, _ = _train(jmx, N, hybridize=False)
    t8, _ = _train(tmx, N, hybridize=False)
    assert not mesh_walks
    _close(t8, j8, RTOL)


def test_split_and_load():
    from mxnet_tpu_torch.gluon.utils import MeshNDArray
    x = np.arange(48, dtype=np.float32).reshape(12, 4)
    for n, even in ((4, True), (5, False)):
        ctxs = _ctxs(tmx, n)
        got = tmx.gluon.utils.split_and_load(x, ctxs, even_split=even)
        want = jmx.gluon.utils.split_and_load(x, _ctxs(jmx, n),
                                              even_split=even)
        assert len(got) == len(want) == 1
        assert isinstance(got[0], MeshNDArray)
        assert got[0].batch_axis == (0 if even else None)
        assert got[0].contexts == ctxs and got[0].context == tmx.cpu(0)
        np.testing.assert_array_equal(got[0].asnumpy(), want[0].asnumpy())
    with pytest.raises(ValueError, match="evenly"):
        jmx.gluon.utils.split_and_load(x, _ctxs(jmx, 5))
    with pytest.raises(ValueError, match="evenly"):
        tmx.gluon.utils.split_and_load(x, _ctxs(tmx, 5))
    one = tmx.gluon.utils.split_and_load(x, [tmx.cpu()])
    assert type(one[0]) is tmx.nd.NDArray
    axis1 = tmx.gluon.utils.split_and_load(x.T.copy(), _ctxs(tmx, 4),
                                           batch_axis=1)[0]
    assert axis1.batch_axis == 1


def test_parameter_over_contexts(tmp_path):
    for mx in (jmx, tmx):
        ctxs = _ctxs(mx, 4)
        p = mx.gluon.Parameter("w", shape=(3, 2))
        p.initialize(mx.init.One(), ctx=ctxs)
        assert p.list_ctx() == ctxs
        datas = p.list_data()
        assert len(datas) == 4 and all(d is datas[0] for d in datas)
        assert all(p.data(c) is datas[0] for c in ctxs)
        with pytest.raises(RuntimeError, match="was not initialized on "
                                               "context"):
            p.data(mx.cpu(6))
        grads = p.list_grad()
        assert len(grads) == 4
        np.testing.assert_array_equal(grads[0].asnumpy(), 0)
        p.set_data(mx.nd.array(np.full((3, 2), 2.0, np.float32),
                               ctx=ctxs[0]))
        for c in ctxs:
            np.testing.assert_array_equal(p.data(c).asnumpy(), 2.0)
        p.reset_ctx(ctxs[:2])
        assert p.list_ctx() == ctxs[:2] and len(p.list_data()) == 2
        np.testing.assert_array_equal(p.data(ctxs[1]).asnumpy(), 2.0)
    # a ParameterDict saved on one context loads onto several
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    fname = str(tmp_path / "dense.params")
    net.save_parameters(fname)
    net2 = tmx.gluon.nn.Dense(2, in_units=3)
    net2.load_parameters(fname, ctx=_ctxs(tmx, 3))
    for (_, a), (_, b) in zip(net.collect_params().items(),
                              net2.collect_params().items()):
        assert b.list_ctx() == _ctxs(tmx, 3)
        np.testing.assert_array_equal(b.data(tmx.cpu(2)).asnumpy(),
                                      a.data().asnumpy())


KVSTORE_CASES = {
    "device": {"kvstore": "device"},
    "local": {"kvstore": "local"},
    "device_local_update": {"kvstore": "device", "update_on_kvstore": False},
    "local_on_kvstore": {"kvstore": "local", "update_on_kvstore": True},
    "2bit": {"kvstore": "device", "update_on_kvstore": False,
             "compression_params": {"type": "2bit", "threshold": 0.01}},
    "none": {"kvstore": None},
}


@pytest.mark.parametrize("case", sorted(KVSTORE_CASES))
def test_trainer_kvstore_matches_jax(case):
    kw = KVSTORE_CASES[case]
    j8, jtr = _train(jmx, N, True, **kw)
    t8, ttr = _train(tmx, N, True, **kw)
    _close(t8, j8, RTOL, case)
    assert (ttr._kvstore is None) == (jtr._kvstore is None)
    assert ttr._update_on_kvstore == jtr._update_on_kvstore
    if not ttr._update_on_kvstore:
        # allreduce_grads + update is step
        ts, _ = _train(tmx, N, True, split=True, **kw)
        _close(ts, t8, 0.0, case + " split")


def test_trainer_assertions_on_kvstore():
    _, tr = _train(tmx, N, steps=1, kvstore="device",
                   update_on_kvstore=True)
    with pytest.raises(AssertionError, match="allreduce_grads"):
        tr.allreduce_grads()
    with pytest.raises(AssertionError, match="update"):
        tr.update(BATCH)


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch"),
                                           ("torch", "torch")])
def test_states_through_the_kvstore(tmp_path, writer, reader):
    """A kvstore that updates saves the states after 2 steps; a fresh
    Trainer of the reader over 8 contexts loads them into a net holding
    the writer's parameters and takes the third step as the writer
    does."""
    wmx, rmx = PKGS[writer], PKGS[reader]
    kw = {"kvstore": "device", "update_on_kvstore": True}
    _, wtr = _train(wmx, N, True, steps=2, **kw)
    fname = str(tmp_path / "states")
    wtr.save_states(fname)
    mid = [p.data(wmx.cpu(0)).asnumpy() for p in wtr._params]
    ctxs = _ctxs(rmx, N)
    net = _net(rmx, ctxs, True)
    for (_, p), v in zip(net.collect_params().items(), mid):
        p.set_data(rmx.nd.array(v, ctx=ctxs[0]))
    tr = rmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9}, **kw)
    tr.load_states(fname)
    assert tr._update_on_kvstore
    X, Y = _data()
    x = rmx.gluon.utils.split_and_load(X, ctxs)[0]
    y = rmx.gluon.utils.split_and_load(Y, ctxs)[0]
    with rmx.autograd.record():
        loss = rmx.gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    loss.backward()
    tr.step(BATCH)
    got = [p.data(ctxs[0]).asnumpy() for _, p in
           net.collect_params().items()]
    want, _ = _train(wmx, N, True, steps=3, **kw)
    _close(got, want, RTOL)
