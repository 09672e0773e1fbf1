"""The port's kvstore against the JAX package's, on the CPU: the cases
of tests/test_kvstore.py run side by side on the same values (exact for
the sums; the optimizers within a few float32 ulps), optimizer states saved
by the JAX store and loaded by the port's, and the 2-bit compression's
packed words bit for bit the JAX package's, with the residuals carried
over 3 pushes.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

SHAPE = (4, 4)
KEYS = [5, 7, 11]
PKGS = {"jax": jmx, "torch": tmx}


def _ctx(mx):
    return mx.cpu(0)


def init_kv(mx, kind="local"):
    kv = mx.kvstore.create(kind)
    kv.init(3, mx.nd.zeros(SHAPE, ctx=_ctx(mx)))
    kv.init(KEYS, [mx.nd.zeros(SHAPE, ctx=_ctx(mx))] * len(KEYS))
    return kv


def _pull(mx, kv, key):
    out = mx.nd.zeros(SHAPE, ctx=_ctx(mx))
    kv.pull(key, out=out)
    return out.asnumpy()


def _both(fn):
    """fn(mx) for each package; the two results must be equal."""
    got = {k: fn(mx) for k, mx in PKGS.items()}
    np.testing.assert_array_equal(np.asarray(got["torch"]),
                                  np.asarray(got["jax"]))
    return got["torch"]


def test_single_kv_pair():
    def run(mx):
        kv = init_kv(mx)
        kv.push(3, mx.nd.ones(SHAPE, ctx=_ctx(mx)) * 4)
        return _pull(mx, kv, 3)
    np.testing.assert_array_equal(_both(run), np.full(SHAPE, 4.0))


def test_list_kv_pair():
    def run(mx):
        kv = init_kv(mx)
        kv.push(KEYS, [mx.nd.ones(SHAPE, ctx=_ctx(mx)) * (i + 2)
                       for i in range(len(KEYS))])
        out = [mx.nd.zeros(SHAPE, ctx=_ctx(mx)) for _ in KEYS]
        kv.pull(KEYS, out=out)
        return np.stack([o.asnumpy() for o in out])
    assert _both(run)[:, 0, 0].tolist() == [2.0, 3.0, 4.0]


@pytest.mark.parametrize("num_devs", [2, 4])
def test_aggregator_multi_device(num_devs):
    """Per-device values pushed for one key sum; a pull writes the sum
    into every device's array."""
    rng = np.random.RandomState(num_devs)
    vals = rng.standard_normal((num_devs,) + SHAPE).astype(np.float32)

    def run(mx):
        kv = init_kv(mx, "device")
        devs = [mx.cpu(i) for i in range(num_devs)]
        kv.push(3, [mx.nd.array(v, ctx=d) for v, d in zip(vals, devs)])
        out = [mx.nd.zeros(SHAPE, ctx=d) for d in devs]
        kv.pull(3, out=out)
        return np.stack([o.asnumpy() for o in out])
    got = _both(run)
    for o in got:
        np.testing.assert_allclose(o, vals.sum(0), rtol=1e-6)


def test_updater():
    def run(mx):
        kv = init_kv(mx)

        def updater(key, recv, local):
            local += recv
        kv._set_updater(updater)
        kv.push(3, mx.nd.ones(SHAPE, ctx=_ctx(mx)))
        kv.push(3, mx.nd.ones(SHAPE, ctx=_ctx(mx)))
        return _pull(mx, kv, 3)
    np.testing.assert_array_equal(_both(run), np.full(SHAPE, 2.0))


@pytest.mark.parametrize("opt", ["sgd", "sgd_mom", "adam"])
def test_set_optimizer(opt):
    rng = np.random.RandomState(1)
    grads = rng.standard_normal((3,) + SHAPE).astype(np.float32)

    def run(mx):
        kv = init_kv(mx)
        kw = {"sgd": dict(learning_rate=0.1),
              "sgd_mom": dict(learning_rate=0.1, momentum=0.9, wd=1e-2),
              "adam": dict(learning_rate=0.01)}[opt]
        name = "adam" if opt == "adam" else "sgd"
        kv.set_optimizer(mx.optimizer.create(name, **kw))
        for g in grads:
            kv.push(3, mx.nd.array(g, ctx=_ctx(mx)))
        return _pull(mx, kv, 3)
    got = {k: run(mx) for k, mx in PKGS.items()}
    # Adam's square root and division round in another order: a few
    # float32 ulps
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=2e-5,
                               atol=1e-7)


def test_optimizer_states_roundtrip(tmp_path):
    """Within each package, then across: states the JAX store saved,
    loaded by the port's store, continue the same momentum."""
    for mx in PKGS.values():
        kv = init_kv(mx)
        kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
        kv.push(3, mx.nd.ones(SHAPE, ctx=_ctx(mx)))
        fname = str(tmp_path / f"{mx.__name__}.states")
        kv.save_optimizer_states(fname)
        kv.load_optimizer_states(fname)
        kv.push(3, mx.nd.ones(SHAPE, ctx=_ctx(mx)))
        # v1=-0.1, w1=-0.1; v2=0.9*(-0.1)-0.1=-0.19, w2=-0.29
        np.testing.assert_allclose(_pull(mx, kv, 3), -0.29, rtol=1e-6)
    jkv = init_kv(jmx)
    jkv.set_optimizer(jmx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    jkv.push(3, jmx.nd.ones(SHAPE))
    fname = str(tmp_path / "from_jax.states")
    jkv.save_optimizer_states(fname)
    tkv = tmx.kvstore.create("local")
    tkv.init(3, tmx.nd.array(_pull(jmx, jkv, 3), ctx=tmx.cpu()))
    tkv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    tkv.load_optimizer_states(fname)
    state = tkv._updater.states[0]
    assert isinstance(state, tmx.nd.NDArray)
    np.testing.assert_allclose(state.asnumpy(), -0.1, rtol=1e-6)
    tkv.push(3, tmx.nd.ones(SHAPE, ctx=tmx.cpu()))
    jkv.push(3, jmx.nd.ones(SHAPE))
    np.testing.assert_allclose(_pull(tmx, tkv, 3), _pull(jmx, jkv, 3),
                               rtol=1e-6)


@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "torch"])
def test_init_twice_errors(mx):
    kv = init_kv(mx)
    with pytest.raises(Exception) as e:
        kv.init(3, mx.nd.ones(SHAPE, ctx=_ctx(mx)))
    assert type(e.value).__name__ == "MXNetError"


@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "torch"])
def test_push_uninitialized_errors(mx):
    kv = mx.kvstore.create("local")
    with pytest.raises(Exception) as e:
        kv.push(99, mx.nd.ones(SHAPE, ctx=_ctx(mx)))
    assert type(e.value).__name__ == "MXNetError"


@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "torch"])
def test_unknown_kind_errors(mx):
    with pytest.raises(Exception) as e:
        mx.kvstore.create("bogus")
    assert type(e.value).__name__ == "MXNetError"


@pytest.mark.parametrize("kind", ["local", "device", "nccl",
                                  "local_allreduce_cpu",
                                  "local_allreduce_device"])
def test_rank_and_type(kind):
    for mx in PKGS.values():
        kv = mx.kvstore.create(kind)
        assert (kv.rank, kv.num_workers, kv.type) == (0, 1, kind)


@pytest.mark.parametrize("kind", ["dist_sync", "dist_async",
                                  "dist_device_sync", "dist_sync_device",
                                  "dist"])
def test_dist_kinds_raise(kind):
    with pytest.raises(MXNetError, match="item 16"):
        tmx.kvstore.create(kind)


def test_async_warns_in_both(caplog):
    """An async kind runs synchronously, with the warning the JAX package
    logs (the port has no dist kinds, so a local store carries it)."""
    for mx in PKGS.values():
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            kv = mx.kvstore.KVStore("local_async")
        assert any("running synchronously" in r.message
                   for r in caplog.records)
        kv.init(3, mx.nd.ones(SHAPE, ctx=_ctx(mx)))
        np.testing.assert_array_equal(_pull(mx, kv, 3), np.ones(SHAPE))


@pytest.mark.parametrize("threshold", [0.5, 0.1])
@pytest.mark.parametrize("n", [16, 37, 1000])
def test_quantize_2bit_words_are_the_jax_packages(n, threshold):
    """The packed words bit for bit, and the residuals carried over 3
    rounds."""
    rng = np.random.RandomState(n)
    jres = np.zeros(n, np.float32)
    tres = torch.zeros(n)
    for _ in range(3):
        g = (rng.standard_normal(n) * 0.4).astype(np.float32)
        jw, jres = jmx.kvstore.quantize_2bit(g, jres, threshold)
        tw, tres = tmx.kvstore.quantize_2bit(torch.from_numpy(g), tres,
                                             threshold)
        np.testing.assert_array_equal(tw.view(torch.int32).numpy()
                                      .view(np.uint32),
                                      np.asarray(jw).view(np.uint32))
        np.testing.assert_array_equal(tres.numpy(), jres)
        np.testing.assert_array_equal(
            tmx.kvstore.dequantize_2bit(tw, n, threshold).numpy(),
            jmx.kvstore.dequantize_2bit(jw, n, threshold))


def test_compressed_pushes_match_the_jax_store():
    """set_gradient_compression: three pushes of per-device gradients
    through the 2-bit wire format with error feedback, pulled after
    each."""
    rng = np.random.RandomState(3)
    grads = (rng.standard_normal((3, 2) + SHAPE) * 0.6).astype(np.float32)

    def run(mx):
        kv = init_kv(mx)
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        pulled = []
        for g in grads:
            kv.push(3, [mx.nd.array(v, ctx=mx.cpu(i))
                        for i, v in enumerate(g)])
            pulled.append(_pull(mx, kv, 3))
        return np.stack(pulled)
    got = _both(run)
    assert set(np.unique(got)) <= {-0.5, 0.0, 0.5}


@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "torch"])
def test_other_compression_types_raise(mx):
    kv = init_kv(mx)
    with pytest.raises(Exception) as e:
        kv.set_gradient_compression({"type": "1bit"})
    assert type(e.value).__name__ == "MXNetError"
