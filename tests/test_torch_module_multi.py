"""The port's Module over several contexts and its fused fit against the
JAX package's, on the CPU.

The JAX Module over ``cpu(i)`` contexts binds one executor sharded over
the conftest's virtual devices; the port's binds one executor over n
host replicas (the batch split, BatchNorm's statistics and the
gradients over the whole batch). Both start from the JAX package's
Xavier parameters and take the same unshuffled batches; parameters and
aux states are held to JAX's own ``rtol=2e-4, atol=1e-5``
(tests/test_parallel.py).

The JAX Module steps parameter i with updater index ``i * len(context)``
but names index i in ``idx2name``, so with several contexts and the
updater outside the kvstore a parameter's lr / wd multipliers are read
for another parameter (``fc1_bias`` as ``fc2_weight``: decayed). The
port reproduces it (a result that differs from the JAX package's is a
fault); ``test_updater_index_reads_another_parameters_multipliers``
pins it.
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 2e-4, 1e-5
BATCH = 16
N = 128
PKGS = {"jax": jmx, "torch": tmx}


@pytest.fixture(autouse=True)
def _keep_global_rng():
    np_state, jax_state = np.random.get_state(), jmx.random.get_state()
    yield
    np.random.set_state(np_state)
    jmx.random.set_state(jax_state)


def mlp(mx):
    with mx.NameManager():
        data = mx.sym.Variable("data")
        f1 = mx.sym.FullyConnected(data, name="fc1", num_hidden=16)
        a1 = mx.sym.Activation(f1, act_type="relu")
        f2 = mx.sym.FullyConnected(a1, name="fc2", num_hidden=3)
        return mx.sym.SoftmaxOutput(f2, name="softmax")


def convbn(mx):
    with mx.NameManager():
        data = mx.sym.Variable("data")
        c = mx.sym.Convolution(data, kernel=(3, 3), num_filter=6,
                               pad=(1, 1), name="c1")
        b = mx.sym.BatchNorm(c, fix_gamma=False, name="bn1")
        r = mx.sym.Activation(b, act_type="relu")
        p = mx.sym.Pooling(r, kernel=(2, 2), stride=(2, 2), pool_type="max")
        f = mx.sym.FullyConnected(p, num_hidden=3, name="fc")
        return mx.sym.SoftmaxOutput(f, name="softmax")


NETS = {"mlp": (mlp, (8,)), "convbn": (convbn, (2, 6, 6))}


def _data(net, n=N, seed=3):
    rng = np.random.RandomState(seed)
    shape = NETS[net][1]
    centers = rng.uniform(-2, 2, (3,) + shape).astype(np.float32)
    y = rng.randint(0, 3, n)
    x = centers[y] + rng.normal(0, 0.5, (n,) + shape).astype(np.float32)
    return x.astype(np.float32), y.astype(np.float32)


def _iter(mx, x, y, batch=BATCH):
    return mx.io.NDArrayIter(x, y, batch_size=batch,
                             label_name="softmax_label")


def _init(net, x, y):
    """The JAX package's Xavier parameters, as numpy."""
    mod = jmx.mod.Module(NETS[net][0](jmx), context=jmx.cpu(0))
    it = _iter(jmx, x, y)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    jmx.random.seed(0)
    mod.init_params(initializer=jmx.init.Xavier())
    args, auxs = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in auxs.items()})


def _fit(mx, net, n, x, y, init, epochs=3, **kw):
    args, auxs = init
    mod = mx.mod.Module(NETS[net][0](mx),
                        context=[mx.cpu(i) for i in range(n)],
                        compression_params=kw.pop("compression", None))
    kw.setdefault("optimizer_params", {"learning_rate": 0.1,
                                       "momentum": 0.9})
    mod.fit(_iter(mx, x, y), num_epoch=epochs, optimizer="sgd",
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in args.items()},
            aux_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in auxs.items()}, **kw)
    arg, aux = mod.get_params()
    return mod, {**{k: v.asnumpy() for k, v in arg.items()},
                 **{"aux:" + k: v.asnumpy() for k, v in aux.items()}}


def _assert_close(got, want, **tol):
    tol = tol or dict(rtol=RTOL, atol=ATOL)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("n", [1, 2, 4])
def test_module_over_contexts_matches_jax(n, net):
    x, y = _data(net)
    init = _init(net, x, y)
    _, want = _fit(jmx, net, n, x, y, init)
    mod, got = _fit(tmx, net, n, x, y, init)
    _assert_close(got, want)
    assert len(mod._exec._replicas) == n


@pytest.mark.parametrize("n", [2, 4])
def test_several_contexts_equal_one(n):
    """The tests/test_parallel.py invariant on the port: n contexts train
    as one (the updater in the kvstore, at its own indices)."""
    x, y = _data("convbn")
    init = _init("convbn", x, y)
    _, one = _fit(tmx, "convbn", 1, x, y, init)
    _, many = _fit(tmx, "convbn", n, x, y, init)
    _assert_close(many, one)


@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "torch"])
def test_batch_divisibility(mx):
    mod = mx.mod.Module(mlp(mx), context=[mx.cpu(i) for i in range(8)])
    with pytest.raises(Exception) as e:
        mod.bind(data_shapes=[("data", (12, 8))],
                 label_shapes=[("softmax_label", (12,))])
    assert type(e.value).__name__ == "MXNetError"


@pytest.mark.parametrize("on_kvstore", ["0", "1"])
def test_update_on_kvstore_both_ways(monkeypatch, on_kvstore):
    monkeypatch.setenv("MXNET_UPDATE_ON_KVSTORE", on_kvstore)
    x, y = _data("mlp")
    init = _init("mlp", x, y)
    kw = dict(optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                "wd": 0.01})
    jmod, want = _fit(jmx, "mlp", 2, x, y, init, **kw)
    tmod, got = _fit(tmx, "mlp", 2, x, y, init, **kw)
    _assert_close(got, want)
    assert tmod._update_on_kvstore == jmod._update_on_kvstore \
        == (on_kvstore == "1")
    assert tmod._kvstore.type == "local"


def test_updater_index_reads_another_parameters_multipliers(monkeypatch):
    """With the updater outside the kvstore at 2 contexts, parameter i
    takes index 2 i: fc1_bias (i = 1) is stepped as index 2, which
    idx2name names fc2_weight, so it is decayed like a weight; one
    context (index i) does not decay it. Both packages do this."""
    monkeypatch.setenv("MXNET_UPDATE_ON_KVSTORE", "0")
    # two plain SGD steps: the biases start at 0, so the wrongly read
    # decay first shows in the second update, which is computed from the
    # same forward in both runs: the weights still agree, the biases not
    x, y = _data("mlp", n=2 * BATCH)
    init = _init("mlp", x, y)
    kw = dict(optimizer_params={"learning_rate": 0.1, "wd": 0.5})
    out = {}
    for name, mx in PKGS.items():
        for n in (1, 2):
            out[name, n] = _fit(mx, "mlp", n, x, y, init, epochs=1,
                                **dict(kw))[1]
    _assert_close(out["torch", 2], out["jax", 2])
    _assert_close(out["torch", 1], out["jax", 1])
    for w in ("fc1_weight", "fc2_weight"):
        np.testing.assert_allclose(out["torch", 2][w], out["torch", 1][w],
                                   rtol=RTOL, atol=ATOL)
    for b in ("fc1_bias", "fc2_bias"):
        diff = np.abs(out["torch", 2][b] - out["torch", 1][b]).max()
        assert diff > 10 * ATOL, (b, diff)


def test_gradient_compression_matches_jax():
    x, y = _data("mlp")
    init = _init("mlp", x, y)
    comp = {"type": "2bit", "threshold": 0.01}
    _, want = _fit(jmx, "mlp", 2, x, y, init, epochs=2, compression=comp)
    _, got = _fit(tmx, "mlp", 2, x, y, init, epochs=2, compression=comp)
    _assert_close(got, want)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("n", [1, 2])
def test_fused_fit_matches_k1_and_jax(n, net):
    x, y = _data(net)
    init = _init(net, x, y)
    _, k1 = _fit(tmx, net, n, x, y, init, epochs=2)
    tmod, k4 = _fit(tmx, net, n, x, y, init, epochs=2,
                    steps_per_dispatch=4)
    _, jk4 = _fit(jmx, net, n, x, y, init, epochs=2, steps_per_dispatch=4)
    _assert_close(k4, k1)
    _assert_close(k4, jk4)
    assert tmod.fused_trainer.captures == 0       # host: no graph


@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "torch"])
def test_fused_fit_metric_and_callbacks(mx):
    """One batch-end callback a block (nbatch = batches consumed - 1), the
    metric over every sample, the epoch-end callback with the trained
    parameters (tests/test_multistep.py)."""
    x, y = _data("mlp", n=224)
    seen, ends = [], []
    metric = mx.metric.Accuracy()
    mod = mx.mod.Module(mlp(mx), context=mx.cpu(0))
    mod.fit(_iter(mx, x, y, batch=32), num_epoch=1, optimizer="sgd",
            eval_metric=metric, optimizer_params={"learning_rate": 0.1},
            initializer=mx.init.Xavier(),
            batch_end_callback=lambda p: seen.append(p.nbatch),
            epoch_end_callback=lambda *a: ends.append(a),
            steps_per_dispatch=4)
    assert seen == [3, 6]
    assert metric.num_inst == 224
    assert len(ends) == 1 and ends[0][0] == 0
    np.testing.assert_array_equal(ends[0][2]["fc1_weight"].asnumpy(),
                                  mod.get_params()[0]["fc1_weight"]
                                  .asnumpy())


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record.getMessage())


@pytest.mark.parametrize("case", ["instance", "hyperparam", "lr_scheduler",
                                  "fixed_param"])
@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "torch"])
def test_fused_fit_blockers_warn_and_fall_back(mx, case):
    x, y = _data("mlp", n=64)
    opt, params, kw = "sgd", {"learning_rate": 0.1}, {}
    if case == "instance":
        opt = mx.optimizer.SGD(learning_rate=0.1, rescale_grad=1.0 / 32)
        params = {}
    elif case == "hyperparam":
        params["begin_num_update"] = 0
    elif case == "lr_scheduler":
        params["lr_scheduler"] = mx.lr_scheduler.FactorScheduler(2, 0.5)
    else:
        kw["fixed_param_names"] = ["fc1_bias"]
    mod = mx.mod.Module(mlp(mx), context=mx.cpu(0), **kw)
    h = _Warnings()
    logging.getLogger().addHandler(h)
    try:
        mod.fit(_iter(mx, x, y, batch=32), num_epoch=1, optimizer=opt,
                optimizer_params=params, initializer=mx.init.Xavier(),
                steps_per_dispatch=4)
    finally:
        logging.getLogger().removeHandler(h)
    assert any("falling back to per-batch" in r for r in h.records)
    assert mod.optimizer_initialized


@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "torch"])
def test_multi_precision_does_not_block_fusing(mx):
    x, y = _data("mlp", n=64)
    mod = mx.mod.Module(mlp(mx), context=mx.cpu(0))
    h = _Warnings()
    logging.getLogger().addHandler(h)
    try:
        mod.fit(_iter(mx, x, y, batch=32), num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1,
                                  "multi_precision": True},
                initializer=mx.init.Xavier(), steps_per_dispatch=4)
    finally:
        logging.getLogger().removeHandler(h)
    assert not any("falling back" in r for r in h.records)
    assert not mod.optimizer_initialized


def test_fused_fit_checkpoint_skips_optimizer_states(tmp_path, caplog):
    x, y = _data("mlp", n=64)
    mod = tmx.mod.Module(mlp(tmx), context=tmx.cpu(0))
    mod.fit(_iter(tmx, x, y, batch=32), num_epoch=1, optimizer="sgd",
            initializer=tmx.init.Xavier(), steps_per_dispatch=2)
    prefix = str(tmp_path / "m")
    with caplog.at_level(logging.WARNING):
        mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    assert any("skipping optimizer states" in r.message
               for r in caplog.records)
    _, args, _ = jmx.model.load_checkpoint(prefix, 1)
    np.testing.assert_array_equal(args["fc2_weight"].asnumpy(),
                                  mod.get_params()[0]["fc2_weight"]
                                  .asnumpy())
