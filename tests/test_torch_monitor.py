"""mxnet_tpu_torch.monitor.Monitor against the JAX package's
mxnet_tpu.monitor.Monitor, on the CPU: a small MLP's Module.fit with
``monitor=`` from the same numpy parameters in both packages, with and
without ``monitor_all`` (every node's inputs tapped as
``{node}_{input}``), gives the same windows (steps), the same tapped
names in the same order, and the same mean(|x|) statistics within 1e-5
relative (float32 sums in another order). Also: ``install_monitor`` on a
bound Module, ``sort``, ``pattern`` and ``interval``, and the refusal of
a monitor on a data-parallel mesh executor, which the JAX package has
too.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

PKGS = {"jax": jmx, "torch": tmx}
RTOL = 1e-5


def _mlp_sym(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, name="fc1", num_hidden=16)
    act1 = mx.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = mx.sym.FullyConnected(act1, name="fc2", num_hidden=4)
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def _data():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (48, 8)).astype(np.float32)
    y = rng.randint(0, 4, (48,)).astype(np.float32)
    params = {"fc1_weight": rng.normal(0, 0.3, (16, 8)),
              "fc1_bias": rng.normal(0, 0.1, (16,)),
              "fc2_weight": rng.normal(0, 0.3, (4, 16)),
              "fc2_bias": rng.normal(0, 0.1, (4,))}
    return x, y, {k: v.astype(np.float32) for k, v in params.items()}


def _recorder(mx, **kw):
    class Recorder(mx.Monitor):
        def __init__(self):
            super().__init__(**kw)
            self.windows = []

        def toc_print(self):
            self.windows.append(self.toc())
    return Recorder()


def _fit(mx, **kw):
    x, y, params = _data()
    ctx = tmx.cpu() if mx is tmx else jmx.cpu()
    it = mx.io.NDArrayIter(x, y, batch_size=16, shuffle=False)
    mod = mx.mod.Module(_mlp_sym(mx), context=ctx)
    mon = _recorder(mx, **kw)
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1},
            arg_params={k: mx.nd.array(v, ctx=ctx)
                        for k, v in params.items()},
            monitor=mon)
    return mon.windows


def _floats(text):
    return np.array([float(v) for v in text.strip().split("\t")])


@pytest.mark.parametrize("monitor_all", [False, True])
def test_monitor_stats_match_jax(monitor_all):
    kw = dict(interval=2, monitor_all=monitor_all)
    got = {n: _fit(mx, **kw) for n, mx in PKGS.items()}
    assert len(got["torch"]) == len(got["jax"]) == 6
    for ours, ref in zip(got["torch"], got["jax"]):
        assert [r[:2] for r in ours] == [r[:2] for r in ref]
        for (step, name, a), (_, _, b) in zip(ours, ref):
            np.testing.assert_allclose(_floats(a), _floats(b), rtol=RTOL,
                                       err_msg=f"step {step} {name}")
    names = [r[1] for w in got["torch"] for r in w]
    assert "fc1_output" in names and "softmax_output" in names
    if monitor_all:
        for n in ("fc1_data", "fc1_weight", "fc1_bias", "relu1_data",
                  "softmax_label"):
            assert n in names
    else:
        assert "fc1_weight" not in names
    # odd steps open no window: the interval is 2 over 6 batches
    assert [w[0][0] for w in got["torch"] if w] == [1, 3, 5]


def test_install_sort_and_pattern():
    x, _, params = _data()
    for mx in PKGS.values():
        ctx = tmx.cpu() if mx is tmx else jmx.cpu()
        mod = mx.mod.Module(_mlp_sym(mx), context=ctx)
        mod.bind(data_shapes=[("data", (16, 8))],
                 label_shapes=[("softmax_label", (16,))])
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                    for k, v in params.items()})
        mon = mx.Monitor(1, pattern="fc.*", sort=True)
        mod.install_monitor(mon)
        mon.tic()
        mod.forward(mx.io.DataBatch([mx.nd.array(x[:16], ctx=ctx)],
                                    [mx.nd.zeros((16,), ctx=ctx)]),
                    is_train=False)
        recs = mon.toc()
        assert [r[1] for r in recs] == ["fc1_output", "fc2_output",
                                        "softmax_output"]
        assert mon.toc() == []


def test_monitor_refused_on_a_data_parallel_mesh():
    mod = tmx.mod.Module(_mlp_sym(tmx), context=[tmx.cpu(0), tmx.cpu(1)])
    mod.bind(data_shapes=[("data", (16, 8))],
             label_shapes=[("softmax_label", (16,))])
    mod.init_params(tmx.init.Xavier())
    mon = tmx.Monitor(1, monitor_all=True)
    mod.install_monitor(mon)
    mon.tic()
    with pytest.raises(tmx.MXNetError, match="data-parallel mesh"):
        mod.forward(tmx.io.DataBatch(
            [tmx.nd.array(np.ones((16, 8), np.float32), ctx=tmx.cpu())],
            [tmx.nd.zeros((16,), ctx=tmx.cpu())]), is_train=False)
