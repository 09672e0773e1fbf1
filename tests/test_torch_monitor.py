"""mxnet_tpu_torch.monitor.Monitor against the JAX package's
mxnet_tpu.monitor.Monitor, on the CPU: a small MLP's Module.fit with
``monitor=`` from the same numpy parameters in both packages, with and
without ``monitor_all`` (every node's inputs tapped as
``{node}_{input}``), gives the same windows (steps), the same tapped
names in the same order, and the same mean(|x|) statistics within 1e-5
relative (float32 sums in another order). Also: ``install_monitor`` on a
bound Module, ``sort``, ``pattern`` and ``interval``, and a monitor on a
data-parallel mesh executor (a Module over two contexts), whose taps are
the whole batch's values, as the JAX package's.
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


def _tapper(mx, monitor_all):
    class Tapper(mx.Monitor):
        """Keeps each tapped array itself, in the order of the taps."""

        def __init__(self):
            super().__init__(1, pattern=".*", monitor_all=monitor_all)
            self.taps = []

        def __call__(self, name, array):
            if self._window_open:
                self.taps.append((name, array.asnumpy().copy()))
    return Tapper()


def _mesh_taps_match_jax(monitor_all):
    """A monitor on a Module over two contexts (a data-parallel mesh
    executor) taps the whole batch's values, as the JAX package's
    monitored forward does: the same names in the same order, and the
    same values within 1e-5 relative (float32 products summed in another
    order)."""
    got = {}
    for n, mx in PKGS.items():
        x, y, params = _data()
        mod = mx.mod.Module(_mlp_sym(mx), context=[mx.cpu(0), mx.cpu(1)])
        mod.bind(data_shapes=[("data", (16, 8))],
                 label_shapes=[("softmax_label", (16,))])
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in params.items()})
        mon = _tapper(mx, monitor_all)
        mod.install_monitor(mon)
        mon.tic()
        mod.forward(mx.io.DataBatch([mx.nd.array(x[:16], ctx=mx.cpu())],
                                    [mx.nd.array(y[:16], ctx=mx.cpu())]),
                    is_train=True)
        mon.toc()
        got[n] = mon.taps
    assert [t[0] for t in got["torch"]] == [t[0] for t in got["jax"]]
    assert len(got["jax"]) == (13 if monitor_all else 4), \
        [t[0] for t in got["jax"]]
    for (name, a), (_, b) in zip(got["torch"], got["jax"]):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6,
                                   err_msg=name)


def test_monitor_refused_on_a_data_parallel_mesh():
    """No longer refused: every node's inputs and outputs, tapped over
    the mesh, as the JAX package taps them."""
    _mesh_taps_match_jax(monitor_all=True)


def test_monitor_on_a_data_parallel_mesh_taps_outputs():
    _mesh_taps_match_jax(monitor_all=False)


def test_fit_with_a_monitor_over_two_contexts():
    """Module.fit(monitor=) over [cpu(0), cpu(1)]: the windows' names and
    mean(|x|) statistics match the JAX package's within 1e-5 relative."""
    got = {}
    for n, mx in PKGS.items():
        x, y, params = _data()
        it = mx.io.NDArrayIter(x, y, batch_size=16, shuffle=False)
        mod = mx.mod.Module(_mlp_sym(mx), context=[mx.cpu(0), mx.cpu(1)])
        mon = _recorder(mx, interval=2)
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                            for k, v in params.items()},
                monitor=mon)
        got[n] = mon.windows
    assert len(got["torch"]) == len(got["jax"]) == 6
    assert sum(len(w) for w in got["torch"]) == 15
    for ours, ref in zip(got["torch"], got["jax"]):
        assert [r[:2] for r in ours] == [r[:2] for r in ref]
        for (step, name, a), (_, _, b) in zip(ours, ref):
            np.testing.assert_allclose(_floats(a), _floats(b), rtol=RTOL,
                                       err_msg=f"step {step} {name}")
