"""The port's ``gluon.trainer.fused_fit`` against the JAX package's, on
the CPU: the MLP of tests/test_multistep.py::test_gluon_fused_fit_learns
and a small conv net with BatchNorm, from the same parameters, give the
same epoch losses and final parameters (1e-5 of the tensor's largest
magnitude), on one context and on four (the port's mesh of cpu(i)
replicas, the JAX package's 4 CPU devices). Also: K = 4 against K = 1
(1e-6), a tail block shorter than K, a deferred-init net, the epoch
callback seeing the written-back parameters, and the errors (an empty
or exhausted single-pass ``train_data``); ``checkpoint_dir`` commits
(tests/test_torch_checkpoint.py holds the resume).
"""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.parallel.planner import AUTO_KNOB_VARS
import mxnet_tpu_torch as tmx


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


RTOL = 1e-5
PKGS = {"jax": jmx, "torch": tmx}
OPT = {"learning_rate": 0.2, "momentum": 0.9}


def _blobs(n, batch, seed=5, conv=False):
    rng = np.random.RandomState(seed)
    shape = (1, 6, 6) if conv else (10,)
    centers = rng.uniform(-2, 2, (3,) + shape).astype(np.float32)
    out = []
    for _ in range(n):
        y = rng.randint(0, 3, batch)
        x = (centers[y] + rng.normal(0, 0.3, (batch,) + shape)) \
            .astype(np.float32)
        out.append((x, y.astype(np.float32)))
    return out


def _mlp(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu"))
        net.add(nn.Dense(3))
    return net


def _convnet(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(4, kernel_size=3, padding=1))
        net.add(nn.BatchNorm())
        net.add(nn.Activation("relu"))
        net.add(nn.Dense(3))
    return net


NETS = {"mlp": _mlp, "conv_bn": _convnet}


def _kw(mx):
    return {"ctx": tmx.cpu()} if mx is tmx else {}


def _scope(mx):
    return tmx.cpu() if mx is tmx else jmx.cpu()


def _built(mx, kind, batches, seed=1):
    """The net, initialized and then set from a seeded draw in parameter
    order (BatchNorm's scale and variance positive)."""
    net = NETS[kind](mx)
    net.initialize(mx.init.Xavier(), **_kw(mx))
    net(mx.nd.array(batches[0][0], **_kw(mx)))
    rng = np.random.RandomState(seed)
    for _, p in net.collect_params().items():
        if p.name.endswith(("gamma", "var")):
            v = rng.uniform(0.5, 1.5, p.shape)
        else:
            v = rng.normal(0, 0.3, p.shape)
        p.set_data(mx.nd.array(v.astype(np.float32), **_kw(mx)))
    return net


def _values(net):
    return [p.data().asnumpy() for _, p in net.collect_params().items()]


def _fit(mx, net, batches, epochs=3, k=4, **kw):
    data = [(mx.nd.array(x, **_kw(mx)), mx.nd.array(y, **_kw(mx)))
            for x, y in batches]
    with _scope(mx):
        return mx.gluon.trainer.fused_fit(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), data, epochs,
            optimizer="sgd", optimizer_params=dict(OPT),
            steps_per_dispatch=k, **kw)


def _close(got, want, rtol, what=""):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * max(
            1e-30, np.abs(w).max()), err_msg=f"{what} param {i}")


@pytest.mark.parametrize("kind", sorted(NETS))
def test_matches_jax(kind):
    batches = _blobs(8, 32, conv=kind == "conv_bn")
    got = {}
    for name, mx in PKGS.items():
        net = _built(mx, kind, batches)
        losses = _fit(mx, net, batches)
        got[name] = (losses, _values(net))
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], rtol=RTOL)
    _close(got["torch"][1], got["jax"][1], RTOL, kind)
    assert got["torch"][0][-1] < got["torch"][0][0] * 0.7


def test_four_contexts_match_jax():
    """contexts=[cpu(0..3)]: the batch split over 4 replicas (BatchNorm's
    statistics over the whole batch) in both packages."""
    batches = _blobs(4, 32, conv=True)
    got = {}
    for name, mx in PKGS.items():
        net = _built(mx, "conv_bn", batches)
        losses = _fit(mx, net, batches, epochs=2,
                      contexts=[mx.cpu(i) for i in range(4)])
        got[name] = (losses, _values(net))
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], rtol=RTOL)
    _close(got["torch"][1], got["jax"][1], RTOL, "4 contexts")


def test_k4_against_k1_with_a_tail_block():
    """6 batches at K = 4: a block of 4 and a tail block of 2, against
    K = 1 from the same parameters."""
    batches = _blobs(6, 16, conv=True)
    runs = []
    for k in (1, 4):
        net = _built(tmx, "conv_bn", batches)
        runs.append((_fit(tmx, net, batches, epochs=2, k=k), _values(net)))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6)
    _close(runs[1][1], runs[0][1], 1e-6, "K=4 vs K=1")


def test_deferred_init_net_and_epoch_callback():
    """A net whose shapes are still deferred is finished on the first
    batch; the callback sees the parameters written back at each epoch's
    end, and the mean loss the fit returns."""
    batches = _blobs(4, 16)
    for mx in PKGS.values():
        net = _mlp(mx)
        net.initialize(mx.init.Xavier(), **_kw(mx))
        first = next(iter(net.collect_params().values()))
        assert first.shape[1] == 0
        snaps = []
        losses = _fit(mx, net, batches, epochs=2, k=3,
                      epoch_callback=lambda e, n, loss: snaps.append(
                          (e, loss, _values(n))))
        assert first.shape == (16, 10)
        assert [s[0] for s in snaps] == [0, 1]
        assert [s[1] for s in snaps] == losses
        _close(snaps[-1][2], _values(net), 0.0, "callback")
        assert not np.allclose(snaps[0][2][0], snaps[1][2][0])


def test_refusals(tmp_path):
    batches = _blobs(2, 8)
    net = _built(tmx, "mlp", batches)
    single_pass = ((tmx.nd.array(x, ctx=tmx.cpu()),
                    tmx.nd.array(y, ctx=tmx.cpu())) for x, y in batches)
    with tmx.cpu(), pytest.raises(tmx.MXNetError, match="no batches"):
        tmx.gluon.trainer.fused_fit(
            net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), single_pass, 2)
    with tmx.cpu(), pytest.raises(tmx.MXNetError, match="empty"):
        tmx.gluon.trainer.fused_fit(
            net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), [], 1)
    # checkpoints are ported: one commit an epoch, none refused
    _fit(tmx, net, batches, epochs=2, checkpoint_dir=str(tmp_path))
    assert tmx.checkpoint.CheckpointManager(str(tmp_path)).steps() == [2, 4]


def test_steps_per_dispatch_default(monkeypatch):
    """K comes from MXNET_FUSED_K when not given, else 8: the blocks the
    trainer's step_k sees, and the losses equal K = 2's."""
    from mxnet_tpu_torch.parallel import dp
    blocks = []
    real = dp.DataParallelTrainer.step_k

    def step_k(self, params, states, aux, inputs, *a, **kw):
        blocks.append(int(inputs[0].shape[0]))
        return real(self, params, states, aux, inputs, *a, **kw)
    monkeypatch.setattr(dp.DataParallelTrainer, "step_k", step_k)
    batches = _blobs(6, 8)
    runs = []
    for env in ("2", None):
        if env is None:
            monkeypatch.delenv("MXNET_FUSED_K", raising=False)
        else:
            monkeypatch.setenv("MXNET_FUSED_K", env)
        net = _built(tmx, "mlp", batches)
        runs.append(_fit(tmx, net, batches, epochs=1, k=None))
    assert blocks == [2, 2, 2, 6]
    net = _built(tmx, "mlp", batches)
    assert runs[0] == _fit(tmx, net, batches, epochs=1, k=2)
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-6)
