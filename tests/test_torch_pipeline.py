"""mxnet_tpu_torch.pipeline (the device feed) against the JAX package's
mxnet_tpu.pipeline, on the CPU.

  - DeviceFeed's semantics in both packages, one case each: order and
    values, a source or stage exception raised again in the consumer,
    close mid-stream with no thread left, idempotent close,
    ``feed_or_inline`` off is an inline map, counters in the profiler's
    export;
  - the port's Module.fit / score / predict and Gluon fused_fit give
    bit-identical results with the feed on and off;
  - the port's fused_fit with the feed on against the JAX package's, from
    the same numpy parameters, within 1e-5 of each tensor's largest
    magnitude (the tolerance of tests/test_torch_fused_fit.py);
  - module_stage copies a batch to the executor's device and passes a
    batch that does not divide a mesh through.
"""
import os
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import pipeline as jpl
from mxnet_tpu.parallel.planner import AUTO_KNOB_VARS
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import pipeline as tpl

PLS = {"torch": tpl, "jax": jpl}
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _no_planner_settings(monkeypatch):
    """The JAX planner's settings another test may leave in os.environ
    (MXNET_DEVICE_FEED among them) are removed for the test and put back
    after it (tests/test_torch_fused_fit.py has the story)."""
    for k in AUTO_KNOB_VARS + ("MXNET_PLAN",):
        if k in os.environ:
            monkeypatch.delenv(k)


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("pkg", sorted(PLS))
def test_feed_order_values_and_shutdown(pkg):
    pl = PLS[pkg]
    items = [np.full((4,), i, np.float32) for i in range(20)]
    feed = pl.DeviceFeed(iter(items), stage=lambda a: a * 2)
    out = list(feed)
    assert len(out) == 20
    for i, a in enumerate(out):
        np.testing.assert_array_equal(a, np.full((4,), 2 * i, np.float32))
    feed.close()
    assert not feed._thread.is_alive()


@pytest.mark.parametrize("pkg", sorted(PLS))
def test_source_and_stage_exceptions_reach_the_consumer(pkg):
    pl = PLS[pkg]

    def source():
        yield 1
        yield 2
        raise RuntimeError("decode failed")

    feed = pl.DeviceFeed(source(), stage=lambda x: x)
    assert _take(feed, 2) == [1, 2]
    with pytest.raises(RuntimeError, match="decode failed"):
        next(feed)
    assert not feed._thread.is_alive()
    with pytest.raises(StopIteration):
        next(feed)

    def bad_stage(x):
        if x == 3:
            raise ValueError("bad batch 3")
        return x

    feed = pl.DeviceFeed(iter(range(6)), stage=bad_stage)
    assert _take(feed, 3) == [0, 1, 2]
    with pytest.raises(ValueError, match="bad batch 3"):
        next(feed)
    assert not feed._thread.is_alive()


@pytest.mark.parametrize("pkg", sorted(PLS))
def test_close_midstream_and_twice_leaves_no_thread(pkg):
    pl = PLS[pkg]
    before = threading.active_count()
    with pl.DeviceFeed(iter(range(1000)), stage=lambda x: x,
                       depth=2) as feed:
        assert next(feed) == 0
        thread = feed._thread
    thread.join(timeout=5)
    assert not thread.is_alive()
    feed.close()                               # idempotent
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


@pytest.mark.parametrize("pkg", sorted(PLS))
def test_feed_or_inline_off_and_counters(pkg, monkeypatch):
    pl = PLS[pkg]
    profiler = tmx.profiler if pkg == "torch" else jmx.profiler
    monkeypatch.setenv("MXNET_DEVICE_FEED", "0")
    feed = pl.feed_or_inline(iter([1, 2, 3]), lambda x: x + 1)
    assert not isinstance(feed, pl.DeviceFeed)
    assert list(feed) == [2, 3, 4]
    pl.close_feed(feed)
    monkeypatch.setenv("MXNET_DEVICE_FEED", "1")
    pl.reset_stats()
    feed = pl.feed_or_inline(iter(range(5)), lambda x: x)
    assert isinstance(feed, pl.DeviceFeed)
    assert list(feed) == list(range(5))
    pl.close_feed(feed)
    snap = profiler.export_counters()["device_feed"]
    assert snap["feed_batches"] == 5
    assert snap["feeds_opened"] == snap["feeds_closed"] == 1
    assert 0.0 <= snap["overlap_frac"] <= 1.0 and snap["feed_stage_us"] > 0


def test_staged_items_and_host_staging():
    """On the host a Staged item carries no event; stage_tensors and
    stack_to_device copy, so the source may reuse its buffers."""
    import torch
    src = [torch.arange(4.0), torch.ones(4)]
    copies, event = tpl.stage_tensors(src, torch.device("cpu"))
    assert event is None
    src[0].zero_()
    np.testing.assert_array_equal(copies[0].numpy(), np.arange(4.0))
    stacks, event = tpl.stack_to_device([src, src], torch.device("cpu"))
    assert event is None and tuple(stacks[0].shape) == (2, 4)
    item = object()
    assert tpl.Staged(item).ready() is item
    with pytest.raises(ValueError, match="copy stream"):
        tpl.stage_tensors(src, torch.device("cuda", 0))
    # nothing to copy (every array of a batch passed unstaged): no event
    assert tpl.stage_tensors([], torch.device("cuda", 0)) == ([], None)


# -- Module --------------------------------------------------------------------

def _mlp_sym(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, name="fc1", num_hidden=16)
    act1 = mx.sym.Activation(fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(act1, name="fc2", num_hidden=4)
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def _blob_data(n=160, dim=8, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-3, 3, size=(classes, dim))
    y = rng.randint(0, classes, size=n)
    x = centers[y] + rng.normal(0, 0.4, size=(n, dim))
    return x.astype(np.float32), y.astype(np.float32)


def _module_run(feed, monkeypatch, contexts=None, k=1):
    monkeypatch.setenv("MXNET_DEVICE_FEED", feed)
    tmx.random.seed(7)
    np.random.seed(7)
    x, y = _blob_data()
    it = tmx.io.NDArrayIter(x, y, batch_size=40, shuffle=False)
    mod = tmx.mod.Module(_mlp_sym(tmx), context=contexts or tmx.cpu())
    mod.fit(it, num_epoch=3, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=tmx.init.Xavier(), steps_per_dispatch=k)
    args, _ = mod.get_params()
    score = mod.score(it, "acc")
    pred = mod.predict(it).asnumpy()
    return {n: a.asnumpy() for n, a in args.items()}, score, pred


@pytest.mark.parametrize("k", [1, 2])
def test_module_fit_score_predict_bit_identical_with_feed(k, monkeypatch):
    """Module.fit (per batch, and K = 2 through _fit_fused), score and
    predict: equal, not close, with the feed on and off."""
    on = _module_run("1", monkeypatch, k=k)
    off = _module_run("0", monkeypatch, k=k)
    assert set(on[0]) == set(off[0])
    for n in on[0]:
        np.testing.assert_array_equal(on[0][n], off[0][n], err_msg=n)
    assert on[1] == off[1]
    np.testing.assert_array_equal(on[2], off[2])


def _bound_module(contexts):
    mod = tmx.mod.Module(_mlp_sym(tmx), context=contexts)
    mod.bind(data_shapes=[("data", (8, 8))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(tmx.init.Xavier())
    return mod


def test_module_stage_copies_to_the_executor_device():
    mod = _bound_module([tmx.cpu(0), tmx.cpu(1)])
    stage = tpl.module_stage(mod)
    x = np.ones((8, 8), np.float32)
    batch = tmx.io.DataBatch(data=[tmx.nd.array(x, ctx=tmx.cpu())],
                             label=[tmx.nd.array(np.zeros(8), ctx=tmx.cpu())])
    staged = stage(batch)
    assert isinstance(staged, tpl.Staged) and staged.event is None
    got = staged.ready()
    assert got.data[0]._data.data_ptr() != batch.data[0]._data.data_ptr()
    assert got.data[0]._data.device == mod._exec._device
    mod.forward(got, is_train=False)
    out = mod.get_outputs()[0].asnumpy()
    assert out.shape == (8, 4)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-5)
    odd = tmx.io.DataBatch(data=[tmx.nd.array(np.ones((7, 8), np.float32),
                                              ctx=tmx.cpu())],
                           label=[tmx.nd.array(np.zeros(7), ctx=tmx.cpu())])
    assert stage(odd).ready().data[0] is odd.data[0]


# -- Gluon fused_fit -------------------------------------------------------------

def _fused(mx, feed, monkeypatch, batches, params):
    monkeypatch.setenv("MXNET_DEVICE_FEED", feed)
    nn = mx.gluon.nn
    kw = {"ctx": tmx.cpu()} if mx is tmx else {}
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu"))
        net.add(nn.Dense(4))
    net.initialize(mx.init.Xavier(), **kw)
    net(mx.nd.array(batches[0][0], **kw))
    for (_, p), v in zip(net.collect_params().items(), params):
        p.set_data(mx.nd.array(v, **kw))
    data = [(mx.nd.array(x, **kw), mx.nd.array(y, **kw)) for x, y in batches]
    with (tmx.cpu() if mx is tmx else jmx.cpu()):
        losses = mx.gluon.trainer.fused_fit(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), data, 3,
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            steps_per_dispatch=2)
    return losses, [p.data().asnumpy()
                    for _, p in net.collect_params().items()]


def test_fused_fit_feed_on_off_and_against_jax(monkeypatch):
    x, y = _blob_data(n=192)
    batches = [(x[i:i + 32], y[i:i + 32]) for i in range(0, 192, 32)]
    rng = np.random.RandomState(3)
    params = [rng.normal(0, 0.3, s).astype(np.float32)
              for s in ((16, 8), (16,), (4, 16), (4,))]
    on = _fused(tmx, "1", monkeypatch, batches, params)
    off = _fused(tmx, "0", monkeypatch, batches, params)
    assert on[0] == off[0]
    for a, b in zip(on[1], off[1]):
        np.testing.assert_array_equal(a, b)
    ref = _fused(jmx, "1", monkeypatch, batches, params)
    np.testing.assert_allclose(on[0], ref[0], rtol=RTOL)
    for i, (a, b) in enumerate(zip(on[1], ref[1])):
        np.testing.assert_allclose(a, b, rtol=0, atol=RTOL * max(
            1e-30, np.abs(b).max()), err_msg=f"param {i}")
    assert on[0][-1] < on[0][0]
