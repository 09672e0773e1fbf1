"""The port's BucketingModule, SequentialModule and PythonLossModule
against the JAX package's, on the CPU.

Both packages build the same symbols, train from the same parameters
(uniform draws set in the JAX package's module, carried across with
``convert.load_module_params``) on the same batches (BucketSentenceIter
under one ``np.random`` / ``random`` seed), batch by batch: the outputs
and every parameter within RTOL of each tensor's largest magnitude after
each batch (float32 sums in another order through an LSTM over time).
The port's buckets share one buffer per parameter. Parameter files of a
bucketed FusedRNNCell model cross between the packages both ways.
"""
import logging
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import load_module_params

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _keep_global_rng():
    """The tests draw from np.random and random (BucketSentenceIter
    shuffles by them) and seed both packages' global generators: other
    tests in this process must find them all as they were."""
    np_state, py_state = np.random.get_state(), random.getstate()
    j_state, t_state = jmx.random.get_state(), tmx.random.get_state()
    yield
    np.random.set_state(np_state)
    random.setstate(py_state)
    jmx.random.set_state(j_state)
    tmx.random.set_state(t_state)


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1e-30, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


VOCAB, HIDDEN, EMBED = 20, 8, 6


def _sym_gen(mx, fused):
    """tests/test_rnn.py's LM (Embedding -> LSTM -> FullyConnected ->
    SoftmaxOutput), through LSTMCell.unroll or a 2-layer FusedRNNCell."""
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=VOCAB, output_dim=EMBED,
                                 name="embed")
        if fused:
            cell = mx.rnn.FusedRNNCell(HIDDEN, num_layers=2, mode="lstm",
                                       prefix="lstm_")
        else:
            cell = mx.rnn.LSTMCell(HIDDEN, prefix="lstm_l0_")
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, HIDDEN))
        pred = mx.sym.FullyConnected(pred, num_hidden=VOCAB, name="pred")
        lab = mx.sym.Reshape(label, shape=(-1,))
        return (mx.sym.SoftmaxOutput(pred, lab, name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


def _sentences(n=60, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        start = rng.randint(1, VOCAB - 6)
        out.append([start + i for i in range(rng.choice([3, 4, 6]))])
    return out


def _iter(mx, seed=5):
    np.random.seed(seed)
    random.seed(seed)
    return mx.rnn.BucketSentenceIter(_sentences(), batch_size=6,
                                     buckets=[3, 4, 6], invalid_label=0)


def _modules(fused, optimizer, opt_params):
    """(JAX module, port module, their iterators), bound and initialized
    with the same uniform draws (the fused cell's flat parameter vector
    has no name rule an initializer takes by default)."""
    jit = _iter(jmx)
    with tmx.cpu():
        tit = _iter(tmx)
    jm = jmx.mod.BucketingModule(_sym_gen(jmx, fused),
                                 default_bucket_key=jit.default_bucket_key,
                                 context=jmx.cpu())
    jm.bind(jit.provide_data, jit.provide_label)
    cur = jm._curr_module
    rng = np.random.RandomState(0)
    draws = {n: jmx.nd.array(rng.uniform(-0.3, 0.3,
                                         cur._exec.arg_dict[n].shape)
                             .astype(np.float32))
             for n in cur._param_names}
    jm.init_params(initializer=None, arg_params=draws, aux_params={})
    jm.init_optimizer(optimizer=optimizer, optimizer_params=opt_params)
    tm = tmx.mod.BucketingModule(_sym_gen(tmx, fused),
                                 default_bucket_key=tit.default_bucket_key,
                                 context=tmx.cpu())
    tm.bind(tit.provide_data, tit.provide_label)
    args, auxs = jm.get_params()
    load_module_params(tm, {n: a.asnumpy() for n, a in args.items()},
                       {n: a.asnumpy() for n, a in auxs.items()})
    tm.init_optimizer(optimizer=optimizer, optimizer_params=opt_params)
    return jm, tm, jit, tit


@pytest.mark.parametrize("fused,optimizer,opt_params", [
    (False, "sgd", {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-4}),
    (True, "adam", {"learning_rate": 0.02}),
])
def test_bucketing_module_per_batch(fused, optimizer, opt_params):
    jm, tm, jit, tit = _modules(fused, optimizer, opt_params)
    jmet, tmet = jmx.metric.Perplexity(None), tmx.metric.Perplexity(None)
    n = 0
    for jb, tb in zip(jit, tit):
        assert jb.bucket_key == tb.bucket_key
        for m, b in ((jm, jb), (tm, tb)):
            m.forward_backward(b)
            m.update()
        jm.update_metric(jmet, jb.label)
        tm.update_metric(tmet, tb.label)
        _close(tm.get_outputs()[0].asnumpy(), jm.get_outputs()[0].asnumpy(),
               f"batch {n} output")
        targs, jargs = tm.get_params()[0], jm.get_params()[0]
        assert sorted(targs) == sorted(jargs)
        for k in jargs:
            _close(targs[k].asnumpy(), jargs[k].asnumpy(), f"batch {n} {k}")
        n += 1
        if n == 8:
            break
    assert len(tm._buckets) == len(jm._buckets) == 3
    _close(tmet.get()[1], jmet.get()[1], "perplexity")
    # one buffer a parameter (and a gradient) across the buckets
    for name in tm._buckets[6]._param_names:
        ptrs = {m._exec.arg_dict[name]._data.data_ptr()
                for m in tm._buckets.values()}
        grads = {m._exec.grad_dict[name]._data.data_ptr()
                 for m in tm._buckets.values()}
        assert len(ptrs) == 1 and len(grads) == 1, name
    upd = {id(m._updater) for m in tm._buckets.values()}
    assert len(upd) == 1


def test_bucketing_module_score_predict_and_switch():
    jm, tm, jit, tit = _modules(False, "sgd", {"learning_rate": 0.1})
    # score resets its iterator, which shuffles by the global seeds
    np.random.seed(3)
    random.seed(3)
    js = jm.score(jit, jmx.metric.Perplexity(None))
    np.random.seed(3)
    random.seed(3)
    with tmx.cpu():
        ts = tm.score(tit, tmx.metric.Perplexity(None))
    _close(ts[0][1], js[0][1], "score")
    # predict: one bucket's batches (the outputs are concatenated)
    np.random.seed(1)
    random.seed(1)
    sents = [[1, 2, 3, 4, 5, 6]] * 12
    jpi = jmx.rnn.BucketSentenceIter(sents, 6, buckets=[6], invalid_label=0)
    np.random.seed(1)
    random.seed(1)
    with tmx.cpu():
        tpi = tmx.rnn.BucketSentenceIter(sents, 6, buckets=[6],
                                         invalid_label=0)
        tp = tm.predict(tpi).asnumpy()
    _close(tp, jm.predict(jpi).asnumpy(), "predict")
    # prepare binds a bucket and keeps the current one
    with tmx.cpu():
        tit.reset()
    batch = next(b for b in tit if b.bucket_key != 6)
    cur = tm._curr_bucket_key
    tm._buckets.pop(batch.bucket_key, None)
    tm.prepare(batch)
    assert tm._curr_bucket_key == cur and batch.bucket_key in tm._buckets
    assert tm.data_shapes == tm._curr_module.data_shapes
    assert tm.output_names == jm.output_names
    assert tm.data_names == list(jm.data_names)


def test_bucketing_fit_with_checkpoints(tmp_path):
    """BaseModule.fit's checkpoints (PR 12's) through a BucketingModule:
    a resumed fit starts from the last commit's parameters."""
    with tmx.cpu():
        it = _iter(tmx)
        mod = tmx.mod.BucketingModule(_sym_gen(tmx, False),
                                      default_bucket_key=6,
                                      context=tmx.cpu())
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                initializer=tmx.init.Xavier(),
                checkpoint_dir=str(tmp_path))
        saved = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
        it.reset()
        again = tmx.mod.BucketingModule(_sym_gen(tmx, False),
                                        default_bucket_key=6,
                                        context=tmx.cpu())
        again.fit(it, num_epoch=2, optimizer="sgd",
                  optimizer_params={"learning_rate": 0.1},
                  initializer=tmx.init.Xavier(),
                  checkpoint_dir=str(tmp_path), resume=True)
    got = {n: a.asnumpy() for n, a in again.get_params()[0].items()}
    assert sorted(got) == sorted(saved)
    for n in saved:
        np.testing.assert_array_equal(got[n], saved[n])


def test_fused_bucketing_params_files_cross(tmp_path):
    """A bucketed FusedRNNCell model's checkpoint (symbol of the default
    bucket + params) written by either package loads into the other's
    BucketingModule and gives the same outputs."""
    jm, tm, jit, tit = _modules(True, "sgd", {"learning_rate": 0.1})
    batch_j = next(iter(jit))
    batch_t = next(iter(tit))
    jm.save_checkpoint(str(tmp_path / "jax"), 1)
    tm.save_checkpoint(str(tmp_path / "port"), 1)
    _, targs, tauxs = tmx.model.load_checkpoint(str(tmp_path / "jax"), 1)
    _, jargs, jauxs = jmx.model.load_checkpoint(str(tmp_path / "port"), 1)
    assert "lstm_parameters" in targs and "lstm_parameters" in jargs
    for n in targs:
        np.testing.assert_array_equal(targs[n].asnumpy(),
                                      jargs[n].asnumpy())
    tm.set_params(targs, tauxs)
    jm.set_params(jargs, jauxs)
    tm.forward(batch_t, is_train=False)
    jm.forward(batch_j, is_train=False)
    _close(tm.get_outputs()[0].asnumpy(), jm.get_outputs()[0].asnumpy(),
           "outputs from the other package's file")


# ---------------------------------------------------------------------------
# SequentialModule, PythonLossModule (tests/test_module_family.py's uses)
# ---------------------------------------------------------------------------

def _feature_sym(mx):
    data = mx.sym.Variable("data")
    return mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=16,
                                                   name="feat_fc"),
                             act_type="relu", name="feat_act")


def _head_sym(mx):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, num_hidden=3, name="head_fc")
    return mx.sym.SoftmaxOutput(fc, name="softmax")


def _nll_grad(scores, labels):
    s = scores.asnumpy()
    p = np.exp(s - s.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    lab = labels.asnumpy().astype(int)
    p[np.arange(len(lab)), lab] -= 1.0
    return p


def _seq(mx, kind, ctx):
    seq = mx.mod.SequentialModule()
    if kind == "softmax":
        seq.add(mx.mod.Module(_feature_sym(mx), label_names=None,
                              context=ctx))
        seq.add(mx.mod.Module(_head_sym(mx), context=ctx), take_labels=True)
    else:
        head = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                     name="fc")
        seq.add(mx.mod.Module(head, label_names=None, context=ctx))
        seq.add(mx.mod.PythonLossModule(grad_func=_nll_grad),
                take_labels=True)
    return seq


@pytest.mark.parametrize("kind", ["softmax", "pyloss"])
def test_sequential_module_against_jax(kind):
    """tests/test_module_family.py's chains (feature Module + softmax head
    Module; FullyConnected Module + PythonLossModule): 10 forward /
    backward / update steps from the same parameters, outputs and every
    parameter within RTOL after each."""
    rng = np.random.RandomState(2)
    ni = 10 if kind == "softmax" else 5
    x = rng.normal(size=(8, ni)).astype(np.float32)
    w = rng.normal(size=(3, ni)).astype(np.float32)
    y = (x @ w.T).argmax(1).astype(np.float32)
    mods = {}
    for name, mx, ctx in (("jax", jmx, jmx.cpu()), ("port", tmx, tmx.cpu())):
        with mx.NameManager():
            seq = _seq(mx, kind, ctx)
        seq.bind(data_shapes=[("data", (8, ni))],
                 label_shapes=[("softmax_label", (8,))])
        mods[name] = seq
    jmx.random.seed(0)
    mods["jax"].init_params(jmx.init.Xavier())
    args, auxs = mods["jax"].get_params()
    with tmx.cpu():
        targs = {n: tmx.nd.array(a.asnumpy()) for n, a in args.items()}
    for m in mods["port"]._modules:
        m.init_params(arg_params=targs, aux_params={}, allow_missing=True,
                      allow_extra=True, initializer=None)
    mods["port"].params_initialized = True
    for m in mods.values():
        m.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": 0.1})
    batches = {"jax": jmx.io.DataBatch(data=[jmx.nd.array(x)],
                                       label=[jmx.nd.array(y)])}
    with tmx.cpu():
        batches["port"] = tmx.io.DataBatch(data=[tmx.nd.array(x)],
                                           label=[tmx.nd.array(y)])
    for step in range(10):
        for name, m in mods.items():
            m.forward(batches[name], is_train=True)
            m.backward()
            m.update()
        _close(mods["port"].get_outputs()[0].asnumpy(),
               mods["jax"].get_outputs()[0].asnumpy(), f"step {step} out")
        ta, ja = mods["port"].get_params()[0], mods["jax"].get_params()[0]
        assert sorted(ta) == sorted(ja)
        for n in ja:
            _close(ta[n].asnumpy(), ja[n].asnumpy(), f"step {step} {n}")
    if kind == "softmax":
        jmet, tmet = jmx.metric.Accuracy(), tmx.metric.Accuracy()
        mods["jax"].update_metric(jmet, [jmx.nd.array(y)])
        with tmx.cpu():
            mods["port"].update_metric(tmet, [tmx.nd.array(y)])
        assert tmet.get() == jmet.get()
        assert mods["port"].output_shapes == mods["jax"].output_shapes
    else:
        g = mods["port"]._modules[1].get_input_grads()[0]
        assert g.context == tmx.cpu()


def test_sequential_module_fit_and_score():
    """tests/test_module_family.py::test_sequential_module_fit on the
    port: fit over NDArrayIter, then score above the same bar."""
    rng = np.random.RandomState(1)
    x = rng.normal(size=(32, 6)).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.float32)
    with tmx.cpu():
        it = tmx.io.NDArrayIter(x, y, batch_size=8,
                                label_name="softmax_label")
        seq = tmx.mod.SequentialModule()
        seq.add(tmx.mod.Module(_feature_sym(tmx), label_names=None,
                               context=tmx.cpu()))
        seq.add(tmx.mod.Module(_head_sym(tmx), context=tmx.cpu()),
                take_labels=True)
        tmx.random.seed(0)
        seq.fit(it, num_epoch=4, optimizer_params={"learning_rate": 0.2})
        score = seq.score(it, tmx.metric.Accuracy())
    assert score[0][1] > 0.6
    with pytest.raises(tmx.MXNetError):
        seq.add(tmx.mod.Module(_head_sym(tmx)), bogus=True)
    with pytest.raises(tmx.MXNetError):
        tmx.mod.SequentialModule().bind([("data", (1, 2))],
                                        shared_module=seq)


def test_python_module_defaults():
    m = tmx.mod.PythonModule(["data"], ["softmax_label"], ["out"],
                             logger=logging)
    m.bind([("data", (4, 3))], [("softmax_label", (4,))])
    assert m.output_shapes == [("out", (4, 3))]
    assert m.get_params() == ({}, {})
    m.init_params()
    m.init_optimizer()
    assert m.params_initialized and m.optimizer_initialized
    loss = tmx.mod.PythonLossModule()
    loss.bind([("data", (4, 3))], [("softmax_label", (4,))])
    with tmx.cpu():
        loss.forward(tmx.io.DataBatch([tmx.nd.ones((4, 3))],
                                      [tmx.nd.zeros((4,))]), is_train=True)
    with pytest.raises(tmx.MXNetError):
        loss.backward()
    with pytest.raises(tmx.MXNetError):
        tmx.mod.PythonLossModule(grad_func=3)
