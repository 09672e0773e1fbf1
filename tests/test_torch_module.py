"""The port's Module training against the JAX package's, on the CPU.

10 forward_backward + update steps of the MLP and LeNet of
tests/test_train_accuracy.py, unshuffled, from the JAX package's Xavier
initial parameters carried across (``convert.load_module_params``), for
SGD with momentum and weight decay, Adam, and SGD under a
FactorScheduler: every parameter within RTOL of its tensor's largest
magnitude after the 10 steps (Adam: up to 2% of a tensor's elements to
1% of lr x STEPS instead, see ``_close_adam``), the training metrics
within RTOL. Then
``fit`` over two epochs, checkpoints written by either package and
loaded by the other, optimizer states saved and reloaded, the metrics
and NDArrayIter's batches under one ``np.random`` seed. Trajectories,
not accuracy bars.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import load_module_params, \
    module_params_to_numpy

from test_torch_symbol import lenet, mlp

RTOL = 1e-4
STEPS = 10


@pytest.fixture(autouse=True)
def _keep_global_rng():
    """These tests seed np.random (NDArrayIter shuffles by it) and the JAX
    package's global key; other test files in the same process must find
    both as they were."""
    np_state, jax_state = np.random.get_state(), jmx.random.get_state()
    yield
    np.random.set_state(np_state)
    jmx.random.set_state(jax_state)


def _data(which, n, seed=0):
    rng = np.random.RandomState(seed)
    shape = (n, 64) if which == "mlp" else (n, 1, 16, 16)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.float32)
    return x, y


def _lenet16(mx):
    """tests/test_train_accuracy.py's LeNet layout at 16 x 16 inputs."""
    return lenet(mx)


BUILD = {"mlp": mlp, "lenet": _lenet16}


def _close(got, want, what, tol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1e-30, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _close_adam(got, want, what):
    """Adam divides each gradient element by its own root mean square, so
    an element whose gradient is at rounding level in one package and not
    the other (a ReLU a rounding away from 0 upstream) takes a step of up
    to lr there: such elements (measured: 0-1.2% of a tensor, at most 2%
    allowed) are held to
    1% of the largest displacement 10 steps of Adam allow (lr x STEPS),
    all others to RTOL of the tensor's largest magnitude."""
    err = np.abs(np.asarray(got, np.float64) - want)
    off = err > RTOL * np.abs(want).max()
    assert off.mean() <= 0.02, f"{what}: {off.sum()} of {off.size}"
    lr = OPTIMIZERS["adam"][1]["learning_rate"]
    assert err.max() <= 0.01 * lr * STEPS, f"{what}: {err.max()}"


def _pair(which, batch):
    with jmx.base.NameManager():
        js = BUILD[which](jmx)
    with tmx.NameManager():
        ts = BUILD[which](tmx)
    x, y = _data(which, batch * STEPS)
    jit = jmx.io.NDArrayIter(x, y, batch, label_name="softmax_label")
    tit = tmx.io.NDArrayIter(x, y, batch, label_name="softmax_label")
    jmod = jmx.mod.Module(js, context=jmx.cpu())
    tmod = tmx.mod.Module(ts, context=tmx.cpu())
    jmod.bind(data_shapes=jit.provide_data, label_shapes=jit.provide_label)
    tmod.bind(data_shapes=tit.provide_data, label_shapes=tit.provide_label)
    jmx.random.seed(0)
    jmod.init_params(jmx.init.Xavier())
    args, aux = jmod.get_params()
    load_module_params(tmod, {k: v.asnumpy() for k, v in args.items()},
                       {k: v.asnumpy() for k, v in aux.items()})
    return jmod, tmod, jit, tit


OPTIMIZERS = {
    "sgd_momentum": ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    "adam": ("adam", dict(learning_rate=0.01, wd=1e-3)),
    "sgd_factor": ("sgd", dict(learning_rate=0.2, momentum=0.5)),
}


def _opt_params(name, pkg):
    kind, params = OPTIMIZERS[name]
    params = dict(params)
    if name == "sgd_factor":
        params["lr_scheduler"] = pkg.lr_scheduler.FactorScheduler(
            step=3, factor=0.5)
    return kind, params


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("which", ["mlp", "lenet"])
def test_ten_steps_match_jax(which, opt):
    jmod, tmod, jit, tit = _pair(which, batch=8)
    start, _ = module_params_to_numpy(tmod)
    for mod, pkg in ((jmod, jmx), (tmod, tmx)):
        kind, params = _opt_params(opt, pkg)
        mod.init_optimizer(optimizer=kind, optimizer_params=params)
    jm = jmx.metric.create(["acc", "ce"])
    tm = tmx.metric.create(["acc", "ce"])
    for jb, tb in zip(jit, tit):
        for mod, batch, m in ((jmod, jb, jm), (tmod, tb, tm)):
            mod.forward_backward(batch)
            mod.update()
            mod.update_metric(m, batch.label)
    jargs, jaux = jmod.get_params()
    targs, taux = module_params_to_numpy(tmod)
    assert sorted(targs) == sorted(jargs)
    for n, v in jargs.items():
        if opt == "adam":
            _close_adam(targs[n], v.asnumpy(), f"{which} {n}")
        else:
            _close(targs[n], v.asnumpy(), f"{which} {opt} {n}")
    (jn, jv), (tn, tv) = jm.get(), tm.get()
    assert jn == tn
    np.testing.assert_allclose(tv, jv, rtol=RTOL)
    # the weights moved: these are trajectories, not fixed points
    assert all(not np.array_equal(targs[n], start[n]) for n in targs)


def test_wd_mult_rule_and_symbol_multipliers():
    """Only *_weight and *_gamma decay by default; a Variable's
    lr_mult / wd_mult attrs override (set_lr_mult / set_wd_mult)."""
    with tmx.NameManager():
        w = tmx.sym.Variable("fc_weight", lr_mult=0.5, wd_mult=2.0)
        s = tmx.sym.FullyConnected(tmx.sym.Variable("data"), weight=w,
                                   num_hidden=3, name="fc")
        s = tmx.sym.FullyConnected(s, num_hidden=2, name="fc2")
    names = ["fc_weight", "fc_bias", "fc2_weight", "fc2_bias"]
    opt = tmx.optimizer.create("sgd", sym=s, learning_rate=1.0, wd=0.1,
                               param_idx2name=dict(enumerate(names)))
    assert [opt._get_lr(i) for i in range(4)] == [0.5, 1.0, 1.0, 1.0]
    assert [opt._get_wd(i) for i in range(4)] == \
        pytest.approx([0.2, 0.0, 0.1, 0.0])
    with jmx.base.NameManager():
        jw = jmx.sym.Variable("fc_weight", lr_mult=0.5, wd_mult=2.0)
        js = jmx.sym.FullyConnected(jmx.sym.Variable("data"), weight=jw,
                                    num_hidden=3, name="fc")
        js = jmx.sym.FullyConnected(js, num_hidden=2, name="fc2")
    jopt = jmx.optimizer.create("sgd", sym=js, learning_rate=1.0, wd=0.1,
                                param_idx2name=dict(enumerate(names)))
    assert [opt._get_wd(i) for i in range(4)] == \
        [jopt._get_wd(i) for i in range(4)]
    assert [opt._get_lr(i) for i in range(4)] == \
        [jopt._get_lr(i) for i in range(4)]


@pytest.mark.parametrize("sched", ["factor", "multifactor", "poly"])
def test_lr_schedulers_match_jax(sched):
    def make(pkg):
        m = pkg.lr_scheduler
        if sched == "factor":
            s = m.FactorScheduler(step=4, factor=0.7, stop_factor_lr=1e-3)
        elif sched == "multifactor":
            s = m.MultiFactorScheduler(step=[3, 7, 12], factor=0.5)
        else:
            return m.PolyScheduler(max_update=20, base_lr=0.3, pwr=2)
        s.base_lr = 0.3
        return s
    js, ts = make(jmx), make(tmx)
    assert [ts(i) for i in range(30)] == [js(i) for i in range(30)]


def test_fit_matches_jax_and_writes_loadable_checkpoints(tmp_path, caplog):
    jmod, tmod, jit, tit = _pair("mlp", batch=16)
    jargs, jaux = jmod.get_params()
    with tmx.NameManager():
        ts = mlp(tmx)
    tmod = tmx.mod.Module(ts, context=tmx.cpu())
    prefix = str(tmp_path / "mlp")
    params = dict(learning_rate=0.1, momentum=0.9)
    jmod.fit(jit, num_epoch=2, optimizer="sgd",
             optimizer_params=params, arg_params=jargs, aux_params=jaux,
             force_init=True, eval_data=jit)
    with caplog.at_level(logging.INFO):
        tmod.fit(tit, num_epoch=2, optimizer="sgd", optimizer_params=params,
                 arg_params={k: tmx.nd.array(v.asnumpy(), ctx=tmx.cpu())
                             for k, v in jargs.items()},
                 aux_params={}, eval_data=tit,
                 batch_end_callback=tmx.callback.Speedometer(16, 2),
                 epoch_end_callback=tmx.callback.do_checkpoint(prefix))
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("Epoch[1] Train-accuracy=") for m in msgs)
    assert any(m.startswith("Epoch[1] Validation-accuracy=") for m in msgs)
    assert any("Time cost=" in m for m in msgs)
    targs, _ = module_params_to_numpy(tmod)
    for n, v in jmod.get_params()[0].items():
        _close(targs[n], v.asnumpy(), f"fit {n}")
    # the port's checkpoint loads in the JAX package, and back
    sym, args, aux = jmx.model.load_checkpoint(prefix, 2)
    assert sym.list_arguments() == ts.list_arguments()
    for n, v in args.items():
        np.testing.assert_array_equal(v.asnumpy(), targs[n])
    jprefix = str(tmp_path / "jax")
    jmx.model.save_checkpoint(jprefix, 3, jmod.symbol, *jmod.get_params())
    sym2, args2, _ = tmx.model.load_checkpoint(jprefix, 3)
    assert sym2.tojson() == jmod.symbol.tojson()
    for n, v in jmod.get_params()[0].items():
        np.testing.assert_array_equal(args2[n].asnumpy(), v.asnumpy())
    # Module.load from the JAX package's files, then predict
    m3 = tmx.mod.Module.load(jprefix, 3, context=tmx.cpu())
    m3.bind(data_shapes=tit.provide_data, for_training=False)
    pred = m3.predict(tit)
    jpred = jmod.predict(jit)
    _close(pred.asnumpy(), jpred.asnumpy(), "predict")
    score = dict(m3.score(tit, "acc"))["accuracy"]
    assert score == pytest.approx(dict(jmod.score(jit, "acc"))["accuracy"])


def test_optimizer_states_save_and_reload(tmp_path):
    """A module that reloads the saved momentum continues exactly as the
    one that kept it."""
    _, a, _, it = _pair("mlp", batch=8)
    params = dict(learning_rate=0.1, momentum=0.9)
    a.init_optimizer(optimizer="sgd", optimizer_params=params)
    batches = list(it)
    for b in batches[:3]:
        a.forward_backward(b)
        a.update()
    fname = str(tmp_path / "opt.states")
    a.save_optimizer_states(fname)
    args, aux = a.get_params()
    with tmx.NameManager():
        b_mod = tmx.mod.Module(mlp(tmx), context=tmx.cpu())
    b_mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    b_mod.set_params({k: v.copy() for k, v in args.items()}, aux)
    b_mod.init_optimizer(optimizer="sgd", optimizer_params=params)
    b_mod.load_optimizer_states(fname)
    b_mod._optimizer._index_update_count = dict(
        a._optimizer._index_update_count)
    for b in batches[3:6]:
        for m in (a, b_mod):
            m.forward_backward(b)
            m.update()
    pa, pb = module_params_to_numpy(a)[0], module_params_to_numpy(b_mod)[0]
    for n in pa:
        np.testing.assert_array_equal(pa[n], pb[n])


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_batches_match_jax(handle):
    rng = np.random.RandomState(3)
    x = rng.rand(23, 3).astype(np.float32)
    y = np.arange(23).astype(np.float32)
    out = {}
    for pkg in (jmx, tmx):
        np.random.seed(11)
        it = pkg.io.NDArrayIter(x, y, batch_size=5, shuffle=True,
                                last_batch_handle=handle)
        seq = []
        for _ in range(2):
            for b in it:
                seq.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                            b.pad))
            it.reset()
        out[pkg] = (seq, it.provide_data, it.provide_label)
    (js, jd, jl), (ts, td, tl) = out[jmx], out[tmx]
    assert len(js) == len(ts)
    for (a, b, c), (d, e, f) in zip(js, ts):
        np.testing.assert_array_equal(d, a)
        np.testing.assert_array_equal(e, b)
        assert f == c
    assert [tuple(d) for d in td] == [tuple(d) for d in jd]
    assert [tuple(d) for d in tl] == [tuple(d) for d in jl]


@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_holds_each_source_once(shuffle):
    """The iterator keeps one host tensor a source (shuffled rows taken
    once), and describes its batches by those tensors: float64 sources
    are held, batched and described as float32."""
    x = np.arange(30, dtype=np.float64).reshape(10, 3)
    y = np.arange(10, dtype=np.float64)
    np.random.seed(4)
    it = tmx.io.NDArrayIter(x, y, batch_size=4, shuffle=shuffle)
    held = [v for _, v in it.data + it.label]
    assert all(isinstance(v, torch.Tensor) for v in held)
    assert not any(isinstance(v, np.ndarray) and v.ndim > 1
                   for v in vars(it).values())
    assert [v.dtype for v in held] == [torch.float32, torch.float32]
    assert [(d.shape, d.dtype) for d in it.provide_data] == \
        [((4, 3), np.float32)]
    assert [(d.shape, d.dtype) for d in it.provide_label] == \
        [((4,), np.float32)]
    b = next(iter(it))
    assert b.data[0]._data.dtype == torch.float32
    np.testing.assert_array_equal(b.data[0].asnumpy(), x[it.idx[:4]])


def test_host_batches_and_synthetic_mnist():
    it = tmx.io.NDArrayIter(np.zeros((4, 2)), np.zeros(4), 2)
    b = next(iter(it))
    assert b.data[0]._data.device.type == "cpu"
    assert b.data[0]._data.dtype.is_floating_point
    j = jmx.io.MNISTIter(batch_size=16, shuffle=False, synthetic_size=64,
                         silent=True)
    t = tmx.io.MNISTIter(batch_size=16, shuffle=False, synthetic_size=64,
                         silent=True)
    for jb, tb in zip(j, t):
        np.testing.assert_array_equal(tb.data[0].asnumpy(),
                                      jb.data[0].asnumpy())
        np.testing.assert_array_equal(tb.label[0].asnumpy(),
                                      jb.label[0].asnumpy())


def test_csv_and_resize_iters(tmp_path):
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    np.savetxt(tmp_path / "d.csv", x, delimiter=",")
    np.savetxt(tmp_path / "l.csv", np.arange(8), delimiter=",")
    seqs = []
    for pkg in (jmx, tmx):
        it = pkg.io.CSVIter(data_csv=str(tmp_path / "d.csv"),
                            data_shape=(3,), label_csv=str(tmp_path / "l.csv"),
                            batch_size=3)
        r = pkg.io.ResizeIter(it, 5)
        seqs.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                     for b in r])
    for (a, b, c), (d, e, f) in zip(*seqs):
        np.testing.assert_array_equal(d, a)
        np.testing.assert_array_equal(e, b)
        assert c == f
    assert len(seqs[1]) == 5


METRICS = [("acc", {}), ("top_k_accuracy", {"top_k": 3}), ("f1", {}),
           ("perplexity", {"ignore_label": None}), ("mae", {}), ("mse", {}),
           ("rmse", {}), ("ce", {}), ("nll_loss", {}), ("pearsonr", {}),
           ("loss", {})]


@pytest.mark.parametrize("name,kw", METRICS)
def test_metrics_match_jax(name, kw):
    rng = np.random.RandomState(0)
    classes = 2 if name == "f1" else 5
    preds, labels = [], []
    for _ in range(3):
        p = rng.dirichlet(np.ones(classes), 6).astype(np.float32)
        lab = rng.randint(0, classes, 6).astype(np.float32)
        if name in ("mae", "mse", "rmse", "pearsonr"):
            p = rng.rand(6).astype(np.float32)
            lab = rng.rand(6).astype(np.float32)
        preds.append(p)
        labels.append(lab)
    jm, tm = jmx.metric.create(name, **kw), tmx.metric.create(name, **kw)
    for p, lab in zip(preds, labels):
        jm.update([jmx.nd.array(lab)], [jmx.nd.array(p)])
        tm.update([tmx.nd.array(lab, ctx=tmx.cpu())],
                  [tmx.nd.array(p, ctx=tmx.cpu())])
    assert tm.get()[0] == jm.get()[0]
    np.testing.assert_allclose(tm.get()[1], jm.get()[1], rtol=1e-6)


def test_composite_metric_and_custom():
    def feval(label, pred):
        return float(np.abs(label - pred.argmax(1)).sum()), len(label)
    jm = jmx.metric.create(["acc", jmx.metric.np(feval)])
    tm = tmx.metric.create(["acc", tmx.metric.np(feval)])
    p = np.random.RandomState(1).rand(4, 3).astype(np.float32)
    lab = np.array([0, 1, 2, 1], np.float32)
    jm.update_dict({"softmax_label": jmx.nd.array(lab)},
                   {"softmax_output": jmx.nd.array(p)})
    tm.update_dict({"softmax_label": tmx.nd.array(lab, ctx=tmx.cpu())},
                   {"softmax_output": tmx.nd.array(p, ctx=tmx.cpu())})
    assert tm.get_name_value() == jm.get_name_value()


def test_unported_fit_options_raise():
    _, tmod, _, tit = _pair("mlp", batch=8)
    # several contexts and the fused fit are ported
    # (test_torch_module_multi.py); a checkpoint directory is not, fused
    # or per batch
    for kw, item in ((dict(steps_per_dispatch=4, checkpoint_dir="x"),
                      "item 14"),
                     (dict(checkpoint_dir="x"), "item 14")):
        with pytest.raises(tmx.MXNetError, match=item):
            tmod.fit(tit, num_epoch=1, **kw)
    with tmx.NameManager():
        s = mlp(tmx)
    with pytest.raises(tmx.MXNetError, match="item 8"):
        tmx.mod.Module(s, context=tmx.cpu(), group2ctxs={"a": tmx.cpu()})
    with pytest.raises(tmx.MXNetError, match="item 14"):
        tmx.callback.module_checkpoint(tmod, "p", manager="dir")
