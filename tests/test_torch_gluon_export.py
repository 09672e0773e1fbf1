"""Gluon's files and helpers across the two packages, on the CPU.

- ``HybridBlock.export`` in each package, read by the other's
  ``SymbolBlock.imports`` (and the port's ``Module`` through
  ``model.load_checkpoint``): the same outputs from the same input
  (rtol 1e-5 / atol 1e-6), BatchNorm's statistics carried as ``aux:``.
- ``Trainer.load_states`` on a file the JAX package's ``save_states``
  wrote, then one more step matching the JAX Trainer's (rtol 1e-5 /
  atol 1e-7); and a fresh Trainer continuing from the port's own file.
- ``gluon.utils``: split_data, split_and_load (one context),
  clip_global_norm, check_sha1, download of a ``file://`` URL.
- ``convert.load_gluon_params`` / ``gluon_params_to_numpy`` over a
  ``SymbolBlock``.
- What the Trainer and ``fused_fit`` still refuse, naming the ROADMAP
  item.
"""
import hashlib

import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.parallel.planner import AUTO_KNOB_VARS
from mxnet_tpu import gluon as jgluon
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu, gluon as tgluon
from mxnet_tpu_torch.convert import gluon_params_to_numpy, load_gluon_params


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


CPU = cpu()
TOL = dict(rtol=1e-5, atol=1e-6)


def _net(g):
    net = g.nn.HybridSequential(prefix="ex_")
    with net.name_scope():
        net.add(g.nn.Conv2D(4, 3, padding=1), g.nn.BatchNorm(),
                g.nn.Activation("relu"), g.nn.GlobalAvgPool2D(),
                g.nn.Dense(5))
    return net


def _x():
    return np.random.RandomState(0).standard_normal((2, 3, 6, 6)).astype(
        np.float32)


def _trained_stats(mx, net, kw):
    """One training call, so the moving statistics are not the init's."""
    with mx.autograd.record():
        net(mx.nd.array(_x() * 2 + 1, **kw))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_export_is_read_by_the_other_package(tmp_path, writer):
    x = _x()
    if writer == "jax":
        net = _net(jgluon)
        net.initialize(jmx.init.Xavier())
        net.hybridize()
        net(jmx.nd.array(x))
        _trained_stats(jmx, net, {})
        want = net(jmx.nd.array(x)).asnumpy()
    else:
        net = _net(tgluon)
        net.initialize(tmx.init.Xavier(), ctx=CPU)
        net.hybridize()
        net(tmx.nd.array(x, ctx=CPU))
        _trained_stats(tmx, net, {"ctx": CPU})
        want = net(tmx.nd.array(x, ctx=CPU)).asnumpy()
    prefix = str(tmp_path / "model")
    net.export(prefix, epoch=3)
    sym_file, param_file = prefix + "-symbol.json", prefix + "-0003.params"
    loaded = (jmx.nd.load(param_file) if writer == "port"
              else tmx.nd.load(param_file))
    assert any(k.startswith("aux:") and k.endswith("running_var")
               for k in loaded)
    assert all(k.startswith(("arg:", "aux:")) for k in loaded)
    for mx, kw in ((jmx, {}), (tmx, {"ctx": CPU})):
        block = mx.gluon.SymbolBlock.imports(sym_file, ["data"],
                                             param_file, **kw)
        got = block(mx.nd.array(x, **kw)).asnumpy()
        np.testing.assert_allclose(got, want, err_msg=mx.__name__, **TOL)
    # the port's Module runs the exported pair too
    sym, args, auxs = tmx.model.load_checkpoint(prefix, 3)
    mod = tmx.mod.Module(sym, data_names=["data"], label_names=None,
                         context=CPU)
    mod.bind(data_shapes=[("data", x.shape)], for_training=False)
    mod.set_params(args, auxs)
    mod.forward(tmx.io.DataBatch([tmx.nd.array(x, ctx=CPU)]), is_train=False)
    np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(), want, **TOL)


def test_symbol_block_params_carry_and_train(tmp_path):
    x = _x()
    jnet = _net(jgluon)
    jnet.initialize(jmx.init.Xavier())
    jnet.hybridize()
    jnet(jmx.nd.array(x))
    prefix = str(tmp_path / "sb")
    jnet.export(prefix)
    jblock = jgluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                        prefix + "-0000.params")
    tblock = tgluon.SymbolBlock(tmx.sym.load(prefix + "-symbol.json"),
                                [tmx.sym.var("data")])
    assert list(tblock.collect_params()) == list(jblock.collect_params())
    load_gluon_params(tblock, {n: p.data().asnumpy() for n, p in
                               jblock.collect_params().items()}, ctx=CPU)
    null = [n for n, p in tblock.collect_params().items()
            if p.grad_req == "null"]
    assert null and all(n.endswith(("running_mean", "running_var"))
                        for n in null)
    for n, a in gluon_params_to_numpy(tblock).items():
        np.testing.assert_array_equal(
            a, jblock.collect_params()[n].data().asnumpy())
    res = []
    for mx, kw, b in ((jmx, {}, jblock), (tmx, {"ctx": CPU}, tblock)):
        xb = mx.nd.array(x, **kw)
        with mx.autograd.record():
            loss = (b(xb) ** 2).sum()
        loss.backward()
        res.append({n: p.grad().asnumpy() for n, p in
                    b.collect_params().items() if p.grad_req != "null"})
    for n in res[0]:
        np.testing.assert_allclose(res[1][n], res[0][n], err_msg=n,
                                   rtol=1e-5, atol=1e-5)


def _dense(g):
    return g.nn.Dense(3, in_units=4, prefix="st_")


@pytest.mark.parametrize("opt,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01})])
def test_trainer_load_states_across_packages(tmp_path, opt, params):
    rng = np.random.RandomState(1)
    xs = [rng.standard_normal((5, 4)).astype(np.float32) for _ in range(3)]
    jnet = _dense(jgluon)
    jnet.initialize(jmx.init.Xavier())
    jtr = jgluon.Trainer(jnet.collect_params(), opt, dict(params))

    def step(mx, net, tr, x, kw):
        with mx.autograd.record():
            loss = (net(mx.nd.array(x, **kw)) ** 2).sum()
        loss.backward()
        tr.step(5)

    step(jmx, jnet, jtr, xs[0], {})
    step(jmx, jnet, jtr, xs[1], {})
    path = str(tmp_path / "j.states")
    jtr.save_states(path)
    mid = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    step(jmx, jnet, jtr, xs[2], {})

    tnet = _dense(tgluon)
    load_gluon_params(tnet, mid, ctx=CPU)
    ttr = tgluon.Trainer(tnet.collect_params(), opt, dict(params))
    ttr.load_states(path)
    step(tmx, tnet, ttr, xs[2], {"ctx": CPU})
    for n, p in jnet.collect_params().items():
        np.testing.assert_allclose(tnet.collect_params()[n].data().asnumpy(),
                                   p.data().asnumpy(), rtol=1e-5, atol=1e-7)
    # and the port's own file: a fresh Trainer continues as this one
    back = str(tmp_path / "t.states")
    ttr.save_states(back)
    tnet2 = _dense(tgluon)
    load_gluon_params(tnet2, gluon_params_to_numpy(tnet), ctx=CPU)
    ttr2 = tgluon.Trainer(tnet2.collect_params(), opt, dict(params))
    ttr2.load_states(back)
    step(tmx, tnet2, ttr2, xs[0], {"ctx": CPU})
    step(tmx, tnet, ttr, xs[0], {"ctx": CPU})
    for n, a in gluon_params_to_numpy(tnet).items():
        np.testing.assert_array_equal(gluon_params_to_numpy(tnet2)[n], a)


def test_trainer_refuses_what_is_not_ported():
    """Several contexts, the kvstore and 2-bit compression are ported
    (tests/test_torch_gluon_multi.py), and so are fused_fit's checkpoints
    and float16 (tests/test_torch_checkpoint.py, test_torch_amp.py); what
    is not raises at first use: another compression type, a distributed
    kvstore (ROADMAP queue 1 item 16), a dtype no trainer takes."""
    net = _dense(tgluon)
    net.initialize(ctx=[CPU, tmx.cpu(1)])
    tr = tgluon.Trainer(net.collect_params(), "sgd",
                        compression_params={"type": "1bit"})
    with pytest.raises(tmx.MXNetError, match="only 2bit"):
        tr.step(1)
    tr = tgluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync")
    with pytest.raises(tmx.MXNetError, match="item 16"):
        tr.step(1)
    data = [(tmx.nd.array(np.ones((2, 4), np.float32), ctx=CPU),
             tmx.nd.array(np.zeros(2, np.float32), ctx=CPU))]
    loss = tgluon.loss.L2Loss()
    with pytest.raises(tmx.MXNetError, match="float16"):
        tgluon.trainer.fused_fit(net, loss, data, 1, contexts=[CPU],
                                 dtype="float64")


def test_gluon_utils_match_jax(tmp_path):
    from mxnet_tpu.gluon import utils as jutils
    from mxnet_tpu_torch.gluon import utils as tutils
    x = np.arange(30, dtype=np.float32).reshape(6, 5)
    for even, n in ((True, 3), (False, 4)):
        js = jutils.split_data(jmx.nd.array(x), n, 0, even_split=even)
        ts = tutils.split_data(tmx.nd.array(x, ctx=CPU), n, 0,
                               even_split=even)
        assert [a.asnumpy().tolist() for a in ts] == \
            [a.asnumpy().tolist() for a in js]
    with pytest.raises(ValueError, match="evenly"):
        tutils.split_data(tmx.nd.array(x, ctx=CPU), 4)
    loaded = tutils.split_and_load(x, [CPU])
    assert len(loaded) == 1 and loaded[0].context == CPU
    np.testing.assert_array_equal(loaded[0].asnumpy(), x)
    arrays = [np.full((2, 2), 3.0, np.float32), np.full((3,), 4.0,
                                                        np.float32)]
    jarr = [jmx.nd.array(a) for a in arrays]
    tarr = [tmx.nd.array(a, ctx=CPU) for a in arrays]
    jn = jutils.clip_global_norm(jarr, 5.0)
    tn = tutils.clip_global_norm(tarr, 5.0)
    np.testing.assert_allclose(tn, jn, rtol=1e-6)
    for t, j in zip(tarr, jarr):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6)
    src = tmp_path / "blob.bin"
    src.write_bytes(b"gluon" * 100)
    sha = hashlib.sha1(src.read_bytes()).hexdigest()
    assert tutils.check_sha1(str(src), sha)
    got = tutils.download("file://" + str(src), path=str(tmp_path / "d"),
                          sha1_hash=sha)
    assert open(got, "rb").read() == src.read_bytes()
    with pytest.raises(tmx.MXNetError, match="file://"):
        tutils.download("https://example.invalid/x.bin",
                        path=str(tmp_path / "e"))
