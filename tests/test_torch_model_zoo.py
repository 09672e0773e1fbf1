"""The port's Gluon model zoo against the JAX package's, on the CPU.

- Every name of the JAX ``_models`` table builds, applied to a Symbol
  under fresh ``NameManager``s, the same Symbol in both packages: op
  sequence and node names, parsed attrs, arguments, aux states and the
  inferred shapes (exact).
- ``resnet18_v1`` hybridized at batch 2, 32 x 32: the JAX net's weights
  carried in by name, then the forward (rtol 1e-5 / atol 1e-6) and 3
  ``Trainer`` steps (SGD with momentum; BatchNorm on its moving
  statistics, see the test) held against the JAX net's, hybridized too:
  losses and parameters rtol 1e-4 / atol 1e-6.
- ``pretrained=True`` through a ``file://`` ``MXNET_GLUON_REPO`` holding
  the zip of a ``.params`` file the JAX package's ``save_parameters``
  wrote (its sha1 registered for the test, as the JAX package's own
  model-store tests do).

``examples/gluon_cifar.py`` in both packages is
tests/test_torch_gluon_cifar.py (a file of its own, so that the
scheduler's file groups spread it).
"""
import hashlib
import os
import zipfile

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu, gluon as tgluon
from mxnet_tpu_torch.convert import load_gluon_params
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.gluon.model_zoo.vision import model_store

CPU = cpu()
STEP_TOL = dict(rtol=1e-4, atol=1e-6)


def _ops(symbol):
    return [n for n in symbol._topo() if n.op is not None]


def test_the_zoo_tables_match():
    assert sorted(tvision._models) == sorted(jvision._models)
    assert len(tvision._models) == 34
    assert model_store._model_sha1 == \
        jvision.model_store._model_sha1


@pytest.mark.parametrize("name", sorted(jvision._models))
def test_zoo_symbol_matches_jax(name):
    with jmx.base.NameManager():
        js = jvision.get_model(name)(jmx.sym.Variable("data"))
    with tmx.NameManager():
        ts = tvision.get_model(name)(tmx.sym.Variable("data"))
    a, b = _ops(ts), _ops(js)
    assert [n.op.name for n in a] == [n.op.name for n in b]
    assert [n.name for n in a] == [n.name for n in b]
    for x, y in zip(a, b):
        assert x.op.parse_attrs(x.attrs) == \
            tmx.ops.registry.get_op(y.op.name).parse_attrs(y.attrs), x.name
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    size = 299 if name == "inceptionv3" else 224
    shapes = dict(data=(1, 3, size, size))
    got, want = ts.infer_shape(**shapes), js.infer_shape(**shapes)
    for g, w in zip(got, want):
        assert [tuple(s) for s in g] == [tuple(s) for s in w]


def _resnet18(g):
    return g.model_zoo.vision.resnet18_v1(classes=10, prefix="r18_")


def test_resnet18_v1_hybridized_trains_as_jax():
    """resnet18_v1 hybridized at batch 2, 32 x 32, both packages from the
    same weights: the forward, then 3 ``Trainer`` steps (SGD, momentum
    0.9). The steps record with ``train_mode=False``, so BatchNorm
    normalises with its moving statistics: with batch statistics a batch
    of 2 at 32 x 32 leaves the last stage's BatchNorm 2 values a channel,
    an ill-conditioned step that the JAX package does not reproduce
    itself (its float64 run, whose BatchNorm statistics accumulate in
    float32, and the port's part after one step by 10% in the loss).
    Training-mode BatchNorm, eager and hybridized, is held in
    tests/test_torch_gluon_layers.py."""
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    y = np.array([3, 7], np.float32)
    jnet = _resnet18(jgluon)
    jmx.random.seed(1)
    jnet.initialize(jmx.init.Xavier(magnitude=2.0))
    jnet.hybridize()                # one compiled program, deferred shapes
    jnet(jmx.nd.array(x))
    tnet = _resnet18(tgluon)
    load_gluon_params(tnet, {n: p.data().asnumpy() for n, p in
                             jnet.collect_params().items()}, ctx=CPU)
    res = []
    for mx, kw, net in ((jmx, {}, jnet), (tmx, {"ctx": CPU}, tnet)):
        net.hybridize()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.05, "momentum": 0.9})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        xb, yb = mx.nd.array(x, **kw), mx.nd.array(y, **kw)
        seen = [net(xb).asnumpy()]
        for _ in range(3):
            with mx.autograd.record(train_mode=False):
                loss = loss_fn(net(xb), yb).mean()
            loss.backward()
            trainer.step(1)
            seen.append(loss.asnumpy())
        res.append((seen, {n: p.data().asnumpy() for n, p in
                           net.collect_params().items()}))
    (jseen, jparams), (tseen, tparams) = res
    np.testing.assert_allclose(tseen[0], jseen[0], rtol=1e-5, atol=1e-6)
    for g, w in zip(tseen[1:], jseen[1:]):
        np.testing.assert_allclose(g, w, **STEP_TOL)
    assert sorted(tparams) == sorted(jparams)
    for n in jparams:
        np.testing.assert_allclose(tparams[n], jparams[n], err_msg=n,
                                   **STEP_TOL)
    assert tnet._cached_graph


def _sha1(path):
    return hashlib.sha1(open(path, "rb").read()).hexdigest()


def test_pretrained_through_a_file_repo(tmp_path, monkeypatch):
    x = np.random.RandomState(2).uniform(0, 1, (1, 3, 32, 32)).astype(
        np.float32)
    src = jvision.resnet18_v1()
    src.initialize(jmx.init.Xavier())
    src.hybridize()
    want = src(jmx.nd.array(x)).asnumpy()
    params = tmp_path / "resnet18_v1-00000000.params"
    src.save_parameters(str(params))
    repo = tmp_path / "repo" / "gluon" / "models"
    repo.mkdir(parents=True)
    with zipfile.ZipFile(repo / "resnet18_v1-00000000.zip", "w") as zf:
        zf.write(params, "resnet18_v1-00000000.params")
    monkeypatch.setitem(model_store._model_sha1, "resnet18_v1",
                        _sha1(str(params)))
    monkeypatch.setattr(model_store, "short_hash", lambda n: "00000000")
    monkeypatch.setenv("MXNET_GLUON_REPO",
                       "file://" + str(tmp_path / "repo") + "/")
    root = tmp_path / "cache"
    net = tvision.resnet18_v1(pretrained=True, root=str(root), ctx=CPU)
    assert os.path.exists(root / "models" / "resnet18_v1-00000000.params")
    np.testing.assert_allclose(net(tmx.nd.array(x, ctx=CPU)).asnumpy(),
                               want, rtol=1e-5, atol=1e-6)
    # a file that fails its published sha1 is refused
    monkeypatch.setitem(model_store._model_sha1, "resnet18_v1", "0" * 40)
    with pytest.raises(tmx.MXNetError, match="sha1"):
        tvision.resnet18_v1(pretrained=True, root=str(tmp_path / "c2"),
                            ctx=CPU)
    # no local copy and no repo: raises (nothing is fetched)
    monkeypatch.delenv("MXNET_GLUON_REPO")
    with pytest.raises(tmx.MXNetError, match="resnet18_v1"):
        tvision.resnet18_v1(pretrained=True, root=str(tmp_path / "c3"),
                            ctx=CPU)
