"""Optimizer-state files across the two packages.

The port's ``Updater.get_states`` pickles under the JAX package's names
(``mxnet_tpu.ndarray.ndarray._from_numpy_reduce`` with a numpy argument,
``mxnet_tpu.optimizer.SGD`` / ``Adam`` with the JAX class's attribute
dict), so the JAX package's plain ``pickle.loads`` builds its own
NDArrays and optimizer; the port reads those names back as its own. For
each writer (``Module.save_optimizer_states``, ``gluon.Trainer.
save_states`` with and without a kvstore that updates, ``KVStore.
save_optimizer_states``) a file written by one package after two steps
is loaded by the other, which then takes the third step from the
writer's parameters: it must match the writer's own third step to 1e-6
of the tensor's largest magnitude.
"""
import pickle

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import load_module_params

from test_torch_symbol import mlp

RTOL = 1e-6
PKGS = {"jax": jmx, "torch": tmx}
DIRECTIONS = [("torch", "jax"), ("jax", "torch")]
OPTS = {"sgd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
        "adam": ("adam", {"learning_rate": 0.01, "wd": 1e-3})}


def _ctx(mx):
    return {"ctx": tmx.cpu()} if mx is tmx else {}


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    scale = max(1e-30, float(np.abs(want).max()))
    assert err <= RTOL * scale, f"{what}: {err} > {RTOL} * {scale}"


def _batches(n, batch=8, width=64, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal((batch, width)).astype(np.float32),
             rng.randint(0, 10, batch).astype(np.float32))
            for _ in range(n)]


# -- Module ------------------------------------------------------------------

def _module(mx, args, aux):
    with (jmx.base.NameManager() if mx is jmx else tmx.NameManager()):
        sym = mlp(mx)
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind(data_shapes=[("data", (8, 64))],
             label_shapes=[("softmax_label", (8,))])
    if mx is jmx:
        mod.init_params(arg_params={k: jmx.nd.array(v)
                                    for k, v in args.items()},
                        aux_params={k: jmx.nd.array(v)
                                    for k, v in aux.items()})
    else:
        load_module_params(mod, args, aux)
    kind, params = OPTS["sgd"]
    mod.init_optimizer(optimizer=kind, optimizer_params=dict(params))
    return mod


def _module_step(mx, mod, batch):
    x, y = batch
    mod.forward_backward(mx.io.DataBatch(
        data=[mx.nd.array(x, **_ctx(mx))],
        label=[mx.nd.array(y, **_ctx(mx))]))
    mod.update()


def _module_params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_module_states_load_in_the_other_package(tmp_path, writer, reader):
    wmx, rmx = PKGS[writer], PKGS[reader]
    with jmx.base.NameManager():
        init = jmx.mod.Module(mlp(jmx), context=jmx.cpu())
    init.bind(data_shapes=[("data", (8, 64))],
              label_shapes=[("softmax_label", (8,))])
    jmx.random.seed(0)
    init.init_params(jmx.init.Xavier())
    args, aux = ({k: v.asnumpy() for k, v in d.items()}
                 for d in init.get_params())
    batches = _batches(3)
    w = _module(wmx, args, aux)
    for b in batches[:2]:
        _module_step(wmx, w, b)
    fname = str(tmp_path / "mod.states")
    w.save_optimizer_states(fname)
    mid = _module_params(w)
    r = _module(rmx, mid, aux)
    r.load_optimizer_states(fname)
    _module_step(rmx, r, batches[2])
    _module_step(wmx, w, batches[2])
    got, want = _module_params(r), _module_params(w)
    for n in want:
        _close(got[n], want[n], n)


# -- gluon.Trainer ------------------------------------------------------------

def _gluon_net(mx, values=None):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(6, activation="relu", in_units=5),
            mx.gluon.nn.Dense(3, in_units=6))
    net.initialize(mx.init.Xavier(), **_ctx(mx))
    rng = np.random.RandomState(3)
    for i, (_, p) in enumerate(net.collect_params().items()):
        v = values[i] if values is not None else \
            rng.normal(0, 0.3, p.shape).astype(np.float32)
        p.set_data(mx.nd.array(v, **_ctx(mx)))
    return net


def _gluon_values(net):
    return [p.data().asnumpy() for _, p in net.collect_params().items()]


def _gluon_step(mx, net, tr, x):
    with mx.autograd.record():
        loss = (net(mx.nd.array(x, **_ctx(mx))) ** 2).sum()
    loss.backward()
    tr.step(x.shape[0])


def _trainer(mx, net, opt, on_kvstore):
    kind, params = OPTS[opt]
    if not on_kvstore:
        return mx.gluon.Trainer(net.collect_params(), kind, dict(params))
    return mx.gluon.Trainer(net.collect_params(), kind, dict(params),
                            kvstore=mx.kvstore.create("device"),
                            update_on_kvstore=True)


@pytest.mark.parametrize("on_kvstore", [False, True],
                         ids=["updater", "kvstore"])
@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_trainer_states_load_in_the_other_package(tmp_path, writer, reader,
                                                  opt, on_kvstore):
    wmx, rmx = PKGS[writer], PKGS[reader]
    rng = np.random.RandomState(1)
    xs = [rng.standard_normal((4, 5)).astype(np.float32) for _ in range(3)]
    wnet = _gluon_net(wmx)
    wtr = _trainer(wmx, wnet, opt, on_kvstore)
    for x in xs[:2]:
        _gluon_step(wmx, wnet, wtr, x)
    fname = str(tmp_path / "trainer.states")
    wtr.save_states(fname)
    assert wtr._update_on_kvstore == on_kvstore
    rnet = _gluon_net(rmx, _gluon_values(wnet))
    rtr = _trainer(rmx, rnet, opt, on_kvstore)
    rtr.load_states(fname)
    assert type(rtr._optimizer).__module__ == rmx.optimizer.__name__
    _gluon_step(rmx, rnet, rtr, xs[2])
    _gluon_step(wmx, wnet, wtr, xs[2])
    for i, (got, want) in enumerate(zip(_gluon_values(rnet),
                                        _gluon_values(wnet))):
        _close(got, want, f"param {i}")


# -- KVStore ------------------------------------------------------------------

@pytest.mark.parametrize("opt,dump", [("sgd", False), ("adam", True)])
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_kvstore_states_load_in_the_other_package(tmp_path, writer, reader,
                                                  opt, dump):
    wmx, rmx = PKGS[writer], PKGS[reader]
    rng = np.random.RandomState(2)
    w0 = rng.standard_normal((4, 6)).astype(np.float32)
    grads = [rng.standard_normal((4, 6)).astype(np.float32)
             for _ in range(3)]
    kind, params = OPTS[opt]

    def store(mx, value):
        kv = mx.kvstore.create("local")
        kv.init(3, mx.nd.array(value, **_ctx(mx)))
        kv.set_optimizer(mx.optimizer.create(kind, **params))
        return kv

    def pull(mx, kv):
        out = mx.nd.zeros((4, 6), **_ctx(mx))
        kv.pull(3, out=out)
        return out.asnumpy()

    wkv = store(wmx, w0)
    for g in grads[:2]:
        wkv.push(3, wmx.nd.array(g, **_ctx(wmx)))
    fname = str(tmp_path / "kv.states")
    wkv.save_optimizer_states(fname, dump_optimizer=dump)
    rkv = store(rmx, pull(wmx, wkv))
    rkv.load_optimizer_states(fname)
    rkv.push(3, rmx.nd.array(grads[2], **_ctx(rmx)))
    wkv.push(3, wmx.nd.array(grads[2], **_ctx(wmx)))
    _close(pull(rmx, rkv), pull(wmx, wkv), "weight")


def test_port_file_names_only_the_jax_package():
    """The bytes name no module of the port: the JAX package's plain
    pickle.loads gives its own NDArray and optimizer classes."""
    opt = tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                            lr_scheduler=tmx.lr_scheduler.FactorScheduler(3))
    upd = tmx.optimizer.get_updater(opt)
    w = tmx.nd.array(np.ones(4, np.float32), ctx=tmx.cpu())
    upd(0, tmx.nd.array(np.ones(4, np.float32), ctx=tmx.cpu()), w)
    blob = upd.get_states(dump_optimizer=True)
    assert b"mxnet_tpu_torch" not in blob
    states, loaded = pickle.loads(blob)
    assert type(states[0]) is jmx.nd.NDArray
    assert type(loaded) is jmx.optimizer.SGD
    assert type(loaded.lr_scheduler) is jmx.lr_scheduler.FactorScheduler
    assert sorted(vars(loaded)) == sorted(vars(jmx.optimizer.SGD()))
    np.testing.assert_allclose(states[0].asnumpy(), -0.1, rtol=1e-6)
