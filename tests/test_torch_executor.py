"""The port's executor against the JAX package's, on the CPU.

LeNet (examples/train_mnist.py's) and a narrow two-bottleneck ResNet v1
(chip_smoke.py's builder: stem, one stage of two bottlenecks, 8 -> 32
channels) at 32 x 32 and batch 2, both bound with ``simple_bind`` on the
CPU and given the same parameters (weights from the JAX package's
Xavier initializer, the rest seeded) and moving statistics:
outputs, every gradient, and the BatchNorm moving statistics after a
training forward, under grad_req write, add and null; an inference
forward; and the nodes the BN+ReLU fusion and dead-bias passes pick.
Tolerance: TOL of each tensor's largest magnitude (float32 in another
summation order, through BatchNorms over 2 x 8 x 8 values).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import executor as jexec
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import executor as texec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


def _build(which, mx):
    with mx.NameManager() if hasattr(mx, "NameManager") else \
            mx.base.NameManager():
        if which == "lenet":
            return SMOKE.lenet_symbol(mx.sym), (2, 1, 28, 28)
        return SMOKE.resnet_v1_symbol(mx.sym, layers=(2,), channels=(8, 32),
                                      classes=10), (2, 3, 32, 32)


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1e-30, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _values(symbol, shape, seed=0):
    """Seeded parameters (and non-trivial moving statistics) by name."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = symbol.infer_shape(data=shape)
    args, aux = {}, {}
    for n, s in zip(symbol.list_arguments(), arg_shapes):
        if n == "softmax_label":
            args[n] = rng.randint(0, 10, s).astype(np.float32)
        elif n.endswith("gamma"):
            args[n] = rng.uniform(0.5, 1.5, s).astype(np.float32)
        else:
            args[n] = (rng.standard_normal(s) * 0.2).astype(np.float32)
    for n, s in zip(symbol.list_auxiliary_states(), aux_shapes):
        aux[n] = (rng.uniform(0.5, 2.0, s) if n.endswith("var")
                  else rng.standard_normal(s) * 0.1).astype(np.float32)
    return args, aux


def _pair(which, grad_req="write"):
    """JAX and port executors holding the same values: the weights as the
    JAX package's Xavier initializer draws them (its global key seeded,
    then restored), the rest from ``_values``, all carried across."""
    js, shape = _build(which, jmx)
    ts, _ = _build(which, tmx)
    args, aux = _values(js, shape)
    jex = js.simple_bind(ctx=jmx.cpu(), grad_req=grad_req, data=shape)
    tex = ts.simple_bind(ctx=tmx.cpu(), grad_req=grad_req, data=shape)
    jex.copy_params_from({k: jmx.nd.array(v) for k, v in args.items()},
                         {k: jmx.nd.array(v) for k, v in aux.items()})
    state = jmx.random.get_state()
    jmx.random.seed(0)
    try:
        init = jmx.init.Xavier()
        for n in args:
            if n.endswith("weight"):
                init(jmx.init.InitDesc(n), jex.arg_dict[n])
                args[n] = jex.arg_dict[n].asnumpy()
    finally:
        jmx.random.set_state(state)
    tex.copy_params_from(args, aux)
    return jex, tex, args


def _step(ex, args, nd):
    ex.forward(is_train=True, data=nd.array(args["data"], ctx=_ctx(nd)),
               softmax_label=nd.array(args["softmax_label"], ctx=_ctx(nd)))
    ex.backward()


def _ctx(nd):
    return tmx.cpu() if nd is tmx.nd else jmx.cpu()


def _compare(jex, tex, what):
    for a, b in zip(tex.outputs, jex.outputs):
        _close(a.asnumpy(), b.asnumpy(), f"{what} output")
    assert sorted(tex.grad_dict) == sorted(jex.grad_dict)
    for n in jex.grad_dict:
        _close(tex.grad_dict[n].asnumpy(), jex.grad_dict[n].asnumpy(),
               f"{what} grad {n}")
    for n in jex.aux_dict:
        _close(tex.aux_dict[n].asnumpy(), jex.aux_dict[n].asnumpy(),
               f"{what} aux {n}")


@pytest.mark.parametrize("which", ["lenet", "resnet"])
def test_forward_backward_write(which):
    jex, tex, args = _pair(which)
    _step(jex, args, jmx.nd)
    _step(tex, args, tmx.nd)
    _compare(jex, tex, which)
    # a second step overwrites (write), it does not accumulate
    _step(jex, args, jmx.nd)
    _step(tex, args, tmx.nd)
    _compare(jex, tex, which + " step 2")
    # nothing lands in .grad of the bound arrays
    assert all(a._data.grad is None for a in tex.arg_dict.values())


@pytest.mark.parametrize("which", ["lenet", "resnet"])
def test_grad_req_add_accumulates(which):
    jex, tex, args = _pair(which, grad_req="add")
    for _ in range(2):
        _step(jex, args, jmx.nd)
        _step(tex, args, tmx.nd)
    _compare(jex, tex, which)


def test_grad_req_null_leaves_no_gradient():
    js, shape = _build("resnet", jmx)
    ts, _ = _build("resnet", tmx)
    args, aux = _values(js, shape)
    req = {n: "write" for n in js.list_arguments()
           if n.endswith("weight")}
    jex = js.simple_bind(ctx=jmx.cpu(), grad_req=req, data=shape)
    tex = ts.simple_bind(ctx=tmx.cpu(), grad_req=req, data=shape)
    jex.copy_params_from({k: jmx.nd.array(v) for k, v in args.items()},
                         {k: jmx.nd.array(v) for k, v in aux.items()})
    tex.copy_params_from(args, aux)
    _step(jex, args, jmx.nd)
    _step(tex, args, tmx.nd)
    assert sorted(tex.grad_dict) == sorted(req)
    _compare(jex, tex, "null")


@pytest.mark.parametrize("which", ["lenet", "resnet"])
def test_inference_forward_uses_moving_statistics(which):
    jex, tex, args = _pair(which)
    before = {n: a.asnumpy().copy() for n, a in tex.aux_dict.items()}
    for ex, nd in ((jex, jmx.nd), (tex, tmx.nd)):
        ex.forward(is_train=False, data=nd.array(args["data"], ctx=_ctx(nd)))
    for a, b in zip(tex.outputs, jex.outputs):
        _close(a.asnumpy(), b.asnumpy(), "inference output")
    for n, v in before.items():       # inference leaves them untouched
        np.testing.assert_array_equal(tex.aux_dict[n].asnumpy(), v)


def test_a_training_forward_without_backward_keeps_no_graph():
    _, tex, args = _pair("resnet")
    tex.forward(is_train=True, data=tmx.nd.array(args["data"], ctx=tmx.cpu()))
    assert tex._pending is not None
    tex.forward(is_train=False, data=tmx.nd.array(args["data"],
                                                  ctx=tmx.cpu()))
    assert tex._pending is None
    assert all(o._data.grad_fn is None for o in tex.outputs)
    with pytest.raises(tmx.MXNetError, match="before forward"):
        tex.backward()


@pytest.mark.parametrize("which", ["lenet", "resnet"])
def test_graph_passes_pick_the_same_nodes(which):
    js, _ = _build(which, jmx)
    ts, _ = _build(which, tmx)
    jt, tt = js._topo(), ts._topo()
    jname = {id(n): n.name for n in jt}
    tname = {id(n): n.name for n in tt}
    jf, jp = jexec._fuse_bn_relu(js, jt)
    tf, tp = texec._fuse_bn_relu(ts, tt)
    assert sorted(tname[i] for i in tf) == sorted(jname[i] for i in jf)
    assert sorted((tname[a], tname[b]) for a, b in tp.items()) == \
        sorted((jname[a], jname[b]) for a, b in jp.items())
    jd = sorted(jname[i] for i in jexec._dead_bias_convs(js, jt))
    assert sorted(tname[i] for i in texec._dead_bias_convs(ts, tt)) == jd
    if which == "resnet":
        # each bottleneck's two 1 x 1 convs with a bias feed a BN alone
        # (2 x 2 dead biases); the stem's BN and two BNs a bottleneck feed
        # a ReLU alone (1 + 2 x 2 fused; the third BN feeds the add)
        assert len(jd) == 4 and len(jf) == 5


def test_monitor_sees_every_node_unfused():
    _, tex, args = _pair("resnet")
    seen = []
    tex.set_monitor_callback(lambda name, arr: seen.append(name))
    tex.forward(is_train=False, data=tmx.nd.array(args["data"],
                                                  ctx=tmx.cpu()))
    n_ops = sum(1 for n in tex._symbol._topo() if n.op is not None)
    assert len(seen) == n_ops
    # the model zoo names its ReLUs activation0, activation1, ...: the
    # ones the fused plan folds into their BatchNorm are seen here too
    relu = [s for s in seen if s.startswith("activation")]
    assert relu and all(s.endswith("_output") for s in seen)


def test_reshape_and_output_dict():
    _, tex, args = _pair("lenet")
    ex2 = tex.reshape(data=(3, 1, 28, 28), softmax_label=(3,))
    assert ex2.arg_dict["c1_weight"] is tex.arg_dict["c1_weight"]
    out = ex2.forward(data=tmx.nd.array(np.zeros((3, 1, 28, 28)),
                                        ctx=tmx.cpu()))
    assert out[0].shape == (3, 10)
    assert list(ex2.output_dict) == ["softmax_output"]


def test_unported_options_raise():
    ts, shape = _build("lenet", tmx)
    # group2ctx is ported (tests/test_torch_segmented.py): it binds, and
    # with a data-parallel mesh it raises as the JAX package's does
    ex = ts.simple_bind(ctx=tmx.cpu(), data=shape,
                        group2ctx={"a": tmx.cpu()})
    assert ex.copies == 0 and len(ex.segments) == 1
    from mxnet_tpu_torch.parallel import mesh_for_contexts
    with pytest.raises(tmx.MXNetError, match="group2ctx"):
        ts.simple_bind(ctx=tmx.cpu(), data=shape,
                       group2ctx={"a": tmx.cpu()},
                       mesh=mesh_for_contexts([tmx.cpu(0), tmx.cpu(1)]),
                       sharded_args=("data",))
    # the data-parallel mesh is ported: what is not a Mesh raises
    with pytest.raises(tmx.MXNetError, match="parallel.Mesh"):
        ts.simple_bind(ctx=tmx.cpu(), data=shape, mesh=object())
    os.environ["MXNET_BACKWARD_DO_MIRROR"] = "1"
    try:
        with pytest.raises(tmx.MXNetError, match="MIRROR"):
            ts.simple_bind(ctx=tmx.cpu(), data=shape)
    finally:
        del os.environ["MXNET_BACKWARD_DO_MIRROR"]


def test_out_grads_are_the_cotangents_of_a_plain_head():
    """A head that is not a loss takes the given cotangents."""
    with jmx.base.NameManager():
        js = jmx.sym.FullyConnected(jmx.sym.Variable("x"), num_hidden=3,
                                    name="fc")
    with tmx.NameManager():
        ts = tmx.sym.FullyConnected(tmx.sym.Variable("x"), num_hidden=3,
                                    name="fc")
    rng = np.random.RandomState(0)
    vals = {"x": rng.rand(4, 5), "fc_weight": rng.rand(3, 5),
            "fc_bias": rng.rand(3)}
    ct = rng.rand(4, 3).astype(np.float32)
    jex = js.simple_bind(ctx=jmx.cpu(), x=(4, 5))
    tex = ts.simple_bind(ctx=tmx.cpu(), x=(4, 5))
    jex.copy_params_from({k: jmx.nd.array(v) for k, v in vals.items()})
    tex.copy_params_from({k: v.astype(np.float32) for k, v in vals.items()})
    jex.forward(is_train=True)
    jex.backward([jmx.nd.array(ct)])
    tex.forward(is_train=True)
    tex.backward([tmx.nd.array(ct, ctx=tmx.cpu())])
    _compare(jex, tex, "fc")
    assert torch.is_tensor(tex.grad_dict["x"]._data)


@pytest.mark.parametrize("seeded", [False, True], ids=["ones", "out_grads"])
def test_write_gradients_stay_in_their_own_buffers(seeded):
    """grad_req 'write' copies into the buffers simple_bind allocated:
    autograd hands a + b the same cotangent tensor for both leaves (and,
    given out_grads, the caller's own tensor), and no gradient may alias
    another or the caller's buffer."""
    with tmx.NameManager():
        s = tmx.sym.Variable("a") + tmx.sym.Variable("b")
    ex = s.simple_bind(ctx=tmx.cpu(), a=(3,), b=(3,))
    ptrs = {n: g._data.data_ptr() for n, g in ex.grad_dict.items()}
    ex.forward(is_train=True, a=tmx.nd.array(np.ones(3), ctx=tmx.cpu()),
               b=tmx.nd.array(np.ones(3), ctx=tmx.cpu()))
    ct = tmx.nd.array(np.full(3, 2.0), ctx=tmx.cpu())
    ex.backward([ct] if seeded else None)
    want = np.full(3, 2.0 if seeded else 1.0, np.float32)
    assert {n: g._data.data_ptr() for n, g in ex.grad_dict.items()} == ptrs
    ex.grad_dict["a"][:] = 0
    if seeded:
        ct[:] = 5
    np.testing.assert_array_equal(ex.grad_dict["b"].asnumpy(), want)
    np.testing.assert_array_equal(ex.grad_dict["a"].asnumpy(), 0 * want)
