"""The port's Symbol against the JAX package's, on the CPU.

Names (``list_arguments`` / ``list_auxiliary_states`` / ``list_outputs``
and every internal output), ``infer_shape`` and ``attr_dict`` of the
MLP and LeNet of tests/test_train_accuracy.py and of auto-named graphs;
JSON written by either package loaded by the other (and a
reference-era legacy JSON by both); chip_smoke.py's ResNet-50 builder
against the JAX model zoo's ``resnet50_v1()`` applied to a Variable.
Every comparison is exact (names, attrs and shapes).
"""
import importlib.util
import json
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mlp(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=128, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=64, name="fc2")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc3")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def lenet(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, kernel=(5, 5), num_filter=20, name="c1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Pooling(net, pool_type="max", kernel=(2, 2), stride=(2, 2))
    net = mx.sym.Convolution(net, kernel=(5, 5), num_filter=50, name="c2")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Pooling(net, pool_type="max", kernel=(2, 2), stride=(2, 2))
    net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=256,
                                name="f1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="f2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def auto_named(mx):
    """No names given: every op and parameter is named by the counters."""
    x = mx.sym.Variable("data", lr_mult=2.0)
    y = mx.sym.Convolution(x, kernel=(3, 3), num_filter=4, pad=(1, 1))
    y = mx.sym.BatchNorm(y, fix_gamma=False)
    y = mx.sym.Activation(y, act_type="relu")
    y = mx.sym.Pooling(y, kernel=(2, 2), stride=(2, 2), pool_type="avg")
    z = mx.sym.FullyConnected(mx.sym.Flatten(y), num_hidden=3)
    w = mx.sym.Variable("w2", shape=(3, 3), wd_mult=0.5)
    z = mx.sym.FullyConnected(z, weight=w, num_hidden=3, no_bias=True)
    z = (z * 2.0 + 1.0) / 3.0 - z
    z = mx.sym.Reshape(z, shape=(0, -1))
    return mx.sym.SoftmaxOutput(z, name="softmax")


BUILDERS = {"mlp": (mlp, {"data": (4, 64)}),
            "lenet": (lenet, {"data": (2, 1, 32, 32)}),
            "auto": (auto_named, {"data": (2, 3, 8, 8)})}


def _both(build):
    with jmx.base.NameManager():
        js = build(jmx)
    with tmx.NameManager():
        ts = build(tmx)
    return js, ts


@pytest.mark.parametrize("which", sorted(BUILDERS))
def test_names_and_shapes_match_jax(which):
    build, shapes = BUILDERS[which]
    js, ts = _both(build)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_outputs() == js.list_outputs()
    assert ts.get_internals().list_outputs() == \
        js.get_internals().list_outputs()
    assert ts.attr_dict() == js.attr_dict()
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)
    part = {k: v for k, v in shapes.items()}
    assert ts.infer_shape_partial(**part) == js.infer_shape_partial(**part)
    assert [str(t) for t in ts.infer_type(data="float32")[0]] == \
        [str(t) for t in js.infer_type(data="float32")[0]]


def test_auto_names_follow_the_op_hint():
    with tmx.NameManager():
        s = tmx.sym.FullyConnected(tmx.sym.Variable("x"), num_hidden=2)
        c = tmx.sym.Convolution(tmx.sym.Variable("y"), kernel=(1, 1),
                                num_filter=2)
    assert s.list_arguments() == ["x", "fullyconnected0_weight",
                                  "fullyconnected0_bias"]
    assert c.list_arguments()[1] == "convolution0_weight"


@pytest.mark.parametrize("which", sorted(BUILDERS))
def test_json_round_trips_across_the_packages(which):
    build, shapes = BUILDERS[which]
    js, ts = _both(build)
    assert json.loads(ts.tojson()) == json.loads(js.tojson())
    j_from_t = jmx.sym.load_json(ts.tojson())
    t_from_j = tmx.sym.load_json(js.tojson())
    assert t_from_j.list_arguments() == js.list_arguments()
    assert j_from_t.list_arguments() == ts.list_arguments()
    assert t_from_j.infer_shape(**shapes) == js.infer_shape(**shapes)
    assert json.loads(t_from_j.tojson()) == json.loads(js.tojson())


def test_symbol_files_load_in_the_other_package(tmp_path):
    js, ts = _both(lenet)
    ts.save(str(tmp_path / "t-symbol.json"))
    js.save(str(tmp_path / "j-symbol.json"))
    assert jmx.sym.load(str(tmp_path / "t-symbol.json")).tojson() == \
        js.tojson()
    assert tmx.sym.load(str(tmp_path / "j-symbol.json")).tojson() == \
        ts.tojson()


LEGACY = {
    # a reference 0.8-era file: "param" instead of "attrs", no aux inputs
    # stored for BatchNorm, hidden keys ("lr_mult", "{arg}_wd_mult") raw,
    # no version attr
    "nodes": [
        {"op": "null", "name": "data", "inputs": []},
        {"op": "null", "name": "fc_weight", "param": {"lr_mult": "0.5"},
         "inputs": []},
        {"op": "null", "name": "fc_bias", "inputs": []},
        {"op": "FullyConnected", "name": "fc",
         "param": {"num_hidden": "4", "weight_wd_mult": "0.1"},
         "inputs": [[0, 0], [1, 0], [2, 0]]},
        {"op": "null", "name": "bn_gamma", "inputs": []},
        {"op": "null", "name": "bn_beta", "inputs": []},
        {"op": "BatchNorm", "name": "bn", "param": {"fix_gamma": "False"},
         "inputs": [[3, 0], [4, 0], [5, 0]]},
        {"op": "argmax", "name": "am", "param": {"axis": "-1"},
         "inputs": [[6, 0]]},
    ],
    "arg_nodes": [0, 1, 2, 4, 5],
    "heads": [[6, 0], [7, 0]],
}


def test_legacy_json_upgrades_the_same_way_in_both():
    text = json.dumps(LEGACY)
    js = jmx.sym.load_json(text)
    ts = tmx.sym.load_json(text)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states() == \
        ["bn_moving_mean", "bn_moving_var"]
    assert ts.attr_dict() == js.attr_dict()
    assert ts.attr_dict()["fc_weight"]["__lr_mult__"] == "0.5"
    assert ts.attr_dict()["fc_weight"]["__wd_mult__"] == "0.1"
    assert ts.infer_shape(data=(2, 3)) == js.infer_shape(data=(2, 3))
    assert json.loads(ts.tojson()) == json.loads(js.tojson())


def _ops(symbol):
    return [n for n in symbol._topo() if n.op is not None]


def test_chip_smoke_resnet50_builder_matches_the_model_zoo():
    """Same op sequence, parsed attrs, parameter names and inferred shapes
    at 224 x 224 as the JAX model zoo's resnet50_v1 (loaded into the port
    through its JSON)."""
    from mxnet_tpu.gluon.model_zoo import vision
    with jmx.base.NameManager():
        zoo = jmx.sym.SoftmaxOutput(
            vision.resnet50_v1()(jmx.sym.Variable("data")), name="softmax")
    ref = tmx.sym.load_json(zoo.tojson())
    built = chip_smoke().resnet_v1_symbol(tmx.sym)
    a, b = _ops(built), _ops(ref)
    assert [n.op.name for n in a] == [n.op.name for n in b]
    assert len(a) == 175
    for x, y in zip(a, b):
        assert x.op.parse_attrs(x.attrs) == y.op.parse_attrs(y.attrs), \
            (x.name, y.name)
        assert [(n2.op is None, i) for n2, i in x.inputs] == \
            [(n2.op is None, i) for n2, i in y.inputs]
    assert built.list_arguments() == ref.list_arguments()
    assert built.list_auxiliary_states() == ref.list_auxiliary_states()
    shapes = dict(data=(2, 3, 224, 224))
    got = built.infer_shape(**shapes)
    assert got == ref.infer_shape(**shapes)
    assert got[1] == [(2, 1000)]
    n_params = sum(int(np.prod(s)) for n, s in zip(
        built.list_arguments(), got[0]) if n not in ("data",
                                                     "softmax_label"))
    # torchvision's resnet50 count, 25,557,032, plus the 18,880 biases
    # of the 1 x 1 convolutions Gluon's BottleneckV1 keeps
    assert n_params == 25_557_032 + 18_880
    internals = built.get_internals()
    assert internals.infer_shape(**shapes)[1] == \
        ref.get_internals().infer_shape(**shapes)[1]


def test_symbol_arithmetic_and_group():
    with tmx.NameManager():
        a, b = tmx.sym.Variable("a"), tmx.sym.Variable("b")
        g = tmx.sym.Group([a + b, a * 2.0, 3.0 - b, a / b, a ** 2.0])
    out = g.eval(ctx=tmx.cpu(), a=tmx.nd.array([1.0, 2.0], ctx=tmx.cpu()),
                 b=tmx.nd.array([4.0, 8.0], ctx=tmx.cpu()))
    np.testing.assert_allclose([o.asnumpy() for o in out],
                               [[5, 10], [2, 4], [-1, -5], [0.25, 0.25],
                                [1, 4]])
    assert len(g) == 5 and g[1].name == "mul_scalar0"
