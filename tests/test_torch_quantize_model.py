"""The legacy int8 Symbol path of the port against the JAX package.

- the seven quantized ops: int8 / int32 outputs and their range scalars
  bit-equal to the JAX ops on the same seeded inputs, including a
  convolution whose int32 sums pass 2^24 (K = 4608 > 1040), where a
  float32 accumulation is shown to be wrong (the control);
- ``quantize_model``: the same rewritten node list in topological order,
  naive thresholds equal to the float32 rounding of the layer outputs
  they are read from (each package's own float forward), entropy
  thresholds within 1e-6, and the int8 MLP's and convnet's outputs within
  1e-5 of the JAX package's;
- ``examples/quantize_resnet.py`` on the port, import changed only.

Small sizes (MLPs of 16-64, convnets of 8-16 filters at 8-16 pixels).
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.contrib import quantization as jqz
from mxnet_tpu.ops.registry import get_op as jget_op

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.contrib import quantization as tqz
from mxnet_tpu_torch.ops.registry import get_op as tget_op

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _hold_settings(monkeypatch):
    """Two torch threads (six xdist workers share the cores), and none of
    the JAX planner's or the serving budget's settings that another test
    may leave in os.environ."""
    from mxnet_tpu.parallel.planner import AUTO_KNOB_VARS
    for k in AUTO_KNOB_VARS + ("MXNET_PLAN", "MXNET_SERVING_HBM_BUDGET",
                               "MXNET_DEVSTATS_HBM_BYTES"):
        if k in os.environ:
            monkeypatch.delenv(k)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _run(get_op, to_dev, from_dev, name, attrs, *xs):
    s = get_op(name)
    return [from_dev(o) for o in
            s.fcompute(s.parse_attrs(attrs), None, *[to_dev(x) for x in xs])]


def _jax_op(name, attrs, *xs):
    import jax.numpy as jnp
    return _run(jget_op, jnp.asarray, np.asarray, name, attrs, *xs)


def _port_op(name, attrs, *xs):
    return _run(tget_op, lambda x: torch.from_numpy(np.array(x)),
                lambda t: t.numpy(), name, attrs, *xs)


def _bit_equal(name, attrs, *xs):
    got, want = _port_op(name, attrs, *xs), _jax_op(name, attrs, *xs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert np.array_equal(g, w), (
            name, int((g != w).sum()),
            float(np.abs(g.astype(np.float64) - w).max()))
    return got


def _r(a):
    return np.asarray(a, np.float32).reshape(1)


def _q(x):
    """int8 tensor and its range through the JAX quantize op."""
    q, mn, mx_ = _jax_op("_contrib_quantize", {"out_type": "int8"}, x,
                         _r(x.min()), _r(x.max()))
    return q, _r(mn), _r(mx_)


@pytest.mark.parametrize("out_type", ["int8", "uint8"])
def test_quantize_and_dequantize_bit_equal(out_type):
    x = np.random.RandomState(0).normal(0, 1, (4, 8, 6, 6)).astype(
        np.float32)
    q, mn, mx_ = _bit_equal("_contrib_quantize", {"out_type": out_type}, x,
                            _r(x.min()), _r(x.max()))
    _bit_equal("_contrib_dequantize", {}, q, _r(mn), _r(mx_))


@pytest.mark.parametrize("calib", [None, (-3.5, 3.1)])
def test_requantize_bit_equal(calib):
    rng = np.random.RandomState(1)
    x = rng.randint(-2 ** 30, 2 ** 30, (4, 16, 5, 5)).astype(np.int32)
    attrs = {} if calib is None else {"min_calib_range": calib[0],
                                      "max_calib_range": calib[1]}
    _bit_equal("_contrib_requantize", attrs, x, _r(-7.25), _r(6.5))


@pytest.mark.parametrize("attrs,bias", [
    ({"kernel": (3, 3), "num_filter": 16, "pad": (1, 1)}, True),
    ({"kernel": (3, 3), "num_filter": 16, "stride": (2, 2),
      "no_bias": True}, False),
    ({"kernel": (1, 1), "num_filter": 8, "num_group": 2}, True)])
def test_quantized_conv_bit_equal(attrs, bias):
    rng = np.random.RandomState(2)
    x = rng.normal(0, 1, (4, 8, 10, 10)).astype(np.float32)
    groups = attrs.get("num_group", 1)
    w = rng.normal(0, .3, (attrs["num_filter"], 8 // groups)
                   + attrs["kernel"]).astype(np.float32)
    b = rng.normal(0, .3, (attrs["num_filter"],)).astype(np.float32)
    qx, qw, qb = _q(x), _q(w), _q(b)
    ins = [qx[0], qw[0]] + ([qb[0]] if bias else []) + \
        [qx[1], qx[2], qw[1], qw[2]] + ([qb[1], qb[2]] if bias else [])
    _bit_equal("_contrib_quantized_conv", attrs, *ins)


def test_quantized_fc_bit_equal():
    rng = np.random.RandomState(3)
    x = rng.normal(0, 1, (6, 4, 4, 4)).astype(np.float32)
    w = rng.normal(0, .3, (12, 64)).astype(np.float32)
    b = rng.normal(0, .3, (12,)).astype(np.float32)
    qx, qw, qb = _q(x), _q(w), _q(b)
    _bit_equal("_contrib_quantized_fully_connected", {"num_hidden": 12},
               qx[0], qw[0], qb[0], qx[1], qx[2], qw[1], qw[2], qb[1],
               qb[2])
    _bit_equal("_contrib_quantized_fully_connected",
               {"num_hidden": 12, "no_bias": True},
               qx[0], qw[0], qx[1], qx[2], qw[1], qw[2])


@pytest.mark.parametrize("attrs", [
    {"kernel": (2, 2), "stride": (2, 2), "pool_type": "max"},
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "avg"},
    {"global_pool": True, "pool_type": "avg"},
    {"global_pool": True, "pool_type": "max"}])
def test_quantized_pooling_and_flatten_bit_equal(attrs):
    qx = np.random.RandomState(4).randint(-127, 128, (2, 6, 8, 8)).astype(
        np.int8)
    _bit_equal("_contrib_quantized_pooling", attrs, qx, _r(-1.5), _r(2.0))
    _bit_equal("_contrib_quantized_flatten", {}, qx, _r(-1.5), _r(2.0))


def test_quantized_conv_past_2_24_exact_where_float32_is_not():
    """K = 512 * 3 * 3 = 4608 int8 products of up to 127 * 127: sums near
    7e7 > 2^24. The port's int32 outputs are the JAX package's bit for
    bit; the control, the same convolution accumulated in float32,
    differs."""
    rng = np.random.RandomState(5)
    d = rng.randint(100, 128, (2, 512, 5, 5)).astype(np.int8)
    w = (rng.randint(100, 128, (4, 512, 3, 3))
         * rng.choice([-1, 1], (4, 1, 1, 1))).astype(np.int8)
    one = _r(1.0)
    out = _bit_equal("_contrib_quantized_conv",
                     {"kernel": (3, 3), "num_filter": 4, "no_bias": True},
                     d, w, -one, one, -one, one)[0]
    assert np.abs(out).max() > 2 ** 24
    f32 = torch.nn.functional.conv2d(torch.from_numpy(d).float(),
                                     torch.from_numpy(w).float()).numpy()
    assert not np.array_equal(f32.astype(np.int64), out.astype(np.int64))


# -- quantize_model ------------------------------------------------------

def _mlp_sym(mx):
    data = mx.sym.Variable("data")
    f1 = mx.sym.FullyConnected(data, num_hidden=64, name="fc1")
    a1 = mx.sym.Activation(f1, act_type="relu")
    f2 = mx.sym.FullyConnected(a1, num_hidden=8, name="fc2")
    return mx.sym.softmax(f2, name="out")


def _conv_sym(mx):
    data = mx.sym.Variable("data")
    c1 = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                            name="conv1")
    a1 = mx.sym.Activation(c1, act_type="relu")
    p1 = mx.sym.Pooling(a1, kernel=(2, 2), stride=(2, 2), pool_type="max",
                        name="pool1")
    c2 = mx.sym.Convolution(p1, kernel=(3, 3), num_filter=16, pad=(1, 1),
                            name="conv2")
    a2 = mx.sym.Activation(c2, act_type="relu")
    gp = mx.sym.Pooling(a2, global_pool=True, pool_type="avg", name="gp")
    fl = mx.sym.Flatten(gp, name="flat")
    f1 = mx.sym.FullyConnected(fl, num_hidden=10, name="fc1")
    return mx.sym.softmax(f1, name="out")


NETS = {"mlp": (_mlp_sym, (8, 16)), "convnet": (_conv_sym, (4, 3, 16, 16))}


def _draws(sym, data_shape, seed):
    rng = np.random.RandomState(seed)
    shapes, _, _ = sym.infer_shape(data=data_shape)
    params = {n: rng.normal(0, 0.2, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes) if n != "data"}
    return params, rng.normal(0, 1, data_shape).astype(np.float32)


def _outputs(mx, sym, params, x):
    ex = sym.simple_bind(mx.cpu(), grad_req="null", data=x.shape)
    for k, v in params.items():
        if k in ex.arg_dict:
            ex.arg_dict[k][:] = v
    ex.arg_dict["data"][:] = x
    return ex.forward(is_train=False)[0].asnumpy()


def _both(net, mode):
    """quantize_model in each package from the same draws: (jax, port)
    each (qsym, qargs, output on x). The entropy search (a Python loop
    over 4,000 candidate thresholds a layer) calibrates fc1 alone."""
    build, shape = NETS[net]
    out = []
    for mx, qz in ((jmx, jqz), (tmx, tqz)):
        # a fresh name counter a package: tests run before this one in
        # the process name their unnamed nodes in either package alone
        with mx.NameManager():
            sym = build(mx)
        params, x = _draws(sym, shape, seed=11)
        nd = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in params.items()}
        calib = mx.io.NDArrayIter(x, batch_size=shape[0] // 2,
                                  label_name=None)
        qsym, qargs, _ = qz.quantize_model(
            sym, nd, {}, ctx=mx.cpu(), calib_mode=mode,
            calib_data=calib if mode != "none" else None,
            num_calib_examples=shape[0],
            calib_layer=(lambda n: n == "fc1_output")
            if mode == "entropy" else None)
        host = {k: v.asnumpy() for k, v in qargs.items()}
        out.append((qsym, host, _outputs(mx, qsym, host, x)))
    return out


def _nodes(qsym):
    return [(n.name, n.op.name if n.op is not None else None,
             {k: str(v) for k, v in n.attrs.items()}) for n in qsym._topo()]


@pytest.mark.parametrize("net,mode", [
    ("mlp", "none"), ("mlp", "naive"), ("mlp", "entropy"),
    ("convnet", "none"), ("convnet", "naive")])
def test_quantize_model_matches_the_jax_package(net, mode):
    (jsym, jargs, jout), (tsym, targs, tout) = _both(net, mode)
    jn, tn = _nodes(jsym), _nodes(tsym)
    assert [n[:2] for n in tn] == [n[:2] for n in jn]
    assert tsym.list_arguments() == jsym.list_arguments()
    for (name, op, ja), (_, _, ta) in zip(jn, tn):
        # thresholds come from each package's own float32 forward, whose
        # products sum in another order than XLA's: naive ones (the
        # outputs' |max|) agree within its rounding; entropy ones are bin
        # edges, within 1e-6
        if op != "_contrib_requantize" or "min_calib_range" not in ja:
            assert ta == ja, name
            continue
        for k in ("min_calib_range", "max_calib_range"):
            tol = 1e-6 if mode == "entropy" else 1e-6 * abs(float(ja[k]))
            assert abs(float(ta[k]) - float(ja[k])) <= tol, (name, k)
    assert sorted(targs) == sorted(jargs)
    for k in jargs:
        assert np.array_equal(targs[k], jargs[k]), k
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-5)


def test_entropy_threshold_search_matches():
    """The same histogram gives the same threshold (within 1e-6), and the
    smoothing the same distribution."""
    arr = np.random.RandomState(12).standard_t(3, 20000).astype(np.float32)
    got = tqz._get_optimal_threshold(arr, num_bins=801)
    want = jqz._get_optimal_threshold(arr, num_bins=801)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    p = np.array([0, 3, 0, 5, 1], np.float32) / 9
    np.testing.assert_array_equal(tqz._smooth_distribution(p),
                                  jqz._smooth_distribution(p))


def test_quantize_model_excluded_layer_and_structure():
    sym = _mlp_sym(tmx)
    qsym = tqz._quantize_symbol(sym, excluded_symbols={"fc2"})
    names = [n.name for n in qsym._topo() if n.op is not None]
    assert "fc2" in names and "quantized_fc1" in names
    qsym = tqz._quantize_symbol(sym, offline_params={"fc1_weight",
                                                     "fc1_bias"})
    args = qsym.list_arguments()
    assert "fc1_weight_quantize" in args
    assert "fc1_weight_quantize_min" in args


def test_nd_and_sym_contrib_namespaces():
    x = tmx.nd.array(np.array([[1., -2.], [3., .5]], np.float32),
                     ctx=tmx.cpu())
    q, mn, mx_ = tmx.nd.contrib.quantize(x, tmx.nd.min(x), tmx.nd.max(x),
                                         out_type="int8")
    assert q.asnumpy().tolist() == [[42, -85], [127, 21]]
    assert float(mx_.asnumpy()) == 3.0
    s = tmx.sym.contrib.quantize(tmx.sym.Variable("d"), tmx.sym.Variable(
        "lo"), tmx.sym.Variable("hi"))
    assert s.list_outputs() == [f"{s._outputs[0][0].name}_output{i}"
                                for i in range(3)]


@pytest.mark.parametrize("calib", ["none", "naive"])
def test_quantize_resnet_example_on_the_port(calib):
    """examples/quantize_resnet.py with only its import changed, with its
    own --ctx default (cpu); the port's default context is the card, so
    the host context is entered around the program (its mx.nd.array
    calls name none). Its own bar: exit code 0 (max prob error < 0.1).
    Its entropy run (40 s of numpy threshold search on the host) is
    chip_smoke.py's."""
    import contextlib
    import io
    path = os.path.join(ROOT, "examples", "quantize_resnet.py")
    src = open(path).read()
    for a, b in (("import mxnet_tpu as mx", "import mxnet_tpu_torch as mx"),
                 ("from mxnet_tpu.contrib import",
                  "from mxnet_tpu_torch.contrib import")):
        assert a in src
        src = src.replace(a, b)
    argv, sys.argv = sys.argv, [path, "--calib", calib]
    buf = io.StringIO()
    try:
        with tmx.cpu(), contextlib.redirect_stdout(buf):
            exec(compile(src, path, "exec"), {"__name__": "__main__",
                                              "__file__": path})
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = argv
    assert code == 0, buf.getvalue()
    assert "quantized nodes" in buf.getvalue()
