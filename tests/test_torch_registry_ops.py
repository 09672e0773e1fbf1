"""The port's registered operators against the JAX package's, on the CPU.

Each case feeds the same seeded numpy inputs and the same attrs to both
registries' fcompute: outputs are compared, and gradients (torch
autograd against ``jax.vjp``, with one random cotangent on output 0).
Tolerance: an element's error within RTOL of its tensor's largest
magnitude (float32 sums of at most a few hundred terms in another
order), 1e-4 for convolutions (cuDNN / oneDNN and XLA tile their sums
differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

RTOL = 2e-5
CONV_RTOL = 1e-4


def _close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got)), what
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    if fin.any():
        scale = max(1.0, float(np.abs(want[fin]).max()))
        err = float(np.abs(got[fin] - want[fin]).max())
        assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def run_both(name, attrs, inputs, is_train=False, diff=(), flags=None,
             seed=0):
    """(jax outputs, port outputs, jax grads, port grads) of op ``name``
    on numpy ``inputs``; grads w.r.t. the inputs at indices ``diff`` for
    a random cotangent on output 0. ``flags`` are extra parsed attrs (the
    executor's pass flags)."""
    js, ts = jreg.get_op(name), treg.get_op(name)
    ja, ta = js.parse_attrs(attrs), ts.parse_attrs(attrs)
    for k, v in (flags or {}).items():
        ja[k] = v
        ta[k] = v
    jx = [jnp.asarray(x) for x in inputs]
    tx = [torch.from_numpy(np.array(x)) for x in inputs]
    for i in diff:
        tx[i].requires_grad_(True)

    def jf(*d):
        xs = list(jx)
        for i, v in zip(diff, d):
            xs[i] = v
        return js.fcompute(ja, jreg.OpCtx(is_train=is_train), *xs)

    with torch.enable_grad():
        tout = ts.fcompute(ta, treg.OpCtx(is_train=is_train, device="cpu"),
                           *tx)
    if not diff:
        return jf(), tout, None, None
    jout, vjp = jax.vjp(lambda *d: jf(*d)[0], *[jx[i] for i in diff])
    ct = np.random.RandomState(seed + 7).standard_normal(
        jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))
    tgrads = torch.autograd.grad(tout[0], [tx[i] for i in diff],
                                 torch.from_numpy(ct), allow_unused=True)
    return jf(), tout, jgrads, tgrads


def _check(jo, to, jg, tg, rtol=RTOL, n_out=None):
    n = len(jo) if n_out is None else n_out
    for i in range(n):
        _close(to[i].detach().numpy(), np.asarray(jo[i]), rtol, f"out{i}")
    for i, (a, b) in enumerate(zip(tg or (), jg or ())):
        b = np.zeros_like(np.asarray(b)) if b is None else np.asarray(b)
        a = np.zeros_like(b) if a is None else a.numpy()
        _close(a, b, rtol, f"grad{i}")


def _rand(*shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


CONV_CASES = [
    dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), num_filter=6),
    dict(kernel=(3, 3), stride=(2, 2), pad=(0, 0), num_filter=6,
         no_bias=True),
    dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2), num_filter=4),
    dict(kernel=(3, 3), pad=(1, 1), num_filter=6, num_group=2),
    dict(kernel=(1, 1), stride=(2, 2), num_filter=8, no_bias=True),
    dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3), num_filter=4),
    dict(kernel=(3,), pad=(1,), num_filter=5),
]


@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_convolution(case):
    attrs = CONV_CASES[case]
    ns = len(attrs["kernel"])
    ci = 4
    x = _rand(2, ci, *([9] * ns), seed=case)
    g = attrs.get("num_group", 1)
    w = _rand(attrs["num_filter"], ci // g, *attrs["kernel"], seed=case + 1,
              scale=0.3)
    inputs = [x, w] if attrs.get("no_bias") else \
        [x, w, _rand(attrs["num_filter"], seed=case + 2)]
    out = run_both("Convolution", attrs, inputs, is_train=True,
                   diff=range(len(inputs)))
    _check(*out, rtol=CONV_RTOL)


@pytest.mark.parametrize("op", ["Convolution", "FullyConnected"])
def test_dead_bias_gradient_is_exact_zero(op):
    if op == "Convolution":
        attrs = dict(kernel=(3, 3), pad=(1, 1), num_filter=4)
        inputs = [_rand(2, 3, 6, 6), _rand(4, 3, 3, 3, seed=1),
                  _rand(4, seed=2)]
    else:
        attrs = dict(num_hidden=4)
        inputs = [_rand(3, 5), _rand(4, 5, seed=1), _rand(4, seed=2)]
    jo, to, jg, tg = run_both(op, attrs, inputs, is_train=True,
                              diff=(0, 1, 2),
                              flags={"__bias_grad_dead__": True})
    _check(jo, to, jg, tg, rtol=CONV_RTOL)
    assert not tg[2].any() and not np.asarray(jg[2]).any()


POOL_CASES = [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg"),
    dict(kernel=(2, 2), stride=(2, 2), pool_type="max",
         pooling_convention="full"),
    dict(kernel=(3, 3), stride=(2, 2), pool_type="avg",
         pooling_convention="full"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         pooling_convention="full", count_include_pad=False),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         count_include_pad=False),
    dict(kernel=(2, 2), stride=(1, 1), pool_type="sum"),
    dict(kernel=(3, 3), stride=(3, 3), pad=(2, 2), pool_type="max"),
    dict(pool_type="max", global_pool=True, kernel=(1, 1)),
    dict(pool_type="avg", global_pool=True, kernel=(1, 1),
         pooling_convention="full"),
]


@pytest.mark.parametrize("size", [7, 8, 9])
@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_pooling(case, size):
    x = _rand(2, 3, size, size, seed=case)
    _check(*run_both("Pooling", POOL_CASES[case], [x], diff=(0,)))


@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_pooling_full_keeps_a_window_that_starts_in_the_padding(pool_type):
    """d 3, kernel 1, stride 2, pad 1, full: MXNet's (and the JAX
    package's) last window lies wholly in the right padding, which
    torch's ceil_mode drops."""
    attrs = dict(kernel=(1, 1), stride=(2, 2), pad=(1, 1),
                 pool_type=pool_type, pooling_convention="full")
    jo, to, jg, tg = run_both("Pooling", attrs, [_rand(1, 2, 3, 3)],
                              diff=(0,))
    assert to[0].shape == (1, 2, 3, 3)
    _check(jo, to, jg, tg)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation(act):
    _check(*run_both("Activation", {"act_type": act},
                     [_rand(4, 7, scale=3)], diff=(0,)))


@pytest.mark.parametrize("flatten", [True, False])
@pytest.mark.parametrize("no_bias", [False, True])
def test_fully_connected(flatten, no_bias):
    x = _rand(3, 4, 6)
    w = _rand(5, 24 if flatten else 6, seed=1)
    inputs = [x, w] if no_bias else [x, w, _rand(5, seed=2)]
    _check(*run_both("FullyConnected", dict(num_hidden=5, flatten=flatten,
                                            no_bias=no_bias),
                     inputs, diff=range(len(inputs))))


BN_CASES = [
    dict(is_train=True, fix_gamma=False, relu=False),
    dict(is_train=True, fix_gamma=True, relu=False),
    dict(is_train=True, fix_gamma=False, relu=True),
    dict(is_train=False, fix_gamma=False, relu=False),
    dict(is_train=False, fix_gamma=False, relu=True),
    dict(is_train=True, fix_gamma=False, relu=False, big_mean=True),
    dict(is_train=True, fix_gamma=False, relu=False, two_d=True),
]


@pytest.mark.parametrize("case", range(len(BN_CASES)))
def test_batch_norm(case):
    c = BN_CASES[case]
    if c.get("two_d"):
        x = _rand(8, 5, seed=case)
    elif c.get("big_mean"):
        # the two-pass case: the one-pass E[x^2] - mean^2 cancels here
        x = _rand(4, 5, 6, 6, seed=case, scale=1e-2, shift=1e3)
    else:
        x = _rand(4, 5, 6, 6, seed=case)
    gamma = np.random.RandomState(9).uniform(0.5, 1.5, 5).astype(np.float32)
    beta = _rand(5, seed=10, scale=0.3)
    mm, mv = _rand(5, seed=11), np.random.RandomState(12).uniform(
        0.5, 2, 5).astype(np.float32)
    attrs = dict(eps=1e-5, momentum=0.9, fix_gamma=c["fix_gamma"])
    flags = {"__fuse_relu__": True} if c["relu"] else None
    jo, to, jg, tg = run_both("BatchNorm", attrs, [x, gamma, beta, mm, mv],
                              is_train=c["is_train"], diff=(0, 1, 2),
                              flags=flags)
    if c.get("big_mean"):
        # float32 resolves x only to ulp(1e3) = 6.1e-5, i.e. xhat to
        # ulp / std = 6.1e-3: any two summation orders of the mean differ
        # by that much after normalizing, so 4 such units, of the
        # tensor's largest magnitude, is the bound; the one-pass variance
        # would be negative here (NaN out), which the finiteness checks
        # below catch
        rtol = 4 * float(np.spacing(np.float32(1e3))) / 1e-2
    else:
        rtol = RTOL
    _check(jo, to, jg, tg, rtol=rtol)
    assert np.isfinite(to[0].detach().numpy()).all()
    assert all(np.isfinite(g.numpy()).all() for g in tg)
    if c["fix_gamma"]:
        assert not tg[1].any()


SMO_CASES = [
    dict(),
    dict(normalization="batch", grad_scale=0.5),
    dict(normalization="valid", use_ignore=True, ignore_label=2),
    dict(use_ignore=True, ignore_label=1),
    dict(smooth_alpha=0.1),
    dict(multi_output=True),
    dict(multi_output=True, use_ignore=True, ignore_label=0,
         normalization="valid"),
]


@pytest.mark.parametrize("case", range(len(SMO_CASES)))
def test_softmax_output_drops_its_cotangent(case):
    attrs = SMO_CASES[case]
    rng = np.random.RandomState(case)
    if attrs.get("multi_output"):
        x = _rand(3, 4, 5, seed=case)
        label = rng.randint(0, 4, (3, 5)).astype(np.float32)
    else:
        x = _rand(6, 4, seed=case)
        label = rng.randint(0, 4, (6,)).astype(np.float32)
    jo, to, jg, tg = run_both("SoftmaxOutput", attrs, [x, label], diff=(0,))
    _check(jo, to, jg, tg)
    # the gradient is the implied loss's, whatever the cotangent: a second
    # cotangent gives the same gradient
    ts = treg.get_op("SoftmaxOutput")
    t = torch.from_numpy(x).requires_grad_(True)
    out = ts.fcompute(ts.parse_attrs(attrs), treg.OpCtx(), t,
                      torch.from_numpy(label))[0]
    g2 = torch.autograd.grad(out, t, torch.full_like(out, 3.0))[0]
    np.testing.assert_array_equal(g2.numpy(), tg[0].numpy())


def test_softmax_output_probability_labels():
    x = _rand(4, 3)
    p = np.random.RandomState(1).dirichlet(np.ones(3), 4).astype(np.float32)
    _check(*run_both("SoftmaxOutput", {}, [x, p], diff=(0,)))


@pytest.mark.parametrize("shape,spec", [
    ((2, 3, 4), (0, -1)), ((2, 3, 4), (-1,)), ((2, 3, 4), (-2,)),
    ((2, 3, 4), (-3, 0)), ((2, 3, 4), (0, -4, 1, -1, 0)),
    ((2, 3, 4), (4, -1)), ((2, 3, 4, 5), (-3, -3)),
    ((2, 3, 4), (0, 0, -4, 2, 2)), ((6, 4), (-4, 2, -1, 0))])
def test_reshape_codes(shape, spec):
    x = _rand(*shape)
    _check(*run_both("Reshape", {"shape": spec}, [x], diff=(0,)))
    _check(*run_both("Reshape", {"shape": str(spec)}, [x]))


def test_reshape_reverse():
    _check(*run_both("Reshape", {"shape": (-1, 0), "reverse": True},
                     [_rand(2, 3, 4)]))


OPT_CASES = [
    ("sgd_update", dict(lr=0.1, wd=0.01, rescale_grad=0.5), 0),
    ("sgd_update", dict(lr=0.1, clip_gradient=0.3), 0),
    ("sgd_mom_update", dict(lr=0.05, momentum=0.9, wd=1e-3,
                            rescale_grad=1 / 8., clip_gradient=0.2), 1),
    ("mp_sgd_update", dict(lr=0.1, wd=0.01), 1),
    ("mp_sgd_mom_update", dict(lr=0.1, momentum=0.9, wd=0.01), 2),
    ("adam_update", dict(lr=0.01, wd=0.01, rescale_grad=0.25,
                         clip_gradient=0.5), 2),
    ("adam_update", dict(lr=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6), 2),
]


@pytest.mark.parametrize("case", range(len(OPT_CASES)))
def test_optimizer_ops(case):
    name, attrs, n_states = OPT_CASES[case]
    rng = np.random.RandomState(case)
    w = rng.standard_normal((5, 4)).astype(np.float32)
    g = rng.standard_normal((5, 4)).astype(np.float32)
    states = [np.abs(rng.standard_normal((5, 4))).astype(np.float32)
              for _ in range(n_states)]
    if name.startswith("mp_"):
        states[-1] = w.copy()                       # the float32 master
        w = w.astype(np.float16)
        g = g.astype(np.float16)
    jo, to, _, _ = run_both(name, attrs, [w, g] + states)
    assert len(jo) == len(to) == 1 + n_states
    for a, b in zip(to, jo):
        assert a.dtype == {np.dtype("float16"): torch.float16,
                           np.dtype("float32"): torch.float32}[
            np.asarray(b).dtype]
        _close(a.float().numpy(), np.asarray(b).astype(np.float32),
               1e-3 if a.dtype == torch.float16 else 1e-6)


TENSOR_CASES = [
    ("broadcast_add", {}, [(3, 1, 4), (1, 5, 4)], True),
    ("broadcast_mul", {}, [(3, 4), (4,)], True),
    ("broadcast_div", {}, [(3, 4), (3, 1)], False),
    ("broadcast_greater", {}, [(3, 4), (3, 4)], False),
    ("elemwise_sub", {}, [(3, 4), (3, 4)], True),
    ("_rminus_scalar", {"scalar": 2.5}, [(3, 4)], True),
    ("_rdiv_scalar", {"scalar": 2.0}, [(3, 4)], False),
    ("_power_scalar", {"scalar": 2.0}, [(3, 4)], True),
    ("_lesser_equal_scalar", {"scalar": 0.1}, [(3, 4)], False),
    ("sum", {"axis": (1,), "keepdims": True}, [(3, 4, 5)], True),
    ("sum", {"axis": 1, "exclude": True}, [(3, 4, 5)], True),
    ("mean", {}, [(3, 4)], True),
    ("max", {"axis": -1}, [(3, 4)], True),
    ("prod", {"axis": (0, 2)}, [(2, 3, 2)], True),
    ("norm", {"ord": 2, "axis": 1}, [(3, 4)], True),
    ("argmax", {"axis": 1}, [(3, 4)], False),
    ("argmin", {}, [(3, 4)], False),
    ("dot", {}, [(3, 4), (4, 5)], True),
    ("dot", {"transpose_a": True}, [(4, 3), (4, 5)], True),
    ("dot", {"transpose_b": True}, [(2, 3, 4), (5, 4)], True),
    ("batch_dot", {"transpose_b": True}, [(2, 3, 4), (2, 5, 4)], True),
    ("Flatten", {}, [(2, 3, 4)], True),
    ("transpose", {}, [(2, 3, 4)], True),
    ("transpose", {"axes": (1, 0, 2)}, [(2, 3, 4)], True),
    ("expand_dims", {"axis": 1}, [(2, 3)], True),
    ("squeeze", {"axis": (1,)}, [(2, 1, 3)], True),
    ("slice", {"begin": (0, 1), "end": (2, None)}, [(3, 4)], True),
    ("slice", {"begin": "(None, 1)", "end": "(None, 3)",
               "step": "(1, 2)"}, [(3, 5)], True),
    ("slice_axis", {"axis": 1, "begin": 1, "end": 3}, [(3, 4)], True),
    ("clip", {"a_min": -0.5, "a_max": 0.5}, [(3, 4)], True),
    ("Concat", {"dim": 1, "num_args": 2}, [(2, 3), (2, 2)], True),
    ("add_n", {"num_args": 3}, [(2, 3), (2, 3), (2, 3)], True),
    ("broadcast_to", {"shape": (3, 0, 4)}, [(1, 2, 4)], True),
    ("Cast", {"dtype": "float16"}, [(3, 4)], False),
    ("_copy", {}, [(3, 4)], True),
    ("BlockGrad", {}, [(3, 4)], False),
    ("softmax", {"axis": 0}, [(3, 4)], True),
    ("log_softmax", {"temperature": 2.0}, [(3, 4)], True),
    ("zeros_like", {}, [(3, 4)], False),
    ("ones_like", {}, [(3, 4)], False),
    ("square", {}, [(3, 4)], True),
    ("exp", {}, [(3, 4)], True),
    ("negative", {}, [(3, 4)], True),
    ("abs", {}, [(3, 4)], True),
    ("sigmoid", {}, [(3, 4)], True),
    ("relu", {}, [(3, 4)], True),
]


@pytest.mark.parametrize("case", range(len(TENSOR_CASES)))
def test_tensor_ops(case):
    name, attrs, shapes, grad = TENSOR_CASES[case]
    inputs = [_rand(*s, seed=case + i) for i, s in enumerate(shapes)]
    out = run_both(name, attrs, inputs,
                   diff=range(len(inputs)) if grad else ())
    _check(*out)


@pytest.mark.parametrize("name,attrs", [
    ("take", {"axis": 0, "mode": "clip"}), ("take", {"axis": 1,
                                                     "mode": "wrap"}),
    ("pick", {"axis": -1}), ("pick", {"axis": 0, "keepdims": True}),
    ("one_hot", {"depth": 5, "on_value": 2.0, "off_value": -1.0})])
def test_indexing_ops(name, attrs):
    x = _rand(4, 5)
    idx = np.array([[0, 6], [-1, 2]], np.float32)
    if name == "pick":
        idx = np.array([0, 4, 2, 1, 3], np.float32)[:x.shape[0]] \
            if attrs["axis"] == -1 else np.array([0, 3, 2, 1, 3], np.float32)
        idx = idx[:4] if attrs["axis"] == -1 else idx
        out = run_both(name, attrs, [x, idx], diff=(0,))
    elif name == "one_hot":
        out = run_both(name, attrs, [np.array([0, 4, 7, -1], np.float32)])
    else:
        out = run_both(name, attrs, [x, idx], diff=(0,))
    _check(*out)


@pytest.mark.parametrize("name,attrs", [
    ("_zeros", {"shape": (2, 3)}), ("_ones", {"shape": (4,),
                                              "dtype": "int32"}),
    ("_full", {"shape": (2, 2), "value": 1.5}),
    ("_arange", {"start": 1, "stop": 7, "step": 1.5, "repeat": 2})])
def test_init_ops(name, attrs):
    jo = jreg.get_op(name).fcompute(jreg.get_op(name).parse_attrs(attrs),
                                    jreg.OpCtx())
    ts = treg.get_op(name)
    to = ts.fcompute(ts.parse_attrs(attrs), treg.OpCtx(device="cpu"))
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo[0]))
    assert str(np.asarray(jo[0]).dtype) == str(to[0].numpy().dtype)


def test_the_path_ops_share_the_jax_schema():
    """Every op of the path has the JAX package's inputs, aux and params."""
    for name in ("Convolution", "FullyConnected", "Pooling", "Activation",
                 "BatchNorm", "SoftmaxOutput", "Dropout", "softmax",
                 "log_softmax", "Reshape", "Flatten", "sgd_mom_update",
                 "adam_update", "mp_sgd_mom_update", "elemwise_add",
                 "Concat", "add_n", "one_hot"):
        j, t = jreg.get_op(name), treg.get_op(name)
        assert list(j.input_names) == list(t.input_names), name
        assert tuple(j.aux_indices) == tuple(t.aux_indices), name
        assert set(j.params) == set(t.params), name
        assert {k: p.default for k, p in j.params.items()} == \
            {k: p.default for k, p in t.params.items()}, name
        assert (j.mutates_aux, j.aux_always, j.needs_rng,
                j.key_var_num_args) == (t.mutates_aux, t.aux_always,
                                        t.needs_rng, t.key_var_num_args)


def test_dropout_draws_from_the_given_generator():
    s = treg.get_op("Dropout")
    x = torch.ones(1000)
    a = s.parse_attrs({"p": 0.25})
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    y1 = s.fcompute(a, treg.OpCtx(is_train=True, rng=g1), x)[0]
    y2 = s.fcompute(a, treg.OpCtx(is_train=True, rng=g2), x)[0]
    assert torch.equal(y1, y2)
    assert set(np.unique(y1.numpy()).tolist()) <= {
        0.0, float(np.float32(1) / np.float32(0.75))}
    assert abs(float((y1 == 0).float().mean()) - 0.25) < 0.05
    # inference: identity
    assert torch.equal(s.fcompute(a, treg.OpCtx(is_train=False), x)[0], x)


def test_batch_norm_takes_float64_statistics_for_float64_data():
    """float64 data keeps float64 through BatchNorm (statistics, output,
    gradients), so a float64 step can serve as the reference of a
    float32 one (chip_smoke.py's ResNet-50 check); numpy is the oracle."""
    x = _rand(4, 3, 5, 5, shift=1e3).astype(np.float64)
    g, b = np.full(3, 1.5), np.full(3, 0.25)
    s = treg.get_op("BatchNorm")
    a = s.parse_attrs(dict(fix_gamma=False, eps=1e-5))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, mean, var = s.fcompute(a, treg.OpCtx(is_train=True), tx,
                                torch.from_numpy(g), torch.from_numpy(b),
                                torch.zeros(3, dtype=torch.float64),
                                torch.ones(3, dtype=torch.float64))
    assert out.dtype == mean.dtype == var.dtype == torch.float64
    m = x.mean(axis=(0, 2, 3), keepdims=True)
    v = x.var(axis=(0, 2, 3), keepdims=True)
    want = (x - m) / np.sqrt(v + 1e-5) * 1.5 + 0.25
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-12,
                               atol=1e-9)
    np.testing.assert_allclose(var.numpy(), 0.1 * v.ravel() + 0.9,
                               rtol=1e-12)
    (gx,) = torch.autograd.grad(out.sum(), tx)
    assert gx.dtype == torch.float64 and np.abs(gx.numpy()).max() < 1e-9
