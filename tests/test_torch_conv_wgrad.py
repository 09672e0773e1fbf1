"""The convolution's float32 weight gradient route and the ops' half
precision, against the JAX package, on the CPU.

* ``_wgrad_route`` sends every float32 2-D convolution with a 5 x 5
  kernel at stride 1 (groups 1, dilation 1) to ``_conv_wgrad_gemm``: on
  the H100, cuDNN's heuristic picks a lossy weight-gradient algorithm
  for some of those shapes (PERF.md,
  ``tools/torch_f32_witness.py --sweep``). The route is decided from
  shape and type alone. On the CPU the GEMM route and PyTorch's own
  weight gradient are both float32 sums of the same products: each within
  F32_RTOL of float64 and of each other.
* bfloat16 through FullyConnected, Convolution, Pooling, Activation,
  BatchNorm and SoftmaxOutput as the JAX ops cast: bf16 outputs (BN's
  statistics and moving averages float32), values within HALF_RTOL (two
  bf16 units, 2^-7, of the largest magnitude: the two frameworks round
  their bf16 products and sums at other places).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx  # noqa: F401
from mxnet_tpu_torch.ops import nn as nnops
from mxnet_tpu_torch.ops import registry as treg

F32_RTOL = 1e-5
HALF_RTOL = 2 ** -7

# (x shape, w shape, stride, dilate, groups, dtype) -> route
ROUTES = [
    ((8, 1, 28, 28), (20, 1, 5, 5), (1, 1), (1, 1), 1, "float32", "gemm"),
    ((2, 64, 56, 56), (64, 64, 5, 5), (1, 1), (1, 1), 1, "float32", "gemm"),
    ((2, 64, 56, 56), (64, 64, 3, 3), (1, 1), (1, 1), 1, "float32", "cudnn"),
    ((2, 4, 9, 9), (3, 4, 5, 5), (2, 2), (1, 1), 1, "float32", "cudnn"),
    ((2, 3, 9, 9), (8, 3, 7, 7), (1, 1), (1, 1), 1, "float32", "cudnn"),
    ((2, 8, 9, 9), (8, 8, 1, 1), (1, 1), (1, 1), 1, "float32", "cudnn"),
    ((2, 4, 9, 9), (4, 2, 3, 3), (1, 1), (1, 1), 2, "float32", "cudnn"),
    ((2, 4, 9, 9), (4, 4, 3, 3), (1, 1), (2, 2), 1, "float32", "cudnn"),
    ((2, 4, 9, 9), (4, 4, 3, 3), (1, 1), (1, 1), 1, "bfloat16", "cudnn"),
    ((2, 4, 9, 9), (4, 4, 3, 3), (1, 1), (1, 1), 1, "float64", "cudnn"),
    ((2, 4, 9), (4, 4, 3), (1,), (1,), 1, "float32", "cudnn"),
    ((2, 4, 9, 9), (4, 4, 3, 5), (1, 1), (1, 1), 1, "float32", "cudnn"),
]


@pytest.mark.parametrize("xs,ws,stride,dilate,groups,dt,route", ROUTES)
def test_route_is_decided_by_shape_alone(xs, ws, stride, dilate, groups,
                                         dt, route):
    dtype = getattr(torch, dt)
    for seed in (0, 1):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(xs, generator=g).to(dtype)
        w = torch.randn(ws, generator=g).to(dtype)
        assert nnops._wgrad_route(x, w, stride, dilate, groups) == route
    meta = torch.empty(xs, dtype=dtype, device="meta")
    assert nnops._wgrad_route(meta, torch.empty(ws, device="meta"), stride,
                              dilate, groups) == route


CASES = [(8, 1, 20, 28, 5, 2), (8, 20, 50, 12, 5, 0), (2, 64, 8, 14, 3, 1),
         (4, 3, 6, 11, 3, 0), (3, 2, 4, 9, 5, 1)]


def _wgrads(n, ci, co, hw, k, pad, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, (n, ci, hw, hw)).astype(np.float32)
    w = rng.standard_normal((co, ci, k, k)).astype(np.float32)
    ho = hw + 2 * pad - k + 1
    dy = rng.standard_normal((n, co, ho, ho)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, w, dy)]


@pytest.mark.parametrize("n,ci,co,hw,k,pad", CASES)
def test_gemm_weight_gradient_holds_float32(n, ci, co, hw, k, pad):
    x, w, dy = _wgrads(n, ci, co, hw, k, pad)
    ref = torch.ops.aten.convolution_backward(
        dy.double(), x.double(), w.double(), None, [1, 1], [pad, pad],
        [1, 1], False, [0, 0], 1, [False, True, False])[1]
    gemm = nnops._conv_wgrad_gemm(dy, x, w.shape, (1, 1), (pad, pad),
                                  (1, 1))
    aten = torch.ops.aten.convolution_backward(
        dy, x, w, None, [1, 1], [pad, pad], [1, 1], False, [0, 0], 1,
        [False, True, False])[1]
    scale = ref.abs().max().item()
    assert gemm.dtype == torch.float32
    assert (gemm.double() - ref).abs().max().item() <= F32_RTOL * scale
    assert (aten.double() - ref).abs().max().item() <= F32_RTOL * scale
    assert (gemm - aten).abs().max().item() <= F32_RTOL * scale


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("n,ci,co,hw,k,pad", CASES[:3])
def test_conv_backward_through_the_route(n, ci, co, hw, k, pad, bias):
    """``_Conv``'s backward: dW from the GEMM, dX and the bias gradient
    from the same convolution_backward call as before."""
    x, w, dy = _wgrads(n, ci, co, hw, k, pad, seed=1)
    b = torch.randn(co) if bias else None
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    bl = b.clone().requires_grad_() if bias else None
    y = nnops._Conv.apply(xl, wl, bl, (1, 1), (pad, pad), (1, 1), 1, False)
    grads = torch.autograd.grad(y, [t for t in (xl, wl, bl)
                                    if t is not None], dy)
    ref = torch.ops.aten.convolution_backward(
        dy, x, w, [co] if bias else None, [1, 1], [pad, pad], [1, 1], False,
        [0, 0], 1, [True, True, bias])
    torch.testing.assert_close(grads[0], ref[0], rtol=0, atol=0)
    scale = ref[1].abs().max().item()
    assert (grads[1] - ref[1]).abs().max().item() <= F32_RTOL * scale
    if bias:
        torch.testing.assert_close(grads[2], ref[2], rtol=0, atol=0)


def test_routed_gradient_matches_jax():
    """LeNet's c1 (1 -> 20, 5 x 5, batch 8): the port's weight gradient
    (the GEMM route) against the JAX package's Convolution vjp."""
    import jax
    x, w, dy = _wgrads(8, 1, 20, 28, 5, 0, seed=2)
    attrs = dict(kernel=(5, 5), num_filter=20, no_bias=True)
    jop = jreg.get_op("Convolution")

    def f(wj):
        return jop.fcompute(jop.parse_attrs(attrs), jreg.OpCtx(is_train=True),
                            jnp.asarray(x.numpy()), wj)[0]
    _, vjp = jax.vjp(f, jnp.asarray(w.numpy()))
    jdw = np.asarray(vjp(jnp.asarray(dy.numpy()))[0])
    top = treg.get_op("Convolution")
    wl = w.clone().requires_grad_()
    y = top.fcompute(top.parse_attrs(attrs), treg.OpCtx(is_train=True), x,
                     wl)[0]
    tdw = torch.autograd.grad(y, wl, dy)[0].numpy()
    assert np.abs(tdw - jdw).max() <= F32_RTOL * np.abs(jdw).max()


def _half_close(got, want, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(1e-30, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= HALF_RTOL * scale, f"{what}: {err} > {HALF_RTOL} * {scale}"


def _run_both(name, attrs, arrays, is_train=True, half=None):
    """The op's outputs in both packages; ``half`` names the inputs given
    in bfloat16 (default: all)."""
    half = set(range(len(arrays))) if half is None else set(half)
    jx = [jnp.asarray(a, jnp.bfloat16) if i in half else jnp.asarray(a)
          for i, a in enumerate(arrays)]
    tx = [torch.from_numpy(a).to(torch.bfloat16) if i in half
          else torch.from_numpy(a) for i, a in enumerate(arrays)]
    js, ts = jreg.get_op(name), treg.get_op(name)
    jo = js.fcompute(js.parse_attrs(attrs), jreg.OpCtx(is_train=is_train),
                     *jx)
    to = ts.fcompute(ts.parse_attrs(attrs),
                     treg.OpCtx(is_train=is_train, device="cpu"), *tx)
    return jo, to


HALF_OPS = [
    ("FullyConnected", dict(num_hidden=6), [(4, 10), (6, 10), (6,)]),
    ("FullyConnected", dict(num_hidden=6, no_bias=True),
     [(4, 2, 5), (6, 10)]),
    ("Convolution", dict(kernel=(3, 3), num_filter=5, pad=(1, 1)),
     [(2, 3, 8, 8), (5, 3, 3, 3), (5,)]),
    ("Convolution", dict(kernel=(5, 5), num_filter=4, stride=(2, 2)),
     [(2, 2, 11, 11), (4, 2, 5, 5), (4,)]),
    ("Pooling", dict(kernel=(2, 2), stride=(2, 2), pool_type="max"),
     [(2, 3, 8, 8)]),
    ("Pooling", dict(kernel=(3, 3), stride=(2, 2), pool_type="avg",
                     pad=(1, 1)), [(2, 3, 9, 9)]),
    ("Pooling", dict(global_pool=True, kernel=(1, 1), pool_type="avg"),
     [(2, 3, 7, 7)]),
    ("Activation", dict(act_type="relu"), [(3, 7)]),
    ("Activation", dict(act_type="tanh"), [(3, 7)]),
    ("Activation", dict(act_type="sigmoid"), [(3, 7)]),
]


@pytest.mark.parametrize("name,attrs,shapes", HALF_OPS,
                         ids=[f"{o[0]}{i}" for i, o in enumerate(HALF_OPS)])
def test_bf16_ops_cast_as_jax(name, attrs, shapes):
    rng = np.random.RandomState(len(shapes))
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    half = [0, 1] if name in ("FullyConnected", "Convolution") else None
    # biases stay float32 (the trainer casts them; the op casts at the
    # use site either way)
    jo, to = _run_both(name, attrs, arrays, half=half)
    assert str(to[0].dtype).split(".")[-1] == str(jo[0].dtype) == \
        "bfloat16"
    _half_close(to[0], jo[0], name)


@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("is_train", [True, False])
def test_bf16_batchnorm_keeps_float32_statistics(is_train, fix_gamma):
    rng = np.random.RandomState(7)
    c = 4
    arrays = [rng.standard_normal((3, c, 5, 5)).astype(np.float32) * 2 + 1,
              rng.uniform(0.5, 1.5, c).astype(np.float32),
              rng.standard_normal(c).astype(np.float32),
              rng.standard_normal(c).astype(np.float32) * 0.1,
              rng.uniform(0.5, 1.5, c).astype(np.float32)]
    attrs = dict(fix_gamma=fix_gamma, eps=1e-3, momentum=0.9)
    jo, to = _run_both("BatchNorm", attrs, arrays, is_train=is_train,
                       half=[0, 1, 2])
    assert to[0].dtype == torch.bfloat16 and str(jo[0].dtype) == "bfloat16"
    _half_close(to[0], jo[0], "out")
    for i in (1, 2):
        assert to[i].dtype == torch.float32 and str(jo[i].dtype) == \
            "float32"
        np.testing.assert_allclose(to[i].numpy(), np.asarray(jo[i]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
def test_bf16_softmax_output_and_its_gradient(normalization):
    import jax
    rng = np.random.RandomState(3)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    y = rng.randint(0, 5, 6).astype(np.float32)
    attrs = dict(normalization=normalization, grad_scale=0.5)
    js, ts = jreg.get_op("SoftmaxOutput"), treg.get_op("SoftmaxOutput")
    ja = js.parse_attrs(attrs)

    def f(d):
        return js.fcompute(ja, jreg.OpCtx(is_train=True), d,
                           jnp.asarray(y))[0]
    jout, vjp = jax.vjp(f, jnp.asarray(x, jnp.bfloat16))
    jgrad = vjp(jnp.ones_like(jout))[0]
    xl = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tout = ts.fcompute(ts.parse_attrs(attrs), treg.OpCtx(is_train=True), xl,
                       torch.from_numpy(y))[0]
    tgrad = torch.autograd.grad(tout, xl, torch.ones_like(tout))[0]
    assert tout.dtype == tgrad.dtype == torch.bfloat16
    assert str(jout.dtype) == str(jgrad.dtype) == "bfloat16"
    _half_close(tout, jout, "out")
    _half_close(tgrad, jgrad, "grad")
