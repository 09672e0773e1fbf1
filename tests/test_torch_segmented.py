"""group2ctx model parallelism in the port (``executor._Placement``)
against the JAX package's (``_SegmentedRunner``), on the CPU: the six
cases of tests/test_segmented_mp.py, the JAX side over two of the CPU
devices tests/conftest.py gives it.

The port's walk is eager, so "compiled once per stage" becomes "split
into the same stages": the topological order's maximal same-device runs.
On the host every ``cpu(i)`` is one torch device, so a placement is read
from the executor's record of each node's context (``Executor.placement``)
and no copy is made; the card test moves a head group to the host.

Tolerances, stated before the runs: outputs, gradients and aux states
against the JAX package's segmented executor within the JAX test's own
bounds (outputs and aux rtol 2e-5 / atol 1e-6, gradients rtol 2e-4 /
atol 1e-5). The dropout case holds the port's segmented walk against its
own single walk, bit for bit: the random streams differ between the
packages.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

OUT_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)


def _staged_sym(mx, stages=4, hidden=16):
    x = mx.sym.Variable("data")
    for s in range(stages):
        with mx.AttrScope(ctx_group=f"stage{s}"):
            x = mx.sym.FullyConnected(x, num_hidden=hidden, name=f"fc{s}")
            x = mx.sym.BatchNorm(x, name=f"bn{s}")
            x = mx.sym.Activation(x, act_type="relu")
    with mx.AttrScope(ctx_group=f"stage{stages - 1}"):
        x = mx.sym.FullyConnected(x, num_hidden=3, name="head")
    return mx.sym.SoftmaxOutput(x, name="softmax")


def _bind(mx, sym, stages, **shapes):
    g2c = {f"stage{s}": mx.Context("cpu", s % 2) for s in range(stages)}
    return sym.simple_bind(mx.cpu(0), group2ctx=g2c, **shapes)


def _set(exs, rng, scale=0.1):
    for k in exs[0].arg_dict:
        v = rng.normal(0, scale, exs[0].arg_dict[k].shape).astype(np.float32)
        for ex in exs:
            ex.arg_dict[k][:] = v


def _nd(mx, a):
    return mx.nd.array(a, ctx=mx.cpu())


def test_stages_across_steps():
    """Five training steps of the 4-stage MLP: the same stages as the JAX
    package's segments, and every step's outputs and gradients equal to
    its."""
    j = _bind(jmx, _staged_sym(jmx), 4, data=(8, 12), softmax_label=(8,))
    t = _bind(tmx, _staged_sym(tmx), 4, data=(8, 12), softmax_label=(8,))
    _set([j, t], np.random.RandomState(0))
    rng = np.random.RandomState(1)
    for _ in range(5):
        x = rng.normal(size=(8, 12)).astype(np.float32)
        y = rng.randint(0, 3, 8).astype(np.float32)
        for mx, ex in ((jmx, j), (tmx, t)):
            ex.forward(is_train=True, data=_nd(mx, x),
                       softmax_label=_nd(mx, y))
            ex.backward()
        np.testing.assert_allclose(t.outputs[0].asnumpy(),
                                   j.outputs[0].asnumpy(), **OUT_TOL)
        for k in j.grad_dict:
            np.testing.assert_allclose(t.grad_dict[k].asnumpy(),
                                       j.grad_dict[k].asnumpy(),
                                       err_msg=k, **GRAD_TOL)
    jseg = j._segmented_train.segments
    assert len(t.segments) == len(jseg) >= 4
    assert [len(ns) for _, ns in t.segments] == \
        [len(s["pos"]) for s in jseg]


def test_stage_placement():
    """Each node runs on its group's context and its outputs land there;
    the outputs equal the JAX package's, whose result lies on device 3."""
    import jax
    outs = {}
    for mx in (jmx, tmx):
        with mx.AttrScope(ctx_group="dev1"):
            a = mx.sym.Variable("a")
            h = mx.sym.FullyConnected(a, num_hidden=8, name="fc1")
        with mx.AttrScope(ctx_group="dev2"):
            out = mx.sym.FullyConnected(h, num_hidden=4, name="fc2")
        ex = out.simple_bind(mx.cpu(0), a=(2, 6),
                             group2ctx={"dev1": mx.cpu(0),
                                        "dev2": mx.cpu(3)})
        _set([ex], np.random.RandomState(3), 1.0)
        outs[mx] = (ex, ex.forward(is_train=True)[0])
    devs = jax.local_devices(backend="cpu")
    assert list(outs[jmx][1]._data.devices())[0] == devs[3]
    ex, res = outs[tmx]
    assert ex.placement == {"fc1": tmx.cpu(0), "fc2": tmx.cpu(3)}
    assert res._data.device == tmx.cpu(3).torch_device()
    np.testing.assert_allclose(res.asnumpy(), outs[jmx][1].asnumpy(),
                               **OUT_TOL)


def test_matches_single_program_fwd_bwd_aux():
    """Same params, same batch: the port's staged executor equals the JAX
    package's staged executor (outputs, every gradient, the BatchNorm aux
    updates) and the port's unplaced one."""
    rng = np.random.RandomState(1)
    x = rng.normal(size=(8, 12)).astype(np.float32)
    y = rng.randint(0, 3, 8).astype(np.float32)
    j = _bind(jmx, _staged_sym(jmx, 3), 3, data=(8, 12), softmax_label=(8,))
    ts = _staged_sym(tmx, 3)
    t = _bind(tmx, ts, 3, data=(8, 12), softmax_label=(8,))
    ref = ts.simple_bind(tmx.cpu(0), data=(8, 12), softmax_label=(8,))
    _set([j, t, ref], rng)
    for mx, ex in ((jmx, j), (tmx, t), (tmx, ref)):
        ex.forward(is_train=True, data=_nd(mx, x), softmax_label=_nd(mx, y))
        ex.backward()
    for other, tol in ((j, GRAD_TOL), (ref, dict(rtol=0, atol=0))):
        np.testing.assert_allclose(t.outputs[0].asnumpy(),
                                   other.outputs[0].asnumpy(),
                                   **(OUT_TOL if other is j else tol))
        for k in other.grad_dict:
            np.testing.assert_allclose(t.grad_dict[k].asnumpy(),
                                       other.grad_dict[k].asnumpy(),
                                       err_msg=k, **tol)
        for k in other.aux_dict:
            np.testing.assert_allclose(t.aux_dict[k].asnumpy(),
                                       other.aux_dict[k].asnumpy(),
                                       err_msg=k,
                                       **(OUT_TOL if other is j else tol))


def test_eval_path_segmented_and_matches():
    rng = np.random.RandomState(2)
    j = _bind(jmx, _staged_sym(jmx, 3), 3, data=(8, 12), softmax_label=(8,))
    t = _bind(tmx, _staged_sym(tmx, 3), 3, data=(8, 12), softmax_label=(8,))
    _set([j, t], rng)
    x = rng.normal(size=(8, 12)).astype(np.float32)
    a = t.forward(is_train=False, data=_nd(tmx, x))[0].asnumpy()
    b = j.forward(is_train=False, data=_nd(jmx, x))[0].asnumpy()
    np.testing.assert_allclose(a, b, **OUT_TOL)
    assert hasattr(j, "_segmented_eval")
    assert len(t.segments) == len(j._segmented_eval.segments)


def test_dropout_rng_stage_chain():
    """Dropout in a stage: two training forwards draw different masks,
    and the segmented walk equals the port's own single walk from the
    same generator state; three stages (the untagged loss on the
    executor's context)."""
    def build(mx):
        x = mx.sym.Variable("data")
        with mx.AttrScope(ctx_group="s0"):
            h = mx.sym.FullyConnected(x, num_hidden=32, name="fc0")
            h = mx.sym.Dropout(h, p=0.5)
        with mx.AttrScope(ctx_group="s1"):
            out = mx.sym.FullyConnected(h, num_hidden=32, name="fc1")
        return mx.sym.MakeLoss(mx.sym.sum(out))
    sym = build(tmx)
    ex = sym.simple_bind(tmx.cpu(0), data=(4, 8),
                         group2ctx={"s0": tmx.cpu(0), "s1": tmx.cpu(1)})
    single = sym.simple_bind(tmx.cpu(0), data=(4, 8))
    rng = np.random.RandomState(5)
    _set([ex, single], rng, 1.0)
    d = _nd(tmx, rng.normal(size=(4, 8)).astype(np.float32))
    tmx.random.seed(7)
    o1 = ex.forward(is_train=True, data=d)[0].asnumpy()
    o2 = ex.forward(is_train=True, data=d)[0].asnumpy()
    assert not np.allclose(o1, o2)
    tmx.random.seed(7)
    s1 = single.forward(is_train=True, data=d)[0].asnumpy()
    assert np.array_equal(o1, s1)
    assert [(c, len(ns)) for c, ns in ex.segments] == \
        [(tmx.cpu(0), 2), (tmx.cpu(1), 1), (tmx.cpu(0), 2)]


def test_variable_output_in_group():
    """Group([Variable, net]) under group2ctx: the bare variable output is
    its bound value, and the backward takes a cotangent for each. The
    layer's gradients equal the JAX package's; the variable's own
    gradient equals the port's unplaced walk's, which adds the variable
    output's cotangent (the JAX package's executors, placed or not, drop
    it)."""
    got, execs = {}, []
    for mx in (jmx, tmx, tmx):
        with mx.AttrScope(ctx_group="g1"):
            a = mx.sym.Variable("a")
            h = mx.sym.FullyConnected(a, num_hidden=4, name="fc")
        grouped = mx.sym.Group([mx.sym.Variable("a"), h])
        kw = {} if len(execs) == 2 else {"group2ctx": {"g1": mx.cpu(1)}}
        ex = grouped.simple_bind(mx.cpu(0), a=(2, 3), **kw)
        _set([ex], np.random.RandomState(0), 1.0)
        outs = ex.forward(is_train=True)
        np.testing.assert_allclose(outs[0].asnumpy(),
                                   ex.arg_dict["a"].asnumpy())
        assert outs[1].shape == (2, 4)
        ex.backward([mx.nd.ones((2, 3), ctx=mx.cpu()),
                     mx.nd.ones((2, 4), ctx=mx.cpu())])
        execs.append({k: v.asnumpy() for k, v in ex.grad_dict.items()})
    jg, tg, single = execs
    for k in ("fc_weight", "fc_bias"):
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **GRAD_TOL)
    for k in single:
        assert np.array_equal(tg[k], single[k]), k
    np.testing.assert_allclose(tg["a"], jg["a"] + 1.0, **GRAD_TOL)
