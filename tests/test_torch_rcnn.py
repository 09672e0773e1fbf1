"""A small Faster R-CNN trained in both packages on the CPU.

The network, the proposal_target Custom op and the anchor assignment of
tools/torch_rcnn.py (the card's faster_rcnn phase uses the same
definitions at VGG16's widths), cut to size: two convolution stages
(8 and 16 filters, each followed by a 4 x 4 max pool: stride 16), a
64 x 96 image, anchors at scales 1 and 2 (so that some fit the image),
Proposal 300 -> 64 boxes, 16 sampled rois, fc6 / fc7 of 32, no dropout
(the packages' generators differ). Both packages' Modules take the same
seeded parameters and images; 3 SGD steps (momentum 0.9, wd 5e-4):
every loss term and parameter within 1e-4, the proposals and the
sampled rois of a step within 1e-5 of their magnitude (the same rows).
"""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import torch_rcnn as R  # noqa: E402

STAGES = ((1, 8, 4), (1, 16, 4))
SCALES = (1, 2)
HW = (64, 96)
STEPS = 3
TOL = 1e-4


def _symbol(mx):
    with mx.NameManager():
        return R.faster_rcnn_symbol(mx, stages=STAGES, rpn_pre=300,
                                    rpn_post=64, batch_rois=16, hidden=32,
                                    dropout=0, scales=SCALES)


def _train(mx, ctx, d, params):
    sym = _symbol(mx)
    mod = mx.mod.Module(sym, data_names=R.DATA_NAMES,
                        label_names=R.LABEL_NAMES, context=ctx,
                        fixed_param_names=R.fixed_param_names(STAGES, 1))
    ins = R.input_shapes(*HW, stages=STAGES, scales=SCALES)
    mod.bind(data_shapes=[(k, ins[k]) for k in R.DATA_NAMES],
             label_shapes=[(k, ins[k]) for k in R.LABEL_NAMES])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                for k, v in params.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
        learning_rate=0.01, momentum=0.9, wd=5e-4))
    losses = []
    for i in range(STEPS):
        b = mx.io.DataBatch(
            data=[mx.nd.array(d[k][i:i + 1], ctx=ctx) for k in R.DATA_NAMES],
            label=[mx.nd.array(d[k][i:i + 1], ctx=ctx)
                   for k in R.LABEL_NAMES])
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
        losses.append(R.losses([o.asnumpy() for o in mod.get_outputs()],
                               d["label"][i]))
    return losses, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.fixture(scope="module")
def runs():
    d = R.synthetic_images(STEPS, *HW, 21, seed=1, stages=STAGES,
                           scales=SCALES)
    params = R.init_params(R.param_shapes(_symbol(tmx), *HW, stages=STAGES,
                                          scales=SCALES), seed=0)
    with tmx.cpu():
        port = _train(tmx, tmx.cpu(), d, params)
    return port, _train(jmx, jmx.cpu(), d, params), d


def test_losses_match_the_jax_package(runs):
    (tl, _), (jl, _), _ = runs
    for a, b in zip(tl, jl):
        for k in a:
            assert abs(a[k] - b[k]) <= TOL * max(1.0, abs(b[k])), (k, a, b)
    assert tl[-1]["rpn_log_loss"] < tl[0]["rpn_log_loss"]


def test_parameters_match_the_jax_package(runs):
    (_, tp), (_, jp), _ = runs
    assert sorted(tp) == sorted(jp)
    for k in tp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=TOL,
                                   err_msg=k)
    # the fixed stage did not move, the rest did
    init = R.init_params(R.param_shapes(_symbol(tmx), *HW, stages=STAGES,
                                        scales=SCALES), seed=0)
    np.testing.assert_array_equal(tp["conv1_1_weight"],
                                  init["conv1_1_weight"])
    assert not np.array_equal(tp["fc6_weight"], init["fc6_weight"])


def test_proposals_and_sampled_rois_match(runs):
    """Proposal's output and proposal_target's rois of each step (the
    executor's monitor), against the JAX package's."""
    d = runs[2]
    sym_t, sym_j = _symbol(tmx), _symbol(jmx)
    params = R.init_params(R.param_shapes(sym_t, *HW, stages=STAGES,
                                          scales=SCALES), seed=0)
    names = R.DATA_NAMES + R.LABEL_NAMES
    got = {}
    for mx, sym, ctx in ((tmx, sym_t, tmx.cpu()), (jmx, sym_j, jmx.cpu())):
        ex = sym.simple_bind(ctx, **{n: d[n][:1].shape for n in names})
        ex.copy_params_from({k: mx.nd.array(v, ctx=ctx)
                             for k, v in params.items()})
        seen = {}
        ex.set_monitor_callback(lambda n, a: seen.__setitem__(
            n, a.asnumpy()))
        ex.forward(is_train=True, **{n: mx.nd.array(d[n][:1], ctx=ctx)
                                     for n in names})
        got[mx.__name__] = seen
    t, j = got["mxnet_tpu_torch"], got["mxnet_tpu"]
    for name in ("rois_output0", "proposal_target_output0"):
        key = next(k for k in j if k.endswith(name))
        np.testing.assert_allclose(t[name], j[key], rtol=0,
                                   atol=1e-5 * np.abs(j[key]).max())
