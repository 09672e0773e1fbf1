"""The traps of the R-CNN and sequence ops, on the CPU, against the JAX
package where it has the function (tolerance 1e-6 unless stated):

- ROIPooling's gradient at ties is the JAX op's two-stage max (over W,
  then H): a row with two tied columns and a row with one get 1/4, 1/4
  and 1/2; an empty bin gives 0; the rois get a zero gradient; the
  wrapper on host tensors runs the plain version (no launch);
- Proposal refuses a batch of 2, pads past the kept boxes by cycling
  them, and its NMS suppresses at IoU exactly the threshold (``>=``) as
  the JAX package's _nms_keep does;
- fft of a float64 input computes in float32 and returns float64 (the
  JAX op under x64 gives the same numbers);
- an infeasible CTC alignment gives a finite loss near 1e30;
- gluon's CTCLoss (blank last, -1 padding, NTC) equals the JAX package's,
  loss and gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import contrib as jcontrib, registry as jreg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import contrib as tcontrib, rcnn, registry as treg


def _op(reg, name, attrs, *xs, octx=None):
    schema = reg.get_op(name)
    return schema.fcompute(schema.parse_attrs(attrs), octx or reg.OpCtx(),
                           *xs)


def test_roi_pooling_tie_gradient_is_the_two_stage_split():
    """One 2 x 3 bin: row 0 holds the maximum twice, row 1 once; the
    cotangent 1 becomes 1/4, 1/4 (row 0) and 1/2 (row 1), in both
    packages; not argmax routing, not one even split over the three."""
    data = np.array([[[[5., 1., 5.], [0., 5., 2.]]]], np.float32)
    rois = np.array([[0, 0, 0, 2, 1]], np.float32)
    attrs = {"pooled_size": (1, 1), "spatial_scale": 1.0}
    x = torch.tensor(data, requires_grad=True)
    (out,) = _op(treg, "ROIPooling", attrs, x, torch.tensor(rois))
    (g,) = torch.autograd.grad(out.sum(), x)
    want = np.array([[[[.25, 0, .25], [0, .5, 0]]]], np.float32)
    np.testing.assert_array_equal(g.numpy(), want)
    jg = jax.grad(lambda d: _op(jreg, "ROIPooling", attrs, d,
                                jnp.asarray(rois))[0].sum())(
        jnp.asarray(data))
    np.testing.assert_array_equal(np.asarray(jg), want)


def test_roi_pooling_empty_bin_zero_and_rois_get_no_gradient():
    data = np.random.RandomState(0).normal(size=(1, 2, 4, 4)) \
        .astype(np.float32)
    # a roi past the map's right edge: its bins are empty
    rois = np.array([[0, 40, 0, 60, 3], [0, 0, 0, 3, 3]], np.float32)
    attrs = {"pooled_size": (2, 2), "spatial_scale": 1.0}
    x = torch.tensor(data, requires_grad=True)
    r = torch.tensor(rois, requires_grad=True)
    (out,) = _op(treg, "ROIPooling", attrs, x, r)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    gx, gr = torch.autograd.grad(out.sum(), (x, r), allow_unused=True)
    assert gr is None or not bool(gr.any())
    (jo,) = _op(jreg, "ROIPooling", attrs, jnp.asarray(data),
                jnp.asarray(rois))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                               atol=1e-6)
    jr = jax.grad(lambda q: _op(jreg, "ROIPooling", attrs, jnp.asarray(data),
                                q)[0].sum())(jnp.asarray(rois))
    assert not np.asarray(jr).any()


def test_kernel_wrappers_on_host_tensors_take_the_plain_versions():
    data = torch.randn(1, 3, 6, 7)
    rois = torch.tensor([[0, 1, 1, 50, 40], [0, 0, 0, 20, 90.]])
    boxes = torch.tensor([[[0, 0, 10, 10], [1, 1, 10, 10], [20, 20, 30,
                                                               30.]]])
    n0 = (rcnn.roi_pooling.launches, rcnn.proposal_nms.launches)
    assert torch.equal(rcnn.roi_pooling(data, rois, (3, 2), 0.125),
                       rcnn.roi_pooling_plain(data, rois, (3, 2), 0.125))
    keep = rcnn.proposal_nms(boxes, 0.7)
    assert keep.tolist() == [[True, False, True]]
    assert (rcnn.roi_pooling.launches, rcnn.proposal_nms.launches) == n0
    with pytest.raises(MXNetError, match="boxes"):
        rcnn.proposal_nms(boxes[0], 0.7)
    with pytest.raises(MXNetError, match="rois"):
        rcnn.roi_pooling(data, rois[:, :4], (2, 2), 1.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_nms_suppresses_at_exactly_the_threshold_as_jax(dtype):
    """Box 1's IoU with box 0 is exactly 0.5: suppressed at threshold 0.5
    (``>=``), kept above it; the plain version's keep mask is the JAX
    _nms_keep's over random boxes too."""
    rng = np.random.RandomState(4)
    ctr = rng.uniform(0, 200, (40, 2))
    wh = rng.uniform(8, 60, (40, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1)
    boxes[0] = (100, 100, 110, 110)
    boxes[1] = (100, 100, 110, 120)
    boxes = boxes.astype(dtype)
    for thresh in (0.5, 0.5000001, 0.3):
        keep = rcnn.proposal_nms_plain(torch.tensor(boxes)[None], thresh)
        with jax.enable_x64(dtype == np.float64):
            want = jcontrib._nms_keep(jnp.asarray(boxes), jnp.zeros(40),
                                      jnp.full(40, True), 40, thresh, True)
        assert keep[0].tolist() == np.asarray(want).tolist(), thresh
    assert not bool(rcnn.proposal_nms_plain(torch.tensor(boxes)[None],
                                            0.5)[0, 1])


def test_proposal_refuses_a_batch_and_cycles_its_padding():
    rng = np.random.RandomState(5)
    z = rng.normal(size=(2, 2, 3, 2, 3))
    prob = (np.exp(z) / np.exp(z).sum(1, keepdims=True)).reshape(
        2, 6, 2, 3).astype(np.float32)
    delta = rng.uniform(-0.2, 0.2, (2, 12, 2, 3)).astype(np.float32)
    info = np.array([[40, 50, 1.0], [40, 50, 1.0]], np.float32)
    attrs = {"scales": (1.0,), "rpn_pre_nms_top_n": 18,
             "rpn_post_nms_top_n": 18, "threshold": 0.3, "rpn_min_size": 4}
    with pytest.raises(MXNetError, match="batch size 1"):
        _op(treg, "_contrib_Proposal", attrs, *map(torch.tensor,
                                                    (prob, delta, info)))
    with pytest.raises(jmx.MXNetError, match="batch size 1"):
        _op(jreg, "_contrib_Proposal", attrs, *map(jnp.asarray,
                                                    (prob, delta, info)))
    rois, scores = _op(treg, "_contrib_Proposal", attrs,
                       *map(torch.tensor, (prob[:1], delta[:1], info[:1])))
    jr, js = _op(jreg, "_contrib_Proposal", attrs,
                 *map(jnp.asarray, (prob[:1], delta[:1], info[:1])))
    np.testing.assert_allclose(rois.numpy(), np.asarray(jr), atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), atol=1e-6)
    # fewer kept boxes than post_n: the kept rows repeat in order
    kept = len({tuple(r) for r in rois.numpy().tolist()})
    assert kept < 18
    np.testing.assert_array_equal(rois.numpy()[kept:2 * kept],
                                  rois.numpy()[:kept])


def test_fft_of_float64_computes_in_float32():
    x = np.random.RandomState(6).normal(size=(3, 16))
    (got,) = _op(treg, "_contrib_fft", {}, torch.tensor(x))
    assert got.dtype == torch.float64
    (f32,) = _op(treg, "_contrib_fft", {},
                 torch.tensor(x, dtype=torch.float32))
    assert torch.equal(got, f32.double())
    with jax.enable_x64(True):
        (want,) = _op(jreg, "_contrib_fft", {}, jnp.asarray(x))
        assert want.dtype == jnp.float64
        (back,) = _op(jreg, "_contrib_ifft", {}, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    (tback,) = _op(treg, "_contrib_ifft", {}, got)
    assert tback.dtype == torch.float64
    np.testing.assert_allclose(tback.numpy(), np.asarray(back), atol=1e-4)


def test_infeasible_ctc_gives_a_finite_loss_near_1e30():
    data = np.random.RandomState(7).normal(size=(2, 1, 4)).astype(np.float32)
    label = np.array([[1, 1, 2]], np.float32)       # needs 4 frames
    (loss,) = _op(treg, "CTCLoss", {}, torch.tensor(data),
                  torch.tensor(label))
    (jloss,) = _op(jreg, "CTCLoss", {}, jnp.asarray(data),
                   jnp.asarray(label))
    assert np.isfinite(loss.numpy()).all()
    assert 0.9e30 < float(loss[0]) < 1.1e30
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-6)


def test_gluon_ctc_loss_matches_jax():
    rng = np.random.RandomState(8)
    pred = rng.normal(size=(3, 7, 5)).astype(np.float32)        # NTC
    label = np.array([[0, 1, -1], [2, 2, 3], [1, -1, -1]], np.float32)
    jl = jmx.gluon.loss.CTCLoss()
    tl = tmx.gluon.loss.CTCLoss()
    jp = jmx.nd.array(pred)
    jp.attach_grad()
    with jmx.autograd.record():
        jo = jl(jp, jmx.nd.array(label))
    jo.backward()
    tp = tmx.nd.array(pred, ctx=tmx.cpu())
    tp.attach_grad()
    with tmx.autograd.record():
        to = tl(tp, tmx.nd.array(label, ctx=tmx.cpu()))
    to.backward()
    np.testing.assert_allclose(to.asnumpy(), jo.asnumpy(), rtol=1e-5)
    np.testing.assert_allclose(tp.grad.asnumpy(), jp.grad.asnumpy(),
                               rtol=1e-5, atol=1e-6)


def test_proposal_candidates_are_what_proposal_selects_from():
    """The candidates the card's keep-mask check reads (sorted, cut to
    pre_n) and the NMS over them give Proposal's own rows."""
    rng = np.random.RandomState(9)
    z = rng.normal(size=(1, 2, 9, 3, 4))
    prob = torch.tensor((np.exp(z) / np.exp(z).sum(1, keepdims=True))
                        .reshape(1, 18, 3, 4))
    delta = torch.tensor(rng.uniform(-0.2, 0.2, (1, 36, 3, 4)))
    info = torch.tensor([[48.0, 64.0, 1.0]], dtype=torch.float64)
    attrs = treg.get_op("_contrib_Proposal").parse_attrs(
        {"scales": (1.0, 2.0, 4.0), "rpn_pre_nms_top_n": 50,
         "rpn_post_nms_top_n": 20, "rpn_min_size": 4})
    top, scores, post_n = tcontrib.proposal_candidates(prob[:, 9:], delta,
                                                       info, attrs)
    keep = rcnn.proposal_nms(tcontrib.nms_boxes(top), 0.7)
    rois, _ = tcontrib._proposals(prob[:, 9:], delta, info, attrs)
    want = top[0][keep[0]][:post_n]
    np.testing.assert_array_equal(rois[0][:len(want)].numpy(), want.numpy())
