"""Detection operators (counterpart of the SSD family in
mxnet_tpu/ops/contrib.py): ``_contrib_MultiBoxPrior``,
``_contrib_MultiBoxTarget``, ``_contrib_MultiBoxDetection``,
``_contrib_box_nms``, ``_contrib_box_iou`` and
``_contrib_bipartite_matching``, with the JAX package's params, defaults,
shape rules, outputs and tie-breaking:

  - the greedy matchings take the *first* maximum of the flattened
    (rows x columns) matrix, as ``jnp.argmax`` does (``torch.argmax``
    returns the first maximal index too);
  - hard-negative mining and the detection order rank with stable sorts
    (the mining's background probabilities in float64, so that the card
    and the host rank alike);
  - a batch item whose label starts with class -1 keeps loc 0, mask 0 and
    class ``ignore_label``;
  - MultiBoxTarget's outputs are constants of the step (computed under
    ``torch.no_grad()``: no gradient reaches ``cls_pred`` or the anchors).

Every op runs on its inputs' device, one batched tensor step at a time
(the JAX ops ``vmap`` a per-image function): the bipartite pass loops
over the label rows, greedy NMS over the reference rows. The JAX NMS
loops over all n rows; rows at or beyond ``k`` can neither be kept nor
suppress anything, so here the loop runs to the largest ``k`` of the
batch, with the IoUs of those top rows computed once. Reading that ``k``
is the one host sync of MultiBoxDetection and box_nms; MultiBoxTarget has
none, so a training step that holds it can be captured in a CUDA graph.

The rest of the JAX module, with its traps kept:

  - ``ROIPooling`` and Proposal's NMS are the hand-written kernels of
    ``ops/rcnn.py`` on the card; ROIPooling's gradient at ties is the
    JAX op's two-stage max (over W, then H), Proposal's top-k a stable
    descending sort (``lax.top_k`` puts the lower index first among
    equal scores, and every padded or too-small anchor scores -1.0);
    its gradients are autograd's with the kept indices held constant;
  - ``_contrib_PSROIPooling``, ``_contrib_DeformableConvolution`` and
    ``_contrib_DeformablePSROIPooling`` are gathers and bilinear
    samples (clamped coordinates, a +-0.5 border mask; ``floor`` has
    gradient 0 at the integer kinks, ``clip`` half of it at its bounds);
  - ``BilinearSampler``, ``GridGenerator``, ``SpatialTransformer``,
    ``_contrib_AdaptiveAvgPooling2D``, ``_contrib_BilinearResize2D``,
    ``Correlation`` and ``Crop``;
  - ``CTCLoss`` (and its aliases): the log-softmax inside, the alpha
    recursion a time loop of torch ops in log space, -1e30 for "no
    path" (an infeasible alignment gives a finite loss near 1e30), alpha
    frozen past ``data_lengths``; autograd gives the gradient;
  - ``_contrib_fft`` / ``_contrib_ifft`` (computed in float32 whatever
    the input's type, interleaved (re, im) pairs, cast back),
    ``_contrib_count_sketch``, ``khatri_rao`` and ``_contrib_quadratic``.

A division by a number whose result is floored (bin bounds, sample
steps) is ``rcnn.ieee_div``: on the card PyTorch multiplies by a host
scalar's reciprocal instead, and the card's bins would differ from the
host's and the JAX package's.
"""
from __future__ import annotations

import math

import torch

import numpy as _np

from ..base import MXNetError
from . import rcnn
from .registry import Param, register
from .tensor import _clip

__all__ = []

_NEG = -1e30


def _flat_batch(x, keep_last):
    """Collapse the leading dims, keeping the last ``keep_last``."""
    lead = tuple(x.shape[:-keep_last]) if keep_last else tuple(x.shape)
    return x.reshape((math.prod(lead),) + tuple(x.shape[len(lead):])), lead


def _corner_wh(boxes):
    return boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1]


def _box_area(boxes):
    w, h = _corner_wh(boxes)
    return torch.where((w < 0) | (h < 0), torch.zeros_like(w), w * h)


def _to_corner(boxes):
    x, y = boxes[..., 0], boxes[..., 1]
    w, h = boxes[..., 2] / 2, boxes[..., 3] / 2
    return torch.stack([x - w, y - h, x + w, y + h], dim=-1)


def _from_corner(boxes):
    l, t, r, b = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    return torch.stack([(l + r) / 2, (t + b) / 2, r - l, b - t], dim=-1)


def _round_half_away(v):
    """C round(): half away from zero (not banker's rounding)."""
    return torch.sign(v) * torch.floor(v.abs() + 0.5)


def _pair_iou(a, b, fmt="corner"):
    """IoU of every a-box against every b-box: a (..., A, 4), b (..., B,
    4) -> (..., A, B); a union <= 0 gives 0."""
    if fmt == "center":
        a, b = _to_corner(a), _to_corner(b)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = _box_area(a)[..., :, None] + _box_area(b)[..., None, :] - inter
    return torch.where(union <= 0, torch.zeros_like(inter), inter / union)


def _same_shape(attrs, in_shapes):
    return in_shapes, [in_shapes[0]]


# ---------------------------------------------------------------------------
# MultiBoxPrior
# ---------------------------------------------------------------------------

def _multibox_prior(attrs, octx, data):
    h, w = int(data.shape[2]), int(data.shape[3])
    sizes, ratios = attrs["sizes"], attrs["ratios"]
    step_y, step_x = attrs["steps"]
    off_y, off_x = attrs["offsets"]
    if step_y <= 0 or step_x <= 0:
        step_y, step_x = 1.0 / h, 1.0 / w
    # every size at ratio 1, then every further ratio at sizes[0]; the
    # widths aspect-corrected by h / w
    half_w = [s * h / w / 2 for s in sizes]
    half_h = [s / 2 for s in sizes]
    for r in ratios[1:]:
        sr = math.sqrt(r)
        half_w.append(sizes[0] * h / w * sr / 2)
        half_h.append(sizes[0] / sr / 2)
    kw = dict(dtype=data.dtype, device=data.device)
    # filled on the device (no host copy, so a CUDA graph can capture it)
    hw = torch.stack([torch.full((), v, **kw) for v in half_w])
    hh = torch.stack([torch.full((), v, **kw) for v in half_h])
    a = hw.shape[0]
    cy = (torch.arange(h, **kw) + off_y) * step_y
    cx = (torch.arange(w, **kw) + off_x) * step_x
    cyg = cy[:, None, None].expand(h, w, a)
    cxg = cx[None, :, None].expand(h, w, a)
    out = torch.stack([cxg - hw, cyg - hh, cxg + hw, cyg + hh], dim=-1)
    out = out.reshape(1, h * w * a, 4)
    if attrs["clip"]:
        out = out.clamp(0.0, 1.0)
    return (out,)


def _multibox_prior_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None]
    a = len(attrs["sizes"]) + len(attrs["ratios"]) - 1
    return in_shapes, [(1, ds[2] * ds[3] * a, 4)]


register("_contrib_MultiBoxPrior", _multibox_prior,
         params={"sizes": Param("floats", (1.0,)),
                 "ratios": Param("floats", (1.0,)),
                 "clip": Param("bool", False),
                 "steps": Param("floats", (-1.0, -1.0)),
                 "offsets": Param("floats", (0.5, 0.5))},
         inputs=("data",), infer_shape=_multibox_prior_infer)


# ---------------------------------------------------------------------------
# MultiBoxTarget
# ---------------------------------------------------------------------------

def _encode_loc(anchors, gt):
    """SSD box encoding; the caller divides by the variances."""
    aw, ah = _corner_wh(anchors)
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    gw, gh = _corner_wh(gt)
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    return torch.stack([(gx - ax) / aw, (gy - ay) / ah,
                        torch.log(torch.clamp_min(gw, 1e-12) / aw),
                        torch.log(torch.clamp_min(gh, 1e-12) / ah)], dim=-1)


def _bipartite_assign(ious, thresh_ok=1e-6):
    """The greedy bipartite pass of MultiBoxTarget over a batch: L
    rounds, each taking every item's first global maximum among the
    unmatched (anchor, label) pairs. ious (B, A, L) -> (a_matched,
    m_gt, m_iou), each (B, A)."""
    nb, na, nl = ious.shape
    dev = ious.device
    rows = torch.arange(nb, device=dev)
    a_matched = torch.zeros(nb, na, dtype=torch.bool, device=dev)
    g_matched = torch.zeros(nb, nl, dtype=torch.bool, device=dev)
    m_gt = torch.full((nb, na), -1, dtype=torch.int64, device=dev)
    m_iou = torch.full((nb, na), -1.0, dtype=ious.dtype, device=dev)
    neg = ious.new_full((), _NEG)
    for _ in range(nl):
        m = torch.where(a_matched[:, :, None] | g_matched[:, None, :], neg,
                        ious)
        flat = torch.argmax(m.reshape(nb, -1), dim=1)
        bi, bk = flat // nl, flat % nl
        best = m[rows, bi, bk]
        ok = best > thresh_ok
        a_matched[rows, bi] |= ok
        g_matched[rows, bk] |= ok
        m_gt[rows, bi] = torch.where(ok, bk, m_gt[rows, bi])
        m_iou[rows, bi] = torch.where(ok, best, m_iou[rows, bi])
    return a_matched, m_gt, m_iou


@torch.no_grad()
def _multibox_target(attrs, octx, anchor, label, cls_pred):
    anchors = anchor.reshape(-1, 4)                        # (A, 4)
    na = anchors.shape[0]
    nb, nl = label.shape[0], label.shape[1]
    thresh = attrs["overlap_threshold"]
    ignore = attrs["ignore_label"]
    mine_ratio = attrs["negative_mining_ratio"]
    mine_thresh = attrs["negative_mining_thresh"]
    dt = anchors.dtype

    # the valid labels: the reference stops at the first class -1 row
    valid = torch.cumprod((label[:, :, 0] != -1.0).to(torch.int32),
                          dim=1).bool()                     # (B, L)
    has_gt = valid[:, 0]
    gt_boxes = label[:, :, 1:5]
    ious = _pair_iou(anchors, gt_boxes)                     # (B, A, L)
    ious = torch.where(valid[:, None, :], ious, ious.new_full((), -1.0))

    # stage 1: greedy bipartite matching; stage 2: the threshold matches
    # of the anchors it left
    a_matched, m_gt, m_iou = _bipartite_assign(ious)
    best_iou = ious.amax(dim=2)
    best_gt = torch.argmax(ious, dim=2)                     # first maximum
    if thresh > 0:
        positive = a_matched | (best_iou > thresh)
    else:
        positive = a_matched
    m_gt = torch.where(a_matched, m_gt, best_gt)
    m_iou = torch.where(a_matched, m_iou, best_iou)

    if mine_ratio > 0:
        # hard-negative mining: among the non-positive anchors whose best
        # IoU is under the mining threshold, the num_pos * ratio with the
        # lowest background probability
        num_pos = positive.sum(dim=1, dtype=torch.int32)
        num_neg = torch.clamp_min(
            (num_pos.to(torch.float32) * mine_ratio).to(torch.int32),
            attrs["minimum_negative_samples"])
        num_neg = torch.minimum(num_neg, na - num_pos)
        cand = (~positive) & (m_iou < mine_thresh)
        # ranked in the input's type as the reference ranks them, so
        # probabilities equal in that type tie and keep the anchors'
        # order; taken in float64 and rounded once, so the card and the
        # host round alike (a float32 softmax's last bit differs between
        # the card's kernel and the host's)
        bg_prob = torch.softmax(cls_pred.to(torch.float64),
                                dim=1)[:, 0, :].to(cls_pred.dtype)
        score = torch.where(cand, -bg_prob, bg_prob.new_full((), _NEG))
        order = torch.argsort(-score, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(na, device=order.device)
            .expand(nb, na).contiguous())
        negative = cand & (rank < num_neg[:, None])
    else:
        negative = ~positive

    gt_cls = torch.gather(label[:, :, 0], 1, m_gt)          # (B, A)
    ignored = torch.full_like(gt_cls, ignore)
    cls_t = torch.where(positive, gt_cls + 1.0,
                        torch.where(negative, torch.zeros_like(gt_cls),
                                    ignored))
    matched = torch.gather(gt_boxes, 1, m_gt[:, :, None].expand(nb, na, 4))
    enc = _encode_loc(anchors, matched)
    loc = torch.stack([enc[..., k] / v for k, v in
                       enumerate(attrs["variances"])], dim=-1)
    mask4 = positive[:, :, None].expand(nb, na, 4).to(dt)
    loc_t = torch.where(positive[:, :, None], loc,
                        torch.zeros_like(loc)) * mask4
    # a batch item with no ground truth keeps the initial values
    cls_t = torch.where(has_gt[:, None], cls_t, ignored)
    loc_t = torch.where(has_gt[:, None, None], loc_t,
                        torch.zeros_like(loc_t))
    mask4 = torch.where(has_gt[:, None, None], mask4,
                        torch.zeros_like(mask4))
    return loc_t.reshape(nb, -1), mask4.reshape(nb, -1), cls_t


def _multibox_target_infer(attrs, in_shapes):
    ash, lsh, _ = in_shapes
    if ash is None or lsh is None:
        return in_shapes, [None, None, None]
    na, nb = ash[1], lsh[0]
    return in_shapes, [(nb, na * 4), (nb, na * 4), (nb, na)]


register("_contrib_MultiBoxTarget", _multibox_target,
         params={"overlap_threshold": Param("float", 0.5),
                 "ignore_label": Param("float", -1.0),
                 "negative_mining_ratio": Param("float", -1.0),
                 "negative_mining_thresh": Param("float", 0.5),
                 "minimum_negative_samples": Param("int", 0),
                 "variances": Param("floats", (0.1, 0.1, 0.2, 0.2))},
         inputs=("anchor", "label", "cls_pred"), num_outputs=3,
         infer_shape=_multibox_target_infer)


# ---------------------------------------------------------------------------
# MultiBoxDetection
# ---------------------------------------------------------------------------

def _decode_loc(anchors, loc, variances, clip):
    vx, vy, vw, vh = variances
    aw, ah = _corner_wh(anchors)
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    ox = loc[..., 0] * vx * aw + ax
    oy = loc[..., 1] * vy * ah + ay
    ow = torch.exp(loc[..., 2] * vw) * aw / 2
    oh = torch.exp(loc[..., 3] * vh) * ah / 2
    out = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    return out.clamp(0.0, 1.0) if clip else out


# (B, k, k) pairs above which _greedy_nms computes each reference row's
# IoUs in its loop instead of the whole matrix at once
_NMS_MATRIX_ELEMS = 1 << 26


def _greedy_nms(boxes, ids, keep, k, thresh, force, strict):
    """Greedy NMS of a batch of score-sorted rows, in place on ``keep``
    (B, n): reference row r, while kept, suppresses every later kept row
    before k (per item) of its class (any class under ``force``) whose
    IoU with it reaches ``thresh`` (exceeds it when ``strict``). Only the
    first max(k) rows take part; their IoUs are computed once (a row at
    a time past _NMS_MATRIX_ELEMS)."""
    kmax = int(k.max()) if k.numel() else 0
    if kmax < 2:
        return keep
    nb = boxes.shape[0]
    top = boxes[:, :kmax]
    idx = torch.arange(kmax, device=boxes.device)
    before_k = idx[None, :] < k[:, None]                    # (B, kmax)

    def cand(rows, r0):
        """Which rows each reference row of ``rows`` (its IoUs, (B, r,
        kmax), starting at row r0) may suppress."""
        over = rows > thresh if strict else rows >= thresh
        ref = idx[r0:r0 + rows.shape[1]]
        if not force:
            over &= ids[:, ref, None] == ids[:, None, :kmax]
        return over & (idx[None, None, :] > ref[None, :, None]) \
            & before_k[:, None, :]

    whole = nb * kmax * kmax <= _NMS_MATRIX_ELEMS
    if whole:
        table = cand(_pair_iou(top, top), 0)                # (B, kmax, kmax)
    kk = keep[:, :kmax].clone()
    for ref in range(kmax - 1):
        row = table[:, ref] if whole else \
            cand(_pair_iou(top[:, ref:ref + 1], top), ref)[:, 0]
        kk &= ~(row & kk[:, ref:ref + 1])
    keep[:, :kmax] = kk
    return keep


def _multibox_detection(attrs, octx, cls_prob, loc_pred, anchor):
    if attrs["background_id"] != 0:
        # the reference kernel hardcodes class 0 as the background too
        raise MXNetError("MultiBoxDetection: only background_id=0 is "
                         "supported")
    anchors = anchor.reshape(-1, 4)
    na = anchors.shape[0]
    nb = cls_prob.shape[0]
    threshold = attrs["threshold"]
    nms_thresh = attrs["nms_threshold"]
    topk = attrs["nms_topk"]
    dt = cls_prob.dtype
    fg = cls_prob[:, 1:, :]                                 # (B, C-1, A)
    score = fg.amax(dim=1)
    cid = torch.argmax(fg, dim=1).to(dt)                    # first maximum
    valid = score >= threshold
    boxes = _decode_loc(anchors, loc_pred.reshape(nb, na, 4),
                        attrs["variances"], attrs["clip"])
    # the valid rows first, by descending score (stable)
    key = torch.where(valid, score, torch.full_like(score, _NEG))
    order = torch.argsort(-key, dim=1, stable=True)
    s_score = torch.gather(score, 1, order)
    s_cid = torch.gather(cid, 1, order)
    s_boxes = torch.gather(boxes, 1, order[:, :, None].expand(nb, na, 4))
    s_valid = torch.gather(valid, 1, order)
    nvalid = valid.sum(dim=1)
    k = torch.clamp_max(nvalid, topk) if topk > 0 else nvalid
    if 0 < nms_thresh <= 1:
        idx = torch.arange(na, device=cls_prob.device)
        keep = s_valid & (idx[None, :] < k[:, None])
        keep = _greedy_nms(s_boxes, s_cid, keep, k, nms_thresh,
                           attrs["force_suppress"], strict=False)
    else:
        keep = s_valid
    out_id = torch.where(keep, s_cid, torch.full_like(s_cid, -1.0))
    row = torch.cat([out_id[:, :, None], s_score[:, :, None], s_boxes],
                    dim=2)
    return (torch.where(s_valid[:, :, None], row, torch.full_like(row,
                                                                  -1.0)),)


def _multibox_detection_infer(attrs, in_shapes):
    csh = in_shapes[0]
    if csh is None:
        return in_shapes, [None]
    return in_shapes, [(csh[0], csh[2], 6)]


register("_contrib_MultiBoxDetection", _multibox_detection,
         params={"clip": Param("bool", True),
                 "threshold": Param("float", 0.01),
                 "background_id": Param("int", 0),
                 "nms_threshold": Param("float", 0.5),
                 "force_suppress": Param("bool", False),
                 "variances": Param("floats", (0.1, 0.1, 0.2, 0.2)),
                 "nms_topk": Param("int", -1)},
         inputs=("cls_prob", "loc_pred", "anchor"),
         infer_shape=_multibox_detection_infer)


# ---------------------------------------------------------------------------
# box_nms / box_iou / bipartite_matching
# ---------------------------------------------------------------------------

def _box_nms(attrs, octx, data):
    thresh = attrs["overlap_thresh"]
    topk = attrs["topk"]
    cs, si, ii = attrs["coord_start"], attrs["score_index"], attrs["id_index"]
    in_fmt, out_fmt = attrs["in_format"], attrs["out_format"]
    flat, _ = _flat_batch(data, 2)
    nb, n = flat.shape[0], flat.shape[1]
    k = n if topk < 0 else min(n, topk)
    if k < 1:
        return (data,)
    scores = flat[:, :, si]
    valid = scores > attrs["valid_thresh"]
    # the invalid rows sort to the back
    order = torch.argsort(torch.where(valid, -scores,
                                      torch.full_like(scores, -_NEG)),
                          dim=1, stable=True)
    srows = torch.gather(flat, 1, order[:, :, None].expand_as(flat))
    boxes = srows[:, :, cs:cs + 4]
    if in_fmt == "center":
        boxes = _to_corner(boxes)
    ids = srows[:, :, ii] if ii >= 0 else torch.zeros_like(scores)
    s_valid = torch.gather(valid, 1, order)
    # the JAX op loops over every row before k, invalid ones included;
    # those sit behind the valid ones and change only invalid rows, which
    # the valid mask drops, so the loop stops at min(k, valid rows)
    kv = torch.clamp_max(valid.sum(dim=1), k)
    keep = s_valid & (torch.arange(n, device=data.device)[None, :]
                      < kv[:, None])
    keep = _greedy_nms(boxes.detach(), ids.detach(), keep, kv, thresh,
                       attrs["force_suppress"], strict=True)
    # the survivors packed to the front in score order, -1 elsewhere
    pack = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    out = torch.gather(srows, 1, pack[:, :, None].expand_as(srows))
    kept_row = torch.arange(n, device=data.device)[None, :] \
        < keep.sum(dim=1)[:, None]
    if in_fmt != out_fmt:
        box = out[:, :, cs:cs + 4]
        conv = _to_corner(box) if out_fmt == "corner" else _from_corner(box)
        out = torch.cat([out[:, :, :cs], conv, out[:, :, cs + 4:]], dim=2)
    out = torch.where(kept_row[:, :, None], out, torch.full_like(out, -1.0))
    return (out.reshape(data.shape),)


register("_contrib_box_nms", _box_nms,
         params={"overlap_thresh": Param("float", 0.5),
                 "valid_thresh": Param("float", 0.0),
                 "topk": Param("int", -1),
                 "coord_start": Param("int", 2),
                 "score_index": Param("int", 1),
                 "id_index": Param("int", -1),
                 "force_suppress": Param("bool", False),
                 "in_format": Param("str", "corner"),
                 "out_format": Param("str", "corner")},
         inputs=("data",), infer_shape=_same_shape,
         aliases=("_contrib_box_non_maximum_suppression",))


def _box_iou(attrs, octx, lhs, rhs):
    a, alead = _flat_batch(lhs, 1)
    b, blead = _flat_batch(rhs, 1)
    return (_pair_iou(a, b, attrs["format"]).reshape(alead + blead),)


def _box_iou_infer(attrs, in_shapes):
    a, b = in_shapes
    if a is None or b is None:
        return in_shapes, [None]
    return in_shapes, [tuple(a[:-1]) + tuple(b[:-1])]


register("_contrib_box_iou", _box_iou,
         params={"format": Param("str", "corner")},
         inputs=("lhs", "rhs"), infer_shape=_box_iou_infer)


def _bipartite_matching(attrs, octx, data):
    thresh = attrs["threshold"]
    is_ascend = attrs["is_ascend"]
    topk = attrs["topk"]
    flat, lead = _flat_batch(data, 2)
    nb, nr, nc = flat.shape
    dev = data.device
    s = -flat if is_ascend else flat
    bound = -thresh if is_ascend else thresh
    rows = torch.arange(nb, device=dev)
    rmark = torch.full((nb, nr), -1.0, dtype=data.dtype, device=dev)
    cmark = torch.full((nb, nc), -1.0, dtype=data.dtype, device=dev)
    count = torch.zeros(nb, dtype=torch.int64, device=dev)
    neg = data.new_full((), _NEG)
    with torch.no_grad():
        for _ in range(min(nr, nc)):
            m = torch.where((rmark[:, :, None] == -1)
                            & (cmark[:, None, :] == -1), s, neg)
            fi = torch.argmax(m.reshape(nb, -1), dim=1)
            r, c = fi // nc, fi % nc
            ok = m[rows, r, c] > bound
            if topk > 0:
                ok &= count < topk
            rmark[rows, r] = torch.where(ok, c.to(data.dtype),
                                         rmark[rows, r])
            cmark[rows, c] = torch.where(ok, r.to(data.dtype),
                                         cmark[rows, c])
            count += ok.to(torch.int64)
    return (rmark.reshape(lead + (nr,)), cmark.reshape(lead + (nc,)))


def _bipartite_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None, None]
    return in_shapes, [tuple(ds[:-1]), tuple(ds[:-2]) + (ds[-1],)]


register("_contrib_bipartite_matching", _bipartite_matching,
         params={"is_ascend": Param("bool", False),
                 "threshold": Param("float", None, True),
                 "topk": Param("int", -1)},
         inputs=("data",), num_outputs=2, infer_shape=_bipartite_infer)


# ---------------------------------------------------------------------------
# ROIPooling (the kernel of ops/rcnn.py on the card)
# ---------------------------------------------------------------------------

def _roi_pooling(attrs, octx, data, rois):
    return (rcnn.roi_pooling(data, rois, attrs["pooled_size"],
                             attrs["spatial_scale"]),)


def _roi_pooling_infer(attrs, in_shapes):
    ds, rs = in_shapes
    if ds is None or rs is None:
        return in_shapes, [None]
    ph, pw = attrs["pooled_size"]
    return in_shapes, [(rs[0], ds[1], ph, pw)]


register("ROIPooling", _roi_pooling,
         params={"pooled_size": Param("shape", None, True),
                 "spatial_scale": Param("float", None, True)},
         inputs=("data", "rois"), infer_shape=_roi_pooling_infer)


# ---------------------------------------------------------------------------
# BilinearSampler / GridGenerator / SpatialTransformer
# ---------------------------------------------------------------------------

def _gather_hw(img, yi, xi):
    """img (N, C, H, W) at integer coords yi, xi (N, *S): (N, C, *S)."""
    n, c, h, w = img.shape
    flat = (yi * w + xi).reshape(n, 1, -1).expand(n, c, -1)
    return torch.gather(img.reshape(n, c, h * w), 2, flat) \
        .reshape((n, c) + tuple(yi.shape[1:]))


def _bilinear_sample(img, gx, gy):
    """Sample img (N, C, H, W) at real coords gx, gy (N, Ho, Wo), zero
    outside."""
    _, _, h, w = img.shape
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0)[:, None]
    wy = (gy - y0)[:, None]

    def at(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = _gather_hw(img, yi.clamp(0, h - 1).to(torch.int64),
                       xi.clamp(0, w - 1).to(torch.int64))
        return torch.where(inb[:, None], v, torch.zeros_like(v))

    tl = at(y0, x0)
    tr = at(y0, x0 + 1)
    bl = at(y0 + 1, x0)
    br = at(y0 + 1, x0 + 1)
    top = tl * (1 - wx) + tr * wx
    bot = bl * (1 - wx) + br * wx
    return top * (1 - wy) + bot * wy


def _bilinear_sampler(attrs, octx, data, grid):
    gx = (grid[:, 0] + 1.0) * (data.shape[3] - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (data.shape[2] - 1) / 2.0
    return (_bilinear_sample(data, gx, gy),)


def _bilinear_sampler_infer(attrs, in_shapes):
    ds, gs = in_shapes
    if ds is None or gs is None:
        return in_shapes, [None]
    return in_shapes, [(ds[0], ds[1], gs[2], gs[3])]


register("BilinearSampler", _bilinear_sampler,
         inputs=("data", "grid"), infer_shape=_bilinear_sampler_infer)


def _linspace(num, dtype, device):
    """``jnp.linspace(-1, 1, num)`` as the JAX package computes it:
    start * (1 - i / div) + stop * (i / div), then the stop."""
    if num <= 1:
        return torch.zeros(1, dtype=dtype, device=device)
    div = num - 1
    step = rcnn.ieee_div(torch.arange(div, dtype=dtype, device=device), div)
    out = -1.0 * (1 - step) + 1.0 * step
    return torch.cat([out, torch.ones(1, dtype=dtype, device=device)])


def _target_grid(h, w, dtype, device):
    """(3, h * w): the target grid's x, y in [-1, 1] (row-major) and 1."""
    gy, gx = torch.meshgrid(_linspace(h, dtype, device),
                            _linspace(w, dtype, device), indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones(h * w, dtype=dtype, device=device)])


def _grid_generator(attrs, octx, data):
    tt = attrs["transform_type"]
    if tt == "affine":
        h, w = attrs["target_shape"]
        tgt = _target_grid(h, w, data.dtype, data.device)
        src = data.reshape(-1, 2, 3) @ tgt                  # (N, 2, H*W)
        return (src.reshape(-1, 2, h, w),)
    if tt == "warp":
        _, _, h, w = data.shape
        yy, xx = torch.meshgrid(
            torch.arange(h, dtype=data.dtype, device=data.device),
            torch.arange(w, dtype=data.dtype, device=data.device),
            indexing="ij")
        gx = rcnn.ieee_div((data[:, 0] + xx) * 2.0, max(w - 1, 1)) - 1.0
        gy = rcnn.ieee_div((data[:, 1] + yy) * 2.0, max(h - 1, 1)) - 1.0
        return (torch.stack([gx, gy], dim=1),)
    raise MXNetError(f"GridGenerator: unknown transform_type {tt!r}")


def _grid_generator_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None]
    if attrs["transform_type"] == "affine":
        h, w = attrs["target_shape"]
        return in_shapes, [(ds[0], 2, h, w)]
    return in_shapes, [tuple(ds)]


register("GridGenerator", _grid_generator,
         params={"transform_type": Param("str", None, True),
                 "target_shape": Param("shape", (0, 0))},
         inputs=("data",), infer_shape=_grid_generator_infer)


def _spatial_transformer(attrs, octx, data, loc):
    h, w = attrs["target_shape"]
    tgt = _target_grid(h, w, data.dtype, data.device)
    src = loc.reshape(-1, 2, 3) @ tgt
    sx = (src[:, 0].reshape(-1, h, w) + 1.0) * (data.shape[3] - 1) / 2.0
    sy = (src[:, 1].reshape(-1, h, w) + 1.0) * (data.shape[2] - 1) / 2.0
    return (_bilinear_sample(data, sx, sy),)


def _spatial_transformer_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is not None and in_shapes[1] is None:
        in_shapes = [ds, (ds[0], 6)]
    if ds is None:
        return in_shapes, [None]
    h, w = attrs["target_shape"]
    return in_shapes, [(ds[0], ds[1], h, w)]


register("SpatialTransformer", _spatial_transformer,
         params={"target_shape": Param("shape", (0, 0)),
                 "transform_type": Param("str", "affine"),
                 "sampler_type": Param("str", "bilinear")},
         inputs=("data", "loc"), infer_shape=_spatial_transformer_infer)


# ---------------------------------------------------------------------------
# AdaptiveAvgPooling2D / BilinearResize2D
# ---------------------------------------------------------------------------

def _bin_masks(length, nbins, size, dtype, device):
    """(nbins, length) membership of the bins of a side starting at 0:
    [floor(i * size / n), ceil((i + 1) * size / n)) clipped."""
    i = torch.arange(nbins, dtype=dtype, device=device)
    lo = torch.floor(rcnn.ieee_div(i * size, nbins)).clamp(0, length)
    hi = torch.ceil(rcnn.ieee_div((i + 1) * size, nbins)).clamp(0, length)
    pos = torch.arange(length, dtype=dtype, device=device)[None, :]
    return (pos >= lo[:, None]) & (pos < hi[:, None])


def _out_hw(osz):
    if not osz:
        return 1, 1
    if len(osz) == 1:
        return osz[0], osz[0]
    return osz


def _adaptive_avg_pool(attrs, octx, data):
    oh, ow = _out_hw(attrs["output_size"])
    _, _, h, w = data.shape
    mh = _bin_masks(h, oh, float(h), data.dtype, data.device).to(data.dtype)
    mw = _bin_masks(w, ow, float(w), data.dtype, data.device).to(data.dtype)
    mh = mh / mh.sum(dim=1, keepdim=True)
    mw = mw / mw.sum(dim=1, keepdim=True)
    out = torch.einsum("nchw,oh->ncow", data, mh)
    return (torch.einsum("ncow,pw->ncop", out, mw),)


def _adaptive_avg_pool_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None]
    oh, ow = _out_hw(attrs["output_size"])
    return in_shapes, [(ds[0], ds[1], oh, ow)]


register("_contrib_AdaptiveAvgPooling2D", _adaptive_avg_pool,
         params={"output_size": Param("shape", ())},
         inputs=("data",), infer_shape=_adaptive_avg_pool_infer)


def _bilinear_resize(attrs, octx, data):
    oh, ow = attrs["height"], attrs["width"]
    n, _, h, w = data.shape
    kw = dict(dtype=data.dtype, device=data.device)
    # align-corners: src = dst * (in - 1) / (out - 1)
    gy = torch.arange(oh, **kw) * ((h - 1) / (oh - 1) if oh > 1 else 0.0)
    gx = torch.arange(ow, **kw) * ((w - 1) / (ow - 1) if ow > 1 else 0.0)
    gyy = gy[None, :, None].expand(n, oh, ow)
    gxx = gx[None, None, :].expand(n, oh, ow)
    return (_bilinear_sample(data, gxx, gyy),)


def _bilinear_resize_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None]
    return in_shapes, [(ds[0], ds[1], attrs["height"], attrs["width"])]


register("_contrib_BilinearResize2D", _bilinear_resize,
         params={"height": Param("int", None, True),
                 "width": Param("int", None, True)},
         inputs=("data",), infer_shape=_bilinear_resize_infer)


# ---------------------------------------------------------------------------
# Correlation (FlowNet's cost volume)
# ---------------------------------------------------------------------------

def _correlation(attrs, octx, data1, data2):
    k = attrs["kernel_size"]
    if k % 2 == 0:
        raise MXNetError("Correlation: kernel_size must be odd")
    md = attrs["max_displacement"]
    s1, s2 = attrs["stride1"], attrs["stride2"]
    pad = attrs["pad_size"]
    mul = attrs["is_multiply"]
    _, c, h, w = data1.shape
    border = md + (k - 1) // 2
    oh = int(math.ceil((h + 2 * pad - border * 2) / s1))
    ow = int(math.ceil((w + 2 * pad - border * 2) / s1))
    r = md // s2
    p1 = torch.nn.functional.pad(data1, (pad, pad, pad, pad))
    p2 = torch.nn.functional.pad(data2, (pad, pad, pad, pad))
    span_h, span_w = (oh - 1) * s1 + k, (ow - 1) * s1 + k
    base1 = p1[:, :, md:md + span_h, md:md + span_w]
    chans = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            y0, x0 = md + dy * s2, md + dx * s2
            shifted = p2[:, :, y0:y0 + span_h, x0:x0 + span_w]
            prod = base1 * shifted if mul else (base1 - shifted).abs()
            # the k x k window sums at stride s1
            summed = None
            for a in range(k):
                for b in range(k):
                    t = prod[:, :, a:a + (oh - 1) * s1 + 1:s1,
                             b:b + (ow - 1) * s1 + 1:s1]
                    summed = t if summed is None else summed + t
            chans.append(rcnn.ieee_div(torch.sum(summed, dim=1), k * k * c))
    return (torch.stack(chans, dim=1),)


def _correlation_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None]
    k, md = attrs["kernel_size"], attrs["max_displacement"]
    s1, s2, pad = attrs["stride1"], attrs["stride2"], attrs["pad_size"]
    border = md + (k - 1) // 2
    oh = int(math.ceil((ds[2] + 2 * pad - border * 2) / s1))
    ow = int(math.ceil((ds[3] + 2 * pad - border * 2) / s1))
    d = 2 * (md // s2) + 1
    return in_shapes, [(ds[0], d * d, oh, ow)]


register("Correlation", _correlation,
         params={"kernel_size": Param("int", 1),
                 "max_displacement": Param("int", 1),
                 "stride1": Param("int", 1),
                 "stride2": Param("int", 1),
                 "pad_size": Param("int", 0),
                 "is_multiply": Param("bool", True)},
         inputs=("data1", "data2"), infer_shape=_correlation_infer)


# ---------------------------------------------------------------------------
# CTCLoss: the alpha recursion in log space, a time loop of torch ops
# ---------------------------------------------------------------------------

class _LogAddExp(torch.autograd.Function):
    """log(exp(a) + exp(b)) with JAX's derivative: exp(a - out) and
    exp(b - out), so two "no path" values (-1e30, whose sum rounds back
    to -1e30) each pass all of the cotangent, as in the JAX package
    (``torch.logaddexp`` passes half)."""

    @staticmethod
    def forward(ctx, a, b):
        d = a - b
        out = torch.where(torch.isnan(d), a + b, torch.maximum(a, b)
                          + torch.log1p(torch.exp(-d.abs())))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def _ctc_losses(logp, lab, dlen, llen, blank):
    """Negative log likelihood of each sequence: logp (T, B, A) log-softmax
    scores, lab (B, L) int64 labels, dlen / llen (B,) lengths."""
    t_max, nb, na = logp.shape
    dev, dt = logp.device, logp.dtype
    l_max = lab.shape[1]
    s = 2 * l_max + 1
    ext = torch.full((nb, s), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    pos = torch.arange(s, device=dev)
    valid_s = pos[None, :] < (2 * llen + 1)[:, None]
    ext_m2 = torch.cat([torch.full((nb, 2), -1, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], dim=1)
    can_skip = (pos % 2 == 1)[None, :] & (ext != ext_m2)
    # a padding label indexes from the end, as a negative jnp index does
    # (the positions it fills are masked)
    idx = torch.remainder(ext, na)
    neg = logp.new_full((), _NEG)
    first = logp[0].gather(1, idx[:, :2])
    alpha = torch.cat([first[:, :1],
                       torch.where(llen[:, None] > 0, first[:, 1:2], neg),
                       neg.expand(nb, s - 2)], dim=1)
    lae = _LogAddExp.apply
    for t in range(1, t_max):
        prev1 = torch.cat([neg.expand(nb, 1), alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg.expand(nb, 2), alpha[:, :-2]], dim=1)
        prev2 = torch.where(can_skip, prev2, neg)
        new = lae(lae(alpha, prev1), prev2) + logp[t].gather(1, idx)
        new = torch.where(valid_s, new, neg)
        alpha = torch.where((t < dlen)[:, None], new, alpha)
    end1 = alpha.gather(1, (2 * llen)[:, None])[:, 0]
    end2 = torch.where(llen > 0, alpha.gather(
        1, torch.remainder(2 * llen - 1, s)[:, None])[:, 0], neg)
    return -lae(end1, end2).to(dt)


def _ctc_loss(attrs, octx, data, label, *rest):
    # the optional lengths arrive positionally: dispatch on the flags
    data_lengths = label_lengths = None
    i = 0
    if attrs["use_data_lengths"]:
        data_lengths = rest[i]
        i += 1
    if attrs["use_label_lengths"]:
        label_lengths = rest[i]
    t_max, nb, na = data.shape
    blank_first = attrs["blank_label"] == "first"
    blank = 0 if blank_first else na - 1
    pad = 0 if blank_first else -1
    logp = torch.log_softmax(data, dim=-1)
    lab = label.to(torch.int64)
    llen = label_lengths.to(torch.int64) if label_lengths is not None \
        else (lab != pad).sum(dim=-1)
    dlen = data_lengths.to(torch.int64) if data_lengths is not None \
        else torch.full((nb,), t_max, dtype=torch.int64, device=data.device)
    return (_ctc_losses(logp, lab, dlen, llen, blank),)


def _ctc_inputs(attrs):
    names = ["data", "label"]
    if attrs["use_data_lengths"]:
        names.append("data_lengths")
    if attrs["use_label_lengths"]:
        names.append("label_lengths")
    return names


def _ctc_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None]
    return in_shapes, [(ds[1],)]


_ctc_schema = register(
    "CTCLoss", _ctc_loss,
    params={"use_data_lengths": Param("bool", False),
            "use_label_lengths": Param("bool", False),
            "blank_label": Param("str", "first")},
    inputs=("data", "label", "data_lengths", "label_lengths"),
    infer_shape=_ctc_infer,
    aliases=("ctc_loss", "_contrib_ctc_loss", "_contrib_CTCLoss"))
_ctc_schema.list_inputs = _ctc_inputs
_ctc_schema.num_inputs = lambda attrs: len(_ctc_inputs(attrs))


# ---------------------------------------------------------------------------
# fft / ifft, count_sketch, khatri_rao, quadratic
# ---------------------------------------------------------------------------

def _contrib_fft(attrs, octx, data):
    # float32 whatever the input's type, as the JAX op computes it
    spec = torch.fft.fft(data.to(torch.float32), dim=-1)
    out = torch.stack([spec.real, spec.imag], dim=-1)
    return (out.reshape(tuple(data.shape[:-1]) + (2 * data.shape[-1],))
            .to(data.dtype),)


def _contrib_fft_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None]
    return in_shapes, [tuple(ds[:-1]) + (2 * ds[-1],)]


register("_contrib_fft", _contrib_fft,
         params={"compute_size": Param("int", 128)},
         inputs=("data",), infer_shape=_contrib_fft_infer)


def _contrib_ifft(attrs, octx, data):
    d = data.shape[-1] // 2
    pairs = data.to(torch.float32).reshape(tuple(data.shape[:-1]) + (d, 2))
    spec = torch.complex(pairs[..., 0], pairs[..., 1])
    # the unnormalised inverse: the 1/N multiplied back out
    out = torch.fft.ifft(spec, dim=-1).real * d
    return (out.to(data.dtype),)


def _contrib_ifft_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None]
    return in_shapes, [tuple(ds[:-1]) + (ds[-1] // 2,)]


register("_contrib_ifft", _contrib_ifft,
         params={"compute_size": Param("int", 128)},
         inputs=("data",), infer_shape=_contrib_ifft_infer)


def _count_sketch(attrs, octx, data, h, s):
    hh = h.reshape(-1).to(torch.int64)
    signed = data * s.reshape(-1).to(data.dtype)
    out = data.new_zeros(tuple(data.shape[:-1]) + (attrs["out_dim"],))
    return (out.index_add(data.dim() - 1, hh, signed),)


def _count_sketch_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None]
    return in_shapes, [tuple(ds[:-1]) + (attrs["out_dim"],)]


register("_contrib_count_sketch", _count_sketch,
         params={"out_dim": Param("int", None, True),
                 "processing_batch_size": Param("int", 32)},
         inputs=("data", "h", "s"), infer_shape=_count_sketch_infer)


def _khatri_rao(attrs, octx, *mats):
    # column-wise: the columns shared, the rows Kronecker-multiplied
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[1])
    return (out,)


def _khatri_rao_infer(attrs, in_shapes):
    if any(s is None for s in in_shapes):
        return in_shapes, [None]
    return in_shapes, [(math.prod(s[0] for s in in_shapes),
                        in_shapes[0][1])]


register("khatri_rao", _khatri_rao,
         params={"num_args": Param("int", None, True)},
         inputs=("args",), key_var_num_args="num_args",
         infer_shape=_khatri_rao_infer)


register("_contrib_quadratic",
         lambda attrs, octx, data: (attrs["a"] * data * data
                                    + attrs["b"] * data + attrs["c"],),
         params={"a": Param("float", 0.0), "b": Param("float", 0.0),
                 "c": Param("float", 0.0)},
         inputs=("data",), infer_shape=_same_shape)


# ---------------------------------------------------------------------------
# R-CNN family: Proposal / MultiProposal (the NMS is the kernel of
# ops/rcnn.py on the card), PSROIPooling, DeformableConvolution,
# DeformablePSROIPooling
# ---------------------------------------------------------------------------

def _rpn_base_anchors(feature_stride, ratios, scales):
    """py-faster-rcnn's anchor table: ratios outer, scales inner, the
    +1-width conventions."""
    fs = float(feature_stride)
    w = h = fs
    x_ctr = y_ctr = (fs - 1.0) / 2.0
    size = w * h
    rows = []
    for ratio in ratios:
        size_ratio = math.floor(size / ratio)
        new_w = math.floor(math.sqrt(size_ratio) + 0.5)
        new_h = math.floor(new_w * ratio + 0.5)
        for scale in scales:
            sw, sh = new_w * scale, new_h * scale
            rows.append([x_ctr - 0.5 * (sw - 1), y_ctr - 0.5 * (sh - 1),
                         x_ctr + 0.5 * (sw - 1), y_ctr + 0.5 * (sh - 1)])
    return _np.asarray(rows, _np.float32)


def _proposals(fg_scores, deltas, iminfo, attrs):
    """RPN proposals of a batch: fg_scores (B, A, H, W), deltas (B, 4A,
    H, W), iminfo (B, 3) -> rois (B, post_n, 4), scores (B, post_n)."""
    top_boxes, top_scores, post_n = proposal_candidates(fg_scores, deltas,
                                                        iminfo, attrs)
    nb, dev = top_boxes.shape[0], top_boxes.device
    keep = rcnn.proposal_nms(nms_boxes(top_boxes), attrs["threshold"])
    pack = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    nkept = torch.clamp_min(keep.sum(dim=1), 1)
    # padded to post_n by cycling the kept proposals
    slots = torch.remainder(torch.arange(post_n, device=dev)[None, :],
                            nkept[:, None])
    sel = torch.gather(pack, 1, slots)
    rois = torch.gather(top_boxes, 1, sel[:, :, None].expand(nb, post_n, 4))
    return rois, torch.gather(top_scores, 1, sel)


def nms_boxes(top_boxes):
    """The boxes the NMS compares: the +1-width pixel IoU's far corners
    shifted by one (detached)."""
    return top_boxes.detach() + torch.tensor(
        [0.0, 0.0, 1.0, 1.0], dtype=top_boxes.dtype, device=top_boxes.device)


def proposal_candidates(fg_scores, deltas, iminfo, attrs):
    """The decoded, clipped, filtered boxes of a batch sorted by score
    and cut to pre_n: (top_boxes (B, pre_n, 4), top_scores (B, pre_n),
    post_n)."""
    nb, a, h, w = fg_scores.shape
    fs = attrs["feature_stride"]
    if a != len(attrs["ratios"]) * len(attrs["scales"]):
        raise MXNetError(
            f"Proposal: cls_prob has {a} anchors per position but "
            f"ratios x scales = "
            f"{len(attrs['ratios']) * len(attrs['scales'])}")
    dev, dt = fg_scores.device, fg_scores.dtype
    base = torch.from_numpy(_rpn_base_anchors(
        fs, attrs["ratios"], attrs["scales"])).to(dev)
    sx = torch.arange(w, dtype=dt, device=dev) * fs
    sy = torch.arange(h, dtype=dt, device=dev) * fs
    shift = torch.stack([sx[None, :].expand(h, w), sy[:, None].expand(h, w),
                         sx[None, :].expand(h, w), sy[:, None].expand(h, w)],
                        dim=-1)                              # (H, W, 4)
    anchors = shift[:, :, None, :] + base[None, None]        # (H, W, A, 4)
    d = deltas.reshape(nb, a, 4, h, w).permute(0, 3, 4, 1, 2)
    im_h = iminfo[:, 0, None, None, None]
    im_w = iminfo[:, 1, None, None, None]
    im_scale = iminfo[:, 2, None, None, None]
    if attrs["iou_loss"]:
        pred = anchors + d
    else:
        # the +1-width box decode
        aw = anchors[..., 2] - anchors[..., 0] + 1.0
        ah = anchors[..., 3] - anchors[..., 1] + 1.0
        ax = anchors[..., 0] + 0.5 * (aw - 1.0)
        ay = anchors[..., 1] + 0.5 * (ah - 1.0)
        cx = d[..., 0] * aw + ax
        cy = d[..., 1] * ah + ay
        pw = torch.exp(d[..., 2]) * aw
        phh = torch.exp(d[..., 3]) * ah
        pred = torch.stack([cx - 0.5 * (pw - 1), cy - 0.5 * (phh - 1),
                            cx + 0.5 * (pw - 1), cy + 0.5 * (phh - 1)],
                           dim=-1)
    hi = torch.stack([im_w - 1, im_h - 1, im_w - 1, im_h - 1], dim=-1)
    pred = _clip(pred, 0.0, hi)
    score = fg_scores.permute(0, 2, 3, 1)                    # (B, H, W, A)
    # anchors in the padding beyond the true image extent, and boxes
    # under rpn_min_size (scaled to the input image), score -1
    real_h = torch.floor(rcnn.ieee_div(im_h, fs))
    real_w = torch.floor(rcnn.ieee_div(im_w, fs))
    inside = (torch.arange(h, device=dev)[:, None, None] < real_h) & \
             (torch.arange(w, device=dev)[None, :, None] < real_w)
    minus1 = score.new_full((), -1.0)
    score = torch.where(inside, score, minus1)
    min_size = attrs["rpn_min_size"] * im_scale
    iw = pred[..., 2] - pred[..., 0] + 1.0
    ih = pred[..., 3] - pred[..., 1] + 1.0
    score = torch.where((iw < min_size) | (ih < min_size), minus1, score)
    boxes = pred.reshape(nb, -1, 4)
    score = score.reshape(nb, -1)
    count = boxes.shape[1]
    pre_n = attrs["rpn_pre_nms_top_n"]
    pre_n = count if pre_n <= 0 else min(pre_n, count)
    post_n = min(attrs["rpn_post_nms_top_n"], pre_n)
    # lax.top_k's order: descending, the lower index first among ties
    order = torch.argsort(score.detach(), dim=1, descending=True,
                          stable=True)[:, :pre_n]
    top_scores = torch.gather(score, 1, order)
    top_boxes = torch.gather(boxes, 1, order[:, :, None].expand(nb, pre_n, 4))
    return top_boxes, top_scores, post_n


def _proposal(attrs, octx, cls_prob, bbox_pred, im_info):
    if cls_prob.shape[0] != 1:
        raise MXNetError("Proposal supports batch size 1 only; use "
                         "_contrib_MultiProposal for batched inputs")
    a2 = cls_prob.shape[1]
    rois, scores = _proposals(cls_prob[:, a2 // 2:], bbox_pred, im_info,
                              attrs)
    rois, scores = rois[0], scores[0]
    out = torch.cat([rois.new_zeros((rois.shape[0], 1)), rois], dim=1)
    return (out, scores[:, None])


def _multi_proposal(attrs, octx, cls_prob, bbox_pred, im_info):
    a2 = cls_prob.shape[1]
    rois, scores = _proposals(cls_prob[:, a2 // 2:], bbox_pred, im_info,
                              attrs)
    n, post_n = rois.shape[:2]
    bidx = torch.arange(n, dtype=rois.dtype, device=rois.device)[
        :, None, None].expand(n, post_n, 1)
    out = torch.cat([bidx, rois], dim=2).reshape(n * post_n, 5)
    return (out, scores.reshape(n * post_n, 1))


_PROPOSAL_PARAMS = {
    "rpn_pre_nms_top_n": Param("int", 6000),
    "rpn_post_nms_top_n": Param("int", 300),
    "threshold": Param("float", 0.7),
    "rpn_min_size": Param("int", 16),
    "scales": Param("floats", (4.0, 8.0, 16.0, 32.0)),
    "ratios": Param("floats", (0.5, 1.0, 2.0)),
    "feature_stride": Param("int", 16),
    "output_score": Param("bool", False),
    "iou_loss": Param("bool", False),
}


def _proposal_infer(attrs, in_shapes):
    cs = in_shapes[0]
    if cs is None:
        return in_shapes, [None, None]
    count = (cs[1] // 2) * cs[2] * cs[3]
    pre = attrs["rpn_pre_nms_top_n"]
    pre = count if pre <= 0 else min(pre, count)
    post = min(attrs["rpn_post_nms_top_n"], pre)
    return in_shapes, [(cs[0] * post, 5), (cs[0] * post, 1)]


register("_contrib_Proposal", _proposal, params=dict(_PROPOSAL_PARAMS),
         inputs=("cls_prob", "bbox_pred", "im_info"), num_outputs=2,
         infer_shape=_proposal_infer)
register("_contrib_MultiProposal", _multi_proposal,
         params=dict(_PROPOSAL_PARAMS),
         inputs=("cls_prob", "bbox_pred", "im_info"), num_outputs=2,
         infer_shape=_proposal_infer)


def _psroi_channel_maps(pooled, group):
    """The group row / column of each bin."""
    return _np.clip((_np.arange(pooled) * group) // pooled, 0, group - 1)


# bytes of PSROIPooling's (rois, od, p, p, H, W) selection a chunk
_PSROI_CHUNK_BYTES = 256 << 20


def _psroi_pooling(attrs, octx, data, rois):
    scale = attrs["spatial_scale"]
    od = attrs["output_dim"]
    p = attrs["pooled_size"]
    g = attrs["group_size"] or p
    n, channels, h, w = data.shape
    if channels != od * g * g:
        raise MXNetError(f"PSROIPooling: data channels {channels} != "
                         f"output_dim*group_size^2 = {od * g * g}")
    gi = torch.from_numpy(_psroi_channel_maps(p, g)).to(data.device)
    r = rois.detach().to(data.dtype)
    bidx = r[:, 0].to(torch.int64).clamp(0, n - 1)
    x1 = _round_half_away(r[:, 1]) * scale
    y1 = _round_half_away(r[:, 2]) * scale
    x2 = (_round_half_away(r[:, 3]) + 1.0) * scale
    y2 = (_round_half_away(r[:, 4]) + 1.0) * scale
    rw = torch.clamp_min(x2 - x1, 0.1)
    rh = torch.clamp_min(y2 - y1, 0.1)
    bh, bw = rcnn.ieee_div(rh, p), rcnn.ieee_div(rw, p)
    i = torch.arange(p, dtype=data.dtype, device=data.device)[None, :]
    hs = torch.floor(i * bh[:, None] + y1[:, None]).clamp(0, h)
    he = torch.ceil((i + 1) * bh[:, None] + y1[:, None]).clamp(0, h)
    ws = torch.floor(i * bw[:, None] + x1[:, None]).clamp(0, w)
    we = torch.ceil((i + 1) * bw[:, None] + x1[:, None]).clamp(0, w)
    posh = torch.arange(h, dtype=data.dtype, device=data.device)
    posw = torch.arange(w, dtype=data.dtype, device=data.device)
    mh = ((posh >= hs[..., None]) & (posh < he[..., None])).to(data.dtype)
    mw = ((posw >= ws[..., None]) & (posw < we[..., None])).to(data.dtype)
    area = mh.sum(2)[:, :, None] * mw.sum(2)[:, None, :]     # (R, p, p)
    step = max(1, _PSROI_CHUNK_BYTES // max(
        1, od * p * p * h * w * data.element_size()))
    tots = []
    for s in range(0, r.shape[0], step):
        img = data[bidx[s:s + step]].reshape(-1, od, g, g, h, w)
        sel = img[:, :, gi][:, :, :, gi]            # (r, od, p, p, H, W)
        tots.append(torch.einsum("rocdhw,rch,rdw->rocd", sel,
                                 mh[s:s + step], mw[s:s + step]))
    if not tots:
        return (data.new_zeros((0, od, p, p)),)
    tot = torch.cat(tots)
    out = torch.where(area[:, None] > 0,
                      tot / torch.clamp_min(area, 1.0)[:, None],
                      torch.zeros_like(tot))
    return (out,)


def _psroi_infer(attrs, in_shapes):
    ds, rs = in_shapes
    if ds is None or rs is None:
        return in_shapes, [None]
    p = attrs["pooled_size"]
    return in_shapes, [(rs[0], attrs["output_dim"], p, p)]


register("_contrib_PSROIPooling", _psroi_pooling,
         params={"spatial_scale": Param("float", None, True),
                 "output_dim": Param("int", None, True),
                 "pooled_size": Param("int", None, True),
                 "group_size": Param("int", 0)},
         inputs=("data", "rois"), infer_shape=_psroi_infer)


def _clamped_bilinear(flat, hw, base, gx, gy):
    """Bilinear samples with clamped coordinates and the +-0.5 border
    mask. ``flat``: the data flattened; ``hw``: (H, W); ``base``: each
    sample's offset of its (image, channel) plane in ``flat`` (int64,
    broadcast with gx, gy). Returns (values, in-bounds mask)."""
    h, w = hw
    ok = (gx >= -0.5) & (gx <= w - 0.5) & (gy >= -0.5) & (gy <= h - 0.5)
    gx = _clip(gx, 0.0, w - 1.0)
    gy = _clip(gy, 0.0, h - 1.0)
    x1 = torch.floor(gx)
    y1 = torch.floor(gy)
    dx = gx - x1
    dy = gy - y1
    x1i = x1.to(torch.int64)
    y1i = y1.to(torch.int64)
    x2i = torch.clamp_max(x1i + 1, w - 1)
    y2i = torch.clamp_max(y1i + 1, h - 1)
    v11 = flat[base + y1i * w + x1i]
    v12 = flat[base + y2i * w + x1i]
    v21 = flat[base + y1i * w + x2i]
    v22 = flat[base + y2i * w + x2i]
    val = ((1 - dx) * (1 - dy) * v11 + (1 - dx) * dy * v12 +
           dx * (1 - dy) * v21 + dx * dy * v22)
    return val, ok


def _deformable_conv(attrs, octx, data, offset, weight, bias=None):
    kh, kw = attrs["kernel"]
    sh, sw = attrs["stride"] or (1, 1)
    dh, dw = attrs["dilate"] or (1, 1)
    ph, pw = attrs["pad"] or (0, 0)
    ng = attrs["num_group"]
    ndg = attrs["num_deformable_group"]
    n, cin, h, w = data.shape
    nf = attrs["num_filter"]
    oh = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    ow = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    cpg = cin // ndg
    kk = kh * kw
    kw_ = dict(dtype=data.dtype, device=data.device)
    oy = torch.arange(oh, **kw_) * sh - ph
    ox = torch.arange(ow, **kw_) * sw - pw
    ti = torch.arange(kh, device=data.device).repeat_interleave(kw)
    tj = torch.arange(kw, device=data.device).repeat(kh)
    off = offset.reshape(n, ndg, kk, 2, oh, ow)
    # (N, ndg, K, oh, ow): the tap's position, then its offset
    gy = (oy[None, None, None, :, None] + (ti * dh).to(data.dtype)[
        None, None, :, None, None]) + off[:, :, :, 0]
    gx = (ox[None, None, None, None, :] + (tj * dw).to(data.dtype)[
        None, None, :, None, None]) + off[:, :, :, 1]
    # every channel of a deformable group samples its group's points
    plane = (torch.arange(n, device=data.device)[:, None, None] * cin
             + torch.arange(ndg, device=data.device)[None, :, None] * cpg
             + torch.arange(cpg, device=data.device)[None, None, :]) * (h * w)
    base = plane[:, :, :, None, None, None]         # (N, ndg, cpg, 1, 1, 1)
    v, ok = _clamped_bilinear(data.reshape(-1), (h, w), base,
                              gx[:, :, None], gy[:, :, None])
    # (N, ndg, cpg, K, oh, ow)
    cols = torch.where(ok, v, torch.zeros_like(v))
    cols = cols.reshape(n, ng, (cin // ng) * kk, oh * ow)
    wmat = weight.reshape(ng, nf // ng, (cin // ng) * kk)
    out = torch.einsum("gfk,ngko->ngfo", wmat, cols).reshape(n, nf, oh, ow)
    if not attrs["no_bias"]:
        out = out + bias.reshape(1, -1, 1, 1)
    return (out,)


def _deformable_conv_infer(attrs, in_shapes):
    ds = in_shapes[0]
    nf = attrs["num_filter"]
    kh, kw = attrs["kernel"]
    if ds is not None:
        in_shapes = list(in_shapes)
        ng = attrs["num_group"]
        if in_shapes[2] is None:
            in_shapes[2] = (nf, ds[1] // ng, kh, kw)
        if len(in_shapes) > 3 and in_shapes[3] is None:
            in_shapes[3] = (nf,)
    if ds is None:
        return in_shapes, [None]
    sh, sw = attrs["stride"] or (1, 1)
    dh, dw = attrs["dilate"] or (1, 1)
    ph, pw = attrs["pad"] or (0, 0)
    oh = (ds[2] + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    ow = (ds[3] + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    return in_shapes, [(ds[0], nf, oh, ow)]


def _deform_conv_inputs(attrs):
    base = ["data", "offset", "weight"]
    return base if attrs["no_bias"] else base + ["bias"]


_dconv_schema = register(
    "_contrib_DeformableConvolution", _deformable_conv,
    params={"kernel": Param("shape", None, True),
            "stride": Param("shape", None),
            "dilate": Param("shape", None),
            "pad": Param("shape", None),
            "num_filter": Param("int", None, True),
            "num_group": Param("int", 1),
            "num_deformable_group": Param("int", 1),
            "workspace": Param("int", 1024),
            "no_bias": Param("bool", False),
            "layout": Param("str", None)},
    inputs=("data", "offset", "weight", "bias"),
    infer_shape=_deformable_conv_infer)
_dconv_schema.list_inputs = _deform_conv_inputs
_dconv_schema.num_inputs = lambda attrs: len(_deform_conv_inputs(attrs))


def _deformable_psroi_pooling(attrs, octx, data, rois, trans=None):
    scale = attrs["spatial_scale"]
    od = attrs["output_dim"]
    p = attrs["pooled_size"]
    g = attrs["group_size"]
    part = attrs["part_size"] or p
    sp = attrs["sample_per_part"]
    tstd = attrs["trans_std"]
    no_trans = attrs["no_trans"] or trans is None
    n, channels, h, w = data.shape
    dev, dt = data.device, data.dtype
    num_cls = 1 if no_trans else trans.shape[1] // 2
    cpc = od // num_cls
    gi = _psroi_channel_maps(p, g)
    parth = _np.floor(_np.arange(p) / p * part).astype(_np.int64)
    nr = rois.shape[0]
    r = rois.detach().to(dt)
    bidx = r[:, 0].to(torch.int64).clamp(0, n - 1)
    x1 = _round_half_away(r[:, 1]) * scale - 0.5
    y1 = _round_half_away(r[:, 2]) * scale - 0.5
    x2 = (_round_half_away(r[:, 3]) + 1.0) * scale - 0.5
    y2 = (_round_half_away(r[:, 4]) + 1.0) * scale - 0.5
    rw = torch.clamp_min(x2 - x1, 0.1)
    rh = torch.clamp_min(y2 - y1, 0.1)
    bh, bw = rcnn.ieee_div(rh, p), rcnn.ieee_div(rw, p)
    sbh, sbw = rcnn.ieee_div(bh, sp), rcnn.ieee_div(bw, sp)
    # every (roi, channel, bin row, bin column) at once: (R, od, p, p)
    if no_trans:
        tx = ty = data.new_zeros((nr, od, p, p))
    else:
        cls2 = torch.from_numpy(_np.arange(od) // cpc * 2).to(dev)
        pp = torch.from_numpy(parth).to(dev)
        tr = trans[:, :, pp][:, :, :, pp]                   # (R, 2C, p, p)
        tx = tr[:, cls2] * tstd
        ty = tr[:, cls2 + 1] * tstd
    ip = torch.arange(p, device=dev)
    hstart = ip.to(dt)[None, None, :, None] * bh[:, None, None, None] \
        + y1[:, None, None, None] + ty * rh[:, None, None, None]
    wstart = ip.to(dt)[None, None, None, :] * bw[:, None, None, None] \
        + x1[:, None, None, None] + tx * rw[:, None, None, None]
    ih = torch.arange(sp, dtype=dt, device=dev)
    # (R, od, p, p, sp, sp)
    gy = hstart[..., None, None] + ih[:, None] * sbh[:, None, None, None,
                                                     None, None]
    gx = wstart[..., None, None] + ih[None, :] * sbw[:, None, None, None,
                                                     None, None]
    gy, gx = torch.broadcast_tensors(gy, gx)
    gpi = torch.from_numpy(gi).to(dev)
    chan = (torch.arange(od, device=dev)[:, None, None] * g
            + gpi[None, :, None]) * g + gpi[None, None, :]  # (od, p, p)
    base = ((bidx[:, None, None, None] * channels + chan[None])
            * (h * w))[..., None, None]
    vals, ok = _clamped_bilinear(data.reshape(-1), (h, w), base, gx, gy)
    cnt = ok.sum(dim=(4, 5))
    tot = torch.where(ok, vals, torch.zeros_like(vals)).sum(dim=(4, 5))
    out = torch.where(cnt > 0, tot / torch.clamp_min(cnt, 1),
                      torch.zeros_like(tot))
    return (out,)


def _deform_psroi_inputs(attrs):
    return ["data", "rois"] if attrs["no_trans"] else \
        ["data", "rois", "trans"]


def _deform_psroi_infer(attrs, in_shapes):
    ds, rs = in_shapes[0], in_shapes[1]
    if ds is None or rs is None:
        return in_shapes, [None]
    p = attrs["pooled_size"]
    return in_shapes, [(rs[0], attrs["output_dim"], p, p)]


_dpsroi_schema = register(
    "_contrib_DeformablePSROIPooling", _deformable_psroi_pooling,
    params={"spatial_scale": Param("float", None, True),
            "output_dim": Param("int", None, True),
            "group_size": Param("int", None, True),
            "pooled_size": Param("int", None, True),
            "part_size": Param("int", 0),
            "sample_per_part": Param("int", 1),
            "trans_std": Param("float", 0.0),
            "no_trans": Param("bool", False)},
    inputs=("data", "rois", "trans"), infer_shape=_deform_psroi_infer)
_dpsroi_schema.list_inputs = _deform_psroi_inputs
_dpsroi_schema.num_inputs = lambda attrs: len(_deform_psroi_inputs(attrs))


# ---------------------------------------------------------------------------
# legacy Crop: the spatial dims cut to h_w or to a second input's size,
# from the offset or the centre
# ---------------------------------------------------------------------------

def _crop_op(attrs, octx, data, crop_like=None):
    _, _, h, w = data.shape
    if crop_like is not None:
        th, tw = crop_like.shape[2], crop_like.shape[3]
    else:
        th, tw = attrs["h_w"]
    if th <= 0 or tw <= 0:
        raise MXNetError("Crop: need h_w or a second (crop_like) input")
    if attrs["center_crop"]:
        oy, ox = (h - th) // 2, (w - tw) // 2
    else:
        oy, ox = attrs["offset"]
    if oy + th > h or ox + tw > w:
        raise MXNetError(f"Crop: crop window ({oy}:{oy+th},{ox}:{ox+tw}) "
                         f"exceeds input ({h},{w})")
    return (data[:, :, oy:oy + th, ox:ox + tw],)


def _crop_op_infer(attrs, in_shapes):
    ds = in_shapes[0]
    if ds is None:
        return in_shapes, [None]
    if len(in_shapes) > 1 and in_shapes[1] is not None:
        th, tw = in_shapes[1][2], in_shapes[1][3]
    else:
        th, tw = attrs["h_w"]
    return in_shapes, [(ds[0], ds[1], th, tw)]


_crop_schema = register(
    "Crop", _crop_op,
    params={"num_args": Param("int", 1),
            "offset": Param("shape", (0, 0)),
            "h_w": Param("shape", (0, 0)),
            "center_crop": Param("bool", False)},
    inputs=("data", "crop_like"), infer_shape=_crop_op_infer)
_crop_schema.list_inputs = lambda attrs: (
    ["data", "crop_like"] if attrs["num_args"] == 2 else ["data"])
_crop_schema.num_inputs = lambda attrs: attrs["num_args"]
