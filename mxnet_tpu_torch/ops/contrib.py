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

The other ops of the JAX module (ROI/PSROI pooling, Proposal, the
deformable ops, CTC, fft, the samplers and the rest) are not ported yet
(ROADMAP item 17): ``registry.get_op`` names that item for them.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from .registry import Param, register

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
