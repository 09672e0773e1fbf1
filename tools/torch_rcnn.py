"""Faster R-CNN end-to-end training, written once for either package.

The network of MXNet's ``example/rcnn`` end-to-end training
(``symbol_vgg.get_vgg_train``: py-faster-rcnn's ``faster_rcnn_end2end``):
VGG16's ``conv1_1`` .. ``conv5_3``, the RPN (a 3 x 3 convolution, 2A
class scores and 4A box deltas a position, A = 9 anchors at scales 8,
16, 32 and ratios 0.5, 1, 2, stride 16), ``_contrib_Proposal`` (12,000
boxes before NMS, 2,000 after, NMS 0.7, min size 16), the
``proposal_target`` Custom op (128 rois an image, a quarter foreground
at IoU >= 0.5, background in [0, 0.5), box targets normalised by the
stds 0.1, 0.1, 0.2, 0.2), ``ROIPooling`` 7 x 7 at 1/16, fc6 and fc7 of
4096 with dropout, and the class and box heads; the losses are
``SoftmaxOutput`` (the RPN's over the sampled anchors, ``ignore_label``
-1) and ``smooth_l1`` through ``MakeLoss`` at the example's scales. The
anchor targets are assigned on the host in numpy, as the example's
``AnchorLoader`` does (256 anchors an image, half foreground at most,
IoU 0.7 / 0.3).

Nothing here imports either package: each function takes the package
module ``mx`` (``mxnet_tpu_torch`` on the card, either package in the
CPU tests), so one definition serves the card's phase and the parity
test. Images and boxes are synthetic, drawn from a seed.
"""
import numpy as np

# (convolutions, filters, max-pool window after the stage; 0: none)
VGG16 = ((2, 64, 2), (2, 128, 2), (3, 256, 2), (3, 512, 2), (3, 512, 0))
SCALES = (8, 16, 32)
RATIOS = (0.5, 1, 2)
STRIDE = 16
BBOX_STDS = (0.1, 0.1, 0.2, 0.2)
RPN_BATCH = 256
RPN_FG_FRACTION = 0.5
RPN_POSITIVE_OVERLAP = 0.7
RPN_NEGATIVE_OVERLAP = 0.3
FG_THRESH = 0.5
BG_THRESH_HI = 0.5
BG_THRESH_LO = 0.0
# in NDArrayIter's order (it sorts a dict's names)
DATA_NAMES = ("data", "gt_boxes", "im_info")
LABEL_NAMES = ("bbox_target", "bbox_weight", "label")


def fixed_param_names(stages=VGG16, fixed_stages=2):
    """The example's FIXED_PARAMS for VGG16: conv1_* and conv2_*."""
    return ["conv%d_%d_%s" % (s + 1, c + 1, kind)
            for s in range(fixed_stages) for c in range(stages[s][0])
            for kind in ("weight", "bias")]


def faster_rcnn_symbol(mx, num_classes=21, stages=VGG16, rpn_pre=12000,
                       rpn_post=2000, batch_rois=128, fg_fraction=0.25,
                       hidden=4096, dropout=0.5, seed=0, scales=SCALES):
    """The training symbol; outputs [rpn_cls_prob, rpn_bbox_loss,
    cls_prob, bbox_loss, BlockGrad(label)] as the example's."""
    register_proposal_target(mx)
    sym = mx.sym
    data = sym.Variable("data")
    im_info = sym.Variable("im_info")
    gt_boxes = sym.Variable("gt_boxes")
    rpn_label = sym.Variable("label")
    rpn_bbox_target = sym.Variable("bbox_target")
    rpn_bbox_weight = sym.Variable("bbox_weight")
    x = data
    for s, (n, filters, pool) in enumerate(stages):
        for c in range(n):
            name = "%d_%d" % (s + 1, c + 1)
            x = sym.Convolution(x, kernel=(3, 3), pad=(1, 1),
                                num_filter=filters, name="conv" + name)
            x = sym.Activation(x, act_type="relu", name="relu" + name)
        if pool:
            x = sym.Pooling(x, pool_type="max", kernel=(pool, pool),
                            stride=(pool, pool), name="pool%d" % (s + 1))
    feat = x
    num_anchors = len(scales) * len(RATIOS)
    rpn = sym.Convolution(feat, kernel=(3, 3), pad=(1, 1),
                          num_filter=stages[-1][1], name="rpn_conv_3x3")
    rpn = sym.Activation(rpn, act_type="relu", name="rpn_relu")
    rpn_cls_score = sym.Convolution(rpn, kernel=(1, 1), pad=(0, 0),
                                    num_filter=2 * num_anchors,
                                    name="rpn_cls_score")
    rpn_bbox_pred = sym.Convolution(rpn, kernel=(1, 1), pad=(0, 0),
                                    num_filter=4 * num_anchors,
                                    name="rpn_bbox_pred")
    score_reshape = sym.Reshape(rpn_cls_score, shape=(0, 2, -1, 0),
                                name="rpn_cls_score_reshape")
    rpn_cls_prob = sym.SoftmaxOutput(score_reshape, rpn_label,
                                     multi_output=True,
                                     normalization="valid", use_ignore=True,
                                     ignore_label=-1, name="rpn_cls_prob")
    rpn_bbox_loss = sym.MakeLoss(
        rpn_bbox_weight * sym.smooth_l1(rpn_bbox_pred - rpn_bbox_target,
                                        scalar=3.0),
        grad_scale=1.0 / RPN_BATCH, name="rpn_bbox_loss")
    rpn_cls_act = sym.SoftmaxActivation(score_reshape, mode="channel",
                                        name="rpn_cls_act")
    rpn_cls_act = sym.Reshape(rpn_cls_act, shape=(0, 2 * num_anchors, -1, 0),
                              name="rpn_cls_act_reshape")
    rois = sym.contrib.Proposal(
        rpn_cls_act, rpn_bbox_pred, im_info, name="rois",
        feature_stride=STRIDE, scales=scales, ratios=RATIOS,
        rpn_pre_nms_top_n=rpn_pre, rpn_post_nms_top_n=rpn_post,
        threshold=0.7, rpn_min_size=STRIDE)[0]
    gt = sym.Reshape(gt_boxes, shape=(-1, 5), name="gt_boxes_reshape")
    group = sym.Custom(rois, gt, op_type="proposal_target",
                       num_classes=num_classes, batch_images=1,
                       batch_rois=batch_rois, fg_fraction=fg_fraction,
                       seed=seed, name="proposal_target")
    rois, label, bbox_target, bbox_weight = (group[i] for i in range(4))
    pool5 = sym.ROIPooling(feat, rois, pooled_size=(7, 7),
                           spatial_scale=1.0 / STRIDE, name="roi_pool5")
    x = sym.Flatten(pool5, name="flatten")
    for k in (6, 7):
        x = sym.FullyConnected(x, num_hidden=hidden, name="fc%d" % k)
        x = sym.Activation(x, act_type="relu", name="relu%d" % k)
        if dropout:
            x = sym.Dropout(x, p=dropout, name="drop%d" % k)
    cls_score = sym.FullyConnected(x, num_hidden=num_classes,
                                   name="cls_score")
    cls_prob = sym.SoftmaxOutput(cls_score, label, normalization="batch",
                                 name="cls_prob")
    bbox_pred = sym.FullyConnected(x, num_hidden=4 * num_classes,
                                   name="bbox_pred")
    bbox_loss = sym.MakeLoss(
        bbox_weight * sym.smooth_l1(bbox_pred - bbox_target, scalar=1.0),
        grad_scale=1.0 / batch_rois, name="bbox_loss")
    return sym.Group([rpn_cls_prob, rpn_bbox_loss, cls_prob, bbox_loss,
                      sym.BlockGrad(label, name="label_out")])


def feature_shape(stages, height, width):
    """The feature map's (H, W) after the stages' pooling (valid)."""
    for _, _, pool in stages:
        if pool:
            height, width = height // pool, width // pool
    return height, width


# -- boxes (the example's rcnn/processing, +1-width pixel conventions) -------

def generate_anchors(base_size=STRIDE, ratios=RATIOS, scales=SCALES):
    """The 9 base anchors: ratios outer, scales inner."""
    w = h = float(base_size)
    x_ctr = y_ctr = (base_size - 1.0) / 2.0
    rows = []
    for ratio in ratios:
        size_ratio = np.floor(w * h / ratio)
        ws = np.floor(np.sqrt(size_ratio) + 0.5)
        hs = np.floor(ws * ratio + 0.5)
        for scale in scales:
            sw, sh = ws * scale, hs * scale
            rows.append([x_ctr - 0.5 * (sw - 1), y_ctr - 0.5 * (sh - 1),
                         x_ctr + 0.5 * (sw - 1), y_ctr + 0.5 * (sh - 1)])
    return np.asarray(rows, np.float32)


def bbox_overlaps(boxes, query):
    """IoU of every box with every query box, +1 widths: (N, K)."""
    b = boxes[:, None, :].astype(np.float64)
    q = query[None, :, :].astype(np.float64)
    iw = np.minimum(b[..., 2], q[..., 2]) - np.maximum(b[..., 0], q[..., 0]) \
        + 1
    ih = np.minimum(b[..., 3], q[..., 3]) - np.maximum(b[..., 1], q[..., 1]) \
        + 1
    area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    area_q = (q[..., 2] - q[..., 0] + 1) * (q[..., 3] - q[..., 1] + 1)
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    return np.where((iw > 0) & (ih > 0),
                    inter / (area_b + area_q - inter), 0.0)


def bbox_transform(ex, gt):
    """Box regression targets of ``ex`` toward ``gt`` (N, 4)."""
    ew = ex[:, 2] - ex[:, 0] + 1.0
    eh = ex[:, 3] - ex[:, 1] + 1.0
    ex_x = ex[:, 0] + 0.5 * (ew - 1.0)
    ex_y = ex[:, 1] + 0.5 * (eh - 1.0)
    gw = gt[:, 2] - gt[:, 0] + 1.0
    gh = gt[:, 3] - gt[:, 1] + 1.0
    gx = gt[:, 0] + 0.5 * (gw - 1.0)
    gy = gt[:, 1] + 0.5 * (gh - 1.0)
    return np.stack([(gx - ex_x) / (ew + 1e-14), (gy - ex_y) / (eh + 1e-14),
                     np.log(gw / ew), np.log(gh / eh)], axis=1)


def assign_anchors(feat_hw, gt_boxes, im_info, rng, allowed_border=0,
                   scales=SCALES):
    """The RPN's targets of one image (AnchorLoader's assign_anchor):
    label (1, A*H, W) in {1, 0, -1} (the example's (1, A*H*W), in the
    spatial shape of the scores that both packages' multi_output
    SoftmaxOutput takes), bbox_target / bbox_weight (1, 4A, H, W);
    ``rng`` draws the fg / bg subsample."""
    base = generate_anchors(scales=scales)
    a = base.shape[0]
    fh, fw = feat_hw
    sx, sy = np.meshgrid(np.arange(fw) * STRIDE, np.arange(fh) * STRIDE)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], 1)
    anchors_all = (base[None] + shifts[:, None]).reshape(-1, 4)
    total = anchors_all.shape[0]
    inside = np.where((anchors_all[:, 0] >= -allowed_border)
                      & (anchors_all[:, 1] >= -allowed_border)
                      & (anchors_all[:, 2] < im_info[1] + allowed_border)
                      & (anchors_all[:, 3] < im_info[0] + allowed_border))[0]
    anchors = anchors_all[inside]
    labels = np.full(len(inside), -1, np.float32)
    overlaps = bbox_overlaps(anchors, gt_boxes[:, :4])
    argmax = overlaps.argmax(axis=1)
    max_ov = overlaps[np.arange(len(inside)), argmax]
    gt_max = overlaps[overlaps.argmax(axis=0), np.arange(overlaps.shape[1])]
    gt_argmax = np.where(overlaps == gt_max)[0]
    labels[max_ov < RPN_NEGATIVE_OVERLAP] = 0
    labels[gt_argmax] = 1
    labels[max_ov >= RPN_POSITIVE_OVERLAP] = 1
    num_fg = int(RPN_FG_FRACTION * RPN_BATCH)
    fg = np.where(labels == 1)[0]
    if len(fg) > num_fg:
        labels[rng.choice(fg, size=len(fg) - num_fg, replace=False)] = -1
    num_bg = RPN_BATCH - int(np.sum(labels == 1))
    bg = np.where(labels == 0)[0]
    if len(bg) > num_bg:
        labels[rng.choice(bg, size=len(bg) - num_bg, replace=False)] = -1
    targets = bbox_transform(anchors, gt_boxes[argmax, :4])
    weights = np.zeros((len(inside), 4), np.float32)
    weights[labels == 1] = 1.0

    def unmap(v, fill):
        out = np.full((total,) + v.shape[1:], fill, np.float32)
        out[inside] = v
        return out

    labels = unmap(labels, -1).reshape(1, fh, fw, a).transpose(0, 3, 1, 2)
    targets = unmap(targets, 0).reshape(1, fh, fw, 4 * a) \
        .transpose(0, 3, 1, 2)
    weights = unmap(weights, 0).reshape(1, fh, fw, 4 * a) \
        .transpose(0, 3, 1, 2)
    return (labels.reshape(1, a * fh, fw), np.ascontiguousarray(targets),
            np.ascontiguousarray(weights))


def sample_rois(rois, gt_boxes, fg_per_image, rois_per_image, num_classes,
                rng):
    """proposal_target's sampling (the example's sample_rois): rois (N,
    5) with the ground truth appended -> (rois, labels, bbox_targets,
    bbox_weights) of ``rois_per_image`` rows."""
    overlaps = bbox_overlaps(rois[:, 1:], gt_boxes[:, :4])
    assign = overlaps.argmax(axis=1)
    best = overlaps.max(axis=1)
    labels = gt_boxes[assign, 4]
    fg = np.where(best >= FG_THRESH)[0]
    n_fg = int(min(fg_per_image, fg.size))
    if fg.size > n_fg:
        fg = rng.choice(fg, size=n_fg, replace=False)
    bg = np.where((best < BG_THRESH_HI) & (best >= BG_THRESH_LO))[0]
    n_bg = int(min(rois_per_image - n_fg, bg.size))
    if bg.size > n_bg:
        bg = rng.choice(bg, size=n_bg, replace=False)
    keep = np.append(fg, bg)
    while keep.shape[0] < rois_per_image:     # pad to a fixed batch
        gap = min(len(rois), rois_per_image - keep.shape[0])
        keep = np.append(keep, rng.choice(range(len(rois)), size=gap,
                                          replace=False))
    labels = labels[keep].copy()
    labels[n_fg:] = 0
    rois = rois[keep]
    targets = bbox_transform(rois[:, 1:], gt_boxes[assign[keep], :4]) \
        / np.asarray(BBOX_STDS)
    bbox_targets = np.zeros((rois_per_image, 4 * num_classes))
    bbox_weights = np.zeros_like(bbox_targets)
    for i in np.where(labels > 0)[0]:
        c = int(labels[i])
        bbox_targets[i, 4 * c:4 * c + 4] = targets[i]
        bbox_weights[i, 4 * c:4 * c + 4] = 1.0
    return rois, labels, bbox_targets, bbox_weights


def register_proposal_target(mx):
    """Register the ``proposal_target`` Custom op with ``mx`` (once). Its
    forward samples with a RandomState seeded in the operator's
    constructor, so a forward draws alike in both packages."""
    if "proposal_target" in mx.operator.get_all_registered():
        return

    class ProposalTarget(mx.operator.CustomOp):
        def __init__(self, num_classes, batch_rois, fg_fraction, seed):
            super().__init__()
            self._num_classes = num_classes
            self._batch_rois = batch_rois
            self._fg_fraction = fg_fraction
            self._rng = np.random.RandomState(seed)

        def forward(self, is_train, req, in_data, out_data, aux):
            all_rois = np.asarray(in_data[0])
            gt_boxes = np.asarray(in_data[1])
            zeros = np.zeros((gt_boxes.shape[0], 1), all_rois.dtype)
            all_rois = np.vstack((all_rois,
                                  np.hstack((zeros, gt_boxes[:, :-1]))))
            fg = np.round(self._fg_fraction * self._batch_rois)
            outs = sample_rois(all_rois, gt_boxes, fg, self._batch_rois,
                               self._num_classes, self._rng)
            for i, v in enumerate(outs):
                self.assign(out_data[i], req[i], v)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            for i in range(len(in_grad)):
                self.assign(in_grad[i], req[i], 0)

    @mx.operator.register("proposal_target")
    class ProposalTargetProp(mx.operator.CustomOpProp):
        def __init__(self, num_classes, batch_images, batch_rois,
                     fg_fraction="0.25", seed="0"):
            super().__init__(need_top_grad=False)
            self._num_classes = int(num_classes)
            self._batch_rois = int(batch_rois) // int(batch_images)
            self._fg_fraction = float(fg_fraction)
            self._seed = int(seed)

        def list_arguments(self):
            return ["rois", "gt_boxes"]

        def list_outputs(self):
            return ["rois_output", "label", "bbox_target", "bbox_weight"]

        def infer_shape(self, in_shape):
            n = self._batch_rois
            return in_shape, [(n, 5), (n,), (n, 4 * self._num_classes),
                              (n, 4 * self._num_classes)], []

        def create_operator(self, ctx, shapes, dtypes):
            return ProposalTarget(self._num_classes, self._batch_rois,
                                  self._fg_fraction, self._seed)


# -- data -------------------------------------------------------------------

def synthetic_images(n, height, width, num_classes, boxes=4, seed=0,
                     stages=VGG16, scales=SCALES):
    """n images (n, 3, H, W) of seeded noise with ``boxes`` brighter
    rectangles, their ground truth (n, boxes, 5) [x1, y1, x2, y2, class]
    and the RPN targets of each: a dict of the six inputs, stacked."""
    rng = np.random.RandomState(seed)
    fh, fw = feature_shape(stages, height, width)
    out = {k: [] for k in DATA_NAMES + LABEL_NAMES}
    lo, hi = max(8, min(height, width) // 8), max(16, min(height, width) // 2)
    for _ in range(n):
        img = rng.standard_normal((3, height, width)).astype(np.float32)
        gt = np.zeros((boxes, 5), np.float32)
        for b in range(boxes):
            bw, bh = rng.randint(lo, hi, 2)
            x1 = rng.randint(0, width - bw)
            y1 = rng.randint(0, height - bh)
            gt[b] = (x1, y1, x1 + bw - 1, y1 + bh - 1,
                     rng.randint(1, num_classes))
            img[:, y1:y1 + bh, x1:x1 + bw] += 1.5
        info = np.array([height, width, 1.0], np.float32)
        label, target, weight = assign_anchors((fh, fw), gt, info, rng,
                                               scales=scales)
        for k, v in (("data", img), ("im_info", info), ("gt_boxes", gt),
                     ("label", label[0]), ("bbox_target", target[0]),
                     ("bbox_weight", weight[0])):
            out[k].append(v)
    return {k: np.stack(v) for k, v in out.items()}


def init_params(shapes, seed=0):
    """He-normal convolutions, N(0, 0.01) fully connected layers (the
    box head's N(0, 0.001)), zero biases, drawn by name from ``seed``."""
    rng = np.random.RandomState(seed)
    out = {}
    for name in sorted(shapes):
        shape = shapes[name]
        if name.endswith("_bias"):
            out[name] = np.zeros(shape, np.float32)
        elif name.startswith(("conv", "rpn_")):
            out[name] = (rng.standard_normal(shape) * np.sqrt(
                2.0 / int(np.prod(shape[1:])))).astype(np.float32)
        else:
            std = 0.001 if name.startswith("bbox_pred") else 0.01
            out[name] = (rng.standard_normal(shape) * std).astype(np.float32)
    return out


def param_shapes(sym, height, width, num_gt=4, stages=VGG16, scales=SCALES):
    """{parameter: shape} of the training symbol at one image."""
    shapes = input_shapes(height, width, num_gt, stages, scales)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    return {n: tuple(s) for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def input_shapes(height, width, num_gt=4, stages=VGG16, scales=SCALES):
    """The six inputs' shapes at one image."""
    fh, fw = feature_shape(stages, height, width)
    a = len(scales) * len(RATIOS)
    return {"data": (1, 3, height, width), "im_info": (1, 3),
            "gt_boxes": (1, num_gt, 5), "label": (1, a * fh, fw),
            "bbox_target": (1, 4 * a, fh, fw),
            "bbox_weight": (1, 4 * a, fh, fw)}


def losses(outs, rpn_label):
    """The example's metrics from a step's outputs (numpy): the RPN's and
    the second stage's log loss and smooth-L1 sums."""
    rpn_prob, rpn_l1, cls_prob, bbox_l1, label = outs
    lab = rpn_label.reshape(-1).astype(np.int64)
    keep = lab >= 0
    p = rpn_prob.reshape(2, -1)[np.where(keep, lab, 0), np.arange(lab.size)]
    rpn_ce = float(-np.log(np.maximum(p[keep], 1e-14)).mean())
    lab2 = label.reshape(-1).astype(np.int64)
    p2 = cls_prob.reshape(-1, cls_prob.shape[-1])[np.arange(lab2.size), lab2]
    return {"rpn_log_loss": rpn_ce,
            "rpn_l1": float(rpn_l1.sum() / max(1, int(keep.sum()))),
            "rcnn_log_loss": float(-np.log(np.maximum(p2, 1e-14)).mean()),
            "rcnn_l1": float(bbox_l1.sum() / lab2.size)}
