"""SSD detection on the port against the JAX package, on the CPU.

1. Every detection op of ops/contrib.py (MultiBoxPrior, MultiBoxTarget,
   MultiBoxDetection, box_nms, box_iou, bipartite_matching) given the
   same seeded numpy inputs and attrs in both packages: masks, classes,
   kept rows and matched indices equal, floats within 1e-6 (relative,
   plus 1e-6 absolute). The inputs hold exact ties: duplicate ground-truth
   boxes, an image whose class scores are all equal, an image whose
   background probabilities are equal in float32 but not in float64
   (mining ranks them in float32, as the reference does), a label whose first
   row is class -1 (no ground truth), equal-score detection rows, a
   repeated box for box_nms; MultiBoxDetection at nms_topk -1 and 400.
   The ops' gradients (within 1e-6 of each one's largest element):
   box_nms, box_iou and MultiBoxDetection pass them through their gathers
   as the JAX ops do; MultiBoxTarget gives cls_pred none.
2. One Module training step of chip_smoke.py's SSD300-VGG16 at 1/16 of
   its widths, 300 x 300, batch 2, from the same parameters: the
   SoftmaxOutput probabilities, the box loss, the class targets and every
   parameter's gradient within 1e-4 of each tensor's largest magnitude
   (f32), the detections by their sorted scores and kept classes, and the
   SGD update. The JAX package's shape inference does not read a
   variable's declared shape, so its side is an executor bound with the
   L2Normalization scale's shape given.
3. examples/ssd_train.py on the port with only its import changed,
   exiting 0 (the JAX package's run of it is tests/test_ssd.py's).
"""
import contextlib
import io
import os
import random
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from test_torch_gluon_cifar import PORT_THREADS, _torch_threads  # noqa: E402

FLOAT_TOL = 1e-6
STEP_RTOL = 1e-4


def _run_both(name, ins, attrs, diff=(), seed=0):
    """Outputs (and, for ``diff``, the vjp of a seeded cotangent) of the
    op in both packages."""
    js, ts = jreg.get_op(name), treg.get_op(name)
    ja, ta = js.parse_attrs(attrs), ts.parse_attrs(attrs)
    xs = [jnp.asarray(x) for x in ins]

    def f(*d):
        args = list(xs)
        for i, v in zip(diff, d):
            args[i] = v
        return tuple(js.fcompute(ja, jreg.OpCtx(), *args))

    tx = [torch.tensor(x) for x in ins]
    leaves = [tx[i].requires_grad_(True) for i in diff]
    with torch.enable_grad():
        tout = ts.fcompute(ta, treg.OpCtx(), *tx)
    if not diff:
        return [np.asarray(o) for o in f()], \
            [o.detach().numpy() for o in tout], [], []
    jout, vjp = jax.vjp(f, *[xs[i] for i in diff])
    rng = np.random.RandomState(seed)
    cts = [rng.standard_normal(np.shape(o)).astype(np.float32)
           for o in jout]
    jg = vjp(tuple(jnp.asarray(c) for c in cts))
    pairs = [(o, torch.tensor(c)) for o, c in zip(tout, cts)
             if o.requires_grad]
    tg = torch.autograd.grad([o for o, _ in pairs], leaves,
                             [c for _, c in pairs], allow_unused=True)
    tg = [np.zeros_like(ins[i]) if g is None else g.numpy()
          for i, g in zip(diff, tg)]
    return [np.asarray(o) for o in jout], \
        [o.detach().numpy() for o in tout], [np.asarray(g) for g in jg], tg


def _floats(got, want, what):
    np.testing.assert_allclose(got, want, rtol=FLOAT_TOL, atol=FLOAT_TOL,
                               err_msg=what)


# -- inputs -------------------------------------------------------------------

def _feature(seed, h, w, c=4, n=2):
    return np.random.RandomState(seed).rand(n, c, h, w).astype(np.float32)


def _anchors(h, w, sizes=(0.2, 0.35), ratios=(1.0, 2.0, 0.5)):
    s = jreg.get_op("_contrib_MultiBoxPrior")
    return np.asarray(s.fcompute(s.parse_attrs(dict(sizes=sizes,
                                                    ratios=ratios)),
                                 jreg.OpCtx(),
                                 jnp.zeros((1, 1, h, w)))[0])


def _labels(seed, nb, nl, classes):
    """Padded labels: image 0 has two identical boxes (a tie in the
    bipartite pass), the last image none (its first row class -1)."""
    rng = np.random.RandomState(seed)
    lab = -np.ones((nb, nl, 5), np.float32)
    for b in range(nb - 1):
        for i in range(rng.randint(1, nl + 1)):
            x1, y1 = rng.uniform(0, 0.6, 2)
            lab[b, i] = (rng.randint(classes), x1, y1,
                         x1 + rng.uniform(0.1, 0.4),
                         y1 + rng.uniform(0.1, 0.4))
    lab[0, 1] = lab[0, 0]
    return lab


def _cls_pred(seed, nb, classes, na):
    """Class scores; image 1's all 0, so its background probabilities
    tie everywhere."""
    c = np.random.RandomState(seed).randn(nb, classes + 1, na) \
        .astype(np.float32)
    c[1] = 0.0
    return c


A_SMALL = _anchors(10, 12)                       # 360 anchors
A_LARGE = _anchors(20, 24)                       # 1440 anchors
LAB = _labels(3, 4, 5, 4)
CLS = _cls_pred(4, 4, 4, A_SMALL.shape[1])


def _near_tie_cls(cls):
    """Image 0's background probabilities all 0.5 in float32 but apart in
    float64: logits 0 for the background, j * 1e-11 for class 1 at anchor
    j, -30 for the rest. The reference ranks them in float32, so mining
    keeps them in the anchors' order."""
    c = cls.copy()
    c[0] = -30.0
    c[0, 0] = 0.0
    c[0, 1] = np.arange(c.shape[2], dtype=np.float32) * np.float32(1e-11)
    return c


CLS_NEAR = _near_tie_cls(CLS)


def _probs(seed, nb, classes, na, tie_rows=()):
    logits = np.random.RandomState(seed).randn(nb, classes + 1, na) * 2
    p = torch.softmax(torch.tensor(logits, dtype=torch.float32), 1).numpy()
    for b in tie_rows:
        p[b, :, 5:40] = p[b, :, 5:6]             # equal scores, 35 anchors
    return p


PROB_L = _probs(5, 3, 4, A_LARGE.shape[1], tie_rows=(0,))
LOC_L = (np.random.RandomState(6).randn(3, A_LARGE.shape[1] * 4) * 0.4) \
    .astype(np.float32)


def _rows(seed, shape):
    """box_nms rows [id, score, x1, y1, x2, y2]; a repeated row."""
    rng = np.random.RandomState(seed)
    lead, n = shape[:-1], shape[-1]
    ids = rng.randint(0, 3, lead + (n, 1)).astype(np.float32)
    score = rng.rand(*lead, n, 1).astype(np.float32)
    xy = rng.rand(*lead, n, 2).astype(np.float32) * 0.5
    wh = rng.rand(*lead, n, 2).astype(np.float32) * 0.5 + 0.05
    rows = np.concatenate([ids, score, xy, xy + wh], -1)
    rows[..., 3, :] = rows[..., 2, :]
    return rows


ROWS = _rows(7, (2, 3, 40))

CASES = [
    ("prior", "_contrib_MultiBoxPrior", [_feature(0, 10, 12)],
     dict(sizes=(0.2, 0.35), ratios=(1, 2, 0.5), clip=True), ()),
    ("prior_steps_offsets", "_contrib_MultiBoxPrior", [_feature(1, 7, 9)],
     dict(sizes=(0.3,), ratios=(1, 3, 1 / 3.), steps=(0.1, 0.12),
          offsets=(0.4, 0.6)), ()),
    ("target", "_contrib_MultiBoxTarget", [A_SMALL, LAB, CLS], {}, (2,)),
    ("target_mining", "_contrib_MultiBoxTarget", [A_SMALL, LAB, CLS],
     dict(negative_mining_ratio=3.0), (2,)),
    ("target_mining_min_neg", "_contrib_MultiBoxTarget", [A_SMALL, LAB, CLS],
     dict(negative_mining_ratio=2.0, minimum_negative_samples=40,
          overlap_threshold=0.3, negative_mining_thresh=0.4,
          variances=(0.1, 0.1, 0.2, 0.2), ignore_label=-2), (2,)),
    ("target_mining_float32_ties", "_contrib_MultiBoxTarget",
     [A_SMALL, LAB, CLS_NEAR], dict(negative_mining_ratio=3.0), ()),
    ("target_no_threshold", "_contrib_MultiBoxTarget", [A_SMALL, LAB, CLS],
     dict(overlap_threshold=0.0), ()),
    ("detection_all", "_contrib_MultiBoxDetection",
     [PROB_L, LOC_L, A_LARGE], dict(nms_topk=-1), (0, 1)),
    ("detection_top400", "_contrib_MultiBoxDetection",
     [PROB_L, LOC_L, A_LARGE], dict(nms_topk=400, nms_threshold=0.45),
     (0, 1)),
    ("detection_force_threshold", "_contrib_MultiBoxDetection",
     [PROB_L, LOC_L, A_LARGE],
     dict(nms_topk=50, force_suppress=True, threshold=0.3, clip=False), ()),
    ("detection_no_nms", "_contrib_MultiBoxDetection",
     [PROB_L, LOC_L, A_LARGE], dict(nms_threshold=1.5), ()),
    ("box_nms", "_contrib_box_nms", [ROWS], {}, (0,)),
    ("box_nms_topk_ids", "_contrib_box_nms", [ROWS],
     dict(topk=12, id_index=0, overlap_thresh=0.3), (0,)),
    ("box_nms_valid_force", "_contrib_box_nms", [ROWS],
     dict(valid_thresh=0.4, force_suppress=True), ()),
    ("box_nms_center_in", "_contrib_box_nms", [ROWS],
     dict(in_format="center", out_format="corner"), ()),
    ("box_nms_center_out", "_contrib_box_nms", [ROWS],
     dict(out_format="center", topk=30), ()),
    ("box_iou", "_contrib_box_iou", [ROWS[0, 0, :, 2:6], ROWS[1, :, :7, 2:6]],
     {}, (0, 1)),
    ("box_iou_center", "_contrib_box_iou",
     [ROWS[0, 0, :, 2:6], ROWS[1, :, :7, 2:6]], dict(format="center"), ()),
    ("bipartite", "_contrib_bipartite_matching",
     [np.random.RandomState(8).rand(3, 7, 5).astype(np.float32)],
     dict(threshold=0.2), ()),
    ("bipartite_ascend_topk", "_contrib_bipartite_matching",
     [np.random.RandomState(9).rand(2, 3, 6, 4).astype(np.float32)],
     dict(threshold=0.6, is_ascend=True, topk=2), ()),
]
# a tie in the bipartite scores
CASES[-2][2][0][0, 3, 1] = CASES[-2][2][0][0].max()
CASES[-2][2][0][0, 5, 2] = CASES[-2][2][0][0].max()


def _exact_outputs(name, attrs):
    """Output indices held exactly: masks, classes, kept ids, matches."""
    return {"_contrib_MultiBoxTarget": (1, 2),
            "_contrib_bipartite_matching": (0, 1)}.get(name, ())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_detection_op_against_jax(case):
    cid, name, ins, attrs, diff = case
    jo, to, jg, tg = _run_both(name, ins, attrs, diff, seed=len(cid))
    assert len(jo) == len(to)
    exact = _exact_outputs(name, attrs)
    for k, (a, b) in enumerate(zip(jo, to)):
        assert a.shape == b.shape, (cid, k, a.shape, b.shape)
        if k in exact:
            np.testing.assert_array_equal(b, a, err_msg="%s %d" % (cid, k))
        elif name in ("_contrib_MultiBoxDetection", "_contrib_box_nms"):
            # ids / kept rows exactly (-1 marks a dropped row), then floats
            idc = 0
            np.testing.assert_array_equal(b[..., idc], a[..., idc],
                                          err_msg=cid)
            _floats(b, a, cid)
        else:
            _floats(b, a, "%s %d" % (cid, k))
    if name == "_contrib_MultiBoxTarget":
        assert (to[2] == attrs.get("ignore_label", -1.0))[-1].all()
        assert not to[1][-1].any() and not to[0][-1].any()
        if attrs.get("negative_mining_ratio", -1) > 0:
            assert (to[2] == 0).any() and (to[2] > 0).any()
    if name == "_contrib_MultiBoxDetection" and attrs.get("nms_topk") == 400:
        kept = (to[0][..., 0] >= 0).sum(axis=1)
        valid = (to[0][..., 1] >= 0.01).sum(axis=1)
        assert (kept <= 400).all() and (valid > 400).all()
    for k, (a, b) in enumerate(zip(jg, tg)):
        # a gradient sums many terms: within 1e-6 of its largest element
        np.testing.assert_allclose(
            b, a, rtol=0, atol=FLOAT_TOL * (1 + float(np.abs(a).max())),
            err_msg="%s gradient %d" % (cid, diff[k]))


def test_multibox_detection_refuses_another_background_id():
    s = treg.get_op("_contrib_MultiBoxDetection")
    with pytest.raises(MXNetError, match="background_id"):
        s.fcompute(s.parse_attrs(dict(background_id=1)), treg.OpCtx(),
                   torch.tensor(PROB_L), torch.tensor(LOC_L),
                   torch.tensor(A_LARGE))


def test_greedy_nms_row_loop_equals_the_table(monkeypatch):
    """Past _NMS_MATRIX_ELEMS the suppressions are computed a reference
    row at a time: the same kept rows."""
    from mxnet_tpu_torch.ops import contrib
    args = (torch.tensor(PROB_L), torch.tensor(LOC_L),
            torch.tensor(A_LARGE))
    s = treg.get_op("_contrib_MultiBoxDetection")
    attrs = s.parse_attrs(dict(nms_topk=-1))
    want = s.fcompute(attrs, treg.OpCtx(), *args)[0]
    monkeypatch.setattr(contrib, "_NMS_MATRIX_ELEMS", 0)
    got = s.fcompute(attrs, treg.OpCtx(), *args)[0]
    assert torch.equal(got, want)


# -- the SSD300 training step -------------------------------------------------

WIDTH_DIV = 16
BATCH = 2


def _params(shapes, seed=10):
    """He-normal weights, small biases, the L2Normalization scale 20."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name in ("data", "label"):
            continue
        if name == "relu4_3_scale":
            out[name] = np.full(shape, 20.0, np.float32)
        elif name.endswith("_weight"):
            fan_in = int(np.prod(shape[1:]))
            out[name] = (rng.standard_normal(shape)
                         * np.sqrt(2.0 / fan_in)).astype(np.float32)
        else:
            out[name] = (rng.standard_normal(shape) * 0.01) \
                .astype(np.float32)
    return out


def _sorted_detections(det):
    """Each image's valid rows ordered by (score, class, box): a row
    order that near-equal scores cannot reshuffle."""
    out = []
    for img in det:
        rows = img[img[:, 1] >= 0]
        out.append(rows[np.lexsort(rows.T[::-1][:, ::-1].T[::-1])]
                   if len(rows) else rows)
    return out


def test_ssd300_module_step_against_jax():
    with _torch_threads(PORT_THREADS):
        _ssd300_module_step_against_jax()


def _ssd300_module_step_against_jax():
    x, y = chip_smoke.synthetic_detection(BATCH, seed=0)
    with tmx.NameManager():
        tsym = chip_smoke.ssd300_vgg16_symbol(tmx.sym, width_div=WIDTH_DIV)
    with jmx.NameManager():
        jsym = chip_smoke.ssd300_vgg16_symbol(jmx.sym, width_div=WIDTH_DIV)
    assert tsym.list_arguments() == jsym.list_arguments()
    arg_shapes, out_shapes, _ = tsym.infer_shape(data=x.shape, label=y.shape)
    assert out_shapes[0] == (BATCH, 21, 8732)
    shapes = dict(zip(tsym.list_arguments(), arg_shapes))
    params = _params(shapes)
    lr, mom, wd = 0.004, 0.9, 5e-4

    with tmx.cpu():
        mod = tmx.mod.Module(tsym, data_names=("data",),
                             label_names=("label",), context=tmx.cpu())
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("label", y.shape)])
        mod.init_params(arg_params={k: tmx.nd.array(v)
                                    for k, v in params.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": lr, "momentum": mom, "wd": wd})
        batch = tmx.io.DataBatch(data=[tmx.nd.array(x)],
                                 label=[tmx.nd.array(y)])
        mod.forward(batch, is_train=True)
        mod.backward()
        touts = [o.asnumpy() for o in mod.get_outputs()]
        tgrads = {k: v.asnumpy() for k, v in mod._exec.grad_dict.items()
                  if k in params}
        mod.update()
        tnew = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    ex = jsym.simple_bind(jmx.cpu(), data=x.shape, label=y.shape,
                          relu4_3_scale=shapes["relu4_3_scale"])
    for k, v in params.items():
        ex.arg_dict[k][:] = v
    ex.arg_dict["data"][:] = x
    ex.arg_dict["label"][:] = y
    ex.forward(is_train=True)
    ex.backward()
    jouts = [o.asnumpy() for o in ex.outputs]
    jgrads = {k: ex.grad_dict[k].asnumpy() for k in params}
    # Module's default rescale_grad: 1 / batch size
    opt = jmx.optimizer.create("sgd", learning_rate=lr, momentum=mom, wd=wd,
                               rescale_grad=1.0 / BATCH, sym=jsym,
                               param_idx2name=dict(enumerate(params)))
    upd = jmx.optimizer.get_updater(opt)
    for i, k in enumerate(params):
        upd(i, ex.grad_dict[k], ex.arg_dict[k])
    jnew = {k: ex.arg_dict[k].asnumpy() for k in params}

    def close(got, want, what):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=STEP_RTOL * max(scale, 1e-12),
                                   err_msg=what)

    close(touts[0], jouts[0], "cls_prob")
    close(touts[1], jouts[1], "loc_loss")
    np.testing.assert_array_equal(touts[2], jouts[2])
    assert (touts[2] > 0).sum() >= BATCH and (touts[2] == 0).sum() > 0
    for t, j in zip(_sorted_detections(touts[3]),
                    _sorted_detections(jouts[3])):
        assert t.shape == j.shape
        np.testing.assert_allclose(t[:, 1], j[:, 1], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(np.sort(t[:, 0]), np.sort(j[:, 0]))
    for k in params:
        close(tgrads[k], jgrads[k], "gradient of " + k)
        close(tnew[k], jnew[k], "updated " + k)
    assert np.abs(tgrads["relu4_3_scale"]).max() > 0


# -- the example ---------------------------------------------------------------

@pytest.fixture
def _keep_global_rng():
    np_state, py_state = np.random.get_state(), random.getstate()
    t_state = tmx.random.get_state()
    yield
    np.random.set_state(np_state)
    random.setstate(py_state)
    tmx.random.set_state(t_state)


def test_ssd_example_runs_on_the_port(_keep_global_rng):
    """examples/ssd_train.py with ``mxnet_tpu`` replaced by
    ``mxnet_tpu_torch`` in its import, nothing else changed, --ctx cpu;
    its arrays without a context follow the caller's ``with cpu()``
    scope (the port's default context is the card). Torch at 2 intra-op
    threads, as tests/test_torch_gluon_cifar.py runs its example."""
    path = os.path.join(ROOT, "examples", "ssd_train.py")
    src = open(path).read().replace("import mxnet_tpu as mx",
                                    "import mxnet_tpu_torch as mx")
    argv, sys.argv = sys.argv, [path, "--ctx", "cpu"]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf), tmx.cpu(), \
                _torch_threads(PORT_THREADS):
            exec(compile(src, path, "exec"), {"__name__": "__main__",
                                              "__file__": path})
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = argv
    assert code == 0, buf.getvalue()
    assert "detections after 40 steps" in buf.getvalue()


# -- the card's float64 forward route for long convolutions -------------------

@pytest.mark.parametrize("shape,kernel,stride,pad,dilate,budget", [
    ((3, 260, 9, 11), (3, 3), (1, 1), (1, 1), (1, 1), 1 << 30),
    ((5, 300, 11, 13), (3, 3), (2, 2), (1, 0), (1, 1), 300 * 9 * 200 * 8),
    ((2, 240, 40, 36), (3, 3), (1, 1), (6, 6), (6, 6), 240 * 9 * 1440 * 8),
    ((4, 64, 33, 35), (5, 3), (2, 1), (0, 2), (2, 1), 1 << 20)],
    ids=["one_chunk", "strided_chunked", "dilated_chunked", "odd_window"])
def test_conv_forward_gemm_route_is_float64_exact(shape, kernel, stride, pad,
                                                  dilate, budget,
                                                  monkeypatch):
    """ops.nn._conv_fwd_gemm (the card's forward of float32 convolutions
    with K >= 2048 and maps of 19^2 and more) against float64 conv2d, on the CPU: the whole batch
    in one chunk and in several, strides, padding and dilation; within 2
    float32 ulps of the output's largest magnitude. The route itself is
    for the card."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import nn as ops_nn
    monkeypatch.setattr(ops_nn, "_FWD_GEMM_COLS_BYTES", budget)
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.rand(shape, generator=g)
    w = torch.randn((7, shape[1]) + kernel, generator=g)
    b = torch.randn(7, generator=g)
    y = ops_nn._conv_fwd_gemm(x, w, b, stride, pad, dilate)
    ref = F.conv2d(x.double(), w.double(), b.double(), stride, pad, dilate)
    assert y.dtype == torch.float32 and y.shape == ref.shape
    assert float((y.double() - ref).abs().max()) \
        <= 2 * 2.0 ** -23 * float(ref.abs().max())
    assert ops_nn._fwd_route(x, w, 1, stride, pad, dilate) == "cudnn"


def _routed_convolutions(sym, **shapes):
    """The names of a Symbol's convolutions whose shapes take the card's
    float64 forward (ops.nn._fwd_gemm_shape), and how many it has."""
    import ast
    import json
    from mxnet_tpu_torch.ops import nn as ops_nn
    graph = json.loads(sym.tojson())
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape(**shapes)
    by_name = dict(zip(internals.list_outputs(), outs))

    def shape_of(ref):
        src = graph["nodes"][ref[0]]
        return by_name[src["name"] if src["op"] == "null"
                       else src["name"] + "_output"]

    def tup(attrs, key, default):
        return tuple(ast.literal_eval(attrs[key])) if key in attrs \
            else default

    convs = [n for n in graph["nodes"] if n["op"] == "Convolution"]
    return len(convs), [
        n["name"] for n in convs if ops_nn._fwd_gemm_shape(
            shape_of(n["inputs"][0]), shape_of(n["inputs"][1]),
            int(n["attrs"].get("num_group", 1)),
            tup(n["attrs"], "stride", (1, 1)), tup(n["attrs"], "pad", (0, 0)),
            tup(n["attrs"], "dilate", (1, 1)))]


def test_float64_forward_route_takes_ssd300s_trunk_and_no_resnet50_conv():
    """The route's shape rule at full width: SSD300-VGG16 at 300^2 sends
    its 3 x 3 convolutions of K >= 2048 with maps of 19^2 and more
    (conv3_2 to fc6 and the first two heads) to the float64 GEMM, and
    ResNet-50 v1 at 224^2 (the module, Gluon, data-parallel and predict
    phases' network) none: its long convolutions are at 14^2 and 7^2."""
    with tmx.NameManager():
        ssd = chip_smoke.ssd300_vgg16_symbol(tmx.sym)
    with tmx.NameManager():
        r50 = chip_smoke.resnet_v1_symbol(tmx.sym)
    assert _routed_convolutions(ssd, data=(2, 3, 300, 300),
                                label=(2, 8, 5)) == (35, [
        "conv3_2", "conv3_3", "conv4_1", "conv4_2", "conv4_3",
        "src0_cls_pred_conv", "conv5_1", "conv5_2", "conv5_3", "fc6",
        "src1_cls_pred_conv", "src0_loc_pred_conv", "src1_loc_pred_conv"])
    assert _routed_convolutions(r50, data=(2, 3, 224, 224)) == (53, [])
