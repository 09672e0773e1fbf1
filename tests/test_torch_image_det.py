"""mxnet_tpu_torch.image.detection against mxnet_tpu.image.detection, on
the CPU (``ctx=cpu()``), for one seed of ``random`` given to both
packages (the draws are the JAX package's, in its order):

- each detection augmenter (flip, random crop, random select, borrow)
  gives the same image (exact: crops and flips move pixels) and the same
  boxes (exact: the same float32 numpy arithmetic);
- ``CreateDetAugmenter``'s lists;
- ``ImageDetIter`` over a ``.rec`` of packed detection labels
  ([header_width, object_width, objects...]) with rand_crop and
  rand_mirror: batches within 1 unit (OpenCV's fixed-point bicubic resize
  against the port's float64 one), labels exact and padded with -1 to the
  largest object count, ``reshape``, the label checks, and
  ``draw_next``'s refusal, which names OpenCV as the JAX package's does.
"""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.image import detection as jdet
from mxnet_tpu_torch.image import detection as tdet
from mxnet_tpu_torch import recordio as trec

cv2 = pytest.importorskip("cv2")


def _boxes(rng, n):
    lo = rng.uniform(0, 0.6, (n, 2))
    hi = lo + rng.uniform(0.1, 0.4, (n, 2))
    cls = rng.randint(0, 5, (n, 1)).astype(np.float64)
    return np.concatenate([cls, lo[:, :1], lo[:, 1:], np.minimum(hi, 1)[:, :1],
                           np.minimum(hi, 1)[:, 1:]], 1).astype(np.float32)


AUGS = [
    ("flip", lambda m: m.DetHorizontalFlipAug(0.5)),
    ("crop", lambda m: m.DetRandomCropAug(min_crop_scale=0.3, p=0.8)),
    ("select", lambda m: m.DetRandomSelectAug(
        [m.DetHorizontalFlipAug(1.0), m.DetRandomCropAug(p=1.0)],
        skip_prob=0.3)),
    ("borrow", lambda m: m.DetBorrowAug(
        (jmx.image if m is jdet else tmx.image).CastAug())),
]


@pytest.mark.parametrize("case", AUGS, ids=[a[0] for a in AUGS])
def test_det_augmenter_matches_jax(case):
    _, make = case
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (40, 52, 3)).astype(np.uint8)
    for seed in range(6):
        label = _boxes(np.random.RandomState(seed), 3)
        random.seed(seed)
        a, la = make(jdet)(jmx.nd.array(img, dtype=np.uint8), label)
        after = random.random()
        random.seed(seed)
        b, lb = make(tdet)(tmx.nd.array(img, ctx=tmx.cpu(), dtype=np.uint8),
                           label)
        assert random.random() == after
        np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
        np.testing.assert_array_equal(lb, la)
    with pytest.raises(tmx.MXNetError, match="image Augmenter"):
        tdet.DetBorrowAug(lambda x: x)


def test_create_det_augmenter_lists_match_jax():
    for kw in (dict(), dict(resize=64, rand_crop=0.5, rand_mirror=True,
                            mean=True, std=True)):
        j = jdet.CreateDetAugmenter((3, 32, 32), **kw)
        t = tdet.CreateDetAugmenter((3, 32, 32), **kw)
        assert [type(a).__name__ for a in t] == [type(a).__name__ for a in j]
        assert [type(getattr(a, "augmenter", None)).__name__ for a in t] == \
            [type(getattr(a, "augmenter", None)).__name__ for a in j]


@pytest.fixture(scope="module")
def det_rec(tmp_path_factory):
    rng = np.random.RandomState(1)
    path = str(tmp_path_factory.mktemp("det") / "d.rec")
    w = trec.MXRecordIO(path, "w")
    for i in range(10):
        h, w_ = rng.randint(40, 60), rng.randint(40, 60)
        base = rng.randint(0, 255, (5, 5, 3)).astype(np.uint8)
        img = cv2.resize(base, (w_, h), interpolation=cv2.INTER_CUBIC)
        buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])[1]
        n = 1 + i % 4
        label = np.concatenate([[2, 5], _boxes(rng, n).ravel()])
        w.write(trec.pack(trec.IRHeader(0, label, i, 0), buf.tobytes()))
    w.close()
    return path


def _run(pkg, path, ctx_kw, seed, n=3):
    random.seed(seed)
    it = pkg.ImageDetIter(batch_size=4, data_shape=(3, 32, 32),
                          path_imgrec=path, rand_crop=0.7, rand_mirror=True,
                          **ctx_kw)
    out = []
    for _ in range(n):
        b = it.next()
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return it, out


def test_image_det_iter_matches_jax(det_rec):
    jit, want = _run(jdet, det_rec, {}, 3)
    tit, got = _run(tdet, det_rec, {"ctx": tmx.cpu()}, 3)
    assert tit.provide_label[0].shape == jit.provide_label[0].shape \
        == (4, 4, 5)
    assert [g[2] for g in got] == [w[2] for w in want] == [0, 0, 2]
    for (a, la, _), (b, lb, _) in zip(got, want):
        assert np.abs(a - b).max() <= 1.0
        np.testing.assert_array_equal(la, lb)
    # rows past an image's objects are -1
    assert (got[0][1][0, 1:] == -1).all()
    with pytest.raises(StopIteration):
        tit.next()
    tit.reshape(data_shape=(3, 24, 24), label_shape=(6, 5))
    tit.reset()
    b = tit.next()
    assert b.data[0].shape == (4, 3, 24, 24) and \
        b.label[0].shape == (4, 6, 5)
    with pytest.raises(tmx.MXNetError, match="OpenCV"):
        tit.draw_next()


def test_image_det_iter_label_checks():
    it = tdet.ImageDetIter.__new__(tdet.ImageDetIter)
    with pytest.raises(tmx.MXNetError, match="too short"):
        it._parse_label([2])
    with pytest.raises(tmx.MXNetError, match="header"):
        it._parse_label([1, 5, 0, 0, 0, 1, 1])
    with pytest.raises(tmx.MXNetError, match="multiple"):
        it._parse_label([2, 5, 0, 0, 0, 1])
    np.testing.assert_array_equal(
        it._parse_label([3, 5, 9, 1, .1, .2, .3, .4]),
        np.array([[1, .1, .2, .3, .4]], np.float32))
