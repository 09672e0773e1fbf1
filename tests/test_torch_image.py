"""mxnet_tpu_torch.image against mxnet_tpu.image, on the CPU (every
entry point with ``ctx=cpu()``: the host codec, OpenCV here, and the
plain versions of the card's code).

- ``imdecode`` / ``imread`` equal the JAX package's decode bit for bit
  (both are OpenCV's).
- Each of the 13 augmenter classes, for one seed of ``random`` and
  ``np.random`` given to both packages: the same draws, so the same
  crops, flips and jitters. Tolerances: exact for crops, flips, casts
  and the gray pick; 1 unit for an 8-bit resize (OpenCV sums in fixed
  point, the port in float64); 1e-5 relative for float32 jitters
  (sums in another order).
- ``CreateAugmenter``'s lists (classes and ``dumps``).
- ``ImageIter`` over a ``.rec`` (with its ``.idx``, shuffled) and over an
  imglist, batches within 1 unit (the resize) and labels exact.
- ``ImageRecordIter`` on both routes against the JAX factory's. The
  card route at ``ctx=cpu()`` (nvJPEG's place taken by OpenCV, the
  assembly kernel's by its plain version) equals the JAX package's
  native C++ pipeline bit for bit, uint8 and float32, with resize,
  shuffle and parts; a control whose crops are shifted by one pixel
  must differ. The Python route (an augmentation outside the native
  set) within 1e-5 relative.
- ``PrefetchingIter`` (two iterators, renamed) against the JAX one.
- The ``_image_to_tensor`` / ``_image_normalize`` ops and ``mx.nd.image``
  within 1e-6.
- ``RecordFileDataset``, ``ImageRecordDataset`` and ``ImageFolderDataset``.
- The committed JPEG fixture (tests/data/jpeg_fixture.npz, read by the
  card test and chip_smoke.py's image_codec phase, which have no JAX) is
  the JAX package's today: :func:`make_fixture` made it, and its pixels
  are what the JAX package's ``unpack_img`` decodes from its records.
  Rebuild it with ``python -c "from tests.test_torch_image import
  write_fixture; write_fixture()"`` from the repository's root.

Every JPEG is made here from a numpy seed, at most a few dozen of 32-72
pixels a side.
"""
import contextlib
import os
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import recordio as jrec
from mxnet_tpu.image import image as jimg
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.image import image as timg

cv2 = pytest.importorskip("cv2")

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "data", "jpeg_fixture.npz")
RTOL = 1e-5


def fixture_images(seed=0):
    """Four BGR images: smooth colour waves, a flat block, mild noise;
    entries 0 and 1 share their shape (one is the other's control)."""
    rng = np.random.RandomState(seed)
    out = []
    for h, w in ((48, 64), (48, 64), (56, 40), (33, 70)):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        img = np.zeros((h, w, 3))
        for c in range(3):
            a, b, p = rng.uniform(-1, 1, 3)
            img[:, :, c] = 128 + 60 * np.sin(a * xx / 9 + b * yy / 7 + 6 * p)
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        img[y0:y0 + h // 3, x0:x0 + w // 3] = rng.randint(0, 255, 3)
        img += rng.normal(0, 4, img.shape)
        out.append(np.clip(np.rint(img), 0, 255).astype(np.uint8))
    return out


def make_fixture():
    """The fixture's arrays: the JAX package's ``pack_img`` records
    (quality 90) of :func:`fixture_images`, and its ``unpack_img``
    decode of each (BGR)."""
    recs, pix = [], []
    for i, img in enumerate(fixture_images()):
        recs.append(jrec.pack_img(jrec.IRHeader(0, float(i), i, 0), img,
                                  quality=90))
        pix.append(jrec.unpack_img(recs[-1])[1])
    return {"records": np.frombuffer(b"".join(recs), np.uint8),
            "record_ends": np.cumsum([len(r) for r in recs]),
            "pixels": np.concatenate([p.reshape(-1) for p in pix]),
            "shapes": np.array([p.shape for p in pix])}


def write_fixture(path=FIXTURE):
    np.savez_compressed(path, **make_fixture())


def load_fixture(path=FIXTURE):
    """[(record bytes, decoded BGR pixels)] of the fixture."""
    from mxnet_tpu_torch.test_utils import jpeg_fixture
    return jpeg_fixture(path)


def test_jpeg_fixture_matches_the_jax_package():
    entries = load_fixture()
    assert os.path.getsize(FIXTURE) <= 100_000
    assert len(entries) == 4
    for i, (rec, pix) in enumerate(entries):
        header, img = jrec.unpack_img(rec)
        assert header.label == float(i) and header.id == i
        np.testing.assert_array_equal(img, pix)
        # the port reads the same record the same way on the host
        _, mine = trec.unpack_img(rec, ctx=tmx.cpu())
        np.testing.assert_array_equal(mine, pix)
    # the same arrays come out of the generator today (bit for bit: the
    # encoder is this machine's OpenCV, as when the file was written)
    made = make_fixture()
    np.testing.assert_array_equal(made["pixels"], np.load(FIXTURE)["pixels"])


def _jpegs(n=6, seed=1, quality=90, sizes=None):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = sizes[i] if sizes else (rng.randint(36, 64),
                                        rng.randint(36, 64))
        base = rng.randint(0, 255, (5, 5, 3)).astype(np.uint8)
        img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
        out.append(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY,
                                              quality])[1].tobytes())
    return out


@pytest.mark.parametrize("flag,to_rgb", [(1, True), (1, False), (0, True)])
def test_imdecode_cpu_matches_jax(flag, to_rgb, tmp_path):
    for buf in _jpegs(3):
        want = jimg.imdecode(buf, flag=flag, to_rgb=to_rgb).asnumpy()
        got = timg.imdecode(buf, flag=flag, to_rgb=to_rgb, ctx=tmx.cpu())
        assert got.context == tmx.cpu()
        np.testing.assert_array_equal(got.asnumpy(), want)
    path = tmp_path / "a.jpg"
    path.write_bytes(buf)
    np.testing.assert_array_equal(
        timg.imread(str(path), flag, to_rgb, ctx=tmx.cpu()).asnumpy(),
        jimg.imread(str(path), flag, to_rgb).asnumpy())


def _seeded(seed):
    random.seed(seed)
    np.random.seed(seed)


# (name, the two packages' augmenter, input dtype, tolerance kind)
AUGS = [
    ("Augmenter", lambda m: m.Augmenter(a=1), "uint8", "dumps"),
    ("ResizeAug", lambda m: m.ResizeAug(40, 2), "uint8", "unit"),
    ("ForceResizeAug", lambda m: m.ForceResizeAug((30, 20), 1), "uint8",
     "unit"),
    ("RandomCropAug", lambda m: m.RandomCropAug((24, 20), 2), "uint8",
     "exact"),
    ("CenterCropAug", lambda m: m.CenterCropAug((24, 20), 2), "uint8",
     "exact"),
    ("HorizontalFlipAug", lambda m: m.HorizontalFlipAug(0.5), "uint8",
     "exact"),
    ("CastAug", lambda m: m.CastAug(), "uint8", "exact"),
    ("ColorNormalizeAug", lambda m: m.ColorNormalizeAug(
        [123.68, 116.28, 103.53], [58.395, 57.12, 57.375]), "float32",
     "float"),
    ("BrightnessJitterAug", lambda m: m.BrightnessJitterAug(0.4), "float32",
     "float"),
    ("ContrastJitterAug", lambda m: m.ContrastJitterAug(0.4), "float32",
     "float"),
    ("SaturationJitterAug", lambda m: m.SaturationJitterAug(0.4), "float32",
     "float"),
    ("LightingAug", lambda m: m.LightingAug(
        0.1, np.array([55.46, 4.794, 1.148]),
        np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]])), "float32", "float"),
    ("RandomGrayAug", lambda m: m.RandomGrayAug(0.5), "float32", "float"),
]


@pytest.mark.parametrize("case", AUGS, ids=[a[0] for a in AUGS])
def test_augmenter_matches_jax(case):
    name, make, dtype, kind = case
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (36, 44, 3)).astype(dtype)
    jaug, taug = make(jimg), make(timg)
    assert type(taug).__name__ == name
    if kind == "dumps":
        assert taug.dumps() == jaug.dumps()
        with pytest.raises(NotImplementedError):
            taug(tmx.nd.array(img, ctx=tmx.cpu()))
        return
    for seed in range(4):      # both branches of the p=0.5 draws
        _seeded(seed)
        want = jaug(jmx.nd.array(img, dtype=dtype)).asnumpy()
        after_jax = (random.random(), np.random.rand())
        _seeded(seed)
        got = taug(tmx.nd.array(img, ctx=tmx.cpu(), dtype=dtype))
        # the same draws were taken: both generators end in one state
        assert (random.random(), np.random.rand()) == after_jax
        assert got.context == tmx.cpu()
        got = got.asnumpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if kind == "exact":
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif kind == "unit":
            assert np.abs(got.astype(int) - want).max() <= 1, name
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4,
                                       err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(), dict(resize=40, rand_crop=True, rand_mirror=True),
    dict(mean=True, std=True, brightness=0.1, contrast=0.2, saturation=0.3,
         pca_noise=0.1, rand_gray=0.2),
    dict(mean=np.array([1.0, 2.0, 3.0]), inter_method=1)])
def test_create_augmenter_lists_match_jax(kw):
    j = jimg.CreateAugmenter((3, 24, 20), **kw)
    t = timg.CreateAugmenter((3, 24, 20), **kw)
    assert [type(a).__name__ for a in t] == [type(a).__name__ for a in j]
    for a, b in zip(t, j):
        if not isinstance(a, timg.ColorNormalizeAug):
            assert a.dumps() == b.dumps()
        else:
            np.testing.assert_array_equal(a.mean, b.mean)


def _write_rec(path, bufs, labels, idx=True):
    """The same .rec (and .idx) through both packages' writers."""
    w = (trec.MXIndexedRecordIO(str(path) + ".idx", str(path), "w") if idx
         else trec.MXRecordIO(str(path), "w"))
    for i, (b, l_) in enumerate(zip(bufs, labels)):
        s = trec.pack(trec.IRHeader(0, l_, i, 0), b)
        if idx:
            w.write_idx(i, s)
        else:
            w.write(s)
    w.close()
    return str(path)


def _batches(it, n):
    out = []
    for _ in range(n):
        b = it.next()
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


def test_image_iter_over_a_rec_matches_jax(tmp_path):
    bufs = _jpegs(10, seed=4)
    rec = _write_rec(tmp_path / "a.rec", bufs, [float(i % 3) for i in
                                                  range(10)])
    kw = dict(batch_size=4, data_shape=(3, 24, 24), path_imgrec=rec,
              path_imgidx=rec + ".idx", shuffle=True, resize=30,
              rand_crop=True, rand_mirror=True)
    _seeded(5)
    want = _batches(jimg.ImageIter(**kw), 3)
    _seeded(5)
    got = _batches(timg.ImageIter(ctx=tmx.cpu(), **kw), 3)
    for (a, la, pa), (b, lb, pb) in zip(got, want):
        assert a.shape == b.shape and pa == pb
        assert np.abs(a - b).max() <= 1.0       # the 8-bit resize
        np.testing.assert_array_equal(la, lb)


def test_image_iter_over_an_imglist_matches_jax(tmp_path):
    bufs = _jpegs(5, seed=6)
    lines = []
    for i, b in enumerate(bufs):
        (tmp_path / f"{i}.jpg").write_bytes(b)
        lines.append(f"{i}\t{i % 2}\t{i * 0.5}\t{i}.jpg")
    lst = tmp_path / "list.lst"
    lst.write_text("\n".join(lines) + "\n")
    kw = dict(batch_size=2, data_shape=(3, 32, 32), label_width=2,
              path_imglist=str(lst), path_root=str(tmp_path))
    want = _batches(jimg.ImageIter(**kw), 3)
    got = _batches(timg.ImageIter(ctx=tmx.cpu(), **kw), 3)
    assert [g[2] for g in got] == [0, 0, 1]
    for (a, la, _), (b, lb, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    # an imglist given as a list
    lst_kw = dict(batch_size=2, data_shape=(3, 32, 32),
                  imglist=[[1.0, f"{i}.jpg"] for i in range(3)],
                  path_root=str(tmp_path))
    a = timg.ImageIter(ctx=tmx.cpu(), **lst_kw).next()
    b = jimg.ImageIter(**lst_kw).next()
    np.testing.assert_array_equal(a.data[0].asnumpy(), b.data[0].asnumpy())


NATIVE = [
    dict(rand_crop=True, rand_mirror=True, output_dtype="uint8"),
    dict(resize=48, rand_crop=True, rand_mirror=True, mean=True, std=True),
    dict(resize=45, shuffle=True, rand_mirror=True, output_dtype="uint8",
         seed=7),
    dict(num_parts=2, part_index=1, rand_crop=True, shuffle=True,
         mean=np.array([1.0, 2.0, 3.0]), std=2.0, seed=2)]


@pytest.fixture(scope="module")
def native_rec(tmp_path_factory):
    bufs = _jpegs(21, seed=8)
    path = tmp_path_factory.mktemp("native") / "n.rec"
    return _write_rec(path, bufs, [float(i % 7) for i in range(21)],
                      idx=False)


@pytest.mark.parametrize("kw", NATIVE, ids=["u8", "f32_resize", "shuffle",
                                            "parts"])
def test_image_record_iter_card_route_matches_jax_native(kw, native_rec,
                                                         monkeypatch):
    from mxnet_tpu.image.io import ImageRecordIter as JIter
    from mxnet_tpu_torch.image import assemble as asm
    from mxnet_tpu_torch.image.io import ImageRecordIter as TIter
    args = dict(path_imgrec=native_rec, data_shape=(3, 32, 32), batch_size=8,
                **kw)
    j, t = JIter(**args), TIter(ctx=tmx.cpu(), **args)
    assert type(j).__name__ == type(t).__name__ == "_NativeImageRecordIter"
    nb = -(-len(t._indices) // 8)
    for _ in range(2):                          # two epochs
        for _ in range(nb):
            a, b = j.next(), t.next()
            np.testing.assert_array_equal(b.data[0].asnumpy(),
                                          a.data[0].asnumpy())
            np.testing.assert_array_equal(b.label[0].asnumpy(),
                                          a.label[0].asnumpy())
            assert a.pad == b.pad
        with pytest.raises(StopIteration):
            t.next()
        j.reset()
        t.reset()
    want = j.next().data[0].asnumpy()
    t.close()
    j.close()
    # the control: every crop one pixel to the right must not pass
    real = asm.plan_record

    def shifted(*a, **k):
        p = real(*a, **k)
        p.x0 = p.x0 + 1 if p.x0 + 32 < p.rw else p.x0 - 1
        return p
    monkeypatch.setattr(asm, "plan_record", shifted)
    ctl = TIter(ctx=tmx.cpu(), **args)
    ctl.reset()
    ctl.reset()
    got = ctl.next().data[0].asnumpy()
    ctl.close()
    assert not np.array_equal(got, want)


def test_image_record_iter_python_route_matches_jax(native_rec,
                                                    monkeypatch):
    from mxnet_tpu.image.io import ImageRecordIter as JIter
    from mxnet_tpu_torch.image.io import ImageRecordIter as TIter
    args = dict(path_imgrec=native_rec, data_shape=(3, 32, 32), batch_size=8,
                rand_crop=True, rand_mirror=True, brightness=0.3,
                preprocess_threads=1, prefetch_buffer=0)
    _seeded(11)
    j = JIter(**args)
    want = _batches(j, 3)
    _seeded(11)
    t = TIter(ctx=tmx.cpu(), **args)
    assert type(t).__name__ == type(j).__name__ == "_RawImageRecordIter"
    got = _batches(t, 3)
    for (a, la, pa), (b, lb, pb) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-3)
        np.testing.assert_array_equal(la, lb)
        assert pa == pb
    # with prefetch_buffer the Python route is wrapped in PrefetchingIter
    it = TIter(ctx=tmx.cpu(), **dict(args, prefetch_buffer=2))
    assert isinstance(it, tmx.io.PrefetchingIter)
    assert it.next().data[0].shape == (8, 3, 32, 32)
    # the JAX package's knob sends even native augmentations this way
    native = dict(path_imgrec=native_rec, data_shape=(3, 32, 32),
                  batch_size=8, rand_crop=True, prefetch_buffer=0)
    assert type(TIter(ctx=tmx.cpu(), **native)).__name__ == \
        "_NativeImageRecordIter"
    monkeypatch.setenv("MXNET_TPU_DISABLE_NATIVE_ITER", "1")
    assert type(TIter(ctx=tmx.cpu(), **native)).__name__ == \
        "_RawImageRecordIter"


def test_prefetching_iter_matches_jax():
    rng = np.random.RandomState(0)
    x1, x2 = rng.rand(10, 3).astype(np.float32), rng.rand(10, 2)
    y = rng.randint(0, 3, 10).astype(np.float32)
    got = {}
    for n, mx in (("jax", jmx), ("torch", tmx)):
        with (tmx.cpu() if mx is tmx else contextlib.nullcontext()):
            it = mx.io.PrefetchingIter(
                [mx.io.NDArrayIter(x1, y, 4, last_batch_handle="pad"),
                 mx.io.NDArrayIter(x2.astype(np.float32), y, 4,
                                   last_batch_handle="pad",
                                   data_name="d2", label_name="l2")],
                rename_data=[{"data": "a"}, {"d2": "b"}],
                rename_label=[{"softmax_label": "la"}, {"l2": "lb"}])
            assert [d.name for d in it.provide_data] == ["a", "b"]
            assert [d.name for d in it.provide_label] == ["la", "lb"]
            rounds = []
            for _ in range(2):
                rounds.append([([d.asnumpy() for d in b.data],
                                [l_.asnumpy() for l_ in b.label], b.pad)
                               for b in it])
                it.reset()
            got[n] = rounds
    for ours, ref in zip(got["torch"], got["jax"]):
        assert len(ours) == len(ref) == 3
        for (d1, l1, p1), (d2, l2, p2) in zip(ours, ref):
            assert p1 == p2
            for a, b in zip(d1 + l1, d2 + l2):
                np.testing.assert_allclose(a, b, rtol=0, atol=0)


def test_prefetching_iter_raises_what_its_iterator_raises():
    class Bad(tmx.io.DataIter):
        provide_data = [tmx.io.DataDesc("data", (2, 3))]
        provide_label = []

        def next(self):
            raise ValueError("broken source")
    it = tmx.io.PrefetchingIter(Bad(2))
    with pytest.raises(ValueError, match="broken source"):
        it.next()


def test_image_ops_and_nd_image_match_jax():
    rng = np.random.RandomState(0)
    for shape in ((5, 6, 3), (2, 5, 6, 3)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        j = jmx.nd.image.to_tensor(jmx.nd.array(img, dtype=np.uint8))
        t = tmx.nd.image.to_tensor(tmx.nd.array(img, ctx=tmx.cpu(),
                                                dtype=np.uint8))
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6)
        kw = dict(mean=(0.4, 0.5, 0.6), std=(0.2, 0.25, 0.3))
        jn = jmx.nd.image.normalize(j, **kw)
        tn = tmx.nd.image.normalize(t, **kw)
        np.testing.assert_allclose(tn.asnumpy(), jn.asnumpy(), rtol=1e-6,
                                   atol=1e-6)
        for name in ("_image_to_tensor", "image_to_tensor",
                     "_image_normalize", "image_normalize"):
            assert name in tmx.ops.registry._REGISTRY
    # the Symbol path runs the same op
    data = tmx.sym.Variable("data")
    s = tmx.sym._image_normalize(tmx.sym._image_to_tensor(data),
                                 mean=(0.5,), std=(0.25,))
    ex = s.simple_bind(ctx=tmx.cpu(), data=(5, 6, 3))
    out = ex.forward(data=tmx.nd.array(img[0], ctx=tmx.cpu()))[0]
    ref = (img[0].transpose(2, 0, 1) / 255.0 - 0.5) / 0.25
    np.testing.assert_allclose(out.asnumpy(), ref, rtol=1e-5, atol=1e-6)


def test_gluon_record_datasets_match_jax(tmp_path):
    from mxnet_tpu.gluon import data as jdata
    from mxnet_tpu_torch.gluon import data as tdata
    bufs = _jpegs(4, seed=9)
    rec = _write_rec(tmp_path / "d.rec", bufs, [1.0, 2.0, 3.0, 4.0])
    jr, tr = jdata.RecordFileDataset(rec), tdata.RecordFileDataset(rec)
    assert len(tr) == len(jr) == 4
    assert all(tr[i] == jr[i] for i in range(4))
    ji = jdata.vision.ImageRecordDataset(rec)
    ti = tdata.vision.ImageRecordDataset(rec, ctx=tmx.cpu())
    for i in range(4):
        (a, la), (b, lb) = ti[i], ji[i]
        assert a.context == tmx.cpu() and la == lb
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    for c, name in enumerate(("cat", "dog")):
        (tmp_path / name).mkdir()
        for i in range(2):
            (tmp_path / name / f"{i}.jpg").write_bytes(bufs[2 * c + i])
    (tmp_path / "dog" / "notes.txt").write_text("not an image")
    jf = jdata.vision.ImageFolderDataset(str(tmp_path))
    tf = tdata.vision.ImageFolderDataset(str(tmp_path), ctx=tmx.cpu(),
                                         transform=lambda x, y: (x, y + 10))
    assert tf.synsets == jf.synsets == ["cat", "dog"] and len(tf) == 4
    for i in range(4):
        (a, la), (b, lb) = tf[i], jf[i]
        assert la == lb + 10
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_image_entry_points_default_to_the_card(native_rec):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from mxnet_tpu_torch.image import codec
    buf = _jpegs(1)[0]
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        timg.imdecode(buf)
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        tmx.image.ImageRecordIter(path_imgrec=native_rec,
                                  data_shape=(3, 32, 32), batch_size=4)
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        trec.pack_img(trec.IRHeader(0, 1.0, 0, 0),
                      np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        timg.ImageIter(2, (3, 8, 8), path_imgrec=native_rec)
    # the card codec refuses a host tensor: no quiet host decode
    with pytest.raises(tmx.MXNetError, match="CUDA device"):
        codec.decode(buf, "cpu")
