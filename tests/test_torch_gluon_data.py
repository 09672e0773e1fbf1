"""The port's gluon.data against the JAX package's: samplers (a seeded
RandomSampler visits the same order), BatchSampler's three last_batch
policies, ArrayDataset and transform / transform_first, the DataLoader
(inline, thread and process workers give the same batches, on the
context of the iteration), the vision datasets (the synthetic MNIST,
FashionMNIST, CIFAR10 and CIFAR100 sets equal, MNIST read from idx files
the test writes) and every vision transform on the same image.

Tolerances: exact, but for the resampling transforms on 8-bit images,
where the JAX package calls OpenCV, which sums in fixed point, and the
port rounds a float64 sum: one unit of the uint8 pixel (1 / 255 after
ToTensor, with float32 rounding). Float images resample to 1e-4 of 255.
"""
import gzip
import random
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from mxnet_tpu.gluon import data as jdata
from mxnet_tpu_torch.gluon import data as tdata

CPU = tmx.cpu()


@pytest.fixture(autouse=True)
def _keep_global_rngs():
    """The samplers and transforms draw from numpy's and Python's global
    generators: restore both for the other tests of the process."""
    np_state, py_state = np.random.get_state(), random.getstate()
    yield
    np.random.set_state(np_state)
    random.setstate(py_state)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def test_samplers_match_jax():
    assert list(tdata.SequentialSampler(7)) == list(jdata.SequentialSampler(7))
    for seed in (0, 3):
        np.random.seed(seed)
        want = list(jdata.RandomSampler(20))
        np.random.seed(seed)
        got = list(tdata.RandomSampler(20))
        assert got == want and sorted(got) == list(range(20))
    assert len(tdata.RandomSampler(5)) == 5


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_batch_sampler_last_batch(last_batch):
    def epochs(pkg):
        bs = pkg.BatchSampler(pkg.SequentialSampler(10), 3, last_batch)
        return [(len(bs), list(bs)) for _ in range(3)]
    got = epochs(tdata)
    assert got == epochs(jdata)
    first = got[0][1]
    if last_batch == "keep":
        assert first[-1] == [9] and got[0][0] == 4
    elif last_batch == "discard":
        assert first[-1] == [6, 7, 8] and got[0][0] == 3
    else:
        assert got[1][1][0] == [9, 0, 1]
    with pytest.raises(ValueError, match="last_batch"):
        tdata.BatchSampler(tdata.SequentialSampler(4), 2, "pad")


def test_array_dataset_and_transforms():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    y = np.arange(6, dtype=np.int32)
    for pkg, mx, kw in ((tdata, tmx, {"ctx": CPU}), (jdata, jmx, {})):
        ds = pkg.ArrayDataset(x, mx.nd.array(y, dtype="int32", **kw))
        assert len(ds) == 6
        d, lab = ds[2]
        np.testing.assert_array_equal(d, x[2])
        assert int(lab) == 2
        lazy = ds.transform_first(lambda v: v * 2)
        eager = ds.transform_first(lambda v: v * 2, lazy=False)
        assert type(eager).__name__ == "SimpleDataset"
        for t in (lazy, eager):
            d, lab = t[3]
            np.testing.assert_array_equal(d, x[3] * 2)
            assert int(lab) == 3
        both = ds.transform(lambda a, b: (a.sum(), b + 1))
        assert both[1] == (x[1].sum(), 2)
        single = pkg.ArrayDataset(x).transform(lambda a: a[0])
        assert single[5] == x[5, 0]
        with pytest.raises(AssertionError, match="same length"):
            pkg.ArrayDataset(x, y[:5])
    # RecordFileDataset is ported (tests/test_torch_image.py reads
    # files): a missing file raises as in the JAX package
    for pkg in (jdata, tdata):
        with pytest.raises(FileNotFoundError):
            pkg.RecordFileDataset("no-such-file.rec")


def _loader_batches(pkg, ds, **kw):
    return [_np(b) for b in pkg.DataLoader(ds, batch_size=4, **kw)]


def test_dataloader_workers_and_contexts():
    rng = np.random.RandomState(0)
    x = rng.standard_normal((18, 3, 5)).astype(np.float32)
    y = rng.randint(0, 4, 18).astype(np.float32)
    want = _loader_batches(jdata, jdata.ArrayDataset(x, y))
    ds = tdata.ArrayDataset(x, y)
    runs = {}
    with CPU:
        for name, kw in (("inline", {}),
                         ("thread", {"num_workers": 2}),
                         ("process", {"num_workers": 2,
                                      "worker_type": "process"})):
            loader = tdata.DataLoader(ds, batch_size=4, **kw)
            assert len(loader) == 5
            batches = list(loader)
            assert all(b.context == CPU for b in batches[0])
            runs[name] = [_np(b) for b in batches]
    for name, got in runs.items():
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=name)
    # the tail batch kept; last_batch="discard" drops it
    assert runs["inline"][-1][0].shape == (2, 3, 5)
    with CPU:
        assert len(list(tdata.DataLoader(ds, 4, last_batch="discard"))) == 4
    # shuffled through numpy's global generator, as the JAX package
    np.random.seed(5)
    jshuf = _loader_batches(jdata, jdata.ArrayDataset(x, y), shuffle=True)
    np.random.seed(5)
    with CPU:
        tshuf = _loader_batches(tdata, ds, shuffle=True)
    for g, w in zip(tshuf, jshuf):
        np.testing.assert_array_equal(g[1], w[1])
    # a user's batchify_fn runs in the thread workers under the context
    # of the iteration, and its output is returned as it is
    with CPU:
        ctxs = list(tdata.DataLoader(
            ds, batch_size=6, num_workers=2,
            batchify_fn=lambda s: tmx.nd.array(np.stack([a for a, _ in s]))
            .context))
    assert ctxs == [CPU] * 3


def test_dataloader_refusals():
    ds = tdata.SimpleDataset(list(range(4)))
    with pytest.raises(ValueError, match="worker_type"):
        tdata.DataLoader(ds, 2, worker_type="fiber")
    with pytest.raises(ValueError, match="batch_size must be specified"):
        tdata.DataLoader(ds)
    with pytest.raises(ValueError, match="shuffle must not"):
        tdata.DataLoader(ds, 2, shuffle=True,
                         sampler=tdata.SequentialSampler(4))
    with pytest.raises(ValueError, match="must not be specified"):
        tdata.DataLoader(ds, 2, batch_sampler=tdata.BatchSampler(
            tdata.SequentialSampler(4), 2))


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "CIFAR10",
                                  "CIFAR100"])
@pytest.mark.parametrize("train", [True, False])
def test_synthetic_vision_datasets_match_jax(tmp_path, name, train):
    root = str(tmp_path / "absent")
    j = getattr(jdata.vision, name)(root=root, train=train)
    t = getattr(tdata.vision, name)(root=root, train=train)
    assert len(t) == len(j)
    for i in (0, 1, len(j) - 1):
        (ti, tl), (ji, jl) = t[i], j[i]
        assert ti.context == CPU and ti.dtype == np.uint8
        np.testing.assert_array_equal(ti.asnumpy(), ji.asnumpy())
        assert int(tl) == int(jl)
    np.testing.assert_array_equal(t._label, j._label)


def _write_idx(root, n=12, gz=False):
    rng = np.random.RandomState(7)
    images = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    with opener(str(root / ("train-images-idx3-ubyte" + suffix)), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with opener(str(root / ("train-labels-idx1-ubyte" + suffix)), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return images, labels


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_reads_idx_files(tmp_path, gz):
    images, labels = _write_idx(tmp_path, gz=gz)
    t = tdata.vision.MNIST(root=str(tmp_path))
    j = jdata.vision.MNIST(root=str(tmp_path))
    assert len(t) == len(j) == 12
    for i in range(12):
        np.testing.assert_array_equal(t[i][0].asnumpy(), images[i][..., None])
        np.testing.assert_array_equal(t[i][0].asnumpy(), j[i][0].asnumpy())
        assert int(t[i][1]) == int(labels[i]) == int(j[i][1])
    # a transform and a loader over the files
    ds = t.transform_first(tdata.vision.transforms.ToTensor())
    with CPU:
        x, y = next(iter(tdata.DataLoader(ds, batch_size=5)))
    assert x.shape == (5, 1, 28, 28) and x.dtype == np.float32
    np.testing.assert_allclose(x.asnumpy()[0, 0], images[0] / 255.0,
                               rtol=1e-6)
    np.testing.assert_array_equal(y.asnumpy(), labels[:5])
    # the image datasets are ported (tests/test_torch_image.py): a
    # folder without class folders is empty, a missing .rec raises, as
    # in the JAX package
    for pkg in (jdata, tdata):
        assert len(pkg.vision.ImageFolderDataset(str(tmp_path))) == 0
        with pytest.raises(FileNotFoundError):
            pkg.vision.ImageRecordDataset(str(tmp_path / "x.rec"))


def _transforms(pkg):
    T = pkg.vision.transforms
    return {
        "to_tensor": (T.ToTensor(), 0),
        "normalize": (T.Compose([T.ToTensor(), T.Normalize(
            (0.4, 0.5, 0.6), (0.2, 0.25, 0.3))]), 0),
        "cast": (T.Cast("float16"), 0),
        "resize": (T.Resize((20, 14)), 1),
        "resize_nearest": (T.Resize(17, interpolation=0), 0),
        "resize_keep_ratio": (T.Resize(24, keep_ratio=True), 1),
        "center_crop": (T.CenterCrop(16), 0),
        "center_crop_larger": (T.CenterCrop((40, 36)), 1),
        "random_resized_crop": (T.RandomResizedCrop(12), 1),
        "flip_lr": (T.RandomFlipLeftRight(), 0),
        "flip_tb": (T.RandomFlipTopBottom(), 0),
        "brightness": (T.RandomBrightness(0.4), 0),
        "contrast": (T.RandomContrast(0.4), 0),
        "saturation": (T.RandomSaturation(0.4), 0),
        "compose": (T.Compose([T.Resize(24), T.CenterCrop(20),
                               T.RandomFlipLeftRight(), T.ToTensor()]),
                    1.0001 / 255),
    }


@pytest.mark.parametrize("name", sorted(_transforms(tdata)))
def test_vision_transforms_match_jax(name):
    img = np.random.RandomState(11).randint(0, 256, (30, 26, 3)) \
        .astype(np.uint8)
    tt, atol = _transforms(tdata)[name]
    jt, _ = _transforms(jdata)[name]
    for seed in range(4):
        random.seed(seed)
        got = tt(tmx.nd.array(img, ctx=CPU, dtype="uint8"))
        random.seed(seed)
        want = jt(jmx.nd.array(img, dtype="uint8"))
        assert got.context == CPU
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_allclose(got.asnumpy().astype(np.float64),
                                   want.asnumpy().astype(np.float64),
                                   rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4])
def test_imresize_float_images_match_jax(interp):
    from mxnet_tpu import image as jimage
    from mxnet_tpu_torch import image as timage
    img = np.random.RandomState(12).uniform(0, 255, (23, 31, 3)) \
        .astype(np.float32)
    for w, h in ((11, 9), (40, 50), (31, 23), (15, 30)):
        got = timage.imresize(img, w, h, interp).asnumpy()
        want = jimage.imresize(jmx.nd.array(img), w, h, interp).asnumpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=255 * 1e-4)
