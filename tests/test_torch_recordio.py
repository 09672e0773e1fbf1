"""mxnet_tpu_torch.recordio against mxnet_tpu.recordio, on the CPU: the
files are byte for byte the same in both directions.

- ``pack`` / ``unpack`` (one label, several labels) give the same bytes
  and headers;
- sequential and indexed files written by either package are read by
  the other (the bytes of the ``.rec`` and the ``.idx`` equal), an
  indexed file without its ``.idx`` is indexed from its framing, and a
  reader survives pickling;
- ``scan_record_positions`` equals the JAX package's (its native C++
  walk where built);
- ``pack_img`` / ``unpack_img`` at ``ctx=cpu()`` (OpenCV here) give the
  JAX package's bytes and pixels exactly; the card is the default
  context, so without a card they raise.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import recordio as trec

PKGS = {"jax": jrec, "torch": trec}


def _records(n=7, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.bytes(int(rng.randint(0, 40))) for _ in range(n)]


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0], np.arange(5.0)])
def test_pack_and_unpack_match_jax(label):
    hdr = (0, label, 17, 3)
    for payload in (b"", b"abc", bytes(range(41))):
        s = trec.pack(trec.IRHeader(*hdr), payload)
        assert s == jrec.pack(jrec.IRHeader(*hdr), payload)
        h, body = trec.unpack(s)
        jh, jbody = jrec.unpack(s)
        assert body == jbody == payload
        assert h.flag == jh.flag and h.id == jh.id and h.id2 == jh.id2
        np.testing.assert_array_equal(np.asarray(h.label),
                                      np.asarray(jh.label))


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_sequential_files_cross(tmp_path, writer, reader):
    recs = _records()
    paths = {}
    for n, m in PKGS.items():
        paths[n] = str(tmp_path / f"{n}.rec")
        w = m.MXRecordIO(paths[n], "w")
        for r in recs:
            w.write(r)
        w.close()
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()
    r = PKGS[reader].MXRecordIO(paths[writer], "r")
    got = []
    while True:
        s = r.read()
        if s is None:
            break
        got.append(s)
    assert got == recs
    r.reset()
    assert r.read() == recs[0]
    r.close()


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_indexed_files_cross(tmp_path, writer, reader):
    recs = _records(9, seed=1)
    for n, m in PKGS.items():
        w = m.MXIndexedRecordIO(str(tmp_path / f"{n}.idx"),
                                str(tmp_path / f"{n}.rec"), "w")
        for i, r in enumerate(recs):
            w.write_idx(i * 2, r)
        w.close()
    for ext in ("rec", "idx"):
        assert (tmp_path / f"jax.{ext}").read_bytes() == \
            (tmp_path / f"torch.{ext}").read_bytes()
    r = PKGS[reader].MXIndexedRecordIO(str(tmp_path / f"{writer}.idx"),
                                       str(tmp_path / f"{writer}.rec"), "r")
    assert r.keys == [2 * i for i in range(9)]
    for i in (8, 0, 5, 5, 3):
        assert r.read_idx(2 * i) == recs[i]
    # without the .idx the seek table comes from the framing
    t = trec.MXIndexedRecordIO(None, str(tmp_path / f"{writer}.rec"), "r")
    j = jrec.MXIndexedRecordIO(None, str(tmp_path / f"{writer}.rec"), "r")
    assert t.keys == j.keys == list(range(9))
    assert t.idx == j.idx
    assert [t.read_idx(k) for k in t.keys] == recs
    # a reader pickles (closed) and reopens where it was
    t2 = pickle.loads(pickle.dumps(t))
    assert t2.read_idx(4) == recs[4]
    with pytest.raises(ValueError, match="Invalid flag"):
        trec.MXRecordIO(str(tmp_path / "x.rec"), "a")


def test_scan_record_positions_matches_jax(tmp_path):
    path = str(tmp_path / "s.rec")
    w = trec.MXRecordIO(path, "w")
    for r in _records(11, seed=2):
        w.write(r)
    w.close()
    got, want = trec.scan_record_positions(path), \
        jrec.scan_record_positions(path)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with open(path, "r+b") as f:                 # a broken magic word
        f.write(b"\0\0\0\0")
    with pytest.raises(IOError, match="corrupt"):
        trec.scan_record_positions(path)


@pytest.mark.parametrize("quality,fmt,iscolor", [(95, ".jpg", -1),
                                                 (80, ".jpg", 0),
                                                 (3, ".png", 1)])
def test_pack_img_and_unpack_img_on_the_host_match_jax(quality, fmt,
                                                       iscolor):
    pytest.importorskip("cv2")
    img = np.random.RandomState(4).randint(0, 256, (20, 28, 3)) \
        .astype(np.uint8)
    hdr = trec.IRHeader(0, [1.0, 2.0], 5, 0)
    s = trec.pack_img(hdr, img, quality=quality, img_fmt=fmt, ctx=tmx.cpu())
    assert s == jrec.pack_img(jrec.IRHeader(*hdr), img, quality=quality,
                              img_fmt=fmt)
    h, got = trec.unpack_img(s, iscolor, ctx=tmx.cpu())
    jh, want = jrec.unpack_img(s, iscolor)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(h.label, jh.label)
    assert trec.USES_CV2 == jrec.USES_CV2


def test_pack_img_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        trec.pack_img(trec.IRHeader(0, 1.0, 0, 0), img)
    s = trec.pack_img(trec.IRHeader(0, 1.0, 0, 0), img, ctx=tmx.cpu())
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        trec.unpack_img(s)
    with pytest.raises(ValueError, match="JPEG only"):
        trec.pack_img(trec.IRHeader(0, 1.0, 0, 0), img, img_fmt=".png",
                      ctx=tmx.gpu())
