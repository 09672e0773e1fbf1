"""The port's sparse storage (mxnet_tpu_torch/ndarray/sparse.py, the
four sparse ops, the optimizers' lazy updates, the kvstore's row-sparse
push and pull, sparse ``.params`` files) against the JAX package's, on
the CPU.

Both packages get the same seeded numpy inputs. Values are held within
RTOL (1e-6) of each array's largest magnitude plus ATOL; index arrays,
storage types and row sets exactly. Every case of
tests/test_sparse_optimizer.py runs in both packages, its own asserts on
the port's result and the two results against each other.
"""
import numpy as np
import pytest
import scipy.sparse as sps

import mxnet_tpu as jmx
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import sparse as tsp
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-6, 1e-7


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL + RTOL * scale,
                               err_msg=what)


@pytest.fixture(autouse=True)
def _host_context():
    with tmx.cpu():
        yield


# (package namespace, sparse module) of each package
PKGS = {"jax": (jmx, jsp), "port": (tmx, tsp)}


def _csr_parts(seed, r=5, f=32):
    rng = np.random.RandomState(seed)
    dense = np.zeros((r, f), np.float32)
    for i in range(r):
        cols = rng.choice(f, size=rng.randint(1, 6), replace=False)
        dense[i, cols] = rng.normal(0, 1, len(cols))
    csr = sps.csr_matrix(dense)
    return dense, (csr.data, csr.indices, csr.indptr)


# -- construction and validation ----------------------------------------------

def test_csr_matrix_parts_and_duplicates_match_jax():
    data = np.array([1.0, 2.0, 0.0, 3.0, 4.0], np.float32)
    indices = np.array([2, 2, 4, 1, 0])        # (0, 2) twice: summed
    indptr = np.array([0, 3, 5])
    outs = {}
    for key, (_, sp) in PKGS.items():
        m = sp.csr_matrix((data, indices, indptr), shape=(2, 6))
        assert m.stype == "csr" and m._ell is not None
        outs[key] = (m.asnumpy(), m.data.asnumpy(), m.indices.asnumpy(),
                     m.indptr.asnumpy())
    for got, want in zip(outs["port"], outs["jax"]):
        np.testing.assert_array_equal(got, want)
    # the explicit zero at (0, 4) survives in the parts
    np.testing.assert_array_equal(outs["port"][2], [2, 4, 0, 1])


def test_row_sparse_array_parts_match_jax():
    data = np.arange(6, dtype=np.float32).reshape(3, 2)
    rows = np.array([4, 0, 2])
    for shape in ((6, 2), None):
        got = tsp.row_sparse_array((data, rows), shape=shape)
        want = jsp.row_sparse_array((data, rows), shape=shape)
        assert got.stype == "row_sparse" and got.shape == want.shape
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
        np.testing.assert_array_equal(got.indices.asnumpy(),
                                      want.indices.asnumpy())
        np.testing.assert_array_equal(got.data.asnumpy(),
                                      want.data.asnumpy())
    half = tsp.row_sparse_array((data, rows), shape=(6, 2), dtype="float16")
    assert str(half.dtype) == "float16" and str(half.data.dtype) == "float16"


@pytest.mark.parametrize("make", [
    lambda sp: sp.row_sparse_array((np.ones((2, 2), np.float32),
                                    np.array([1, 1])), shape=(4, 2)),
    lambda sp: sp.csr_matrix((np.ones(1, np.float32), np.array([7]),
                              np.array([0, 1, 1])), shape=(2, 4)),
    lambda sp: sp.csr_matrix((np.ones(1, np.float32), np.array([-1]),
                              np.array([0, 1, 1])), shape=(2, 4)),
    lambda sp: sp.merge_row_sparse([(np.ones((1, 2), np.float32), [4])],
                                   shape=(4, 2)),
    lambda sp: sp.merge_row_sparse([np.ones(2)], shape=(4, 2)),
], ids=["duplicate_rows", "column_past_end", "negative_column",
        "merge_row_out_of_range", "merge_bad_part"])
def test_invalid_parts_raise_in_both(make):
    with pytest.raises(jmx.MXNetError):
        make(jsp)
    with pytest.raises(MXNetError):
        make(tsp)


def test_dense_backed_views_and_tostype():
    rng = np.random.RandomState(0)
    a = np.zeros((5, 3), np.float32)
    a[[1, 3]] = rng.normal(size=(2, 3))
    for key, (mx, sp) in PKGS.items():
        rs = sp.row_sparse_array(mx.nd.array(a))
        assert rs._ell is None
        np.testing.assert_array_equal(rs.indices.asnumpy(), [1, 3])
        np.testing.assert_array_equal(rs.data.asnumpy(), a[[1, 3]])
        d = rs.tostype("default")
        assert d.stype == "default"
        np.testing.assert_array_equal(d.asnumpy(), a)
        z = sp.zeros_sparse("csr", (2, 3))
        assert z.stype == "csr" and not z.asnumpy().any()
    # NDArray.tostype gives the dense-backed views (the JAX package's
    # NDArray.tostype raises for them; sparse.row_sparse_array(x) /
    # csr_matrix(x) build the same views there)
    x = tmx.nd.array(a)
    assert x.tostype("default") is x
    for stype, make in (("row_sparse", jsp.row_sparse_array),
                        ("csr", jsp.csr_matrix)):
        v = x.tostype(stype)
        w = make(jmx.nd.array(a))
        assert v.stype == w.stype == stype
        np.testing.assert_array_equal(v.indices.asnumpy(),
                                      w.indices.asnumpy())
    with pytest.raises(MXNetError):
        tsp.csr_matrix(a).tostype("row_sparse")


def test_attach_grad_takes_a_sparse_stype():
    """attach_grad(stype=...) is accepted and the gradient stays dense,
    as in the JAX package."""
    grads = []
    for mx in (jmx, tmx):
        x = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        x.attach_grad(stype="row_sparse")
        with mx.autograd.record():
            y = (x * x).sum()
        y.backward()
        grads.append(x.grad.asnumpy())
    np.testing.assert_array_equal(grads[1], grads[0])


def test_inplace_write_drops_the_parts():
    g = tsp.row_sparse_array((np.ones((2, 3), np.float32), [1, 4]),
                             shape=(6, 3))
    g *= 0.5
    assert g._ell is None
    h = tsp.row_sparse_array((np.ones((1, 3), np.float32), [2]),
                             shape=(6, 3))
    h[0] = 1.0
    assert h._ell is None
    k = tsp.csr_matrix(*[(np.ones(1, np.float32), np.array([1]),
                          np.array([0, 1, 1]))], shape=(2, 3))
    tmx.nd.ones((2, 3)).copyto(k)
    assert k._ell is None


# -- dot and its gradient -----------------------------------------------------

@pytest.mark.parametrize("transpose_a", [False, True])
def test_dot_gather_path_matches_jax(transpose_a):
    dense, parts = _csr_parts(3)
    rng = np.random.RandomState(4)
    rhs = rng.normal(size=(5 if transpose_a else 32, 4)).astype(np.float32)
    outs = []
    for mx, sp in (PKGS["jax"], PKGS["port"]):
        lhs = sp.csr_matrix(parts, shape=dense.shape)
        outs.append(sp.dot(lhs, mx.nd.array(rhs),
                           transpose_a=transpose_a).asnumpy())
        # a dense-backed csr takes the dense op
        outs.append(sp.dot(sp.csr_matrix(mx.nd.array(dense)),
                           mx.nd.array(rhs),
                           transpose_a=transpose_a).asnumpy())
    ref = (dense.T if transpose_a else dense) @ rhs
    for o in outs:
        _close(o, ref)
    _close(outs[2], outs[0])


def test_dot_records_the_rhs_gradient():
    dense, parts = _csr_parts(5, r=3, f=8)
    rhs = np.random.RandomState(6).normal(size=(8, 2)).astype(np.float32)
    ct = np.random.RandomState(7).normal(size=(3, 2)).astype(np.float32)
    grads = []
    for mx, sp in (PKGS["jax"], PKGS["port"]):
        lhs = sp.csr_matrix(parts, shape=(3, 8))
        r = mx.nd.array(rhs)
        r.attach_grad()
        with mx.autograd.record():
            out = sp.dot(lhs, r)
            loss = (out * mx.nd.array(ct)).sum()
        loss.backward()
        grads.append(r.grad.asnumpy())
    _close(grads[1], grads[0])
    _close(grads[1], dense.T @ ct)


def test_dot_shape_mismatch_raises():
    m = tsp.csr_matrix((np.ones(1, np.float32), np.array([2]),
                        np.array([0, 1, 1])), shape=(2, 32))
    with pytest.raises(Exception):
        tsp.dot(m, tmx.nd.ones((16, 4)))


# -- merge_row_sparse ---------------------------------------------------------

def test_merge_row_sparse_matches_jax():
    rng = np.random.RandomState(8)
    parts = [(rng.normal(size=(3, 2)).astype(np.float32),
              np.array([5, 1, 3])),
             (rng.normal(size=(2, 2)).astype(np.float32), np.array([3, 0]))]
    outs = []
    for _, sp in (PKGS["jax"], PKGS["port"]):
        a = sp.row_sparse_array(parts[0], shape=(7, 2))
        m = sp.merge_row_sparse([a, parts[1]])
        assert m.stype == "row_sparse" and m._ell is not None
        outs.append((m.asnumpy(), m.indices.asnumpy(), m.data.asnumpy()))
        e = sp.merge_row_sparse([], shape=(4, 2))
        assert e._ell is not None and not e.asnumpy().any()
    for got, want in zip(outs[1], outs[0]):
        _close(got, want)
    np.testing.assert_array_equal(outs[1][1], [0, 1, 3, 5])


# -- the four item-3 ops ------------------------------------------------------

def _op_pair(name, ins, attrs):
    import jax.numpy as jnp
    import torch
    js, ts = jreg.get_op(name), treg.get_op(name)
    jo = js.fcompute(js.parse_attrs(attrs), jreg.OpCtx(is_train=True),
                     *[jnp.asarray(x) for x in ins])
    to = ts.fcompute(ts.parse_attrs(attrs),
                     treg.OpCtx(is_train=True, device=torch.device("cpu")),
                     *[torch.tensor(x) for x in ins])
    return [np.asarray(o) for o in jo], [o.numpy() for o in to]


@pytest.mark.parametrize("name,ins,attrs", [
    ("cast_storage", [np.arange(6, dtype=np.float32).reshape(2, 3)],
     {"stype": "row_sparse"}),
    ("_sparse_cast_storage", [np.ones((2, 2), np.float32)],
     {"stype": "csr"}),
    ("_sparse_retain", [np.arange(12, dtype=np.float32).reshape(4, 3),
                        np.array([3, 1], np.float32)], {}),
    ("_sparse_adagrad_update",
     [np.random.RandomState(9).normal(size=(4, 3)).astype(np.float32),
      np.random.RandomState(10).normal(size=(4, 3)).astype(np.float32),
      np.abs(np.random.RandomState(11).normal(size=(4, 3)))
      .astype(np.float32)],
     {"lr": 0.1, "rescale_grad": 0.5, "clip_gradient": 0.4}),
], ids=["cast_storage", "sparse_cast_storage", "sparse_retain",
        "sparse_adagrad_update"])
def test_sparse_op_matches_jax(name, ins, attrs):
    jo, to = _op_pair(name, ins, attrs)
    assert len(jo) == len(to)
    for got, want in zip(to, jo):
        _close(got, want, name)


def test_sparse_ops_are_registered_and_refuse_wd():
    assert treg.get_op("_sparse_cast_storage") is treg.get_op("cast_storage")
    for name in ("cast_storage", "_sparse_retain", "_sparse_adagrad_update"):
        assert treg.get_op(name).name == jreg.get_op(name).name
        assert callable(getattr(tmx.nd, name))
    import torch
    schema = treg.get_op("_sparse_adagrad_update")
    with pytest.raises(MXNetError, match="wd"):
        schema.fcompute(schema.parse_attrs({"lr": 0.1, "wd": 0.1}),
                        treg.OpCtx(), *[torch.ones(2, 2)] * 3)
    with pytest.raises(jmx.MXNetError, match="wd"):
        _op_pair("_sparse_adagrad_update", [np.ones((2, 2), np.float32)] * 3,
                 {"lr": 0.1, "wd": 0.1})


def test_sparse_adagrad_update_through_nd_writes_history():
    w0 = np.ones((3, 2), np.float32)
    outs = []
    for mx in (jmx, tmx):
        w, g = mx.nd.array(w0), mx.nd.array(np.full((3, 2), 0.5, np.float32))
        h = mx.nd.zeros((3, 2))
        mx.nd._sparse_adagrad_update(w, g, h, out=w, lr=0.1)
        outs.append((w.asnumpy(), h.asnumpy()))
    for got, want in zip(outs[1], outs[0]):
        _close(got, want)
    assert outs[1][1].any()


# -- the lazy updates: tests/test_sparse_optimizer.py, in both packages -------

def _rs_dense(sp, shape, rows, data):
    dense = np.zeros(shape, np.float32)
    dense[rows] = data
    return sp.row_sparse_array(dense)


def _rs_parts(sp, shape, rows, data):
    return sp.row_sparse_array((data, np.array(rows, np.int64)), shape=shape)


def _draw(shape, rows, seed):
    return np.random.RandomState(seed).normal(
        0, 1, (len(rows),) + shape[1:]).astype(np.float32)


def _sgd_case(mx, sp, grad_kind, lazy, momentum=0.9, wd=0.1, lr=0.1,
              shape=(6, 3), rows=(1, 4), data=None, w0=None, mom0=0.5):
    rows = list(rows)
    data = _draw(shape, rows, 0) if data is None else data
    grad = (_rs_parts if grad_kind == "parts" else _rs_dense)(
        sp, shape, rows, data)
    opt = mx.optimizer.SGD(learning_rate=lr, momentum=momentum, wd=wd,
                           lazy_update=lazy)
    w = mx.nd.array(np.ones(shape, np.float32) if w0 is None else w0)
    state = mx.nd.array(np.full(shape, mom0, np.float32)) if momentum \
        else None
    opt.update(0, w, grad, state)
    return [w.asnumpy()] + ([state.asnumpy()] if momentum else [])


def _adam_case(mx, sp, grad_kind, lazy, shape=(5, 2), rows=(0, 3), seed=3,
               w0=None, wd=0.0, clip=None, data=None):
    rows = list(rows)
    data = _draw(shape, rows, seed) if data is None else data
    grad = (_rs_parts if grad_kind == "parts" else _rs_dense)(
        sp, shape, rows, data)
    opt = mx.optimizer.Adam(learning_rate=0.01, wd=wd, clip_gradient=clip,
                            lazy_update=lazy)
    w = mx.nd.array(np.ones(shape, np.float32) if w0 is None else w0)
    state = opt.create_state(0, w)
    opt.update(0, w, grad, state)
    return [w.asnumpy(), state[0].asnumpy(), state[1].asnumpy()]


def _w(seed, shape, loc=1.0):
    return np.random.RandomState(seed).normal(loc, 0.1, shape) \
        .astype(np.float32)


def _check_sgd_lazy(out):
    w, m = out
    g = _draw((6, 3), [1, 4], 0) + 0.1
    expect_m = 0.9 * 0.5 - 0.1 * g
    assert np.array_equal(w[[0, 2, 3, 5]], np.ones((4, 3), np.float32))
    assert np.array_equal(m[[0, 2, 3, 5]], np.full((4, 3), 0.5, np.float32))
    np.testing.assert_allclose(m[[1, 4]], expect_m, rtol=1e-6)
    np.testing.assert_allclose(w[[1, 4]], 1 + expect_m, rtol=1e-6)


def _check_sgd_std(out):
    w, m = out
    expect = 0.9 * 0.5 - 0.1 * (0.1 * 1.0)
    np.testing.assert_allclose(m[[0, 2, 3, 5]], expect, rtol=1e-6)
    np.testing.assert_allclose(w[[0, 2, 3, 5]], 1 + expect, rtol=1e-6)


def _check_adam_lazy(out):
    w, mean, var = out
    assert np.array_equal(w[[1, 2, 4]], np.ones((3, 2), np.float32))
    assert not mean[[1, 2, 4]].any() and not var[[1, 2, 4]].any()
    assert np.all(w[[0, 3]] != 1) and np.all(mean[[0, 3]] != 0)


def _check_explicit_zero_rows(out):
    w = out[0]
    np.testing.assert_allclose(w[[1, 4]], 1.0 - 0.1 * 0.5, rtol=1e-6)
    assert np.array_equal(w[[0, 2, 3, 5]], np.ones((4, 3), np.float32))


def _check_wd_before_clip(out):
    assert out[0][1, 0] > 3.0


def _check_dense_grad(out):
    np.testing.assert_allclose(out[0], 1 - 0.1 * 0.1, rtol=1e-6)


LAZY_CASES = {
    "sgd_lazy_update_touches_only_grad_rows": (
        lambda mx, sp: _sgd_case(mx, sp, "dense", True), _check_sgd_lazy),
    "sgd_std_update_touches_all_rows": (
        lambda mx, sp: _sgd_case(mx, sp, "dense", False), _check_sgd_std),
    "adam_lazy_update_touches_only_grad_rows": (
        lambda mx, sp: _adam_case(mx, sp, "dense", True), _check_adam_lazy),
    "sgd_scatter_path": (
        lambda mx, sp: _sgd_case(mx, sp, "parts", True, w0=_w(1, (8, 4)),
                                 shape=(8, 4), rows=(2, 5, 7), mom0=0.25),
        None),
    "sgd_masked_path_same_rows": (
        lambda mx, sp: _sgd_case(mx, sp, "dense", True, w0=_w(1, (8, 4)),
                                 shape=(8, 4), rows=(2, 5, 7), mom0=0.25),
        None),
    "sgd_scatter_plain": (
        lambda mx, sp: _sgd_case(mx, sp, "parts", True, momentum=0.0,
                                 lr=1.0), None),
    "scatter_path_honors_explicit_zero_rows": (
        lambda mx, sp: _sgd_case(mx, sp, "parts", True, wd=0.5, mom0=0.0,
                                 data=np.zeros((2, 3), np.float32)),
        _check_explicit_zero_rows),
    "adam_scatter_path": (
        lambda mx, sp: _adam_case(mx, sp, "parts", True, shape=(7, 2),
                                  rows=(0, 3, 6), seed=5,
                                  w0=_w(2, (7, 2), 0.0)), None),
    "adam_scatter_path_wd_clip_order": (
        lambda mx, sp: _adam_case(mx, sp, "parts", True, shape=(4, 1),
                                  rows=(1,), w0=np.full((4, 1), 3.0,
                                                        np.float32),
                                  wd=0.5, clip=1.0,
                                  data=np.full((1, 1), -2.0, np.float32)),
        _check_wd_before_clip),
    "adam_masked_path_wd_clip_order": (
        lambda mx, sp: _adam_case(mx, sp, "dense", True, shape=(4, 1),
                                  rows=(1,), w0=np.full((4, 1), 3.0,
                                                        np.float32),
                                  wd=0.5, clip=1.0,
                                  data=np.full((1, 1), -2.0, np.float32)),
        _check_wd_before_clip),
}


@pytest.mark.parametrize("case", sorted(LAZY_CASES))
def test_lazy_update_matches_jax(case):
    run, check = LAZY_CASES[case]
    want = run(jmx, jsp)
    got = run(tmx, tsp)
    for g, w in zip(got, want):
        _close(g, w, case)
    if check is not None:
        check(got)


def test_dense_grad_ignores_lazy_flag():
    for mx in (jmx, tmx):
        opt = mx.optimizer.SGD(learning_rate=0.1, wd=0.1, lazy_update=True)
        w = mx.nd.array(np.ones((4, 2), np.float32))
        opt.update(0, w, mx.nd.zeros((4, 2)), None)
        _check_dense_grad([w.asnumpy()])


def test_scatter_and_masked_paths_agree_in_the_port():
    a = LAZY_CASES["sgd_scatter_path"][0](tmx, tsp)
    b = LAZY_CASES["sgd_masked_path_same_rows"][0](tmx, tsp)
    for x, y in zip(a, b):
        _close(x, y)


def test_adagrad_on_row_sparse_matches_jax():
    rng = np.random.RandomState(12)
    w0 = rng.normal(size=(5, 2)).astype(np.float32)
    data = rng.normal(size=(2, 2)).astype(np.float32)
    outs = []
    for mx, sp in (PKGS["jax"], PKGS["port"]):
        opt = mx.optimizer.AdaGrad(learning_rate=0.1, wd=0.01,
                                   clip_gradient=0.5)
        w = mx.nd.array(w0)
        st = opt.create_state(0, w)
        opt.update(0, w, sp.row_sparse_array((data, [0, 3]), shape=(5, 2)),
                   st)
        outs.append((w.asnumpy(), st.asnumpy()))
    for g, w in zip(outs[1], outs[0]):
        _close(g, w)


# -- the kvstore: row-sparse push and pull ------------------------------------

def test_kvstore_row_sparse_push_is_lazy_and_matches_jax():
    W = np.random.RandomState(2).normal(size=(8, 4)).astype(np.float32)
    outs = []
    for mx, sp in (PKGS["jax"], PKGS["port"]):
        kv = mx.kv.create("local")
        kv.init("emb", mx.nd.array(W))
        kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5, wd=0.1))
        g1 = sp.row_sparse_array((np.ones((2, 4), np.float32), [1, 3]),
                                 shape=(8, 4))
        g2 = sp.row_sparse_array((np.full((2, 4), 2.0, np.float32), [3, 5]),
                                 shape=(8, 4))
        kv.push("emb", [g1, g2])
        out = mx.nd.zeros((8, 4))
        kv.pull("emb", out=out)
        outs.append(out.asnumpy())
    o = outs[1]
    _close(o, outs[0])
    assert np.array_equal(o[[0, 2, 4, 6, 7]], W[[0, 2, 4, 6, 7]])
    for r, gv in ((1, 1.0), (3, 3.0), (5, 2.0)):
        np.testing.assert_allclose(o[r], W[r] - 0.5 * (gv + 0.1 * W[r]),
                                   atol=1e-6)


def test_kvstore_row_sparse_pull_edge_cases():
    W = np.arange(12, dtype=np.float32).reshape(6, 2)
    for mx, err in ((jmx, jmx.MXNetError), (tmx, MXNetError)):
        kv = mx.kv.create("local")
        kv.init("emb", mx.nd.array(W))
        out = mx.nd.zeros((6, 2))
        kv.row_sparse_pull("emb", out=out, row_ids=mx.nd.array(
            np.array([4, 4, 1, 1], np.int64), dtype="int64"))
        o = out.asnumpy()
        assert np.array_equal(o[[1, 4]], W[[1, 4]])
        assert not o[[0, 2, 3, 5]].any()
        kv.row_sparse_pull("emb", out=out, row_ids=mx.nd.array(
            np.zeros(0, np.int64), dtype="int64"))
        assert not out.asnumpy().any()
        for bad in ([6], [-1]):
            with pytest.raises(err):
                kv.row_sparse_pull("emb", out=out, row_ids=mx.nd.array(
                    np.array(bad, np.int64), dtype="int64"))
        one = mx.nd.array(np.array([1], np.int64), dtype="int64")
        with pytest.raises(err):
            kv.row_sparse_pull(["emb"], out=[[out, out]],
                               row_ids=[[one] * 3])
        with pytest.raises(err):
            kv.row_sparse_pull(["emb", "ghost"], out=[[out], [out]],
                               row_ids=[one])
        # one id list for several outputs of a key; no ids: a plain pull
        o2 = mx.nd.zeros((6, 2))
        kv.row_sparse_pull("emb", out=[out, o2], row_ids=one)
        assert np.array_equal(o2.asnumpy()[1], W[1])
        kv.row_sparse_pull("emb", out=out)
        assert np.array_equal(out.asnumpy(), W)


# -- sparse .params files cross between the packages --------------------------

@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_sparse_params_cross_between_the_packages(tmp_path, direction):
    rs_parts = (np.arange(6, dtype=np.float32).reshape(2, 3),
                np.array([1, 3]))
    cs_parts = (np.array([1.0, 2.0, 3.0], np.float32), np.array([0, 2, 1]),
                np.array([0, 2, 3]))
    (smx, ssp), (lmx, _) = (PKGS["port"], PKGS["jax"]) \
        if direction == "port_to_jax" else (PKGS["jax"], PKGS["port"])
    arrays = {"rs": ssp.row_sparse_array(rs_parts, shape=(5, 3)),
              "cs": ssp.csr_matrix(cs_parts, shape=(2, 4)),
              "d": smx.nd.array(np.ones((2, 2), np.float32))}
    f = str(tmp_path / "sparse.params")
    smx.nd.save(f, arrays)
    loaded = lmx.nd.load(f)
    assert loaded["rs"].stype == "row_sparse" and loaded["cs"].stype == "csr"
    assert loaded["d"].stype == "default"
    for k in arrays:
        np.testing.assert_array_equal(loaded[k].asnumpy(),
                                      arrays[k].asnumpy())
    np.testing.assert_array_equal(loaded["rs"].indices.asnumpy(), [1, 3])
    np.testing.assert_array_equal(loaded["cs"].indptr.asnumpy(), [0, 2, 3])
    # and the bytes are the same whichever package writes them
    g = str(tmp_path / "again.params")
    lmx.nd.save(g, loaded)
    with open(f, "rb") as a, open(g, "rb") as b:
        assert a.read() == b.read()


def test_dense_readers_refuse_a_sparse_blob(tmp_path):
    from mxnet_tpu_torch.ndarray.container import load_container
    f = str(tmp_path / "s.params")
    tmx.nd.save(f, [tsp.row_sparse_array((np.ones((1, 2), np.float32),
                                          [0]), shape=(3, 2))])
    with pytest.raises(ValueError, match="sparse"):
        load_container(f)
    assert isinstance(tmx.nd.load(f)[0], tsp.RowSparseNDArray)
