"""The port's ``amp`` against the JAX package's, on the CPU.

- the policy's casts: for one Symbol (convolution, BatchNorm folded with
  its ReLU, pooling, FullyConnected, softmax, a SoftmaxOutput head) and
  one amp dtype, both packages' executor hooks see the same sequence of
  (op, dtype of each input after the cast), exactly; integer inputs are
  never cast;
- ``amp.init("float32")`` is bit-identical to amp off; a plan keeps the
  policy it was built with (``amp.init`` after the first forward changes
  nothing, in both packages); ``MXNET_AMP`` turns amp on at import;
- bf16: a ``DataParallelTrainer(dtype="bfloat16")`` MLP converges with
  fp32 masters;
- fp16: an inf batch is skipped (parameters and states bit-identical,
  the scale halved, one skip counted) exactly as in the JAX package; the
  scale is carried across ``step_k`` (K = 4 with an overflow in the
  middle against four ``step`` calls: bit-identical, the same scale and
  skips as the JAX package's scan); the host scaler's schedule; the
  device ``update_state`` against the JAX one over a schedule;
- ``multi_precision`` on by default under amp (Gluon's Trainer,
  ``Module.init_optimizer``; an explicit False wins), and a bf16 weight's
  fp32 master against the JAX package's;
- a 2-layer, 32-wide LM under amp bf16 through Gluon's ``fused_fit``:
  its losses within 2e-2 (relative) of the JAX package's (bf16 products
  in both, summed in different orders);
- ``python -m mxnet_tpu_torch.amp --selftest --ctx cpu``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.parallel.planner import AUTO_KNOB_VARS
import mxnet_tpu_torch as tmx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_RTOL = 2e-2


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """The JAX planner's settings another test may leave in os.environ
    (tests/test_planner.py's ``test_knobs_auto_unless_set``) and amp's
    settings are removed for the test (monkeypatch puts back what was
    set); amp's process-wide policy is reset after it in both
    packages, and torch runs on two threads for it."""
    for k in AUTO_KNOB_VARS + ("MXNET_PLAN", "MXNET_AMP", "MXNET_AMP_DTYPE"):
        if k in os.environ:
            monkeypatch.delenv(k)
    # two intra-op threads: the suite runs as six xdist workers at once,
    # and torch's default (all cores each) makes them fight for the CPU
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)
    jmx.amp._reset_for_tests()
    tmx.amp._reset_for_tests()


def _names(mx):
    return tmx.NameManager() if mx is tmx else jmx.base.NameManager()


def _mlp_sym(mx):
    with _names(mx):
        net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=16,
                                    name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
        return mx.sym.SoftmaxOutput(net, name="softmax")


def _conv_sym(mx):
    with _names(mx):
        x = mx.sym.Variable("data")
        x = mx.sym.Convolution(x, num_filter=4, kernel=(3, 3), pad=(1, 1),
                               name="c1")
        x = mx.sym.BatchNorm(x, name="bn1")
        x = mx.sym.Activation(x, act_type="relu")
        x = mx.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
        x = mx.sym.Flatten(x)
        x = mx.sym.FullyConnected(x, num_hidden=8, name="fc1")
        s = mx.sym.softmax(x, axis=-1)
        x = mx.sym.FullyConnected(x * s, num_hidden=4, name="fc2")
        return mx.sym.SoftmaxOutput(x, name="softmax")


def _data(n=16, shape=(8,)):
    rng = np.random.RandomState(0)
    x = rng.normal(size=(n,) + shape).astype(np.float32)
    y = rng.randint(0, 4, size=(n,)).astype(np.float32)
    return x, y


def _module(mx, sym, x, y, params=None):
    ctx = mx.cpu(0)
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    if params is None:
        mod.init_params(mx.init.Xavier(rnd_type="gaussian"))
    else:
        mod.init_params(arg_params=params[0], aux_params=params[1],
                        force_init=True)
    return mod


def _forward(mx, mod, x, y, is_train=False):
    kw = {"ctx": mx.cpu()} if mx is tmx else {}
    mod.forward(mx.io.DataBatch(data=[mx.nd.array(x, **kw)],
                                label=[mx.nd.array(y, **kw)]),
                is_train=is_train)
    return mod.get_outputs()[0].asnumpy()


def _host_params(mx, mod):
    args, aux = mod.get_params()
    kw = {"ctx": mx.cpu()} if mx is tmx else {}
    return ({n: a.asnumpy() for n, a in args.items()},
            {n: a.asnumpy() for n, a in aux.items()}, kw)


def _as(mx, params):
    args, aux, _ = params
    kw = {"ctx": mx.cpu()} if mx is tmx else {}
    return ({n: mx.nd.array(a, **kw) for n, a in args.items()},
            {n: mx.nd.array(a, **kw) for n, a in aux.items()})


def _cast_log(mx, monkeypatch, sym, x, y, params):
    log = []
    real = mx.amp.cast_op_inputs

    def logged(op_name, ins, *a, **k):
        out = real(op_name, ins, *a, **k)
        log.append((op_name, tuple(str(v.dtype).replace("torch.", "")
                                   for v in out)))
        return out
    monkeypatch.setattr(mx.amp, "cast_op_inputs", logged)
    mx.amp.init("bfloat16")
    mod = _module(mx, sym, x, y, _as(mx, params))
    _forward(mx, mod, x, y)
    monkeypatch.setattr(mx.amp, "cast_op_inputs", real)
    return log


@pytest.mark.parametrize("net", ["mlp", "conv"])
def test_cast_log_matches_jax_exactly(monkeypatch, net):
    build, shape = {"mlp": (_mlp_sym, (8,)),
                    "conv": (_conv_sym, (2, 6, 6))}[net]
    x, y = _data(8, shape)
    jmod = _module(jmx, build(jmx), x, y)
    params = _host_params(jmx, jmod)
    jlog = _cast_log(jmx, monkeypatch, build(jmx), x, y, params)
    tlog = _cast_log(tmx, monkeypatch, build(tmx), x, y, params)
    assert jlog and tlog == jlog
    ops = [op for op, _ in tlog]
    assert "Activation" not in ops or net == "mlp"   # the BN+ReLU fold
    assert dict(tlog)["FullyConnected"] == ("bfloat16",) * 3
    assert dict(tlog)["SoftmaxOutput"][0] == "float32"


def test_integer_inputs_are_never_cast():
    ids = torch.arange(4, dtype=torch.int32)
    for mx, f, i in ((tmx, torch.ones(4), ids),
                     (jmx, jmx.nd.ones((4,))._data,
                      jmx.nd.array(np.arange(4), dtype="int32")._data)):
        mx.amp.init("float16")
        out = mx.amp.cast_op_inputs("FullyConnected", [f, i])
        assert "float16" in str(out[0].dtype)
        assert "int32" in str(out[1].dtype)
        out = mx.amp.cast_op_inputs("softmax", [f.to(torch.float16)
                                                if mx is tmx else f, i])
        assert "float32" in str(out[0].dtype) and "int32" in str(out[1].dtype)
        mx.amp._reset_for_tests()


def test_amp_init_float32_is_bit_identical_noop():
    x, y = _data(16, (2, 6, 6))
    base_mod = _module(tmx, _conv_sym(tmx), x, y)
    base = _forward(tmx, base_mod, x, y, is_train=True)
    tmx.amp.init("float32")
    assert not tmx.amp.is_enabled()
    params = _as(tmx, _host_params(tmx, base_mod))
    mod = _module(tmx, _conv_sym(tmx), x, y, params)
    assert (_forward(tmx, mod, x, y, is_train=True) == base).all()
    assert tmx.amp.counters()["amp_cast_bytes_saved"] == 0


@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "torch"])
def test_policy_is_taken_when_the_plan_is_built(mx):
    x, y = _data(16)
    mod = _module(mx, _mlp_sym(mx), x, y)
    before = _forward(mx, mod, x, y)
    mx.amp.init("bfloat16")
    assert (_forward(mx, mod, x, y) == before).all()
    params = _as(mx, _host_params(mx, mod))
    fresh = _forward(mx, _module(mx, _mlp_sym(mx), x, y, params), x, y)
    assert not (fresh == before).all()
    assert mx.amp.counters()["amp_cast_bytes_saved"] > 0


def test_mxnet_amp_turns_amp_on_at_import():
    env = dict(os.environ, MXNET_AMP="1", MXNET_AMP_DTYPE="float16",
               PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", "import mxnet_tpu_torch as m;"
                        " print(m.amp.is_enabled(), m.amp.get_dtype())"],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=120)
    assert r.stdout.split() == ["True", "float16"], r.stderr


def _trainer(mx, dtype, n=2, **kw):
    if dtype == "float16" and "loss_scaler" not in kw:
        # 2^15 overflows this MLP's fp16 gradients on step one (a right
        # backoff that would offset the skip counts held here)
        kw["loss_scaler"] = mx.amp.DynamicLossScaler(init_scale=1024.0)
    if mx is tmx:
        from mxnet_tpu_torch.parallel import DataParallelTrainer
        from mxnet_tpu_torch.parallel.mesh import mesh_for_contexts
        mesh = mesh_for_contexts([tmx.cpu(i) for i in range(n)])
    else:
        import jax
        from mxnet_tpu.parallel import (DataParallelTrainer,
                                        data_parallel_mesh)
        mesh = data_parallel_mesh(n, jax.devices()[:n])
    tr = DataParallelTrainer(_mlp_sym(mx), mesh, optimizer="sgd",
                             learning_rate=0.1, momentum=0.9, dtype=dtype,
                             rescale_grad=1.0 / 16, **kw)
    state = tr.init_state({"data": (16, 8), "softmax_label": (16,)})
    return tr, state


def _ce(outs, y):
    p = np.asarray(outs[0].float() if torch.is_tensor(outs[0])
                   else outs[0], np.float32)
    return float(-np.log(p[np.arange(len(y)), y.astype(int)] + 1e-8).mean())


def test_bf16_mlp_converges_with_f32_masters():
    x, y = _data()
    tr, (params, states, aux) = _trainer(tmx, "bfloat16")
    inputs = tr.shard_inputs([x, y])
    ces = []
    for _ in range(30):
        params, states, aux, _, outs = tr.step(params, states, aux, inputs)
        ces.append(_ce(outs, y))
    assert ces[-1] < 0.75 * ces[0]
    assert all(p.dtype == torch.float32 for p in params)
    assert all(s.dtype == torch.float32 for st in states for s in st)


def test_fp16_skip_and_backoff_match_jax():
    x, y = _data()
    bad = x.copy()
    bad[0, 0] = np.inf
    got = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        tr, (params, states, aux) = _trainer(mx, "float16")
        inputs = tr.shard_inputs([x, y])
        params, states, aux, _, _ = tr.step(params, states, aux, inputs)
        before = [np.array(p) if name == "jax" else p.clone()
                  for p in list(params) + [s for st in states for s in st]]
        scale0 = tr.loss_scale
        params, states, aux, _, _ = tr.step(params, states, aux,
                                            tr.shard_inputs([bad, y]))
        after = list(params) + [s for st in states for s in st]
        if name == "torch":
            assert all(torch.equal(a, b) for a, b in zip(after, before))
        else:
            assert all((np.asarray(a) == b).all()
                       for a, b in zip(after, before))
        scales = [scale0, tr.loss_scale]
        ces = []
        for _ in range(20):
            params, states, aux, _, outs = tr.step(params, states, aux,
                                                   inputs)
            ces.append(_ce(outs, y))
        assert np.isfinite(ces).all() and ces[-1] < ces[0]
        got[name] = (scales, tr.skipped_steps, tr.loss_scale,
                     mx.amp.counters()["amp_skipped_steps"])
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [1024.0, 512.0] and got["torch"][1] == 1


def test_fp16_step_k_carries_the_scale():
    x, y = _data()
    xs = np.stack([x] * 4)
    xs[1, 0, 0] = np.inf
    ys = np.stack([y] * 4)
    tr, state = _trainer(tmx, "float16")
    params, states, aux, losses, _ = tr.step_k(
        *state, tr.shard_inputs([xs, ys], stacked=True))
    assert losses.shape == (4,)
    tr1, state1 = _trainer(tmx, "float16")
    p1, s1, a1 = state1
    for i in range(4):
        p1, s1, a1, _, _ = tr1.step(p1, s1, a1,
                                    tr1.shard_inputs([xs[i], ys[i]]))
    for a, b in zip(list(params) + [s for st in states for s in st],
                    list(p1) + [s for st in s1 for s in st]):
        assert torch.equal(a, b)
    assert (tr.loss_scale, tr.skipped_steps, tr._t_value()) == \
        (tr1.loss_scale, tr1.skipped_steps, tr1._t_value()) == (512.0, 1, 3.0)
    jtr, jstate = _trainer(jmx, "float16")
    jtr.step_k(*jstate, jtr.shard_inputs([xs, ys], stacked=True))
    assert (jtr.loss_scale, jtr.skipped_steps) == (512.0, 1)


def test_dynamic_loss_scaler_host_semantics():
    for mx in (jmx, tmx):
        s = mx.amp.DynamicLossScaler(init_scale=8.0, growth_interval=2)
        assert s.update(overflow=True) is False
        assert s.scale == 4.0
        assert s.update(overflow=False) is True
        assert s.update(overflow=False) is True
        assert s.scale == 8.0 and s.skipped_steps == 1
        s2 = mx.amp.DynamicLossScaler()
        s2.set_state(s.get_state())
        assert s2.get_state() == s.get_state()


def test_device_update_state_matches_jax():
    import jax.numpy as jnp
    kw = dict(init_scale=4.0, growth_interval=3, max_scale=16.0,
              min_scale=1.0)
    js, ts = jmx.amp.DynamicLossScaler(**kw), tmx.amp.DynamicLossScaler(**kw)
    jst, tst = jnp.asarray(js.state0()), ts.state0()
    for finite in [True, True, True, False, False, False, True, True, True,
                   True, True, True, True, True, True, True]:
        jst = js.update_state(jst, jnp.asarray(finite))
        tst = ts.update_state(tst, torch.tensor(finite))
        assert np.asarray(jst).tolist() == tst.tolist()


def test_multi_precision_on_by_default_under_amp():
    net = tmx.gluon.nn.Dense(4, in_units=4)
    net.initialize(ctx=tmx.cpu())
    assert not tmx.gluon.Trainer(net.collect_params(), "sgd") \
        ._optimizer.multi_precision
    tmx.amp.init("bfloat16")
    assert tmx.gluon.Trainer(net.collect_params(), "sgd") \
        ._optimizer.multi_precision
    assert not tmx.gluon.Trainer(net.collect_params(), "sgd",
                                 {"multi_precision": False}) \
        ._optimizer.multi_precision
    x, y = _data()
    mod = _module(tmx, _mlp_sym(tmx), x, y)
    mod.init_optimizer(optimizer="sgd")
    assert mod._optimizer.multi_precision


def test_bf16_weight_master_matches_jax():
    import jax.numpy as jnp
    rng = np.random.RandomState(3)
    w = rng.uniform(-1, 1, (4, 4)).astype(np.float32)
    g = rng.uniform(-1, 1, (4, 4)).astype(np.float32)
    masters = []
    for mx, w16 in ((jmx, jmx.nd.array(np.asarray(jnp.asarray(
            w, jnp.bfloat16)))), (tmx, tmx.nd.NDArray(
            torch.from_numpy(w).to(torch.bfloat16)))):
        opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                  multi_precision=True)
        state = opt.create_state_multi_precision(0, w16)
        grad = mx.nd.array(g, ctx=tmx.cpu()) if mx is tmx \
            else mx.nd.array(g)
        opt.update_multi_precision(0, w16, grad, state)
        assert "float32" in str(state[1].dtype)     # (momentum, master)
        masters.append(state[1].asnumpy())
    np.testing.assert_array_equal(masters[1], masters[0])


def _lm(mx):
    net = mx.gluon.nn.HybridSequential(prefix="lm_")
    with net.name_scope():
        net.add(mx.gluon.nn.TransformerEncoder(
            vocab_size=16, units=32, hidden_size=64, num_heads=4,
            num_layers=2, max_length=16),
            mx.gluon.nn.Dense(16, flatten=False))
    return net


def test_bf16_lm_through_fused_fit_matches_jax():
    from mxnet_tpu_torch.convert import load_gluon_params
    rng = np.random.RandomState(3)
    toks = rng.randint(0, 16, (4, 4, 17))
    data = {}
    for name, mx in (("jax", jmx), ("torch", tmx)):
        kw = {"ctx": tmx.cpu()} if mx is tmx else {}
        data[name] = [(mx.nd.array(t[:, :-1].astype(np.float32), **kw),
                       mx.nd.array(t[:, 1:].astype(np.float32), **kw))
                      for t in toks]
    jnet = _lm(jmx)
    jmx.random.seed(4)
    jnet.initialize(jmx.init.Xavier())
    jnet(data["jax"][0][0])
    weights = {n: p.data().asnumpy() for n, p in
               jnet.collect_params().items()}
    tnet = _lm(tmx)
    load_gluon_params(tnet, weights, ctx=tmx.cpu())
    losses = {}
    for name, mx, net in (("jax", jmx, jnet), ("torch", tmx, tnet)):
        mx.amp.init("bfloat16")
        net.hybridize()
        ctx = [tmx.cpu()] if mx is tmx else None
        losses[name] = mx.gluon.trainer.fused_fit(
            net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), data[name], 2,
            optimizer="adam", optimizer_params={"learning_rate": 1e-2},
            steps_per_dispatch=2, contexts=ctx)
        mx.amp._reset_for_tests()
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=LM_RTOL)
    assert losses["torch"][-1] < losses["torch"][0]
    # the masters stayed fp32; the fit's trainer ran in bf16
    assert all(p.data()._data.dtype == torch.float32
               for p in tnet.collect_params().values())


def test_selftest_subprocess():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.amp",
                        "--selftest", "--ctx", "cpu"], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["ok"] and rec["fp16_skipped_steps"] == 1
    r = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.amp",
                        "--hlo-check"], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 2 and "item 10" in r.stderr
