"""The port's ``checkpoint`` against the JAX package's, on the CPU.

The JAX file's tests (tests/test_checkpoint.py) that one process can
run, on the port: the commit protocol (per-shard manifests, the
TOPOLOGY.json seal, no staging left), the port's own bfloat16 payload,
retention, the fall-back past a corrupt or missing shard, async saves
and the swept staging directory, split/whole placement, a shard-count
independent ``state_sha256``, I/O retries, format-1 directories,
``rescale_cursor``; bit-identical resume of ``Module.fit`` (per batch,
mid-epoch, fused with K = 2, across shard counts), of Gluon's
``fused_fit`` (fp32 and under amp bf16) and of the fp16 scaler's state;
SIGTERM's final checkpoint and exit 143; ``module_checkpoint(manager=)``,
the Gluon Trainer's ``save_checkpoint`` / ``restore_checkpoint``, a
capture that later steps do not change; and the SIGKILL-in-a-save
selftest in a subprocess.

Across the packages, from the same directory: the JAX package resumes a
port checkpoint and the port a JAX one (per batch and fused), each
continuation within 1e-5 of the writer's uninterrupted run, and both
packages' ``state_sha256`` of the restored state equal; the JAX key
under ``meta["rng"]`` is ignored by the port with a warning; the JAX
package's bfloat16 payload (an ``ml_dtypes`` pickle) is refused naming
the dtype.
"""
import json
import logging
import os
import pickle
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.parallel.planner import AUTO_KNOB_VARS
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.checkpoint import (CheckpointManager, TrainingState,
                                        capture_module_state,
                                        rescale_cursor, state_sha256)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROSS_RTOL = 1e-5


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


def _payload_files(step_dir):
    out = []
    for root, _dirs, files in os.walk(step_dir):
        out += [os.path.join(root, f) for f in files
                if f.startswith("arrays")]
    return sorted(out)


def _mlp_sym(mx):
    with mx.NameManager() if mx is tmx else jmx.base.NameManager():
        net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=16,
                                    name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
        return mx.sym.SoftmaxOutput(net, name="softmax")


def _train_iter(mx, n=40, batch=8, seed=42):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = rng.randint(0, 4, size=(n,)).astype(np.float32)
    return mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=False)


def _fit(ckpt_dir, num_epoch, resume=False, steps_per_dispatch=1, mx=tmx,
         **kw):
    np.random.seed(0)
    mx.random.seed(0)
    mod = mx.mod.Module(_mlp_sym(mx), context=mx.cpu(0))
    mod.fit(_train_iter(mx), num_epoch=num_epoch, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mx.init.Xavier(rnd_type="gaussian"),
            steps_per_dispatch=steps_per_dispatch,
            checkpoint_dir=ckpt_dir, resume=resume, **kw)
    return mod


def _params(mod):
    args, auxs = mod.get_params()
    return {n: a.asnumpy() for d in (args, auxs) for n, a in d.items()}


def _params_bytes(mod):
    return {n: np.ascontiguousarray(a).tobytes()
            for n, a in _params(mod).items()}


# -- the commit protocol -------------------------------------------------------

def test_atomic_commit_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, keep_last_n=0, async_save=False)
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    st = TrainingState(arrays={"param:w": w, "aux:m": w * 2},
                       opt_states={0: (tmx.nd.array(w, ctx=tmx.cpu()),)},
                       meta={"epoch": 1, "batch": 0, "step": 7})
    mgr.save(st, step=7, metric=0.5)
    assert sorted(os.listdir(d)) == ["step-0000000007"]
    step_dir = tmp_path / "ckpt" / "step-0000000007"
    topo = json.loads((step_dir / "TOPOLOGY.json").read_text())
    assert topo["step"] == 7 and topo["metric"] == 0.5
    assert topo["format"] == 2 and len(topo["shards"]) == mgr.num_shards
    for sname in topo["shards"]:
        assert (step_dir / sname / "MANIFEST.json").is_file()
    assert set(topo["shard_map"]) == {"param:w", "aux:m"}
    shard0 = f"shard-{0:05d}-of-{mgr.num_shards:05d}"
    assert "optimizer.bin" in json.loads(
        (step_dir / shard0 / "MANIFEST.json").read_text())["files"]
    place = topo["shard_map"]["param:w"]
    w_shard = f"shard-{place.get('shard', 0):05d}-of-{mgr.num_shards:05d}"
    # the container both packages read
    loaded = jmx.nd.load(str(step_dir / w_shard / "arrays.nd"))
    assert np.array_equal(loaded["param:w"].asnumpy(), w)
    back = mgr.restore()
    assert back.step == 7 and back.metric == 0.5
    assert np.array_equal(np.asarray(back.arrays["param:w"]), w)
    assert np.array_equal(back.arg_params_nd()["w"].asnumpy(), w)
    assert np.array_equal(back.aux_params_nd()["m"].asnumpy(), w * 2)
    # optimizer.bin in the JAX package's names: its plain pickle reads it
    states = pickle.loads(back.optimizer_bytes())
    assert np.array_equal(states[0][0].asnumpy(), w)
    mgr.close()


def test_bfloat16_payload_is_the_ports_own(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, async_save=False)
    w = torch.full((4,), 1.5, dtype=torch.bfloat16)
    mgr.save(TrainingState(arrays={"param:w": w, "param:f": np.ones(3)},
                           meta={"epoch": 0, "batch": 0, "step": 1}),
             step=1)
    payloads = _payload_files(os.path.join(d, "step-0000000001"))
    assert payloads and all(p.endswith(("arrays.raw", "arrays.nd"))
                            for p in payloads)
    back = mgr.restore()
    assert back.arrays["param:w"].dtype == torch.bfloat16
    assert torch.equal(back.arrays["param:w"], w)
    assert back.arrays["param:f"].dtype == np.float64
    mgr.close()


def test_jax_bfloat16_payload_is_refused_naming_the_dtype(tmp_path):
    import jax.numpy as jnp
    from mxnet_tpu.checkpoint import CheckpointManager as JManager
    from mxnet_tpu.checkpoint import TrainingState as JState
    d = str(tmp_path / "ckpt")
    jm = JManager(d, async_save=False)
    jm.save(JState(arrays={"param:w": np.asarray(
        jnp.full((4,), 1.5, jnp.bfloat16))},
        meta={"epoch": 0, "batch": 0, "step": 1}), step=1)
    jm.close()
    with pytest.raises(tmx.MXNetError, match="bfloat16"):
        CheckpointManager(d).restore()


def test_retention_keep_last_and_best_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep_last_n=2,
                            keep_best_k=1, async_save=False)
    for s, m in [(1, 0.1), (2, 0.9), (3, 0.3), (4, 0.2), (5, 0.4)]:
        mgr.save(TrainingState(arrays={"param:w": np.float32([s])},
                               meta={"epoch": s, "batch": 0, "step": s}),
                 step=s, metric=m)
    assert mgr.steps() == [2, 4, 5]
    assert mgr.counters()["ckpt_retained"] == 3
    mgr.close()


@pytest.mark.parametrize("damage", ["corrupt", "missing_file",
                                    "missing_dir"])
def test_damaged_newest_commit_falls_back(tmp_path, damage):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep_last_n=0,
                            async_save=False, num_shards=4)
    for s in (1, 2):
        mgr.save(TrainingState(
            arrays={"param:w": np.arange(8, dtype=np.float32) * s},
            meta={"epoch": s, "batch": 0, "step": s}), step=s)
    newest = tmp_path / "ckpt" / "step-0000000002"
    if damage == "corrupt":
        with open(_payload_files(newest)[0], "r+b") as f:
            f.write(b"garbage")
    elif damage == "missing_file":
        os.unlink(_payload_files(newest)[0])
    else:
        shutil.rmtree(newest / "shard-00002-of-00004")
    back = mgr.restore()
    assert back is not None and back.step == 1
    assert mgr.counters()["ckpt_fallback_total"] >= 1
    mgr.close()


def test_async_save_counters_and_staging_sweep(tmp_path):
    d = str(tmp_path / "ckpt")
    os.makedirs(os.path.join(d, ".staging-step-0000000009.12345"))
    mgr = CheckpointManager(d, async_save=True, keep_last_n=0)
    assert not [n for n in os.listdir(d) if n.startswith(".staging")]
    for s in range(1, 4):
        mgr.save(TrainingState(
            arrays={"param:w": np.zeros((64, 64), np.float32)},
            meta={"epoch": s, "batch": 0, "step": s}), step=s)
    mgr.wait()
    c = mgr.counters()
    assert c["ckpt_commits"] == 3 and c["ckpt_failures"] == 0
    assert c["ckpt_bytes"] > 3 * 64 * 64 * 4
    assert c["ckpt_save_us"] > 0 and c["ckpt_last_step"] == 3
    assert c["ckpt_overlap_frac"] is not None
    mgr.close()


def test_save_rejects_non_training_state(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    with pytest.raises(TypeError):
        mgr.save({"param:w": np.zeros(3)}, step=1)
    mgr.close()


def test_sharded_split0_and_whole_placement(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep_last_n=0,
                            async_save=False, num_shards=4)
    big = np.arange(16, dtype=np.float32).reshape(8, 2)
    odd = np.arange(6, dtype=np.float32).reshape(3, 2)
    mgr.save(TrainingState(arrays={"param:big": big, "param:odd": odd},
                           meta={"epoch": 0, "batch": 0, "step": 1}),
             step=1)
    step_dir = tmp_path / "ckpt" / "step-0000000001"
    topo = json.loads((step_dir / "TOPOLOGY.json").read_text())
    assert topo["shard_map"]["param:big"] == {"mode": "split0"}
    assert topo["shard_map"]["param:odd"]["mode"] == "whole"
    assert topo["topology"]["num_shards"] == 4
    for k in range(4):
        loaded = tmx.nd.load(str(step_dir / f"shard-{k:05d}-of-00004"
                                 / "arrays.nd"))
        assert np.array_equal(loaded["param:big"].asnumpy(),
                              big[2 * k:2 * k + 2])
    back = mgr.restore()
    assert np.array_equal(np.asarray(back.arrays["param:big"]), big)
    assert np.array_equal(np.asarray(back.arrays["param:odd"]), odd)
    mgr.close()


def test_state_sha256_is_shard_count_and_package_independent(tmp_path):
    from mxnet_tpu.checkpoint import CheckpointManager as JManager
    from mxnet_tpu.checkpoint import state_sha256 as jsha
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    b = np.float32([1.0, 2.0, 3.0])
    shas = set()
    for n in (1, 2, 8):
        d = str(tmp_path / f"ckpt{n}")
        mgr = CheckpointManager(d, keep_last_n=0, async_save=False,
                                num_shards=n)
        mgr.save(TrainingState(arrays={"param:w": w, "param:b": b},
                               opt_states={0: (torch.from_numpy(w),)},
                               meta={"epoch": 0, "batch": 0, "step": 1,
                                     "trainer": {"t": 3.0}}),
                 step=1)
        shas.add(state_sha256(mgr.restore()))
        shas.add(jsha(JManager(d).restore()))
        mgr.close()
    assert len(shas) == 1


def test_retention_counts_commits_not_shard_files(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep_last_n=2,
                            async_save=False, num_shards=4)
    for s in range(1, 6):
        mgr.save(TrainingState(
            arrays={"param:w": np.full((8, 2), s, np.float32)},
            meta={"epoch": s, "batch": 0, "step": s}), step=s)
    assert mgr.steps() == [4, 5]
    assert mgr.counters()["ckpt_retained"] == 2
    mgr.close()


@pytest.mark.parametrize("fails,retries,ok", [(2, 2, True), (3, 1, False)])
def test_transient_io_failures_retry(tmp_path, monkeypatch, fails, retries,
                                     ok):
    monkeypatch.setenv("MXNET_CHECKPOINT_INJECT_IO_FAIL", str(fails))
    monkeypatch.setenv("MXNET_CHECKPOINT_RETRIES", str(retries))
    monkeypatch.setenv("MXNET_CHECKPOINT_BACKOFF_S", "0.01")
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep_last_n=0,
                            async_save=False)
    st = TrainingState(arrays={"param:w": np.float32([1.0])},
                       meta={"epoch": 0, "batch": 0, "step": 1})
    if not ok:
        with pytest.raises(OSError):
            mgr.save(st, step=1)
        mgr.close()
        return
    mgr.save(st, step=1)
    c = mgr.counters()
    assert c["ckpt_commits"] == 1 and c["ckpt_retry_total"] == 2
    assert mgr.restore() is not None
    mgr.close()


def test_legacy_format1_dir_still_restores(tmp_path):
    import hashlib
    step_dir = tmp_path / "ckpt" / "step-0000000003"
    step_dir.mkdir(parents=True)
    payload = pickle.dumps({"param:w": np.float32([7.0, 8.0])})
    (step_dir / "arrays.pkl").write_bytes(payload)
    (step_dir / "MANIFEST.json").write_text(json.dumps({
        "format": 1, "step": 3, "metric": 0.25,
        "meta": {"epoch": 1, "batch": 0, "step": 3},
        "files": {"arrays.pkl": {
            "sha256": hashlib.sha256(payload).hexdigest(),
            "bytes": len(payload)}}}))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    assert mgr.steps() == [3]
    back = mgr.restore()
    assert back.step == 3 and back.metric == 0.25
    assert np.array_equal(np.asarray(back.arrays["param:w"]),
                          np.float32([7.0, 8.0]))
    assert tmx.checkpoint.last_sealed_commit(str(tmp_path / "ckpt"))[
        "sealed"] == "MANIFEST.json"
    mgr.close()


def test_rescale_cursor_maps_samples_not_batches():
    from mxnet_tpu.checkpoint import rescale_cursor as jrescale
    for meta, bs in [({"batch": 3, "batch_size": 8}, 8), ({"batch": 3}, 8),
                     ({"batch": 3, "batch_size": 8}, None),
                     ({"batch": 3, "batch_size": 8}, 4),
                     ({"batch": 6, "batch_size": 4}, 8),
                     ({"batch": 5, "batch_size": 6}, 8)]:
        assert rescale_cursor(meta, bs) == jrescale(meta, bs)
    assert rescale_cursor({"batch": 5, "batch_size": 6}, 8) == 3


# -- resume --------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2], ids=["per_batch", "fused"])
def test_resume_across_shard_counts_bit_identical(tmp_path, monkeypatch, k):
    base = _fit(str(tmp_path / "base"), 4, steps_per_dispatch=k)
    monkeypatch.setenv("MXNET_CHECKPOINT_SHARDS", "8")
    _fit(str(tmp_path / "split"), 2, steps_per_dispatch=k)
    monkeypatch.setenv("MXNET_CHECKPOINT_SHARDS", "2")
    resumed = _fit(str(tmp_path / "split"), 4, resume=True,
                   steps_per_dispatch=k)
    assert _params_bytes(base) == _params_bytes(resumed)
    mgr = CheckpointManager(str(tmp_path / "split"))
    assert mgr.latest_step() == 20
    st = mgr.restore()
    assert st.meta["epoch"] == 4 and st.meta["batch"] == 0
    assert st.meta["kind"] == ("module" if k == 1 else "module_fused")
    if k == 2:
        assert st.meta["trainer"]["t"] == 20.0
        assert st.meta["batch_size"] == 8
    mgr.close()


def test_mid_epoch_cursor_resume_bit_identical(tmp_path):
    base = _fit(str(tmp_path / "base"), 4)
    _fit(str(tmp_path / "split"), 2, checkpoint_period=3)
    mgr = CheckpointManager(str(tmp_path / "split"))
    st = mgr.restore(step=8)            # epoch 1, batch 3
    assert st.meta["epoch"] == 1 and st.meta["batch"] == 3
    mgr.close()
    shutil.rmtree(tmp_path / "split" / "step-0000000010")
    resumed = _fit(str(tmp_path / "split"), 4, resume=True)
    assert _params_bytes(base) == _params_bytes(resumed)


def test_fused_bf16_amp_resume_bit_identical(tmp_path):
    tmx.amp.init("bfloat16")
    base = _fit(str(tmp_path / "base"), 4, steps_per_dispatch=2)
    _fit(str(tmp_path / "split"), 2, steps_per_dispatch=2)
    resumed = _fit(str(tmp_path / "split"), 4, resume=True,
                   steps_per_dispatch=2)
    assert _params_bytes(base) == _params_bytes(resumed)
    mgr = CheckpointManager(str(tmp_path / "split"))
    assert mgr.restore().meta["amp_dtype"] == "bfloat16"
    mgr.close()


def _gluon_lm(mx):
    net = mx.gluon.nn.HybridSequential(prefix="lm_")
    with net.name_scope():
        net.add(mx.gluon.nn.TransformerEncoder(
            vocab_size=16, units=32, hidden_size=64, num_heads=4,
            num_layers=2, max_length=16),
            mx.gluon.nn.Dense(16, flatten=False))
    return net


def _lm_data(mx, n=4, batch=4, seq=16):
    rng = np.random.RandomState(3)
    t = rng.randint(0, 16, (n, batch, seq + 1))
    return [(mx.nd.array(b[:, :-1].astype(np.float32), ctx=mx.cpu()),
             mx.nd.array(b[:, 1:].astype(np.float32), ctx=mx.cpu()))
            for b in t]


def _gluon_fused(ckpt_dir, epochs, weights, resume=False):
    from mxnet_tpu_torch.convert import load_gluon_params
    net = _gluon_lm(tmx)
    load_gluon_params(net, weights, ctx=tmx.cpu())
    net.hybridize()
    with tmx.cpu():
        losses = tmx.gluon.trainer.fused_fit(
            net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), _lm_data(tmx),
            epochs, optimizer="adam",
            optimizer_params={"learning_rate": 1e-2}, steps_per_dispatch=2,
            checkpoint_dir=ckpt_dir, checkpoint_period=2, resume=resume)
    return losses, {n: p.data().asnumpy().tobytes()
                    for n, p in net.collect_params().items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gluon_fused_fit_resume_bit_identical(tmp_path, dtype):
    if dtype != "float32":
        tmx.amp.init(dtype)
    net = _gluon_lm(tmx)
    with tmx.cpu():
        net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
        net(_lm_data(tmx)[0][0])
    weights = {n: p.data().asnumpy() for n, p in
               net.collect_params().items()}
    base_losses, base = _gluon_fused(str(tmp_path / "base"), 2, weights)
    _gluon_fused(str(tmp_path / "split"), 1, weights)
    losses, resumed = _gluon_fused(str(tmp_path / "split"), 2, weights,
                                   resume=True)
    assert resumed == base
    assert losses == base_losses[1:]
    st = CheckpointManager(str(tmp_path / "split")).restore()
    assert st.meta["kind"] == "gluon_fused" and st.meta["epoch"] == 2
    assert st.meta["amp_dtype"] == (None if dtype == "float32" else dtype)
    assert st.meta["trainer"]["t"] == 8.0     # 4 batches x 2 epochs


def test_sigterm_preemption_saves_and_exits_143(tmp_path):
    d = str(tmp_path / "ckpt")
    np.random.seed(0)
    tmx.random.seed(0)
    mod = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu(0))
    fired = []

    def _kick(param):
        if param.nbatch == 1 and not fired:
            fired.append(True)
            os.kill(os.getpid(), signal.SIGTERM)

    with pytest.raises(SystemExit) as exc:
        mod.fit(_train_iter(tmx), num_epoch=4, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                initializer=tmx.init.Xavier(rnd_type="gaussian"),
                batch_end_callback=_kick, checkpoint_dir=d)
    assert exc.value.code == 143
    mgr = CheckpointManager(d)
    st = mgr.restore()
    assert st is not None and st.meta["batch"] > 0
    mgr.close()
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL,
                                                signal.default_int_handler)


def test_fp16_scaler_counters_survive_roundtrip():
    from mxnet_tpu_torch.parallel import DataParallelTrainer
    from mxnet_tpu_torch.parallel.mesh import mesh_for_contexts

    def _tr():
        return DataParallelTrainer(
            _mlp_sym(tmx), mesh_for_contexts([tmx.cpu(0)]),
            optimizer="sgd", learning_rate=0.1, momentum=0.9,
            dtype="float16", rescale_grad=1.0 / 16,
            loss_scaler=tmx.amp.DynamicLossScaler(init_scale=1024.0))

    rng = np.random.RandomState(0)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    y = rng.randint(0, 4, size=(16,)).astype(np.float32)
    tr = _tr()
    params, states, aux = tr.init_state({"data": (16, 8),
                                         "softmax_label": (16,)})
    inputs = tr.shard_inputs([x, y])
    params, states, aux, _, _ = tr.step(params, states, aux, inputs)
    bad = x.copy()
    bad[0, 0] = np.inf
    params, states, aux, _, _ = tr.step(params, states, aux,
                                        tr.shard_inputs([bad, y]))
    assert tr.loss_scale == 512.0 and tr.skipped_steps == 1
    arrays, meta = tr.export_training_state(params, states, aux)
    assert meta["loss_scaler"][0] == 512.0 and meta["loss_scaler"][2] == 1.0
    assert meta["rng"] is None
    tr2 = _tr()
    tr2.init_state({"data": (16, 8), "softmax_label": (16,)})
    p2, s2, a2 = tr2.import_training_state(arrays, meta)
    assert tr2.loss_scale == 512.0 and tr2.skipped_steps == 1
    params, states, aux, _, _ = tr.step(params, states, aux, inputs)
    p2, s2, a2, _, _ = tr2.step(p2, s2, a2, tr2.shard_inputs([x, y]))
    for a, b in zip(params, p2):
        assert torch.equal(a, b)
    assert tr.loss_scale == tr2.loss_scale


def test_capture_module_state_is_consistent_snapshot():
    np.random.seed(0)
    tmx.random.seed(0)
    mod = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu(0))
    it = _train_iter(tmx)
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=tmx.init.Xavier(rnd_type="gaussian"))
    st = capture_module_state(mod, epoch=1)
    frozen = st.arg_params_nd()["fc1_weight"].asnumpy().copy()
    opt = st.optimizer_bytes()
    st2 = capture_module_state(mod, epoch=1)
    it.reset()
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            force_init=False)
    assert not np.array_equal(
        mod.get_params()[0]["fc1_weight"].asnumpy(), frozen)
    assert np.array_equal(st.arg_params_nd()["fc1_weight"].asnumpy(),
                          frozen)
    # the optimizer states were copied too: the second capture serializes
    # after the steps and still gives the first one's bytes
    assert st2.optimizer_bytes() == opt


def test_module_checkpoint_callback_persists_states(tmp_path):
    prefix = str(tmp_path / "cb")
    np.random.seed(0)
    tmx.random.seed(0)
    mod = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu(0))
    cb = tmx.callback.module_checkpoint(mod, prefix,
                                        save_optimizer_states=True)
    mod.fit(_train_iter(tmx), num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=tmx.init.Xavier(rnd_type="gaussian"),
            epoch_end_callback=cb)
    assert os.path.exists(prefix + "-0002.states")
    mod2 = tmx.mod.Module(_mlp_sym(tmx), context=tmx.cpu(0))
    mgr = CheckpointManager(str(tmp_path / "mgr"))
    cb2 = tmx.callback.module_checkpoint(mod2, prefix, manager=mgr)
    mod2.fit(_train_iter(tmx), num_epoch=2, optimizer="sgd",
             optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
             initializer=tmx.init.Xavier(rnd_type="gaussian"),
             epoch_end_callback=cb2)
    st = mgr.restore()
    assert st is not None and st.optimizer_bytes() is not None
    assert np.array_equal(st.arg_params_nd()["fc1_weight"].asnumpy(),
                          mod2.get_params()[0]["fc1_weight"].asnumpy())
    mgr.close()


def test_gluon_trainer_checkpoint_roundtrip(tmp_path):
    net = tmx.gluon.nn.Dense(4, in_units=8)
    net.initialize(ctx=tmx.cpu())
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9})
    x = tmx.nd.array(np.random.RandomState(1).normal(size=(8, 8)),
                     ctx=tmx.cpu())

    def step():
        with tmx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        trainer.step(8)

    for _ in range(3):
        step()
    d = str(tmp_path / "ckpt")
    trainer.save_checkpoint(d, step=3)
    want = {p.name: p.data().asnumpy().copy() for p in trainer._params}
    step()
    after = {p.name: p.data().asnumpy().copy() for p in trainer._params}
    for p in trainer._params:
        p.set_data(tmx.nd.zeros(p.data().shape, ctx=tmx.cpu()))
    trainer._updaters[0].states.clear()
    assert trainer.restore_checkpoint(d) == 3
    for p in trainer._params:
        assert np.array_equal(p.data().asnumpy(), want[p.name])
    assert trainer._optimizer.momentum == 0.9
    step()          # the momentum came back: the same fourth step
    for p in trainer._params:
        assert np.array_equal(p.data().asnumpy(), after[p.name])


def test_crash_injection_selftest_subprocess():
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    p = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.checkpoint", "--selftest",
         "--points", "mid-arrays", "--fused", "--ctx", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert p.returncode == 0, p.stdout + p.stderr
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    assert rec["ok"] and rec["mid_arrays_bit_identical"]
    assert rec["mid_arrays_latest"] == 10


# -- across the packages ------------------------------------------------------

def _close(got, want):
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=CROSS_RTOL,
                                   atol=CROSS_RTOL * np.abs(want[n]).max(),
                                   err_msg=n)


@pytest.mark.parametrize("k", [1, 2], ids=["per_batch", "fused"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, caplog, k):
    from mxnet_tpu.checkpoint import CheckpointManager as JManager
    from mxnet_tpu.checkpoint import state_sha256 as jsha
    d = str(tmp_path / "jax")
    want = _params(_fit(str(tmp_path / "base"), 4, mx=jmx,
                        steps_per_dispatch=k))
    _fit(d, 2, mx=jmx, steps_per_dispatch=k)
    assert jsha(JManager(d).restore()) == state_sha256(
        CheckpointManager(d).restore())
    with caplog.at_level(logging.WARNING):
        got = _params(_fit(d, 4, resume=True, steps_per_dispatch=k))
    assert any("JAX package's key" in r.getMessage()
               for r in caplog.records)
    _close(got, want)


@pytest.mark.parametrize("k", [1, 2], ids=["per_batch", "fused"])
def test_port_checkpoint_resumes_in_jax(tmp_path, k):
    from mxnet_tpu.checkpoint import CheckpointManager as JManager
    from mxnet_tpu.checkpoint import state_sha256 as jsha
    d = str(tmp_path / "port")
    want = _params(_fit(str(tmp_path / "base"), 4, steps_per_dispatch=k))
    _fit(d, 2, steps_per_dispatch=k)
    st = CheckpointManager(d).restore()
    assert st.meta["rng"] is None and st.meta["torch_rng"] is not None
    assert jsha(JManager(d).restore()) == state_sha256(st)
    got = _params(_fit(d, 4, resume=True, mx=jmx, steps_per_dispatch=k))
    _close(got, want)
