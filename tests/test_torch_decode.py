"""mxnet_tpu_torch.serving.decode against the JAX package's decode slice.

Both packages start from the same numpy params (``init_params`` shares
its recipe) and the same prompts. The JAX side runs its Pallas kernels
under the interpreter (``DecodeModel(attention="interpret",
matmul="interpret")``); the port runs its plain versions on the CPU.
Logit tolerance is rtol/atol 1e-4 in float32, as tests/test_decode.py
holds incremental decode against full-context recompute: two layers of
float32 matmuls, norms and softmaxes summed in another order.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.serving import decode as JD
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib.quantization import calibrate_weights
from mxnet_tpu_torch.serving.decode import (DecodeEngine, DecodeModel,
                                            SessionPool, SessionPoolFull,
                                            _selftest, prompt_buckets)
from mxnet_tpu_torch.telemetry import devstats

CFG = dict(vocab=48, layers=2, d_model=32, heads=4, kv_heads=2, d_ff=64,
           max_len=32)
TOL = dict(rtol=1e-4, atol=1e-4)


def _model(**kw):
    return DecodeModel(**dict(CFG, **kw))


def _pad(prompt, bucket):
    out = np.zeros((1, bucket), np.int32)
    out[0, :len(prompt)] = prompt
    return out


def _port_stream(model, prompt, n_new, num_slots=2):
    """Incremental decode through the port: one prefill, then steps."""
    kc, vc = model.init_cache(num_slots, "cpu")
    kc, vc, tok0, logits0 = model.prefill(
        kc, vc, torch.from_numpy(_pad(prompt, 8)), len(prompt), 0)
    toks, logits = [int(tok0)], [logits0.numpy()]
    tokens = torch.zeros(num_slots, dtype=torch.int32)
    lengths = torch.zeros(num_slots, dtype=torch.int32)
    active = torch.zeros(num_slots, dtype=torch.bool)
    tokens[0], lengths[0], active[0] = int(tok0), len(prompt), True
    for _ in range(n_new - 1):
        kc, vc, tokens, lengths, lg = model.step(kc, vc, tokens, lengths,
                                                 active)
        toks.append(int(tokens[0]))
        logits.append(lg[0].numpy())
    return toks, logits


def _jax_stream(model, params, prompt, n_new, num_slots=2):
    kc, vc = model.init_cache(num_slots)
    kc, vc, tok0, logits0 = model.prefill(params, kc, vc, _pad(prompt, 8),
                                          len(prompt), 0)
    toks, logits = [int(tok0)], [np.asarray(logits0)]
    tokens = np.zeros(num_slots, np.int32)
    lengths = np.zeros(num_slots, np.int32)
    active = np.zeros(num_slots, bool)
    tokens[0], lengths[0], active[0] = int(tok0), len(prompt), True
    for _ in range(n_new - 1):
        kc, vc, nxt, lengths, lg = model.step(params, kc, vc, tokens,
                                              lengths, active)
        tokens = np.asarray(nxt)
        toks.append(int(tokens[0]))
        logits.append(np.asarray(lg)[0])
    return toks, logits


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_prefill_and_steps_match_jax_logits(quant):
    jmodel = JD.DecodeModel(**CFG, attention="interpret",
                            matmul="interpret")
    params = jmodel.init_params(seed=5)
    prompt, n_new = [3, 17, 29, 8, 41], 4
    if quant:
        from mxnet_tpu.contrib.quantization import calibrate_weights as jcal
        params, _ = jcal(params, quant)
    j_toks, j_logits = _jax_stream(jmodel, params, prompt, n_new)
    t_toks, t_logits = _port_stream(_model().load_params(params), prompt,
                                    n_new)
    assert t_toks == j_toks
    for got, ref in zip(t_logits, j_logits):
        np.testing.assert_allclose(got, ref, **TOL)


def test_port_calibration_serves_like_jax_calibration():
    # calibrating in the port gives the bytes the JAX package gives, so
    # the quantized model decodes to the same logits
    jmodel = JD.DecodeModel(**CFG)
    params = jmodel.init_params(seed=8)
    from mxnet_tpu.contrib.quantization import calibrate_weights as jcal
    jq, _ = jcal(params, "int8")
    tq, _ = calibrate_weights(params, "int8")
    prompt = [1, 2, 3]
    a = _port_stream(_model().load_params(jq), prompt, 3)
    b = _port_stream(_model().load_params(tq), prompt, 3)
    assert a[0] == b[0]
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)


def _recompute_stream(model, prompt, n_new):
    """Greedy decode by FULL-CONTEXT recompute: each token re-runs
    prefill on everything so far in a fresh cache."""
    toks, out, logits_seq = list(prompt), [], []
    for _ in range(n_new):
        kc, vc = model.init_cache(1, "cpu")
        bucket = next(b for b in prompt_buckets(model.max_len)
                      if b >= len(toks))
        _, _, tok, logits = model.prefill(
            kc, vc, torch.from_numpy(_pad(toks, bucket)), len(toks), 0)
        out.append(int(tok))
        logits_seq.append(logits.numpy())
        toks.append(int(tok))
    return out, logits_seq


def test_decode_matches_full_context_recompute():
    model = _model()
    model.load_params(model.init_params(seed=5))
    prompt = [3, 17, 29, 8, 41]
    ref_toks, ref_logits = _recompute_stream(model, prompt, 6)
    toks, logits = _port_stream(model, prompt, 6)
    assert toks == ref_toks
    for got, ref in zip(logits, ref_logits):
        np.testing.assert_allclose(got, ref, **TOL)


def test_coresident_sessions_do_not_perturb_logits_bitwise():
    model = _model()
    model.load_params(model.init_params(seed=9))
    p0, others = [5, 11, 2], ([7, 7, 30, 4], [1], [44, 20])

    def prefill(kc, vc, p, slot):
        return model.prefill(kc, vc, torch.from_numpy(_pad(p, 8)), len(p),
                             slot)

    kc, vc = model.init_cache(4, "cpu")
    kc, vc, tok0, _ = prefill(kc, vc, p0, 0)
    ka, va = [t.clone() for t in kc], [t.clone() for t in vc]
    tokens = torch.tensor([int(tok0), 0, 0, 0], dtype=torch.int32)
    lengths = torch.tensor([len(p0), 0, 0, 0], dtype=torch.int32)
    active = torch.tensor([True, False, False, False])
    _, _, nxt_a, len_a, log_a = model.step(ka, va, tokens, lengths, active)

    kb, vb = kc, vc
    for slot, p in enumerate(others, start=1):
        kb, vb, _, _ = prefill(kb, vb, p, slot)
    tokens_b = torch.tensor([int(tok0), 9, 3, 27], dtype=torch.int32)
    lengths_b = torch.tensor([len(p0)] + [len(p) for p in others],
                             dtype=torch.int32)
    _, _, nxt_b, len_b, log_b = model.step(kb, vb, tokens_b, lengths_b,
                                           torch.ones(4, dtype=torch.bool))
    assert torch.equal(log_a[0], log_b[0])
    assert int(nxt_a[0]) == int(nxt_b[0])
    assert int(len_a[0]) == int(len_b[0])
    # inactive rows pass their token and length through
    assert nxt_a[1:].tolist() == [0, 0, 0] and len_a[1:].tolist() == [0] * 3


def test_step_clips_position_at_max_len():
    # a row at lengths == max_len writes position max_len-1 and attends
    # over max_len positions, as the JAX step does
    model = _model(max_len=16)
    params = model.init_params(seed=3)
    model.load_params(params)
    jmodel = JD.DecodeModel(**dict(CFG, max_len=16))
    kc, vc = model.init_cache(2, "cpu")
    jkc, jvc = jmodel.init_cache(2)
    toks = np.array([4, 9], np.int32)
    lens = np.array([16, 5], np.int32)
    act = np.array([True, True])
    _, _, t_nxt, t_len, t_log = model.step(
        kc, vc, torch.from_numpy(toks), torch.from_numpy(lens),
        torch.from_numpy(act))
    _, _, j_nxt, j_len, j_log = jmodel.step(params, jkc, jvc, toks, lens,
                                            act)
    assert t_len.tolist() == np.asarray(j_len).tolist() == [16, 6]
    assert t_nxt.tolist() == np.asarray(j_nxt).tolist()
    np.testing.assert_allclose(t_log.numpy(), np.asarray(j_log), **TOL)


def test_pool_full_admission_is_sized_507():
    pool = SessionPool(num_slots=1, max_len=32, session_bytes=4096,
                       queue_depth=1)

    class _S:
        slot = None

    pool.admit(_S())
    assert pool.assign()
    pool.admit(_S())
    with pytest.raises(SessionPoolFull) as ei:
        pool.admit(_S())
    assert isinstance(ei.value, devstats.HBMPreflightError)
    assert "4096" in str(ei.value)
    assert pool.rejected == 1


def test_engine_preflight_rejects_pool_over_budget(monkeypatch):
    monkeypatch.setenv("MXNET_DEVSTATS_HBM_BYTES", "1024")
    model = _model()
    with pytest.raises(devstats.HBMPreflightError, match="over by"):
        DecodeEngine(model, model.init_params(seed=1), num_slots=2,
                     device="cpu")


def test_retirement_frees_block_for_next_session():
    model = _model(max_len=16)
    eng = DecodeEngine(model, model.init_params(seed=2), num_slots=2,
                       name="t-retire", device="cpu")
    try:
        free0 = list(eng.pool._free)
        out = eng.generate([4, 9, 13], max_new_tokens=5)
        assert len(out) == 5
        stopped = eng.generate([4, 9, 13], max_new_tokens=5,
                               eos_id=out[1])
        assert stopped == out[:2]
        capped = eng.generate([1, 2, 3, 4, 5, 6], max_new_tokens=100)
        assert len(capped) == model.max_len - 6 + 1
        assert eng.pool.occupancy() == 0
        assert eng.pool.retired == 3
        assert sorted(eng.pool._free) == sorted(free0)
    finally:
        eng.close()


def test_engine_streams_match_jax_engine():
    jmodel = JD.DecodeModel(**CFG)
    params = jmodel.init_params(seed=4)
    prompts = [[3, 30, 12, 8], [1], [7, 7, 7, 7, 7, 7, 7, 7, 7, 40]]
    with JD.DecodeEngine(jmodel, params, num_slots=3, name="j-eng",
                         warmup=False) as je:
        ref = [je.generate(p, max_new_tokens=6) for p in prompts]
    with DecodeEngine(_model(), params, num_slots=3, name="t-eng",
                      device="cpu") as te:
        sess = [te.submit(p, max_new_tokens=6, keep_logits=True)
                for p in prompts]
        got = [s.result(timeout=60) for s in sess]
        stats = te.stats()
    assert got == ref
    assert all(len(s.logits) == 6 and len(s.t_emit) == 6 for s in sess)
    assert stats["tokens_generated"] == 18
    assert stats["prefill_executions"] == 3


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_jax_exported_artifact_serves_same_stream(tmp_path, quant):
    from mxnet_tpu.contrib.export import export_decode_model
    from mxnet_tpu.contrib.quantization import quantize_decode_artifact
    jmodel = JD.DecodeModel(**CFG)
    params = jmodel.init_params(seed=7)
    path = str(tmp_path / "dec_f32.mxa")
    export_decode_model(path, jmodel.config(), params, model_name="t-dec")
    if quant:
        qpath = str(tmp_path / f"dec_{quant}.mxa")
        quantize_decode_artifact(path, qpath, dtype=quant)
        path = qpath
    prompt = [3, 30, 12, 8]
    with JD.DecodeEngine(path, num_slots=2, name="j-mxa",
                         warmup=False) as je:
        ref = je.generate(prompt, max_new_tokens=8)
    with DecodeEngine(path, num_slots=2, device="cpu") as te:
        assert te.name == "t-dec"
        if quant:
            assert "l0.wq__scale" in te._names
            assert te.model.get_parameter("l0.wq").dtype == (
                torch.int8 if quant == "int8" else torch.float8_e4m3fn)
        got = te.generate(prompt, max_new_tokens=8)
    assert got == ref


def test_load_params_names_and_errors():
    model = _model()
    params = model.init_params(seed=0)
    model.load_params(params)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(model.param_names())
    with pytest.raises(MXNetError, match="missing"):
        _model().load_params({k: v for k, v in params.items()
                              if k != "head"})
    with pytest.raises(MXNetError, match="unknown"):
        _model().load_params(dict(params, bogus=np.ones(2, np.float32)))
    # reloading replaces: quantized companions appear, float ones go
    q, _ = calibrate_weights(params, "int8")
    model.load_params(q)
    assert model.get_parameter("l1.w2").dtype == torch.int8
    model.load_params(params)
    assert "l1.w2__scale" not in dict(model.named_parameters())


def test_selftest_streams_identical_on_cpu():
    out = _selftest(sessions=4, new_tokens=6, device="cpu")
    assert out["identical"] and out["device"] == "cpu"
