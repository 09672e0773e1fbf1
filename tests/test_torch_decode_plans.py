"""The decode engine's plans, config and pool bookkeeping against the JAX
package's (mxnet_tpu/serving/decode.py).

The JAX engine compiles one plan for the step and one for each prompt
bucket (``warmup=True``: the step and the smallest bucket at
construction). The port's engine captures a CUDA graph for each on the
card; on the CPU its plans call the model eagerly and are counted the
same way, which is what these tests hold against the JAX engine's counts.
Prefill through tensor slot / length indices must give the same bits as
through ints. No test here depends on timing: every submission is waited
for before the next count is read.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.serving import decode as JD
from mxnet_tpu.telemetry import devstats as jdevstats
from mxnet_tpu_torch.contrib.quantization import calibrate_weights
from mxnet_tpu_torch.serving.decode import (DecodeEngine, DecodeModel,
                                            SessionPool)
from mxnet_tpu_torch.telemetry import devstats

CFG = dict(vocab=48, layers=2, d_model=32, heads=4, kv_heads=2, d_ff=64,
           max_len=32)


@pytest.mark.parametrize("cfg", [
    CFG,
    dict(vocab=64, layers=1, d_model=64, heads=4, max_len=16),
    dict(vocab=50, layers=3, d_model=48, heads=6, kv_heads=3, d_ff=None,
         max_len=40),
], ids=["gqa", "mha_defaults", "ff_default"])
def test_config_round_trip_equals_jax(cfg):
    ours, ref = DecodeModel(**cfg).config(), JD.DecodeModel(**cfg).config()
    assert ours == ref
    assert DecodeModel.from_config(ours).config() == ref
    # an artifact's decode block carries param_names beside the config
    block = dict(ref, param_names=DecodeModel(**cfg).param_names())
    assert DecodeModel.from_config(block).config() == \
        JD.DecodeModel.from_config(block).config()


def test_from_config_passes_keywords_to_the_constructor():
    for cls in (DecodeModel, JD.DecodeModel):
        with pytest.raises(TypeError, match="bogus"):
            cls.from_config(CFG, bogus=1)
    # the JAX package's own keywords reach its constructor the same way
    assert JD.DecodeModel.from_config(CFG, matmul="xla").matmul == "xla"


class _S:
    """A stand-in session: the pool only reads and sets ``slot``."""

    def __init__(self, sid):
        self.sid, self.slot = sid, None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_active_sessions_match_jax(seed):
    rng = np.random.RandomState(seed)
    ours, ref = SessionPool(4, 32, 1024, 3), JD.SessionPool(4, 32, 1024, 3)
    sid = 0
    for _ in range(40):
        op = rng.randint(3)
        if op == 0:
            sid += 1
            try:
                ref.admit(_S(sid))
            except JD.SessionPoolFull:
                with pytest.raises(Exception, match="decode pool full"):
                    ours.admit(_S(sid))
                continue
            ours.admit(_S(sid))
        elif op == 1:
            assert [s.sid for s in ours.assign()] == \
                [s.sid for s in ref.assign()]
        elif ref.active_sessions():
            slot = sorted(ref.active_sessions())[
                rng.randint(len(ref.active_sessions()))]
            assert ours.retire(slot).sid == ref.retire(slot).sid
        got = {k: s.sid for k, s in ours.active_sessions().items()}
        assert got == {k: s.sid for k, s in ref.active_sessions().items()}
    # a copy: the caller cannot unbind a session through it
    ours.active_sessions().clear()
    assert ours.occupancy() == ref.occupancy()


def test_stats_keys_are_the_jax_engines_and_device():
    model = JD.DecodeModel(**CFG)
    params = model.init_params(seed=1)
    with JD.DecodeEngine(model, params, num_slots=2, name="pl-keys-j",
                         warmup=False) as je:
        ref = set(je.stats())
    with DecodeEngine(DecodeModel(**CFG), params, num_slots=2,
                      name="pl-keys-t", device="cpu") as te:
        ours = te.stats()
    assert set(ours) == ref | {"device"}
    assert ours["device"] == "cpu"


@pytest.mark.parametrize("lens", [
    [5], [5, 12], [12, 5, 30, 9], [30, 17, 3], [16, 8, 9, 31],
], ids=["b8", "b8_b16", "b16_b8_b32_b16", "b32_b32_b8", "b16_b8_b16_b32"])
def test_plan_compiles_match_jax(lens):
    model = JD.DecodeModel(**CFG)
    params = model.init_params(seed=2)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, CFG["vocab"], size=n).tolist() for n in lens]
    with JD.DecodeEngine(model, params, num_slots=2, name="pl-cnt-j") as je:
        ref = [je.plan_compiles]
        for p in prompts:
            je.generate(p, max_new_tokens=3)
            ref.append(je.plan_compiles)
        ref_steps = je.step_compiles
    with DecodeEngine(DecodeModel(**CFG), params, num_slots=2,
                      name="pl-cnt-t", device="cpu") as te:
        got = [te.plan_compiles]
        for p in prompts:
            te.generate(p, max_new_tokens=3)
            got.append(te.plan_compiles)
        assert te.stats()["plan_compiles"] == got[-1]
        steps = te.step_compiles
    assert got == ref
    assert steps == ref_steps == 1


def test_step_compiles_stays_one_through_occupancy_churn():
    model = DecodeModel(**CFG)
    params = model.init_params(seed=4)
    rng = np.random.RandomState(5)
    with DecodeEngine(model, params, num_slots=3, name="pl-churn",
                      device="cpu") as eng:
        sessions = []
        for i in range(9):
            p = rng.randint(0, CFG["vocab"], size=rng.randint(1, 20))
            sessions.append(eng.submit(p.tolist(),
                                       max_new_tokens=int(rng.randint(1, 9)),
                                       eos_id=int(rng.randint(CFG["vocab"]))
                                       if i % 3 == 0 else None))
        for s in sessions:
            s.result(timeout=120)
        # and once more alone, after the pool drained
        eng.generate([1, 2, 3], max_new_tokens=4)
        used = {eng._bucket_for(len(s.prompt)) for s in sessions} | {8}
        assert eng.step_compiles == 1
        assert eng.plan_compiles == 1 + len(used)
        assert sorted(eng._prefill_plans) == sorted(used)
        assert eng.pool.occupancy() == 0
        assert eng.stats()["step_executions"] == eng._step_plan.replays


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("slot,true_len", [(0, 1), (2, 5), (1, 8), (3, 3)])
def test_prefill_with_tensor_indices_is_bitwise_the_int_prefill(
        quant, slot, true_len):
    model = DecodeModel(**CFG)
    params = model.init_params(seed=6)
    if quant:
        params, _ = calibrate_weights(params, quant)
    model.load_params(params)
    rng = np.random.RandomState(true_len)
    toks = torch.zeros(1, 8, dtype=torch.int64)
    toks[0, :true_len] = torch.from_numpy(
        rng.randint(0, CFG["vocab"], size=true_len))
    kc_a, vc_a = model.init_cache(4, "cpu")
    kc_b, vc_b = model.init_cache(4, "cpu")
    _, _, tok_a, lg_a = model.prefill(kc_a, vc_a, toks, true_len, slot)
    _, _, tok_b, lg_b = model.prefill(
        kc_b, vc_b, toks.to(torch.int32),
        torch.tensor(true_len, dtype=torch.int32),
        torch.tensor(slot, dtype=torch.int32))
    assert int(tok_a) == int(tok_b)
    assert torch.equal(lg_a, lg_b)
    for a, b in zip(kc_a + vc_a, kc_b + vc_b):
        assert torch.equal(a, b)
    # only the slot's block was written
    others = [i for i in range(4) if i != slot]
    assert not kc_b[0][others].any() and kc_b[0][slot].any()


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_resident_bytes_add_up(quant):
    jmodel = JD.DecodeModel(**CFG)
    params = jmodel.init_params(seed=7)
    if quant:
        params, _ = calibrate_weights(params, quant)
        params = {k: v.numpy() if v.dtype != torch.float8_e4m3fn
                  else v.view(torch.uint8).numpy() for k, v in params.items()}
    with DecodeEngine(DecodeModel(**CFG), params, num_slots=3,
                      name=f"pl-res-{quant}", device="cpu") as te:
        st = te.stats()
        assert te.plan_resident_bytes == st["plan_resident_bytes"] == 0
        assert te.resident_bytes() == (st["kv_cache_bytes"]
                                       + st["params_bytes"]
                                       + st["plan_resident_bytes"])
        assert st["kv_cache_bytes"] == 3 * st["session_cache_bytes"]
        assert st["params_bytes"] == sum(
            np.asarray(v).nbytes for v in params.values())
    if quant != "fp8":    # the JAX engine takes fp8 only as e4m3fn arrays
        with JD.DecodeEngine(jmodel, params, num_slots=3,
                             name=f"pl-res-j-{quant}", warmup=False) as je:
            ref = je.stats()
        for key in ("kv_cache_bytes", "params_bytes", "session_cache_bytes"):
            assert st[key] == ref[key], key


def test_devstats_records_the_jax_engines_plans():
    model = JD.DecodeModel(**CFG)
    params = model.init_params(seed=8)
    prompts = [[1, 2, 3], list(range(1, 13)), list(range(2, 26))]
    with JD.DecodeEngine(model, params, num_slots=2, name="pl-dev") as je:
        for p in prompts:
            je.generate(p, max_new_tokens=2)
    with DecodeEngine(DecodeModel(**CFG), params, num_slots=2,
                      name="pl-dev", device="cpu") as te:
        for p in prompts:
            te.generate(p, max_new_tokens=2)
        names = [p["name"] for p in te.plans()]
    ref = {n: s for n, s in jdevstats.program_stats().items()
           if n.startswith("pl-dev.")}
    ours = {n: s for n, s in devstats.program_stats().items()
            if n.startswith("pl-dev.")}
    assert sorted(ours) == sorted(ref) == sorted(names) == [
        "pl-dev.prefill.b16", "pl-dev.prefill.b32", "pl-dev.prefill.b8",
        "pl-dev.step"]
    assert {s["kind"] for s in ours.values()} == \
        {s["kind"] for s in ref.values()} == {"serving"}
    # no graph on the CPU: no bytes, no launches
    assert all(s["peak_bytes"] == 0 and s["resident_bytes"] == 0
               for s in ours.values())
    assert devstats.counters()["recompiles"]["pl-dev.step"] == 1
    assert te.graph_launches() == {"captured": {}, "replayed": {}}


@pytest.mark.parametrize("need,resident,budget", [
    (3 << 20, 1 << 30, 1 << 30), (5 << 30, 0, 4 << 30), (100, 28, 127),
])
def test_preflight_refuses_as_the_jax_preflight(need, resident, budget):
    with pytest.raises(jdevstats.HBMPreflightError) as ref:
        jdevstats.preflight("e.step", need, resident_bytes=resident,
                            budget=budget, what="decode plan")
    with pytest.raises(devstats.HBMPreflightError) as ours:
        devstats.preflight("e.step", need, resident_bytes=resident,
                           budget=budget, what="decode plan")
    assert str(ours.value) == str(ref.value)
    assert devstats.preflight("e.step", need, resident_bytes=resident,
                              budget=need + resident) == \
        jdevstats.preflight("e.step", need, resident_bytes=resident,
                            budget=need + resident) == 0


def test_recompile_sentinel_warns_once_past_the_limit(monkeypatch, caplog):
    monkeypatch.setenv("MXNET_DEVSTATS_RECOMPILE_LIMIT", "2")
    storms = devstats.counters()["recompile_storms"]
    with caplog.at_level("WARNING", logger="mxnet_tpu_torch.devstats"):
        for _ in range(4):
            devstats.note_compile("pl-storm.step")
    assert devstats.counters()["recompiles"]["pl-storm.step"] == 4
    assert devstats.counters()["recompile_storms"] == storms + 1
    assert sum("recompile storm" in r.message for r in caplog.records) == 1
