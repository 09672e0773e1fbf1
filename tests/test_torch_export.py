"""The write side of the decode ``.mxa`` (mxnet_tpu_torch.contrib.export,
contrib.quantization) against the JAX package's.

From the same numpy params the two packages must write the same manifest
and the same ``params.bin`` bytes; an int8/fp8 artifact the port writes
must load in the JAX package and serve the same token streams in both
engines, and the reverse. The quantization command line must exit 0 and
print its JSON line.
"""
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from mxnet_tpu.contrib.export import export_decode_model as j_export
from mxnet_tpu.contrib.quantization import \
    quantize_decode_artifact as j_quantize
from mxnet_tpu.serving import decode as JD
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib.export import export_decode_model
from mxnet_tpu_torch.contrib.quantization import quantize_decode_artifact
from mxnet_tpu_torch.convert import load_decode_artifact
from mxnet_tpu_torch.serving.decode import DecodeEngine, DecodeModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab=48, layers=2, d_model=32, heads=4, kv_heads=2, d_ff=64,
           max_len=32)
CFGS = {"gqa": CFG,
        "mha": dict(vocab=40, layers=1, d_model=64, heads=2, max_len=16)}
PROMPT = [3, 30, 12, 8]


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return zf.read("MANIFEST.json"), zf.read("params.bin")


def _params(cfg, seed=7):
    return JD.DecodeModel(**cfg).init_params(seed=seed)


@pytest.mark.parametrize("as_tensors", [False, True],
                         ids=["numpy", "tensors"])
@pytest.mark.parametrize("name", [None, "dec-model"])
@pytest.mark.parametrize("cfg", sorted(CFGS))
def test_float_artifact_is_the_jax_artifact(tmp_path, cfg, name, as_tensors):
    params = _params(CFGS[cfg])
    ours = dict(params)
    if as_tensors:
        ours = {k: torch.from_numpy(v) for k, v in params.items()}
    config = JD.DecodeModel(**CFGS[cfg]).config()
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    ref = j_export(str(tmp_path / "j" / "dec.mxa"), config, params,
                   model_name=name)
    got = export_decode_model(str(tmp_path / "t" / "dec.mxa"),
                              DecodeModel(**CFGS[cfg]).config(), ours,
                              model_name=name)
    (m_ref, p_ref), (m_got, p_got) = _members(ref), _members(got)
    assert m_got == m_ref
    assert p_got == p_ref
    manifest = json.loads(m_got)
    assert manifest["model_name"] == (name or "dec")
    assert manifest["devstats"]["params_bytes"] == sum(
        v.nbytes for v in params.values())


def test_float64_params_are_stored_as_float32(tmp_path):
    params = _params(CFG)
    wide = {k: v.astype(np.float64) for k, v in params.items()}
    export_decode_model(str(tmp_path / "a.mxa"), CFG, wide)
    j_export(str(tmp_path / "b.mxa"), CFG, params, model_name="a")
    assert _members(tmp_path / "a.mxa") == _members(tmp_path / "b.mxa")


def _strip_stats(manifest):
    m = json.loads(manifest)
    stats = m["quant"].pop("stats")
    return m, stats


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("route", ["export", "cli_core"])
def test_quantized_artifact_is_the_jax_artifact(tmp_path, dtype, route):
    params = _params(CFG, seed=3)
    if route == "export":
        ours = export_decode_model(str(tmp_path / "t.mxa"), CFG, params,
                                   model_name="q", quantize=dtype)
        ref = j_export(str(tmp_path / "j.mxa"), CFG, params,
                       model_name="q", quantize=dtype)
    else:
        j_export(str(tmp_path / "f.mxa"), CFG, params, model_name="q")
        quant = quantize_decode_artifact(str(tmp_path / "f.mxa"),
                                         str(tmp_path / "t.mxa"), dtype)
        assert quant["dtype"] == dtype
        j_quantize(str(tmp_path / "f.mxa"), str(tmp_path / "j.mxa"), dtype)
        ours, ref = tmp_path / "t.mxa", tmp_path / "j.mxa"
    (m_got, p_got), (m_ref, p_ref) = _members(ours), _members(ref)
    assert p_got == p_ref          # weights and scales, byte for byte
    got, got_stats = _strip_stats(m_got)
    want, want_stats = _strip_stats(m_ref)
    assert got == want
    assert got_stats.keys() == want_stats.keys()
    for k, s in got_stats.items():
        r = want_stats[k]
        assert s["shape"] == r["shape"]
        for f in ("amax", "scale_min", "scale_max"):
            assert s[f] == r[f], (k, f)
        # numpy and torch sum the squares in other orders
        assert s["rms_rel_err"] == pytest.approx(r["rms_rel_err"],
                                                 rel=1e-5)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_port_quantized_artifact_serves_in_both_engines(tmp_path, dtype):
    params = _params(CFG, seed=11)
    f32 = export_decode_model(str(tmp_path / "f.mxa"), CFG, params,
                              model_name="pq")
    path = str(tmp_path / f"{dtype}.mxa")
    quantize_decode_artifact(f32, path, dtype=dtype)
    cfg, jparams, name, quant = JD._load_decode_artifact(path)
    assert name == "pq" and quant["dtype"] == dtype
    assert "l0.wq__scale" in jparams and cfg["param_names"][:3] == \
        ["embed", "pos", "l0.ln1"]
    with JD.DecodeEngine(path, num_slots=2, name="ex-j",
                         warmup=False) as je:
        ref = [je.generate(PROMPT, max_new_tokens=8),
               je.generate([1], max_new_tokens=5)]
    with DecodeEngine(path, num_slots=2, device="cpu") as te:
        assert te.name == "pq"
        got = [te.generate(PROMPT, max_new_tokens=8),
               te.generate([1], max_new_tokens=5)]
    assert got == ref


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_jax_quantized_artifact_serves_in_the_port(tmp_path, dtype):
    params = _params(CFG, seed=12)
    f32 = j_export(str(tmp_path / "f.mxa"), CFG, params, model_name="jq")
    path = str(tmp_path / f"{dtype}.mxa")
    j_quantize(f32, path, dtype=dtype)
    with JD.DecodeEngine(path, num_slots=2, name="ex-jq",
                         warmup=False) as je:
        ref = je.generate(PROMPT, max_new_tokens=8)
    with DecodeEngine(path, num_slots=2, device="cpu") as te:
        got = te.generate(PROMPT, max_new_tokens=8)
    assert got == ref
    # both packages read the same values from it
    _, tparams, _, _ = load_decode_artifact(path)
    _, jparams, _, _ = JD._load_decode_artifact(path)
    assert sorted(tparams) == sorted(jparams)
    for n, t in tparams.items():
        if t.dtype == torch.float8_e4m3fn:
            t = t.view(torch.uint8)
        assert t.numpy().tobytes() == np.asarray(jparams[n]).tobytes(), n


def test_artifact_engine_serves_as_the_in_memory_engine(tmp_path):
    params = _params(CFG, seed=13)
    path = export_decode_model(str(tmp_path / "m.mxa"), CFG, params,
                               quantize="int8")
    from mxnet_tpu_torch.contrib.quantization import calibrate_weights
    qparams, _ = calibrate_weights(params, "int8")
    with DecodeEngine(path, num_slots=2, device="cpu") as a, \
            DecodeEngine(DecodeModel(**CFG), qparams, num_slots=2,
                         device="cpu", name="m-mem") as b:
        for n, t in a.model.named_parameters():
            assert torch.equal(t, b.model.get_parameter(n)), n
        assert a.generate(PROMPT, 6) == b.generate(PROMPT, 6)


def test_export_refusals_match_jax(tmp_path):
    params = _params(CFG)
    short = {k: v for k, v in params.items() if k != "head"}
    for fn, err in ((export_decode_model, MXNetError),
                    (j_export, Exception)):
        with pytest.raises(err, match="missing params \\['head'\\]"):
            fn(str(tmp_path / "x.mxa"), CFG, short)
        with pytest.raises(err, match="int8 or fp8, got 'int4'"):
            fn(str(tmp_path / "x.mxa"), CFG, params, quantize="int4")
    q = export_decode_model(str(tmp_path / "q.mxa"), CFG, params,
                            quantize="int8")
    with pytest.raises(MXNetError, match="already quantized"):
        quantize_decode_artifact(q, str(tmp_path / "qq.mxa"))


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.contrib.quantization",
         *args], cwd=ROOT, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_cli_writes_a_quantized_artifact(tmp_path, dtype):
    src = export_decode_model(str(tmp_path / "f.mxa"), CFG, _params(CFG),
                              model_name="cli")
    dst = str(tmp_path / "q.mxa")
    r = _cli(src, dst, "--dtype", dtype)
    assert r.returncode == 0, r.stderr
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line == {"metric": "quantize_decode_artifact", "dst": dst,
                    "dtype": dtype, "params": 2 * 6 + 1, "ok": True}
    assert JD._load_decode_artifact(dst)[3]["dtype"] == dtype
    # a quantized source is refused
    r = _cli(dst, str(tmp_path / "qq.mxa"))
    assert r.returncode != 0 and "already quantized" in r.stderr
