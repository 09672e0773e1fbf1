"""The port stands alone and defaults to the card.

- No module of mxnet_tpu_torch, nor chip_smoke.py, imports jax,
  ml_dtypes or anything of the JAX package (an AST scan).
- Importing mxnet_tpu_torch leaves jax out of sys.modules.
- Entry points default to CUDA: without a card they raise instead of
  running on the CPU; the CPU is used only when asked for.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "mxnet_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "mxnet_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for mod in _imported(tree):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append((os.path.relpath(path, ROOT), mod))
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.serving, "
            "mxnet_tpu_torch.contrib.quantization, mxnet_tpu_torch.convert, "
            "mxnet_tpu_torch.gluon, mxnet_tpu_torch.gluon.nn, "
            "mxnet_tpu_torch.gluon.loss, mxnet_tpu_torch.autograd, "
            "mxnet_tpu_torch.optimizer, mxnet_tpu_torch.initializer, "
            "mxnet_tpu_torch.random, mxnet_tpu_torch.ops.nn, "
            "mxnet_tpu_torch.ndarray.container\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'mxnet_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from mxnet_tpu_torch import MXNetError, gpu, resolve_device
    from mxnet_tpu_torch.serving.decode import DecodeEngine, DecodeModel
    model = DecodeModel(vocab=16, layers=1, d_model=16, heads=2,
                        max_len=16)
    params = model.init_params(seed=0)
    with pytest.raises(MXNetError, match="no CUDA device"):
        DecodeEngine(model, params)
    with pytest.raises(MXNetError, match="no CUDA device"):
        gpu(0).torch_device()
    with pytest.raises(MXNetError):
        resolve_device(None)
    # the model's parameters stayed on the host, untouched
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_gluon_initialize_and_trainer_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from mxnet_tpu_torch import MXNetError, gluon, init
    net = gluon.nn.TransformerEncoder(vocab_size=8, units=8, hidden_size=8,
                                      num_heads=1, num_layers=1,
                                      max_length=4, prefix="guard_")
    with pytest.raises(MXNetError, match="no CUDA device"):
        net.initialize(init.Xavier())
    with pytest.raises(MXNetError, match="no CUDA device"):
        gluon.nn.Dense(3).initialize()        # deferred shapes too
    # nothing was quietly placed on the host, so there is nothing to train
    with pytest.raises(RuntimeError, match="not been initialized"):
        gluon.Trainer(net.collect_params(), "adam")


def test_gluon_runs_on_the_cpu_when_asked():
    from mxnet_tpu_torch import autograd, cpu, gluon
    net = gluon.nn.Dense(2, in_units=3, prefix="host_")
    net.initialize(ctx=cpu())
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    with autograd.record():
        loss = net(torch.ones(4, 3)).sum()
    loss.backward()
    trainer.step(4)
    assert net.weight.data().device.type == "cpu"
    assert net.weight.list_ctx()[0].device_type == "cpu"


def test_cpu_is_used_when_asked():
    from mxnet_tpu_torch import cpu, resolve_device
    from mxnet_tpu_torch.serving.decode import DecodeEngine, DecodeModel
    assert resolve_device("cpu") == torch.device("cpu")
    assert cpu().torch_device() == torch.device("cpu")
    model = DecodeModel(vocab=16, layers=1, d_model=16, heads=2,
                        max_len=16)
    with DecodeEngine(model, model.init_params(seed=0), num_slots=1,
                      device="cpu") as eng:
        out = eng.generate([1, 2], max_new_tokens=3)
    assert len(out) == 3 and all(0 <= t < 16 for t in out)
    assert np.all([p.device.type == "cpu" for p in model.parameters()])


def test_config_knobs_keep_the_jax_package_names_and_defaults():
    from mxnet_tpu import config as jcfg
    from mxnet_tpu_torch import config as tcfg
    for name in tcfg._DOCUMENTED:
        assert tcfg.get(name) == jcfg.get(name), name
