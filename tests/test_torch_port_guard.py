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
            "mxnet_tpu_torch.ops.conv_fused, mxnet_tpu_torch.rtc, "
            "mxnet_tpu_torch.ndarray.container, mxnet_tpu_torch.telemetry, "
            "mxnet_tpu_torch.telemetry.registry, "
            "mxnet_tpu_torch.telemetry.exporter, "
            "mxnet_tpu_torch.telemetry.devstats, "
            "mxnet_tpu_torch.contrib.export, mxnet_tpu_torch.base, "
            "mxnet_tpu_torch.config, mxnet_tpu_torch.context, "
            "mxnet_tpu_torch.ops.registry, mxnet_tpu_torch.ops.tensor, "
            "mxnet_tpu_torch.ops.optimizer_ops, mxnet_tpu_torch.imperative, "
            "mxnet_tpu_torch.ndarray, mxnet_tpu_torch.ndarray.ndarray, "
            "mxnet_tpu_torch.ndarray.random, mxnet_tpu_torch.symbol, "
            "mxnet_tpu_torch.symbol.symbol, mxnet_tpu_torch.executor, "
            "mxnet_tpu_torch.lr_scheduler, mxnet_tpu_torch.metric, "
            "mxnet_tpu_torch.io, mxnet_tpu_torch.model, "
            "mxnet_tpu_torch.callback, mxnet_tpu_torch.module, "
            "mxnet_tpu_torch.module.base_module, "
            "mxnet_tpu_torch.module.module, mxnet_tpu_torch.kvstore, "
            "mxnet_tpu_torch.parallel, mxnet_tpu_torch.parallel.mesh, "
            "mxnet_tpu_torch.parallel.dp\n"
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


def test_conv_fused_and_rtc_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from mxnet_tpu_torch import MXNetError, rtc
    from mxnet_tpu_torch.ops import conv_fused
    # rtc compiles for the default device: without a card it raises
    with pytest.raises(MXNetError, match="no CUDA device"):
        rtc.CudaModule('extern "C" __global__ void k() {}')
    # conv1x1 follows its tensors: the host only for host tensors, and
    # nothing is moved off the device it was given
    x = torch.ones(1, 8, 16)
    before = conv_fused.conv1x1.launches
    y, (s1, _) = conv_fused.conv1x1(x, torch.ones(4, 8))
    assert y.device.type == "cpu" and s1.device.type == "cpu"
    assert conv_fused.conv1x1.launches == before


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


def _mlp_symbol():
    import mxnet_tpu_torch as mx
    with mx.NameManager():
        net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                                    name="fc")
        return mx.sym.SoftmaxOutput(net, name="softmax")


def test_symbolic_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    import mxnet_tpu_torch as mx
    sym = _mlp_symbol()
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        mx.mod.Module(sym)
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        sym.simple_bind(data=(2, 3))
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        mx.nd.array(np.ones(3))
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        mx.nd.zeros((2,))


def test_symbolic_path_runs_on_the_cpu_when_asked():
    import mxnet_tpu_torch as mx
    sym = _mlp_symbol()
    x = np.random.RandomState(0).rand(8, 3).astype(np.float32)
    y = np.arange(8) % 4
    it = mx.io.NDArrayIter(x, y.astype(np.float32), 4)
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1})
    args, _ = mod.get_params()
    assert all(a._data.device.type == "cpu" for a in args.values())
    ex = sym.simple_bind(ctx=mx.cpu(), data=(2, 3))
    assert ex.arg_dict["fc_weight"]._data.device.type == "cpu"
    with mx.cpu():
        assert mx.nd.array(x).context == mx.cpu()
        ex2 = sym.simple_bind(data=(2, 3))
    assert ex2.arg_dict["data"]._data.device.type == "cpu"


def test_data_parallel_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import (DataParallelTrainer,
                                          data_parallel_mesh,
                                          mesh_for_contexts)
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        data_parallel_mesh()
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        DataParallelTrainer(_mlp_symbol(), data_parallel_mesh(1))
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        mesh_for_contexts([mx.gpu(0), mx.gpu(1)])
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        mx.mod.Module(_mlp_symbol(), context=[mx.gpu(0), mx.gpu(1)])


def test_data_parallel_runs_on_host_replicas_when_asked():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import (DataParallelTrainer,
                                          mesh_for_contexts)
    ctxs = [mx.cpu(i) for i in range(2)]
    tr = DataParallelTrainer(_mlp_symbol(), mesh_for_contexts(ctxs),
                             learning_rate=0.1)
    params, states, aux = tr.init_state({"data": (4, 3),
                                         "softmax_label": (4,)})
    x = np.random.RandomState(0).rand(4, 3).astype(np.float32)
    y = (np.arange(4) % 4).astype(np.float32)
    params, states, aux, loss, outs = tr.step(params, states, aux,
                                              tr.shard_inputs([x, y]))
    assert params[0].device.type == "cpu" and tr.captures == 0
    assert outs[0].shape == (4, 4)
    it = mx.io.NDArrayIter(x, y, 4)
    mod = mx.mod.Module(_mlp_symbol(), context=ctxs)
    mod.fit(it, num_epoch=1, optimizer="sgd", steps_per_dispatch=2)
    assert mod.get_params()[0]["fc_weight"].context == mx.cpu()

