"""The predict tier and the int8 ops on the card.

Marked ``cuda``: every test skips without a CUDA device (decided in the
fixture, never at import). On a machine with a card:

    python -m pytest --noconftest tests/test_torch_serving_cuda.py -m cuda -q

- ``export_model`` on the card writes both programs and a measured
  ``devstats.peak_bytes``; the cpu program on the host and the cuda
  program on the card agree within float32 tolerance (1e-5 of the
  largest probability), and a predictor on the card refuses an artifact
  that holds no cuda program, naming the file;
- ``ServingEngine`` on the card: one CUDA graph a bucket, every bucket's
  rows bit-equal to the predictor's (each bucket pads to the export
  batch and runs the same kernels), no hand-written kernel launched;
- ``EnginePool`` with two replicas (two streams, two graph pools, one
  Predictor) under concurrent clients: every answer the predictor's row;
- the quantized convolution and fully connected ops give the CPU's
  int32 bit for bit at K = 4608, where a float32 accumulation does not.
"""
import threading

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

SHAPE = (8, 3, 16, 16)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the serving graphs run on the card")
    return torch.device("cuda")


def _convnet(mx):
    with mx.NameManager():
        data = mx.sym.Variable("data")
        net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8,
                                 name="c1")
        net = mx.sym.BatchNorm(net, name="bn1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(mx.sym.Flatten(net), num_hidden=10,
                                    name="fc")
        return mx.sym.SoftmaxOutput(net, name="softmax")


@pytest.fixture
def artifact(dev, tmp_path):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib.export import export_model
    sym = _convnet(mx)
    rng = np.random.RandomState(0)
    shapes, _, aux_shapes = sym.infer_shape(data=SHAPE)
    args = {n: rng.normal(0, .2, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    auxs = {n: rng.uniform(.5, 1.5, s).astype(np.float32)
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    path = str(tmp_path / "model.mxa")
    export_model(path, sym, args, auxs, {"data": SHAPE})
    x = rng.uniform(0, 1, SHAPE).astype(np.float32)
    return path, sym, args, auxs, x


def test_export_on_the_card_writes_both_programs(artifact, tmp_path):
    import json
    import zipfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib.export import export_model
    from mxnet_tpu_torch.predictor import Predictor
    path, sym, args, auxs, x = artifact
    with zipfile.ZipFile(path) as z:
        man = json.loads(z.read("MANIFEST.json"))
        names = set(z.namelist())
    assert {"module.cpu.pt2", "module.cuda.pt2"} <= names
    assert man["platforms"] == ["cpu", "cuda"]
    assert man["devstats"]["peak_bytes"] > 0
    card = Predictor(path).forward(x)[0]
    host = Predictor(path, device="cpu").forward(x)[0]
    assert np.abs(card - host).max() <= 1e-5 * np.abs(host).max()
    cpu_only = str(tmp_path / "cpu_only.mxa")
    export_model(cpu_only, sym, args, auxs, {"data": SHAPE},
                 platforms=("cpu",))
    with pytest.raises(mx.MXNetError, match="module.cuda.pt2"):
        Predictor(cpu_only)


def test_engine_buckets_are_graphs_and_equal_the_predictor(artifact):
    from mxnet_tpu_torch.ops import launches
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.serving import ServingEngine
    path, _, _, _, x = artifact
    pred = Predictor(path)
    full = pred.forward(x)[0]
    eng = ServingEngine(pred)
    assert eng.buckets == [1, 2, 4, 8]
    assert [p.graph is not None for p in eng._plans.values()] == [True]
    assert eng.plan_resident_bytes > 0
    before = launches.counts()
    for n in (8, 1, 2, 3, 5, 8, 1):
        np.testing.assert_array_equal(eng.infer(x[:n])[0], full[:n])
    assert launches.counts() == before
    assert eng.plan_compiles == 1
    eng.close()


def test_pool_replicas_serve_concurrent_clients(artifact):
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.serving import EnginePool
    path, _, _, _, x = artifact
    full = Predictor(path).forward(x)[0]
    errors, results = [], {}
    with EnginePool(path, replicas=2, max_wait_us=500) as pool:
        streams = {e._stream.cuda_stream for e in pool.engines}
        assert len(streams) == 2

        def client(i):
            try:
                for k in range(20):
                    r = (i + k) % SHAPE[0]
                    results[(i, k)] = (r, pool.infer(x[r:r + 1],
                                                     timeout_ms=30000)[0])
            except Exception as e:       # reported below
                errors.append(repr(e))
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        served = [s["completed"] for s in pool.stats()["per_replica"]]
    assert not errors, errors[:3]
    assert len(results) == 16 * 20
    for r, out in results.values():
        np.testing.assert_array_equal(out[0], full[r])
    assert sum(served) == 16 * 20


@pytest.mark.parametrize("op", ["conv", "fc"])
def test_quantized_products_are_the_cpus_past_2_24(dev, op):
    from mxnet_tpu_torch.ops.registry import OpCtx, get_op
    rng = np.random.RandomState(1)
    one = np.ones(1, np.float32)
    if op == "conv":
        d = rng.randint(100, 128, (4, 512, 5, 5)).astype(np.int8)
        w = (rng.randint(100, 128, (16, 512, 3, 3))
             * rng.choice([-1, 1], (16, 1, 1, 1))).astype(np.int8)
        name, attrs = "_contrib_quantized_conv", {
            "kernel": (3, 3), "num_filter": 16, "pad": (1, 1),
            "no_bias": True}
    else:
        d = rng.randint(100, 128, (8, 4608)).astype(np.int8)
        w = rng.randint(100, 128, (16, 4608)).astype(np.int8)
        name, attrs = "_contrib_quantized_fully_connected", {
            "num_hidden": 16, "no_bias": True}
    s = get_op(name)
    parsed = s.parse_attrs(attrs)

    def run(device):
        ts = [torch.from_numpy(a).to(device) for a in (d, w, -one, one,
                                                       -one, one)]
        return s.fcompute(parsed, OpCtx(device=torch.device(device)), *ts)
    card, host = run(dev), run("cpu")
    for c, h in zip(card, host):
        assert c.dtype == h.dtype
        assert torch.equal(c.cpu(), h)
    assert int(card[0].abs().max()) > 2 ** 24
    dc, wc = torch.from_numpy(d).to(dev).float(), \
        torch.from_numpy(w).to(dev).float()
    from mxnet_tpu_torch.ops.nn import cudnn_f32
    with cudnn_f32():
        f32 = torch.nn.functional.conv2d(dc, wc, padding=1) \
            if op == "conv" else dc @ wc.t()
    assert not torch.equal(torch.round(f32).to(torch.int32).cpu(), host[0])
