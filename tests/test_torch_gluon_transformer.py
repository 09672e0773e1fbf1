"""The transformer LM through the port's Gluon against the JAX package's
hybridized one, on the CPU, and the ``_contrib_flash_attention`` op.

A TransformerEncoder (2 layers, 32 wide, 4 heads) + Dense head, the JAX
net's Xavier weights carried in by name: the port's net eager and
hybridized against the JAX net hybridized (its attention through the
registered op, dense on the CPU): loss and every parameter's gradient,
rtol 1e-5 / atol 1e-6 (loss), 1e-4 / 1e-6 (gradients: the backward's
longer sums, as tests/test_torch_transformer.py). Then the op itself
through ``mx.nd`` and ``mx.sym`` (causal and not, a given scale): output
and q/k/v gradients against the JAX registry op's, rtol 1e-5 /
atol 1e-6. On the CPU the port's op runs the plain versions of the
kernels: no launch is counted.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpu, gluon as tgluon
from mxnet_tpu_torch.convert import load_gluon_params
from mxnet_tpu_torch.ops import attention as TA

CPU = cpu()
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
OP_TOL = dict(rtol=1e-5, atol=1e-6)
VOCAB, SEQ, BATCH = 16, 32, 4


def _build(g):
    net = g.nn.HybridSequential(prefix="lm_")
    with net.name_scope():
        net.add(g.nn.TransformerEncoder(vocab_size=VOCAB, units=32,
                                        hidden_size=64, num_heads=4,
                                        num_layers=2, max_length=SEQ),
                g.nn.Dense(VOCAB, flatten=False))
    return net


def _tokens():
    rng = np.random.RandomState(3)
    t = rng.randint(0, VOCAB, (BATCH, SEQ + 1))
    return t[:, :-1].astype(np.float32), t[:, 1:].astype(np.float32)


def _step(mx, net, x, y, kw):
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        logits = net(mx.nd.array(x, **kw))
        loss = loss_fn(logits.reshape((-3, 0)),
                       mx.nd.array(y, **kw).reshape((-1,))).mean()
    loss.backward()
    return float(loss.asnumpy()), {n: p.grad().asnumpy() for n, p in
                                   net.collect_params().items()}


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
def test_lm_matches_jax_hybridized(hybrid):
    x, y = _tokens()
    jnet = _build(jgluon)
    jmx.random.seed(4)
    jnet.initialize(jmx.init.Xavier())
    jnet.hybridize()
    jnet(jmx.nd.array(x))
    weights = {n: p.data().asnumpy() for n, p in
               jnet.collect_params().items()}
    jloss, jgrads = _step(jmx, jnet, x, y, {})
    tnet = _build(tgluon)
    load_gluon_params(tnet, weights, ctx=CPU)
    if hybrid:
        tnet.hybridize()
    before = TA.flash_attention_fwd.launches
    tloss, tgrads = _step(tmx, tnet, x, y, {"ctx": CPU})
    np.testing.assert_allclose(tloss, jloss, **LOSS_TOL)
    assert sorted(tgrads) == sorted(jgrads)
    for n in jgrads:
        np.testing.assert_allclose(tgrads[n], jgrads[n], err_msg=n,
                                   **GRAD_TOL)
    assert TA.flash_attention_fwd.launches == before
    if hybrid:
        ops = [n.op.name for n in tnet._cached_graph[1]._topo()
               if n.op is not None]
        assert ops.count("_contrib_flash_attention") == 2
        assert ops.count("cumsum") == 1


@pytest.mark.parametrize("causal,scale", [(True, None), (False, 0.3)])
@pytest.mark.parametrize("route", ["nd", "sym"])
def test_contrib_flash_attention_op_matches_jax(causal, scale, route):
    rng = np.random.RandomState(5)
    q, k, v, ct = (rng.standard_normal((2, 3, 16, 8)).astype(np.float32)
                   for _ in range(4))
    attrs = {"causal": causal}
    if scale is not None:
        attrs["scale"] = scale
    res = []
    for mx, kw in ((jmx, {}), (tmx, {"ctx": CPU})):
        arrs = [mx.nd.array(a, **kw) for a in (q, k, v)]
        for a in arrs:
            a.attach_grad()
        with mx.autograd.record():
            if route == "nd" or mx is jmx:
                out = mx.nd._contrib_flash_attention(*arrs, **attrs)
            else:
                sym = mx.sym._contrib_flash_attention(
                    mx.sym.var("q"), mx.sym.var("k"), mx.sym.var("v"),
                    **attrs)
                block = mx.gluon.SymbolBlock(
                    sym, [mx.sym.var("q"), mx.sym.var("k"),
                          mx.sym.var("v")])
                out = block(*arrs)
            total = (out * mx.nd.array(ct, **kw)).sum()
        total.backward()
        res.append([out.asnumpy()] + [a.grad.asnumpy() for a in arrs])
    for g, w in zip(res[1], res[0]):
        np.testing.assert_allclose(g, w, **OP_TOL)
    schema = tmx.ops.registry.get_op("_contrib_flash_attention")
    jschema = jmx.ops.registry.get_op("_contrib_flash_attention")
    assert list(schema.params) == list(jschema.params)
    assert list(schema.input_names) == list(jschema.input_names)
    assert schema.infer_shape(schema.parse_attrs({}), [(2, 3, 16, 8)] * 3) \
        == jschema.infer_shape(jschema.parse_attrs({}), [(2, 3, 16, 8)] * 3)
