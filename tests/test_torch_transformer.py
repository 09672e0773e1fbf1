"""The training slice as a whole: the JAX package's Gluon transformer LM
step against the port's, on the CPU.

A TransformerEncoder + Dense head is built in both packages with the same
prefixes; the JAX net's Xavier weights are carried into the port by
``collect_params`` name. The same seeded token batch then goes through
both: features, loss and every parameter's gradient after one backward,
and every parameter after each of 3 ``Trainer("adam")`` steps, are
compared. On the CPU the JAX package's attention takes its dense XLA
path, as its own transformer tests run; the port's takes its autograd
Function with the plain forward and backward twins.

Tolerances: features and loss rtol 1e-5 / atol 1e-5 on the carried-in
weights (float32 through two layers summed in another order), rtol 1e-4 /
atol 1e-4 after an optimizer step (the weights then differ by up to the
parameter tolerance below); gradients rtol 1e-4 / atol 1e-6 (the
backward's longer sums); parameters after Adam steps rtol 1e-4 /
atol 1e-6.

Both Trainers use Adam with epsilon 1e-4. With the default 1e-8 an
element whose gradient is within its rounding error of 0 moves by a full
step in a direction each package's rounding picks (the thread count alone
changes it), and the next step's gradients then differ by ~1%: the
comparison would measure rounding, not the port. With 1e-4 the step is
continuous in the gradient near 0, so every element compares strictly.
(The attention key bias is such a tensor throughout: q . (k_j + b) shifts
every score of a row by the same q . b, which softmax ignores, so its
true gradient is exactly 0.)

The JAX net's init is seeded (``JAX_INIT_SEED``), so the weights do not
depend on which tests ran before in the same process. The strict
comparison needs that: an FFN pre-activation that lands within rounding
of 0 in one package and not in the other flips its ReLU, and in a model
this small one such flip moves the next gradients by ~1% (one token's
FFN contribution). The seed is one where no pre-activation comes that
close over the 3 steps.

A port-only copy of ``tests/test_transformer.py::test_transformer_lm_trains``
checks that the port learns the same next-token pattern.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgluon
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag, cpu, gluon as tgluon
from mxnet_tpu_torch.convert import gluon_params_to_numpy, load_gluon_params
from mxnet_tpu_torch.ops import attention as TA

FEAT_TOL = dict(rtol=1e-5, atol=1e-5)
STEPPED_FEAT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
ADAM = {"learning_rate": 3e-3, "epsilon": 1e-4}
VOCAB, SEQ, BATCH = 16, 128, 2
JAX_INIT_SEED = 4


def _build(g, heads):
    net = g.nn.TransformerEncoder(vocab_size=VOCAB, units=32, hidden_size=64,
                                  num_heads=heads, num_layers=2,
                                  max_length=SEQ, prefix="lm_")
    head = g.nn.Dense(VOCAB, flatten=False, prefix="head_")
    return net, head


def _tokens(seed):
    rng = np.random.RandomState(seed)
    start = rng.randint(0, VOCAB, (BATCH, 1))
    tokens = (start + np.arange(SEQ + 1) * 3) % VOCAB
    noise = rng.randint(0, VOCAB, tokens.shape)      # not a clean pattern
    tokens = np.where(rng.rand(*tokens.shape) < 0.3, noise, tokens)
    return (tokens[:, :-1].astype(np.float32),
            tokens[:, 1:].astype(np.float32))


def _jax_params(*blocks):
    out = {}
    for b in blocks:
        out.update({n: p for n, p in b.collect_params().items()})
    return out


@pytest.mark.parametrize("heads", [2, 1], ids=["d16", "d32"])
def test_train_step_matches_jax(heads):
    x, y = _tokens(seed=heads)
    jnet, jhead = _build(jgluon, heads)
    jmx.random.seed(JAX_INIT_SEED)
    jnet.initialize(jmx.init.Xavier())
    jhead.initialize(jmx.init.Xavier())
    jhead(jnet(jmx.nd.array(x)))                   # finish deferred shapes
    jparams = _jax_params(jnet, jhead)

    tnet, thead = _build(tgluon, heads)
    for tb, jb in ((tnet, jnet), (thead, jhead)):
        load_gluon_params(tb, {n: p.data().asnumpy() for n, p in
                               jb.collect_params().items()}, ctx=cpu())
    tparams = {**tnet.collect_params(), **thead.collect_params()}
    assert list(tparams) == list(jparams)

    jtrainer = jgluon.Trainer(jparams, "adam", dict(ADAM))
    ttrainer = tgluon.Trainer(tparams, "adam", dict(ADAM))
    jloss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    tloss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    jx, jy = jmx.nd.array(x), jmx.nd.array(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    counts = TA.flash_attention_bwd_dq.launches
    for step in range(3):
        with jag.record():
            jfeat = jnet(jx)
            jloss = jloss_fn(jhead(jfeat).reshape(-3, 0),
                             jy.reshape(-1)).mean()
        jloss.backward()
        with tag.record():
            tfeat = tnet(tx)
            tloss = tloss_fn(thead(tfeat).reshape(-1, VOCAB),
                             ty.reshape(-1)).mean()
        tloss.backward()
        tol = FEAT_TOL if step == 0 else STEPPED_FEAT_TOL
        np.testing.assert_allclose(tfeat.detach().numpy(), jfeat.asnumpy(),
                                   **tol)
        np.testing.assert_allclose(float(tloss.detach()),
                                   float(jloss.asnumpy()), **tol)
        for n, p in tparams.items():
            np.testing.assert_allclose(p.grad().asnumpy(),
                                       jparams[n].grad().asnumpy(),
                                       err_msg=f"step {step} grad {n}",
                                       **GRAD_TOL)
        jtrainer.step(1)
        ttrainer.step(1)
        tvals = gluon_params_to_numpy(tnet)
        tvals.update(gluon_params_to_numpy(thead))
        for n, p in jparams.items():
            np.testing.assert_allclose(tvals[n], p.data().asnumpy(),
                                       err_msg=f"step {step} param {n}",
                                       **PARAM_TOL)
    # on the CPU the plain twins ran: no kernel launch was counted
    assert TA.flash_attention_bwd_dq.launches == counts


def test_transformer_lm_trains():
    """Port-only copy of tests/test_transformer.py::test_transformer_lm_trains:
    a tiny causal LM learns next token = (token + 3) % vocab."""
    tmx.random.seed(0)
    rng = np.random.RandomState(2)
    vocab, seq, batch = 12, 16, 8
    net = tgluon.nn.TransformerEncoder(vocab_size=vocab, units=32,
                                       hidden_size=64, num_heads=4,
                                       num_layers=2, max_length=seq)
    head = tgluon.nn.Dense(vocab, flatten=False)
    net.initialize(tmx.init.Xavier(), ctx=cpu())
    head.initialize(tmx.init.Xavier(), ctx=cpu())
    params = {**net.collect_params(), **head.collect_params()}
    trainer = tgluon.Trainer(params, "adam", {"learning_rate": 3e-3})
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()

    start = rng.randint(0, vocab, (batch, 1))
    tokens = (start + np.arange(seq + 1) * 3) % vocab
    x = torch.tensor(tokens[:, :-1], dtype=torch.float32)
    y = torch.tensor(tokens[:, 1:], dtype=torch.float32)

    losses = []
    for _ in range(60):
        with tag.record():
            logits = head(net(x))
            loss = loss_fn(logits.reshape(-1, vocab), y.reshape(-1)).mean()
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.3, losses[-5:]
    pred = head(net(x)).argmax(-1).numpy()
    acc = (pred == tokens[:, 1:]).mean()
    assert acc > 0.9, acc


def test_sequence_longer_than_max_length_raises():
    net = tgluon.nn.TransformerEncoder(vocab_size=5, units=8, hidden_size=8,
                                       num_heads=1, num_layers=1,
                                       max_length=4, prefix="short_")
    net.initialize(ctx=cpu())
    with pytest.raises(ValueError, match="max_length"):
        net(torch.zeros(1, 5))


def test_reference_switch_gives_the_same_gradients(monkeypatch):
    # swapping ops.attention.flash_attention (which the registered
    # _contrib_flash_attention op calls) for the dense plain attention,
    # differentiated by torch (the reference switch chip_smoke.py uses on
    # the card): on the CPU both paths must agree
    tmx.random.seed(1)
    net, head = _build(tgluon, 2)
    net.initialize(tmx.init.Xavier(), ctx=cpu())
    head.initialize(tmx.init.Xavier(), ctx=cpu())
    x, y = (torch.from_numpy(a) for a in _tokens(seed=9))
    params = {**net.collect_params(), **head.collect_params()}
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    grads = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(TA, "flash_attention",
                                TA.reference_attention)
        with tag.record():
            loss = loss_fn(head(net(x)).reshape(-1, VOCAB),
                           y.reshape(-1)).mean()
        loss.backward()
        grads.append({n: p.grad().asnumpy().copy()
                      for n, p in params.items()})
    for n in params:
        np.testing.assert_allclose(grads[0][n], grads[1][n], **GRAD_TOL)
