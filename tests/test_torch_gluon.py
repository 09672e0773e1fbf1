"""The port's Gluon against the JAX package's, on the CPU.

Layers, losses, initializer shapes and scale, parameter names and
structural keys, ``save_parameters``/``load_parameters`` across the two
packages, and the ``grad_req`` contract. Both sides get explicit
``prefix=`` (the automatic prefix counters are per process), the same
weights (carried from the JAX net by name) and the same seeded numpy
inputs. Tolerance rtol 1e-5 / atol 1e-6: float32 ops of width <= 64
summed in another order.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgluon
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag, cpu, gluon as tgluon
from mxnet_tpu_torch.convert import gluon_params_to_numpy, load_gluon_params

TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_params(net):
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _pair(make, x, seed=0):
    """(jax block, port block) with the jax block's initialized weights
    carried into the port block."""
    jb, tb = make(jgluon), make(tgluon)
    jb.initialize(jmx.init.Xavier())
    jb(jmx.nd.array(x))                       # finish deferred shapes
    load_gluon_params(tb, _jax_params(jb), ctx=cpu())
    return jb, tb


@pytest.mark.parametrize("flatten", [True, False])
@pytest.mark.parametrize("act", [None, "relu", "tanh"])
def test_dense_matches_jax(flatten, act):
    x = np.random.RandomState(0).standard_normal((3, 4, 6)).astype(
        np.float32)
    jb, tb = _pair(lambda g: g.nn.Dense(5, activation=act, flatten=flatten,
                                        prefix="fc_"), x)
    assert list(tb.collect_params()) == ["fc_weight", "fc_bias"]
    want = (5, 24) if flatten else (5, 6)
    assert tb.weight.shape == want and jb.weight.shape == want
    np.testing.assert_allclose(tb(torch.from_numpy(x)).numpy(),
                               jb(jmx.nd.array(x)).asnumpy(), **TOL)


def test_layernorm_embedding_activation_match_jax():
    rng = np.random.RandomState(1)
    x = (rng.standard_normal((2, 5, 8)) * 3 + 1).astype(np.float32)
    jb, tb = _pair(lambda g: g.nn.LayerNorm(prefix="ln_"), x)
    gamma = rng.rand(8).astype(np.float32)
    tb.gamma.set_data(gamma)
    jb.gamma.set_data(jmx.nd.array(gamma))
    np.testing.assert_allclose(tb(torch.from_numpy(x)).numpy(),
                               jb(jmx.nd.array(x)).asnumpy(), rtol=1e-5,
                               atol=1e-5)
    # ids out of range and fractional: cast then clipped, as the reference
    ids = np.array([[0, 3, 9, -2], [1.7, 15, 4, 2]], np.float32)
    jb, tb = _pair(lambda g: g.nn.Embedding(10, 4, prefix="emb_"), ids)
    np.testing.assert_allclose(tb(torch.from_numpy(ids)).numpy(),
                               jb(jmx.nd.array(ids)).asnumpy(), **TOL)
    for act in ("relu", "sigmoid", "tanh", "softrelu", "softsign"):
        jb = jgluon.nn.Activation(act, prefix="a_")
        tb = tgluon.nn.Activation(act, prefix="a_")
        np.testing.assert_allclose(tb(torch.from_numpy(x)).numpy(),
                                   jb(jmx.nd.array(x)).asnumpy(), **TOL)


def test_dropout_only_in_training_with_keep_scaling():
    tmx.random.seed(3)
    x = torch.ones(200, 50)
    d = tgluon.nn.Dropout(0.25, prefix="drop_")
    assert torch.equal(d(x), x)               # predict mode: identity
    with tag.record():
        y = d(x)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    with tag.predict_mode():
        assert torch.equal(d(x), x)
    # the same seed gives the same mask
    tmx.random.seed(3)
    with tag.record():
        assert torch.equal(d(x), y)


@pytest.mark.parametrize("batch_axis", [0, 1])
def test_losses_match_jax(batch_axis):
    rng = np.random.RandomState(2)
    pred = rng.standard_normal((4, 3, 7)).astype(np.float32)
    label = rng.randint(0, 7, (4, 3)).astype(np.float32)
    jl = jgluon.loss.SoftmaxCrossEntropyLoss(batch_axis=batch_axis)
    tl = tgluon.loss.SoftmaxCrossEntropyLoss(batch_axis=batch_axis)
    got = tl(torch.from_numpy(pred), torch.from_numpy(label))
    np.testing.assert_allclose(
        got.numpy(), jl(jmx.nd.array(pred), jmx.nd.array(label)).asnumpy(),
        **TOL)
    assert got.shape == (pred.shape[batch_axis],)
    dense = rng.rand(4, 3, 7).astype(np.float32)
    jl = jgluon.loss.SoftmaxCrossEntropyLoss(sparse_label=False, weight=0.5)
    tl = tgluon.loss.SoftmaxCrossEntropyLoss(sparse_label=False, weight=0.5)
    np.testing.assert_allclose(
        tl(torch.from_numpy(pred), torch.from_numpy(dense)).numpy(),
        jl(jmx.nd.array(pred), jmx.nd.array(dense)).asnumpy(), **TOL)
    sw = rng.rand(4, 1, 1).astype(np.float32)
    jl, tl = jgluon.loss.L2Loss(), tgluon.loss.L2Loss()
    np.testing.assert_allclose(
        tl(torch.from_numpy(pred), torch.from_numpy(dense),
           torch.from_numpy(sw)).numpy(),
        jl(jmx.nd.array(pred), jmx.nd.array(dense),
           jmx.nd.array(sw)).asnumpy(), **TOL)


@pytest.mark.parametrize("factor,rnd", [("avg", "uniform"), ("in", "uniform"),
                                        ("out", "gaussian")])
def test_xavier_shapes_and_scale_match_jax(factor, rnd):
    tmx.random.seed(0)
    init = tmx.init.Xavier(rnd_type=rnd, factor_type=factor, magnitude=2)
    jnet = jgluon.nn.Dense(300, in_units=200, prefix="x_")
    tnet = tgluon.nn.Dense(300, in_units=200, prefix="x_")
    jnet.initialize(jmx.init.Xavier(rnd_type=rnd, factor_type=factor,
                                    magnitude=2))
    tnet.initialize(init, ctx=cpu())
    jw, tw = jnet.weight.data().asnumpy(), tnet.weight.data().asnumpy()
    assert jw.shape == tw.shape == (300, 200)
    fan = {"avg": 250.0, "in": 200.0, "out": 300.0}[factor]
    scale = np.sqrt(2 / fan)
    if rnd == "uniform":
        assert np.abs(tw).max() <= scale and np.abs(jw).max() <= scale
        want_std = scale / np.sqrt(3)
    else:
        want_std = scale
    for w in (tw, jw):
        assert abs(w.std() / want_std - 1) < 0.03
    # bias is zero in both (its own "zeros" initializer)
    assert not tnet.bias.data().asnumpy().any() and \
        not jnet.bias.data().asnumpy().any()


def test_default_initializer_is_uniform_007():
    tmx.random.seed(1)
    net = tgluon.nn.Dense(64, in_units=64, prefix="u_")
    net.initialize(ctx=cpu())
    w = net.weight.data().asnumpy()
    assert float(np.abs(w).max()) <= 0.07 and float(w.std()) > 0.03


def _tiny_lm(g, prefix):
    return g.nn.TransformerEncoder(vocab_size=11, units=16, hidden_size=32,
                                   num_heads=2, num_layers=2, max_length=8,
                                   prefix=prefix)


def test_parameter_names_and_structural_keys_match_jax():
    jnet, tnet = _tiny_lm(jgluon, "lm_"), _tiny_lm(tgluon, "lm_")
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    assert list(tnet._collect_params_with_prefix()) == \
        list(jnet._collect_params_with_prefix())
    assert "2.attention.proj_query.weight" in \
        tnet._collect_params_with_prefix()
    # auto prefixes inside a name scope count per parent, as in the JAX
    # package: two unnamed Dense layers under one block
    outer_t = tgluon.nn.HybridSequential(prefix="seq_")
    outer_j = jgluon.nn.HybridSequential(prefix="seq_")
    for outer, g in ((outer_t, tgluon), (outer_j, jgluon)):
        with outer.name_scope():
            outer.add(g.nn.Dense(3), g.nn.Dense(4))
    assert list(outer_t.collect_params()) == list(outer_j.collect_params())


def test_load_parameters_reads_a_file_the_jax_package_saved(tmp_path):
    x = np.array([[1, 2, 3, 4, 5, 6, 7, 8], [3, 1, 4, 1, 5, 9, 2, 6]],
                 np.float32)
    jnet = _tiny_lm(jgluon, "lm_")
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    path = str(tmp_path / "lm.params")
    jnet.save_parameters(path)
    tnet = _tiny_lm(tgluon, "lm_")
    tnet.load_parameters(path, ctx=cpu())
    for n, a in _jax_params(jnet).items():
        np.testing.assert_array_equal(gluon_params_to_numpy(tnet)[n], a)
    np.testing.assert_allclose(tnet(torch.from_numpy(x)).numpy(),
                               jnet(jmx.nd.array(x)).asnumpy(), rtol=1e-5,
                               atol=1e-5)
    # and back: the JAX package reads what the port saves
    for p in tnet.collect_params().values():
        p.set_data(p.data() * 0.5)
    back = str(tmp_path / "back.params")
    tnet.save_parameters(back)
    jnet.load_parameters(back)
    for n, a in gluon_params_to_numpy(tnet).items():
        np.testing.assert_array_equal(jnet.collect_params()[n].data()
                                      .asnumpy(), a)


def test_deferred_dense_resolves_on_first_forward():
    net = tgluon.nn.Dense(4, prefix="d_")
    net.initialize(ctx=cpu())
    with pytest.raises(tgluon.DeferredInitializationError):
        net.weight.data()
    assert net.weight.list_ctx()[0].device_type == "cpu"
    out = net(torch.ones(2, 3, 5))
    assert out.shape == (2, 4) and net.weight.shape == (4, 15)


def test_grad_req_write_overwrites_add_accumulates_null_skips():
    # the reference overwrites the gradient on every backward; torch would
    # accumulate. Checked over three steps: the bug shows from step 2 on
    net = tgluon.nn.Dense(3, in_units=4, prefix="g_")
    net.initialize(ctx=cpu())
    rng = np.random.RandomState(4)
    xs = [torch.from_numpy(rng.standard_normal((2, 4)).astype("f"))
          for _ in range(3)]
    for x in xs:
        with tag.record():
            y = net(x).sum()
        y.backward()                              # torch's own method
        np.testing.assert_allclose(net.weight.grad().asnumpy(),
                                   np.tile(x.sum(0).numpy(), (3, 1)),
                                   rtol=1e-6)
    net.weight.grad_req = "add"
    net.weight.zero_grad()
    for x in xs:
        with tag.record():
            y = net(x).sum()
        tag.backward(y)
    np.testing.assert_allclose(net.weight.grad().asnumpy(),
                               np.tile(sum(x.sum(0) for x in xs).numpy(),
                                       (3, 1)), rtol=1e-5)
    net.bias.grad_req = "null"
    with tag.record():
        y = net(xs[0]).sum()
    y.backward()
    assert net.bias.data().grad is None
    with pytest.raises(RuntimeError, match="null"):
        net.bias.grad()


def test_nothing_is_recorded_outside_record():
    net = tgluon.nn.Dense(3, in_units=4, prefix="r_")
    net.initialize(ctx=cpu())
    x = torch.ones(1, 4)
    assert not net(x).requires_grad
    with tag.record():
        assert net(x).requires_grad
        assert tag.is_recording() and tag.is_training()
        with tag.pause():
            assert not net(x).requires_grad
    assert not tag.is_recording()


def test_jax_grads_of_a_block_match():
    # one backward through the JAX tape and through torch autograd
    x = np.random.RandomState(5).standard_normal((4, 6)).astype(np.float32)
    jb, tb = _pair(lambda g: g.nn.Dense(5, activation="relu", prefix="b_"),
                   x)
    with jag.record():
        jy = (jb(jmx.nd.array(x)) ** 2).sum()
    jy.backward()
    with tag.record():
        ty = (tb(torch.from_numpy(x)) ** 2).sum()
    ty.backward()
    for n in ("b_weight", "b_bias"):
        np.testing.assert_allclose(
            tb.collect_params()[n].grad().asnumpy(),
            jb.collect_params()[n].grad().asnumpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["Sequential", "HybridSequential"])
def test_sequential_matches_jax(kind):
    x = np.random.RandomState(6).standard_normal((3, 7)).astype(np.float32)

    def make(g):
        net = getattr(g.nn, kind)(prefix="seq_")
        with net.name_scope():
            net.add(g.nn.Dense(8, activation="relu"), g.nn.Dense(4))
        return net
    jb, tb = _pair(make, x)
    assert len(tb) == 2 and isinstance(tb[1], tgluon.nn.Dense)
    assert list(tb.collect_params()) == list(jb.collect_params())
    np.testing.assert_allclose(tb(torch.from_numpy(x)).numpy(),
                               jb(jmx.nd.array(x)).asnumpy(), **TOL)
    assert len(tb[:1]) == 1


def test_trainer_update_learning_rate_and_head_grads():
    net = tgluon.nn.Dense(2, in_units=3, prefix="tr_")
    net.initialize(tmx.init.One(), ctx=cpu())
    trainer = tgluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.5})
    assert trainer.learning_rate == 0.5
    trainer.set_learning_rate(0.25)
    assert trainer.learning_rate == 0.25
    x = torch.ones(4, 3)
    with tag.record():
        y = net(x)
    # head_grads weight the outputs: d/dw of sum(2 * y) over 4 rows
    tag.backward([y], [torch.full_like(y, 2.0)])
    np.testing.assert_allclose(net.weight.grad().asnumpy(), np.full((2, 3), 8.))
    trainer.allreduce_grads()                 # one device: nothing to do
    trainer.update(4)                         # rescale 1/4, lr 0.25
    np.testing.assert_allclose(net.weight.data().asnumpy(),
                               np.full((2, 3), 1.0 - 0.25 * 2.0))
    np.testing.assert_allclose(net.bias.data().asnumpy(),
                               np.full((2,), 0.0 - 0.25 * 2.0))


def test_parameter_dict_save_and_load(tmp_path):
    net = tgluon.nn.Dense(3, in_units=2, prefix="pd_")
    net.initialize(tmx.init.Normal(1.0), ctx=cpu())
    path = str(tmp_path / "pd.params")
    net.collect_params().save(path, strip_prefix="pd_")
    other = tgluon.nn.Dense(3, in_units=2, prefix="pd_")
    other.collect_params().load(path, ctx=cpu(), restore_prefix="pd_")
    for n, a in gluon_params_to_numpy(net).items():
        np.testing.assert_array_equal(gluon_params_to_numpy(other)[n], a)
    # the JAX package reads the same file by its full names
    jnet = jgluon.nn.Dense(3, in_units=2, prefix="pd_")
    jnet.collect_params().load(path, restore_prefix="pd_")
    np.testing.assert_array_equal(jnet.weight.data().asnumpy(),
                                  gluon_params_to_numpy(net)["pd_weight"])
