"""The port's optimizers against mxnet_tpu.optimizer, on the CPU.

Three updates of the same weight with the same seeded gradients through
each package's ``Updater``: Adam (bias correction folded into lr, eps on
the uncorrected root, wd before clipping) and SGD with and without
momentum (wd after clipping), with ``wd``, ``clip_gradient`` and
``rescale_grad`` set, and per-parameter ``lr_mult``/``wd_mult``.
Tolerance rtol 1e-5 / atol 1e-7: the same float32 elementwise formulas,
rounded in another order.
"""
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import optimizer as jopt
from mxnet_tpu_torch import optimizer as topt

TOL = dict(rtol=1e-5, atol=1e-7)

CASES = {
    "adam": dict(learning_rate=0.01, wd=0.1, clip_gradient=0.5,
                 rescale_grad=0.25, beta1=0.8, beta2=0.99, epsilon=1e-6),
    "adam_defaults": dict(learning_rate=0.003),
    "sgd": dict(learning_rate=0.1, wd=0.05, clip_gradient=0.3,
                rescale_grad=0.5),
    "sgd_momentum": dict(learning_rate=0.1, momentum=0.9, wd=0.05,
                         clip_gradient=0.3, rescale_grad=0.5),
}


def _mults(lr_mult, wd_mult):
    return types.SimpleNamespace(lr_mult=lr_mult, wd_mult=wd_mult)


@pytest.mark.parametrize("mults", [(1.0, 1.0), (0.5, 0.0)],
                         ids=["plain", "lr_wd_mult"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_three_updates_match_jax_optimizer(case, mults):
    kwargs = dict(CASES[case])
    name = case.split("_")[0]
    rng = np.random.RandomState(len(case))
    w0 = rng.standard_normal((7, 5)).astype(np.float32)
    grads = [(rng.standard_normal((7, 5)) * 3).astype(np.float32)
             for _ in range(3)]
    jo = jopt.create(name, param_dict={0: _mults(*mults)}, **kwargs)
    to = topt.create(name, param_dict={0: _mults(*mults)}, **kwargs)
    ju, tu = jopt.get_updater(jo), topt.get_updater(to)
    jw = jmx.nd.array(w0)
    tw = torch.from_numpy(w0.copy())
    for g in grads:
        ju(0, jmx.nd.array(g), jw)
        tu(0, torch.from_numpy(g), tw)
        np.testing.assert_allclose(tw.numpy(), jw.asnumpy(), **TOL)
    assert to._index_update_count == {0: 3} == jo._index_update_count
    assert not np.allclose(tw.numpy(), w0)


def test_adam_is_not_torch_adam():
    # the folded bias correction and the uncorrected eps differ from
    # torch.optim.Adam once eps is not negligible against sqrt(v)
    w0 = np.full((4,), 1.0, np.float32)
    g = np.full((4,), 1e-3, np.float32)
    to = topt.Adam(learning_rate=0.1, epsilon=1e-3)
    tw = torch.from_numpy(w0.copy())
    topt.get_updater(to)(0, torch.from_numpy(g), tw)
    ref = torch.from_numpy(w0.copy()).requires_grad_()
    ref.grad = torch.from_numpy(g)
    torch.optim.Adam([ref], lr=0.1, eps=1e-3).step()
    # MXNet: lr_t = 0.1 * sqrt(1 - 0.999) / (1 - 0.9); m = 1e-4,
    # v = 1e-9: step = lr_t * m / (sqrt(v) + eps)
    lr_t = 0.1 * np.sqrt(1 - 0.999) / (1 - 0.9)
    want = 1.0 - lr_t * 1e-4 / (np.sqrt(1e-9) + 1e-3)
    np.testing.assert_allclose(tw.numpy(), want, rtol=1e-5)
    assert abs(float(ref.detach()[0]) - want) > 1e-3


def test_registry_and_learning_rate():
    o = topt.create("sgd", learning_rate=0.5)
    assert isinstance(o, topt.SGD) and o.learning_rate == 0.5
    o.set_learning_rate(0.25)
    assert o.learning_rate == 0.25
    with pytest.raises(ValueError):
        topt.create("nosuch")
