"""The sparse ops and the embedding trainer on the card.

Marked ``cuda``: every test skips without a CUDA device (decided in the
fixture, never at import). On a machine with a card:

    python -m pytest --noconftest tests/test_torch_sparse_cuda.py -m cuda -q

- ``unique_rows``, ``segment_sum_rows`` and the in-place ``rows_*``
  updates on the card equal the CPU's (SGD's updates bit for bit, Adam's
  within 1e-6 relative; sums within 1e-6) and make no host sync
  (``torch.cuda.set_sync_debug_mode("error")``);
- an out-of-range row is dropped on the card without a device assert;
- an ``EmbeddingTrainer`` step (sparse and dense exchanges, sgd with
  momentum and adam) makes no host sync and repeats bit for bit, and 3
  steps equal the CPU's trainer within 1e-5 (sgd with momentum; adam's
  first loss), the touched-row counts exactly.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's path of the sparse ops")
    return torch.device("cuda")


class _NoSync:
    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")


def test_unique_and_segment_sum_on_the_card(dev):
    from mxnet_tpu_torch.ops import sparse_ops as sp
    rng = np.random.RandomState(0)
    ids = np.minimum(rng.zipf(1.3, size=4096) - 1, 999).astype(np.int32)
    vals = rng.normal(size=(4096, 16)).astype(np.float32)
    host = sp.unique_rows(torch.tensor(ids), 4096, 1000)
    ids_d, vals_d = torch.tensor(ids, device=dev), torch.tensor(vals,
                                                                device=dev)
    with _NoSync():
        card = sp.unique_rows(ids_d, 4096, 1000)
        seg = sp.segment_sum_rows(vals_d, card[1], 4096)
    for a, b in zip(card, host):
        assert torch.equal(a.cpu(), b)
    ref = sp.segment_sum_rows(torch.tensor(vals), host[1], 4096)
    np.testing.assert_allclose(seg.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-6 * float(ref.abs().max()))


@pytest.mark.parametrize("kind", ["sgd", "sgd_mom", "adam"])
def test_rows_updates_on_the_card_equal_the_cpu(dev, kind):
    from mxnet_tpu_torch.ops import sparse_ops as sp
    rng = np.random.RandomState(1)
    n = 1 + {"sgd": 0, "sgd_mom": 1, "adam": 2}[kind]
    bufs = [rng.normal(size=(1001, 16)).astype(np.float32) for _ in range(n)]
    if kind == "adam":
        bufs[2] = np.abs(bufs[2])
    rows = np.concatenate([rng.choice(1000, 300, replace=False),
                           [1000, 5000]])        # two past the rows
    g = rng.normal(size=(len(rows), 16)).astype(np.float32)
    fn = getattr(sp, {"sgd": "rows_sgd_update_",
                      "sgd_mom": "rows_sgd_mom_update_",
                      "adam": "rows_adam_update_"}[kind])
    extra = {"sgd": (0.1,), "sgd_mom": (0.1, 0.9),
             "adam": (0.01, 0.9, 0.999, 1e-8)}[kind]
    out = []
    for d in ("cpu", dev):
        ts = [torch.tensor(b, device=d) for b in bufs]
        r, gg = torch.tensor(rows, device=d), torch.tensor(g, device=d)
        with (_NoSync() if d == dev else torch.no_grad()):
            fn(*ts, r, gg, *extra, wd=0.01, rescale_grad=0.5)
        out.append([t[:-1].cpu() for t in ts])
    for a, b in zip(out[1], out[0]):
        if kind == "adam":
            # the card's sqrt and division may round an ulp off the host's
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        else:
            assert torch.equal(a, b)
    untouched = np.setdiff1d(np.arange(1000), rows)
    assert np.array_equal(out[1][0].numpy()[untouched], bufs[0][untouched])


def _trainer(mesh, optimizer, exchange):
    from mxnet_tpu_torch.parallel.embedding import EmbeddingTrainer
    return EmbeddingTrainer(
        mesh, vocab=5000, embed_dim=16, n_slots=8, dense_dim=13,
        mlp_hidden=(64, 32), optimizer=optimizer,
        learning_rate=0.1 if optimizer == "sgd" else 1e-2,
        momentum=0.9 if optimizer == "sgd" else 0.0, rescale_grad=1 / 256,
        exchange=exchange, batch_size=256)


def _batch(seed):
    rng = np.random.RandomState(seed)
    ids = np.minimum(rng.zipf(1.3, size=(256, 8)) - 1, 4999).astype(np.int32)
    x = rng.normal(size=(256, 13)).astype(np.float32)
    y = ((ids[:, 0] % 2) ^ (x[:, 0] > 0)).astype(np.float32)
    return [ids, x, y]


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("exchange", ["sparse", "dense"])
def test_trainer_step_on_the_card(dev, optimizer, exchange):
    from mxnet_tpu_torch.context import cpu
    from mxnet_tpu_torch.parallel.mesh import (data_parallel_mesh,
                                               mesh_for_contexts)
    runs = {}
    for where, mesh in (("cpu", mesh_for_contexts([cpu(0)])),
                        ("card", data_parallel_mesh(1)),
                        ("again", data_parallel_mesh(1))):
        tr = _trainer(mesh, optimizer, exchange)
        st = tr.init_state(seed=0)
        losses, nnz = [], []
        for s in range(3):
            inputs = tr.shard_inputs(_batch(s))
            if where == "card" and s == 2:
                with _NoSync():
                    st, loss, n = tr.step(st, inputs)
            else:
                st, loss, n = tr.step(st, inputs)
            losses.append(float(loss))
            nnz.append(int(n))
        runs[where] = (losses, nnz, tr.export_training_state(st)[0])
    assert runs["card"][0] == runs["again"][0]
    for k, v in runs["card"][2].items():
        assert np.array_equal(v, runs["again"][2][k]), k
    assert runs["card"][1] == runs["cpu"][1]
    # Adam moves each parameter by about +-lr whatever its gradient's
    # size: a gradient summing to about 0 may flip its step between two
    # summation orders, so past the first loss only sgd is held
    held = 3 if optimizer == "sgd" else 1
    np.testing.assert_allclose(runs["card"][0][:held], runs["cpu"][0][:held],
                               rtol=1e-5)
    if optimizer == "sgd":
        for k, v in runs["cpu"][2].items():
            np.testing.assert_allclose(runs["card"][2][k], v, rtol=0,
                                       atol=1e-5 * np.abs(v).max(),
                                       err_msg=k)
