"""``examples/lstm_bucketing.py`` run as it is in the JAX package and with
only its import changed on the port (``mxnet_tpu_torch``), on the CPU
(``--ctx cpu``, the example's other arguments its own): both reach the
example's own bar, a final train perplexity below 8.0 (its exit code 0).
One case a package, in a file of its own, so that pytest-xdist's file
groups (``--dist loadfile``) run it beside the other files; torch at 2
intra-op threads, as tests/test_torch_gluon_cifar.py runs its example.
"""
import contextlib
import io
import os
import random
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from test_torch_gluon_cifar import PORT_THREADS, ROOT, _torch_threads


@pytest.fixture(autouse=True)
def _keep_global_rng():
    """The example draws from np.random and random (its iterator
    shuffles by them) and both packages' global generators: other tests
    in this process must find them all as they were."""
    np_state, py_state = np.random.get_state(), random.getstate()
    j_state, t_state = jmx.random.get_state(), tmx.random.get_state()
    yield
    np.random.set_state(np_state)
    random.setstate(py_state)
    jmx.random.set_state(j_state)
    tmx.random.set_state(t_state)


def _run_example(package):
    """examples/lstm_bucketing.py's program with ``mxnet_tpu`` replaced by
    ``package`` in its import (nothing else changed), on the CPU; returns
    (exit code, printed text)."""
    path = os.path.join(ROOT, "examples", "lstm_bucketing.py")
    src = open(path).read()
    if package != "mxnet_tpu":
        src = src.replace("import mxnet_tpu as mx",
                          f"import {package} as mx")
    argv, sys.argv = sys.argv, [path, "--ctx", "cpu"]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            exec(compile(src, path, "exec"), {"__name__": "__main__",
                                              "__file__": path})
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = argv
    return code, buf.getvalue()


@pytest.mark.parametrize("package", ["mxnet_tpu_torch", "mxnet_tpu"])
def test_lstm_bucketing_example_runs_in_both_packages(package):
    with _torch_threads(PORT_THREADS):
        code, text = _run_example(package)
    assert code == 0, (package, text)
    assert "final train perplexity:" in text, (package, text)
