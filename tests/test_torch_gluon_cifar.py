"""``examples/gluon_cifar.py`` run as it is in the JAX package and with
only its import changed on the port (``mxnet_tpu_torch``), on the CPU:
both reach the example's own accuracy bar (its exit code 0) and print
"step 30:". One case a package, in a file of its own, so that pytest-
xdist's file groups (``--dist loadfile``) run it beside the other
files. Torch is held to 2 intra-op threads (the port's case uses them),
which several test processes sharing the host's cores would otherwise
oversubscribe.
"""
import contextlib
import io
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_THREADS = 2


def _run_example(package):
    """examples/gluon_cifar.py's program with ``mxnet_tpu`` replaced by
    ``package`` in its imports (nothing else changed), on the CPU;
    returns (exit code, printed text)."""
    path = os.path.join(ROOT, "examples", "gluon_cifar.py")
    src = open(path).read()
    if package != "mxnet_tpu":
        src = src.replace("import mxnet_tpu as mx",
                          f"import {package} as mx")
        src = src.replace("from mxnet_tpu import", f"from {package} import")
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


@contextlib.contextmanager
def _torch_threads(n):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.mark.parametrize("package", ["mxnet_tpu_torch", "mxnet_tpu"])
def test_gluon_cifar_example_runs_in_both_packages(package):
    with _torch_threads(PORT_THREADS):
        code, text = _run_example(package)
    assert code == 0, (package, text)
    assert "step 30:" in text, (package, text)
