"""mxnet_tpu_torch.rtc on the CPU: what runs without a card.

The two packages mirror each other: the JAX package compiles Pallas
source at run time and its ``CudaModule`` raises; the port compiles CUDA
C++ through NVRTC and its ``PallasModule`` raises. Here: the C signature
parser, the argument count and type checks of a launch, and both
modules' refusals. The compiling and launching cases (round trip,
compile error with NVRTC's log, ``no kernel``, ``exports``, ``expects``)
are marked ``cuda`` in tests/test_torch_kernels_cuda.py.
"""
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu_torch import MXNetError, rtc


def test_signature_parsing():
    assert rtc.parse_signature("const float *x, float *y, int n") == [
        (True, True, "float"), (True, False, "float"), (False, False, "int")]
    assert rtc.parse_signature("  double*a ,int64_t  n,__half h") == [
        (True, False, "double"), (False, False, "int64_t"),
        (False, False, "__half")]


@pytest.mark.parametrize("bad,match", [
    ("const *x", "invalid kernel parameter"),
    ("float x y z", "invalid kernel parameter"),
    ("float **x", "invalid kernel parameter"),
    ("unsigned long n", "invalid kernel parameter"),
    ("size_t n", "unsupported kernel parameter type"),
    ("const float *x,", "invalid kernel parameter")])
def test_signature_parsing_refuses(bad, match):
    with pytest.raises(MXNetError, match=match):
        rtc.parse_signature(bad)


def _kernel(sig):
    # a kernel object without a module: enough for the argument checks,
    # which run before anything touches the CUDA driver
    return rtc.CudaKernel(None, "k", None, rtc.parse_signature(sig))


def test_launch_arguments_are_counted_and_typed():
    cpu = torch.device("cpu")
    k = _kernel("const float *x, float *y, int n, __half h")
    with pytest.raises(MXNetError, match="expects 4 arguments, got 2"):
        k._pack([torch.zeros(2), torch.zeros(2)], cpu)
    with pytest.raises(MXNetError, match="takes torch.float32, got "
                                         "torch.int32"):
        k._pack([torch.zeros(2, dtype=torch.int32), torch.zeros(2), 2, 1.0],
                cpu)
    with pytest.raises(MXNetError, match="takes a tensor or a device "
                                         "pointer, got float"):
        k._pack([1.5, torch.zeros(2), 2, 1.0], cpu)
    with pytest.raises(MXNetError, match="int takes a number, got str"):
        k._pack([torch.zeros(2), torch.zeros(2), "2", 1.0], cpu)
    with pytest.raises(MXNetError, match="the kernel runs on"):
        k._pack([torch.zeros(2), torch.zeros(2), 2, 1.0],
                torch.device("cuda", 0))
    vals = k._pack([torch.zeros(2), 4096, 7, 1.0], cpu)
    assert vals[1].value == 4096 and vals[2].value == 7
    assert vals[3].value == 0x3C00           # 1.0 as IEEE half bits


def test_pallas_module_raises_and_names_cuda_module():
    with pytest.raises(MXNetError, match="CudaModule"):
        rtc.PallasModule("def k(x_ref, o_ref):\n    o_ref[:] = x_ref[:]")
    # the mirror: the JAX package refuses CUDA source and names Pallas
    with pytest.raises(jmx.MXNetError, match="Pallas"):
        jmx.rtc.CudaModule('extern "C" __global__ void k() {}')


def test_cuda_module_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the module compiles there")
    with pytest.raises(MXNetError, match="no CUDA device"):
        rtc.CudaModule('extern "C" __global__ void k() {}')
