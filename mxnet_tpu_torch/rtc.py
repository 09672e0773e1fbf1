"""Runtime kernel compilation — mx.rtc on the card.

Counterpart of mxnet_tpu/rtc.py, the other way round. There, CUDA source
raises (its ``CudaModule`` is a stub) and Pallas source is compiled at run
time. Here :class:`CudaModule` is MXNet 1.x's API (python/mxnet/rtc.py,
src/common/rtc.cc): CUDA C++ compiled by NVRTC to an ``sm_90a`` cubin,
loaded through the CUDA driver API, and launched on PyTorch's current stream;
:class:`PallasModule` raises and names it.

    mod = rtc.CudaModule(r'''
    extern "C" __global__ void axpy(const float* x, float* y, float a,
                                    int n) {
      int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) y[i] += a * x[i];
    }''')
    k = mod.get_kernel("axpy", "const float *x, float *y, float a, int n")
    k.launch([x, y, 2.0, n], mx.gpu(0), ((n + 255) // 256, 1, 1),
             (256, 1, 1))

Arguments are CUDA ``torch.Tensor``s or NDArrays (or integer device
pointers) for pointer parameters and Python numbers for scalars. The launch does not
synchronise. Both libraries are loaded with ``ctypes`` at first use:
``libnvrtc.so`` from the toolkit that holds ``nvcc`` (``$CUDA_HOME``) and
the CUDA driver's ``libcuda.so.1``. Nothing is loaded when the module is
imported.
"""
from __future__ import annotations

import ctypes
import glob
import os
import re
import threading

import numpy as np
import torch

from . import _build
from .base import MXNetError
from .context import resolve_device

__all__ = ["CudaModule", "CudaKernel", "PallasModule"]

# C type -> (torch dtype of a pointer's tensor, ctypes type of a scalar):
# MXNet's _DTYPE_CPP_TO_NP
_CTYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, ctypes.c_uint16),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int8_t": (torch.int8, ctypes.c_int8),
    "char": (torch.int8, ctypes.c_int8),
    "int64_t": (torch.int64, ctypes.c_int64),
}
_ARG = re.compile(r"^\s*(const)?\s*([\w]+)\s*(\*)?\s*([\w]+)?\s*$")
_ARCH = "--gpu-architecture=sm_90a"

_LOCK = threading.Lock()
_LIBS = {}
_CONTEXTS = {}


def parse_signature(signature):
    """``"const float *x, float *y, int n"`` -> [(is_pointer, is_const,
    C type)], one per parameter; raises on anything else."""
    out = []
    for arg in re.sub(r"\s+", " ", signature).split(","):
        m = _ARG.match(arg)
        if not m or m.group(2) == "const":
            raise MXNetError(f'invalid kernel parameter "{arg.strip()}": '
                             'must be "(const) type (*) (name)"')
        if m.group(2) not in _CTYPES:
            raise MXNetError(f'unsupported kernel parameter type in '
                             f'"{arg.strip()}"; supported: '
                             f'{", ".join(_CTYPES)}')
        out.append((bool(m.group(3)), bool(m.group(1)), m.group(2)))
    return out


def _libs():
    """(nvrtc, cuda) ctypes libraries, loaded once."""
    with _LOCK:
        if not _LIBS:
            home = os.path.dirname(os.path.dirname(_build._nvcc()))
            cands = [p for d in ("lib64", "lib",
                                 os.path.join("targets", "x86_64-linux",
                                              "lib"))
                     for p in sorted(glob.glob(
                         os.path.join(home, d, "libnvrtc.so*")))]
            if not cands:
                raise MXNetError(f"libnvrtc.so not found under {home}")
            nvrtc = ctypes.CDLL(cands[0])
            nvrtc.nvrtcGetErrorString.restype = ctypes.c_char_p
            cuda = ctypes.CDLL("libcuda.so.1")
            _LIBS.update(nvrtc=nvrtc, cuda=cuda)
            _cu(cuda.cuInit(0), "cuInit")
        return _LIBS["nvrtc"], _LIBS["cuda"]


def _cu(res, what):
    """Raise on a CUresult other than CUDA_SUCCESS, with its string."""
    if res:
        msg = ctypes.c_char_p()
        _LIBS["cuda"].cuGetErrorString(res, ctypes.byref(msg))
        raise MXNetError(f"{what}: CUDA driver error {res} "
                         f"({(msg.value or b'?').decode()})")


def _nv(res, what):
    if res:
        raise MXNetError(f"{what}: NVRTC error {res} "
                         f"({_LIBS['nvrtc'].nvrtcGetErrorString(res).decode()})")


def _make_current(index):
    """Make the device's primary context (PyTorch's own) current on this
    thread, retaining it once."""
    _, cuda = _libs()
    with _LOCK:
        ctx = _CONTEXTS.get(index)
        if ctx is None:
            dev = ctypes.c_int()
            _cu(cuda.cuDeviceGet(ctypes.byref(dev), index), "cuDeviceGet")
            ctx = ctypes.c_void_p()
            _cu(cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                "cuDevicePrimaryCtxRetain")
            _CONTEXTS[index] = ctx
    _cu(cuda.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


def _compile(source, options, exports):
    """NVRTC: source -> (cubin bytes, {export: lowered name})."""
    nvrtc, _ = _libs()
    prog = ctypes.c_void_p()
    _nv(nvrtc.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                 b"rtc_source.cu", 0, None, None),
        "nvrtcCreateProgram")
    try:
        for name in exports:
            _nv(nvrtc.nvrtcAddNameExpression(prog, name.encode()),
                "nvrtcAddNameExpression")
        home = os.path.dirname(os.path.dirname(_build._nvcc()))
        opts = [_ARCH, "--std=c++17", f"--include-path={home}/include",
                *options]
        arr = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        res = nvrtc.nvrtcCompileProgram(prog, len(opts), arr)
        size = ctypes.c_size_t()
        nvrtc.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        log = ctypes.create_string_buffer(size.value)
        nvrtc.nvrtcGetProgramLog(prog, log)
        if res:
            raise MXNetError(
                "CudaModule: source failed to compile (%s)%s:\n%s" % (
                    nvrtc.nvrtcGetErrorString(res).decode(),
                    f" with exports {list(exports)}" if exports else "",
                    log.value.decode(errors="replace")))
        lowered = {}
        for name in exports:
            low = ctypes.c_char_p()
            if nvrtc.nvrtcGetLoweredName(prog, name.encode(),
                                         ctypes.byref(low)):
                raise MXNetError(f"CudaModule: exports {name!r} not found "
                                 "in the source")
            lowered[name] = low.value.decode()
        _nv(nvrtc.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
            "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nv(nvrtc.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin, lowered
    finally:
        nvrtc.nvrtcDestroyProgram(ctypes.byref(prog))


class CudaModule:
    """CUDA C++ compiled at run time by NVRTC for ``sm_90a``.

    ``options`` are passed to NVRTC after the architecture; ``exports``
    names C++ (mangled) kernels, templates included, so that
    :meth:`get_kernel` finds them by the name written in the source;
    ``extern "C"`` kernels need no export. Uses the default CUDA device
    and raises without one."""

    def __init__(self, source, options=(), exports=()):
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self._device = resolve_device(None)
        self._cuda = _libs()[1]
        self._module = None
        cubin, self._lowered = _compile(source, tuple(options),
                                        tuple(exports))
        _make_current(self._device.index)
        mod = ctypes.c_void_p()
        _cu(self._cuda.cuModuleLoadData(ctypes.byref(mod), cubin),
            "cuModuleLoadData")
        self._module = mod

    def get_kernel(self, name, signature):
        """The kernel ``name`` (an ``extern "C"`` name or one of
        ``exports``), its parameters given as a C ``signature``."""
        params = parse_signature(signature)
        _make_current(self._device.index)
        fn = ctypes.c_void_p()
        res = self._cuda.cuModuleGetFunction(
            ctypes.byref(fn), self._module,
            self._lowered.get(name, name).encode())
        if res:
            raise MXNetError(f"no kernel {name!r} in the module (a C++ "
                             "kernel must be listed in exports)")
        return CudaKernel(self, name, fn, params)

    def __del__(self):
        if getattr(self, "_module", None) is not None:
            try:
                _make_current(self._device.index)
                self._cuda.cuModuleUnload(self._module)
            except Exception:      # interpreter shutdown: nothing to free
                pass


def _dims(dims, what):
    dims = tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise MXNetError(f"{what} must be 1 to 3 positive ints, got {dims}")
    return dims + (1,) * (3 - len(dims))


def _unwrap(arg):
    """An NDArray argument is passed as its tensor."""
    from .ndarray.ndarray import NDArray
    return arg._data if isinstance(arg, NDArray) else arg


class CudaKernel:
    """A kernel of a :class:`CudaModule`; see :meth:`launch`. The class
    counts every launch of every such kernel in ``CudaKernel.launches``."""

    launches = 0

    def __init__(self, module, name, handle, params):
        self._module = module      # keeps the loaded module alive
        self._name = name
        self._handle = handle
        self._params = params

    def _pack(self, args, device):
        if len(args) != len(self._params):
            raise MXNetError(f"kernel {self._name!r} expects "
                             f"{len(self._params)} arguments, got "
                             f"{len(args)}")
        vals = []
        for i, (arg, (ptr, _, ctype)) in enumerate(zip(args, self._params)):
            dtype, scalar = _CTYPES[ctype]
            arg = _unwrap(arg)
            if ptr:
                if isinstance(arg, torch.Tensor):
                    if arg.device != device:
                        raise MXNetError(
                            f"kernel {self._name!r} argument {i}: tensor on "
                            f"{arg.device}, the kernel runs on {device}")
                    if arg.dtype != dtype:
                        raise MXNetError(
                            f"kernel {self._name!r} argument {i}: {ctype}* "
                            f"takes {dtype}, got {arg.dtype}")
                    vals.append(ctypes.c_void_p(arg.data_ptr()))
                elif isinstance(arg, int) and not isinstance(arg, bool):
                    vals.append(ctypes.c_void_p(arg))
                else:
                    raise MXNetError(
                        f"kernel {self._name!r} argument {i}: {ctype}* "
                        f"takes a tensor or a device pointer, got "
                        f"{type(arg).__name__}")
            elif isinstance(arg, (int, float, np.number)) \
                    and not isinstance(arg, bool):
                if ctype == "__half":
                    vals.append(scalar(int(np.float16(arg).view(np.uint16))))
                elif ctype in ("float", "double"):
                    vals.append(scalar(float(arg)))
                else:
                    vals.append(scalar(int(arg)))
            else:
                raise MXNetError(
                    f"kernel {self._name!r} argument {i}: {ctype} takes a "
                    f"number, got {type(arg).__name__}")
        return vals

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on PyTorch's current stream of ``ctx`` (a Context, a
        torch.device or a string; the module's device), without
        synchronising. ``grid_dims``/``block_dims`` are up to 3 ints;
        ``shared_mem`` is the dynamic shared memory in bytes."""
        device = resolve_device(ctx)
        if device != self._module._device:
            raise MXNetError(f"kernel {self._name!r} was loaded on "
                             f"{self._module._device}, not {device}")
        vals = self._pack(list(args), device)
        grid = _dims(grid_dims, "grid_dims")
        block = _dims(block_dims, "block_dims")
        cuda = self._module._cuda
        _make_current(device.index)
        params = (ctypes.c_void_p * len(vals))(
            *[ctypes.cast(ctypes.byref(v), ctypes.c_void_p) for v in vals])
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        res = cuda.cuLaunchKernel(self._handle,
                                  *[ctypes.c_uint(g) for g in grid],
                                  *[ctypes.c_uint(b) for b in block],
                                  ctypes.c_uint(int(shared_mem)), stream,
                                  params, None)
        CudaKernel.launches += 1
        _cu(res, f"kernel {self._name!r} launch")


class PallasModule:
    """Pallas source has no lowering to this card (the mirror of the JAX
    package's CudaModule stub)."""

    def __init__(self, source, exports=()):
        raise MXNetError(
            "PallasModule compiles Pallas kernels for a TPU: there is no "
            "lowering for Pallas source on this card. Use rtc.CudaModule "
            "with CUDA C++ (compiled at run time by NVRTC).")
