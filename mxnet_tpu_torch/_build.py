"""Build and load the port's CUDA kernels at first use.

Every ``mxnet_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C interface,
linked against the toolkit libraries its ``mxt-link`` line names (the
nvJPEG codec's ``-lnvjpeg``), all sources in parallel, into
``build/kernels/`` beside the package. The file names carry a hash of
the sources and flags, so an edited kernel is rebuilt and an unchanged
one is loaded as it is. Libraries are loaded
with ``ctypes``: pointers and the stream are ``c_void_p``, and every C
entry returns ``cudaGetLastError()``, which :func:`check` turns into an
error. Nothing here includes PyTorch's headers, so a build takes seconds.

Nothing is compiled or loaded when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .base import MXNetError

__all__ = ["build", "library", "bind", "launches", "add_launches", "check",
           "FLAGS", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS = {}
_BOUND = {}
# what the last build did: seconds, per-source compiler output (ptxas -v
# register/shared-memory report, kept beside each library and read back
# when it is reused), and which sources it built
last_build = {}
# a source that needs a library of the toolkit names it on a line of its
# own, "// mxt-link: -lname": those flags are added to its nvcc command
# only (the key hashes every source's text, so a changed line rebuilds)
_LINK = "// mxt-link:"


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise MXNetError("nvcc not found (set CUDA_HOME): the port's kernels "
                     "are built from mxnet_tpu_torch/csrc at first use")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _link_flags(src):
    """The source's own ``mxt-link`` flags, and the toolkit's library
    directory to find them in at build and at load time."""
    flags = []
    for line in src.read_text().splitlines():
        if line.startswith(_LINK):
            flags += line[len(_LINK):].split()
    if not flags:
        return []
    lib = os.path.join(os.path.dirname(os.path.dirname(_nvcc())), "lib64")
    return ["-L", lib, "-Xlinker", "-rpath," + lib, *flags]


def _key():
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile every source whose library is missing, all at once; return
    {stem: path}. Raises with the compiler's output when one fails."""
    key = _key()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out, procs = {}, {}
    for src in _sources():
        lib = BUILD_DIR / f"{src.stem}-{key}.so"
        out[src.stem] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(".so.tmp%d" % os.getpid())
        cmd = [_nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src),
               *_link_flags(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, lib)
    logs, failed = {}, []
    for stem, (p, tmp, lib) in procs.items():
        logs[stem] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(stem)
        else:
            lib.with_suffix(".log").write_text(logs[stem])
            os.replace(tmp, lib)
    for stem, lib in out.items():     # a reused library's compiler report
        log = lib.with_suffix(".log")
        if stem not in logs and log.exists():
            logs[stem] = log.read_text()
    last_build.clear()
    last_build.update(seconds=time.perf_counter() - t0, logs=logs,
                      built=sorted(procs), key=key)
    if failed:
        raise MXNetError("nvcc failed for %s:\n%s" % (
            ", ".join(failed), "\n".join(logs[s] for s in failed)))
    return out


def library(stem):
    """The loaded ctypes library of ``csrc/<stem>.cu`` (building all
    sources on first use)."""
    with _LOCK:
        if not _LIBS:
            for name, path in build().items():
                _LIBS[name] = ctypes.CDLL(str(path))
        return _LIBS[stem]


def bind(stem, name, *argtypes):
    """ctypes entry ``name`` of ``csrc/<stem>.cu`` with its argtypes set
    and an int (cudaError_t) result."""
    fn = _BOUND.get((stem, name))
    if fn is None:
        fn = getattr(library(stem), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _BOUND[(stem, name)] = fn
    return fn


def launches(stem):
    """Kernel launches the library of ``csrc/<stem>.cu`` has made in this
    process: its launch sites count each launch (``mxt_launches``)."""
    fn = _BOUND.get((stem, "mxt_launches"))
    if fn is None:
        fn = getattr(library(stem), "mxt_launches")
        fn.argtypes = []
        fn.restype = ctypes.c_ulonglong
        _BOUND[(stem, "mxt_launches")] = fn
    return int(fn())


def add_launches(stem, n):
    """Add ``n`` to the launch count of ``csrc/<stem>.cu``: the kernels a
    CUDA graph replay launches, which pass no launch site."""
    fn = _BOUND.get((stem, "mxt_add_launches"))
    if fn is None:
        fn = getattr(library(stem), "mxt_add_launches")
        fn.argtypes = [ctypes.c_ulonglong]
        fn.restype = None
        _BOUND[(stem, "mxt_add_launches")] = fn
    fn(int(n))


def check(err, stem, what):
    if err:
        msg = library(stem).mxt_error_string
        msg.restype = ctypes.c_char_p
        msg.argtypes = [ctypes.c_int]
        raise MXNetError("%s: CUDA error %d (%s)"
                         % (what, err, msg(err).decode()))
