"""The JAX package's parameters as the port's tensors.

The JAX package hands parameters around as ``{name: np.ndarray}`` dicts
(``DecodeModel.init_params``, a Gluon net's ``collect_params()`` values)
and stores them in ``.mxa`` artifacts whose ``params.bin`` is the
reference NDArray container. This module turns either into torch
tensors, and carries a Gluon net's weights across by parameter name
(:func:`load_gluon_params`, :func:`gluon_params_to_numpy`) and a
Module's (:func:`load_module_params`, :func:`module_params_to_numpy`;
checkpoints need nothing here: ``model.save_checkpoint`` /
``load_checkpoint`` write and read the JAX package's files as they are),
and a data-parallel trainer's state (:func:`dp_state_from_jax`,
:func:`dp_state_to_numpy`: the dicts ``DataParallelTrainer.
export_training_state`` writes, so a run continues in the other package):

* float and int8 arrays are kept as they are (no dtype change);
* fp8 arrives either as an ``float8_e4m3fn`` numpy array (a JAX-side
  dict; recognised by its dtype name) or as the ``uint8`` bytes an
  artifact stores (its manifest's ``quant`` block names them); both
  become ``torch.float8_e4m3fn`` with the same bytes.
"""
from __future__ import annotations

import json
import zipfile

import numpy as np
import torch

from .base import MXNetError
from .ndarray.container import _read_container_dense

__all__ = ["to_tensor", "to_torch_params", "load_decode_artifact",
           "load_gluon_params", "gluon_params_to_numpy", "load_module_params",
           "module_params_to_numpy", "dp_state_from_jax", "dp_state_to_numpy"]


def to_tensor(a, device=None, fp8=False):
    """One array as a tensor (``fp8=True``: uint8 bytes are e4m3fn)."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.asarray(a)
        if a.dtype.name == "float8_e4m3fn":
            a, fp8 = a.view(np.uint8), True
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:      # container reads are buffer views
            a = a.copy()
        t = torch.from_numpy(a)
    if fp8 and t.dtype == torch.uint8:
        t = t.view(torch.float8_e4m3fn)
    return t if device is None else t.to(device)


def to_torch_params(params, device=None, fp8_names=()):
    """{name: array} -> {name: tensor on ``device``}; names in
    ``fp8_names`` hold e4m3fn bytes stored as uint8."""
    fp8_names = set(fp8_names)
    return {n: to_tensor(v, device, n in fp8_names)
            for n, v in params.items()}


def load_decode_artifact(path):
    """Read a decode ``.mxa`` written by the JAX package
    (contrib.export.export_decode_model): manifest ``decode`` block ->
    model config, params.bin -> {name: tensor} on the CPU (fp8 viewed
    back from its uint8 bytes). Returns (config, params, model_name,
    quant)."""
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read("MANIFEST.json"))
        raw = _read_container_dense(zf.read("params.bin"))
    dec = manifest.get("decode")
    if dec is None:
        raise MXNetError(f"{path}: no 'decode' block in manifest — not a "
                         "decode artifact")
    params = {n.split(":", 1)[1]: v for n, v in raw.items()}
    quant = manifest.get("quant")
    fp8 = quant.get("params", []) if quant and quant.get("dtype") == "fp8" \
        else ()
    return dec, to_torch_params(params, fp8_names=fp8), \
        manifest.get("model_name"), quant


def load_gluon_params(net, arrays, ctx=None):
    """Install ``{name: array}`` (the JAX package's
    ``{n: p.data().asnumpy() for n, p in net.collect_params().items()}``,
    or NDArrays) into the port's ``net`` (a model-zoo net, a
    ``SymbolBlock``, any Block), keyed by the same ``collect_params``
    names: weights, and aux states such as BatchNorm's ``running_mean`` /
    ``running_var`` (grad_req "null") alike. A parameter not yet
    initialized (or deferred, or of a shape still unknown) is created on
    ``ctx`` (default: the card) with the array's shape; one already
    initialized keeps its device."""
    params = net.collect_params()
    missing = [n for n in params.keys() if n not in arrays]
    if missing:
        raise MXNetError(f"load_gluon_params: no value for {missing[:5]}")
    extra = [n for n in arrays if n not in params]
    if extra:
        raise MXNetError(f"load_gluon_params: {extra[:5]} are not "
                         "parameters of the net")
    for name, p in params.items():
        a = arrays[name]
        p._load_init(a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a),
                     ctx)


def gluon_params_to_numpy(net):
    """{collect_params name: numpy array} of the port's ``net``."""
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def load_module_params(mod, arg_params, aux_params=None,
                       allow_missing=False):
    """Install the JAX package's Module parameters (``{name: numpy}``
    dicts, e.g. ``{n: a.asnumpy() for n, a in jmod.get_params()[0]
    .items()}``) into the bound port Module ``mod``, on its device."""
    from .ndarray.ndarray import array
    from .context import cpu

    def nds(d):
        return {n: array(np.asarray(v), ctx=cpu(), dtype=np.asarray(v).dtype)
                for n, v in (d or {}).items()}
    mod.set_params(nds(arg_params), nds(aux_params),
                   allow_missing=allow_missing, force_init=True)


def module_params_to_numpy(mod):
    """(arg_params, aux_params) of the port Module ``mod`` as
    ``{name: numpy}`` dicts (what the JAX package's ``set_params``
    takes after ``mx.nd.array``)."""
    args, auxs = mod.get_params()
    return ({n: a.asnumpy() for n, a in args.items()},
            {n: a.asnumpy() for n, a in auxs.items()})


def dp_state_from_jax(trainer, arrays, meta):
    """The port trainer's (params, states, aux) tuples from the JAX
    package's ``DataParallelTrainer.export_training_state`` output
    (``param:<name>``, ``opt:<name>:<i>``, ``aux:<name>`` numpy arrays and
    its meta); the trainer's step count ``t`` is restored, so Adam's bias
    correction continues. The JAX rng key does not carry over. The full
    parameters go in whatever the trainer's plan: a tensor-parallel
    trainer (``param_specs``) gives each model rank its shard, a ZeRO
    trainer on an N-D mesh packs them into its joint shards."""
    return trainer.import_training_state(
        {k: np.asarray(v) for k, v in arrays.items()}, dict(meta))


def dp_state_to_numpy(trainer, params, states, aux):
    """(arrays, meta) in the JAX package's export format from the port
    trainer's tuples: what ``mxnet_tpu``'s
    ``DataParallelTrainer.import_training_state`` takes (its rng entry
    None, so that package keeps its own key); the full parameters and
    states, also of a tensor-parallel or N-D ZeRO trainer."""
    return trainer.export_training_state(params, states, aux)
