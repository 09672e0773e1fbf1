"""Pretrained model store (counterpart of
mxnet_tpu/gluon/model_zoo/vision/model_store.py).

The sha1 table lists the published checksums of the reference's
pretrained weight files. ``get_model_file`` looks for
``{name}-{shorthash}.params`` under the cache root (``MXNET_HOME``,
default ``~/.mxnet``, then ``models``) and checks its sha1; else serves a
file matched by name alone (with a warning: it cannot be verified); else
fetches ``{name}-{shorthash}.zip`` from ``MXNET_GLUON_REPO`` through
``gluon.utils.download``, which copies ``file://`` URLs and refuses any
other, and raises when that fails.
"""
from __future__ import annotations

import logging
import os
import zipfile

from ....base import MXNetError
from ...utils import check_sha1, download

__all__ = ["get_model_file", "purge", "short_hash"]

# published sha1 of each reference pretrained .params file
# (reference model_store.py:27-62)
_model_sha1 = {name: checksum for checksum, name in [
    ("44335d1f0046b328243b32a26a4fbd62d9057b45", "alexnet"),
    ("f27dbf2dbd5ce9a80b102d89c7483342cd33cb31", "densenet121"),
    ("b6c8a95717e3e761bd88d145f4d0a214aaa515dc", "densenet161"),
    ("2603f878403c6aa5a71a124c4a3307143d6820e9", "densenet169"),
    ("1cdbc116bc3a1b65832b18cf53e1cb8e7da017eb", "densenet201"),
    ("ed47ec45a937b656fcc94dabde85495bbef5ba1f", "inceptionv3"),
    ("9f83e440996887baf91a6aff1cccc1c903a64274", "mobilenet0.25"),
    ("8e9d539cc66aa5efa71c4b6af983b936ab8701c3", "mobilenet0.5"),
    ("529b2c7f4934e6cb851155b22c96c9ab0a7c4dc2", "mobilenet0.75"),
    ("6b8c5106c730e8750bcd82ceb75220a3351157cd", "mobilenet1.0"),
    ("36da4ff1867abccd32b29592d79fc753bca5a215", "mobilenetv2_1.0"),
    ("e2be7b72a79fe4a750d1dd415afedf01c3ea818d", "mobilenetv2_0.75"),
    ("aabd26cd335379fcb72ae6c8fac45a70eab11785", "mobilenetv2_0.5"),
    ("ae8f9392789b04822cbb1d98c27283fc5f8aa0a7", "mobilenetv2_0.25"),
    ("e54b379f50fa4b10bbd2506237e3bd74e6164778", "resnet18_v1"),
    ("c1dc0967a3d25ee9127e03bc1046a5d44d92e2ba", "resnet34_v1"),
    ("c940b1a062b32e3a5762f397c9d1e178b5abd007", "resnet50_v1"),
    ("d992389084bc5475c370e9b52c3561706e755799", "resnet101_v1"),
    ("48ce7775d375987d019ec9aa96bc43b98165dfcb", "resnet152_v1"),
    ("84f666402577b5b79cd59eba5d3ba0bc1edf2152", "resnet18_v2"),
    ("5da34c2772893e9d680d5fa0bd6d432eba8689c9", "resnet34_v2"),
    ("81a4e66af7859a5aa904e2b4051aa0d3bc472b2f", "resnet50_v2"),
    ("7eb2b3cde097883c11941b927048a705ed334294", "resnet101_v2"),
    ("64c75ac8c292f6ac54f873f9ef62e0531105878b", "resnet152_v2"),
    ("264ba4970a0cc87a4f15c96e25246a1307caf523", "squeezenet1.0"),
    ("33ba0f93753c83d86e1eb397f38a667eaf2e9376", "squeezenet1.1"),
    ("dd221b160977f36a53f464cb54648d227c707a05", "vgg11"),
    ("ee79a8098a91fbe05b7a973fed2017a6117723a8", "vgg11_bn"),
    ("6bc5de58a05a5e2e7f493e2d75a580d83efde38c", "vgg13"),
    ("7d97a06c3c7a1aecc88b6e7385c2b373a249e95e", "vgg13_bn"),
    ("649467530119c0f78c4859999e264e7bf14471a9", "vgg16"),
    ("6b9dbe6194e5bfed30fd7a7c9a71f7e5a276cb14", "vgg16_bn"),
    ("f713436691eee9a20d70a145ce0d53ed24bf7399", "vgg19"),
    ("9730961c9cea43fd7eeefb00d792e386c45847d6", "vgg19_bn")]}

apache_repo_url = \
    "https://apache-mxnet.s3-accelerate.dualstack.amazonaws.com/"
_url_format = "{repo_url}gluon/models/{file_name}.zip"


def short_hash(name):
    if name not in _model_sha1:
        raise ValueError(f"Pretrained model for {name} is not available.")
    return _model_sha1[name][:8]


def _default_root(root):
    root = os.path.expanduser(root or os.environ.get(
        "MXNET_HOME", os.path.join("~", ".mxnet")))
    if not root.endswith("models"):
        root = os.path.join(root, "models")
    return root


def _local_unverified(name, root):
    """Offline fallback: a cache file matching by NAME only (hand-placed
    `{name}.params` or epoch-suffixed checkpoint)."""
    cand = os.path.join(root, f"{name}.params")
    if os.path.exists(cand):
        return cand
    if os.path.isdir(root):
        cands = sorted(f for f in os.listdir(root)
                       if f.startswith(name + "-")
                       and f.endswith(".params"))
        if cands:
            return os.path.join(root, cands[-1])
    return None


def get_model_file(name, root=None):
    """Resolve (verify, and if needed fetch) a pretrained .params file.

    Resolution order: sha1-verified `{name}-{shorthash}.params` in the
    cache; else a name-matched local file (warned, unverifiable
    offline); else download `{name}-{shorthash}.zip` from
    MXNET_GLUON_REPO (file:// works without egress) and verify.
    """
    root = _default_root(root)
    if name in _model_sha1:
        file_name = f"{name}-{short_hash(name)}"
        file_path = os.path.join(root, file_name + ".params")
        sha1_hash = _model_sha1[name]
        if os.path.exists(file_path):
            if check_sha1(file_path, sha1_hash):
                return file_path
            logging.warning(
                "Mismatch in the content of model file %s detected. "
                "Downloading again.", file_path)
        local = _local_unverified(name, root)
        if local is not None and local != file_path:
            logging.warning(
                "Serving name-matched local model file %s WITHOUT sha1 "
                "verification (no verified %s.params in cache).",
                local, file_name)
            return local
        os.makedirs(root, exist_ok=True)
        zip_file_path = os.path.join(root, file_name + ".zip")
        repo_url = os.environ.get("MXNET_GLUON_REPO", apache_repo_url)
        if not repo_url.endswith("/"):
            repo_url += "/"
        try:
            download(_url_format.format(repo_url=repo_url,
                                        file_name=file_name),
                     path=zip_file_path, overwrite=True)
            with zipfile.ZipFile(zip_file_path) as zf:
                zf.extractall(root)
            os.remove(zip_file_path)
            if not os.path.exists(file_path):
                raise MXNetError(
                    f"fetched zip did not contain {file_name}.params at "
                    "its top level")
        # OSError covers the file:// mirror path (missing/unreadable zip),
        # BadZipFile a corrupt one — the operator must always get the
        # actionable message, not a raw traceback
        except (MXNetError, OSError, zipfile.BadZipFile) as e:
            raise MXNetError(
                f"Pretrained model {name!r}: no verified or local copy "
                f"under {root} and the fetch failed ({e}). Place "
                f"{file_name}.params there manually or set "
                "MXNET_GLUON_REPO to a reachable (file://) mirror.")
        if check_sha1(file_path, sha1_hash):
            return file_path
        raise MXNetError(
            f"Downloaded file for {name} has a sha1 mismatch — the repo "
            "copy may be corrupted or outdated.")
    # names outside the published table: local-only resolution
    local = _local_unverified(name, root)
    if local is not None:
        return local
    raise MXNetError(
        f"Pretrained model file for {name!r} not found under {root} and "
        "no published checksum exists for it. Place the .params file "
        "there manually, or use pretrained=False.")


def purge(root=None):
    root = _default_root(root)
    if os.path.isdir(root):
        for f in os.listdir(root):
            if f.endswith(".params"):
                os.remove(os.path.join(root, f))
