"""Read the JAX package's `.roar` bundles without flax.

A bundle (roar_tpu/training/save_restore.py:19-65) is a tar holding
`model_config.yaml` and `model_weights.msgpack`, the flax msgpack encoding of
the parameter tree: nested maps whose array leaves are msgpack ext type 1,
`(shape, dtype name, raw bytes)`; arrays over flax's chunk limit are stored as
`{'__msgpack_chunked_array__': True, 'shape': ..., 'chunks': ...}`.  pyyaml and
msgpack are imported here only, when a bundle is read.
"""

from __future__ import annotations

import tarfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

_CONFIG_NAME = "model_config.yaml"
_WEIGHTS_NAME = "model_weights.msgpack"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _ndarray(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype, buffer = msgpack.unpackb(data, raw=True)
    if dtype == b"bfloat16":  # numpy has no bfloat16: widen through torch
        flat = torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16).float().numpy()
    else:
        flat = np.frombuffer(buffer, dtype=np.dtype(dtype.decode()))
    return flat.reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(node):
    if isinstance(node, dict):
        if node.get("__msgpack_chunked_array__"):
            shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    return node


def msgpack_restore(blob: bytes) -> Dict[str, Any]:
    """flax `serialization.msgpack_restore`, without flax."""
    import msgpack

    return _unchunk(msgpack.unpackb(blob, ext_hook=_ext_hook, raw=False))


def restore_from(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read a `.roar` bundle: (config dict, raw parameter tree)."""
    import yaml

    with tarfile.open(path, "r") as tar:
        cfg = yaml.safe_load(tar.extractfile(_CONFIG_NAME).read())
        blob = tar.extractfile(_WEIGHTS_NAME).read()
    return cfg, msgpack_restore(blob)
