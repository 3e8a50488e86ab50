"""Read and write the JAX package's `.roar` bundles without flax.

A bundle (roar_tpu/training/save_restore.py:19-65) is a tar holding
`model_config.yaml` and `model_weights.msgpack`, the flax msgpack encoding of
the parameter tree: nested maps whose array leaves are msgpack ext type 1,
`(shape, dtype name, raw bytes)`; arrays over flax's chunk limit are stored as
`{'__msgpack_chunked_array__': True, 'shape': ..., 'chunks': ...}`.  `save_to`
writes the same encoding, so roar_tpu's `restore_from` reads the port's
bundles.  pyyaml and msgpack are imported here only, when a bundle is read
or written.
`transfer_params` is the JAX package's warm start on such trees.
"""

from __future__ import annotations

import io
import tarfile
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

_CONFIG_NAME = "model_config.yaml"
_WEIGHTS_NAME = "model_weights.msgpack"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_MAX_CHUNK_BYTES = 2 ** 30  # flax's MAX_CHUNK_SIZE: larger arrays are stored in chunks


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


def _pack_ndarray(arr: np.ndarray):
    import msgpack

    arr = np.asarray(arr, order="C")  # not ascontiguousarray: it makes a 0-d array 1-d
    data = msgpack.packb((list(arr.shape), arr.dtype.name, arr.tobytes()), use_bin_type=True)
    return msgpack.ExtType(_EXT_NDARRAY, data)


def _chunk(arr: np.ndarray) -> Dict[str, Any]:
    flat = arr.reshape(-1)
    per = max(1, _MAX_CHUNK_BYTES // arr.dtype.itemsize)
    chunks = [flat[i : i + per] for i in range(0, flat.size, per)]
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): int(n) for i, n in enumerate(arr.shape)},
            "chunks": {str(i): _pack_ndarray(c) for i, c in enumerate(chunks)}}


def _encode(node):
    if isinstance(node, Mapping):  # keys sorted, as flax writes them
        return {str(k): _encode(node[k]) for k in sorted(node)}
    if isinstance(node, torch.Tensor):
        node = node.detach().cpu().numpy()
    arr = np.asarray(node)
    if arr.dtype == object:
        raise TypeError(f"cannot store {type(node).__name__} in a bundle")
    return _chunk(arr) if arr.nbytes > _MAX_CHUNK_BYTES else _pack_ndarray(arr)


def msgpack_serialize(tree: Mapping[str, Any]) -> bytes:
    """flax `serialization.msgpack_serialize` of a nested dict of arrays."""
    import msgpack

    return msgpack.packb(_encode(tree), use_bin_type=True)


def save_to(path: str, cfg: Dict[str, Any], params: Mapping[str, Any]) -> None:
    """Write a `.roar` bundle: the config dict and a nested dict of arrays
    (numpy or torch), in the layouts of the JAX package."""
    import yaml

    blob = msgpack_serialize(params)
    cfg_bytes = yaml.safe_dump(cfg, sort_keys=False, allow_unicode=True).encode()
    with tarfile.open(path, "w") as tar:
        for name, data in ((_CONFIG_NAME, cfg_bytes), (_WEIGHTS_NAME, blob)):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


def _flat_paths(tree: Mapping[str, Any], prefix: str = ""):
    """('/'-joined path, leaf) of a nested dict, keys in sorted order (the
    order `jax.tree_util` walks a dict in)."""
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flat_paths(value, path + "/")
        else:
            yield path, value


def transfer_params(target: Mapping[str, Any], source: Mapping[str, Any],
                    include: Optional[List[str]] = None, exclude: Optional[List[str]] = None
                    ) -> Tuple[Dict[str, Any], List[str], List[str]]:
    """Warm start (roar_tpu/training/save_restore.py:68-110): copy each leaf
    of `source` into `target` where the '/'-joined paths are equal and the
    shapes agree; `include` / `exclude` are substring filters on the path.
    Both are nested dicts of arrays (a `.roar` bundle's tree, or
    `convert.fastpitch_to_jax_tree`'s).  Returns (new target, loaded paths,
    skipped paths); `target` is not modified."""
    src = dict(_flat_paths(source))
    loaded, skipped = [], []

    def build(node, prefix):
        out = {}
        for key in sorted(node):
            value, path = node[key], f"{prefix}{key}"
            if isinstance(value, Mapping):
                out[key] = build(value, path + "/")
                continue
            candidate = src.get(path)
            ok = candidate is not None and np.shape(candidate) == np.shape(value)
            if ok and include:
                ok = any(s in path for s in include)
            if ok and exclude:
                ok = not any(s in path for s in exclude)
            (loaded if ok else skipped).append(path)
            out[key] = candidate if ok else value
        return out

    return build(target, ""), loaded, skipped
