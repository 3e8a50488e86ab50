"""JAX parameter trees -> the port's torch state_dicts.

The reverse direction of roar_tpu/training/convert.py.  A JAX tree is nested
dicts of arrays, as `flax.serialization.to_state_dict`, `jax.device_get` or a
`.roar` bundle's msgpack give it.  Layouts:

- Dense kernel [in, out]       -> Linear weight [out, in]
- Conv kernel [k, in, out]     -> Conv1d weight [out, in, k]
- Embed embedding              -> Embedding weight
- LayerNorm scale / bias       -> LayerNorm weight / bias
- WeightNorm (kernel, scale)   -> one folded weight, as flax computes it:
  kernel * rsqrt(sum(kernel**2) + 1e-12) * scale, the sum taken over every
  axis but the feature axis (out for Conv, in for the generator's
  ConvTranspose, `feature_axes=1`); ConvTranspose kernels are also flipped.

Every converter raises on a JAX leaf it does not consume and on a port
parameter it leaves unfilled.  FastPitch `aligner_module` leaves are skipped:
the aligner serves training only and is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from roar_tpu_torch.models.fastpitch import ConvReLUNorm
from roar_tpu_torch.models.hifigan import Generator, ResBlock1
from roar_tpu_torch.models.submodules import ConditionalInput, ConditionalLayerNorm
from roar_tpu_torch.models.transformer import PositionwiseConvFF

WN_EPS = 1e-12  # flax nn.WeightNorm's epsilon
FASTPITCH_SKIPPED = ("aligner_module/",)


def flatten_params(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """{'a/b/c': array} from a nested dict, without a leading 'params' level."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for key, value in node.items():
            path = f"{prefix}{key}"
            if isinstance(value, Mapping):
                walk(value, path + "/")
            else:
                out[path] = np.asarray(value)

    walk(tree, "")
    return out


class _Leaves:
    """The JAX leaves, handed out once each."""

    def __init__(self, tree: Mapping[str, Any], skipped: Iterable[str] = ()):
        self.leaves = {k: v for k, v in flatten_params(tree).items()
                       if not k.startswith(tuple(skipped))}

    def take(self, path: str) -> np.ndarray:
        try:
            return self.leaves.pop(path).astype(np.float32)
        except KeyError:
            raise KeyError(f"port parameter left unfilled: no JAX leaf {path!r}") from None

    def check_consumed(self) -> None:
        if self.leaves:
            raise ValueError(f"JAX leaves not consumed by the port: {sorted(self.leaves)}")


def _load(module: nn.Module, sd: Dict[str, np.ndarray]) -> None:
    expected = set(module.state_dict())
    if set(sd) != expected:
        raise KeyError(f"port parameters left unfilled: {sorted(expected - set(sd))}")
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})


# ---------------------------------------------------------------------------
# FastPitch: the port mirrors the flax scopes, with these child renames
# ---------------------------------------------------------------------------


def _flax_child(parent: nn.Module, name: str) -> str:
    if isinstance(parent, ConditionalLayerNorm):
        return {"norm": "LayerNorm_0", "scale_proj": "Dense_0", "shift_proj": "Dense_1"}[name]
    if isinstance(parent, ConditionalInput):
        return "Dense_1" if name == "concat_proj" and hasattr(parent, "add_proj") else "Dense_0"
    if isinstance(parent, PositionwiseConvFF):
        return {"conv1": "Conv_0", "conv2": "Conv_1"}.get(name, name)
    if isinstance(parent, ConvReLUNorm) and name == "conv":
        return "Conv_0"
    return name


def _leaf_params(module: nn.Module, path: str, leaves: _Leaves) -> Dict[str, np.ndarray]:
    """The torch parameters of one leaf module, read from flax scope `path`."""
    if isinstance(module, nn.Linear):
        out = {"weight": leaves.take(f"{path}/kernel").T}
    elif isinstance(module, nn.Conv1d):
        out = {"weight": leaves.take(f"{path}/kernel").transpose(2, 1, 0)}
    elif isinstance(module, nn.Embedding):
        return {"weight": leaves.take(f"{path}/embedding")}
    elif isinstance(module, nn.LayerNorm):
        if not module.elementwise_affine:
            return {}
        return {"weight": leaves.take(f"{path}/scale"), "bias": leaves.take(f"{path}/bias")}
    else:
        raise TypeError(f"no conversion for {type(module).__name__} at {path}")
    if module.bias is not None:
        out["bias"] = leaves.take(f"{path}/bias")
    return out


def _mirror(module: nn.Module, torch_prefix: str, flax_prefix: str, leaves: _Leaves,
            sd: Dict[str, np.ndarray]) -> None:
    if next(module.parameters(), None) is None:
        return
    children = list(module.named_children())
    if not children:
        for k, v in _leaf_params(module, flax_prefix.rstrip("/"), leaves).items():
            sd[torch_prefix + k] = v
        return
    for name, child in children:
        if isinstance(child, nn.ModuleList):
            for i, sub in enumerate(child):
                _mirror(sub, f"{torch_prefix}{name}.{i}.", f"{flax_prefix}{name}_{i}/", leaves, sd)
        else:
            _mirror(child, f"{torch_prefix}{name}.", f"{flax_prefix}{_flax_child(module, name)}/",
                    leaves, sd)


def load_fastpitch_params(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Fill a port FastPitchModule from the JAX FastPitchModule's tree."""
    leaves = _Leaves(params, FASTPITCH_SKIPPED)
    sd: Dict[str, np.ndarray] = {}
    _mirror(module, "", "", leaves, sd)
    leaves.check_consumed()
    _load(module, sd)
    return module


# ---------------------------------------------------------------------------
# HiFi-GAN generator: weight-normed layers, flax scopes named by construction
# ---------------------------------------------------------------------------


def _fold(kernel: np.ndarray, scale: np.ndarray, feature_axis: int) -> np.ndarray:
    axes = tuple(i for i in range(kernel.ndim) if i != feature_axis)
    v = kernel.astype(np.float64)
    shape = [1] * kernel.ndim
    shape[feature_axis] = -1
    w = v / np.sqrt((v * v).sum(axis=axes, keepdims=True) + WN_EPS) * scale.reshape(shape)
    return w.astype(np.float32)


def _wn_layer(leaves: _Leaves, scope: str, wrapper: str, layer: str,
              transposed: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """(torch weight, bias) of a flax `WeightNorm(name=wrapper)` around the
    layer auto-named `layer` inside `scope`: its kernel and bias sit at
    scope/layer, its scale at scope/wrapper/layer/kernel/scale."""
    at = f"{scope}/" if scope else ""
    kernel = leaves.take(f"{at}{layer}/kernel")
    scale = leaves.take(f"{at}{wrapper}/{layer}/kernel/scale")
    bias = leaves.take(f"{at}{layer}/bias")
    if transposed:  # [k, in, out], norm per input channel -> [in, out, k] flipped
        return np.transpose(_fold(kernel, scale, 1)[::-1], (1, 2, 0)), bias
    return np.transpose(_fold(kernel, scale, 2), (2, 1, 0)), bias


def load_generator_params(gen: Generator, params: Mapping[str, Any]) -> Generator:
    """Fill a port Generator from the JAX Generator's tree."""
    leaves = _Leaves(params)
    sd: Dict[str, np.ndarray] = {}

    def put(name: str, wb: Tuple[np.ndarray, np.ndarray]) -> None:
        sd[f"{name}.weight"], sd[f"{name}.bias"] = wb

    put("conv_pre", _wn_layer(leaves, "", "conv_pre", "Conv_0"))
    for i in range(len(gen.ups)):
        put(f"ups.{i}", _wn_layer(leaves, "", f"ups_{i}", f"ConvTranspose_{i}", transposed=True))
        for j, block in enumerate(gen.resblocks[i]):
            scope = f"resblocks_{i}_{j}"
            if isinstance(block, ResBlock1):
                for n in range(len(block.convs1)):
                    put(f"resblocks.{i}.{j}.convs1.{n}",
                        _wn_layer(leaves, scope, f"convs1_{n}", f"Conv_{2 * n}"))
                    put(f"resblocks.{i}.{j}.convs2.{n}",
                        _wn_layer(leaves, scope, f"convs2_{n}", f"Conv_{2 * n + 1}"))
            else:
                for n in range(len(block.convs)):
                    put(f"resblocks.{i}.{j}.convs.{n}",
                        _wn_layer(leaves, scope, f"convs_{n}", f"Conv_{n}"))
    put("conv_post", _wn_layer(leaves, "", "conv_post", "Conv_1"))
    leaves.check_consumed()
    _load(gen, sd)
    return gen
