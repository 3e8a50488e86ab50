"""JAX parameter trees <-> the port's torch state_dicts.

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

The trainable HiFi-GAN modules (`Generator(weight_norm=True)`, the
discriminators) keep `(v, scale, bias)` or `(weight, bias, u, sigma)` per
layer, so their conversion is a change of layout only and runs both ways:
`load_generator_train_params`, `load_mpd_params`, `load_msd_params` fill the
port's modules from the JAX trees, `to_jax_tree` writes them back as the
`{'g_params', 'd_params', 'd_stats'}` bundle of roar_tpu/training/run.py.

FastPitch is a change of layout only as well: `load_fastpitch_params` fills a
port `FastPitchModule` (or any of its sub-modules) from the flax tree and
`fastpitch_to_jax_tree` writes it back, with FFT transformer or Conformer
stacks (a Conformer layer's scopes: `ff1` / `ff2` with `Dense_0`, `Dense_1`
and `layer_norm`, `self_attn`, and `convolutional_block` with `Conv_0`, the
depthwise `Conv_1`, `LayerNorm_0`, `Conv_2` and `layer_norm`), and with a
transformer layer's adapter (`adapter/LayerNorm_0`, `adapter/down`,
`adapter/up`).  `fastpitch_flax_paths` names each port parameter by its flax
path, which is what the JAX package's path regexes (`finetune.param_labels`,
`freeze_updates`) match.

GPT is a change of layout only too: `load_gpt_params` fills a port `GPT` from
the flax tree in either block layout (`h_0 .. h_{L-1}`, or `h_scan` with a
leading layer axis per leaf, what `scan_layers=True` trains), and
`gpt_to_jax_tree` writes the layout the module's `scan_layers` names.  A
Mixtral block's `mlp` is the MoE layer: `mlp/router/kernel` as a Dense, and
`mlp/w_gate`, `mlp/w_up`, `mlp/w_down` ([E, in, out]) as they are.

BERT is a change of layout only as well: `load_bert_params` fills any port
module of `models/bert.py` (`BertForPreTraining`, `BertForMaskedLM`,
`BertEncoder`) from the flax tree, `layers.{i}` being `layers_{i}`, and
`bert_to_jax_tree` writes it back.

The standalone Aligner's `AlignerNet` uses FastPitch's scopes:
`load_aligner_params` / `aligner_to_jax_tree` map `embed` and
`alignment_encoder`.  GST (`gst_module`) maps `reference_encoder/convs_{i}`
(HWIO kernels to OIHW), `reference_encoder/norm_{i}`, `reference_encoder/proj`
and `style_attention/{style_tokens, q_proj, k_proj, v_proj}`.

JETS joins the two: `load_jets_params` fills a port `JETSModule` from the
flax tree, its FastPitch-graph scopes as FastPitch's and its `generator` scope
as the trainable generator's, and `jets_to_jax_tree` writes it back.

Every converter raises on a JAX leaf it does not consume and on a port
parameter it leaves unfilled.  FastPitch `aligner_module` leaves are skipped
only when the port module was built without an aligner (it serves training
only).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from roar_tpu_torch.models.bert import BertOnlyMLMHead
from roar_tpu_torch.models.conformer import ConvolutionalModule, PositionwiseFF
from roar_tpu_torch.models.fastpitch import ConvReLUNorm
from roar_tpu_torch.models.gpt import GPT, RMSNorm
from roar_tpu_torch.models.hifigan import (
    Generator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    ResBlock1,
    SpectralNormConv,
    WeightNormConv,
)
from roar_tpu_torch.models.moe import MoEMLP
from roar_tpu_torch.models.submodules import (
    ConditionalInput,
    ConditionalLayerNorm,
    ConvNorm,
    SpeakerEncoder,
    SpeakerLookupTable,
    StyleAttention,
)
from roar_tpu_torch.models.transformer import AdapterBlock, PositionwiseConvFF

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


def _join(scope: str, name: str) -> str:
    """A leaf's '/'-joined flax path: its scope ('' at the root) and name."""
    return f"{scope}/{name}" if scope else name


def _flax_layout(value: np.ndarray, axes) -> np.ndarray:
    """A torch array in the flax layout: the inverse of `_leaf_names`' axes."""
    return value if axes is None else value.transpose(np.argsort(axes))


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
    if isinstance(parent, (ConvReLUNorm, ConvNorm)) and name == "conv":
        return "Conv_0"
    if isinstance(parent, PositionwiseFF):
        return {"linear_in": "Dense_0", "linear_out": "Dense_1"}.get(name, name)
    if isinstance(parent, AdapterBlock):
        return {"norm": "LayerNorm_0"}.get(name, name)
    if isinstance(parent, SpeakerLookupTable):
        return "Embed_0"
    if isinstance(parent, SpeakerEncoder):
        return {"proj": "Dense_0"}.get(name, name)
    if isinstance(parent, ConvolutionalModule):
        return {"pointwise_in": "Conv_0", "depthwise": "Conv_1", "norm": "LayerNorm_0",
                "pointwise_out": "Conv_2"}.get(name, name)
    return name


def _fastpitch_sites(module: nn.Module, torch_prefix: str = "", flax_prefix: str = ""):
    """(torch prefix, flax scope, module) of every module under `module` that
    holds parameters of its own (a leaf module, or GST's `StyleAttention`
    with its token bank), in registration order."""
    if next(module.parameters(), None) is None:
        return
    children = list(module.named_children())
    if not children or next(module.parameters(recurse=False), None) is not None:
        yield torch_prefix, flax_prefix.rstrip("/"), module
    for name, child in children:
        if isinstance(child, nn.ModuleList):
            for i, sub in enumerate(child):
                yield from _fastpitch_sites(sub, f"{torch_prefix}{name}.{i}.",
                                            f"{flax_prefix}{name}_{i}/")
        else:
            yield from _fastpitch_sites(child, f"{torch_prefix}{name}.",
                                        f"{flax_prefix}{_flax_child(module, name)}/")


def _leaf_names(module: nn.Module, path: str):
    """(torch parameter name, flax leaf name, axes that turn the flax array
    into the torch one) of the parameters a module holds itself;
    `_flax_layout` turns them back."""
    if isinstance(module, nn.Linear):
        names = [("weight", "kernel", (1, 0))]
    elif isinstance(module, nn.Conv1d):
        names = [("weight", "kernel", (2, 1, 0))]
    elif isinstance(module, nn.Conv2d):  # HWIO -> OIHW
        names = [("weight", "kernel", (3, 2, 0, 1))]
    elif isinstance(module, StyleAttention):  # its token bank; the projections are children
        return [("style_tokens", "style_tokens", None)]
    elif isinstance(module, nn.Embedding):
        return [("weight", "embedding", None)]
    elif isinstance(module, nn.LayerNorm):
        return [("weight", "scale", None), ("bias", "bias", None)] \
            if module.elementwise_affine else []
    elif isinstance(module, RMSNorm):
        return [("weight", "scale", None)]
    elif isinstance(module, MoEMLP):  # the experts' own leaves; `router` is a child
        return [(name, name, None) for name in ("w_gate", "w_up", "w_down")]
    elif isinstance(module, BertOnlyMLMHead):  # its decoder bias; the layers are children
        return [("bias", "bias", None)]
    else:
        raise TypeError(f"no conversion for {type(module).__name__} at {path}")
    if module.bias is not None:
        names.append(("bias", "bias", None))
    return names


def load_fastpitch_params(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Fill a port FastPitchModule from the JAX FastPitchModule's tree.  The
    aligner serves training only: a tree's aligner leaves are skipped when
    the port module has no aligner, and a tree with no aligner leaf at all
    (one initialised through `infer`) leaves the port's aligner as it is.
    Anything else unconsumed or unfilled raises."""
    has_aligner = getattr(module, "aligner_module", None) is not None
    leaves = _Leaves(params, () if has_aligner else FASTPITCH_SKIPPED)
    keep = {}
    if has_aligner and not any(k.startswith(FASTPITCH_SKIPPED) for k in leaves.leaves):
        keep = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()
                if k.startswith("aligner_module.")}
    sd: Dict[str, np.ndarray] = dict(keep)
    for torch_prefix, path, leaf in _fastpitch_sites(module):
        for torch_name, flax_name, axes in _leaf_names(leaf, path):
            if torch_prefix + torch_name in keep:
                continue
            value = leaves.take(_join(path, flax_name))
            sd[torch_prefix + torch_name] = value if axes is None else value.transpose(axes)
    leaves.check_consumed()
    _load(module, sd)
    return module


def fastpitch_flax_paths(module: nn.Module) -> Dict[str, str]:
    """{torch parameter name: '/'-joined flax path} of every parameter of a
    port FastPitchModule, as `fastpitch_to_jax_tree` writes it, without the
    leading 'params'."""
    paths = {}
    for torch_prefix, path, leaf in _fastpitch_sites(module):
        for torch_name, flax_name, _ in _leaf_names(leaf, path):
            paths[torch_prefix + torch_name] = _join(path, flax_name)
    return paths


def fastpitch_to_jax_tree(module: nn.Module) -> Dict[str, Any]:
    """{'params': ...} of a port FastPitchModule in the flax tree's names and
    layouts: what `roar_tpu`'s `FastPitchModel` applies and its `restore_from`
    reads.  The reverse of `load_fastpitch_params`."""
    return {"params": _nest(_tree_from_sites(module, _fastpitch_sites(module)))}


def load_aligner_params(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Fill a port `AlignerNet` from the JAX AlignerNet's tree (`embed`,
    `alignment_encoder` with FastPitch's aligner scopes).  An unconsumed leaf
    or an unfilled parameter raises."""
    leaves = _Leaves(params)
    sd = _state_from_sites(leaves, _fastpitch_sites(module))
    leaves.check_consumed()
    _load(module, sd)
    return module


def aligner_to_jax_tree(module: nn.Module) -> Dict[str, Any]:
    """{'params': ...} of a port `AlignerNet` in the flax tree's names and
    layouts; the reverse of `load_aligner_params`."""
    return {"params": _nest(_tree_from_sites(module, _fastpitch_sites(module)))}


# ---------------------------------------------------------------------------
# GPT: the port's names are the flax scopes (`h.3.attn.proj` is `h_3/attn/proj`)
# ---------------------------------------------------------------------------


def _scoped_sites(module: nn.Module, blocks: str):
    """(torch prefix, flax scope, module) of every module under `module` that
    holds parameters of its own; the torch names are the flax scopes, with
    the list `blocks.{i}` named `blocks_{i}` (flax's naming of a loop's
    modules)."""
    pattern = re.compile(rf"(^|\.){blocks}\.(\d+)")
    for name, leaf in module.named_modules():
        if name and next(leaf.parameters(recurse=False), None) is not None:
            scope = pattern.sub(rf"\1{blocks}_\2", name)
            yield name + ".", scope.replace(".", "/"), leaf


def _state_from_sites(leaves: _Leaves, sites) -> Dict[str, np.ndarray]:
    """The state_dict entries of `sites`, each taken from its JAX leaf."""
    sd: Dict[str, np.ndarray] = {}
    for torch_prefix, path, leaf in sites:
        for torch_name, flax_name, axes in _leaf_names(leaf, path):
            value = leaves.take(_join(path, flax_name))
            sd[torch_prefix + torch_name] = value if axes is None else value.transpose(axes)
    return sd


def _tree_from_sites(module: nn.Module, sites) -> Dict[Tuple[str, ...], np.ndarray]:
    """{flax path: array} of every parameter of `module`, through `sites`;
    a parameter no site writes raises."""
    state = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}
    flat: Dict[Tuple[str, ...], np.ndarray] = {}
    for torch_prefix, path, leaf in sites:
        for torch_name, flax_name, axes in _leaf_names(leaf, path):
            value = state.pop(torch_prefix + torch_name)
            flat[tuple(_join(path, flax_name).split("/"))] = np.ascontiguousarray(
                _flax_layout(value, axes))
    if state:
        raise ValueError(f"port parameters not written to the JAX tree: {sorted(state)}")
    return flat


def load_gpt_params(module: GPT, params: Mapping[str, Any]) -> GPT:
    """Fill a port GPT from the JAX GPT's tree, in the unrolled layout
    (`h_{i}`) or the stacked one (`h_scan`, each leaf with a leading layer
    axis).  An unconsumed leaf or an unfilled parameter raises."""
    leaves = _Leaves(params)
    stacked = {k: v for k, v in leaves.leaves.items() if k.startswith("h_scan/")}
    for path, value in stacked.items():
        del leaves.leaves[path]
        if value.shape[0] != module.config.n_layer:
            raise ValueError(f"{path}: {value.shape[0]} stacked layers, the module has "
                             f"{module.config.n_layer}")
        for i, layer in enumerate(value):
            leaves.leaves[f"h_{i}/{path[len('h_scan/'):]}"] = layer
    sd = _state_from_sites(leaves, _scoped_sites(module, "h"))
    leaves.check_consumed()
    _load(module, sd)
    return module


def gpt_to_jax_tree(module: GPT) -> Dict[str, Any]:
    """{'params': ...} of a port GPT in the flax tree's names and layouts:
    what `roar_tpu`'s `GPTLMModel` applies and its `restore_from` reads.
    With `scan_layers` the blocks are stacked under `h_scan`."""
    flat = _tree_from_sites(module, _scoped_sites(module, "h"))
    if module.config.scan_layers:
        n_layer = module.config.n_layer
        for key in [k for k in flat if k[0] == "h_0"]:
            flat[("h_scan", *key[1:])] = np.stack(
                [flat.pop((f"h_{i}", *key[1:])) for i in range(n_layer)])
    return {"params": _nest(flat)}


# ---------------------------------------------------------------------------
# BERT: the port's names are the flax scopes (`bert.layers.2.mlp` is
# `bert/layers_2/mlp`)
# ---------------------------------------------------------------------------


def load_bert_params(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Fill a port BERT module from the JAX module's tree.  An unconsumed
    leaf or an unfilled parameter raises."""
    leaves = _Leaves(params)
    sd = _state_from_sites(leaves, _scoped_sites(module, "layers"))
    leaves.check_consumed()
    _load(module, sd)
    return module


def bert_to_jax_tree(module: nn.Module) -> Dict[str, Any]:
    """{'params': ...} of a port BERT module in the flax tree's names and
    layouts: what `roar_tpu`'s `BertPretrainingModel` applies and its
    `restore_from` reads.  The reverse of `load_bert_params`."""
    return {"params": _nest(_tree_from_sites(module, _scoped_sites(module, "layers")))}


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
    """Fill a port Generator (folded form) from the JAX Generator's tree."""
    leaves = _Leaves(params)
    sd: Dict[str, np.ndarray] = {}
    for name, scope, wrapper, layer in _generator_sites(gen):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = _wn_layer(
            leaves, scope, wrapper, layer, transposed=layer.startswith("ConvTranspose"))
    leaves.check_consumed()
    _load(gen, sd)
    return gen


# ---------------------------------------------------------------------------
# HiFi-GAN, trainable form: layout changes only, both directions
# ---------------------------------------------------------------------------

# flax kernel -> torch kernel axes per conv kind; conv_transpose1d is also
# flipped along k (flax [k, in, out] -> torch [in, out, k])
_TO_TORCH = {"conv1d": (2, 1, 0), "conv2d": (3, 2, 0, 1), "conv_transpose1d": (1, 2, 0)}
_TO_FLAX = {"conv1d": (2, 1, 0), "conv2d": (2, 3, 1, 0), "conv_transpose1d": (2, 0, 1)}


def _kernel_to_torch(kernel: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv_transpose1d":
        kernel = kernel[::-1]
    return np.ascontiguousarray(np.transpose(kernel, _TO_TORCH[kind]))


def _kernel_to_flax(kernel: np.ndarray, kind: str) -> np.ndarray:
    kernel = np.transpose(kernel, _TO_FLAX[kind])
    if kind == "conv_transpose1d":
        kernel = kernel[::-1]
    return np.ascontiguousarray(kernel)


def _generator_sites(gen: Generator):
    """(torch name, flax scope, wrapper, layer) of every generator conv."""
    yield "conv_pre", "", "conv_pre", "Conv_0"
    for i in range(len(gen.ups)):
        yield f"ups.{i}", "", f"ups_{i}", f"ConvTranspose_{i}"
        for j, block in enumerate(gen.resblocks[i]):
            scope = f"resblocks_{i}_{j}"
            if isinstance(block, ResBlock1):
                for n in range(len(block.convs1)):
                    yield f"resblocks.{i}.{j}.convs1.{n}", scope, f"convs1_{n}", f"Conv_{2 * n}"
                    yield f"resblocks.{i}.{j}.convs2.{n}", scope, f"convs2_{n}", f"Conv_{2 * n + 1}"
            else:
                for n in range(len(block.convs)):
                    yield f"resblocks.{i}.{j}.convs.{n}", scope, f"convs_{n}", f"Conv_{n}"
    yield "conv_post", "", "conv_post", "Conv_1"


def _disc_sites(disc: nn.Module, prefix: str, scope: str):
    """A DiscriminatorP's or DiscriminatorS's convs: flax names the inner
    convs Conv_0.. in call order and the wrappers convs_i / conv_post."""
    n = len(disc.convs)
    for i in range(n):
        yield f"{prefix}convs.{i}", scope, f"convs_{i}", f"Conv_{i}"
    yield f"{prefix}conv_post", scope, "conv_post", f"Conv_{n}"


def _mpd_sites(mpd: MultiPeriodDiscriminator):
    for i, p in enumerate(mpd.periods):
        yield from _disc_sites(mpd.discs[i], f"discs.{i}.", f"disc_p{p}")


def _msd_sites(msd: MultiScaleDiscriminator):
    for i, disc in enumerate(msd.discs):
        yield from _disc_sites(disc, f"discs.{i}.", f"disc_s{i}")


def _load_norm_convs(module: nn.Module, sites, params: Mapping[str, Any],
                     stats: Mapping[str, Any] = None) -> nn.Module:
    _load(module, _norm_convs_state(module, sites, params, stats))
    return module


def _norm_convs_state(module: nn.Module, sites, params: Mapping[str, Any],
                      stats: Mapping[str, Any] = None) -> Dict[str, np.ndarray]:
    """The state_dict of `module`'s norm convs from the JAX trees; raises on
    a leaf left unconsumed."""
    leaves = _Leaves(params)
    stat_leaves = _Leaves(stats or {})
    sd: Dict[str, np.ndarray] = {}
    for name, scope, wrapper, layer in sites:
        conv = module.get_submodule(name)
        at = f"{scope}/" if scope else ""
        kernel = _kernel_to_torch(leaves.take(f"{at}{layer}/kernel"), conv.kind)
        sd[f"{name}.bias"] = leaves.take(f"{at}{layer}/bias")
        if isinstance(conv, WeightNormConv):
            sd[f"{name}.v"] = kernel
            sd[f"{name}.scale"] = leaves.take(f"{at}{wrapper}/{layer}/kernel/scale")
        elif isinstance(conv, SpectralNormConv):
            sd[f"{name}.weight"] = kernel
            sd[f"{name}.u"] = stat_leaves.take(f"{at}{wrapper}/{layer}/kernel/u")
            sd[f"{name}.sigma"] = stat_leaves.take(f"{at}{wrapper}/{layer}/kernel/sigma")
        else:
            raise TypeError(f"no conversion for {type(conv).__name__} at {name}")
    leaves.check_consumed()
    stat_leaves.check_consumed()
    return sd


def _nest(flat: Mapping[Tuple[str, ...], np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for (*scopes, leaf), value in flat.items():
        node = tree
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = value
    return tree


def _norm_convs_to_jax(module: nn.Module, sites) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats) as nested dicts of numpy arrays, flax layouts.
    flax keeps a wrapper's own variables under ONE key that holds slashes
    (`convs_0: {'Conv_0/kernel/scale': ...}`); the trees are built so."""
    params: Dict[Tuple[str, ...], np.ndarray] = {}
    stats: Dict[Tuple[str, ...], np.ndarray] = {}
    state = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}
    for name, scope, wrapper, layer in sites:
        conv = module.get_submodule(name)
        at = (scope,) if scope else ()
        params[(*at, layer, "bias")] = state.pop(f"{name}.bias")
        if isinstance(conv, WeightNormConv):
            params[(*at, layer, "kernel")] = _kernel_to_flax(state.pop(f"{name}.v"), conv.kind)
            params[(*at, wrapper, f"{layer}/kernel/scale")] = state.pop(f"{name}.scale")
        else:
            params[(*at, layer, "kernel")] = _kernel_to_flax(state.pop(f"{name}.weight"),
                                                             conv.kind)
            stats[(*at, wrapper, f"{layer}/kernel/u")] = state.pop(f"{name}.u")
            stats[(*at, wrapper, f"{layer}/kernel/sigma")] = state.pop(f"{name}.sigma")
    if state:
        raise ValueError(f"port parameters not written to the JAX tree: {sorted(state)}")
    return _nest(params), _nest(stats)


def load_generator_train_params(gen: Generator, params: Mapping[str, Any]) -> Generator:
    """Fill a `Generator(weight_norm=True)` from the JAX Generator's tree."""
    if not gen.weight_norm:
        raise ValueError("load_generator_train_params fills Generator(weight_norm=True); "
                         "use load_generator_params for the folded form")
    return _load_norm_convs(gen, _generator_sites(gen), params)


def load_discriminator_params(disc: nn.Module, params: Mapping[str, Any],
                              batch_stats: Mapping[str, Any] = None) -> nn.Module:
    """Fill one DiscriminatorP or DiscriminatorS from the JAX module's own tree."""
    return _load_norm_convs(disc, _disc_sites(disc, "", ""), params, batch_stats)


def load_mpd_params(mpd: MultiPeriodDiscriminator,
                    params: Mapping[str, Any]) -> MultiPeriodDiscriminator:
    """Fill the port's MPD from the JAX MultiPeriodDiscriminator's params."""
    return _load_norm_convs(mpd, _mpd_sites(mpd), params)


def load_msd_params(msd: MultiScaleDiscriminator, params: Mapping[str, Any],
                    batch_stats: Mapping[str, Any]) -> MultiScaleDiscriminator:
    """Fill the port's MSD from the JAX MultiScaleDiscriminator's params and
    its `batch_stats` (scale 0's spectral-norm u and sigma)."""
    return _load_norm_convs(msd, _msd_sites(msd), params, batch_stats)


def generator_to_jax_tree(gen: Generator) -> Dict[str, Any]:
    """{'params': ...} of a `Generator(weight_norm=True)`, flax layouts."""
    if not gen.weight_norm:
        raise ValueError("only the trainable (v, scale) form maps back to the JAX tree")
    return {"params": _norm_convs_to_jax(gen, _generator_sites(gen))[0]}


def to_jax_tree(gen: Generator, mpd: MultiPeriodDiscriminator,
                msd: MultiScaleDiscriminator) -> Dict[str, Any]:
    """The GAN bundle `{'g_params', 'd_params', 'd_stats'}` as
    roar_tpu/training/run.py saves it, from the port's three modules."""
    return {"g_params": generator_to_jax_tree(gen), **_discriminator_trees(mpd, msd)}


def _discriminator_trees(mpd: MultiPeriodDiscriminator,
                         msd: MultiScaleDiscriminator) -> Dict[str, Any]:
    mpd_params, _ = _norm_convs_to_jax(mpd, _mpd_sites(mpd))
    msd_params, msd_stats = _norm_convs_to_jax(msd, _msd_sites(msd))
    return {"d_params": {"params": {"mpd": mpd_params, "msd": msd_params}},
            "d_stats": {"msd": msd_stats}}


def load_gan_bundle(gen: Generator, mpd: MultiPeriodDiscriminator,
                    msd: MultiScaleDiscriminator, tree: Mapping[str, Any]) -> None:
    """The reverse of `to_jax_tree`."""
    load_generator_train_params(gen, tree["g_params"])
    _load_discriminators(mpd, msd, tree)


def _load_discriminators(mpd: MultiPeriodDiscriminator, msd: MultiScaleDiscriminator,
                         tree: Mapping[str, Any]) -> None:
    d_params = tree["d_params"]["params"]
    load_mpd_params(mpd, d_params["mpd"])
    load_msd_params(msd, d_params["msd"], (tree.get("d_stats") or {}).get("msd") or {})


# ---------------------------------------------------------------------------
# JETS: the FastPitch graph's scopes plus the trainable generator's
# ---------------------------------------------------------------------------

JETS_GENERATOR = "generator"  # the flax scope of JETSModule's waveform generator


def _jets_sites(module: nn.Module):
    """`_fastpitch_sites` of every child of a JETSModule but its generator."""
    for name, child in module.named_children():
        if name != JETS_GENERATOR:
            yield from _fastpitch_sites(child, f"{name}.", f"{name}/")


def load_jets_params(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Fill a port JETSModule from the JAX JETSModule's tree (`{'params':
    ...}` or the bare tree).  An unconsumed leaf or an unfilled parameter
    raises."""
    tree = params["params"] if set(params) == {"params"} else params
    if JETS_GENERATOR not in tree:
        raise KeyError(f"port parameter left unfilled: no JAX scope {JETS_GENERATOR!r}")
    leaves = _Leaves({k: v for k, v in tree.items() if k != JETS_GENERATOR})
    sd: Dict[str, np.ndarray] = {}
    for torch_prefix, path, leaf in _jets_sites(module):
        for torch_name, flax_name, axes in _leaf_names(leaf, path):
            value = leaves.take(_join(path, flax_name))
            sd[torch_prefix + torch_name] = value if axes is None else value.transpose(axes)
    leaves.check_consumed()
    gen = module.generator
    for k, v in _norm_convs_state(gen, _generator_sites(gen), tree[JETS_GENERATOR]).items():
        sd[f"{JETS_GENERATOR}.{k}"] = v
    _load(module, sd)
    return module


def jets_to_jax_tree(module: nn.Module) -> Dict[str, Any]:
    """{'params': ...} of a port JETSModule in the flax tree's names and
    layouts: what `roar_tpu`'s `JETSModel` applies (its `g_params`).  The
    reverse of `load_jets_params`."""
    state = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()
             if not k.startswith(JETS_GENERATOR + ".")}
    flat: Dict[Tuple[str, ...], np.ndarray] = {}
    for torch_prefix, path, leaf in _jets_sites(module):
        for torch_name, flax_name, axes in _leaf_names(leaf, path):
            value = state.pop(torch_prefix + torch_name)
            flat[tuple(_join(path, flax_name).split("/"))] = np.ascontiguousarray(
                _flax_layout(value, axes))
    if state:
        raise ValueError(f"port parameters not written to the JAX tree: {sorted(state)}")
    tree = _nest(flat)
    tree[JETS_GENERATOR] = generator_to_jax_tree(module.generator)["params"]
    return {"params": tree}


def jets_bundle_to_jax_tree(module: nn.Module, mpd: MultiPeriodDiscriminator,
                            msd: MultiScaleDiscriminator) -> Dict[str, Any]:
    """The JETS GAN bundle `{'g_params', 'd_params', 'd_stats'}` as
    roar_tpu/training/run.py saves it."""
    return {"g_params": jets_to_jax_tree(module), **_discriminator_trees(mpd, msd)}


def load_jets_bundle(module: nn.Module, mpd: MultiPeriodDiscriminator,
                     msd: MultiScaleDiscriminator, tree: Mapping[str, Any]) -> None:
    """The reverse of `jets_bundle_to_jax_tree`."""
    load_jets_params(module, tree["g_params"])
    _load_discriminators(mpd, msd, tree)
