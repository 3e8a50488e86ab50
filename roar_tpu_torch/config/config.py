"""Config loading, `${...}` interpolation and dotlist overrides.

The port's copy of roar_tpu/config/config.py without `_target_`
instantiation (the port builds its objects from plain dicts).  `yaml` is
imported only by the functions that parse YAML text, so a program that
builds its config as a Python dict runs where pyyaml is not installed.
"""

from __future__ import annotations

import copy
import functools
import re
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union


class ConfigError(ValueError):
    pass


class _MissingType:
    """Hydra/OmegaConf's `???` mandatory marker.

    Reference YAMLs (e.g. jets.yaml `n_speakers: ???`) use `???` for
    values the user must override.  OmegaConf raises MissingMandatoryValue
    on *access*; the dict-based analogue is a falsy singleton, so
    `cfg.get(key)` treats an un-overridden mandatory key as absent, and
    any attempt to actually consume it (str/arithmetic) fails loudly
    instead of leaking the literal string "???" into model code.
    """

    __slots__ = ()
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:
        return "???"

    def __str__(self) -> str:
        raise ConfigError("mandatory config value ('???') was never set")

    def __copy__(self):
        return self

    def __deepcopy__(self, memo):
        return self


MISSING = _MissingType()


def _mark_missing(node: Any) -> Any:
    """Strip Hydra `???` mandatory markers.

    Un-overridden mandatory keys are *dropped* (so `cfg.get(key, default)`
    falls back and `cfg[key]` raises a KeyError naming the key — the dict
    analogue of OmegaConf's raise-on-access).  `???` inside lists becomes
    the MISSING sentinel to preserve indices."""
    if isinstance(node, dict):
        return {
            k: _mark_missing(v)
            for k, v in node.items()
            if not (isinstance(v, str) and v == "???")
        }
    if isinstance(node, list):
        return [_mark_missing(v) for v in node]
    if node == "???":
        return MISSING
    return node


_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


@functools.lru_cache(maxsize=None)
def _config_loader():
    """SafeLoader with scientific-notation floats.

    pyyaml follows YAML 1.1, where `1e-3` (no dot) parses as a STRING; that
    silently poisons numeric config fields (e.g. optimizer lr).  This
    resolver accepts the standard float forms.
    """
    import yaml

    class _ConfigLoader(yaml.SafeLoader):
        pass

    _ConfigLoader.add_implicit_resolver(
        "tag:yaml.org,2002:float",
        re.compile(
            r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
            |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
            |\.[0-9_]+(?:[eE][-+][0-9]+)?
            |[-+]?\.(?:inf|Inf|INF)
            |\.(?:nan|NaN|NAN))$""",
            re.X,
        ),
        list("-+0123456789."),
    )
    return _ConfigLoader


def _yaml_load(text_or_file) -> Any:
    import yaml

    return yaml.load(text_or_file, Loader=_config_loader())


def load_yaml(path: Union[str, Path]) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return _yaml_load(f) or {}


def _get_path(cfg: Dict[str, Any], dotted: str):
    cur: Any = cfg
    for part in dotted.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        elif isinstance(cur, list):
            cur = cur[int(part)]
        else:
            raise KeyError(dotted)
    return cur


def _set_path(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    cur = cfg
    for p in parts[:-1]:
        if isinstance(cur, list):
            cur = cur[int(p)]
        else:
            cur = cur.setdefault(p, {})
    if isinstance(cur, list):
        cur[int(parts[-1])] = value
    else:
        cur[parts[-1]] = value


def _parse_scalar(text: str) -> Any:
    return _yaml_load(text)


def resolve_interpolations(cfg: Dict[str, Any], _root=None, _depth=0) -> Any:
    """Resolve `${a.b.c}` references against the root config (OmegaConf-style,
    including full-value and embedded string interpolation)."""
    root = cfg if _root is None else _root
    if _depth > 20:
        raise ConfigError("interpolation depth exceeded (cycle?)")

    def lookup(dotted: str):
        try:
            return _get_path(root, dotted)
        except KeyError:
            raise ConfigError(
                f"interpolation ${{{dotted}}} refers to a key that is not set "
                "(un-overridden mandatory '???' value, or a typo)"
            ) from None

    def resolve_value(v, depth):
        if isinstance(v, str):
            m = _INTERP_RE.fullmatch(v.strip())
            if m:
                return resolve_value(lookup(m.group(1)), depth + 1)
            if _INTERP_RE.search(v):
                def sub(match):
                    t = resolve_value(lookup(match.group(1)), depth + 1)
                    return str(t)

                return _INTERP_RE.sub(sub, v)
            return v
        if isinstance(v, dict):
            return {k: resolve_value(x, depth) for k, x in v.items()}
        if isinstance(v, list):
            return [resolve_value(x, depth) for x in v]
        return v

    return resolve_value(cfg, _depth)


def merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Deep merge (override wins; dicts merge recursively)."""
    out = copy.deepcopy(base)
    for k, v in (override or {}).items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def apply_overrides(cfg: Dict[str, Any], overrides: Sequence[str]) -> Dict[str, Any]:
    """Apply Hydra-style dotlist overrides: `a.b=1 c.d=[1,2] +e.f=x`."""
    cfg = copy.deepcopy(cfg)
    for ov in overrides or ():
        if "=" not in ov:
            raise ConfigError(f"Override must look like key=value, got: {ov}")
        key, val = ov.split("=", 1)
        key = key.lstrip("+~")
        _set_path(cfg, key, _parse_scalar(val))
    return cfg


def _expand_includes(node: Any, base_dir: Path) -> Any:
    """Replace dicts containing `_file_: rel/path.yaml` with the loaded file
    (sibling keys override the included content) — our lightweight analogue
    of Hydra's config groups (`defaults: - model/generator: v1`)."""
    if isinstance(node, dict):
        if "_file_" in node:
            inc_path = base_dir / node["_file_"]
            included = _expand_includes(load_yaml(inc_path), inc_path.parent)
            rest = {k: _expand_includes(v, base_dir) for k, v in node.items() if k != "_file_"}
            return merge(included, rest)
        return {k: _expand_includes(v, base_dir) for k, v in node.items()}
    if isinstance(node, list):
        return [_expand_includes(v, base_dir) for v in node]
    return node


def load_config(
    path: Union[str, Path],
    overrides: Optional[Sequence[str]] = None,
    resolve: bool = True,
) -> Dict[str, Any]:
    path = Path(path)
    cfg = _expand_includes(load_yaml(path), path.parent)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    cfg = _mark_missing(cfg)
    if resolve:
        cfg = resolve_interpolations(cfg)
    return cfg
