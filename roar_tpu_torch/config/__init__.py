"""YAML configs with `${dotted.path}` interpolation and CLI dotlist overrides
(`a.b.c=value`): the port's copy of roar_tpu/config."""

from roar_tpu_torch.config.config import (  # noqa: F401
    MISSING,
    ConfigError,
    load_config,
    merge,
    resolve_interpolations,
)
