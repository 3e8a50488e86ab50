"""CLI runner: the hydra_runner analogue (port of roar_tpu/config/cli.py,
without the XLA compilation cache).

    @config_runner(config_path="configs", config_name="ds_for_fastpitch_align")
    def main(cfg):
        ...

    python script.py --config-name=ds_for_fastpitch_align \\
        manifest_filepath=train.json sup_data_path=sup
"""

from __future__ import annotations

import argparse
import functools
import sys
from pathlib import Path
from typing import Callable, Optional

from roar_tpu_torch.config.config import load_config


def config_runner(
    config_path: Optional[str] = None, config_name: Optional[str] = None
) -> Callable:
    def decorator(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(argv=None):
            parser = argparse.ArgumentParser(add_help=True)
            parser.add_argument("--config-path", default=config_path)
            parser.add_argument("--config-name", default=config_name)
            parser.add_argument(
                "overrides", nargs="*", help="dotlist overrides: a.b=c"
            )
            args = parser.parse_args(argv if argv is not None else sys.argv[1:])
            if args.config_name is None:
                raise SystemExit("--config-name is required")
            name = args.config_name
            if not name.endswith((".yaml", ".yml")):
                name = name + ".yaml"
            cfg_file = Path(args.config_path or ".") / name
            return fn(load_config(cfg_file, overrides=args.overrides))

        return wrapper

    return decorator
