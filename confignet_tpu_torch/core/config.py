"""Configuration handling (counterpart of ``confignet_tpu/core/config.py``).

Configs are plain JSON-serializable dicts so that checkpoints remain
self-describing, matching the reference behavior (reference:
confignet/confignet_utils.py:39-61).
"""
from __future__ import annotations

import json
from typing import Any, Dict


def merge_configs(default_config: Dict[str, Any], input_config: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``input_config`` over ``default_config``.

    Nested dicts are merged key-by-key; non-dict values in ``input_config``
    win; keys only present in ``input_config`` are kept.
    """
    result: Dict[str, Any] = {}
    for name, default_value in default_config.items():
        if name in input_config:
            override = input_config[name]
            if isinstance(default_value, dict):
                if not isinstance(override, dict):
                    raise TypeError(
                        f"Config key {name!r} is a dict in defaults but "
                        f"{type(override).__name__} in the override"
                    )
                result[name] = merge_configs(default_value, override)
            else:
                result[name] = override
        else:
            result[name] = default_value

    for name, override in input_config.items():
        if name in default_config:
            continue
        result[name] = override

    return result


def save_config(config: Dict[str, Any], path: str) -> None:
    with open(path, "w") as fp:
        json.dump(config, fp, indent=4)


def load_config(path: str) -> Dict[str, Any]:
    with open(path, "r") as fp:
        return json.load(fp)
