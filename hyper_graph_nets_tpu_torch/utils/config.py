"""YAML experiment configuration.

Counterpart of ``hyper_graph_nets_tpu/utils/config.py``: multi-doc YAML where
the doc named ``DEFAULT`` is selected, plus nested dict access.  The port
parses the same ``configs/*.yaml`` files unchanged.  ``fused_bwd`` picks the
fused path's backward kernel (``remat``: K2, ``stream``: K3).  The TPU
tuning keys ``fused_chunk``, ``fused_pb``, ``fused_pb_bwd`` and
``scan_unroll`` are read by nothing here and so have no effect; the results
are the same.
"""
from __future__ import annotations

import os
from typing import Any, Iterable, Optional

import yaml

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "configs",
)


def read_yaml(config_name: str, config_dir: Optional[str] = None) -> dict:
    """Read ``configs/<name>.yaml`` and return the doc whose name is DEFAULT."""
    path = config_name
    if not os.path.isfile(path):
        path = os.path.join(config_dir or CONFIG_DIR, f"{config_name}.yaml")
    if not os.path.isfile(path):
        available = sorted(
            f[:-5]
            for f in os.listdir(config_dir or CONFIG_DIR)
            if f.endswith(".yaml")
        )
        raise FileNotFoundError(
            f"unknown config {config_name!r}; available: {', '.join(available)}"
        )
    with open(path, "r") as stream:
        for doc in yaml.safe_load_all(stream):
            if doc and doc.get("name") == "DEFAULT":
                return doc
    raise ValueError(f"no DEFAULT document in {path}")


def get_from_nested_dict(
    dictionary: dict,
    list_of_keys: Iterable[str],
    raise_error: bool = False,
    default_return: Any = None,
) -> Any:
    """Walk nested dicts by key path."""
    current = dictionary
    for key in list_of_keys:
        if not isinstance(current, dict) or key not in current:
            if raise_error:
                raise KeyError(f"key path {list(list_of_keys)} missing at {key!r}")
            return default_return
        current = current[key]
    return current
