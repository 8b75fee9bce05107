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


def initialize_config(config: dict, repetition: int = 0) -> dict:
    """The processed ``params`` of a cw2-style experiment config, as the JAX
    package's ``initialize_config`` builds them: a ``_recording_structure``
    from the experiment header, ``iterations`` moved in, the repetition's
    random seeds (``default``: the repetition index; a ``tied`` pytorch
    seed copies numpy's), every ``log_<key>: v`` as ``<key>: 2**v`` (an
    int above 0 stays an int, one below -30 becomes 0), and integer-valued
    floats as ints.  ``config`` is not changed."""
    import copy

    recording = {
        "_groupname": config.get("_experiment_name"),
        "_runname": f"{config.get('_experiment_name')}_{repetition}",
        "_recording_dir": config.get("params", {}).get("_rep_log_path") or config.get("_rep_log_path"),
        "_job_name": config.get("name"),
    }
    out = copy.deepcopy(config.get("params", {}))
    if "_recording_structure" in out:
        raise ValueError("may not use pre-defined '_recording_structure' subconfig")
    if "iterations" in out:
        raise ValueError("'iterations' must be defined outside of 'params'")
    out["_recording_structure"] = recording
    out["iterations"] = config.get("iterations")

    seeds = dict(out.get("random_seeds") or {})
    if seeds.get("numpy") == "default":
        seeds["numpy"] = repetition
    if seeds.get("pytorch") == "default":
        seeds["pytorch"] = repetition
    elif seeds.get("pytorch") == "tied":
        seeds["pytorch"] = seeds.get("numpy")
    out["random_seeds"] = seeds

    def process(node: dict) -> dict:
        parsed = {}
        for key, value in node.items():
            if isinstance(value, dict):
                parsed[key] = process(value)
            elif key.startswith("log_"):
                name = key.replace("log_", "", 1)
                if isinstance(value, int) and value > 0:
                    parsed[name] = int(2**value)
                elif isinstance(value, int) and value < -30:
                    parsed[name] = 0
                else:
                    parsed[name] = 2**value
            elif isinstance(value, float) and value.is_integer():
                parsed[key] = int(value)
            else:
                parsed[key] = value
        return parsed

    return process(out)
