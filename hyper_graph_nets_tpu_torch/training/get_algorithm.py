"""Algorithm factory.

Counterpart of ``hyper_graph_nets_tpu/training/get_algorithm.py``:
``task.task == 'mesh'`` maps to :class:`MeshSimulator`.
"""
from __future__ import annotations

from typing import Optional

from hyper_graph_nets_tpu_torch.training.simulator import MeshSimulator
from hyper_graph_nets_tpu_torch.utils.config import get_from_nested_dict


def get_algorithm(config: dict, out_dir: Optional[str] = None, device=None) -> MeshSimulator:
    """'mesh' -> MeshSimulator (on the card unless ``device="cpu"``)."""
    params = config.get("params", config)
    name = get_from_nested_dict(params, ["task", "task"], default_return="mesh")
    if name == "mesh":
        return MeshSimulator(config, out_dir=out_dir, device=device)
    raise NotImplementedError(f"unknown algorithm task {name!r}")
