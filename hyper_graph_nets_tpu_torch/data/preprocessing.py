"""Trajectory preprocessing: target/history windows.

Counterpart of ``add_targets`` in ``hyper_graph_nets_tpu/data/preprocessing.py``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def add_targets(
    trajectory: Dict[str, np.ndarray], fields: str | List[str], history: bool
) -> Dict[str, np.ndarray]:
    """Slide the target window: ``x[1:-1]``, ``prev|x = x[:-2]``, ``target|x = x[2:]``."""
    if isinstance(fields, str):
        fields = [fields]
    out = {}
    for key, val in trajectory.items():
        out[key] = val[1:-1]
        if key in fields:
            if history:
                out["prev|" + key] = val[0:-2]
            out["target|" + key] = val[2:]
    return out
