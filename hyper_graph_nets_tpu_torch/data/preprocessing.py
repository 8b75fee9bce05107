"""Trajectory preprocessing: meta decoding and target/history windows.

Counterpart of ``hyper_graph_nets_tpu/data/preprocessing.py``.  Windows stay
``[T-2, N, D]`` arrays that feed batched steps directly; training noise is
drawn in the train step (``training/trainer.py``), not here.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from hyper_graph_nets_tpu_torch.data import tfrecord


def load_meta(dataset_dir: str) -> dict:
    with open(os.path.join(dataset_dir, "meta.json"), "r") as fp:
        return json.loads(fp.read())


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


def trajectory_windows(
    trajectory: Dict[str, np.ndarray],
    field: str,
    history: bool,
    num_steps: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """add_targets, then the first ``num_steps`` frames."""
    out = add_targets(trajectory, field, history)
    if num_steps is not None:
        out = {k: v[:num_steps] for k, v in out.items()}
    return out


class Preprocessing:
    """Stream the trajectories of one split's TFRecord file, windowed by
    :func:`add_targets` unless ``add_targets_b`` is False."""

    def __init__(
        self,
        model_config: dict,
        split: str = "train",
        in_dir: Optional[str] = None,
        add_targets_b: bool = True,
    ):
        self._field = model_config["field"]
        self._history = bool(model_config.get("history", False))
        self._in_dir = in_dir
        self._split = split
        self._add_targets_b = add_targets_b

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        meta = load_meta(self._in_dir)
        path = os.path.join(self._in_dir, f"{self._split}.tfrecord")
        for traj in tfrecord.read_trajectories(path, meta):
            if self._add_targets_b:
                yield add_targets(traj, self._field, self._history)
            else:
                yield traj
