"""Dataset loading: ``get_data(config, split)``.

Counterpart of ``hyper_graph_nets_tpu/data/loader.py``.  When the DeepMind
TFRecord files are present under ``<data_dir>/<dataset>/input`` they are
streamed; otherwise a synthetic dataset with the same schema is generated
once from fixed seeds, written through the TFRecord path and streamed from
disk.  The files are byte for byte the ones the JAX package writes from the
same seeds, so either package reads the other's ``input`` directory.

Left out: ``task.loader: tfdata``, which needs TensorFlow; it raises
``NotImplementedError``.
"""
from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from hyper_graph_nets_tpu_torch.data import synthetic, tfrecord
from hyper_graph_nets_tpu_torch.data.preprocessing import Preprocessing
from hyper_graph_nets_tpu_torch.utils.config import get_from_nested_dict

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA_DIR = os.path.join(REPO_ROOT, "data")

_SYNTH_DEFAULTS = {
    "flag_minimal": dict(trajectories=2, num_steps=12, nx=8, ny=8),
    "flag_simple": dict(trajectories=4, num_steps=40, nx=16, ny=16),
    "cylinder_flow": dict(trajectories=4, num_steps=40, nx=12, ny=8),
    "deforming_plate": dict(trajectories=4, num_steps=30, nx=7, ny=7),
}


def get_directories(dataset_name: str, data_dir: Optional[str] = None):
    """``(input dir, output dir)`` of a dataset under ``data_dir`` (the
    repository's ``data/`` by default)."""
    task_dir = os.path.join(data_dir or DATA_DIR, dataset_name)
    return os.path.join(task_dir, "input"), os.path.join(task_dir, "output")


def _meta_ok(in_dir: str) -> bool:
    """True iff meta.json exists and parses to a non-empty dict."""
    try:
        with open(os.path.join(in_dir, "meta.json"), "r") as fp:
            return bool(json.load(fp))
    except (OSError, ValueError):
        return False


def _tfrecord_ok(path: str) -> bool:
    """The file exists and its first record is framed correctly (catches
    the 0-byte or truncated files of an interrupted run without reading a
    whole corpus; a corrupt record later in the file fails when read)."""
    try:
        return next(tfrecord.read_records(path), None) is not None
    except (OSError, ValueError):
        return False


def _ensure_synthetic(dataset: str, in_dir: str, overrides: dict) -> None:
    """Generate and write the synthetic train/valid/test TFRecords (seeds
    0, 1000 and 2000 up) where absent or invalid, each file atomically."""
    os.makedirs(in_dir, exist_ok=True)
    kw = dict(_SYNTH_DEFAULTS[dataset])
    kw.update({k: v for k, v in overrides.items() if v is not None})
    num_traj = kw.pop("trajectories")
    num_steps = kw.pop("num_steps")
    meta_path = os.path.join(in_dir, "meta.json")
    for split, n in (("train", num_traj), ("valid", max(1, num_traj // 2)),
                     ("test", max(1, num_traj // 2))):
        path = os.path.join(in_dir, f"{split}.tfrecord")
        if _tfrecord_ok(path) and _meta_ok(in_dir):
            continue
        if os.path.exists(path) or (os.path.exists(meta_path) and not _meta_ok(in_dir)):
            print(
                f"# regenerating {dataset}/{split}: corrupt or truncated "
                f"artifact found in {in_dir}",
                flush=True,
            )
        seed_base = {"train": 0, "valid": 1000, "test": 2000}[split]
        gen = synthetic.GENERATORS[dataset]
        trajs = [gen(num_steps=num_steps, seed=seed_base + i, **kw) for i in range(n)]
        tfrecord.write_trajectories(path, trajs)
        if not _meta_ok(in_dir):
            tmp = f"{meta_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as fp:
                json.dump(synthetic.make_meta(dataset, trajs[0]), fp)
            os.replace(tmp, meta_path)


def get_data(
    config: dict,
    split: str = "train",
    add_targets: bool = True,
    data_dir: Optional[str] = None,
) -> "GraphDataLoader":
    """The trajectories of ``split`` (windowed by ``add_targets``)."""
    params = config.get("params", config)
    dataset = get_from_nested_dict(params, ["task", "dataset"], raise_error=True)
    if dataset not in _SYNTH_DEFAULTS:
        raise NotImplementedError(f"unknown dataset {dataset!r}")
    if get_from_nested_dict(params, ["task", "loader"], default_return="python") == "tfdata":
        raise NotImplementedError("task.loader 'tfdata' needs TensorFlow; use the default loader")
    in_dir, _ = get_directories(dataset, data_dir)
    split_path = os.path.join(in_dir, f"{split}.tfrecord")
    if not (_tfrecord_ok(split_path) and _meta_ok(in_dir)):
        overrides = get_from_nested_dict(params, ["task", "synthetic"], default_return={}) or {}
        _ensure_synthetic(dataset, in_dir, overrides)
    if not _meta_ok(in_dir):
        raise ValueError(
            f"invalid or unparseable meta.json in {in_dir} "
            "(delete it and re-download or regenerate the dataset)"
        )
    return GraphDataLoader(
        Preprocessing(params["model"], split=split, in_dir=in_dir, add_targets_b=add_targets)
    )


PREFETCH = 2  # trajectories decoded ahead of the consumer


class GraphDataLoader:
    """Restartable iterable over preprocessed trajectories; a producer
    thread decodes up to ``PREFETCH`` trajectories ahead of the consumer.
    A producer's exception is raised in the consumer."""

    def __init__(self, source):
        self._source = source

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        sentinel = object()
        error: list = []
        stop = threading.Event()  # set when the consumer stops early

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for item in self._source:
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                error.append(e)
            put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise RuntimeError("data prefetch thread failed") from error[0]
                    break
                yield item
        finally:
            stop.set()
            thread.join(timeout=10)

    def take(self, n: int) -> List[Dict[str, np.ndarray]]:
        out = []
        for i, traj in enumerate(self):
            if i >= n:
                break
            out.append(traj)
        return out
