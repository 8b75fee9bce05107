"""Metrics logging with local writers.

Counterpart of ``hyper_graph_nets_tpu/utils/metrics.py``, local writers
only: a JSONL event stream (one line per ``log`` call), CSV eval tables, an
artifact manifest and histogram summaries.  ``logging.wandb_mode`` other
than ``off`` logs one line and changes nothing: Weights & Biases is not a
dependency of the port.
"""
from __future__ import annotations

import csv
import hashlib
import json
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np

log = logging.getLogger(__name__)


class MetricsLogger:
    def __init__(self, out_dir: str, config: Optional[dict] = None, run_name: str = "run"):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._jsonl = open(os.path.join(out_dir, f"{run_name}.metrics.jsonl"), "a")
        self._step = 0
        if config is not None:
            mode = config.get("params", config).get("logging", {}).get("wandb_mode", "off")
            if mode != "off":
                log.warning("logging.wandb_mode %r: the port writes local logs only", mode)

    def log(self, metrics: Dict[str, Any], commit: bool = True) -> None:
        record = {"_step": self._step, "_time": time.time()}
        record.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if commit:
            self._step += 1

    def log_table(self, name: str, rows, header) -> str:
        """Write an eval table as ``<name>.csv``."""
        path = os.path.join(self.out_dir, f"{name}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            w.writerows(rows)
        return path

    def log_artifact(self, name: str, path: str, kind: str = "dataset") -> str:
        """Record a produced file (name, type, path, size, content digest,
        step) as a line of ``artifacts.jsonl``."""
        digest = hashlib.sha256()
        size = 0
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                digest.update(chunk)
                size += len(chunk)
        entry = {
            "name": name,
            "type": kind,
            "path": os.path.abspath(path),
            "bytes": size,
            "sha256": digest.hexdigest()[:16],
            "_step": self._step,
            "_time": time.time(),
        }
        manifest = os.path.join(self.out_dir, "artifacts.jsonl")
        with open(manifest, "a") as f:
            f.write(json.dumps(entry) + "\n")
        return manifest

    def log_histogram(self, name: str, values, percentile_clip: float = 90.0) -> None:
        """Mean, median, 90th percentile and the mean below it."""
        values = np.asarray(values, dtype=float).ravel()
        if len(values) == 0:
            return
        clip = np.percentile(values, percentile_clip)
        trimmed = values[values <= clip]
        self.log(
            {
                f"{name}/mean": float(values.mean()),
                f"{name}/p50": float(np.percentile(values, 50)),
                f"{name}/p90": float(clip),
                f"{name}/trimmed_mean": float(trimmed.mean()) if len(trimmed) else 0.0,
            },
            commit=False,
        )

    def close(self) -> None:
        self._jsonl.close()
