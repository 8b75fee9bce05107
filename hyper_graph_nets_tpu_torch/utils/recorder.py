"""Recorder: a registry of logger plugins.

Counterpart of ``hyper_graph_nets_tpu/utils/recorder.py``: a Recorder that
dispatches records to registered loggers (scalars with duration and peak
RSS, the config dumped once, a python-logging ``out.log``), so custom sinks
can be registered per experiment.  The task loop does not call it, as the
JAX package's does not: its callers are a user's own scripts.
"""
from __future__ import annotations

import json
import logging
import os
import resource
import time
from typing import Callable, Dict, List, Optional


class AbstractLogger:
    def log(self, record: Dict) -> None:
        raise NotImplementedError

    def finalize(self) -> None:
        pass


class ScalarsLogger(AbstractLogger):
    """Scalars with the run's duration and peak RSS, as ``scalars.jsonl``."""

    def __init__(self, out_dir: str):
        self._path = os.path.join(out_dir, "scalars.jsonl")
        self._file = open(self._path, "a")
        self._start = time.time()

    def log(self, record: Dict) -> None:
        record = dict(record)
        record["duration_s"] = time.time() - self._start
        record["max_rss_kb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        self._file.write(json.dumps(record, default=str) + "\n")
        self._file.flush()

    def finalize(self) -> None:
        self._file.close()


class ConfigLogger(AbstractLogger):
    """Dump the experiment config once, as ``config.json``."""

    def __init__(self, out_dir: str, config: dict):
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)

    def log(self, record: Dict) -> None:
        pass


class PythonLogger(AbstractLogger):
    """Records as lines of ``out.log`` through python logging."""

    def __init__(self, out_dir: str, name: str = "hgn"):
        self._logger = logging.getLogger(name)
        self._logger.setLevel(logging.INFO)
        if not self._logger.handlers:
            handler = logging.FileHandler(os.path.join(out_dir, "out.log"))
            handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
            self._logger.addHandler(handler)

    def log(self, record: Dict) -> None:
        self._logger.info(json.dumps(record, default=str))


_REGISTRY: Dict[str, Callable[..., AbstractLogger]] = {
    "scalars": ScalarsLogger,
    "config": ConfigLogger,
    "python": PythonLogger,
}


def register_logger(name: str, factory: Callable[..., AbstractLogger]) -> None:
    _REGISTRY[name] = factory


class Recorder:
    """Dispatch records to the named loggers (``scalars`` and ``python`` by
    default; the config is dumped whenever one is given)."""

    def __init__(self, out_dir: str, config: Optional[dict] = None, loggers: Optional[List[str]] = None):
        os.makedirs(out_dir, exist_ok=True)
        names = loggers or ["scalars", "python"]
        self._loggers: List[AbstractLogger] = []
        for name in names:
            factory = _REGISTRY[name]
            if name == "config":
                self._loggers.append(factory(out_dir, config or {}))
            else:
                self._loggers.append(factory(out_dir))
        if config is not None and "config" not in names:
            self._loggers.append(ConfigLogger(out_dir, config))

    def record(self, record: Dict) -> None:
        for logger in self._loggers:
            logger.log(record)

    def finalize(self) -> None:
        for logger in self._loggers:
            logger.finalize()
