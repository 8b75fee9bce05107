"""Checkpoints: the full training state, with epoch-granular resume.

Counterpart of ``hyper_graph_nets_tpu/training/checkpoint.py``.  A
checkpoint carries the network weights, the Adam state, the normalizer
statistics, the step and the epoch, under the JAX package's
hyperparameter-encoding name (``model_{...}_epoch:{e}``):

- the port's own: ``torch.save`` of plain state dicts, with the suffix
  ``.pt``.  The JAX package's ``latest`` matches only ``.pkl``, so a JAX
  resume in the same output directory never picks up a port file;
- the JAX package's (``.pkl``, a pickled tree of numpy arrays whose classes
  are flax dataclasses and optax states): read by an unpickler that maps
  each of those classes to a plain stand-in, so neither JAX, flax nor optax
  is imported, then converted by ``convert.train_state_from_jax_numpy``.

``latest`` takes the highest epoch of either kind (the port's own on a
tie).  ``logging.checkpoint_backend: orbax`` needs JAX and raises.
"""
from __future__ import annotations

import collections
import os
import pickle
import re
from typing import Optional, Tuple

import torch

from hyper_graph_nets_tpu_torch.convert import state_from_jax_numpy, train_state_from_jax_numpy
from hyper_graph_nets_tpu_torch.core.normalizer import NormalizerState
from hyper_graph_nets_tpu_torch.models.base import ModelState, SystemModel
from hyper_graph_nets_tpu_torch.training.trainer import TrainState, Trainer

SUFFIX = ".pt"
JAX_SUFFIX = ".pkl"
_NORMALIZER_TENSORS = ("acc_count", "num_accumulations", "acc_sum", "acc_sum_squared")


def checkpoint_name(config: dict, epoch: int, suffix: str = SUFFIX) -> str:
    """The JAX package's hyperparameter-encoding file name, with ``suffix``."""
    params = config.get("params", config)
    model = params["model"]
    rmp = model.get("rmp", {})
    bal = model.get("graph_balancer", {})
    return (
        f"model_{rmp.get('num_clusters', 0)}_cluster:{rmp.get('clustering', 'none')}"
        f"_connector:{rmp.get('connector', 'none')}"
        f"_balancer:{bal.get('algorithm', 'none')}"
        f"_mp:{model.get('message_passing_steps', 0)}_epoch:{epoch}{suffix}"
    )


def _check_backend(config: dict) -> None:
    params = config.get("params", config)
    backend = params.get("logging", {}).get("checkpoint_backend", "pickle")
    if backend == "orbax":
        raise NotImplementedError("checkpoint_backend 'orbax' needs JAX; the port writes its own .pt files")


def save(directory: str, config: dict, tstate: TrainState, epoch: int, extra: Optional[dict] = None) -> str:
    """Write ``tstate`` at ``epoch`` (atomically) and return the path."""
    _check_backend(config)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, checkpoint_name(config, epoch))
    normalizers = {
        name: {
            **{f: getattr(ns, f).cpu() for f in _NORMALIZER_TENSORS},
            "max_accumulations": ns.max_accumulations,
            "std_epsilon": ns.std_epsilon,
        }
        for name, ns in tstate.model.normalizers.items()
    }
    payload = {
        "params": {k: v.cpu() for k, v in tstate.model.params.state_dict().items()},
        "normalizers": normalizers,
        "optimizer": tstate.opt_state.state_dict(),
        "step": int(tstate.step),
        "epoch": epoch,
        "extra": extra or {},
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def latest(directory: str, config: dict) -> Optional[Tuple[str, int]]:
    """``(path, epoch)`` of the newest checkpoint of this configuration,
    the port's or the JAX package's; on equal epochs the port's own."""
    if not os.path.isdir(directory):
        return None
    prefix = re.escape(checkpoint_name(config, 0, suffix="").split("_epoch:")[0])
    best: Optional[Tuple[int, bool, str]] = None
    for name in os.listdir(directory):
        m = re.match(prefix + r"_epoch:(\d+)(\.pt|\.pkl)$", name)
        if m:
            cand = (int(m.group(1)), m.group(2) == SUFFIX, os.path.join(directory, name))
            if best is None or cand[:2] > best[:2]:
                best = cand
    return None if best is None else (best[2], best[0])


# -- the JAX package's pickles -------------------------------------------------


class _Fields:
    """Stand-in for a pickled dataclass: keeps its fields as attributes."""


_ScaleByAdamState = collections.namedtuple("ScaleByAdamState", "count mu nu")
_ScaleByScheduleState = collections.namedtuple("ScaleByScheduleState", "count")
_EmptyState = collections.namedtuple("EmptyState", "")

# every JAX-side class a JAX checkpoint names (listed with pickletools in
# tests/test_torch_port_task.py), mapped to its stand-in
JAX_GLOBALS = {
    ("hyper_graph_nets_tpu.training.trainer", "TrainState"): _Fields,
    ("hyper_graph_nets_tpu.models.base", "ModelState"): _Fields,
    ("hyper_graph_nets_tpu.core.normalizer", "NormalizerState"): _Fields,
    ("optax._src.transform", "ScaleByAdamState"): _ScaleByAdamState,
    ("optax._src.transform", "ScaleByScheduleState"): _ScaleByScheduleState,
    ("optax._src.base", "EmptyState"): _EmptyState,
}
# the numpy globals a pickle of arrays and scalars names (protocols 3-4;
# ``_frombuffer`` from protocol 5), under numpy 1's and numpy 2's spellings
NUMPY_GLOBALS = frozenset(
    [("numpy", "ndarray"), ("numpy", "dtype")]
    + [(f"numpy.{core}.multiarray", n) for core in ("core", "_core") for n in ("_reconstruct", "scalar")]
    + [(f"numpy.{core}.numeric", "_frombuffer") for core in ("core", "_core")]
)


class _JaxUnpickler(pickle.Unpickler):
    """Resolves the JAX package's classes to stand-ins and the numpy globals
    above to numpy's; refuses any other global, dotted names included."""

    def find_class(self, module: str, name: str):
        if (module, name) in JAX_GLOBALS:
            return JAX_GLOBALS[(module, name)]
        if (module, name) in NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"a JAX checkpoint does not name {module}.{name}")


def _read_jax(path: str) -> dict:
    """The JAX checkpoint's numpy trees: ``params``, ``normalizers``
    (``{name: {field: array}}``), Adam's ``count``, ``mu``, ``nu``, the
    ``step``, ``epoch`` and ``extra``."""
    with open(path, "rb") as f:
        payload = _JaxUnpickler(f).load()
    ts = payload["tstate"]
    adam = next(s for s in ts.opt_state if isinstance(s, _ScaleByAdamState))
    return {
        "params": ts.model.params,
        "normalizers": {name: vars(ns) for name, ns in ts.model.normalizers.items()},
        "count": adam.count,
        "mu": adam.mu,
        "nu": adam.nu,
        "step": ts.step,
        "epoch": payload["epoch"],
        "extra": payload.get("extra", {}),
    }


# -- loading ---------------------------------------------------------------------


def _model_state(model: SystemModel, payload: dict) -> ModelState:
    """The port's model state (on the CPU) from a ``.pt`` payload."""
    state = model.init_state()
    state.params.load_state_dict(payload["params"])
    normalizers = {name: NormalizerState(**d) for name, d in payload["normalizers"].items()}
    return state.replace(normalizers=normalizers)


def load(path: str, trainer: Trainer) -> Tuple[TrainState, int, dict]:
    """``(train state on trainer's device, epoch, extra)`` from a checkpoint
    of either kind."""
    if path.endswith(JAX_SUFFIX):
        d = _read_jax(path)
        tstate = train_state_from_jax_numpy(
            trainer, d["params"], d["normalizers"], d["mu"], d["nu"], d["count"], d["step"]
        )
        return tstate, int(d["epoch"]), d["extra"]
    payload = torch.load(path, map_location="cpu", weights_only=True)
    tstate = trainer.init_train_state(state=_model_state(trainer.model, payload))
    tstate.opt_state.load_state_dict(payload["optimizer"])
    return TrainState(tstate.model, tstate.opt_state, payload["step"]), payload["epoch"], payload["extra"]


def load_model_state(path: str, model: SystemModel) -> ModelState:
    """The model state alone (on the CPU), for serving."""
    if path.endswith(JAX_SUFFIX):
        d = _read_jax(path)
        return state_from_jax_numpy(d["params"], d["normalizers"])
    return _model_state(model, torch.load(path, map_location="cpu", weights_only=True))


def find(path: str, config: dict) -> str:
    """``path`` itself, or the newest checkpoint in the directory ``path``."""
    if not os.path.isdir(path):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint at {path}")
        return path
    found = latest(path, config)
    if found is None:
        raise FileNotFoundError(f"no checkpoint matching this config under {path}")
    return found[0]

