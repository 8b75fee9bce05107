"""Convert the JAX package's model state into the port's :class:`ModelState`.

This is the only module that knows the JAX layout:

- dense weights are ``[in, out]`` (the port holds ``[out, in]``);
- the processor's block parameters are stacked on a leading
  ``[message_passing_steps, ...]`` axis (``nn/meshgraphnet.py:48-52``),
  the hierarchical blocks' node models (``hyper_node_model_up``,
  ``node_model_down``, ``hyper_node_model_cross``, multiscale's list
  ``hyper_node_models_cross``) included; the hyper tier's encoder is
  ``encoder.hyper_node_model``;
- a normalizer state has the fields ``acc_count``, ``num_accumulations``,
  ``acc_sum``, ``acc_sum_squared`` (and optionally the static
  ``max_accumulations`` / ``std_epsilon``).

Edge encoders and edge models are taken per edge set by name and
normalizers by name, whatever their widths: plate's ``world_edges`` encoder
and ``world_edge`` normalizer and cylinder's 3-wide ``output`` normalizer
(velocity and pressure) convert like flag's trees, and so does HGN plate's
(``plateCluster``: the world set beside the three cluster-tier sets, the
hyper encoder, the hierarchical node models and the RMP normalizers,
``inter_cluster_world``'s 4-wide encoder among them when it is set).

Inputs are nested dicts (lists for MLP layers) of numpy arrays, so neither
side needs the other's framework.  :func:`train_state_from_jax_numpy` also
moves optax's Adam state: its moments ``mu`` and ``nu`` have the
parameters' layout and convert the same way, its ``count`` is each
parameter's ``step`` in ``torch.optim.Adam``.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core.normalizer import NormalizerState
from hyper_graph_nets_tpu_torch.models.base import ModelState
from hyper_graph_nets_tpu_torch.nn.blocks import GraphNetBlock
from hyper_graph_nets_tpu_torch.nn.meshgraphnet import MeshGraphNet
from hyper_graph_nets_tpu_torch.nn.mlp import MLP

if TYPE_CHECKING:
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer, TrainState

_BLOCK_KEYS = {
    "edge_models", "node_model_cross", "hyper_node_model_up", "node_model_down",
    "hyper_node_model_cross", "hyper_node_models_cross",
}
_ENCODER_KEYS = {"node_model", "edge_models", "hyper_node_model"}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _mlp(p: Dict[str, Any]) -> MLP:
    weights = [_tensor(np.asarray(layer["w"]).T) for layer in p["layers"]]
    biases = [_tensor(layer["b"]) for layer in p["layers"]]
    ln = p.get("ln")
    if ln is None:
        return MLP(weights, biases)
    return MLP(weights, biases, _tensor(ln["scale"]), _tensor(ln["bias"]))


def _index(tree, i: int):
    """Block ``i`` of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_index(v, i) for v in tree]
    return np.asarray(tree)[i]


def _num_steps(tree) -> int:
    if isinstance(tree, dict):
        return _num_steps(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _num_steps(tree[0])
    return np.asarray(tree).shape[0]


def _normalizer(d: Dict[str, Any]) -> NormalizerState:
    static = {
        k: float(d[k]) for k in ("max_accumulations", "std_epsilon") if k in d
    }
    return NormalizerState(
        acc_count=_tensor(d["acc_count"]),
        num_accumulations=_tensor(d["num_accumulations"]),
        acc_sum=_tensor(d["acc_sum"]),
        acc_sum_squared=_tensor(d["acc_sum_squared"]),
        **static,
    )


def state_from_jax_numpy(
    params: Dict[str, Any], normalizers: Dict[str, Dict[str, Any]]
) -> ModelState:
    """The port's state (float32, on the CPU) from JAX params and normalizer
    states given as nested dicts of numpy arrays.  Raises on parameters the
    port does not know."""
    enc, proc = params["encoder"], params["processor"]
    extra = (set(enc) - _ENCODER_KEYS) | (set(proc) - _BLOCK_KEYS)
    if extra:
        raise NotImplementedError(f"unknown parameters {sorted(extra)}")
    optional = lambda block, key: _mlp(block[key]) if key in block else None
    blocks = []
    for i in range(_num_steps(proc)):
        block = _index(proc, i)
        cross = block.get("hyper_node_models_cross")
        blocks.append(
            GraphNetBlock(
                {name: _mlp(p) for name, p in block["edge_models"].items()},
                _mlp(block["node_model_cross"]),
                hyper_node_model_up=optional(block, "hyper_node_model_up"),
                node_model_down=optional(block, "node_model_down"),
                hyper_node_model_cross=optional(block, "hyper_node_model_cross"),
                hyper_node_models_cross=None if cross is None else [_mlp(p) for p in cross],
            )
        )
    net = MeshGraphNet(
        node_encoder=_mlp(enc["node_model"]),
        edge_encoders={name: _mlp(p) for name, p in enc["edge_models"].items()},
        blocks=blocks,
        decoder=_mlp(params["decoder"]),
        hyper_encoder=optional(enc, "hyper_node_model"),
    )
    return ModelState(
        params=net,
        normalizers={name: _normalizer(d) for name, d in normalizers.items()},
    )


def train_state_from_jax_numpy(
    trainer: "Trainer",
    params: Dict[str, Any],
    normalizers: Dict[str, Dict[str, Any]],
    mu: Dict[str, Any],
    nu: Dict[str, Any],
    count,
    step,
) -> "TrainState":
    """``trainer``'s train state, on its device, from the JAX package's
    weights, normalizer states, Adam moments (``mu``, ``nu``: trees of the
    weights' layout) and Adam ``count``, and its train-state ``step``, all
    as numpy.  The next Adam update is then the JAX package's next one."""
    tstate = trainer.init_train_state(state=state_from_jax_numpy(params, normalizers))
    moments = {
        key: dict(state_from_jax_numpy(tree, {}).params.named_parameters())
        for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu))
    }
    opt = tstate.opt_state
    for name, p in tstate.model.params.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(float(np.asarray(count))),
            **{key: m[name].detach().to(p) for key, m in moments.items()},
        }
    return dataclasses.replace(tstate, step=int(np.asarray(step)))
