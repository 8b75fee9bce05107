"""Serving API: inference for a system model on the card.

Counterpart of ``hyper_graph_nets_tpu/serving.py``.  :class:`Predictor` owns
the model and its state on one device; :meth:`Predictor.one_step` predicts
the next state of every frame of a trajectory in one batch, and
:meth:`Predictor.rollout` rolls out from the first frame.  With
``model.agg_vjp: fused`` every message-passing block runs the fused
edge-block kernel (``ops/fused_block.py``).  With ``model.graph_balancer``
set, each call resets the expansion and runs its ``prepare`` (SDRF, whose
curvature runs K5, ``ops/maxprod.py``), as the JAX package's
``_prepare_expansion`` does, unless the caller passes a prepared ``static``;
every graph is then expanded after ``make_graph``.  With
``model.inference_quant: int8`` (or ``quantize="int8"``) it serves W8A8
int8 weights (``nn/quant.py``): every dense layer an int8 product on the
card, no set through the fused kernels.

Example::

    from hyper_graph_nets_tpu_torch.serving import Predictor
    p = Predictor.from_config("flag_full_scale")   # on the card
    p = Predictor.from_config("flag_fused_demo", checkpoint="data/flag_simple/output")
    p = Predictor.from_config("plateCluster", checkpoint=out_dir, quantize="int8")
    preds = p.one_step(trajectory)                 # [B, N, 3] next positions
    result = p.rollout(trajectory, num_steps=50)   # pred_pos, gt_pos, mse, ...
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core.mesh import mesh_fingerprint
from hyper_graph_nets_tpu_torch.models.base import ModelState, Topology
from hyper_graph_nets_tpu_torch.models.get_model import get_model
from hyper_graph_nets_tpu_torch.runtime import resolve_device
from hyper_graph_nets_tpu_torch.training import checkpoint as ckpt
from hyper_graph_nets_tpu_torch.training.expansion import build_expansion
from hyper_graph_nets_tpu_torch.training.trainer import batched_forward
from hyper_graph_nets_tpu_torch.utils.config import read_yaml


class Predictor:
    """Inference wrapper around a system model and its state.

    ``device`` defaults to the card and raises when there is none; pass
    ``device="cpu"`` to run the plain PyTorch path on the CPU.  ``state``
    defaults to a random init from seed 0.  ``quantize`` overrides the
    config's ``model.inference_quant`` (``"int8"``); the state served is
    ``model.inference_state`` of ``state``, which stays as it was.
    """

    def __init__(
        self,
        config: dict,
        state: Optional[ModelState] = None,
        device=None,
        quantize: Optional[str] = None,
    ):
        self.device = resolve_device(device)
        # own the config: nothing below may mutate the caller's dict
        config = copy.deepcopy(config)
        self.config = config
        self.params = config.get("params", config)
        if quantize is not None:
            self.params["model"]["inference_quant"] = quantize
        self.model = get_model(config)
        # the graph balancer or remote message passing, or None
        self.expansion = build_expansion(self.model, config)
        if state is None:
            state = self.model.init_state()
        self.state = self.model.inference_state(state).to(self.device)
        self._topo_cache: Dict[Tuple, Topology] = {}

    @classmethod
    def from_config(
        cls,
        config_or_name,
        checkpoint: Optional[str] = None,
        device=None,
        quantize: Optional[str] = None,
    ) -> "Predictor":
        """Build from a config name under ``configs/`` or a config dict,
        with the state of ``checkpoint`` when given: a checkpoint file (the
        port's ``.pt`` or the JAX package's ``.pkl``) or a directory, whose
        newest checkpoint of this configuration is taken."""
        config = (
            read_yaml(config_or_name)
            if isinstance(config_or_name, str)
            else config_or_name
        )
        state = None
        if checkpoint is not None:
            state = ckpt.load_model_state(ckpt.find(checkpoint, config), get_model(config))
        return cls(config, state=state, device=device, quantize=quantize)

    def _topology(self, trajectory: Dict[str, np.ndarray]) -> Topology:
        key = mesh_fingerprint(
            trajectory["cells"][0], trajectory["node_type"].shape[1]
        ) + self.model.topology_content_key(trajectory)
        if key not in self._topo_cache:
            self._topo_cache[key] = self.model.topology_from_trajectory(
                trajectory, device=self.device
            )
        return self._topo_cache[key]

    def _prepare_expansion(self, trajectory: Dict[str, np.ndarray], topo: Topology):
        """Reset the expansion and prepare it on the trajectory's first
        frame; returns its static (None without an expansion)."""
        if self.expansion is None:
            return None
        self.expansion.reset(0, trajectory["cells"].shape[0])
        frame0 = {k: v[0] for k, v in trajectory.items()}
        return self.expansion.prepare(self.model, frame0, topo)

    def _static(self, trajectory, topo, static):
        if self.expansion is None or static is not None:
            return static
        return self._prepare_expansion(trajectory, topo)

    def _frames(self, trajectory: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {
            k: torch.as_tensor(v, device=self.device)
            for k, v in trajectory.items()
            if k != "cells"
        }

    @torch.inference_mode()
    def rollout(
        self,
        trajectory: Dict[str, np.ndarray],
        num_steps: Optional[int] = None,
        static=None,
    ) -> Dict[str, Any]:
        """Recursive rollout from the trajectory's first frame: the model's
        rollout ops (``pred_pos``, ``gt_pos``, ``faces``, ``mesh_pos``; for
        cylinder ``pred_velocity``, ``pred_pressure``, ``gt_velocity``,
        ``gt_pressure``; for plate also the obstacle ``mask``) plus per-step
        ``mse``, as numpy arrays.  ``static`` is a prepared
        expansion static (``expansion.prepare``) to use in place of
        preparing one here."""
        topo = self._topology(trajectory)
        static = self._static(trajectory, topo, static)
        ops, mse = self.model.rollout(
            self.state, topo, trajectory, num_steps=num_steps,
            expansion=self.expansion, static=static,
        )
        out = {
            k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in ops.items()
        }
        out["mse"] = mse.cpu().numpy()
        return out

    @torch.inference_mode()
    def one_step(self, trajectory: Dict[str, np.ndarray], static=None):
        """Next-state prediction of the model's field for every frame, as
        one batch: ``[B, N, D]`` positions for flag and plate; for cylinder
        the pair ``(velocity [B, N, 2], pressure [B, N, 1])``.  ``static``
        as in :meth:`rollout`."""
        topo = self._topology(trajectory)
        static = self._static(trajectory, topo, static)
        frames = self._frames(trajectory)
        graph, _, _ = self.model.make_graph(self.state, topo, frames, False)
        if self.expansion is not None:
            graph, _ = self.expansion.expand(
                self.state, graph, frames, self.model, is_training=False, static=static
            )
        out = batched_forward(self.model, self.state.params, graph)
        pred = self.model.update(self.state, frames, out)
        if isinstance(pred, tuple):
            return tuple(p.cpu().numpy() for p in pred)
        return pred.cpu().numpy()
