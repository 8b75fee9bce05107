"""Training: train and validation steps over batched frames.

Counterpart of ``hyper_graph_nets_tpu/training/trainer.py``, with the
configured expansion (the graph balancer, remote message passing) applied
after ``make_graph``.  The JAX package vmaps the
network over frames that share one topology; here the batch dimension is
written out, and every layer of the network takes ``[B, N, F]`` /
``[B, E, F]`` features directly.

Training noise (``add_noise``): Gaussian noise on the dynamic field at
NORMAL nodes, with ``(1 - gamma)`` target compensation.  The standard-normal
draw comes from an explicit ``torch.Generator`` on the trainer's device, or
from a tensor the caller passes in (JAX's PRNG cannot be matched, so the
parity tests pass JAX's draw).  With RMP's ``hyper_noise`` the cluster
means get noise too: a second standard-normal draw ``[B, K, D]``, from the
same generator after the field's, or passed in as ``hyper_normal``.

Example::

    from hyper_graph_nets_tpu_torch.models.get_model import get_model
    from hyper_graph_nets_tpu_torch.training.trainer import Trainer
    model = get_model(config)
    trainer = Trainer(model, config)             # on the card
    tstate = trainer.init_train_state()
    topo = model.topology_from_trajectory(traj, device=trainer.device)
    frames = trainer.frames(batch)               # [B, ...] tensors on the card
    tstate, loss = trainer.train_step(tstate, topo, frames)

With ``model.graph_balancer`` or ``model.rmp`` set, prepare the expansion
once per reset and pass its static to each step, as
``make_train_step(topo, expansion)`` takes it::

    static = trainer.expansion.prepare(model, frame0, topo)
    tstate, loss = trainer.train_step(tstate, topo, frames, static=static)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core.graph import Graph, NodeType
from hyper_graph_nets_tpu_torch.models.base import ModelState, SystemModel, Topology
from hyper_graph_nets_tpu_torch.nn.meshgraphnet import MeshGraphNet, network_apply
from hyper_graph_nets_tpu_torch.runtime import configure_numerics, resolve_device
from hyper_graph_nets_tpu_torch.training.expansion import build_expansion

ADAM_BETAS = (0.9, 0.999)  # optax.adam's defaults
ADAM_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class TrainState:
    """Model state, the optimizer that owns its parameters, and the step.

    The optimizer updates ``model.params`` in place; each train step returns
    a new ``TrainState`` with new normalizer states and the next step count.
    """

    model: ModelState
    opt_state: torch.optim.Adam
    step: int


def add_noise(
    frames: Dict[str, torch.Tensor],
    field: str,
    scale: float,
    gamma: float,
    normal: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Inject ``scale * normal`` on NORMAL nodes with target compensation;
    returns new frames (the inputs are not changed)."""
    x = frames[field]
    noise = scale * normal.to(x.dtype)
    mask = (frames["node_type"][..., 0] == NodeType.NORMAL)[..., None]
    noise = torch.where(mask, noise, torch.zeros_like(noise))
    out = dict(frames)
    out[field] = x + noise
    out["target|" + field] = frames["target|" + field] + (1.0 - gamma) * noise
    return out


def graph_metrics(aux: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Model counters from ``make_graph`` aux, summed over the batch: plate's
    ``world_truncated``; other models contribute nothing."""
    metrics = {}
    if "world_truncated" in aux:
        metrics["world_edge_truncated"] = aux["world_truncated"].sum()
    return metrics


def batched_forward(model: SystemModel, params: MeshGraphNet, graph: Graph) -> torch.Tensor:
    """Network outputs ``[B, N, output_size]`` for a batched graph."""
    return network_apply(params, graph, model.gnn_config)


def masked_mse(model: SystemModel, target, out, node_type) -> torch.Tensor:
    """Mean squared error over the loss rows (the JAX package's
    ``trainer.py:152-155``)."""
    mask = model.loss_mask(node_type).to(out.dtype)[..., None]
    return ((target - out).square() * mask).sum() / (mask.sum() * out.shape[-1])


def frames_to_batches(
    trajectory: Dict[str, np.ndarray],
    batch_size: int,
    num_steps: Optional[int] = None,
    device="cpu",
) -> Iterator[Dict[str, torch.Tensor]]:
    """Split a ``[T, ...]`` trajectory into ``[B, ...]`` frame batches on
    ``device``; the last batch holds the remainder (``cells`` stays on the
    host: the topology is extracted once)."""
    T = min(
        trajectory[next(iter(trajectory))].shape[0],
        num_steps if num_steps is not None else 10**9,
    )
    for start in range(0, T, batch_size):
        end = min(start + batch_size, T)
        yield {
            k: torch.as_tensor(v[start:end], device=device)
            for k, v in trajectory.items()
            if k != "cells"
        }


class Trainer:
    """The optimizer and the train/validation steps of one model.

    Runs on the card unless ``device="cpu"``.  Adam with optax's defaults
    (betas 0.9, 0.999, eps 1e-8) at ``model.learning_rate``; with
    ``model.lr_decay_steps`` set, the rate follows optax's
    ``exponential_decay``: ``lr * rate**(count / steps)``, not staircase,
    floored at ``lr_min``.
    """

    def __init__(self, model: SystemModel, config: dict, device=None):
        self.device = resolve_device(device)
        configure_numerics()
        self.model = model
        # the graph balancer and RMP, or None
        self.expansion = build_expansion(model, config)
        params = config.get("params", config)
        model_cfg = params["model"]
        self.lr = float(model_cfg.get("learning_rate", 1e-4))
        self.decay_steps = model_cfg.get("lr_decay_steps")
        self.decay_rate = float(model_cfg.get("lr_decay_rate", 0.01))
        self.lr_min = float(model_cfg.get("lr_min", 1e-6))

    def learning_rate(self, count: int) -> float:
        """The rate of the update made after ``count`` earlier updates."""
        if not self.decay_steps:
            return self.lr
        value = self.lr * self.decay_rate ** (count / self.decay_steps)
        return max(value, self.lr_min) if self.decay_rate < 1.0 else min(value, self.lr_min)

    def init_train_state(
        self, generator: Optional[torch.Generator] = None, state: Optional[ModelState] = None
    ) -> TrainState:
        """Random init from ``generator`` (seed 0 by default), or ``state``,
        copied to the trainer's device."""
        mstate = (state or self.model.init_state(generator)).to(self.device)
        opt = torch.optim.Adam(
            mstate.params.parameters(), lr=self.learning_rate(0), betas=ADAM_BETAS,
            eps=ADAM_EPS, foreach=True,
        )
        return TrainState(model=mstate, opt_state=opt, step=0)

    def frames(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A batch of frames as tensors on the trainer's device."""
        return {
            k: torch.as_tensor(v, device=self.device) for k, v in batch.items() if k != "cells"
        }

    def loss_and_grads(
        self,
        tstate: TrainState,
        topo: Topology,
        frames: Dict[str, torch.Tensor],
        normal: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        static=None,
        hyper_normal: Optional[torch.Tensor] = None,
        with_metrics: bool = False,
    ):
        """Noise, loss and backward of one step: returns the loss and the new
        normalizer states, and leaves each parameter's gradient in its
        ``.grad``.  ``normal`` is the standard-normal noise draw and
        ``hyper_normal`` RMP's on the cluster means (each drawn from
        ``generator`` when omitted, the field's first); ``static`` is the
        prepared expansion's (its cached one when omitted).  With
        ``with_metrics`` the model counters (:func:`graph_metrics`) follow."""
        model = self.model
        if model.noise_scale is not None:
            x = frames[model.field]
            if normal is None:
                normal = torch.randn(
                    x.shape, generator=generator, device=x.device, dtype=x.dtype
                )
            frames = add_noise(frames, model.field, model.noise_scale, model.noise_gamma, normal)
        params = tstate.model.params
        params.zero_grad(set_to_none=True)
        graph, aux, mstate = model.make_graph(tstate.model, topo, frames, True)
        if self.expansion is not None:
            graph, mstate = self.expansion.expand(
                mstate, graph, frames, model, is_training=True, static=static,
                hyper_normal=hyper_normal, generator=generator,
            )
        target, mstate = model.get_target(mstate, frames, is_training=True)
        out = batched_forward(model, params, graph)
        loss = masked_mse(model, target, out, frames["node_type"])
        loss.backward()
        if with_metrics:
            return loss.detach(), mstate.normalizers, graph_metrics(aux)
        return loss.detach(), mstate.normalizers

    def train_step(
        self,
        tstate: TrainState,
        topo: Topology,
        frames: Dict[str, torch.Tensor],
        normal: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        static=None,
        hyper_normal: Optional[torch.Tensor] = None,
        with_metrics: bool = False,
    ):
        """One Adam step (``make_train_step``; the noise and ``static`` as in
        :meth:`loss_and_grads`).

        Updates the parameters in place and returns ``(new state, loss)``:
        the new state holds new normalizer states (the old ones are left as
        they were) and ``step + 1``.  With ``with_metrics``, ``(new state,
        loss, metrics)``: the model counters of the batch
        (:func:`graph_metrics`, on the device; plate's
        ``world_edge_truncated``).
        """
        loss, normalizers, metrics = self.loss_and_grads(
            tstate, topo, frames, normal, generator, static, hyper_normal, with_metrics=True
        )
        opt = tstate.opt_state
        for group in opt.param_groups:
            group["lr"] = self.learning_rate(tstate.step)
        opt.step()
        new_model = tstate.model.replace(normalizers=normalizers)
        new_state = TrainState(model=new_model, opt_state=opt, step=tstate.step + 1)
        if with_metrics:
            return new_state, loss, metrics
        return new_state, loss

    @torch.no_grad()
    def validation_step(
        self,
        mstate: ModelState,
        topo: Topology,
        frames: Dict[str, torch.Tensor],
        static=None,
        with_metrics: bool = False,
    ):
        """One-step evaluation: (normalized loss, de-normalized field error);
        no noise, no normalizer accumulation (``make_validation_step``);
        ``static`` as in :meth:`loss_and_grads`.  A model whose update is a
        tuple (cylinder's velocity and pressure) is scored on its first
        part, the field.  With ``with_metrics`` the model counters follow,
        as in :meth:`train_step`."""
        model = self.model
        graph, aux, _ = model.make_graph(mstate, topo, frames, False)
        if self.expansion is not None:
            graph, _ = self.expansion.expand(mstate, graph, frames, model, is_training=False, static=static)
        target, _ = model.get_target(mstate, frames, is_training=False)
        out = batched_forward(model, mstate.params, graph)
        loss = masked_mse(model, target, out, frames["node_type"])
        prediction = model.update(mstate, frames, out)
        if isinstance(prediction, tuple):
            prediction = prediction[0]
        diff = frames["target|" + model.field] - prediction
        pos_error = masked_mse(model, torch.zeros_like(diff), diff, frames["node_type"])
        if with_metrics:
            return loss, pos_error, graph_metrics(aux)
        return loss, pos_error
