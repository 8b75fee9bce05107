"""CylinderModel: Eulerian fluid dynamics (cylinder_flow).

Counterpart of ``hyper_graph_nets_tpu/models/cylinder.py``:

- node types compacted 4 -> 1, 5 -> 2, 6 -> 3 before one-hot(4); node
  features: velocity (2) ++ the one-hot;
- mesh-edge features ``[rel_mesh, |rel_mesh|]`` (3);
- output ``(delta velocity (2), pressure (1))``; ``update`` returns the
  tuple ``(velocity + dv, pressure)``;
- target ``[target|velocity - velocity, pressure]``: the pressure target is
  the current frame's pressure, a quirk of the reference kept as it is;
- loss rows: NORMAL or OUTFLOW nodes;
- rollout and n-step: a Python loop whose carry is ``(velocity,
  pressure)``; loss rows take the predicted velocity, the others keep
  theirs, and every step's pressure is the prediction.  As in the JAX
  package, step ``t`` records the velocity after ``t + 1`` steps and its
  MSE is taken against frame ``t``.

Frames may carry a leading batch dimension.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core import normalizer as norm
from hyper_graph_nets_tpu_torch.core.graph import Graph, NodeType
from hyper_graph_nets_tpu_torch.models.base import (
    ModelState,
    SystemModel,
    Topology,
    mesh_edge_set,
    norm_feature,
    one_hot,
)


class CylinderModel(SystemModel):
    model_type = "cylinder"
    world_dim = 2  # the velocity field
    mesh_dim = 2

    def geometry(self, frames):
        return frames["velocity"], frames["mesh_pos"]

    def carry_to_frame(self, carry) -> Dict[str, torch.Tensor]:
        """Rollout carry ``(velocity, pressure)`` -> frame fields."""
        return {"velocity": carry[0], "pressure": carry[1]}

    def mesh_edge_features(self, frames, senders: torch.Tensor, receivers: torch.Tensor) -> torch.Tensor:
        mesh = frames["mesh_pos"]
        return norm_feature(mesh[..., senders.long(), :] - mesh[..., receivers.long(), :])

    def node_in_dim(self) -> int:
        return 2 + 4  # velocity ++ compacted one-hot

    def edge_in_dims(self) -> Tuple[Tuple[str, int], ...]:
        if self.architecture == "multi":
            raise NotImplementedError(
                "the multigraph connector needs mesh and remote edges of one width; "
                "cylinder's mesh edges are 3 wide and its remote edges 6 (as in the JAX package)"
            )
        dims = [("mesh_edges", self.mesh_dim + 1)]
        if self.use_balancer:
            dims.append(("balance", self.mesh_dim + 1))
        if self.use_rmp:
            rmp_dim = self.world_dim + 1 + self.mesh_dim + 1
            for name in ("intra_cluster_to_cluster", "intra_cluster_to_mesh", "inter_cluster"):
                dims.append((name, rmp_dim))
        return tuple(dims)

    def normalizer_schema(self) -> Dict[str, int]:
        schema = {
            "output": self.output_size,
            "node": self.node_in_dim(),
            "node_dynamic": 1,
            "mesh_edge": self.mesh_dim + 1,
        }
        if self.use_rmp:
            rmp_dim = self.world_dim + 1 + self.mesh_dim + 1
            schema.update(intra_edge=rmp_dim, inter_edge=rmp_dim, hyper_node=3)
        return schema

    @staticmethod
    def compact_node_type(node_type: torch.Tensor) -> torch.Tensor:
        codes = node_type[..., 0].long()
        for old, new in ((4, 1), (5, 2), (6, 3)):
            codes = torch.where(codes == old, new, codes)
        return codes

    def frame_features(self, senders, receivers, frame: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Raw (unnormalized) features of one frame or a batch of frames."""
        velocity = frame["velocity"]
        codes = self.compact_node_type(frame["node_type"])
        return {
            "node_features": torch.cat([velocity, one_hot(codes, 4, velocity.dtype)], dim=-1),
            "mesh_edge_features": self.mesh_edge_features(frame, senders, receivers),
        }

    def make_graph(
        self,
        state: ModelState,
        topo: Topology,
        frames: Dict[str, torch.Tensor],
        is_training: bool,
    ) -> Tuple[Graph, Dict[str, torch.Tensor], ModelState]:
        """Build the input graph; returns (graph, raw aux, new state)."""
        raw = self.frame_features(topo.senders, topo.receivers, frames)
        node_valid = (frames["node_type"][..., 0] >= 0).to(torch.float32)
        node_feats, state = self._normalize(
            state, "node", raw["node_features"], accumulate=is_training, mask=node_valid
        )
        edge_mask = None
        if topo.mask is not None:
            edge_mask = topo.mask.expand(raw["mesh_edge_features"].shape[:-1])
        edge_feats, state = self._normalize(
            state, "mesh_edge", raw["mesh_edge_features"], accumulate=is_training, mask=edge_mask
        )
        graph = Graph(
            node_features=node_feats,
            edge_sets={"mesh_edges": mesh_edge_set(topo, edge_feats)},
        )
        return graph, {"mesh_edge_features_raw": raw["mesh_edge_features"]}, state

    def loss_mask(self, node_type: torch.Tensor) -> torch.Tensor:
        codes = node_type[..., 0]
        return (codes == NodeType.NORMAL) | (codes == NodeType.OUTFLOW)

    def get_target(
        self, state: ModelState, frames: Dict[str, torch.Tensor], is_training: bool = True
    ) -> Tuple[torch.Tensor, ModelState]:
        """Normalized ``[dv, pressure]`` (the current frame's pressure)."""
        dv = frames["target|velocity"] - frames["velocity"]
        target = torch.cat([dv, frames["pressure"]], dim=-1)
        return self._normalize(state, "output", target, accumulate=is_training)

    def update(self, state: ModelState, frames, net_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(velocity + dv, pressure)``."""
        out = norm.inverse(state.normalizers["output"], net_out)
        return frames["velocity"] + out[..., :2], out[..., 2:]

    # ------------------------------------------------------------------
    def _step(self, state, topo, frame, mask, expansion, static):
        (pred_v, pred_p), _ = self.predict(state, topo, frame, expansion, static)
        return torch.where(mask, pred_v, frame["velocity"]), pred_p

    def rollout(
        self,
        state: ModelState,
        topo: Topology,
        trajectory: Dict[str, np.ndarray],
        num_steps: Optional[int] = None,
        expansion=None,
        static=None,
        start_carry=None,
        return_carry: bool = False,
    ):
        """Recursive rollout from the first frame (or ``start_carry``, a
        ``(velocity, pressure)`` pair); returns (traj_ops, per-step MSE of
        the velocity) and, with ``return_carry``, the final carry."""
        T = trajectory["cells"].shape[0]
        num_steps = T if num_steps is None else min(num_steps, T)
        device = topo.senders.device
        init = {k: torch.as_tensor(v[0], device=device) for k, v in trajectory.items() if k != "cells"}
        static_frame = {"mesh_pos": init["mesh_pos"], "node_type": init["node_type"]}
        mask = self.loss_mask(init["node_type"])[:, None]
        carry = (init["velocity"], init["pressure"]) if start_carry is None else start_carry
        pred_v, pred_p = [], []
        for _ in range(num_steps):
            frame = {**static_frame, "velocity": carry[0], "pressure": carry[1]}
            carry = self._step(state, topo, frame, mask, expansion, static)
            pred_v.append(carry[0])
            pred_p.append(carry[1])
        pred_v, pred_p = torch.stack(pred_v), torch.stack(pred_p)
        gt = torch.as_tensor(trajectory["velocity"][:num_steps], device=device)
        mse = (gt - pred_v).square().mean(dim=(-2, -1))
        traj_ops = {
            "faces": trajectory["cells"],
            "mesh_pos": trajectory["mesh_pos"],
            "gt_velocity": trajectory["velocity"],
            "gt_pressure": trajectory["pressure"],
            "pred_velocity": pred_v,
            "pred_pressure": pred_p,
        }
        if return_carry:
            return traj_ops, mse, carry
        return traj_ops, mse

    def n_step_computation(
        self,
        state: ModelState,
        topo: Topology,
        trajectory: Dict[str, np.ndarray],
        n_step: int,
        num_timesteps: Optional[int] = None,
        expansion=None,
        static=None,
    ) -> Tuple[float, float]:
        """Sliding-window n-step losses, a chunk of windows per batch of
        frames: each window starting at frame ``s < T - n_step`` takes
        ``n_step + 1`` steps from frame ``s`` and its step ``k`` is held
        against frame ``s + k``, as in the JAX package."""
        T = trajectory["cells"].shape[0] if num_timesteps is None else num_timesteps
        starts = np.arange(T - n_step)
        device = topo.senders.device
        mesh_pos = torch.as_tensor(trajectory["mesh_pos"][0], device=device)
        node_type = torch.as_tensor(trajectory["node_type"][0], device=device)
        mask = self.loss_mask(node_type)[:, None]
        velocity, pressure = trajectory["velocity"], trajectory["pressure"]

        def window_losses(idx: np.ndarray) -> torch.Tensor:
            c = len(idx)
            static_frame = {
                "mesh_pos": mesh_pos.expand(c, *mesh_pos.shape),
                "node_type": node_type.expand(c, *node_type.shape),
            }
            carry = (torch.as_tensor(velocity[idx], device=device), torch.as_tensor(pressure[idx], device=device))
            losses = []
            for k in range(n_step + 1):
                frame = {**static_frame, "velocity": carry[0], "pressure": carry[1]}
                carry = self._step(state, topo, frame, mask, expansion, static)
                gt = torch.as_tensor(velocity[idx + k], device=device)
                losses.append((gt - carry[0]).square().mean(dim=(-2, -1)))
            return torch.stack(losses, dim=1)

        return self._n_step_chunked(window_losses, starts, self.n_step_chunk_size(len(starts)))

