"""FlagModel: cloth simulation with 2nd-order integration.

Counterpart of ``hyper_graph_nets_tpu/models/flag.py``:

- node features: velocity (``world_pos - prev|world_pos``) ++ one-hot(type != NORMAL);
- mesh-edge features: ``[rel_world, |rel_world|, rel_mesh, |rel_mesh|]``;
- ``node_dynamic``: (max - min) of incident ``|rel_world|`` per receiver; its
  normalizer always accumulates (the reference's quirk, kept);
- output: acceleration, integrated as ``pos = 2*cur + acc - prev``;
- rollout: a Python loop in which boundary (non-NORMAL) nodes hold their
  positions; the n-step evaluation runs a chunk of sliding windows as one
  batch of frames;
- with ``graph_balancer`` set, a ``balance`` edge set featurized as mesh
  edges (``mesh_edge_features``), added by the expansion after
  ``make_graph``;
- with remote message passing, the three cluster-tier edge sets (or, with
  ``connector: multi``, mesh edges with 4 type tags and nodes with 2 tier
  tags) and the ``intra_edge``, ``inter_edge`` and ``hyper_node``
  normalizers; ``geometry`` gives the connector world and mesh positions.

Frames may carry a leading batch dimension; the featurizers index the node
axis (-2) and so run batched or not.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core import normalizer as norm
from hyper_graph_nets_tpu_torch.core import segment_ops
from hyper_graph_nets_tpu_torch.core.graph import Graph, NodeType
from hyper_graph_nets_tpu_torch.models.base import (
    ModelState,
    SystemModel,
    Topology,
    mesh_edge_set,
    norm_feature,
)


class FlagModel(SystemModel):
    model_type = "flag"
    world_dim = 3
    mesh_dim = 2

    def geometry(self, frames):
        return frames["world_pos"], frames["mesh_pos"]

    def node_in_dim(self) -> int:
        base = self.world_dim + 2  # velocity ++ one-hot(2)
        return base + 2 if self.architecture == "multi" else base

    def carry_to_frame(self, carry) -> Dict[str, torch.Tensor]:
        """Rollout carry ``(prev_pos, cur_pos)`` -> frame fields."""
        return {"prev|world_pos": carry[0], "world_pos": carry[1]}

    def edge_in_dims(self) -> Tuple[Tuple[str, int], ...]:
        mesh_edge_dim = self.world_dim + 1 + self.mesh_dim + 1
        if self.architecture == "multi":
            # the remote sets folded into mesh_edges with 4 one-hot tags
            return (("mesh_edges", mesh_edge_dim + 4),)
        dims = [("mesh_edges", mesh_edge_dim)]
        if self.use_balancer:
            dims.append(("balance", mesh_edge_dim))
        if self.use_rmp:
            for name in ("intra_cluster_to_cluster", "intra_cluster_to_mesh", "inter_cluster"):
                dims.append((name, mesh_edge_dim))
        return tuple(dims)

    def normalizer_schema(self) -> Dict[str, int]:
        mesh_edge_dim = self.world_dim + 1 + self.mesh_dim + 1
        schema = {
            "output": self.output_size,
            "node": self.world_dim + 2,  # raw width (multi's tier tags come later)
            "node_dynamic": 1,
            "mesh_edge": mesh_edge_dim,
        }
        if self.use_rmp:
            schema.update(intra_edge=mesh_edge_dim, inter_edge=mesh_edge_dim, hyper_node=3)
        return schema

    def mesh_edge_features(
        self, frames: Dict[str, torch.Tensor], senders: torch.Tensor, receivers: torch.Tensor
    ) -> torch.Tensor:
        """Mesh-edge features ``[..., E, 7]`` of any (sender, receiver) pairs
        (the balancer's edges)."""
        snd, rcv = senders.long(), receivers.long()
        world, mesh = frames["world_pos"], frames["mesh_pos"]
        rel_w = world[..., snd, :] - world[..., rcv, :]
        rel_m = mesh[..., snd, :] - mesh[..., rcv, :]
        return torch.cat([norm_feature(rel_w), norm_feature(rel_m)], dim=-1)

    # ------------------------------------------------------------------
    def frame_features(
        self,
        senders: torch.Tensor,
        receivers: torch.Tensor,
        frame: Dict[str, torch.Tensor],
        edge_mask: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Raw (unnormalized) features of one frame or a batch of frames."""
        world_pos = frame["world_pos"]
        num_nodes = world_pos.shape[-2]

        velocity = world_pos - frame["prev|world_pos"]
        type_flag = (frame["node_type"][..., 0] != NodeType.NORMAL).long()
        one_hot = torch.nn.functional.one_hot(type_flag, 2).to(world_pos.dtype)
        node_features = torch.cat([velocity, one_hot], dim=-1)

        edge_features = self.mesh_edge_features(frame, senders, receivers)
        speed = edge_features[..., self.world_dim : self.world_dim + 1]  # |rel_world|
        dyn_max = segment_ops.segment_max(speed, receivers, num_nodes, mask=edge_mask)
        dyn_min = segment_ops.segment_min(speed, receivers, num_nodes, mask=edge_mask)
        return {
            "node_features": node_features,
            "mesh_edge_features": edge_features,
            "node_dynamic": dyn_max - dyn_min,
        }

    def make_graph(
        self,
        state: ModelState,
        topo: Topology,
        frames: Dict[str, torch.Tensor],
        is_training: bool,
    ) -> Tuple[Graph, Dict[str, torch.Tensor], ModelState]:
        """Build the input graph; returns (graph, raw aux, new state)."""
        raw = self.frame_features(topo.senders, topo.receivers, frames, topo.mask)
        # padded nodes carry node_type < 0 and stay out of the statistics
        node_valid = (frames["node_type"][..., 0] >= 0).to(torch.float32)
        node_feats, state = self._normalize(
            state, "node", raw["node_features"], accumulate=is_training, mask=node_valid
        )
        edge_mask = None
        if topo.mask is not None:
            edge_mask = topo.mask.expand(raw["mesh_edge_features"].shape[:-1])
        edge_feats, state = self._normalize(
            state, "mesh_edge", raw["mesh_edge_features"],
            accumulate=is_training, mask=edge_mask,
        )
        # the node_dynamic normalizer always accumulates, as in the reference
        node_dyn, state = self._normalize(
            state, "node_dynamic", raw["node_dynamic"], accumulate=True, mask=node_valid
        )
        graph = Graph(
            node_features=node_feats,
            edge_sets={"mesh_edges": mesh_edge_set(topo, edge_feats)},
        )
        aux = {"node_dynamic": node_dyn, "mesh_edge_features_raw": raw["mesh_edge_features"]}
        return graph, aux, state

    def get_target(
        self, state: ModelState, frames: Dict[str, torch.Tensor], is_training: bool = True
    ) -> Tuple[torch.Tensor, ModelState]:
        """Normalized target acceleration."""
        acceleration = (
            frames["target|world_pos"] - 2 * frames["world_pos"] + frames["prev|world_pos"]
        )
        return self._normalize(state, "output", acceleration, accumulate=is_training)

    def update(
        self, state: ModelState, frames: Dict[str, torch.Tensor], net_out: torch.Tensor
    ) -> torch.Tensor:
        """Integrate: pos = 2*cur + acc - prev."""
        acceleration = norm.inverse(state.normalizers["output"], net_out)
        return 2 * frames["world_pos"] + acceleration - frames["prev|world_pos"]

    # ------------------------------------------------------------------
    def _step(self, state, topo, frame, normal, expansion, static) -> torch.Tensor:
        """The next positions of one frame or a batch of frames; boundary
        (non-NORMAL) nodes hold theirs."""
        prediction, _ = self.predict(state, topo, frame, expansion, static)
        return torch.where(normal, prediction, frame["world_pos"])

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
        """Recursive rollout from the first frame (or from ``start_carry``,
        a ``(prev_pos, cur_pos)`` pair); returns (traj_ops, per-step MSE),
        and the final carry with ``return_carry``, for the segmented
        rollouts of an expansion that resets mid-rollout.  With an
        ``expansion`` every step's graph is expanded (with ``static``, or
        the expansion's prepared one) after ``make_graph``."""
        T = trajectory["cells"].shape[0]
        num_steps = T if num_steps is None else min(num_steps, T)
        device = topo.senders.device
        init = {
            k: torch.as_tensor(v[0], device=device)
            for k, v in trajectory.items()
            if k != "cells"
        }
        static_frame = {"mesh_pos": init["mesh_pos"], "node_type": init["node_type"]}
        normal = (init["node_type"][:, 0] == NodeType.NORMAL)[:, None]
        prev_pos, cur_pos = init["prev|world_pos"], init["world_pos"]
        if start_carry is not None:
            prev_pos, cur_pos = start_carry
        preds = []
        for _ in range(num_steps):
            frame = {**static_frame, "world_pos": cur_pos, "prev|world_pos": prev_pos}
            preds.append(cur_pos)
            prev_pos, cur_pos = cur_pos, self._step(state, topo, frame, normal, expansion, static)
        pred = torch.stack(preds)
        gt = torch.as_tensor(trajectory["world_pos"][:num_steps], device=device)
        mse = (gt - pred).square().mean(dim=(-2, -1))
        traj_ops = {
            "faces": trajectory["cells"],
            "mesh_pos": trajectory["mesh_pos"],
            "gt_pos": trajectory["world_pos"],
            "pred_pos": pred,
        }
        if return_carry:
            return traj_ops, mse, (prev_pos, cur_pos)
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
        """Sliding-window n-step losses: every window starting at frame
        ``s < T - n_step`` rolls out ``n_step`` steps from frame ``s``, and
        its per-step MSE against frames ``s .. s + n_step`` is averaged.
        Returns (mean of the windows' mean losses, mean of their last-step
        losses).  A chunk of windows (``n_step_chunk_size``) runs as one
        batch of ``[chunk, N, ...]`` frames, so each block's kernel runs at
        B = chunk.  The JAX package also runs a forward after the last
        step, whose prediction nothing reads; this loop does not."""
        T = trajectory["cells"].shape[0] if num_timesteps is None else num_timesteps
        starts = np.arange(T - n_step)
        device = topo.senders.device
        mesh_pos = torch.as_tensor(trajectory["mesh_pos"][0], device=device)
        node_type = torch.as_tensor(trajectory["node_type"][0], device=device)
        normal = (node_type[:, 0] == NodeType.NORMAL)[:, None]
        world, prev = trajectory["world_pos"], trajectory["prev|world_pos"]

        def window_losses(idx: np.ndarray) -> torch.Tensor:
            c = len(idx)
            static_frame = {
                "mesh_pos": mesh_pos.expand(c, *mesh_pos.shape),
                "node_type": node_type.expand(c, *node_type.shape),
            }
            prev_pos = torch.as_tensor(prev[idx], device=device)
            cur_pos = torch.as_tensor(world[idx], device=device)
            gt = torch.as_tensor(np.stack([world[idx + k] for k in range(n_step + 1)]), device=device)
            losses = []
            for k in range(n_step + 1):
                losses.append((gt[k] - cur_pos).square().mean(dim=(-2, -1)))
                if k < n_step:
                    frame = {**static_frame, "world_pos": cur_pos, "prev|world_pos": prev_pos}
                    prev_pos, cur_pos = cur_pos, self._step(state, topo, frame, normal, expansion, static)
            return torch.stack(losses, dim=1)

        return self._n_step_chunked(window_losses, starts, self.n_step_chunk_size(len(starts)))
