"""PlateModel: 3-D solid mechanics with a kinematic obstacle (deforming_plate).

Counterpart of ``hyper_graph_nets_tpu/models/plate.py``:

- quad cells -> mesh edges (``deform=True``); the obstacle's nodes belong to
  no cell, so they have no mesh edges;
- world edges, formed anew in every frame by a radius query (0.03) over the
  world positions from OBSTACLE senders to NORMAL receivers, featurized as
  ``[rel_world, |rel_world|]`` (4) and normalized over the valid ones;
- node types compacted 3 -> 2 before one-hot(3); node features: the one-hot
  ++ the obstacle's velocity (``target|world_pos - world_pos`` at OBSTACLE
  nodes, 0 elsewhere);
- output: velocity (3); ``pos = cur + velocity``;
- rollout and n-step: the kinematic (non-NORMAL) nodes follow
  ``target|world_pos``.

The world edges (:meth:`PlateModel._world_edges`) are built on the frames'
device with static shapes and no host sync: the ``[O, N]`` (or dense
``[N, N]``) radius test, each hit's slot from a cumulative count of the
hits in (obstacle, receiver) order, the first ``cap`` of them kept (as the
JAX package's ``lax.top_k`` keeps them; the rest are counted in
``world_truncated``), then a stable sort by receiver with invalid slots
last.  Their aggregate and their sender and receiver gathers' backwards
run in a fixed order (``core.segment_ops.FrameSum``), built per frame on
the device as well.  The capacity is ``model.max_world_edges``, or with
``auto`` a per-trajectory one from a numpy scan of the data (2x the most
hits of a frame, a power of two, at least 64); nothing recompiles here, but
a numeric capacity still truncates as the JAX package does.
"""
from __future__ import annotations

import hashlib
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core import normalizer as norm
from hyper_graph_nets_tpu_torch.core.graph import EdgeSet, Graph, NodeType
from hyper_graph_nets_tpu_torch.core.segment_ops import EdgeSums, frame_rows
from hyper_graph_nets_tpu_torch.models.base import (
    ModelState,
    SystemModel,
    Topology,
    mesh_edge_set,
    norm_feature,
    one_hot,
)

WORLD_EDGE_RADIUS = 0.03


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class PlateModel(SystemModel):
    model_type = "plate"
    world_dim = 3
    mesh_dim = 3

    def __init__(self, params: dict):
        super().__init__(params)
        raw = params["model"].get("max_world_edges", 1024)
        self.auto_world_edges = raw == "auto"
        self.max_world_edges = 1024 if self.auto_world_edges else int(raw)
        self._world_cap_cache: Dict[str, int] = {}

    def geometry(self, frames):
        return frames["world_pos"], frames["mesh_pos"]

    def carry_to_frame(self, carry) -> Dict[str, torch.Tensor]:
        return {"world_pos": carry}

    def mesh_edge_features(self, frames, senders: torch.Tensor, receivers: torch.Tensor) -> torch.Tensor:
        snd, rcv = senders.long(), receivers.long()
        world, mesh = frames["world_pos"], frames["mesh_pos"]
        rel_w = world[..., snd, :] - world[..., rcv, :]
        rel_m = mesh[..., snd, :] - mesh[..., rcv, :]
        return torch.cat([norm_feature(rel_w), norm_feature(rel_m)], dim=-1)

    def obstacle_mask_np(self, frame) -> np.ndarray:
        return _host(frame["node_type"])[:, 0] == NodeType.OBSTACLE

    def node_in_dim(self) -> int:
        base = 3 + 3  # one-hot(3) ++ obstacle velocity
        return base + 2 if self.architecture == "multi" else base

    def edge_in_dims(self) -> Tuple[Tuple[str, int], ...]:
        if self.architecture == "multi":
            return (("mesh_edges", 8 + 4), ("world_edges", 4))
        dims = [("mesh_edges", 8), ("world_edges", 4)]
        if self.use_balancer:
            dims.append(("balance", 8))
        if self.use_rmp:
            for name in ("intra_cluster_to_cluster", "intra_cluster_to_mesh", "inter_cluster"):
                dims.append((name, 8))
            if self.rmp_config.get("inter_cluster_world", False):
                dims.append(("inter_cluster_world", 4))
        return tuple(dims)

    def normalizer_schema(self) -> Dict[str, int]:
        schema = {
            "output": self.output_size,
            "node": 6,  # raw width (multi's tier tags come later)
            "node_dynamic": 1,
            "mesh_edge": 8,
            "world_edge": 4,
        }
        if self.use_rmp:
            schema.update(intra_edge=8, inter_edge=8, hyper_node=3)
        return schema

    # -- topology (host) ---------------------------------------------------
    def build_topology(self, cells, num_nodes=None, deform: bool = True, device="cpu") -> Topology:
        return super().build_topology(cells, num_nodes=num_nodes, deform=True, device=device)

    def topology_from_trajectory(self, trajectory, device="cpu") -> Topology:
        """The mesh topology with the obstacle indices (``aux``), so that the
        radius query computes ``[O, N]`` distances, and under ``auto`` the
        trajectory's world-edge capacity."""
        topo = super().topology_from_trajectory(trajectory, device=device)
        idx, valid = self._obstacle_aux(_host(trajectory["node_type"][0])[:, 0])
        aux = {
            "obstacle_idx": torch.from_numpy(idx).to(device),
            "obstacle_valid": torch.from_numpy(valid).to(device),
        }
        world_cap = self._cached_world_cap(trajectory) if self.auto_world_edges else None
        return topo._replace(aux=aux, world_cap=world_cap)

    def _cached_world_cap(self, trajectory) -> int:
        """The auto capacity, memoized by a SHA1 digest of the world
        positions (it is a function of them alone)."""
        w = np.ascontiguousarray(_host(trajectory["world_pos"]))
        h = hashlib.sha1(w.tobytes()).hexdigest()
        if h not in self._world_cap_cache:
            node_type = _host(trajectory["node_type"][0])[:, 0]
            obstacle = np.nonzero(node_type == NodeType.OBSTACLE)[0].astype(np.int32)
            self._world_cap_cache[h] = self._world_cap_from_trajectory(trajectory, obstacle, node_type)
        return self._world_cap_cache[h]

    def _world_cap_from_trajectory(self, trajectory, obstacle: np.ndarray, node_type: np.ndarray) -> int:
        """Host: 2x the most radius-query hits of a frame, rounded up to a
        power of two, at least 64 (at most obstacles x nodes)."""
        normal = node_type == NodeType.NORMAL
        world = _host(trajectory["world_pos"])
        if len(obstacle) == 0 or not normal.any():
            return 64
        obs = world[:, obstacle]
        nrm = world[:, normal]
        max_hits = 0
        for t in range(world.shape[0]):
            d2 = np.sum((obs[t][:, None, :] - nrm[t][None, :, :]) ** 2, axis=-1)
            max_hits = max(max_hits, int((d2 < WORLD_EDGE_RADIUS**2).sum()))
        cap = 64
        upper = len(obstacle) * int(node_type.shape[0])
        while cap < min(2 * max_hits, upper):
            cap *= 2
        return cap

    @staticmethod
    def _obstacle_aux(node_type: np.ndarray, cap: Optional[int] = None):
        """(obstacle_idx, obstacle_valid) padded to ``cap`` (the count's
        power of two when None)."""
        obstacle = np.nonzero(node_type == NodeType.OBSTACLE)[0].astype(np.int32)
        obs_cap = 1
        while obs_cap < max(len(obstacle), 1):
            obs_cap *= 2
        obs_cap = max(obs_cap, cap or 1)
        idx = np.zeros(obs_cap, np.int32)
        valid = np.zeros(obs_cap, np.float32)
        idx[: len(obstacle)] = obstacle
        valid[: len(obstacle)] = 1.0
        return idx, valid

    def bucket_topology_extras(self, trajectories) -> Optional[dict]:
        """One obstacle capacity for a bucket of trajectories (the power of
        two of the most obstacles) and, under ``auto``, a world-capacity
        floor (the largest auto capacity)."""
        obs_cap, world_floor = 1, 64
        for traj in trajectories:
            n_obs = int((_host(traj["node_type"][0])[:, 0] == NodeType.OBSTACLE).sum())
            while obs_cap < max(n_obs, 1):
                obs_cap *= 2
            if self.auto_world_edges:
                world_floor = max(world_floor, self._cached_world_cap(traj))
        return {"obstacle_cap": obs_cap, "world_floor": world_floor if self.auto_world_edges else None}

    def pad_topology_aux(self, trajectory, num_nodes: int, extras: Optional[dict]):
        """``(aux, world_cap)`` of a bucketed topology, as numpy."""
        extras = extras or {}
        idx, valid = self._obstacle_aux(_host(trajectory["node_type"][0])[:, 0], extras.get("obstacle_cap"))
        world_cap = None
        if self.auto_world_edges:
            world_cap = max(self._cached_world_cap(trajectory), extras.get("world_floor") or 64)
        return {"obstacle_idx": idx, "obstacle_valid": valid}, world_cap

    def topology_content_key(self, trajectory) -> tuple:
        """Under ``auto`` the topology's capacity is a function of the
        trajectory's motion: it joins the cache key."""
        return (self._cached_world_cap(trajectory),) if self.auto_world_edges else ()

    def world_edge_receiver_nodes(self, frame, topo) -> Optional[np.ndarray]:
        """Host: the NORMAL nodes within the world-edge radius of an obstacle
        node (the radius query's receivers)."""
        world_pos = _host(frame["world_pos"])
        codes = _host(frame["node_type"])[:, 0]
        obstacle = codes == NodeType.OBSTACLE
        normal = codes == NodeType.NORMAL
        if not obstacle.any() or not normal.any():
            return None
        d2 = np.sum((world_pos[obstacle][:, None, :] - world_pos[normal][None, :, :]) ** 2, axis=-1)
        hit = (d2 < WORLD_EDGE_RADIUS**2).any(axis=0)
        return np.nonzero(normal)[0][hit]

    # -- world edges (device) ------------------------------------------------
    def _world_edges(
        self,
        world_pos: torch.Tensor,
        node_type: torch.Tensor,
        senders: torch.Tensor,
        receivers: torch.Tensor,
        obstacle_idx: Optional[torch.Tensor] = None,
        obstacle_valid: Optional[torch.Tensor] = None,
        world_cap: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """World edges of one frame ``[N, 3]`` or a batch ``[..., N, 3]``:
        ``(senders, receivers, mask, truncated)``, the first three ``[..., k]``
        with ``k = min(cap, candidates)``, sorted by receiver with invalid
        slots (sender and receiver 0, mask 0) last, and ``truncated`` the
        hits past the capacity per frame.

        With ``obstacle_idx`` only the ``[O, N]`` block of obstacle senders
        is tested (the obstacle has no mesh edges, so no pair is a mesh
        edge); without it the dense ``[N, N]`` test drops self pairs and
        mesh-edge pairs.  The squared distance sums its three terms in
        order, as the JAX package's does."""
        cap = self.max_world_edges if world_cap is None else int(world_cap)
        lead = world_pos.shape[:-2]
        n = world_pos.shape[-2]
        pos = world_pos.reshape(-1, n, world_pos.shape[-1])
        codes = node_type[..., 0].expand(lead + (n,)).reshape(-1, n)
        B = pos.shape[0]
        normal = codes == NodeType.NORMAL
        # a Python scalar: compared in the positions' float32 (as JAX's weak
        # type is), with no host-to-device copy
        radius2 = WORLD_EDGE_RADIUS**2

        def d2(a, b):
            sq = (a - b).square()
            return sq[..., 0] + sq[..., 1] + sq[..., 2]

        if obstacle_idx is not None:
            obs = obstacle_idx.long()
            conn = d2(pos[:, obs, None, :], pos[:, None, :, :]) < radius2  # [B, O, N]
            conn = conn & (obstacle_valid > 0)[None, :, None] & normal[:, None, :]
            sender_of = lambda flat: obs[flat // n]
        else:
            conn = d2(pos[:, :, None, :], pos[:, None, :, :]) < radius2  # [B, N, N]
            conn = conn & ~torch.eye(n, dtype=torch.bool, device=pos.device)
            conn[:, senders.long(), receivers.long()] = False
            conn = conn & (codes == NodeType.OBSTACLE)[:, :, None] & normal[:, None, :]
            sender_of = lambda flat: flat // n
        flat = conn.reshape(B, -1)
        k = min(cap, flat.shape[-1])
        count = torch.cumsum(flat, dim=-1)  # hits up to and including each candidate
        hits = count[:, -1]
        # slot j holds the (j + 1)-th hit in (sender, receiver) order
        slots = torch.arange(1, k + 1, device=pos.device).expand(B, k).contiguous()
        chosen = torch.searchsorted(count, slots).clamp(max=flat.shape[-1] - 1)
        valid = slots <= hits[:, None]
        ws = torch.where(valid, sender_of(chosen), 0)
        wr = torch.where(valid, chosen % n, 0)
        order = torch.argsort(torch.where(valid, wr * n + ws, n * n), dim=-1, stable=True)
        ws, wr, valid = (torch.gather(t, 1, order) for t in (ws, wr, valid))
        truncated = torch.clamp(hits - k, min=0)
        shape = lead + (k,)
        return (
            ws.to(torch.int32).reshape(shape),
            wr.to(torch.int32).reshape(shape),
            valid.to(torch.float32).reshape(shape),
            truncated.reshape(lead),
        )

    def frame_features(self, topo: Topology, frame: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Raw (unnormalized) features and the world edges of one frame or a
        batch of frames."""
        world_pos, node_type = frame["world_pos"], frame["node_type"]
        codes = node_type[..., 0].long()
        codes = torch.where(codes == 3, 2, codes)
        obstacle = (node_type[..., 0] == NodeType.OBSTACLE)[..., None]
        velocities = torch.where(obstacle, frame["target|world_pos"] - world_pos, 0.0)
        node_features = torch.cat([one_hot(codes, 3, world_pos.dtype), velocities], dim=-1)

        aux = topo.aux or {}
        ws, wr, wmask, truncated = self._world_edges(
            world_pos, node_type, topo.senders, topo.receivers,
            aux.get("obstacle_idx"), aux.get("obstacle_valid"), world_cap=topo.world_cap,
        )
        w_rel = frame_rows(world_pos, ws.long()) - frame_rows(world_pos, wr.long())
        return {
            "node_features": node_features,
            "mesh_edge_features": self.mesh_edge_features(frame, topo.senders, topo.receivers),
            "world_edge_features": norm_feature(w_rel) * wmask[..., None],
            "world_senders": ws,
            "world_receivers": wr,
            "world_mask": wmask,
            "world_truncated": truncated,
        }

    def make_graph(
        self,
        state: ModelState,
        topo: Topology,
        frames: Dict[str, torch.Tensor],
        is_training: bool,
    ) -> Tuple[Graph, Dict[str, torch.Tensor], ModelState]:
        """Build the input graph; returns (graph, raw aux with the per-frame
        ``world_truncated`` count, new state)."""
        raw = self.frame_features(topo, frames)
        node_valid = (frames["node_type"][..., 0] >= 0).to(torch.float32)
        node_feats, state = self._normalize(
            state, "node", raw["node_features"], accumulate=is_training, mask=node_valid
        )
        edge_mask = None
        if topo.mask is not None:
            edge_mask = topo.mask.expand(raw["mesh_edge_features"].shape[:-1])
        mesh_feats, state = self._normalize(
            state, "mesh_edge", raw["mesh_edge_features"], accumulate=is_training, mask=edge_mask
        )
        wmask = raw["world_mask"]
        world_feats, state = self._normalize(
            state, "world_edge", raw["world_edge_features"], accumulate=is_training, mask=wmask
        )
        ws, wr = raw["world_senders"], raw["world_receivers"]
        graph = Graph(
            node_features=node_feats,
            edge_sets={
                "mesh_edges": mesh_edge_set(topo, mesh_feats),
                # formed anew every frame: no kernel plan, per-frame sums
                "world_edges": EdgeSet(
                    features=world_feats * wmask[..., None],
                    senders=ws,
                    receivers=wr,
                    mask=wmask,
                    sums=EdgeSums.per_frame(ws, wr, wmask, topo.num_nodes),
                ),
            },
        )
        aux = {
            "mesh_edge_features_raw": raw["mesh_edge_features"],
            "world_truncated": raw["world_truncated"],
        }
        return graph, aux, state

    def get_target(
        self, state: ModelState, frames: Dict[str, torch.Tensor], is_training: bool = True
    ) -> Tuple[torch.Tensor, ModelState]:
        """Normalized target velocity."""
        return self._normalize(
            state, "output", frames["target|world_pos"] - frames["world_pos"], accumulate=is_training
        )

    def update(self, state: ModelState, frames, net_out: torch.Tensor) -> torch.Tensor:
        return frames["world_pos"] + norm.inverse(state.normalizers["output"], net_out)

    # ------------------------------------------------------------------
    def _step(self, state, topo, frame, normal, expansion, static):
        """The next positions (kinematic nodes follow their targets) and the
        hits the capacity dropped."""
        prediction, aux = self.predict(state, topo, frame, expansion, static)
        return torch.where(normal, prediction, frame["target|world_pos"]), aux["world_truncated"].sum()

    def _count_truncated(self, truncated: torch.Tensor, topo: Topology, where: str) -> None:
        """Add the hits the capacity dropped to ``eval_metrics`` (one read
        back to the host per call) and warn when there were any."""
        count = int(truncated)
        self.eval_metrics["world_edge_truncated"] = self.eval_metrics.get("world_edge_truncated", 0) + count
        if count:
            warnings.warn(
                f"plate {where}: {count} radius-query hits were dropped by the world-edge "
                f"capacity ({topo.world_cap or self.max_world_edges}); an uncapped radius "
                "query keeps them. Raise model.max_world_edges or use 'auto'.",
                stacklevel=3,
            )

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
        """Recursive rollout from the first frame (or ``start_carry``, the
        positions); the kinematic nodes follow ``target|world_pos``.  As in
        the JAX package, step ``t`` records the positions after ``t + 1``
        steps and its MSE is taken against frame ``t``."""
        T = trajectory["cells"].shape[0]
        num_steps = T if num_steps is None else min(num_steps, T)
        device = topo.senders.device
        init = {k: torch.as_tensor(v[0], device=device) for k, v in trajectory.items() if k != "cells"}
        static_frame = {"mesh_pos": init["mesh_pos"], "node_type": init["node_type"]}
        normal = (init["node_type"][:, 0] == NodeType.NORMAL)[:, None]
        targets = torch.as_tensor(trajectory["target|world_pos"][:num_steps], device=device)
        cur = init["world_pos"] if start_carry is None else start_carry
        preds, truncated = [], torch.zeros((), dtype=torch.int64, device=device)
        for t in range(num_steps):
            frame = {**static_frame, "world_pos": cur, "target|world_pos": targets[t]}
            cur, dropped = self._step(state, topo, frame, normal, expansion, static)
            truncated = truncated + dropped
            preds.append(cur)
        pred = torch.stack(preds)
        gt = torch.as_tensor(trajectory["world_pos"][:num_steps], device=device)
        mse = (gt - pred).square().mean(dim=(-2, -1))
        self._count_truncated(truncated, topo, "rollout")
        traj_ops = {
            "faces": trajectory["cells"],
            "mesh_pos": trajectory["mesh_pos"],
            "mask": _host(trajectory["node_type"][0])[:, 0] == NodeType.OBSTACLE,
            "gt_pos": trajectory["world_pos"],
            "pred_pos": pred,
        }
        if return_carry:
            return traj_ops, mse, cur
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
        ``n_step + 1`` steps from frame ``s`` along the targets of frames
        ``s .. s + n_step``, and its step ``k`` is held against frame
        ``s + k``, as in the JAX package; the dropped hits go to
        ``eval_metrics``."""
        T = trajectory["cells"].shape[0] if num_timesteps is None else num_timesteps
        starts = np.arange(T - n_step)
        device = topo.senders.device
        mesh_pos = torch.as_tensor(trajectory["mesh_pos"][0], device=device)
        node_type = torch.as_tensor(trajectory["node_type"][0], device=device)
        normal = (node_type[:, 0] == NodeType.NORMAL)[:, None]
        world, target = trajectory["world_pos"], trajectory["target|world_pos"]
        truncated = [torch.zeros((), dtype=torch.int64, device=device)]

        def window_losses(idx: np.ndarray) -> torch.Tensor:
            c = len(idx)
            static_frame = {
                "mesh_pos": mesh_pos.expand(c, *mesh_pos.shape),
                "node_type": node_type.expand(c, *node_type.shape),
            }
            cur = torch.as_tensor(world[idx], device=device)
            losses = []
            for k in range(n_step + 1):
                frame = {**static_frame, "world_pos": cur,
                         "target|world_pos": torch.as_tensor(target[idx + k], device=device)}
                cur, dropped = self._step(state, topo, frame, normal, expansion, static)
                truncated[0] = truncated[0] + dropped
                gt = torch.as_tensor(world[idx + k], device=device)
                losses.append((gt - cur).square().mean(dim=(-2, -1)))
            return torch.stack(losses, dim=1)

        out = self._n_step_chunked(window_losses, starts, self.n_step_chunk_size(len(starts)))
        self._count_truncated(truncated[0], topo, "n-step evaluation")
        return out
