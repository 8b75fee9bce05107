"""Cross-trajectory bucketing: meshes of different sizes padded to one capacity.

Counterpart of ``hyper_graph_nets_tpu/data/bucketing.py``.  The real
cylinder_flow, deforming_plate and flag_simple datasets have a different mesh
in every trajectory.  The JAX package pads all of them to one node capacity
(and one edge capacity) so that XLA compiles one step; the port pads them the
same way, because the padding is part of the results: the rollout and
n-step losses are means over every capacity row, so on a mesh of ``n`` nodes
under a capacity ``C`` they are the unpadded values times ``n / C``.

- node arrays pad with zeros and ``node_type = PAD_NODE_TYPE`` (-1), which
  no loss mask, node-type one-hot, world-edge query or normalizer counts;
- the topology is built from the unpadded cells with ``num_nodes = C``, so
  no edge touches a padded node, and its edge tail is padded with sender 0,
  receiver ``C - 1`` and mask 0, which keeps the edges sorted by receiver;
  every plan, neighbour matrix and fixed-order sum leaves the tail out
  (``models.base.SystemModel.topology_from_edges``);
- cells stay unpadded (the host reads them for the topology and the GIFs).

The bucket's band decision (:func:`bucket_plan_dims`) is the JAX package's,
made with the port's copy of its band criterion (``ops.reorder``): it picks
which meshes run the fused kernels and so the gradients at ties.  Its pinned
chunk, sub-window and window sizes are TPU grid sizes, accepted and ignored
here like ``model.fused_chunk``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core.mesh import cells_to_edges
from hyper_graph_nets_tpu_torch.ops import reorder

PAD_NODE_TYPE = -1
MAX_WINDOW = 2048  # the JAX band plan's widest window

_NODE_KEYS_EXCLUDED = ("cells",)


def _edges(trajectory: Dict[str, np.ndarray]):
    """The trajectory's receiver-sorted mesh edges (quad cells: deforming)."""
    return cells_to_edges(np.asarray(trajectory["cells"][0]))


def trajectory_capacity(trajectories: Iterable[Dict[str, np.ndarray]]) -> Tuple[int, int]:
    """(max nodes, max directed mesh edges) over the trajectories."""
    max_nodes = max_edges = 0
    for traj in trajectories:
        max_nodes = max(max_nodes, traj["node_type"].shape[1])
        max_edges = max(max_edges, len(_edges(traj).senders))
    return max_nodes, max_edges


def pad_trajectory(trajectory: Dict[str, np.ndarray], num_nodes: int) -> Dict[str, np.ndarray]:
    """Every per-node array padded to ``num_nodes`` rows: zeros, and
    ``PAD_NODE_TYPE`` in ``node_type``; the trajectory itself when it has
    ``num_nodes`` already."""
    n = trajectory["node_type"].shape[1]
    if n > num_nodes:
        raise ValueError(f"trajectory has {n} nodes > capacity {num_nodes}")
    if n == num_nodes:
        return trajectory
    out = {}
    for key, val in trajectory.items():
        if key in _NODE_KEYS_EXCLUDED:
            out[key] = val
            continue
        block = np.zeros((val.shape[0], num_nodes - n) + val.shape[2:], val.dtype)
        if "node_type" in key:
            block[:] = PAD_NODE_TYPE
        out[key] = np.concatenate([val, block], axis=1)
    return out


def bucket_plan_dims(
    model, trajectories: Iterable[Dict[str, np.ndarray]], num_nodes: int, num_edges: int
) -> Union[None, str, dict]:
    """The band decision of a whole bucket, as the JAX package makes it.

    None when the model is not on the fused path; ``"off"`` when some
    trajectory cannot be banded at the bucket's common chunk and sub-window
    split, or needs a window wider than ``MAX_WINDOW``: then every bucketed
    topology runs unfused; otherwise ``{"chunk", "sb", "force"}``, the JAX
    package's pinned plan dims, and every topology whose own numbering
    passes the criterion runs the fused kernels."""
    params = model.params["model"]
    if params.get("agg_vjp") != "fused":
        return None
    latent = getattr(model, "latent_size", 128)
    pb = int(params.get("fused_pb", 1))
    chunk = params.get("fused_chunk")
    edge_lists = [(e.senders, e.receivers) for e in map(_edges, trajectories)]
    if chunk is None:
        chunk = reorder.default_chunk()
        if chunk < 512 and all(
            reorder.upgrade_512_ok(s, r, num_nodes, latent_size=latent, pb=pb) for s, r in edge_lists
        ):
            chunk = 512
    # the common split: the smallest that minimizes the bucket's widest W
    best_sb, best_w = 1, None
    for cand in reorder._sb_candidates(chunk):
        dims = [reorder.plan_dims(s, r, chunk=chunk, sb=cand) for s, r in edge_lists]
        if any(d is None for d in dims):
            return "off"
        w = max(d["W"] for d in dims)
        if best_w is None or w < best_w:
            best_sb, best_w = cand, w
    dims = [reorder.plan_dims(s, r, chunk=chunk, sb=best_sb) for s, r in edge_lists]
    if any(d is None or d["W"] > MAX_WINDOW or d["WR"] > MAX_WINDOW for d in dims):
        return "off"
    nr = max(max(d["nr"] for d in dims), ((num_nodes - 1) // 16) * 16 + 128)
    force = (max(d["W"] for d in dims), max(d["WR"] for d in dims), max(d["steps"] for d in dims), nr, best_sb)
    return {"chunk": chunk, "sb": best_sb, "force": force}


def _banded(model, senders, receivers, plan_dims) -> Optional[bool]:
    """Whether a bucketed mesh runs the fused kernels: None (the model
    decides) off the fused path or without a bucket decision; False for an
    ``"off"`` bucket; with pinned dims, where the JAX package's per-mesh
    band plan exists and rebuilds at the bucket's chunk and split."""
    if plan_dims is None:
        return None
    if plan_dims == "off":
        return False
    chunk = model.params["model"].get("fused_chunk")
    if not reorder.check_banded(senders, receivers, chunk=chunk, max_window=MAX_WINDOW):
        return False
    d = reorder.plan_dims(senders, receivers, chunk=plan_dims["chunk"], sb=plan_dims["sb"])
    return d is not None and d["W"] <= MAX_WINDOW and d["WR"] <= MAX_WINDOW


def pad_topology(
    model,
    trajectory: Dict[str, np.ndarray],
    num_nodes: int,
    num_edges: int,
    plan_dims: Union[None, str, dict] = None,
    topo_extras: Optional[dict] = None,
    device="cpu",
):
    """The topology of a trajectory at the capacity ``(num_nodes,
    num_edges)`` on ``device``: the unpadded edges, then a masked tail
    (sender 0, receiver ``num_nodes - 1``) up to ``num_edges``; every
    bucketed topology carries a mask, all ones where nothing is padded.

    ``plan_dims`` is the bucket's band decision (:func:`bucket_plan_dims`;
    None: the mesh's own) and ``topo_extras`` the model's bucket dims
    (``bucket_topology_extras``: plate's obstacle capacity and its ``auto``
    world-capacity floor)."""
    edges = _edges(trajectory)
    e = len(edges.senders)
    if e > num_edges:
        raise ValueError(f"trajectory has {e} edges > capacity {num_edges}")
    pad = num_edges - e
    senders = np.concatenate([edges.senders, np.zeros(pad, np.int32)])
    receivers = np.concatenate([edges.receivers, np.full(pad, num_nodes - 1, np.int32)])
    mask = np.concatenate([np.ones(e, np.float32), np.zeros(pad, np.float32)])
    topo = model.topology_from_edges(
        senders, receivers, num_nodes, device=device, mask=mask,
        banded=_banded(model, edges.senders, edges.receivers, plan_dims),
    )
    aux, world_cap = model.pad_topology_aux(trajectory, num_nodes, topo_extras)
    if aux is not None:
        aux = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in aux.items()}
    return topo._replace(aux=aux, world_cap=world_cap)


class BucketedDataset:
    """Trajectories padded to their shared capacity."""

    def __init__(self, trajectories: List[Dict[str, np.ndarray]], model):
        self._model = model
        self.num_nodes, self.num_edges = trajectory_capacity(trajectories)
        self._trajectories = trajectories

    def __iter__(self):
        for traj in self._trajectories:
            yield pad_trajectory(traj, self.num_nodes)

    def topology(self, trajectory: Dict[str, np.ndarray], device="cpu"):
        return pad_topology(self._model, trajectory, self.num_nodes, self.num_edges, device=device)
