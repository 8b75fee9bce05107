"""Graph balancer: cached edge additions and removals, applied every step.

Counterpart of ``hyper_graph_nets_tpu/balancer/base.py``.  The algorithm
(Ricci SDRF, or random pairs) runs once per reset and its result is cached
as a :class:`BalancerStatic`; every step then

- appends a ``balance`` edge set whose features go through the mesh-edge
  normalizer (accumulating only in training), and
- removes the mesh edges the algorithm removed by zeroing their mask and
  their entries of the neighbour matrix, so that no aggregation path reaches
  them.  (The JAX package's ``fused`` path passes no mask to its kernel and
  keeps aggregating them; its ``sorted`` kernel takes masks only at the
  tail.  The port's contract on every path is the JAX ``gather`` and ``xla``
  result: ROADMAP section 3.)
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core.graph import EdgeSet, Graph
from hyper_graph_nets_tpu_torch.core.mesh import receivers_to_gather
from hyper_graph_nets_tpu_torch.core.segment_ops import EdgeSums


class BalancerStatic(NamedTuple):
    """The balance edges and the mesh edges' keep mask, as tensors, and
    the balance set's fixed-order sums."""

    bal_senders: torch.Tensor  # [Eb] int32, receiver-sorted, padding at the tail
    bal_receivers: torch.Tensor  # [Eb] int32
    bal_mask: torch.Tensor  # [Eb] float32
    bal_gather_idx: torch.Tensor  # [N, d] int32
    bal_gather_valid: torch.Tensor  # [N, d] float32
    mesh_keep: torch.Tensor  # [E] float32, 0 for removed mesh edges
    bal_sums: EdgeSums

    def to(self, device) -> "BalancerStatic":
        return BalancerStatic(*(t.to(device) for t in self))


def _round_pow2(n: int) -> int:
    p = 1
    while p < max(n, 1):
        p *= 2
    return p


def mesh_keep(senders, receivers, num_nodes: int, removed) -> np.ndarray:
    """``[E]`` float32: 0 for each mesh edge whose pair, in either
    direction, is in ``removed``; 1 elsewhere."""
    snd = np.asarray(senders, np.int64)
    rcv = np.asarray(receivers, np.int64)
    keep = np.ones(len(snd), np.float32)
    if removed is not None and len(removed["senders"]):
        rs = np.asarray(removed["senders"], np.int64)
        rr = np.asarray(removed["receivers"], np.int64)
        pairs = np.concatenate([rs * num_nodes + rr, rr * num_nodes + rs])
        keep[np.isin(snd * num_nodes + rcv, pairs)] = 0.0
    return keep


class GraphBalancer:
    """Caches one balancing until :meth:`reset_balancer`."""

    def __init__(self, algorithm, capacity: Optional[int] = None):
        self._algorithm = algorithm
        self._static: Optional[BalancerStatic] = None
        self._capacity = capacity

    def reset_balancer(self) -> None:
        self._static = None

    @property
    def static(self) -> Optional[BalancerStatic]:
        """The cached static (None before :meth:`prepare`)."""
        return self._static

    def prepare(self, model, frame: Dict[str, np.ndarray], topo) -> BalancerStatic:
        """Host: run the algorithm on the topology (unless cached) and build
        the static on the topology's device.  The added edges are padded to
        the capacity and sorted by receiver, with the padding at the tail."""
        if self._static is not None:
            return self._static
        added, removed = self._algorithm.run(topo)

        n_added = len(added["senders"])
        cap = max(self._capacity or _round_pow2(n_added), 1)
        take = min(n_added, cap)
        snd = np.zeros(cap, np.int32)
        rcv = np.zeros(cap, np.int32)
        mask = np.zeros(cap, np.float32)
        snd[:take] = added["senders"][:take]
        rcv[:take] = added["receivers"][:take]
        mask[:take] = 1.0
        order = np.argsort(rcv + (1 - mask) * topo.num_nodes, kind="stable")
        snd, rcv, mask = snd[order], rcv[order], mask[order]
        gidx, gval = receivers_to_gather(rcv, topo.num_nodes, mask=mask)
        d = _round_pow2(gidx.shape[1])
        gidx = np.pad(gidx, ((0, 0), (0, d - gidx.shape[1])))
        gval = np.pad(gval, ((0, 0), (0, d - gval.shape[1])))
        keep = mesh_keep(
            topo.senders.cpu().numpy(), topo.receivers.cpu().numpy(), topo.num_nodes, removed
        )
        device = topo.senders.device
        self._static = BalancerStatic(
            *(torch.from_numpy(a).to(device) for a in (snd, rcv, mask, gidx, gval, keep)),
            bal_sums=EdgeSums.build(snd, rcv, topo.num_nodes).to(device),
        )
        return self._static

    def expand(
        self,
        state,
        graph: Graph,
        frames,
        model,
        is_training: bool,
        static: Optional[BalancerStatic] = None,
    ):
        """Append the ``balance`` edge set and remove the removed mesh edges;
        returns ``(graph, state)`` with the mesh-edge normalizer's new state."""
        static = static if static is not None else self._static
        if static is None:
            raise RuntimeError("GraphBalancer.prepare() must run first")
        static = static.to(graph.node_features.device)

        snd, rcv, bmask = static.bal_senders, static.bal_receivers, static.bal_mask
        feats_raw = model.mesh_edge_features(frames, snd, rcv)
        # balance features go through the mesh-edge normalizer
        feats, state = model._normalize(
            state, "mesh_edge", feats_raw, accumulate=is_training,
            mask=bmask.expand(feats_raw.shape[:-1]),
        )
        edge_sets = dict(graph.edge_sets)
        edge_sets["balance"] = EdgeSet(
            features=feats * bmask[:, None],
            senders=snd,
            receivers=rcv,
            mask=bmask,
            gather_idx=static.bal_gather_idx,
            gather_valid=static.bal_gather_valid,
            sums=static.bal_sums,
        )

        keep = static.mesh_keep
        mesh = edge_sets["mesh_edges"]
        gv = mesh.gather_valid
        if gv is not None:
            gv = gv * keep[mesh.gather_idx.long()]
        edge_sets["mesh_edges"] = mesh.replace(
            mask=keep if mesh.mask is None else mesh.mask * keep,
            gather_valid=gv,
        )
        return graph.replace(edge_sets=edge_sets), state


class RandomGraphBalancer:
    """Adds (and removes) random node pairs (numpy, seeded 0)."""

    def __init__(self, params: dict):
        bal = params["model"]["graph_balancer"]
        self.edge_amount = bal.get("random", {}).get("edge_amount", 100)
        self.remove_edges = bal.get("remove_edges", True)
        self._rng = np.random.RandomState(0)

    def run(self, topo) -> Tuple[Dict[str, list], Optional[Dict[str, list]]]:
        n = topo.num_nodes
        replace = not n >= 2 * self.edge_amount
        pairs = self._rng.choice(n, size=(self.edge_amount, 2), replace=replace)
        added = {"senders": pairs[:, 0].tolist(), "receivers": pairs[:, 1].tolist()}
        if not self.remove_edges:
            return added, None
        rem = self._rng.choice(n, size=(self.edge_amount, 2), replace=replace)
        return added, {"senders": rem[:, 0].tolist(), "receivers": rem[:, 1].tolist()}


def get_balancer(config: dict) -> Optional[GraphBalancer]:
    """The configured balancer: None for ``algorithm: none``."""
    params = config.get("params", config)
    bal = params["model"].get("graph_balancer", {})
    name = bal.get("algorithm", "none")
    if name == "none":
        return None
    if name == "ricci":
        from hyper_graph_nets_tpu_torch.balancer.ricci import Ricci

        loops = bal.get("ricci", {}).get("loops", 150)
        return GraphBalancer(Ricci(params), capacity=_round_pow2(2 * loops))
    if name == "random":
        amount = bal.get("random", {}).get("edge_amount", 100)
        return GraphBalancer(RandomGraphBalancer(params), capacity=_round_pow2(amount))
    raise NotImplementedError(f"unknown balancer {name!r}")
