"""Graph containers: plain dataclasses of tensors.

Counterpart of ``hyper_graph_nets_tpu/core/graph.py``.  Feature tensors may
carry a leading batch dimension (``[B, N, F]`` / ``[B, E, F]``); topology
(senders, receivers, mask) is shared by the batch, except for an edge set
that forms anew in every frame (plate's world edges), whose topology is
``[B, W]``.  Edges keep the
receiver-sorted order of ``core.mesh.cells_to_edges``; a kernel's plan
(fused or sorted) rides on the edge set in place of the JAX package's band
plan.  Remote message passing adds a hyper tier of node features; edge
indices address the concatenated ``[mesh; hyper]`` rows.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional

import torch


class NodeType(enum.IntEnum):
    """Node type codes used by the DeepMind MeshGraphNets datasets."""

    NORMAL = 0
    OBSTACLE = 1
    AIRFOIL = 2
    HANDLE = 3
    INFLOW = 4
    OUTFLOW = 5
    WALL_BOUNDARY = 6
    SIZE = 9


@dataclasses.dataclass(frozen=True)
class EdgeSet:
    """One typed edge set.

    ``senders``/``receivers`` are int32 node indices; ``mask`` is 1.0 for
    valid edges and 0.0 for padding (None = all valid).  ``plan`` is the
    edge set's kernel plan: the fused kernel's receiver segment plan
    (``ops.fused_block.SegmentPlan``) under ``agg_vjp: fused``, the sorted
    pna kernel's (``ops.segment_pna.SortedPlan``) under ``agg_vjp: sorted``,
    or None.  ``gather_idx``/``gather_valid`` are the static ``[N, d_max]``
    neighbour-edge matrix of the receivers (``core.mesh.receivers_to_gather``)
    and ``snd_gather_*`` that of the senders: the ``agg_vjp: gather`` path
    aggregates and routes cotangents through them.  ``sums`` holds the
    fixed-order sums over the receivers and the senders
    (``core.segment_ops.EdgeSums``): the unfused paths' scatter sums and
    gather backwards run through them, in the same order on every run.  A
    set formed per frame has ``[B, E]`` senders, receivers and mask, no plan
    and no neighbour matrices, and per-frame sums
    (``EdgeSums.per_frame``).  ``ties`` is set on a set split over edge
    shards (``nn.blocks.edge_shard_ties``): how its aggregate routes a
    max/min cotangent to tied edges, as its one-device path would.
    """

    features: torch.Tensor  # [..., E, F]
    senders: torch.Tensor  # [E] int32, or [B, E] per frame
    receivers: torch.Tensor  # [E] int32, or [B, E] per frame
    mask: Optional[torch.Tensor] = None  # [E] (or [B, E]) float
    plan: Optional[object] = None
    gather_idx: Optional[torch.Tensor] = None  # [N, d_max] int32
    gather_valid: Optional[torch.Tensor] = None  # [N, d_max] float32
    snd_gather_idx: Optional[torch.Tensor] = None
    snd_gather_valid: Optional[torch.Tensor] = None
    sums: Optional[object] = None
    ties: Optional[str] = None  # 'full' or 'split' (core.segment_ops.ShardedAggregate)

    @property
    def num_edges(self) -> int:
        return self.senders.shape[-1]

    def replace(self, **changes) -> "EdgeSet":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Mesh node features, the hyper tier's (None without remote message
    passing) and a name-keyed dict of edge sets."""

    node_features: torch.Tensor  # [..., N, F]
    edge_sets: Dict[str, EdgeSet]
    hyper_features: Optional[torch.Tensor] = None  # [..., K, F]
    hyper_mask: Optional[torch.Tensor] = None  # [..., K] float, as the JAX Graph carries

    @property
    def num_nodes(self) -> int:
        return self.node_features.shape[-2]

    @property
    def num_hyper_nodes(self) -> int:
        return 0 if self.hyper_features is None else self.hyper_features.shape[-2]

    def replace(self, **changes) -> "Graph":
        return dataclasses.replace(self, **changes)


def concat_node_tiers(graph: Graph) -> torch.Tensor:
    """Mesh and hyper node features as one ``[..., N + K, F]`` tensor."""
    if graph.num_hyper_nodes == 0:
        return graph.node_features
    return torch.cat([graph.node_features, graph.hyper_features], dim=-2)
