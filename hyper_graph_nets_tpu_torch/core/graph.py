"""Graph containers: plain dataclasses of tensors.

Counterpart of ``hyper_graph_nets_tpu/core/graph.py``.  Feature tensors may
carry a leading batch dimension (``[B, N, F]`` / ``[B, E, F]``); topology
(senders, receivers, mask) is shared by the batch.  Edges keep the
receiver-sorted order of ``core.mesh.cells_to_edges``; the fused kernel's
segment plan rides on the edge set in place of the JAX package's band plan.
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
    receiver segment plan of the fused kernel (``ops.fused_block.SegmentPlan``),
    or None when the set does not take the fused path.
    """

    features: torch.Tensor  # [..., E, F]
    senders: torch.Tensor  # [E] int32
    receivers: torch.Tensor  # [E] int32
    mask: Optional[torch.Tensor] = None  # [E] float
    plan: Optional[object] = None

    def replace(self, **changes) -> "EdgeSet":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Mesh node features plus a name-keyed dict of edge sets."""

    node_features: torch.Tensor  # [..., N, F]
    edge_sets: Dict[str, EdgeSet]

    def replace(self, **changes) -> "Graph":
        return dataclasses.replace(self, **changes)
