"""Training-side helpers; this slice of the port has the batched forward only.

Counterpart of ``batched_forward`` in ``hyper_graph_nets_tpu/training/trainer.py``:
the JAX package vmaps the network over frames that share one topology;
here the batch dimension is written out, and every layer of the network
takes ``[B, N, F]`` / ``[B, E, F]`` features directly.
"""
from __future__ import annotations

import torch

from hyper_graph_nets_tpu_torch.core.graph import Graph
from hyper_graph_nets_tpu_torch.models.base import SystemModel
from hyper_graph_nets_tpu_torch.nn.meshgraphnet import MeshGraphNet, network_apply


def batched_forward(model: SystemModel, params: MeshGraphNet, graph: Graph) -> torch.Tensor:
    """Network outputs ``[B, N, output_size]`` for a batched graph."""
    return network_apply(params, graph, model.gnn_config)
