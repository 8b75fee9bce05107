"""Encode-Process-Decode network.

Counterpart of ``hyper_graph_nets_tpu/nn/meshgraphnet.py``.  The JAX package
stacks the processor's block parameters on a leading axis and scans over
them; here the blocks are an ``nn.ModuleList`` run by a Python loop
(``convert.py`` unstacks the JAX layout).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from hyper_graph_nets_tpu_torch.core.graph import Graph
from hyper_graph_nets_tpu_torch.nn.blocks import GNNConfig, GraphNetBlock, block_apply
from hyper_graph_nets_tpu_torch.nn.mlp import MLP


class MeshGraphNet(nn.Module):
    def __init__(
        self,
        node_encoder: MLP,
        edge_encoders: Dict[str, MLP],
        blocks: Sequence[GraphNetBlock],
        decoder: MLP,
    ):
        super().__init__()
        self.node_encoder = node_encoder
        self.edge_encoders = nn.ModuleDict(edge_encoders)
        self.blocks = nn.ModuleList(blocks)
        self.decoder = decoder


def network_init(generator: torch.Generator, cfg: GNNConfig) -> MeshGraphNet:
    """Random init of encoder, processor blocks and decoder (on the CPU)."""
    L = cfg.latent_size
    widths = cfg.mlp_widths(L)
    node_encoder = MLP.init(generator, cfg.node_in_dim, widths)
    edge_dims = dict(cfg.edge_in_dims)
    edge_encoders = {
        name: MLP.init(generator, edge_dims[name], widths) for name in cfg.edge_sets
    }
    blocks = [
        GraphNetBlock.init(generator, cfg) for _ in range(cfg.message_passing_steps)
    ]
    decoder = MLP.init(
        generator, L, cfg.mlp_widths(cfg.output_size), layer_norm=False
    )
    return MeshGraphNet(node_encoder, edge_encoders, blocks, decoder)


def encoder_apply(net: MeshGraphNet, graph: Graph, cfg: GNNConfig) -> Graph:
    """Encode raw node/edge features into latents; edge sets without an
    encoder are dropped, as in the JAX package."""
    node_latents = net.node_encoder(graph.node_features, cfg.cd)
    new_sets = {
        name: es.replace(features=net.edge_encoders[name](es.features, cfg.cd))
        for name, es in graph.edge_sets.items()
        if name in net.edge_encoders
    }
    return graph.replace(node_features=node_latents, edge_sets=new_sets)


def processor_apply(net: MeshGraphNet, graph: Graph, cfg: GNNConfig) -> Graph:
    for block in net.blocks:
        graph = block_apply(block, graph, cfg)
    return graph


def decoder_apply(net: MeshGraphNet, graph: Graph, cfg: GNNConfig) -> torch.Tensor:
    return net.decoder(graph.node_features, cfg.cd).to(torch.float32)


def network_apply(net: MeshGraphNet, graph: Graph, cfg: GNNConfig) -> torch.Tensor:
    """Full forward: encode -> process -> decode per-node outputs."""
    latent = encoder_apply(net, graph, cfg)
    latent = processor_apply(net, latent, cfg)
    return decoder_apply(net, latent, cfg)


def network_activations(net: MeshGraphNet, graph: Graph, cfg: GNNConfig) -> dict:
    """Forward pass keeping per-block node latents (parity/debug tool):
    ``{'encoder': Graph, 'blocks': [node latents per block], 'output': decoded}``."""
    latent = encoder_apply(net, graph, cfg)
    enc = latent
    blocks = []
    for block in net.blocks:
        latent = block_apply(block, latent, cfg)
        blocks.append(latent.node_features)
    return {"encoder": enc, "blocks": blocks, "output": decoder_apply(net, latent, cfg)}
