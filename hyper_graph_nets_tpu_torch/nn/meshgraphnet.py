"""Encode-Process-Decode network.

Counterpart of ``hyper_graph_nets_tpu/nn/meshgraphnet.py``.  The JAX package
stacks the processor's block parameters on a leading axis and scans over
them; here the blocks are an ``nn.ModuleList`` run by a Python loop
(``convert.py`` unstacks the JAX layout); ``model.remat`` recomputes
each block in the backward (:func:`processor_apply`).  With remote message passing the
hyper tier has an encoder of its own (``hyper_node_model``) in the
hierarchical architectures, and in ``multi`` when its width differs from
the mesh nodes'; otherwise it shares the node encoder.  The decoder reads
the mesh rows only.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
        hyper_encoder: Optional[MLP] = None,
    ):
        super().__init__()
        self.node_encoder = node_encoder
        self.edge_encoders = nn.ModuleDict(edge_encoders)
        self.blocks = nn.ModuleList(blocks)
        self.decoder = decoder
        self.hyper_encoder = hyper_encoder


def network_init(generator: torch.Generator, cfg: GNNConfig) -> MeshGraphNet:
    """Random init of encoder, processor blocks and decoder (on the CPU)."""
    L = cfg.latent_size
    widths = cfg.mlp_widths(L)
    node_encoder = MLP.init(generator, cfg.node_in_dim, widths)
    edge_dims = dict(cfg.edge_in_dims)
    edge_encoders = {
        name: MLP.init(generator, edge_dims[name], widths) for name in cfg.edge_sets
    }
    hyper_encoder = None
    if cfg.hyper_in_dim is not None and (cfg.hierarchical or cfg.hyper_in_dim != cfg.node_in_dim):
        hyper_encoder = MLP.init(generator, cfg.hyper_in_dim, widths)
    blocks = [
        GraphNetBlock.init(generator, cfg) for _ in range(cfg.message_passing_steps)
    ]
    decoder = MLP.init(
        generator, L, cfg.mlp_widths(cfg.output_size), layer_norm=False
    )
    return MeshGraphNet(node_encoder, edge_encoders, blocks, decoder, hyper_encoder)


def encoder_apply(net: MeshGraphNet, graph: Graph, cfg: GNNConfig) -> Graph:
    """Encode raw node/edge features into latents; edge sets without an
    encoder are dropped, as in the JAX package."""
    node_latents = net.node_encoder(graph.node_features, cfg.cd)
    hyper_latents = None
    if graph.num_hyper_nodes > 0:
        encoder = net.hyper_encoder if net.hyper_encoder is not None else net.node_encoder
        hyper_latents = encoder(graph.hyper_features, cfg.cd)
    new_sets = {
        name: es.replace(features=net.edge_encoders[name](es.features, cfg.cd))
        for name, es in graph.edge_sets.items()
        if name in net.edge_encoders
    }
    return graph.replace(node_features=node_latents, hyper_features=hyper_latents, edge_sets=new_sets)


def processor_apply(net: MeshGraphNet, graph: Graph, cfg: GNNConfig) -> Graph:
    """The blocks in order.  With ``cfg.remat`` under autograd each block
    runs through ``torch.utils.checkpoint`` (the JAX package's
    ``jax.checkpoint`` of the scan body): its backward recomputes the
    block's forward, kernels included, from the block's input, so the
    results are those without it and only the memory held changes.
    Without autograd it changes nothing."""
    remat = cfg.remat and torch.is_grad_enabled()
    for block in net.blocks:
        if remat:
            graph = checkpoint(block_apply, block, graph, cfg, use_reentrant=False)
        else:
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
    ``{'encoder': Graph, 'blocks': [node latents per block], 'hyper_blocks':
    [hyper latents per block] or None, 'output': decoded}``."""
    latent = encoder_apply(net, graph, cfg)
    enc = latent
    blocks, hyper_blocks = [], []
    for block in net.blocks:
        latent = block_apply(block, latent, cfg)
        blocks.append(latent.node_features)
        hyper_blocks.append(latent.hyper_features)
    return {
        "encoder": enc,
        "blocks": blocks,
        "hyper_blocks": hyper_blocks if latent.hyper_features is not None else None,
        "output": decoder_apply(net, latent, cfg),
    }
