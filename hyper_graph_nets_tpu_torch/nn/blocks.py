"""GraphNet message-passing blocks: the flat path.

Counterpart of ``hyper_graph_nets_tpu/nn/blocks.py`` for ``architecture:
none``:

- edge update ``e' = e + MLP([x[snd], x[rcv], e])`` with the first layer
  factored into sender, receiver and edge parts;
- node update ``x' = x + MLP([x, agg(e') per edge set])`` with pna
  concatenating ``[sum | mean | max | min]``.

``agg_vjp: fused`` routes an eligible edge set (pna, ``[3L -> L -> L -> L]``
+ LayerNorm, a segment plan) through the fused kernels
(``ops/fused_block.py``): K1 forward and, under autograd, K2 (``fused_bwd:
remat``) or K3 (``fused_bwd: stream``) backward; ``xla`` and ``gather`` take
the unfused path, which is the same forward math.  The hierarchical architectures and
``agg_vjp: sorted`` (kernel K4) belong to later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from hyper_graph_nets_tpu_torch.core.graph import EdgeSet, Graph
from hyper_graph_nets_tpu_torch.core.segment_ops import aggregate
from hyper_graph_nets_tpu_torch.nn.mlp import MLP, dense

CANONICAL_EDGE_ORDER: Tuple[str, ...] = (
    "mesh_edges",
    "world_edges",
    "balance",
    "intra_cluster_to_cluster",
    "intra_cluster_to_mesh",
    "inter_cluster",
    "inter_cluster_world",
)

AGG_PATHS = ("xla", "gather", "fused")
FUSED_BWD = ("remat", "stream")


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """Static network schema (shapes derive from this, not from data)."""

    output_size: int
    node_in_dim: int
    edge_in_dims: Tuple[Tuple[str, int], ...]  # (edge set name, raw feature dim)
    latent_size: int = 128
    num_layers: int = 2
    message_passing_steps: int = 5
    aggregation: str = "pna"
    architecture: str = "none"
    compute_dtype: Optional[str] = None  # e.g. 'bfloat16'
    agg_vjp: str = "xla"
    # backward of the fused path: 'remat' (K2 recomputes the forward chain)
    # or 'stream' (K1 saves a1/a2 and the LayerNorm statistics, K3 reads them)
    fused_bwd: str = "remat"

    def __post_init__(self):
        if self.agg_vjp == "sorted":
            raise NotImplementedError(
                "agg_vjp 'sorted' runs the sorted pna kernel (K4), which the "
                "port has not ported yet (ROADMAP slice 6); use 'fused' or 'xla'"
            )
        if self.agg_vjp not in AGG_PATHS:
            raise ValueError(f"agg_vjp must be one of {AGG_PATHS}, got {self.agg_vjp!r}")
        if self.fused_bwd not in FUSED_BWD:
            raise ValueError(
                f"fused_bwd must be 'remat' or 'stream', got {self.fused_bwd!r}"
            )
        if self.architecture != "none":
            raise NotImplementedError(
                f"architecture {self.architecture!r}: the port runs flat blocks "
                "only; RMP and the hierarchical blocks come in ROADMAP slice 5"
            )

    @property
    def edge_sets(self) -> Tuple[str, ...]:
        return tuple(
            n for n in CANONICAL_EDGE_ORDER if n in dict(self.edge_in_dims)
        )

    @property
    def naggs(self) -> int:
        return 4 if self.aggregation == "pna" else 1

    @property
    def cd(self) -> Optional[torch.dtype]:
        return None if self.compute_dtype is None else getattr(torch, self.compute_dtype)

    def mlp_widths(self, output_size: int) -> Tuple[int, ...]:
        return tuple([self.latent_size] * self.num_layers + [output_size])

    def node_update_in_dim(self, num_edge_sets: int) -> int:
        return self.latent_size * (1 + self.naggs * num_edge_sets)


class GraphNetBlock(nn.Module):
    """One flat message-passing block: an edge MLP per edge set and one node MLP."""

    def __init__(self, edge_models: Dict[str, MLP], node_model: MLP):
        super().__init__()
        self.edge_models = nn.ModuleDict(edge_models)
        self.node_model = node_model

    @classmethod
    def init(cls, generator: torch.Generator, cfg: GNNConfig) -> "GraphNetBlock":
        L = cfg.latent_size
        widths = cfg.mlp_widths(L)
        edge_models = {
            name: MLP.init(generator, 3 * L, widths) for name in cfg.edge_sets
        }
        node_model = MLP.init(
            generator, cfg.node_update_in_dim(len(cfg.edge_sets)), widths
        )
        return cls(edge_models, node_model)


def _first_layer_parts(eparams: MLP, L: int):
    """Rows of the first layer's ``[out, 2L + Fe]`` weight: sender, receiver, edge."""
    w1 = eparams.weights[0]
    return w1[:, :L], w1[:, L : 2 * L], w1[:, 2 * L :]


def _update_edge_features(
    eparams: MLP, all_nodes: torch.Tensor, es: EdgeSet, cfg: GNNConfig
) -> torch.Tensor:
    """Edge update ``e + MLP([x[snd], x[rcv], e])`` with a factored first layer:
    the sender and receiver parts are computed once per node and gathered."""
    L = all_nodes.shape[-1]
    ws, wr, we = _first_layer_parts(eparams, L)
    latent = ws.shape[0]
    node_part = dense(all_nodes, torch.cat([ws, wr], dim=0), cfg.cd)
    s_part, r_part = node_part[..., :latent], node_part[..., latent:]
    e_part = dense(es.features, we, cfg.cd)
    b1 = eparams.biases[0]
    if cfg.cd is not None:
        b1 = b1.to(cfg.cd)
    h = s_part[..., es.senders.long(), :] + r_part[..., es.receivers.long(), :]
    h = h + e_part + b1
    return es.features + eparams(h, cfg.cd, from_layer=1)


def _fused_mlp_shape_ok(eparams: MLP, es: EdgeSet, cfg: GNNConfig) -> bool:
    """The ``[3L -> L -> L -> L]`` + LayerNorm structure the kernel hard-codes."""
    L = cfg.latent_size
    w = eparams.weights
    return (
        eparams.num_layers == 3
        and eparams.layer_norm
        and tuple(w[0].shape) == (L, 3 * L)
        and tuple(w[1].shape) == (L, L)
        and tuple(w[2].shape) == (L, L)
        and es.features.shape[-1] == L
    )


def _fused_eligible(eparams: MLP, es: EdgeSet, cfg: GNNConfig) -> bool:
    return (
        cfg.agg_vjp == "fused"
        and cfg.aggregation == "pna"
        and es.plan is not None
        and _fused_mlp_shape_ok(eparams, es, cfg)
    )


def _fused_update_and_agg(
    eparams: MLP, all_nodes: torch.Tensor, es: EdgeSet, cfg: GNNConfig, num_total: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge update + pna aggregate in one fused call (single-device branch):
    K1 forward, and K2 or K3 backward as ``cfg.fused_bwd`` says."""
    from hyper_graph_nets_tpu_torch.ops.fused_block import fused_edge_block

    L = all_nodes.shape[-1]
    ws, wr, we = _first_layer_parts(eparams, L)
    # two products instead of one [2L]-wide one: each keeps its output
    # contiguous for the kernel, and each output column is the same dot
    sp = dense(all_nodes, ws, cfg.cd)
    rp = dense(all_nodes, wr, cfg.cd)
    feats = es.features if cfg.cd is None else es.features.to(cfg.cd)
    weights = {
        "we": we,
        "w2": eparams.weights[1],
        "w3": eparams.weights[2],
        "b1": eparams.biases[0],
        "b2": eparams.biases[1],
        "b3": eparams.biases[2],
        "lns": eparams.ln_scale,
        "lnb": eparams.ln_bias,
    }
    e2, agg = fused_edge_block(
        feats, sp, rp, weights, es.senders, es.receivers, es.mask, num_total,
        plan=es.plan, bwd=cfg.fused_bwd,
    )
    if cfg.cd is not None:
        agg = agg.to(cfg.cd)
    return e2, agg


def _aggregate_sets(
    edge_feats: Dict[str, torch.Tensor],
    graph: Graph,
    names: Sequence[str],
    num_total: int,
    cfg: GNNConfig,
    precomputed: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Concatenated per-set aggregates over node rows."""
    parts = []
    for name in names:
        if precomputed is not None and name in precomputed:
            parts.append(precomputed[name])
            continue
        es = graph.edge_sets[name]
        parts.append(
            aggregate(edge_feats[name], es.receivers, num_total, cfg.aggregation, es.mask)
        )
    return torch.cat(parts, dim=-1)


def _flat_apply_once(block: GraphNetBlock, graph: Graph, cfg: GNNConfig) -> Graph:
    names = tuple(n for n in cfg.edge_sets if n in graph.edge_sets)
    all_nodes = graph.node_features
    num_total = all_nodes.shape[-2]

    new_feats: Dict[str, torch.Tensor] = {}
    fused_aggs: Dict[str, torch.Tensor] = {}
    for name in names:
        es = graph.edge_sets[name]
        eparams = block.edge_models[name]
        if _fused_eligible(eparams, es, cfg):
            new_feats[name], fused_aggs[name] = _fused_update_and_agg(
                eparams, all_nodes, es, cfg, num_total
            )
        else:
            new_feats[name] = _update_edge_features(eparams, all_nodes, es, cfg)
    agg = _aggregate_sets(new_feats, graph, names, num_total, cfg, fused_aggs)
    features = torch.cat([all_nodes, agg], dim=-1)
    upd = block.node_model(features, cfg.cd)
    sets = dict(graph.edge_sets)
    for name, f in new_feats.items():
        sets[name] = sets[name].replace(features=f)
    return graph.replace(node_features=graph.node_features + upd, edge_sets=sets)


def block_apply(block: GraphNetBlock, graph: Graph, cfg: GNNConfig) -> Graph:
    # GNNConfig admits architecture 'none' only (flat blocks)
    return _flat_apply_once(block, graph, cfg)
