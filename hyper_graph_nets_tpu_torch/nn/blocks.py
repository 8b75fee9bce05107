"""GraphNet message-passing blocks: flat and hierarchical.

Counterpart of ``hyper_graph_nets_tpu/nn/blocks.py``:

- edge update ``e' = e + MLP([x[snd], x[rcv], e])`` with the first layer
  factored into sender, receiver and edge parts, always from the
  block-input edge features;
- node update ``x' = x + MLP([x, agg(e') per edge set])`` with pna
  concatenating ``[sum | mean | max | min]``;
- ``architecture``: ``none`` (flat), ``multi`` (flat over the merged
  multigraph, mesh rows updated), ``hetero`` (flat, with a node model of
  its own for the hyper rows), ``repeated`` (the flat block twice), and the
  hierarchical ``hyper`` and ``multiscale``: the ordered sub-steps mesh ->
  up -> cross (3 rounds for multiscale, each with its own hyper model) ->
  down (-> mesh again for multiscale), each sub-step's node update seeing
  the node state its predecessors left and aggregating into its own tier's
  rows only.

``agg_vjp`` picks how an edge set is updated and aggregated, as in the JAX
package (same forward math on every path):

- ``fused``: an eligible set (pna, ``[3L -> L -> L -> L]`` + LayerNorm, a
  segment plan) runs the fused kernels (``ops/fused_block.py``): K1 forward
  and, under autograd, K2 (``fused_bwd: remat``) or K3 (``stream``)
  backward; other sets take the ``xla`` form.  With ``fused_fwd: xla`` a
  set that also has a neighbour matrix passing ``_gather_dense_ok`` takes
  the JAX package's hybrid instead (``ops.fused_block.
  fused_edge_block_hybrid``: the unfused forward and the pna over the
  matrix, no kernel, then K2 with a tie tolerance), on one device only.  In a hierarchical block the
  mesh set's plan covers all ``N + K`` rows (``rmp.connector``), so its
  aggregate is computed over every row and cut to the mesh window.
- ``sorted``: the unfused edge update, and the pna of the sets in
  ``SORTED_EDGE_SETS`` through the sorted pna kernels
  (``ops/segment_pna.py``: K4f forward, K4b backward) while one row of
  float32 edge features fits ``MAX_EDGE_BLOCK_BYTES``; otherwise the
  ``gather`` form's aggregate (or scatter without a neighbour matrix).
- ``gather``: the sender and receiver gathers and pna over the static
  neighbour matrices with gather-only backwards (``core.segment_ops.
  gather_rows``, ``pna_gather``): tied edges get the full max/min cotangent.
- ``xla``: the unfused update and the aggregate over the neighbour matrix
  (``gather_aggregate``, or scatter without one), differentiated by
  autograd (tied edges split the max/min cotangent, as the VJP of JAX's
  max does).

An edge set without a kernel plan (the graph balancer's ``balance`` set,
the cluster-tier sets, a mesh that the band criterion rejects) takes the
unfused update and the aggregate above.  Its scatter sums and the backward
of its index gathers run through the set's fixed-order sums
(``EdgeSet.sums``, ``core.segment_ops.FixedSum``), so a train step is the
same bit for bit on every run.  A set that forms anew in every frame
(plate's world edges, ``[B, W]`` senders, receivers and mask) takes the same
path with per-frame gathers and sums (``core.segment_ops.FrameSum``, built
on the frames' device).

Under the halo forward (``parallel/halo.py``) and the sharded train step
(``parallel/sharding.py``) ``GNNConfig.axis_name`` holds the rank group the
edges are split over, and each rank runs the blocks on its (data rank's
frames and) graph rank's edge shard with every node row: a ``fused`` set
runs ``ops.fused_block.fused_edge_block_spmd`` (K1 unfinalized and the
group's plain all-reduce along ``graph``, or, with ``halo_overlap`` and a
plan that carries bands, K7; under autograd one node per data row whose
backward runs K2 on every shard); a ``sorted`` set that K4f takes joins
its data row's shards and runs K4f once on them, and under autograd K4b
once in one node per data row (``ops.segment_pna.pna_sorted_sharded``:
the JAX package's sorted kernel is not edge-partitioned, GSPMD gathers its
operands); every other set aggregates its local
partials and combines them across the ranks
(``core.segment_ops.sharded_aggregate``: the plain all-reduce, under
autograd one node per data row whose backward routes the max/min
cotangents by the set's one-device tie rule, ``edge_shard_ties``; or, in the
halo forward with ``halo_ring``, K6 through ``collective_aggregate``, the
sorted sets' too).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from hyper_graph_nets_tpu_torch.core.graph import EdgeSet, Graph, concat_node_tiers
from hyper_graph_nets_tpu_torch.core.segment_ops import (
    aggregate,
    collective_aggregate,
    gather_aggregate,
    gather_fixed,
    gather_rows,
    pna_gather,
    sharded_aggregate,
)
from hyper_graph_nets_tpu_torch.nn.mlp import MLP, dense
from hyper_graph_nets_tpu_torch.nn import quant
from hyper_graph_nets_tpu_torch.ops.segment_pna import (
    MAX_EDGE_BLOCK_BYTES,
    SortedPlan,
    pna_sorted,
    pna_sorted_sharded,
)

CANONICAL_EDGE_ORDER: Tuple[str, ...] = (
    "mesh_edges",
    "world_edges",
    "balance",
    "intra_cluster_to_cluster",
    "intra_cluster_to_mesh",
    "inter_cluster",
    "inter_cluster_world",
)

MESH_TIER_SETS = ("mesh_edges", "world_edges", "balance")
UP_SETS = ("intra_cluster_to_cluster",)
CROSS_SETS = ("inter_cluster", "inter_cluster_world")
DOWN_SETS = ("intra_cluster_to_mesh",)

HIERARCHICAL_ARCHITECTURES = ("hyper", "multiscale", "hetero")
ARCHITECTURES = ("none", "hyper", "multiscale", "hetero", "multi", "repeated")
MULTISCALE_ROUNDS = 3
REPEATED_ROUNDS = 2  # flat block applications per step of 'repeated'

AGG_PATHS = ("xla", "gather", "sorted", "fused")
FUSED_BWD = ("remat", "stream")
# edge sets whose valid edges are non-decreasing in receiver (masked ones
# anywhere): the ones agg_vjp 'sorted' aggregates by kernel (the JAX
# package's GNNConfig.sorted_edge_sets default)
SORTED_EDGE_SETS = ("mesh_edges",)


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
    architecture: str = "none"  # one of ARCHITECTURES
    hyper_in_dim: Optional[int] = None
    compute_dtype: Optional[str] = None  # e.g. 'bfloat16'
    agg_vjp: str = "xla"
    # backward of the fused path: 'remat' (K2 recomputes the forward chain)
    # or 'stream' (K1 saves a1/a2 and the LayerNorm statistics, K3 reads them)
    fused_bwd: str = "remat"
    # forward of the fused path: 'kernel' (K1), or 'xla', the JAX package's
    # hybrid (an unfused forward, then K2 with a tie tolerance) on a set with
    # a dense enough neighbour matrix, on one device.  Any other value runs
    # as 'kernel', as in the JAX package.
    fused_fwd: str = "kernel"
    # the JAX package's TPU grid amortization (config model.fused_pb,
    # fused_pb_bwd): the same results whatever their values; read only to
    # warn where a branch ignores them, as the JAX package warns
    fused_pb: int = 1
    fused_pb_bwd: int = 1
    # config model.remat: under autograd each processor block is
    # recomputed in the backward (nn.meshgraphnet.processor_apply) instead
    # of keeping its activations; the same results, less memory
    remat: bool = False
    # set by the halo forward (parallel/halo.py) and the sharded train step
    # and forward (parallel/sharding.py): the rank group
    # (parallel.group.RankGroup) whose 'graph' ranks each hold an edge
    # shard; the aggregations combine the ranks' partials along 'graph' (the
    # JAX package's axis_name with halo_mesh_axes, and its spmd_mesh with
    # spmd_axis 'graph': the group knows its axes)
    axis_name: Optional[object] = None
    # with axis_name: combine the partials of unfused sets through K6 (the
    # ring all-reduce) instead of the plain all-reduce
    halo_ring: bool = False
    # with axis_name and a fused set whose plan carries overlap bands: K7,
    # the fused block and the banded ring in one kernel
    halo_overlap: bool = False

    def __post_init__(self):
        if self.agg_vjp not in AGG_PATHS:
            raise ValueError(f"agg_vjp must be one of {AGG_PATHS}, got {self.agg_vjp!r}")
        if self.fused_bwd not in FUSED_BWD:
            raise ValueError(
                f"fused_bwd must be 'remat' or 'stream', got {self.fused_bwd!r}"
            )
        if self.architecture not in ARCHITECTURES:
            raise ValueError(f"architecture must be one of {ARCHITECTURES}, got {self.architecture!r}")

    @property
    def hierarchical(self) -> bool:
        return self.architecture in HIERARCHICAL_ARCHITECTURES

    def subset(self, names: Sequence[str]) -> Tuple[str, ...]:
        """The registered edge sets among ``names``, in ``names``' order."""
        registered = set(self.edge_sets)
        return tuple(n for n in names if n in registered)

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
    """One message-passing block: an edge MLP per edge set, the mesh node
    model (the JAX package's ``node_model_cross``) and the node models of
    the hierarchical architectures: ``hyper_node_model_up`` and
    ``node_model_down`` (hyper, multiscale), ``hyper_node_model_cross``
    (hyper, hetero) and ``hyper_node_models_cross`` (multiscale, one per
    cross round)."""

    def __init__(
        self,
        edge_models: Dict[str, MLP],
        node_model: MLP,
        hyper_node_model_up: Optional[MLP] = None,
        node_model_down: Optional[MLP] = None,
        hyper_node_model_cross: Optional[MLP] = None,
        hyper_node_models_cross: Optional[Sequence[MLP]] = None,
    ):
        super().__init__()
        self.edge_models = nn.ModuleDict(edge_models)
        self.node_model = node_model
        self.hyper_node_model_up = hyper_node_model_up
        self.node_model_down = node_model_down
        self.hyper_node_model_cross = hyper_node_model_cross
        self.hyper_node_models_cross = (
            None if hyper_node_models_cross is None else nn.ModuleList(hyper_node_models_cross)
        )

    @classmethod
    def init(cls, generator: torch.Generator, cfg: GNNConfig) -> "GraphNetBlock":
        L = cfg.latent_size
        widths = cfg.mlp_widths(L)
        mlp = lambda sets: MLP.init(generator, cfg.node_update_in_dim(len(sets)), widths)
        edge_models = {
            name: MLP.init(generator, 3 * L, widths) for name in cfg.edge_sets
        }
        arch = cfg.architecture
        if arch in ("hyper", "multiscale"):
            cross_sets = cfg.subset(CROSS_SETS)
            return cls(
                edge_models,
                mlp(cfg.subset(MESH_TIER_SETS)),
                hyper_node_model_up=mlp(cfg.subset(UP_SETS)),
                node_model_down=mlp(cfg.subset(DOWN_SETS)),
                hyper_node_model_cross=mlp(cross_sets) if arch == "hyper" else None,
                hyper_node_models_cross=(
                    [mlp(cross_sets) for _ in range(MULTISCALE_ROUNDS)] if arch == "multiscale" else None
                ),
            )
        # flat, hetero, multi, repeated: one node model over every edge set
        node_model = mlp(cfg.edge_sets)
        hyper_cross = mlp(cfg.edge_sets) if arch == "hetero" else None
        return cls(edge_models, node_model, hyper_node_model_cross=hyper_cross)


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
    if eparams.quantized:
        # int8 inference: the row split keeps the whole first layer's
        # per-channel scales; activations are quantized per node row (over L)
        # and per edge row (over the edge features), as in the JAX package
        scale = eparams.wscales[0]
        node_part = quant.dense_int8(all_nodes, torch.cat([ws, wr], dim=0), torch.cat([scale, scale]))
        e_part = quant.dense_int8(es.features, we, scale)
    else:
        node_part = dense(all_nodes, torch.cat([ws, wr], dim=0), cfg.cd)
        e_part = dense(es.features, we, cfg.cd)
    s_part, r_part = node_part[..., :latent], node_part[..., latent:]
    b1 = eparams.biases[0]
    if cfg.cd is not None:
        b1 = b1.to(cfg.cd)
    if (
        cfg.agg_vjp == "gather"
        and es.gather_idx is not None
        and es.snd_gather_idx is not None
        and _gather_dense_ok(es)
        and _gather_dense_ok(es, es.snd_gather_idx)
    ):
        # gather-only backward through the static inverse incidences
        s_rows = gather_rows(s_part, es.senders, es.snd_gather_idx, es.snd_gather_valid)
        r_rows = gather_rows(r_part, es.receivers, es.gather_idx, es.gather_valid)
    elif es.sums is not None:
        # backward: fixed-order sums of the edges' cotangents per node row
        s_rows = gather_fixed(s_part, es.sums.senders)
        r_rows = gather_fixed(r_part, es.sums.receivers)
    else:
        s_rows = s_part[..., es.senders.long(), :]
        r_rows = r_part[..., es.receivers.long(), :]
    h = s_rows + r_rows
    h = h + e_part + b1
    return es.features + eparams(h, cfg.cd, from_layer=1)


def _gather_dense_ok(es: EdgeSet, idx: Optional[torch.Tensor] = None) -> bool:
    """The JAX package's gate on the ``[rows, d_max]`` neighbour matrix: at
    most 4x padding over the edge count (skewed degrees fall back to
    scatter)."""
    rows, d_max = (es.gather_idx if idx is None else idx).shape[-2:]
    return rows * d_max <= 4 * es.num_edges


def _fused_mlp_shape_ok(eparams: MLP, es: EdgeSet, cfg: GNNConfig) -> bool:
    """The ``[3L -> L -> L -> L]`` + LayerNorm float structure the kernel
    hard-codes (an int8 edge model stays unfused, as in the JAX package)."""
    L = cfg.latent_size
    w = eparams.weights
    return (
        not eparams.quantized
        and eparams.num_layers == 3
        and eparams.layer_norm
        and tuple(w[0].shape) == (L, 3 * L)
        and tuple(w[1].shape) == (L, L)
        and tuple(w[2].shape) == (L, L)
        and es.features.shape[-1] == L
    )


def _fused_eligible(eparams: MLP, es: EdgeSet, cfg: GNNConfig) -> bool:
    """The fused path, on one device or on a rank's edge shard
    (``cfg.axis_name``)."""
    return (
        cfg.agg_vjp == "fused"
        and cfg.aggregation == "pna"
        and es.plan is not None
        and _fused_mlp_shape_ok(eparams, es, cfg)
    )


def _takes_hybrid(es: EdgeSet, cfg: GNNConfig) -> bool:
    """Whether a fused set takes the hybrid (the JAX package's
    ``_fused_update_and_agg`` branch order, ``nn/blocks.py:369-412``): one
    device (the sharded step and the halo forward ignore ``fused_fwd``),
    ``fused_fwd: xla`` and a 2-D neighbour matrix that passes
    ``_gather_dense_ok``."""
    return (
        cfg.axis_name is None
        and cfg.fused_fwd == "xla"
        and es.gather_idx is not None
        and es.gather_idx.dim() == 2
        and _gather_dense_ok(es)
    )


def _fused_update_and_agg(
    eparams: MLP, all_nodes: torch.Tensor, es: EdgeSet, cfg: GNNConfig, num_total: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge update + pna aggregate in one fused call: on one device K1
    forward, and K2 or K3 backward as ``cfg.fused_bwd`` says, or the hybrid
    (:func:`_takes_hybrid`: the unfused forward, K2 with a tie tolerance);
    on a rank's edge shard (``cfg.axis_name``) K1 unfinalized with the
    plain all-reduce, or K7 (``cfg.halo_overlap``), and K2 backward at the
    global degree."""
    from hyper_graph_nets_tpu_torch.ops.fused_block import (
        fused_edge_block,
        fused_edge_block_hybrid,
        fused_edge_block_spmd,
    )

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
    topology = (es.senders, es.receivers, es.mask, num_total)
    if (cfg.fused_bwd != "remat" or cfg.fused_pb > 1 or cfg.fused_pb_bwd > 1) and (
        cfg.axis_name is not None or cfg.fused_fwd == "xla"
    ):
        warnings.warn(
            "fused_bwd/fused_pb/fused_pb_bwd apply only to the single-device full-kernel path; the "
            "spmd/collective/hybrid branch selected here ignores them (remat backward, pb=1).",
            stacklevel=2,
        )
    if _takes_hybrid(es, cfg):
        e2, agg = fused_edge_block_hybrid(
            feats, sp, rp, weights, *topology, es.gather_idx, es.gather_valid, plan=es.plan
        )
    elif cfg.axis_name is None:
        e2, agg = fused_edge_block(feats, sp, rp, weights, *topology, plan=es.plan, bwd=cfg.fused_bwd)
    else:
        e2, agg = fused_edge_block_spmd(
            feats, sp, rp, weights, *topology, es.plan, cfg.axis_name, overlap=cfg.halo_overlap
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
    rows: Optional[int] = None,
) -> torch.Tensor:
    """Concatenated per-set aggregates over node rows, dispatched as the JAX
    package's ``_aggregate_sets`` (``nn/blocks.py:465-583``): a set with a
    neighbour matrix that passes ``_gather_dense_ok`` aggregates over it on
    every path (the fused sets come precomputed), the rest by scatter, in
    the set's fixed order when it carries ``sums``.  Masked edges (padding,
    or mesh edges the balancer removed, whose neighbour-matrix entries it
    also zeroes) reach no aggregate on any path.

    ``rows`` aggregates into the first ``rows`` node rows only (the JAX
    package's ``window=(0, rows)``): a hierarchical block's mesh sub-steps,
    whose sets' receivers are all mesh rows.
    """
    hi = num_total if rows is None else rows
    parts = []
    for name in names:
        if precomputed is not None and name in precomputed:
            parts.append(precomputed[name][..., :hi, :])
            continue
        es = graph.edge_sets[name]
        f = edge_feats[name]
        if cfg.axis_name is not None:
            if not cfg.halo_ring and _sorted_kernel_takes(
                    name, f.shape[-2] * cfg.axis_name.shape["graph"], f.shape[-1], cfg):
                # K4f on the data row's shards joined, and K4b under autograd
                plan = es.plan if isinstance(es.plan, SortedPlan) else None
                parts.append(pna_sorted_sharded(f, es.receivers, es.mask, hi, plan, cfg.axis_name))
                continue
            # an edge shard: local partials combined across the rank group
            sums = None if es.sums is None else es.sums.receivers
            if cfg.halo_ring:  # K6, the halo forward's ring: no backward
                if torch.is_grad_enabled() and f.requires_grad:
                    raise NotImplementedError(f"{name}: the ring all-reduce (halo_ring) has no backward")
                agg = collective_aggregate(f, es.receivers, num_total, cfg.aggregation, es.mask,
                                           cfg.axis_name, ring=True, sums=sums)
            else:
                agg = sharded_aggregate(f, es.receivers, num_total, cfg.aggregation, es.mask,
                                        cfg.axis_name, sums=sums, ties=es.ties or "split")
            parts.append(agg[..., :hi, :])
            continue
        if _sorted_kernel_takes(name, f.shape[-2], f.shape[-1], cfg):
            # K4f, and K4b under autograd
            parts.append(pna_sorted(f, es.receivers, es.mask, hi, plan=es.plan))
            continue
        if es.gather_idx is not None and _gather_dense_ok(es):
            gidx, gval = es.gather_idx[:hi], es.gather_valid[:hi]
            if cfg.agg_vjp == "gather" and cfg.aggregation == "pna":
                parts.append(pna_gather(f, gidx, gval, es.receivers, es.mask))
            else:
                parts.append(gather_aggregate(f, gidx, gval, cfg.aggregation))
            continue
        sums = None if es.sums is None else es.sums.receivers
        parts.append(aggregate(f, es.receivers, hi, cfg.aggregation, es.mask, sums=sums))
    return torch.cat(parts, dim=-1)


def _sorted_kernel_takes(name: str, num_edges: int, width: int, cfg: GNNConfig) -> bool:
    """Whether ``agg_vjp: sorted`` aggregates the set through K4f/K4b.  The
    card has no VMEM, so the byte gate means nothing there; it is kept so
    that both packages take the same path, with the same tie rule, on
    every mesh."""
    return (
        cfg.agg_vjp == "sorted"
        and cfg.aggregation == "pna"
        and name in SORTED_EDGE_SETS
        and num_edges * width * 4 <= MAX_EDGE_BLOCK_BYTES
    )


def edge_shard_ties(graph: Graph, cfg: GNNConfig) -> Graph:
    """The graph with each edge set's tie rule (``EdgeSet.ties``) for its
    aggregation over edge shards (``core.segment_ops.sharded_aggregate``):
    what the one-device dispatch of :func:`_aggregate_sets` does with a
    max/min cotangent.  ``pna_gather`` (``gather``, over a neighbour matrix
    that passes ``_gather_dense_ok``) sends all of it to every tied edge
    (``full``); autograd through ``gather_aggregate`` or the scatter
    (``xla``, a set that ``sorted`` leaves to them, and a set the fused
    kernels leave) splits it (``split``).  The sets that K4f/K4b take run
    them on the joined shards.  Read on the whole graph, before
    ``parallel.halo.shard_graph`` drops the neighbour matrices."""
    sets = {}
    for name, es in graph.edge_sets.items():
        full = (
            cfg.agg_vjp == "gather"
            and cfg.aggregation == "pna"
            and es.gather_idx is not None
            and _gather_dense_ok(es)
        )
        sets[name] = es.replace(ties="full" if full else "split")
    return graph.replace(edge_sets=sets)


def _update_sets(
    block: GraphNetBlock,
    graph: Graph,
    names: Sequence[str],
    cfg: GNNConfig,
    new_feats: Dict[str, torch.Tensor],
    fused_aggs: Dict[str, torch.Tensor],
) -> None:
    """Edge updates of ``names`` from the block-input edge features and the
    graph's current node state, into ``new_feats`` (and, for fused sets,
    their aggregates over every node row into ``fused_aggs``)."""
    all_nodes = concat_node_tiers(graph)
    num_total = all_nodes.shape[-2]
    for name in names:
        es = graph.edge_sets[name]
        eparams = block.edge_models[name]
        if _fused_eligible(eparams, es, cfg):
            new_feats[name], fused_aggs[name] = _fused_update_and_agg(
                eparams, all_nodes, es, cfg, num_total
            )
        else:
            new_feats[name] = _update_edge_features(eparams, all_nodes, es, cfg)
            fused_aggs.pop(name, None)


def _with_edge_features(graph: Graph, new_feats: Dict[str, torch.Tensor]) -> Graph:
    sets = dict(graph.edge_sets)
    for name, f in new_feats.items():
        sets[name] = sets[name].replace(features=f)
    return graph.replace(edge_sets=sets)


def _flat_apply_once(block: GraphNetBlock, graph: Graph, cfg: GNNConfig) -> Graph:
    names = tuple(n for n in cfg.edge_sets if n in graph.edge_sets)
    new_feats: Dict[str, torch.Tensor] = {}
    fused_aggs: Dict[str, torch.Tensor] = {}
    _update_sets(block, graph, names, cfg, new_feats, fused_aggs)
    all_nodes = concat_node_tiers(graph)
    agg = _aggregate_sets(new_feats, graph, names, all_nodes.shape[-2], cfg, fused_aggs)
    features = torch.cat([all_nodes, agg], dim=-1)
    n_mesh = graph.num_nodes
    upd = block.node_model(features[..., :n_mesh, :], cfg.cd)
    graph = graph.replace(node_features=graph.node_features + upd)
    if cfg.architecture == "hetero" and graph.hyper_features is not None:
        hyper_upd = block.hyper_node_model_cross(features[..., n_mesh:, :], cfg.cd)
        graph = graph.replace(hyper_features=graph.hyper_features + hyper_upd)
    return _with_edge_features(graph, new_feats)


def _hierarchical_apply(block: GraphNetBlock, graph: Graph, cfg: GNNConfig) -> Graph:
    """The hyper/multiscale block: mesh, up, cross and down sub-steps (and
    mesh again for multiscale).  Each sub-step's edge update reads the
    block-input edge features (the graph's edge sets are replaced only at
    the end) and the current node state; its node update aggregates into
    its tier's rows: the mesh window ``[0, N)`` directly, the hyper rows as
    every row's aggregate cut to ``[N, N + K)``, as in the JAX package."""
    multiscale = cfg.architecture == "multiscale"
    new_feats: Dict[str, torch.Tensor] = {}
    fused_aggs: Dict[str, torch.Tensor] = {}
    n_mesh = graph.num_nodes

    def step(graph: Graph, sets: Sequence[str], model: MLP, tier: str) -> Graph:
        names = tuple(n for n in sets if n in graph.edge_sets)
        _update_sets(block, graph, names, cfg, new_feats, fused_aggs)
        num_total = n_mesh + graph.num_hyper_nodes
        if tier == "mesh":
            agg = _aggregate_sets(new_feats, graph, names, num_total, cfg, fused_aggs, rows=n_mesh)
            upd = model(torch.cat([graph.node_features, agg], dim=-1), cfg.cd)
            return graph.replace(node_features=graph.node_features + upd)
        agg = _aggregate_sets(new_feats, graph, names, num_total, cfg, fused_aggs)[..., n_mesh:, :]
        upd = model(torch.cat([graph.hyper_features, agg], dim=-1), cfg.cd)
        return graph.replace(hyper_features=graph.hyper_features + upd)

    graph = step(graph, MESH_TIER_SETS, block.node_model, "mesh")
    graph = step(graph, UP_SETS, block.hyper_node_model_up, "hyper")
    for i in range(MULTISCALE_ROUNDS if multiscale else 1):
        model = block.hyper_node_models_cross[i] if multiscale else block.hyper_node_model_cross
        graph = step(graph, CROSS_SETS, model, "hyper")
    graph = step(graph, DOWN_SETS, block.node_model_down, "mesh")
    if multiscale:
        graph = step(graph, MESH_TIER_SETS, block.node_model, "mesh")
    return _with_edge_features(graph, new_feats)


def block_apply(block: GraphNetBlock, graph: Graph, cfg: GNNConfig) -> Graph:
    arch = cfg.architecture
    if arch in ("hyper", "multiscale"):
        return _hierarchical_apply(block, graph, cfg)
    if arch == "repeated":
        for _ in range(REPEATED_ROUNDS):
            graph = _flat_apply_once(block, graph, cfg)
        return graph
    return _flat_apply_once(block, graph, cfg)
