"""Edge-parallel halo forward over a rank group.

Counterpart of ``hyper_graph_nets_tpu/parallel/halo.py``: the edges of a
graph are split over the ``graph`` ranks of a ``parallel.group.RankGroup``,
every rank keeps every node row, and each aggregation combines the ranks'
partial sums, maxima and minima along ``graph`` (the owner-computes halo
exchange).  On a 2-D group ``(data, graph)`` every data row does the same
(the JAX package's replicated node spec over ``data``), and the ring
kernels ring along ``graph`` only (the JAX package's ``halo_mesh_axes``).
Each rank runs the network on its shard in its own thread, block by block
in lockstep with the others (``RankGroup.run``); the aggregations meet in
the group's collectives:

- ``agg_vjp: fused`` (a plan per rank; ``ops.fused_block.fused_edge_block_spmd``
  under no autograd): K1 unfinalized on each shard, then the plain
  all-reduce; with ``overlap=True`` and plans built with ``overlap_bands``,
  K7, which rings the node-row bands while later groups compute
  (``ops/fused_overlap.py``);
- any other set: its local partials, combined by the plain all-reduce, or
  with ``ring=True`` by one K6 pass carrying all pna partials
  (``ops/ring.py``).

Forward only, as in the JAX package: training over edge shards is
``parallel.sharding.make_spmd_train_step``.  Use::

    group = RankGroup(4)                          # on the card(s)
    stopo = shard_topology(topo, group, overlap_bands=4)
    graph, _, _ = model.make_graph(state, stopo, frame, False)
    fwd = make_halo_forward(model, group, overlap=True)
    out = fwd(state, split_graph(graph, group))   # [N, out], rank 0's
"""
from __future__ import annotations

import copy
import dataclasses
from typing import List, Sequence, Union

import torch

from hyper_graph_nets_tpu_torch.core.graph import Graph
from hyper_graph_nets_tpu_torch.models.base import ModelState, SystemModel
from hyper_graph_nets_tpu_torch.nn.meshgraphnet import MeshGraphNet, network_apply
from hyper_graph_nets_tpu_torch.ops.segment_pna import SortedPlan
from hyper_graph_nets_tpu_torch.parallel.sharding import RankPlans, RankSums, cut_frame_set, per_frame


def strip_gather(graph: Graph) -> Graph:
    """Drop the neighbour matrices and the single-device fixed-order sums:
    they index global edge ids, invalid on a shard (the per-rank sums of
    ``shard_topology``, a :class:`RankSums`, stay)."""
    gather = dict(gather_idx=None, gather_valid=None, snd_gather_idx=None, snd_gather_valid=None)
    return graph.replace(
        edge_sets={
            name: es.replace(**gather, sums=es.sums if isinstance(es.sums, RankSums) else None)
            for name, es in graph.edge_sets.items()
        }
    )


def shard_graph(graph: Graph, group, r: int) -> Graph:
    """Rank r's view of a graph made on ``parallel.sharding.shard_topology``'s
    topology: every edge array cut to its ``graph`` coordinate's slice (the
    edge axis is the one before the features; the index arrays copied into
    storage of their own, which the kernels need 16-byte aligned), with its
    plan and fixed-order sums (a :class:`SortedPlan` is the whole set's,
    kept as it is: ``ops.segment_pna.pna_sorted_sharded`` joins the shards);
    a set that forms anew in every frame (plate's world edges, ``[..., W]``
    index arrays) padded and cut on its last axis, its sums built on the
    slice (``parallel.sharding.cut_frame_set``); node rows and frames as
    they are, on the graph's device."""
    G, k = group.shape["graph"], group.axis_index(r, "graph")
    frame_sets = {name: cut_frame_set(es, G, k) for name, es in graph.edge_sets.items() if per_frame(es)}
    graph = strip_gather(graph)
    sets = {}
    for name, es in graph.edge_sets.items():
        if name in frame_sets:
            sets[name] = frame_sets[name]
            continue
        E = es.num_edges
        if E % G:
            raise ValueError(f"{name}: {E} edges do not split over {G} ranks (shard_topology pads them)")
        per = E // G
        edge = lambda t, axis: t.narrow(axis, k * per, per)
        sets[name] = es.replace(
            features=edge(es.features, es.features.dim() - 2),
            senders=edge(es.senders, 0).clone(),
            receivers=edge(es.receivers, 0).clone(),
            mask=None if es.mask is None else edge(es.mask, 0).clone(),
            plan=es.plan.plans[r] if isinstance(es.plan, RankPlans) else (
                es.plan if isinstance(es.plan, SortedPlan) else None),
            sums=es.sums.sums[r] if isinstance(es.sums, RankSums) else None,
        )
    return graph.replace(edge_sets=sets)


def split_graph(graph: Graph, group) -> List[Graph]:
    """One graph (made on ``parallel.sharding.shard_topology``'s topology)
    into one graph per rank, on the rank's device: rank r gets the slice of
    every edge array of its ``graph`` coordinate, with its plan and
    fixed-order sums, and every node row (the counterpart of the JAX
    package's ``graph_partition_specs``); a batched graph's ``[B, ...]``
    frames split over the ``data`` ranks as ``sharding.shard_frames`` splits
    them (a per-frame set's index arrays too, before its slice is cut), an
    unbatched one goes to every rank."""
    batched = graph.node_features.dim() == 3
    D = group.shape["data"]
    if batched and graph.node_features.shape[0] % D:
        raise ValueError(f"{graph.node_features.shape[0]} frames do not split over {D} data ranks")
    out = []
    for r in range(group.n):
        dev = group.device(r)
        part = graph
        if batched:
            b = graph.node_features.shape[0] // D
            d = group.axis_index(r, "data")
            frames = lambda t: None if t is None else t[d * b : (d + 1) * b]
            frame_ids = lambda es, t: frames(t) if per_frame(es) else t
            part = part.replace(
                node_features=frames(part.node_features),
                hyper_features=frames(part.hyper_features),
                edge_sets={n: es.replace(features=frames(es.features), senders=frame_ids(es, es.senders),
                                         receivers=frame_ids(es, es.receivers), mask=frame_ids(es, es.mask))
                           for n, es in part.edge_sets.items()},
            )
        # a per-frame set's sums are built where its slice lies
        part = part.replace(edge_sets={
            n: es.replace(features=es.features.to(dev), senders=es.senders.to(dev), receivers=es.receivers.to(dev),
                          mask=es.mask.to(dev)) if per_frame(es) else es
            for n, es in part.edge_sets.items()})
        part = shard_graph(part, group, r)
        # own storage for each slice of features (shard_graph copied the
        # index arrays): the kernels take 16-byte aligned data
        move = lambda t: None if t is None else t.to(dev)
        part = part.replace(
            node_features=move(part.node_features),
            hyper_features=move(part.hyper_features),
            edge_sets={
                n: es.replace(features=es.features.to(dev).clone(), senders=move(es.senders),
                              receivers=move(es.receivers), mask=move(es.mask))
                for n, es in part.edge_sets.items()
            },
        )
        out.append(part)
    return out


def make_halo_forward(model: SystemModel, group, ring: bool = False, overlap: bool = False):
    """``fn(state_or_params, rank_graphs, all_ranks=False) -> [N, out]``.

    ``rank_graphs`` is :func:`split_graph`'s list of one unbatched frame
    (or the frame's graph, which is split here).  The parameters go to each
    rank's device (ranks on the same device share them).  The aggregations
    combine along ``graph``: on a 2-D group each data row computes the same
    output.  Returns rank 0's output, or with ``all_ranks`` every rank's.
    Synchronizes every rank at the end and raises if a ring kernel timed
    out.  In a pod whose ``graph`` row spans processes of one node the ring
    kernels (K6, K7) ring across them (every process calls ``fn`` at the
    same point); across nodes ``ring`` and ``overlap`` raise
    (``RankGroup.check_ring``).
    """
    if ring or overlap:
        group.check_ring("the halo forward's ring (K6)" if ring else "the halo forward's overlap (K7)")
    cfg = dataclasses.replace(
        model.gnn_config, axis_name=group, halo_ring=ring, halo_overlap=overlap
    )

    def fwd(
        state_or_params: Union[ModelState, MeshGraphNet],
        rank_graphs: Union[Graph, Sequence[Graph]],
        all_ranks: bool = False,
    ):
        params = (
            state_or_params.params if isinstance(state_or_params, ModelState) else state_or_params
        )
        if isinstance(rank_graphs, Graph):
            rank_graphs = split_graph(rank_graphs, group)
        home = next(params.parameters()).device
        on_device = {
            d: params if d == home else copy.deepcopy(params).to(d) for d in set(group.devices)
        }

        def rank_forward(r):
            with torch.no_grad():  # grad mode is per thread
                return network_apply(on_device[group.device(r)], rank_graphs[r], cfg)

        outs = group.run(rank_forward)
        group.check()
        return outs if all_ranks else outs[0]

    return fwd
