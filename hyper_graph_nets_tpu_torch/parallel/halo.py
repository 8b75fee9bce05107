"""Edge-parallel halo forward over a rank group.

Counterpart of ``hyper_graph_nets_tpu/parallel/halo.py``: the edges of a
graph are split over the ranks of a ``parallel.group.RankGroup``, every
rank keeps every node row, and each aggregation combines the ranks' partial
sums, maxima and minima (the owner-computes halo exchange).  Each rank runs
the network on its shard in its own thread, block by block in lockstep with
the others (``RankGroup.run``); the aggregations meet in the group's
collectives:

- ``agg_vjp: fused`` (a plan per rank): K1 unfinalized on each shard, then
  the plain all-reduce (``ops.fused_block.fused_edge_block_collective``);
  with ``overlap=True`` and plans built with ``overlap_bands``, K7, which
  rings the node-row bands while later groups compute
  (``ops/fused_overlap.py``);
- any other set: its local partials, combined by the plain all-reduce, or
  with ``ring=True`` by one K6 pass carrying all pna partials
  (``ops/ring.py``).

Forward only, as in the JAX package: training over edge shards is the GSPMD
step of a later slice.  Use::

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
from hyper_graph_nets_tpu_torch.parallel.sharding import RankPlans, RankSums


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


def split_graph(graph: Graph, group) -> List[Graph]:
    """One unbatched graph (made on ``parallel.sharding.shard_topology``'s
    topology) into one graph per rank, on the rank's device: rank r gets the
    r-th contiguous slice of every edge array and the plan and fixed-order
    sums of its slice;
    node rows are copied to every rank (the counterpart of the JAX package's
    ``graph_partition_specs``)."""
    graph = strip_gather(graph)
    if graph.node_features.dim() != 2:
        raise ValueError("the halo forward takes one unbatched frame")
    out = []
    for r in range(group.n):
        dev = group.device(r)
        sets = {}
        for name, es in graph.edge_sets.items():
            E = es.num_edges
            if E % group.n:
                raise ValueError(f"{name}: {E} edges do not split over {group.n} ranks (shard_topology pads them)")
            per = E // group.n
            # own storage for each slice: the kernels take 16-byte aligned data
            cut = lambda t: None if t is None else t[r * per : (r + 1) * per].to(dev).clone()
            sets[name] = es.replace(
                features=cut(es.features),
                senders=cut(es.senders),
                receivers=cut(es.receivers),
                mask=cut(es.mask),
                plan=es.plan.plans[r] if isinstance(es.plan, RankPlans) else None,
                sums=es.sums.sums[r] if isinstance(es.sums, RankSums) else None,
            )
        out.append(Graph(node_features=graph.node_features.to(dev), edge_sets=sets))
    return out


def make_halo_forward(model: SystemModel, group, ring: bool = False, overlap: bool = False):
    """``fn(state_or_params, rank_graphs, all_ranks=False) -> [N, out]``.

    ``rank_graphs`` is :func:`split_graph`'s list (or one graph, which is
    split here).  The parameters go to each rank's device (ranks on the
    same device share them).  Returns rank 0's output, or with
    ``all_ranks`` every rank's.  Synchronizes every rank at the end and
    raises if a ring kernel timed out.
    """
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
