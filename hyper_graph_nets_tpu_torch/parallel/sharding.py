"""Edge sharding of a topology over a rank group.

Counterpart of the parts of ``hyper_graph_nets_tpu/parallel/sharding.py``
that the halo forward needs (``pad_to_multiple``, ``shard_topology``):
edges are padded to a multiple of the group's size and rank r takes the
r-th contiguous slice; node rows are not split.  The GSPMD train step and
the ``data`` axis of that module belong to a later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.models.base import Topology
from hyper_graph_nets_tpu_torch.ops.fused_block import SegmentPlan, plan_segments
from hyper_graph_nets_tpu_torch.ops.fused_overlap import chunk_roundrobin_permutation, overlap_plan

# edges per chunk of the round-robin layout: the JAX package's
# default_chunk() when the TPU's scoped-VMEM limit is not raised, so both
# packages put the same edges on each rank
DEFAULT_CHUNK = 256


@dataclasses.dataclass(frozen=True)
class RankPlans:
    """The kernel plans of an edge-sharded set: ``plans[r]`` is rank r's
    :class:`SegmentPlan` over its slice, on its device (the JAX package's
    stacked per-shard band plan)."""

    plans: Tuple[SegmentPlan, ...]


def pad_to_multiple(arr: np.ndarray, multiple: int, pad_value=0) -> np.ndarray:
    n = arr.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr
    pad = np.full((target - n,) + arr.shape[1:], pad_value, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def shard_topology(
    topo: Topology,
    group,
    overlap_bands: Optional[int] = None,
    chunk: int = DEFAULT_CHUNK,
) -> Topology:
    """Pad the edges to a multiple of the group's size and plan each rank's
    slice.

    Padding edges have receiver ``num_nodes - 1`` (receivers stay sorted),
    sender 0 and mask 0.  With a fused topology (its plan a
    :class:`SegmentPlan`) the result's plan is a :class:`RankPlans`.
    ``overlap_bands`` (fused only) pads to ``chunk * n`` and deals the chunks
    round-robin
    (``ops.fused_overlap.chunk_roundrobin_permutation``), so every rank's
    slice spans all receivers, and its plans carry that many bands and K7's
    work list (``ops.fused_overlap.overlap_plan``).
    The result lies on rank 0's device and has no neighbour matrices (they
    index global edge ids); ``halo.split_graph`` gives each rank its slice.
    """
    g = group.n
    snd = np.asarray(topo.senders.cpu(), np.int32)
    rcv = np.asarray(topo.receivers.cpu(), np.int32)
    n_valid = len(snd)
    if topo.mask is not None and not bool((topo.mask > 0).all()):
        raise ValueError("shard_topology takes a topology whose edges are all valid")
    plans = isinstance(topo.plan, SegmentPlan)
    use_overlap = bool(overlap_bands and plans)
    multiple = chunk * g if use_overlap else g
    snd = pad_to_multiple(snd, multiple, pad_value=0)
    rcv = pad_to_multiple(rcv, multiple, pad_value=topo.num_nodes - 1)
    mask = np.zeros(len(snd), np.float32)
    mask[:n_valid] = 1.0
    if use_overlap:
        perm = chunk_roundrobin_permutation(len(snd), g, chunk)
        snd, rcv, mask = snd[perm], rcv[perm], mask[perm]
    rank_plans = None
    if plans:
        per = len(snd) // g
        shard = lambda r: slice(r * per, (r + 1) * per)
        rank_plans = RankPlans(
            tuple(
                (
                    overlap_plan(rcv[shard(r)], mask[shard(r)], topo.num_nodes, overlap_bands,
                                 senders=snd[shard(r)])
                    if use_overlap
                    else plan_segments(rcv[shard(r)], topo.num_nodes, senders=snd[shard(r)])
                ).to(group.device(r))
                for r in range(g)
            )
        )
    dev = group.device(0)
    return Topology(
        senders=torch.from_numpy(snd).to(dev),
        receivers=torch.from_numpy(rcv).to(dev),
        num_nodes=topo.num_nodes,
        mask=torch.from_numpy(mask).to(dev),
        plan=rank_plans,
    )
