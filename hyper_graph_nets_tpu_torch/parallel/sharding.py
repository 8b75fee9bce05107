"""Data x graph sharding over a rank group: the sharded train step.

Counterpart of ``hyper_graph_nets_tpu/parallel/sharding.py``.  A
``parallel.group.RankGroup(data, graph)`` stands for the JAX package's
``('data', 'graph')`` mesh (``make_mesh``): frames split over ``data``, each
graph's edges over ``graph`` (:func:`shard_topology`: padded to a multiple
of the axis and cut into contiguous slices, or dealt round-robin by chunks
for K7; :class:`EdgeLayout` lays out any per-edge array the same way),
node rows on every rank.

:func:`make_spmd_train_step` is the JAX package's ``make_spmd_train_step``:
the single-device step's noise, loss and Adam update over the global batch,
each rank running the network on its data rank's frames and its graph
rank's edges in its own thread (``RankGroup.run``).  Where the JAX package
lets XLA partition one global program, the port places each collective
itself:

- the normalizers accumulate the global batch: every accumulation's partial
  sums are all-reduced over the ``data`` ranks, in rank order
  (``core.normalizer.reduce_partials``; each rank computes its frames'
  features over every edge, and the expansion over every node row, so no
  ``graph`` reduction is needed);
- with an expansion (the graph balancer, remote message passing), its
  static (``expansion.prepare`` on the unsharded topology) is laid out for
  the group (:func:`shard_static`, on each step unless the caller passes
  its result): the mesh set's keep
  mask as the mesh edges lie, the balance and cluster-tier sets padded to a
  multiple of ``graph``, each rank's fixed-order sums and kernel plans
  (RMP's mesh set over ``N + K`` rows), every plan's in-degree counting the
  kept edges only; each rank expands its frames' graph over every node row
  before the sets are cut;
- each fused block runs K1 unfinalized on the shard and the plain
  all-reduce along ``graph``, or K7 (``ops.fused_block.fused_edge_block_spmd``);
  under autograd each data row's shards meet in one node, whose backward
  runs K2 on every shard against the global aggregate at the global degree;
  a ``sorted`` mesh set joins its data row's shards and runs K4f on them,
  and K4b in one node per data row (``ops.segment_pna.pna_sorted_sharded``,
  as the JAX package's sharded step runs its sorted kernel on the gathered
  set); every other set (the balance and tier sets, and every set under
  ``gather`` or ``xla``) aggregates its local partials and the plain
  all-reduce, its shards meeting in one node per data row as well
  (``core.segment_ops.sharded_aggregate``);
- the loss divides by the global mask sum; only each data row's first graph
  rank's loss is differentiated, and every rank's parameter gradients (its
  own copy of the node side, its shard of the edge side) add up to the
  single-device gradient; the ranks on one device share that device's
  parameters, so their gradients sum in place;
- over several devices (the JAX package's replicated parameters on a mesh
  of several chips), each device other than rank 0's holds a copy of the
  parameters that the step keeps, refreshed from the state's own in place
  at the start of every call and after Adam; after the backward each
  copy's gradient is brought to rank 0's device and added to the state's,
  the devices in the order they first appear in ``group.devices``, with
  plain copies and adds, so the sum is the same bits on every run;
- one Adam step on the summed gradients, on rank 0's device.

A group over several cards (the default ``RankGroup`` on a node with
several: rank r on ``cuda:(r % cards)``) runs each rank on its own card's
copy, topology and plans; the cards must reach each other (peer access,
which ``RankGroup`` turns on and without which it raises).  On the CPU,
``torch.device("cpu", i)`` stands for card i: the ranks' tensors lie on the
one CPU, but each logical device gets copies of its own.

Use::

    group = RankGroup(2, 2)                               # data 2 x graph 2
    stopo = shard_topology(topo, group)                   # overlap_bands=4: K7
    step = make_spmd_train_step(trainer, stopo, group, expansion=trainer.expansion)
    static = trainer.expansion.prepare(model, frame0, topo)   # with an expansion
    static = shard_static(trainer.expansion, static, stopo, group)  # optional: laid out once
    tstate, loss = step(tstate, frames, static=static)    # frames [B, ...], B % 2 == 0

Flag, cylinder and plate, with remote message passing on any connector
and architecture (``hyper``, ``multiscale``, ``hetero``, ``multi``;
``repeated``, which has no expansion; HGN plate is plate with ``hyper``)
and with the graph balancer, alone or before RMP.  ``multi``'s merged
``mesh_edges`` (the laid-out mesh, inter, up and down sets one after
another) is cut into contiguous slices as any unfused set, with per-rank
sums over each slice (:func:`_shard_rmp`).  Plate's world edges form anew in every frame: each graph
rank of a data row builds the whole world set of its frames (the radius
query, the slots, the receiver sort) and ``halo.shard_graph`` cuts it on
its edge axis, padded to a multiple of ``graph`` with the set's invalid
slot (:class:`EdgeLayout` along the last axis), each rank's fixed-order
sums built on its slice (``EdgeSums.per_frame``, over the set's node rows:
``N``, or ``N + K`` after RMP); the balancer's ``balance`` set beside it
is padded to a multiple of ``graph`` as on flag.

In a pod (``parallel.multihost``: the group's ranks over several
processes, a ``data`` row or a ``graph`` row possibly spanning them) each
process hands the step the frames of its ``data`` rows (``group.data_rows``,
``B_row`` frames a row) of the global batch of ``B_row x data``: the step
slices the global noise draws (drawn whole in every process from a
generator seeded alike) at those rows; every sum whose ranks span processes
gathers the other processes' entries and folds in global rank order
(``RankGroup.gather``): the normalizers' partials and the loss mask's count
over ``data``, the aggregates over ``graph``, and in the backward the
aggregate cotangents of a ``graph`` row (each process's sharded node over
its own shards of the row, K2 on them).  A process that holds no row's
first graph rank differentiates one of its ranks' losses with a zero
cotangent, so its nodes run and join their rows' sums.  Each parameter's
gradient is then summed over every device of every process in global order
(:meth:`SpmdTrainStep._sum_over_processes`), so every process and every
card holds the same parameters bit for bit, those of the in-process group
of the same shape over the same devices; the loss is the global loss.
:func:`make_sharded_forward` returns the process's rows.
"""
from __future__ import annotations

import copy
import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.balancer.base import BalancerStatic, GraphBalancer
from hyper_graph_nets_tpu_torch.core import normalizer
from hyper_graph_nets_tpu_torch.core.graph import EdgeSet
from hyper_graph_nets_tpu_torch.core.segment_ops import EdgeSums, FrameSum
from hyper_graph_nets_tpu_torch.models.base import ModelState, Topology
from hyper_graph_nets_tpu_torch.models.cylinder import CylinderModel
from hyper_graph_nets_tpu_torch.models.flag import FlagModel
from hyper_graph_nets_tpu_torch.models.plate import PlateModel
from hyper_graph_nets_tpu_torch.nn.blocks import edge_shard_ties
from hyper_graph_nets_tpu_torch.nn.meshgraphnet import network_apply
from hyper_graph_nets_tpu_torch.ops.fused_block import SegmentPlan, plan_segments
from hyper_graph_nets_tpu_torch.ops.fused_overlap import chunk_roundrobin_permutation, overlap_plan
from hyper_graph_nets_tpu_torch.ops.segment_pna import SortedPlan, sorted_plan
from hyper_graph_nets_tpu_torch.rmp.connector import RMPStatic
from hyper_graph_nets_tpu_torch.rmp.remote_message_passing import RemoteMessagePassing
from hyper_graph_nets_tpu_torch.training.trainer import TrainState, add_noise

# edges per chunk of the round-robin layout: the JAX package's
# default_chunk() when the TPU's scoped-VMEM limit is not raised, so both
# packages put the same edges on each rank
DEFAULT_CHUNK = 256
NOT_PORTED = "is not ported to the sharded step yet (ROADMAP queue 1, item 7)"


@dataclasses.dataclass(frozen=True)
class RankPlans:
    """The kernel plans of an edge-sharded set: ``plans[r]`` is rank r's
    :class:`SegmentPlan` over its graph rank's slice, on its device (the
    JAX package's stacked per-shard band plan), with the set's global
    in-degree (``SegmentPlan.degree``).  Ranks that share a graph
    coordinate and a device share one plan.  The plans stay on their ranks'
    devices: ``to`` leaves them there."""

    plans: Tuple[SegmentPlan, ...]

    def to(self, device) -> "RankPlans":
        return self


@dataclasses.dataclass(frozen=True)
class RankSums:
    """The fixed-order sums of an edge-sharded set: ``sums[r]`` is rank r's
    :class:`EdgeSums` over its graph rank's slice (indices local to the
    slice), on its device; the unfused sets' local partials sum through
    them.  ``to`` leaves them on their ranks' devices."""

    sums: Tuple[EdgeSums, ...]

    def to(self, device) -> "RankSums":
        return self

    def with_rows(self, num_nodes: int) -> "RankSums":
        """Every rank's sums into more node rows (a hyper tier's after the
        mesh rows), the added ones empty."""
        return RankSums(tuple(s.with_rows(num_nodes) for s in self.sums))


@dataclasses.dataclass(frozen=True, eq=False)
class EdgeLayout:
    """How one edge set's ``num_edges`` edges lie over a group's ``graph``
    ranks (the JAX package's ``shard_topology``): padded to ``padded``
    edges, a multiple of the axis (or of ``chunk * graph`` for the
    round-robin layout), then reordered by ``perm`` (laid-out position ->
    padded position; None: in order), which deals the chunks round-robin
    (``ops.fused_overlap.chunk_roundrobin_permutation``).  Graph rank k
    holds positions :meth:`shard` ``(k)``.  :meth:`relay` lays out any
    per-edge array of the set the same way (its mask, the balancer's keep
    mask), :meth:`relay_ids` re-points arrays of edge ids (neighbour
    matrices)."""

    num_edges: int
    padded: int
    graph: int
    perm: Optional[np.ndarray] = None

    @classmethod
    def build(cls, num_edges: int, graph: int, chunk: Optional[int] = None) -> "EdgeLayout":
        multiple = chunk * graph if chunk else graph
        padded = -(-num_edges // multiple) * multiple
        perm = chunk_roundrobin_permutation(padded, graph, chunk) if chunk else None
        return cls(int(num_edges), int(padded), int(graph), perm)

    @property
    def per(self) -> int:
        return self.padded // self.graph

    def shard(self, k: int) -> slice:
        return slice(k * self.per, (k + 1) * self.per)

    def relay(self, x, pad_value=0, axis: int = 0):
        """``x`` (numpy or torch, ``num_edges`` long on ``axis``) padded
        with ``pad_value`` and reordered as the edges lie."""
        if x.shape[axis] != self.num_edges:
            raise ValueError(f"{x.shape[axis]} edges on axis {axis}, the layout has {self.num_edges}")
        pad_shape = list(x.shape)
        pad_shape[axis] = self.padded - self.num_edges
        if isinstance(x, torch.Tensor):
            y = torch.cat([x, x.new_full(pad_shape, pad_value)], dim=axis)
            if self.perm is not None:
                y = y.index_select(axis, torch.from_numpy(self.perm).to(y.device))
            return y
        y = np.concatenate([x, np.full(pad_shape, pad_value, x.dtype)], axis=axis)
        return y if self.perm is None else np.take(y, self.perm, axis=axis)

    def relay_ids(self, ids):
        """Edge ids (a neighbour matrix's, numpy or torch) re-pointed to
        where their edges lie."""
        if self.perm is None:
            return ids
        where = np.empty(self.padded, np.int64)
        where[self.perm] = np.arange(self.padded)
        if isinstance(ids, torch.Tensor):
            return torch.from_numpy(where).to(ids.device)[ids.long()].to(ids.dtype)
        return where[np.asarray(ids, np.int64)].astype(np.asarray(ids).dtype)


def per_frame(es: EdgeSet) -> bool:
    """Whether ``es`` forms anew in every frame (plate's world edges): its
    sums are per-frame plans (``EdgeSums.per_frame``)."""
    return isinstance(es.sums, EdgeSums) and isinstance(es.sums.receivers, FrameSum)


def cut_frame_set(es: EdgeSet, graph: int, k: int) -> EdgeSet:
    """Graph rank k's slice of a set that forms anew in every frame
    (:func:`per_frame`; ``[..., W]`` senders, receivers and mask): the
    arrays padded on their edge axis (the last; the features' the one before
    their width) to a multiple of ``graph`` with the set's invalid slot
    (sender 0, receiver 0, mask 0, features 0), as :class:`EdgeLayout` lays
    them out, and cut to the rank's contiguous slice; its fixed-order sums
    built on the slice, where it lies, over the set's node rows (``N``, or
    ``N + K`` after RMP re-rows it)."""
    layout = EdgeLayout.build(es.num_edges, graph)
    sl = layout.shard(k)

    def cut(t, axis, pad):
        if layout.padded > layout.num_edges:  # no empty pad tensor per step when W divides
            t = layout.relay(t, pad, axis=axis)
        return t.narrow(axis % t.dim(), sl.start, layout.per).contiguous()

    snd, rcv, mask = cut(es.senders, -1, 0), cut(es.receivers, -1, 0), cut(es.mask, -1, 0.0)
    return es.replace(
        features=cut(es.features, -2, 0.0),
        senders=snd,
        receivers=rcv,
        mask=mask,
        plan=None,
        gather_idx=None,
        gather_valid=None,
        snd_gather_idx=None,
        snd_gather_valid=None,
        sums=EdgeSums.per_frame(snd, rcv, mask, es.sums.receivers.num_segments),
    )


def pad_to_multiple(arr: np.ndarray, multiple: int, pad_value=0) -> np.ndarray:
    n = arr.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr
    pad = np.full((target - n,) + arr.shape[1:], pad_value, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _per_rank(group, build):
    """``[build(g).to(device(r)) for r]``, built once per graph coordinate
    and moved once per (graph coordinate, device)."""
    built, moved = {}, {}
    out = []
    for r in range(group.n):
        g, dev = group.axis_index(r, "graph"), group.device(r)
        if g not in built:
            built[g] = build(g)
        if (g, dev) not in moved:
            moved[(g, dev)] = built[g].to(dev)
        out.append(moved[(g, dev)])
    return tuple(out)


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def rank_sums(group, layout: EdgeLayout, senders, receivers, num_nodes: int) -> RankSums:
    """Each rank's fixed-order sums over its slice of laid-out (host)
    senders and receivers, into ``num_nodes`` rows."""
    return RankSums(_per_rank(group, lambda k: EdgeSums.build(
        senders[layout.shard(k)], receivers[layout.shard(k)], num_nodes)))


def _degree(receivers, valid, num_nodes: int) -> torch.Tensor:
    """Each receiver's count of edges with ``valid > 0`` (host arrays)."""
    return torch.from_numpy(np.bincount(receivers[valid > 0], minlength=num_nodes).astype(np.float32))


def rank_plans(group, layout: EdgeLayout, senders, receivers, mask, num_nodes: int,
               bands: Optional[int] = None, degree: Optional[torch.Tensor] = None) -> RankPlans:
    """Each rank's kernel plan over its slice of the laid-out (host) edges
    into ``num_nodes`` rows (with ``bands``, K7's, on the round-robin
    layout, its work list from ``mask``), each carrying the set's in-degree:
    ``degree``, or the count of the edges with ``mask > 0``."""
    degree = _degree(receivers, mask, num_nodes) if degree is None else degree

    def plan_of(k):
        sl = layout.shard(k)
        if bands:
            plan = overlap_plan(receivers[sl], mask[sl], num_nodes, bands, senders=senders[sl])
        else:
            plan = plan_segments(receivers[sl], num_nodes, senders=senders[sl])
        return dataclasses.replace(plan, degree=degree)

    return RankPlans(_per_rank(group, plan_of))


def with_degree(plans: RankPlans, degree: torch.Tensor) -> RankPlans:
    """The same plans with another in-degree (the balancer's kept edges')."""
    new = {}
    return RankPlans(tuple(
        new.setdefault(id(p), dataclasses.replace(p, degree=degree.to(p.row_ptr.device)))
        for p in plans.plans))


def shard_topology(
    topo: Topology,
    group,
    overlap_bands: Optional[int] = None,
    chunk: int = DEFAULT_CHUNK,
) -> Topology:
    """Lay the edges out over the group's ``graph`` ranks
    (:class:`EdgeLayout`) and plan each graph rank's slice.

    Padding edges have receiver ``num_nodes - 1`` (receivers stay sorted),
    sender 0 and mask 0; the topology's own mask goes with its edges, and
    the in-degree counts valid edges only.  With a fused topology (its plan
    a :class:`SegmentPlan`) the result's plan is a :class:`RankPlans`, each
    plan carrying the set's global in-degree.  ``overlap_bands`` (fused
    only) pads to ``chunk * graph`` and deals the chunks round-robin, so
    every rank's slice spans all receivers, and its plans carry that many
    bands and K7's work list (``ops.fused_overlap.overlap_plan``).  With a
    sorted topology (a :class:`SortedPlan`) the result's plan is the
    :class:`SortedPlan` of the laid-out edges, which K4f reads on the
    joined shards.  The result lies on rank 0's device; its neighbour matrices point at
    the laid-out edges; its ``sums`` are a :class:`RankSums`, each rank's
    fixed-order sums over its slice, built here on the host once per
    topology; its ``layout`` is the :class:`EdgeLayout`;
    ``halo.split_graph`` gives each rank its slice.
    """
    N = topo.num_nodes
    plans = isinstance(topo.plan, SegmentPlan)
    use_overlap = bool(overlap_bands and plans)
    layout = EdgeLayout.build(len(topo.senders), group.shape["graph"], chunk if use_overlap else None)
    snd = layout.relay(_host(topo.senders).astype(np.int32), 0)
    rcv = layout.relay(_host(topo.receivers).astype(np.int32), N - 1)
    mask = np.ones(layout.num_edges, np.float32) if topo.mask is None else _host(topo.mask).astype(np.float32)
    mask = layout.relay(mask, 0.0)
    dev = group.device(0)
    ids = lambda t: None if t is None else layout.relay_ids(t).to(dev)
    if use_overlap:
        group.check_ring("shard_topology(overlap_bands=...) (K7)")
    plan = None
    if plans:
        plan = rank_plans(group, layout, snd, rcv, mask, N, overlap_bands if use_overlap else None)
    elif isinstance(topo.plan, SortedPlan):
        plan = sorted_plan(rcv, N, mask).to(dev)
    return Topology(
        senders=torch.from_numpy(snd).to(dev),
        receivers=torch.from_numpy(rcv).to(dev),
        num_nodes=N,
        mask=torch.from_numpy(mask).to(dev),
        plan=plan,
        gather_idx=ids(topo.gather_idx),
        gather_valid=None if topo.gather_valid is None else topo.gather_valid.to(dev),
        snd_gather_idx=ids(topo.snd_gather_idx),
        snd_gather_valid=None if topo.snd_gather_valid is None else topo.snd_gather_valid.to(dev),
        sums=rank_sums(group, layout, snd, rcv, N),
        aux=topo.aux,
        world_cap=topo.world_cap,
        layout=layout,
    )


# -- an expansion's static over the rank group ---------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedStatic:
    """An expansion's static laid out for a rank group (:func:`shard_static`):
    ``topo``, the sharded topology whose plans carry the mesh set's
    in-degree over the kept edges, and ``members``, each member's static
    with its edge sets laid out, per-rank sums and plans."""

    topo: Topology
    members: Tuple


def _shard_balancer(st: BalancerStatic, topo: Topology, group) -> BalancerStatic:
    """The balancer's static on the group: the keep mask laid out as the
    mesh edges lie, the balance set padded to a multiple of ``graph`` with
    each rank's sums over the mesh rows."""
    bal = EdgeLayout.build(int(st.bal_senders.shape[0]), group.shape["graph"])
    snd, rcv = bal.relay(st.bal_senders, 0), bal.relay(st.bal_receivers, topo.num_nodes - 1)
    return BalancerStatic(
        bal_senders=snd,
        bal_receivers=rcv,
        bal_mask=bal.relay(st.bal_mask, 0.0),
        bal_gather_idx=st.bal_gather_idx,  # padding at the end: the ids stand
        bal_gather_valid=st.bal_gather_valid,
        mesh_keep=topo.layout.relay(st.mesh_keep, 0.0),
        bal_sums=rank_sums(group, bal, _host(snd), _host(rcv), topo.num_nodes),
    )


# the cluster-tier sets of an RMPStatic: (prefix, its per-edge fields and
# their padding: a sender, a receiver (the last row), a mask, a node order)
_TIER_SETS = (
    ("up", ("senders", "receivers", "mask", "perm")),
    ("down", ("senders", "receivers", "mask", "perm")),
    ("inter", ("senders", "receivers", "mask")),
    ("inter_world", ("senders", "receivers", "mask")),
)


def _shard_rmp(st: RMPStatic, topo: Topology, group, valid: np.ndarray) -> RMPStatic:
    """RMP's static on the group: each cluster-tier set padded to a
    multiple of ``graph`` (unfused: no plans, as the JAX package un-fuses
    them under sharding), each rank's sums over ``N + K`` rows (and, for
    ``multi``, over each rank's slice of the merged set); the mesh set's
    per-rank plans over ``N + K`` rows with the in-degree over ``valid``
    edges (the kept ones)."""
    rows = topo.num_nodes + st.num_clusters
    pads = {"senders": 0, "receivers": rows - 1, "mask": 0.0, "perm": 0}
    changes = {}
    for prefix, fields in _TIER_SETS:
        if getattr(st, f"{prefix}_senders") is None:
            continue
        layout = EdgeLayout.build(int(getattr(st, f"{prefix}_senders").shape[0]), group.shape["graph"])
        for f in fields:
            changes[f"{prefix}_{f}"] = layout.relay(getattr(st, f"{prefix}_{f}"), pads[f])
        changes[f"{prefix}_sums"] = rank_sums(group, layout, _host(changes[f"{prefix}_senders"]),
                                              _host(changes[f"{prefix}_receivers"]), rows)
        changes[f"{prefix}_plan"] = None
    if st.merged_sums is not None:
        # MultigraphConnector's mesh_edges: the laid-out mesh, inter, up and
        # down sets one after another (each a multiple of graph long), cut
        # into contiguous slices as any unfused set
        cat = lambda f: np.concatenate([_host(getattr(topo, f))] + [
            _host(changes[f"{p}_{f}"]) for p in ("inter", "up", "down")]).astype(np.int64)
        snd, rcv = cat("senders"), cat("receivers")
        changes["merged_sums"] = rank_sums(group, EdgeLayout.build(len(snd), group.shape["graph"]), snd, rcv, rows)
    mesh_plan = None
    if isinstance(topo.plan, RankPlans):
        rcv = _host(topo.receivers)
        mesh_plan = rank_plans(group, topo.layout, _host(topo.senders), rcv, _host(topo.mask), rows,
                               topo.plan.plans[0].overlap_bands or None, degree=_degree(rcv, valid, rows))
    return st._replace(mesh_plan=mesh_plan, **changes)


def shard_static(expansion, static: Tuple, topo: Topology, group) -> ShardedStatic:
    """Lay ``static`` (``expansion.prepare``'s, made on the unsharded
    topology) out for ``topo`` (:func:`shard_topology`'s on ``group``), on
    the host: the balancer's keep mask as the mesh edges lie and its
    balance set padded, RMP's cluster-tier sets padded, each rank's sums
    and plans; every mesh plan's in-degree counts the edges the topology's
    mask and the keep mask leave (a removed edge reaches no aggregate, so
    the mean divides by the kept count, as on one device)."""
    valid = _host(topo.mask).astype(np.float32)
    members = []
    for member, st in zip(expansion.members, static):
        if isinstance(member, GraphBalancer):
            st = _shard_balancer(st, topo, group)
            valid = valid * _host(st.mesh_keep)
        elif isinstance(member, RemoteMessagePassing):
            st = _shard_rmp(st, topo, group, valid)
        members.append(st)
    stopo = topo
    if isinstance(topo.plan, RankPlans):
        stopo = topo._replace(plan=with_degree(topo.plan, _degree(_host(topo.receivers), valid, topo.num_nodes)))
    return ShardedStatic(topo=stopo, members=tuple(members))


def check_supported(model, expansion) -> None:
    """Raise on what the sharded step and forward do not run: a model other
    than flag, cylinder and plate, and a model configured with an expansion
    that is not given.  Every connector and architecture of remote message
    passing (``hyper``, ``multiscale``, ``hetero``, ``multi``; ``repeated``
    has no expansion) and the graph balancer run on every model."""
    if not isinstance(model, (FlagModel, CylinderModel, PlateModel)):
        raise NotImplementedError(f"the sharded step on {type(model).__name__} {NOT_PORTED}")
    if expansion is None and (model.use_rmp or model.use_balancer):
        raise ValueError("the model is configured with an expansion: pass "
                         "expansion=training.expansion.build_expansion(model, config)")


# -- the step -------------------------------------------------------------------


def shard_frames(frames: Dict[str, torch.Tensor], group) -> List[Dict[str, torch.Tensor]]:
    """Each rank's frames: the i-th of the group's data rows (all of them;
    in a pod this process's, ``group.data_rows``) takes slice ``[i * B/rows,
    (i+1) * B/rows)`` of a ``[B, ...]`` batch, on the rank's device (the JAX
    package's ``P('data')``); ranks with one data coordinate and one device
    share the copy.  ``B`` must divide by the rows."""
    rows = group.data_rows
    B = next(iter(frames.values())).shape[0]
    if B % len(rows):
        raise ValueError(f"a batch of {B} frames does not split over {len(rows)} data ranks")
    b = B // len(rows)
    kept = {}
    out = []
    for r in range(group.n):
        i, dev = rows.index(group.axis_index(r, "data")), group.device(r)
        if (i, dev) not in kept:
            kept[(i, dev)] = {k: v[i * b : (i + 1) * b].to(dev) for k, v in frames.items()}
        out.append(kept[(i, dev)])
    return out


def replicate(state: ModelState, group) -> Dict[torch.device, ModelState]:
    """The state on every device of the group, once per device (the JAX
    package's ``replicate``); the device of ``state`` keeps it as it is."""
    home = next(state.params.parameters()).device
    return {d: state if d == home else state.to(d) for d in group.devices}


def spmd_gnn_config(model, topo: Topology, group):
    """The model's network config with the sharded path on (the JAX
    package's ``spmd_gnn_config``): the group as ``axis_name``, K7 where the
    plans carry overlap bands.  Sets with a plan run the fused kernels over
    their shards, every other set the sharded unfused aggregate.
    ``fused_bwd`` other than ``remat``, ``fused_pb`` and ``fused_fwd: xla``
    are ignored, ``fused_bwd`` and ``fused_pb`` with a warning from each
    fused call, as in the JAX package.  ``model.remat`` is ignored with a
    warning: a block's collectives cannot be run again from the backward,
    and remat changes no result, only the memory held."""
    cfg = model.gnn_config
    if cfg.remat:
        warnings.warn("model.remat: the sharded step keeps every block's activations (no recompute)",
                      stacklevel=2)
    return dataclasses.replace(cfg, axis_name=group, halo_overlap=True, remat=False)


def _device_topologies(topo: Topology, group) -> Dict[torch.device, Topology]:
    """The topology on every device of the group, once per device: its
    index arrays, mask and ``aux`` moved (the per-rank plans and sums stay
    where they lie, on their ranks' devices)."""
    out = {}
    for d in dict.fromkeys(group.devices):
        move = lambda t: None if t is None else t.to(d)
        aux = None if topo.aux is None else {k: move(v) for k, v in topo.aux.items()}
        out[d] = topo._replace(aux=aux, **{f: move(getattr(topo, f)) for f in (
            "senders", "receivers", "mask", "gather_idx", "gather_valid", "snd_gather_idx", "snd_gather_valid")})
    return out


def _rank_forward(model, mstate: ModelState, topo: Topology, frames, cfg, group, r: int, is_training: bool,
                  expansion=None, members=None, hyper_normal=None):
    """One rank's graph and output: the features of its frames over every
    edge and, with an expansion, its expansion over every node row (the
    normalizers accumulating the global batch), cut to its edge shard, and
    the network on it.  ``(out, target or None, normalizers)``."""
    from hyper_graph_nets_tpu_torch.parallel.halo import shard_graph

    with normalizer.reduce_partials(lambda x: group.all_reduce_plain(x, "sum", axis="data")):
        graph, _, mstate = model.make_graph(mstate, topo, frames, is_training)
        if expansion is not None:
            graph, mstate = expansion.expand(mstate, graph, frames, model, is_training=is_training,
                                             static=members, hyper_normal=hyper_normal)
        target = None
        if is_training:
            target, mstate = model.get_target(mstate, frames, is_training=True)
    out = network_apply(mstate.params, shard_graph(edge_shard_ties(graph, cfg), group, r), cfg)
    return out, target, mstate.normalizers


class _Sharded:
    """What the sharded step and forward share: the group, the config and
    the topology."""

    def __init__(self, model, topo: Topology, group, expansion):
        check_supported(model, expansion)
        if topo.layout is None:
            raise ValueError("topo must come from parallel.sharding.shard_topology")
        self.model, self.group, self.expansion, self.topo = model, group, expansion, topo
        self.cfg = spmd_gnn_config(model, topo, group)

    def laid_out(self, static) -> Optional[ShardedStatic]:
        """``static`` (the expansion's prepared one when None) laid out for
        the group, or a :class:`ShardedStatic` (:func:`shard_static`'s, made
        once per prepare by a caller that keeps it) as it is."""
        if self.expansion is None:
            return None
        if isinstance(static, ShardedStatic):
            return static
        static = self.expansion.static if static is None else static
        if any(s is None for s in static):
            raise RuntimeError("the expansion has no static: run expansion.prepare(model, frame0, topo) first")
        return shard_static(self.expansion, static, self.topo, self.group)

    def hyper_normals(self, frames, sstatic, hyper_normal, generator, rank_frames, global_size,
                      offset) -> List[Optional[torch.Tensor]]:
        """Each rank's slice of RMP's cluster-mean noise: the global
        ``[B, K, D]`` draw (drawn from ``generator`` after the field's, as
        the single-device step draws it, when not given), cut to this
        process's rows ``offset ..`` of the ``global_size`` (a pod's) and
        sliced as the frames are."""
        if self.expansion is None:
            return [None] * self.group.n
        shape = self.expansion.hyper_noise_shape(self.model, frames, sstatic.members)
        if shape is None:
            return [None] * self.group.n
        x = frames[self.model.field]
        if hyper_normal is None:
            shape = (global_size,) + tuple(shape[1:])
            hyper_normal = torch.randn(shape, generator=generator, device=x.device, dtype=torch.float32)
        hyper_normal = hyper_normal[offset : offset + x.shape[0]]
        rows = self.group.data_rows
        b = x.shape[0] // len(rows)
        return [hyper_normal[i * b : (i + 1) * b].to(fr[self.model.field].device)
                for i, fr in ((rows.index(self.group.axis_index(r, "data")), rank_frames[r])
                              for r in range(self.group.n))]


class SpmdTrainStep(_Sharded):
    """The sharded train step of :func:`make_spmd_train_step`:
    ``step(tstate, frames, normal=None, generator=None, static=None,
    hyper_normal=None) -> (tstate, loss)``, and :meth:`loss_and_grads`, its
    loss and backward without the update (``Trainer.train_step``'s
    arguments).  ``frames`` is the global ``[B, ...]`` batch on any device
    (in a pod: this process's ``[B_local, ...]`` rows, ``B_local *
    group.process ..`` of the global batch);
    ``normal`` the global standard-normal draw ``[B, N, D]`` and
    ``hyper_normal`` RMP's ``[B, K, D]`` (each drawn from ``generator`` on
    the trainer's device when omitted, the field's first), sliced per data
    rank, so the step sees the single-device step's noise; ``static`` the
    expansion's prepared static (its cached one when omitted), laid out for
    the group on each call, or :func:`shard_static`'s :class:`ShardedStatic`
    of it, laid out once by the caller.  Each step
    joins every rank's thread and raises the first error of any rank.

    ``copies`` maps each device of the group other than rank 0's to the
    step's copy of the parameters there (empty on one device): the copies
    are made at the first call, refreshed in place from the state's
    parameters at the start of every call and after Adam, and hold their
    device's gradient (before the sum) until the next call."""

    def __init__(self, trainer, topo: Topology, group, expansion=None):
        super().__init__(trainer.model, topo, group, expansion)
        self.trainer = trainer
        self.home = group.device(0)
        self.topos = _device_topologies(topo, group)
        self.copies: Dict[torch.device, torch.nn.Module] = {}

    def _noisy_frames(self, frames, normal, generator, global_size, offset):
        """The field's training noise: the global ``[B, N, D]`` draw (from
        ``generator`` when not given) at this process's rows."""
        model = self.model
        if model.noise_scale is None:
            return frames
        x = frames[model.field]
        if normal is None:
            shape = (global_size,) + tuple(x.shape[1:])
            normal = torch.randn(shape, generator=generator, device=x.device, dtype=x.dtype)
        normal = normal[offset : offset + x.shape[0]].to(x.device)
        return add_noise(frames, model.field, model.noise_scale, model.noise_gamma, normal)

    def _params_per_device(self, params) -> Dict[torch.device, torch.nn.Module]:
        """The parameters on every device of the group, rank 0's device
        first, the others in the order they first appear: the state's own
        on rank 0's, on every other the step's copy (made by copying at the
        first call), refreshed from them, its gradients cleared."""
        out = {self.home: params}
        for d in dict.fromkeys(self.group.devices):
            if d == self.home:
                continue
            if d in self.copies:
                _refresh(self.copies[d], params)
            else:
                self.copies[d] = copy.deepcopy(params).to(d)
            self.copies[d].zero_grad(set_to_none=True)
            out[d] = self.copies[d]
        return out

    def _sum_over_devices(self, params, per_device) -> None:
        """Each copy's gradient brought to rank 0's device and added to the
        state's parameters' gradient, the devices in ``per_device``'s order
        (rank 0's first): the same bits on every run."""
        copies = [m for d, m in per_device.items() if d != self.home]
        for p, *kept in zip(params.parameters(), *(m.parameters() for m in copies)):
            for c in kept:
                if c.grad is None:
                    continue
                if p.grad is None:
                    p.grad = c.grad.to(p.device, copy=True)
                else:
                    p.grad.add_(c.grad.to(p.device))

    def loss_and_grads(self, tstate, frames, normal=None, generator=None, static=None, hyper_normal=None):
        """Noise, loss and backward of one step: returns the loss and the new
        normalizer states, and leaves each parameter's gradient (summed over
        every rank, every device and, in a pod, every process) in its
        ``.grad``."""
        group, model = self.group, self.model
        params = tstate.model.params
        params.zero_grad(set_to_none=True)
        per_device = self._params_per_device(params)
        norms = tstate.model.normalizers
        states = {d: ModelState(params=p, normalizers=norms if d == self.home else {
            k: v.to(d) for k, v in norms.items()}) for d, p in per_device.items()}
        rows = group.data_rows
        b = frames[model.field].shape[0] // len(rows)  # B_row; shard_frames checks that it divides
        global_size, offset = b * group.shape["data"], b * rows[0]
        frames = self._noisy_frames(frames, normal, generator, global_size, offset)
        rank_frames = shard_frames(frames, group)
        sstatic = self.laid_out(static)
        topos = self.topos if sstatic is None else _device_topologies(sstatic.topo, group)
        members = None if sstatic is None else sstatic.members
        hyper = self.hyper_normals(frames, sstatic, hyper_normal, generator, rank_frames, global_size, offset)

        def rank_fn(r):
            dev = group.device(r)
            fr = rank_frames[r]
            out, target, norms = _rank_forward(model, states[dev], topos[dev], fr, self.cfg, group, r, True,
                                               self.expansion, members, hyper[r])
            mask = model.loss_mask(fr["node_type"]).to(out.dtype)[..., None]
            count = group.all_reduce_plain((mask.sum() * out.shape[-1]).reshape(1), "sum", axis="data")
            return ((target - out).square() * mask).sum() / count[0], norms

        results = group.run(rank_fn)
        # each row's first graph rank's loss; a row whose first graph rank
        # is another process's: one of this process's ranks' losses with a
        # zero cotangent, so that its nodes run and join the row's sums
        roots, cotangents, losses = [], [], {}
        for d, r in row_firsts(group).items():
            x = results[r][0]
            first = group.axis_index(r, "graph") == 0
            roots.append(x)
            cotangents.append(torch.ones_like(x) if first else torch.zeros_like(x))
            if first:
                losses[d] = x.detach()
        torch.autograd.backward(roots, cotangents)
        if group.processes > 1:
            return self._sum_over_processes(params, per_device, losses), results[0][1]
        self._sum_over_devices(params, per_device)
        loss = None
        for x in losses.values():
            loss = x if loss is None else loss + x.to(loss.device)
        return loss, results[0][1]

    def _sum_over_processes(self, params, per_device, losses) -> torch.Tensor:
        """The pod's gradient sum: every device's gradients of every process
        (each process's in ``per_device``'s order, padded to
        ``group.per_process`` devices) gathered over the process group
        (:meth:`RankGroup.gather_processes`) and folded in global order into
        the state's parameters' gradients, as :meth:`_sum_over_devices`
        folds one process's; a device without a parameter's gradient adds
        nothing.  The loss: each row's, from the process holding its first
        graph rank, summed in row order.  The same bits in every process."""
        group = self.group
        D = group.shape["data"]
        plist = list(params.parameters())
        home = self.home
        rows = []
        for i, m in enumerate(per_device.values()):
            grads = [q.grad for q in m.parameters()]
            head = torch.zeros(D + len(plist), dtype=torch.float32)
            if i == 0:
                for d, x in losses.items():
                    head[d] = x.float().cpu()
            head[D:] = torch.tensor([g is not None for g in grads], dtype=torch.float32)
            rows.append(torch.cat([head.to(home)] + [
                torch.zeros(q.numel(), device=home) if g is None else g.detach().reshape(-1).float().to(home)
                for q, g in zip(plist, grads)]))
        x = torch.stack(rows)
        if len(rows) < group.per_process:
            x = torch.cat([x, x.new_zeros(group.per_process - len(rows), x.shape[1])])
        parts = [part for got in group.gather_processes(x) for part in got.unbind(0)]
        heads = torch.stack([part[: D + len(plist)] for part in parts]).cpu()
        owner = lambda d: d * group.shape["graph"] // group.per_process
        loss = None
        for d in range(D):
            row_loss = heads[group.per_process * owner(d)][d]
            loss = row_loss if loss is None else loss + row_loss
        at = D + len(plist)
        for j, p in enumerate(plist):
            acc = None
            for i, part in enumerate(parts):
                if heads[i][D + j] > 0:
                    seg = part[at : at + p.numel()]
                    acc = seg.clone() if acc is None else acc + seg
            at += p.numel()
            if acc is not None:
                p.grad = acc.view_as(p).to(device=p.device, dtype=p.dtype)
        return loss.to(home)

    def __call__(self, tstate, frames, normal=None, generator=None, static=None, hyper_normal=None):
        loss, normalizers = self.loss_and_grads(tstate, frames, normal, generator, static, hyper_normal)
        for grp in tstate.opt_state.param_groups:
            grp["lr"] = self.trainer.learning_rate(tstate.step)
        tstate.opt_state.step()
        for kept in self.copies.values():  # the new parameters on every device
            _refresh(kept, tstate.model.params)
        new_model = tstate.model.replace(normalizers=normalizers)
        return TrainState(model=new_model, opt_state=tstate.opt_state, step=tstate.step + 1), loss


def _refresh(kept: torch.nn.Module, params: torch.nn.Module) -> None:
    """``kept``'s parameters set in place to ``params``' (on their own
    device)."""
    with torch.no_grad():
        for a, b in zip(kept.parameters(), params.parameters()):
            a.copy_(b)


def row_firsts(group) -> Dict[int, int]:
    """Each of the group's data rows (in a pod, this process's) and the
    first of its ranks that this process holds, in row order: every rank of
    a row computes the row's output."""
    firsts: Dict[int, int] = {}
    for r in range(group.n):
        firsts.setdefault(group.axis_index(r, "data"), r)
    return dict(sorted(firsts.items()))


def make_spmd_train_step(trainer, topo: Topology, group, expansion=None) -> SpmdTrainStep:
    """A sharded train step: frames over ``data``, each graph's edges over
    ``graph``, one global loss (the JAX package's ``make_spmd_train_step``,
    ``sharding.py:236-315``).  ``topo`` comes from :func:`shard_topology`
    on the same group; the trainer's device is rank 0's.  ``expansion``
    defaults to the trainer's (``trainer.expansion``: the configured graph
    balancer and RMP).  Runs on the card unless the group was built with
    ``device="cpu"``."""
    return SpmdTrainStep(trainer, topo, group, trainer.expansion if expansion is None else expansion)


def make_sharded_forward(model, topo: Topology, group, expansion=None):
    """``fn(mstate, frames, static=None) -> [B, N, out]``: the edge-sharded
    forward of a ``[B, ...]`` batch (the JAX package's
    ``make_sharded_forward``), each data rank's frames over its graph
    ranks' edge shards, with the expansion (a model configured with one
    needs it) and its static as the step takes them; the outputs of every
    data row's first graph rank, concatenated in data order, on the state's
    device (in a pod, given this process's rows: their outputs)."""
    sharded = _Sharded(model, topo, group, expansion)
    topos = _device_topologies(topo, group)

    def fwd(mstate: ModelState, frames: Dict[str, torch.Tensor], static=None) -> torch.Tensor:
        states = replicate(mstate, group)
        rank_frames = shard_frames(frames, group)
        sstatic = sharded.laid_out(static)
        members = None if sstatic is None else sstatic.members
        rank_topos = topos if sstatic is None else _device_topologies(sstatic.topo, group)

        def rank_fn(r):
            with torch.no_grad():  # grad mode is per thread
                dev = group.device(r)
                return _rank_forward(model, states[dev], rank_topos[dev], rank_frames[r], sharded.cfg, group, r,
                                     False, expansion, members)[0]

        outs = group.run(rank_fn)
        group.check()
        home = next(mstate.params.parameters()).device
        return torch.cat([outs[r].to(home) for r in row_firsts(group).values()])

    return fwd
