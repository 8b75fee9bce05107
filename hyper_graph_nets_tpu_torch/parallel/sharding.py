"""Data x graph sharding over a rank group: the sharded train step.

Counterpart of ``hyper_graph_nets_tpu/parallel/sharding.py``.  A
``parallel.group.RankGroup(data, graph)`` stands for the JAX package's
``('data', 'graph')`` mesh (``make_mesh``): frames split over ``data``, each
graph's edges over ``graph`` (:func:`shard_topology`: padded to a multiple
of the axis and cut into contiguous slices, or dealt round-robin by chunks
for K7), node rows on every rank.

:func:`make_spmd_train_step` is the JAX package's ``make_spmd_train_step``
with ``agg_vjp: fused``: the single-device step's noise, loss and Adam
update over the global batch, each rank running the network on its data
rank's frames and its graph rank's edges in its own thread
(``RankGroup.run``).  Where the JAX package lets XLA partition one global
program, the port places each collective itself:

- the normalizers accumulate the global batch: every accumulation's partial
  sums are all-reduced over the ``data`` ranks, in rank order
  (``core.normalizer.reduce_partials``; each rank computes its frames'
  features over every edge, so no ``graph`` reduction is needed);
- each fused block runs K1 unfinalized on the shard and the plain
  all-reduce along ``graph``, or K7 (``ops.fused_block.fused_edge_block_spmd``);
  under autograd each data row's shards meet in one node, whose backward
  runs K2 on every shard against the global aggregate at the global degree;
- the loss divides by the global mask sum; only each data row's first graph
  rank's loss is differentiated, and every rank's parameter gradients (its
  own copy of the node side, its shard of the edge side) add up to the
  single-device gradient; the ranks share the device's parameters, so
  their gradients sum in place;
- one Adam step on the summed gradients.

Every rank of the step's group lies on one device (the one card, or the
CPU): a group over several cards needs parameters kept identical across
them, which is not ported yet (ROADMAP queue 1, item 7), and raises.

Use::

    group = RankGroup(2, 2)                               # data 2 x graph 2
    stopo = shard_topology(topo, group)                   # overlap_bands=4: K7
    step = make_spmd_train_step(trainer, stopo, group)
    tstate, loss = step(tstate, frames)                   # frames [B, ...], B % 2 == 0

An expansion (remote message passing, the graph balancer), an ``agg_vjp``
other than ``fused``, a group over several devices and
``parallel/multihost.py``'s processes are not ported yet (ROADMAP queue 1,
item 7).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core import normalizer
from hyper_graph_nets_tpu_torch.core.segment_ops import EdgeSums
from hyper_graph_nets_tpu_torch.models.base import ModelState, Topology
from hyper_graph_nets_tpu_torch.nn.meshgraphnet import network_apply
from hyper_graph_nets_tpu_torch.ops.fused_block import SegmentPlan, plan_segments
from hyper_graph_nets_tpu_torch.ops.fused_overlap import chunk_roundrobin_permutation, overlap_plan
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
    coordinate and a device share one plan."""

    plans: Tuple[SegmentPlan, ...]


@dataclasses.dataclass(frozen=True)
class RankSums:
    """The fixed-order sums of an edge-sharded set: ``sums[r]`` is rank r's
    :class:`EdgeSums` over its graph rank's slice (indices local to the
    slice), on its device; the unfused sets' local partials sum through
    them."""

    sums: Tuple[EdgeSums, ...]


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


def shard_topology(
    topo: Topology,
    group,
    overlap_bands: Optional[int] = None,
    chunk: int = DEFAULT_CHUNK,
) -> Topology:
    """Pad the edges to a multiple of the group's ``graph`` axis and plan
    each graph rank's slice.

    Padding edges have receiver ``num_nodes - 1`` (receivers stay sorted),
    sender 0 and mask 0.  With a fused topology (its plan a
    :class:`SegmentPlan`) the result's plan is a :class:`RankPlans`, each
    plan carrying the set's global in-degree.  ``overlap_bands`` (fused
    only) pads to ``chunk * graph`` and deals the chunks round-robin
    (``ops.fused_overlap.chunk_roundrobin_permutation``), so every rank's
    slice spans all receivers, and its plans carry that many bands and K7's
    work list (``ops.fused_overlap.overlap_plan``).
    The result lies on rank 0's device and has no neighbour matrices (they
    index global edge ids); its ``sums`` are a :class:`RankSums`, each
    rank's fixed-order sums over its slice, built here on the host once per
    topology; ``halo.split_graph`` gives each rank its slice.  A topology
    with masked edges raises.
    """
    g = group.shape["graph"]
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
    degree = torch.from_numpy(
        np.bincount(rcv[:n_valid], minlength=topo.num_nodes).astype(np.float32)
    )
    if use_overlap:
        perm = chunk_roundrobin_permutation(len(snd), g, chunk)
        snd, rcv, mask = snd[perm], rcv[perm], mask[perm]
    per = len(snd) // g
    shard = lambda k: slice(k * per, (k + 1) * per)
    rank_sums = RankSums(
        _per_rank(group, lambda k: EdgeSums.build(snd[shard(k)], rcv[shard(k)], topo.num_nodes))
    )

    def plan_of(k):
        if use_overlap:
            plan = overlap_plan(rcv[shard(k)], mask[shard(k)], topo.num_nodes, overlap_bands,
                                senders=snd[shard(k)])
        else:
            plan = plan_segments(rcv[shard(k)], topo.num_nodes, senders=snd[shard(k)])
        return dataclasses.replace(plan, degree=degree)

    dev = group.device(0)
    return Topology(
        senders=torch.from_numpy(snd).to(dev),
        receivers=torch.from_numpy(rcv).to(dev),
        num_nodes=topo.num_nodes,
        mask=torch.from_numpy(mask).to(dev),
        plan=RankPlans(_per_rank(group, plan_of)) if plans else None,
        sums=rank_sums,
        aux=topo.aux,
        world_cap=topo.world_cap,
    )


def shard_frames(frames: Dict[str, torch.Tensor], group) -> List[Dict[str, torch.Tensor]]:
    """Each rank's frames: data rank d's slice ``[d * B/data, (d+1) *
    B/data)`` of a ``[B, ...]`` batch, on the rank's device (the JAX
    package's ``P('data')``); ranks with one data coordinate and one device
    share the copy.  ``B`` must divide by the ``data`` axis."""
    D = group.shape["data"]
    B = next(iter(frames.values())).shape[0]
    if B % D:
        raise ValueError(f"a batch of {B} frames does not split over {D} data ranks")
    b = B // D
    kept = {}
    out = []
    for r in range(group.n):
        d, dev = group.axis_index(r, "data"), group.device(r)
        if (d, dev) not in kept:
            kept[(d, dev)] = {k: v[d * b : (d + 1) * b].to(dev) for k, v in frames.items()}
        out.append(kept[(d, dev)])
    return out


def replicate(state: ModelState, group) -> Dict[torch.device, ModelState]:
    """The state on every device of the group, once per device (the JAX
    package's ``replicate``); the device of ``state`` keeps it as it is."""
    home = next(state.params.parameters()).device
    return {d: state if d == home else state.to(d) for d in group.devices}


def spmd_gnn_config(model, topo: Topology, group):
    """The model's network config with the sharded fused path on (the JAX
    package's ``spmd_gnn_config``): the group as ``axis_name``, K7 where the
    plans carry overlap bands.  The sharded step runs every edge set fused:
    an ``agg_vjp`` other than ``fused``, or a topology without plans, raises
    ``NotImplementedError``.  ``fused_bwd`` other than ``remat`` is
    ignored with a warning, as in the JAX package."""
    cfg = model.gnn_config
    if cfg.agg_vjp != "fused":
        raise NotImplementedError(f"agg_vjp {cfg.agg_vjp!r} {NOT_PORTED}")
    if not isinstance(topo.plan, RankPlans):
        raise NotImplementedError(
            f"a sharded topology without kernel plans (no band plan for this mesh) {NOT_PORTED}"
        )
    if cfg.fused_bwd != "remat":
        warnings.warn(
            "fused_bwd applies only to the single-device path; the sharded step runs the remat "
            "backward (K2)",
            stacklevel=3,
        )
    return dataclasses.replace(cfg, axis_name=group, halo_overlap=True)


def _check_no_expansion(model, expansion) -> None:
    if expansion is not None or model.use_rmp or model.use_balancer:
        raise NotImplementedError(f"an expansion (remote message passing, the graph balancer) {NOT_PORTED}")


def _device_topologies(topo: Topology, group) -> Dict[torch.device, Topology]:
    return {
        d: topo._replace(senders=topo.senders.to(d), receivers=topo.receivers.to(d), mask=topo.mask.to(d))
        for d in set(group.devices)
    }


def _rank_forward(model, mstate: ModelState, topo: Topology, frames, cfg, group, r: int, is_training: bool):
    """One rank's graph and output: the features of its frames over every
    edge (the normalizers accumulating the global batch), cut to its edge
    shard, and the network on it.  ``(out, target or None, normalizers)``."""
    from hyper_graph_nets_tpu_torch.parallel.halo import shard_graph

    with normalizer.reduce_partials(lambda x: group.all_reduce_plain(x, "sum", axis="data")):
        graph, _, mstate = model.make_graph(mstate, topo, frames, is_training)
        target = None
        if is_training:
            target, mstate = model.get_target(mstate, frames, is_training=True)
    out = network_apply(mstate.params, shard_graph(graph, group, r), cfg)
    return out, target, mstate.normalizers


class SpmdTrainStep:
    """The sharded train step of :func:`make_spmd_train_step`:
    ``step(tstate, frames, normal=None, generator=None) -> (tstate, loss)``,
    and :meth:`loss_and_grads`, its loss and backward without the update.
    ``frames`` is the global ``[B, ...]`` batch on any device; ``normal``
    the global standard-normal draw ``[B, N, D]`` (drawn from ``generator``
    on the trainer's device when omitted), sliced per data rank, so the
    step sees the single-device step's noise.  Each step joins every rank's
    thread and raises the first error of any rank."""

    def __init__(self, trainer, topo: Topology, group):
        if len(set(group.devices)) > 1:
            raise NotImplementedError(f"a sharded step over several devices {NOT_PORTED}")
        self.trainer, self.model, self.group = trainer, trainer.model, group
        self.cfg = spmd_gnn_config(self.model, topo, group)
        self.topo = _device_topologies(topo, group)[group.device(0)]

    def _noisy_frames(self, frames, normal, generator):
        model = self.model
        if model.noise_scale is None:
            return frames
        x = frames[model.field]
        if normal is None:
            normal = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        return add_noise(frames, model.field, model.noise_scale, model.noise_gamma, normal.to(x.device))

    def loss_and_grads(self, tstate, frames, normal=None, generator=None):
        """Noise, loss and backward of one step: returns the loss and the new
        normalizer states, and leaves each parameter's gradient (summed over
        every rank) in its ``.grad``."""
        group, model = self.group, self.model
        params = tstate.model.params
        params.zero_grad(set_to_none=True)
        rank_frames = shard_frames(self._noisy_frames(frames, normal, generator), group)

        def rank_fn(r):
            mstate = ModelState(params=params, normalizers=tstate.model.normalizers)
            fr = rank_frames[r]
            out, target, norms = _rank_forward(model, mstate, self.topo, fr, self.cfg, group, r, True)
            mask = model.loss_mask(fr["node_type"]).to(out.dtype)[..., None]
            count = group.all_reduce_plain((mask.sum() * out.shape[-1]).reshape(1), "sum", axis="data")
            return ((target - out).square() * mask).sum() / count[0], norms

        results = group.run(rank_fn)
        firsts = [results[group.rank_at(d, 0)][0] for d in range(group.shape["data"])]
        torch.autograd.backward(firsts)
        loss = firsts[0].detach()
        for x in firsts[1:]:
            loss = loss + x.detach()
        return loss, results[0][1]

    def __call__(self, tstate, frames, normal=None, generator=None):
        loss, normalizers = self.loss_and_grads(tstate, frames, normal, generator)
        for grp in tstate.opt_state.param_groups:
            grp["lr"] = self.trainer.learning_rate(tstate.step)
        tstate.opt_state.step()
        new_model = tstate.model.replace(normalizers=normalizers)
        return TrainState(model=new_model, opt_state=tstate.opt_state, step=tstate.step + 1), loss


def make_spmd_train_step(trainer, topo: Topology, group, expansion=None) -> SpmdTrainStep:
    """A sharded train step: frames over ``data``, each graph's edges over
    ``graph``, one global loss (the JAX package's ``make_spmd_train_step``,
    ``sharding.py:236-315``).  ``topo`` comes from :func:`shard_topology`
    on the same group; the trainer's device is rank 0's.  Runs on the card
    unless the group was built with ``device="cpu"``.  ``expansion`` (and a
    model configured with one) raises ``NotImplementedError``."""
    _check_no_expansion(trainer.model, expansion)
    return SpmdTrainStep(trainer, topo, group)


def make_sharded_forward(model, topo: Topology, group, expansion=None):
    """``fn(mstate, frames) -> [B, N, out]``: the edge-sharded forward of a
    ``[B, ...]`` batch (the JAX package's ``make_sharded_forward``), each
    data rank's frames over its graph ranks' edge shards; the outputs of
    every data row's first graph rank, concatenated in data order, on the
    state's device."""
    _check_no_expansion(model, expansion)
    cfg = spmd_gnn_config(model, topo, group)
    topos = _device_topologies(topo, group)

    def fwd(mstate: ModelState, frames: Dict[str, torch.Tensor]) -> torch.Tensor:
        states = replicate(mstate, group)
        rank_frames = shard_frames(frames, group)

        def rank_fn(r):
            with torch.no_grad():  # grad mode is per thread
                dev = group.device(r)
                return _rank_forward(model, states[dev], topos[dev], rank_frames[r], cfg, group, r, False)[0]

        outs = group.run(rank_fn)
        group.check()
        home = next(mstate.params.parameters()).device
        return torch.cat([outs[group.rank_at(d, 0)].to(home) for d in range(group.shape["data"])])

    return fwd
