"""Fused edge block with a compute-overlapped banded ring (K7).

Counterpart of ``hyper_graph_nets_tpu/ops/pallas/fused_overlap.py``
(``fused_edge_block_collective_overlap`` over ``_overlap_kernel``, and its
batched core ``_overlap_fwd_call``).  Each rank of a
``parallel.group.RankGroup`` holds one edge shard of ``[E, L]`` (one frame)
or ``[B, E, L]`` (B frames) features; one kernel per rank computes the
shard's ``e2`` (K1's) and its raw pna partials, and combines the partials
over the ranks of its sub-ring along ``graph`` band by band while later
receiver groups still compute, one ring pass per frame; the result is
finalized: ``agg = [sum | mean | max | min]`` float32 ``[..., N, 4L]``, 0
where no rank has a valid edge.

The node rows split into ``plan.overlap_bands`` bands, each split again so
that about half of a rank's CTAs ring (``ring_ctas``, ``band_rows``); with
the chunk round-robin edge layout (:func:`chunk_roundrobin_permutation`,
used by ``parallel.sharding.shard_topology``) every rank's shard spans all
rows in receiver order, so early bands finish first.  The kernel keeps a
counter of finished groups per band on the card, so it needs no host-built
schedule (the JAX package's ``build_overlap_schedule``); its work list
(:class:`OverlapWork`: the groups of the shard's valid prefix, then the
padded tail as e2-only items) is built on the host with the plan
(:func:`overlap_plan`).

On CUDA tensors :func:`fused_edge_block_overlap` checks and allocates
everything first, then launches K7 (``csrc/fused_overlap.cu``) on every
rank by one C call, each rank's kernel on its card and stream
(``fused_edge_block_overlap.launches``, one per rank).  On CPU tensors it
runs the plain version: K1's plain version in raw mode per rank, K6's plain
version over the columns ``[0, 2L)`` sum, ``[2L, 3L)`` max, ``[3L, 4L)``
min, then the finalize.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core import segment_ops
from hyper_graph_nets_tpu_torch.ops import fused_block as fb
from hyper_graph_nets_tpu_torch.ops import ring
from hyper_graph_nets_tpu_torch.parallel.group import MAX_BANDS

SOURCE = "fused_overlap.cu"

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_POINTERS = ("e", "sp", "rp", "we", "w2", "w3", "b1", "b2", "b3", "lns", "lnb", "senders", "receivers",
             "mask", "row_ptr", "groups", "group_edges", "e2", "agg")


class OvRank(ctypes.Structure):
    """One rank's entry of ``hgn_fused_overlap_group`` (``csrc/fused_overlap.cu``)."""

    _fields_ = (
        [(name, _vp) for name in _POINTERS]
        + [("E", _ci), ("G", _ci), ("grid", _ci)]
        + [(name, _vp) for name in ("flags_mine", "flags_left", "flags_right", "slot_mine", "slot_right",
                                    "counters")]
        + [("device", _ci), ("stream", _vp)]
    )


_SIGNATURES = {
    "hgn_fused_overlap_group": [_ci, _ci, _ci, _ci, _ci, _vp, _ci, _ci, _ci, ctypes.c_ulonglong, _vp],
    "hgn_cuda_error_string": [_ci],
}


def _lib(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """K7's library (with ``defines``: ``ring.RING_PHASES``, the probe)."""
    return ring._lib(SOURCE, defines, _SIGNATURES)


def chunk_roundrobin_permutation(n_edges_padded: int, num_shards: int, chunk: int) -> np.ndarray:
    """Edge permutation that deals the padded, receiver-sorted edge list's
    chunks round-robin: shard s takes global chunks s, s + S, s + 2S, ...
    (the JAX package's ``chunk_roundrobin_permutation``,
    ``fused_overlap.py:115-142``).  Every shard then walks the whole
    receiver range, receivers stay sorted within each shard and its valid
    edges stay a prefix."""
    if n_edges_padded % (chunk * num_shards):
        raise ValueError(
            f"padded edge count {n_edges_padded} must divide into "
            f"chunk*num_shards = {chunk * num_shards}"
        )
    n_chunks = n_edges_padded // chunk
    order = np.concatenate([np.arange(s, n_chunks, num_shards) for s in range(num_shards)])
    return (order[:, None] * chunk + np.arange(chunk)[None, :]).reshape(-1)


@dataclasses.dataclass(frozen=True)
class OverlapWork:
    """K7's work list for one rank's shard.  The valid prefix is the edges
    up to the last one with a mask above 0 (in the round-robin layout, every
    valid edge), the tail the masked edges after it (the padding).  Items
    ``g < num_groups`` are the valid prefix's groups (``plan_segments`` of
    it), the others the tail in pieces of at most ``TILE`` edges:
    ``groups[g]:groups[g+1]`` are item g's receivers (none for a tail item:
    both are N), ``group_edges[g]:group_edges[g+1]`` its edges, and
    ``row_ptr`` [N + 1] the valid prefix's receiver segments.  A tail item
    writes e2 and no aggregate row, and no band waits for it."""

    row_ptr: torch.Tensor  # [N + 1] int32
    groups: torch.Tensor  # [items + 1] int32
    group_edges: torch.Tensor  # [items + 1] int32
    num_valid: int
    num_groups: int

    @property
    def num_items(self) -> int:
        return self.groups.shape[0] - 1

    def to(self, device) -> "OverlapWork":
        return dataclasses.replace(
            self, row_ptr=self.row_ptr.to(device), groups=self.groups.to(device),
            group_edges=self.group_edges.to(device),
        )


def overlap_work(receivers, mask, num_nodes: int) -> OverlapWork:
    """Host: :class:`OverlapWork` of a receiver-sorted shard (``mask`` None:
    every edge valid)."""
    rcv = fb._host_ids(receivers, num_nodes, "receivers")
    E = rcv.size
    m = np.ones(E, np.float32) if mask is None else np.asarray(
        mask.cpu() if isinstance(mask, torch.Tensor) else mask, np.float32)
    valid = np.flatnonzero(m > 0)
    nv = int(valid[-1]) + 1 if valid.size else 0
    plan = fb.plan_segments(rcv[:nv], num_nodes)
    tail_ends = np.minimum(nv + fb.TILE * np.arange(1, -(-(E - nv) // fb.TILE) + 1), E)
    as_i32 = lambda *parts: torch.from_numpy(np.concatenate(parts).astype(np.int32))
    return OverlapWork(
        row_ptr=plan.row_ptr,
        groups=as_i32(plan.groups.numpy(), np.full(tail_ends.size, num_nodes)),
        group_edges=as_i32(plan.group_edges.numpy(), tail_ends),
        num_valid=nv,
        num_groups=plan.num_groups,
    )


def overlap_plan(receivers, mask, num_nodes: int, bands: int, senders=None) -> fb.SegmentPlan:
    """Host: the :class:`SegmentPlan` of one rank's shard for K7:
    ``plan_segments`` of the shard (K1 raw runs on it too) with
    ``overlap_bands`` and K7's work list (``plan.overlap``)."""
    return dataclasses.replace(
        fb.plan_segments(receivers, num_nodes, senders=senders),
        overlap_bands=int(bands), overlap=overlap_work(receivers, mask, num_nodes),
    )


def band_rows(num_nodes: int, bands: int) -> int:
    """Rows per band: the node rows split into ``bands`` bands, the last one
    shorter."""
    return -(-num_nodes // bands)


def ring_ctas(bands: int, grid: int) -> int:
    """Ring CTAs of one rank's K7 launch of ``grid`` CTAs: each of the
    ``bands`` bands split into as many sub-bands (each its own ring CTA, its
    own completion count) as leave about half the CTAs ringing and half
    computing."""
    if not 1 <= bands <= MAX_BANDS:
        raise ValueError(f"1 to {MAX_BANDS} bands, got {bands}")
    if grid < bands + 1:
        raise ValueError(f"{grid} CTAs per rank leave none to compute beside {bands} band rings")
    return bands * max(1, min(grid // (2 * bands), MAX_BANDS // bands))


def _column_segments(L: int) -> List[Tuple[int, int, str]]:
    return [(0, 2 * L, "sum"), (2 * L, 3 * L, "max"), (3 * L, 4 * L, "min")]


def fused_edge_block_overlap_reference(shards: Sequence[dict], num_nodes: int, group=None):
    """Plain K7 over every rank's shard: ``[(e2, agg), ...]``.  A shard is
    the keyword arguments of one rank: ``e [E, L]`` or ``[B, E, L]``,
    ``sp``, ``rp`` ``[..., N, L]``, ``weights``, ``senders``, ``receivers``,
    ``mask``.  The ranks ring along ``graph`` of ``group`` (without one,
    every shard on one ring); each frame folds on its own."""
    raws, e2s = [], []
    for x in shards:
        e2, raw = fb.fused_edge_block_reference(
            x["e"], x["sp"], x["rp"], x["weights"], x["senders"], x["receivers"], x["mask"],
            num_nodes, raw=True,
        )
        e2s.append(e2)
        raws.append(raw)
    L = shards[0]["e"].shape[-1]
    frames = [r.reshape(-1, num_nodes, 4 * L) for r in raws]  # [B or 1, N, 4L]
    aggs = [[None] * f.shape[0] for f in frames]
    for b in range(frames[0].shape[0]):
        # the column segments of [N, 4L] are the row segments of its transpose
        folded = ring.ring_all_reduce_segments_reference(
            [f[b].T.contiguous() for f in frames], _column_segments(L), group
        )
        for r, f in enumerate(folded):
            aggs[r][b] = segment_ops.finalize_partials(f.T)
    return [(e2, torch.stack(a).reshape(raw.shape)) for e2, a, raw in zip(e2s, aggs, raws)]


def fused_edge_block_overlap(shards: Sequence[dict], num_nodes: int, group, bands: int, lib=None):
    """K7 over every rank's shard (the list of the ranks' keyword arguments,
    see :func:`fused_edge_block_overlap_reference`; ``plan`` also, on the
    card), each ready on its rank's stream: ``[(e2, agg), ...]``, each on
    its rank's stream; the ranks ring along ``graph`` (``lib``: a probe
    build of K7).  On a ``graph`` row that spans processes it raises
    (ROADMAP entry 7.4c)."""
    group.check_ring("the overlapped block (K7)")
    if len(shards) != group.n:
        raise ValueError(f"{len(shards)} shards for a group of {group.n}")
    if shards[0]["e"].device.type == "cpu":
        return fused_edge_block_overlap_reference(shards, num_nodes, group)
    lib = lib or _lib()
    L = shards[0]["e"].shape[-1]
    batched = shards[0]["e"].dim() == 3
    B = shards[0]["e"].shape[0] if batched else 1
    grid = min(group.ctas_per_rank(r) for r in range(group.n))
    nb = ring_ctas(bands, grid)
    rb = band_rows(num_nodes, nb)
    state = group.ring_state("k7", num_nodes * 4 * L, counters=B * nb)
    err = ring.device_error_word(group)
    ranks, outs, alive = ring.rank_table(group, state, OvRank), [], []
    for r, x in enumerate(shards):  # every check and output first: nothing between the launches
        e = x["e"]
        dev = group.device(r)
        fb._check(e.dim() == shards[0]["e"].dim() and (not batched or e.shape[0] == B) and e.device == dev,
                  f"rank {r}: e must be [E, L] or [{B}, E, L], as rank 0's, on {dev}")
        e3 = e if batched else e[None]
        nodes = {k: x[k] if batched else x[k][None] for k in ("sp", "rp")}
        with torch.cuda.device(dev), torch.cuda.stream(group.stream(r)):
            plan = fb._resolve_plan(x.get("plan"), x["senders"], x["receivers"], num_nodes, dev)
            fb._validate(e3, nodes, x["senders"], x["receivers"], x["mask"], num_nodes, plan)
            # a plan without K7's work list (not from overlap_plan): built here, reading the shard back
            work = plan.overlap or overlap_work(x["receivers"], x["mask"], num_nodes).to(dev)
            w, p = fb._kernel_weights(x["weights"], e.dtype, L, dev)
            e2 = torch.empty_like(e)
            agg = torch.empty(e.shape[:-2] + (num_nodes, 4 * L), dtype=torch.float32, device=dev)
        tensors = dict(e=e, sp=x["sp"], rp=x["rp"], senders=x["senders"], receivers=x["receivers"],
                       mask=x["mask"], row_ptr=work.row_ptr, groups=work.groups,
                       group_edges=work.group_edges, e2=e2, agg=agg, **w, **p)
        entry = ranks[r]
        for k in _POINTERS:
            setattr(entry, k, fb._ptr(tensors[k]))
        # nb band rings and, as K1 does, a compute CTA for every two work items
        entry.E, entry.G = e.shape[-2], work.num_items
        entry.grid = nb + min(grid - nb, -(-B * work.num_items // 2))
        alive.append(tensors)  # the weights in the kernel's types, until the launch
        outs.append((e2, agg))
    rc = lib.hgn_fused_overlap_group(
        fb._DTYPES[shards[0]["e"].dtype], L, group.n, group.shape["graph"], B, ranks, num_nodes, nb, rb,
        group.next_epoch(B), err,
    )
    ring.raise_on(rc, lib, "fused_edge_block_overlap")
    fused_edge_block_overlap.launches += group.n
    return outs


fused_edge_block_overlap.launches = 0  # K7 launches (one per rank) since the last reset
