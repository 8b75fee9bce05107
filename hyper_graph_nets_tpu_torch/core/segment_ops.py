"""Masked segment aggregation over the edge axis (plain PyTorch).

Counterpart of ``hyper_graph_nets_tpu/core/segment_ops.py``.  ``data`` is
``[..., E, F]`` and ``segment_ids`` ``[E]``; the result is ``[..., N, F]``.
Masked edges contribute nothing, and empty segments give 0 for every
operation (``segment_ops.py:9-11`` of the JAX package).  Reductions run in
float32 and the result is cast back to the data's dtype.  These serve
``node_dynamic``, the ``agg_vjp: xla`` path and the plain versions of the
kernels; the fused and sorted paths aggregate in their kernels
(``ops/fused_block.py``, ``ops/segment_pna.py``).

The ``agg_vjp: gather`` path aggregates over a static neighbour matrix
(:func:`gather_aggregate`) with gather-only backwards (:func:`pna_gather`,
:func:`gather_rows`): the max/min cotangent goes in full to every tied edge,
as in the JAX package, where autograd through ``scatter_reduce`` would split
it.

Fixed-order sums (:class:`FixedSum`, :class:`EdgeSums`): an edge set
without a kernel plan sums its edges into node rows in the aggregate's sum
and count, and its edge update gathers node rows whose backward sums edge
cotangents into node rows.  ``index_add_`` (and the backward of an index
gather) adds with atomics on the card, in an order that changes from run
to run.  A :class:`FixedSum`, built once per topology on the host, sums by
gathers and dense reductions instead: each segment's elements, in edge
order, in chunks of at most ``FIXED_SUM_CAP``, then the chunks' sums the
same way until one row is left per segment.  :func:`segment_sum_fixed` and
:func:`gather_fixed` are the sum and the gather, each with the other as its
backward, so a train step through them is the same bit for bit on every
run.  An edge set that forms anew in every frame (plate's world edges:
``[B, W]`` ids and mask) takes a :class:`FrameSum` instead, built on the
ids' device by sorts, searches and elementwise passes of static shape, with
no host sync: a stable sort by segment, then a segmented scan in a fixed
tree of ``log2 W`` steps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

_NEG_INF = -1e30
_POS_INF = 1e30


def _out_shape(data: torch.Tensor, num_segments: int) -> tuple:
    return data.shape[:-2] + (num_segments, data.shape[-1])


def _valid(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if mask is None else (mask > 0)[..., None]


# -- fixed-order sums ----------------------------------------------------------

FIXED_SUM_CAP = 32  # elements summed per row of one level, at most


@dataclasses.dataclass(frozen=True)
class FixedSum:
    """Host-built plan of the sum of ``[..., E, F]`` rows into the
    ``num_segments`` segments of ``ids``, in a fixed order.

    Each level gathers its input rows into ``[R, C]`` slots (``idx``, with
    ``valid`` False for padding) and sums over the slots; ``place`` then
    picks each segment's row of the last level's output, or the zero row
    appended after it for an empty segment.  ``rest`` (a plan of its own
    over the same ``ids``) sums the elements a mask left out of the levels,
    added after them: a masked element is 0 in a masked sum, so adding its
    row changes no sum (and carries a NaN as an unmasked sum would), while
    the order of the others is the one they have without it.
    """

    ids: torch.Tensor  # [E] int64
    levels: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # ([R, C] int64, [R, C] bool)
    place: torch.Tensor  # [num_segments] int64
    num_segments: int
    rest: Optional["FixedSum"] = None

    def to(self, device) -> "FixedSum":
        return FixedSum(
            self.ids.to(device),
            tuple((i.to(device), v.to(device)) for i, v in self.levels),
            self.place.to(device),
            self.num_segments,
            None if self.rest is None else self.rest.to(device),
        )

    def with_rows(self, num_segments: int) -> "FixedSum":
        """The same sum into more segments; the added ones stay empty."""
        extra = num_segments - self.num_segments
        if extra < 0:
            raise ValueError("with_rows only adds segments")
        rows = int(self.levels[-1][0].shape[0]) if self.levels else int(self.ids.shape[0])
        pad = torch.full((extra,), rows, dtype=torch.int64, device=self.place.device)
        return dataclasses.replace(
            self, place=torch.cat([self.place, pad]), num_segments=num_segments,
            rest=None if self.rest is None else self.rest.with_rows(num_segments),
        )

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``[..., E, F] -> [..., num_segments, F]``, no autograd."""
        if x.shape[-2] != self.ids.shape[0]:
            raise ValueError(f"{x.shape[-2]} rows, the plan sums {self.ids.shape[0]}")
        axis = x.dim() - 2
        out = x
        for idx, valid in self.levels:
            g = out.index_select(axis, idx.reshape(-1)).reshape(
                out.shape[:-2] + tuple(idx.shape) + (out.shape[-1],)
            )
            out = torch.where(valid[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))
            out = out.sum(dim=-2)
        out = torch.cat([out, out.new_zeros(out.shape[:-2] + (1, out.shape[-1]))], dim=axis)
        out = out.index_select(axis, self.place)
        return out if self.rest is None else out + self.rest(x)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x[..., ids, :]``: each element's segment row, no autograd (also
        the sum's adjoint)."""
        return x.index_select(x.dim() - 2, self.ids)

    spread = gather


def _sum_levels(ids: np.ndarray, items: np.ndarray, num_segments: int):
    """The levels and ``place`` of the fixed-order sum of the elements
    ``items`` (sorted by segment, each segment's in edge order)."""
    seg = ids[items]
    levels = []
    while seg.size:
        uniq, starts, counts = np.unique(seg, return_index=True, return_counts=True)
        if counts.max() == 1:
            break
        width = 1
        while width < min(int(counts.max()), FIXED_SUM_CAP):
            width *= 2
        owner = np.repeat(np.arange(len(uniq)), counts)
        rank = np.arange(len(seg)) - starts[owner]
        chunks = (counts + width - 1) // width
        first = np.concatenate([[0], np.cumsum(chunks)[:-1]])
        row, col = first[owner] + rank // width, rank % width
        idx = np.zeros((int(chunks.sum()), width), np.int64)
        valid = np.zeros(idx.shape, bool)
        idx[row, col] = items
        valid[row, col] = True
        levels.append((torch.from_numpy(idx), torch.from_numpy(valid)))
        seg = np.repeat(uniq, chunks)
        items = np.arange(len(seg))
    place = np.full(num_segments, len(items) if levels else ids.size, np.int64)  # the zero row
    place[seg] = items
    return tuple(levels), torch.from_numpy(place)


def fixed_sum_plan(ids, num_segments: int, mask=None) -> FixedSum:
    """Host: the :class:`FixedSum` of ``ids`` (``[E]``, values in
    ``[0, num_segments)``), on the CPU.  With ``mask`` (``[E]``) the
    elements with ``mask > 0`` are summed in the order they have without
    the others, and the others (a bucketed topology's padded tail) after
    them (``FixedSum.rest``)."""
    ids = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids, np.int64)
    if ids.size and (ids.min() < 0 or ids.max() >= num_segments):
        raise ValueError(f"ids must lie in [0, {num_segments})")
    items = np.argsort(ids, kind="stable")  # each segment's elements in edge order
    rest = None
    if mask is not None:
        keep = (np.asarray(mask) > 0)[items]
        if not keep.all():
            rest = FixedSum(torch.from_numpy(ids), *_sum_levels(ids, items[~keep], num_segments), int(num_segments))
        items = items[keep]
    return FixedSum(torch.from_numpy(ids), *_sum_levels(ids, items, num_segments), int(num_segments), rest)


@dataclasses.dataclass(frozen=True)
class FrameSum:
    """Plan of the sum of ``[..., W, F]`` rows into the ``num_segments``
    segments of per-frame ids ``[..., W]`` (every leading index a frame of
    its own), in a fixed order, built where the ids lie.

    Masked elements go to a dropped segment.  The elements are sorted by
    segment, stably (so each segment keeps its elements in their order),
    and summed by a segmented Hillis-Steele scan: at step ``d = 1, 2, 4,
    ...`` each element adds the partial ``d`` places before it when that one
    is of its segment.  A segment's sum is then its last element's partial,
    and an empty segment reads the zero row after them.  The order of the
    additions follows from the ids alone, so a sum is the same bit for bit
    on every run, and nothing is read back to the host.
    """

    ids: torch.Tensor  # [..., W] int64: each element's segment
    key: torch.Tensor  # [..., W] int64: ids, num_segments where masked
    order: torch.Tensor  # [..., W] int64: the elements sorted by key, stably
    same: Tuple[torch.Tensor, ...]  # per scan step d: [..., W - d] bool, sorted[i - d] shares i's segment
    last: torch.Tensor  # [..., num_segments] int64: each segment's last sorted slot, W if empty
    num_segments: int

    @classmethod
    def build(cls, ids: torch.Tensor, valid: Optional[torch.Tensor], num_segments: int) -> "FrameSum":
        """The plan of ``ids`` (values in ``[0, num_segments)``) with
        ``valid`` (bool or float, the ids' shape; None: all valid)."""
        ids = ids.long()
        key = ids if valid is None else torch.where(valid > 0, ids, num_segments)
        seg, order = torch.sort(key, dim=-1, stable=True)
        W = ids.shape[-1]
        same, d = [], 1
        while d < W:
            same.append(seg[..., d:] == seg[..., :-d])
            d *= 2
        nodes = torch.arange(num_segments, device=ids.device).expand(ids.shape[:-1] + (num_segments,))
        start = torch.searchsorted(seg, nodes.contiguous())
        end = torch.searchsorted(seg, nodes.contiguous(), right=True)
        last = torch.where(end > start, end - 1, W)
        return cls(ids, key, order, tuple(same), last, int(num_segments))

    def with_rows(self, num_segments: int) -> "FrameSum":
        """The same sum into more segments (a hyper tier's rows after the
        mesh rows), on the plan's device with no host sync: the added
        segments stay empty (``last`` padded with ``W``), and a masked
        element's key moves to the new ``num_segments`` so that
        :meth:`spread` still reads the zero row for it.  Masked keys stay
        the largest, so the sort order and the scan's ``same`` masks do not
        change."""
        extra = num_segments - self.num_segments
        if extra < 0:
            raise ValueError("with_rows only adds segments")
        W = self.ids.shape[-1]
        pad = self.last.new_full(self.last.shape[:-1] + (extra,), W)
        key = torch.where(self.key == self.num_segments, num_segments, self.key)
        return dataclasses.replace(
            self, key=key, last=torch.cat([self.last, pad], dim=-1), num_segments=int(num_segments)
        )

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``[..., W, F] -> [..., num_segments, F]``, no autograd."""
        x = frame_rows(x, self.order)
        for step, same in enumerate(self.same):
            d = 1 << step
            add = torch.where(same[..., None], x[..., :-d, :], torch.zeros((), dtype=x.dtype, device=x.device))
            x = torch.cat([x[..., :d, :], x[..., d:, :] + add], dim=-2)
        x = torch.cat([x, x.new_zeros(x.shape[:-2] + (1, x.shape[-1]))], dim=-2)
        return frame_rows(x, self.last)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x[..., ids[..., w], :]`` per frame, masked elements included; no
        autograd."""
        return frame_rows(x, self.ids)

    def spread(self, g: torch.Tensor) -> torch.Tensor:
        """The sum's adjoint: each element's segment row of ``g``, 0 for a
        masked one."""
        g = torch.cat([g, g.new_zeros(g.shape[:-2] + (1, g.shape[-1]))], dim=-2)
        return frame_rows(g, self.key)


def frame_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx[..., w], :]``: each frame's rows by that frame's indices
    (``x`` and ``idx`` share their leading axes)."""
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + (x.shape[-1],)))


@dataclasses.dataclass(frozen=True)
class EdgeSums:
    """The fixed-order sums of one edge set: over its receivers (the
    aggregate, and the receiver gather's backward) and over its senders
    (the sender gather's backward)."""

    receivers: FixedSum
    senders: FixedSum

    @classmethod
    def build(cls, senders, receivers, num_nodes: int, mask=None) -> "EdgeSums":
        """The sums of a static edge set; with ``mask`` the masked edges
        reach neither."""
        return cls(fixed_sum_plan(receivers, num_nodes, mask), fixed_sum_plan(senders, num_nodes, mask))

    @classmethod
    def per_frame(cls, senders, receivers, mask, num_nodes: int) -> "EdgeSums":
        """The sums of a set with per-frame ``[..., W]`` senders, receivers
        and mask, as :class:`FrameSum` plans built on their device.  The
        sender gather's backward drops masked edges' cotangents: a masked
        edge reaches no aggregate, so they are zero."""
        return cls(FrameSum.build(receivers, mask, num_nodes), FrameSum.build(senders, mask, num_nodes))

    def to(self, device) -> "EdgeSums":
        return EdgeSums(self.receivers.to(device), self.senders.to(device))

    def with_rows(self, num_nodes: int) -> "EdgeSums":
        return EdgeSums(self.receivers.with_rows(num_nodes), self.senders.with_rows(num_nodes))


class _SegmentSumFixed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, plan):
        ctx.plan = plan
        return plan(data)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.spread(g), None


class _GatherFixed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        if x.shape[-2] != plan.num_segments:
            raise ValueError(f"{x.shape[-2]} node rows, the plan has {plan.num_segments}")
        ctx.plan = plan
        return plan.gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan(g), None


def segment_sum_fixed(data: torch.Tensor, plan) -> torch.Tensor:
    """Segment sum of ``data`` ``[..., E, F]`` in the plan's fixed order
    (a :class:`FixedSum` or a :class:`FrameSum`); its backward is a gather."""
    return _SegmentSumFixed.apply(data, plan)


def gather_fixed(x: torch.Tensor, plan) -> torch.Tensor:
    """``x[..., ids, :]`` (per frame for a :class:`FrameSum`), whose backward
    sums each row's cotangents in the plan's fixed order."""
    return _GatherFixed.apply(x, plan)


def _sum32(data, ids, num_segments, mask, sums: Optional[FixedSum] = None):
    d = data.to(torch.float32)
    if mask is not None:
        d = d * mask[..., None].to(torch.float32)
    if sums is not None:
        return segment_sum_fixed(d, sums)[..., :num_segments, :]
    out = d.new_zeros(_out_shape(d, num_segments))
    return out.index_add_(out.dim() - 2, ids.long(), d)


def _count32(data, ids, num_segments, mask, sums: Optional[FixedSum] = None):
    ones = torch.ones(data.shape[-2], dtype=torch.float32, device=data.device)
    if mask is not None:
        ones = ones * mask.to(torch.float32)
    if sums is not None:
        return sums(ones[..., None])[..., :num_segments, :]
    counts = ones.new_zeros(ones.shape[:-1] + (num_segments,))
    counts.index_add_(counts.dim() - 1, ids.long(), ones)
    return counts[..., None]


def _extremum_raw32(data, ids, num_segments, mask, reduce: str):
    """Segment max (``amax``) or min in float32; -1e30 (+1e30) where a
    segment has no valid edge."""
    fill = _NEG_INF if reduce == "amax" else _POS_INF
    d = data.to(torch.float32)
    valid = _valid(mask)
    if valid is not None:
        d = torch.where(valid, d, torch.full_like(d, fill))
    out = torch.full(_out_shape(d, num_segments), fill, device=d.device)
    index = ids.long()[..., None].expand_as(d)
    return out.scatter_reduce_(d.dim() - 2, index, d, reduce, include_self=True)


def _empty_to_zero(x: torch.Tensor, reduce: str) -> torch.Tensor:
    empty = x <= _NEG_INF / 2 if reduce == "amax" else x >= _POS_INF / 2
    return torch.where(empty, torch.zeros_like(x), x)


def _extremum32(data, ids, num_segments, mask, reduce: str):
    return _empty_to_zero(_extremum_raw32(data, ids, num_segments, mask, reduce), reduce)


def segment_sum(data, segment_ids, num_segments, mask=None):
    return _sum32(data, segment_ids, num_segments, mask).to(data.dtype)


def segment_mean(data, segment_ids, num_segments, mask=None):
    total = _sum32(data, segment_ids, num_segments, mask)
    counts = _count32(data, segment_ids, num_segments, mask)
    return (total / torch.clamp(counts, min=1.0)).to(data.dtype)


def segment_max(data, segment_ids, num_segments, mask=None):
    return _extremum32(data, segment_ids, num_segments, mask, "amax").to(data.dtype)


def segment_min(data, segment_ids, num_segments, mask=None):
    return _extremum32(data, segment_ids, num_segments, mask, "amin").to(data.dtype)


_OPS = {
    "sum": segment_sum,
    "mean": segment_mean,
    "max": segment_max,
    "min": segment_min,
}


def _std(square: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``sqrt(max(E[x^2] - mean^2, 0))``.  Its gradient at
    a segment with no spread (one edge, equal edges, or none) is the JAX
    package's too: ``maximum`` splits the cotangent at the tie with 0 and
    ``sqrt``'s is infinite at 0, so the segment's edges get NaN (inf - inf,
    or 0 x inf for a zero cotangent), and so does every gradient that sums
    them."""
    return torch.sqrt(torch.maximum(square - mean * mean, torch.zeros((), dtype=mean.dtype, device=mean.device)))


def aggregate(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    aggregation: str,
    mask: Optional[torch.Tensor] = None,
    sums: Optional[FixedSum] = None,
) -> torch.Tensor:
    """Aggregate edge features to receiver nodes.

    ``aggregation='pna'`` concatenates ``[sum | mean | max | min]``; any
    other name selects the single segment op (``std``: :func:`_std` of the
    segment means of the data and of its square).  With ``sums`` (the
    :class:`FixedSum` of ``segment_ids`` over at least ``num_segments``
    rows) the sums and counts run in its fixed order; max and min do not
    depend on the order.
    """
    if aggregation == "pna":
        total = _sum32(data, segment_ids, num_segments, mask, sums)
        counts = _count32(data, segment_ids, num_segments, mask, sums)
        parts = [
            total,
            total / torch.clamp(counts, min=1.0),
            _extremum32(data, segment_ids, num_segments, mask, "amax"),
            _extremum32(data, segment_ids, num_segments, mask, "amin"),
        ]
        return torch.cat(parts, dim=-1).to(data.dtype)
    if aggregation == "std":
        counts = torch.clamp(_count32(data, segment_ids, num_segments, mask, sums), min=1.0)
        mean = _sum32(data, segment_ids, num_segments, mask, sums) / counts
        square = _sum32(data * data, segment_ids, num_segments, mask, sums) / counts
        return _std(square, mean).to(data.dtype)
    if aggregation not in _OPS:
        raise ValueError(f"invalid segment operation {aggregation!r}")
    if sums is not None and aggregation in ("sum", "mean"):
        total = _sum32(data, segment_ids, num_segments, mask, sums)
        if aggregation == "mean":
            total = total / torch.clamp(_count32(data, segment_ids, num_segments, mask, sums), min=1.0)
        return total.to(data.dtype)
    return _OPS[aggregation](data, segment_ids, num_segments, mask)


def pna_partials(data, segment_ids, num_segments, mask=None, sums: Optional[FixedSum] = None) -> torch.Tensor:
    """Unfinalized pna partials of one edge shard, float32 ``[..., N, 4F]``:
    ``[sum | count (broadcast over F) | max | min]`` with -1e30 / +1e30 where
    the shard has no valid edge for a segment (the raw output of the JAX
    package's fused kernel, ``finalize=False``); the sums and counts in the
    fixed order of ``sums`` when given."""
    counts = _count32(data, segment_ids, num_segments, mask, sums)
    return torch.cat(
        [
            _sum32(data, segment_ids, num_segments, mask, sums),
            counts.expand(_out_shape(data, num_segments)),
            _extremum_raw32(data, segment_ids, num_segments, mask, "amax"),
            _extremum_raw32(data, segment_ids, num_segments, mask, "amin"),
        ],
        dim=-1,
    )


def finalize_partials(raw: torch.Tensor) -> torch.Tensor:
    """``[sum | sum / max(count, 1) | max | min]`` from combined partials,
    empty segments' extrema 0 (``fused_block.py:1915-1923``)."""
    F = raw.shape[-1] // 4
    s, n, mx, mn = raw.split(F, dim=-1)
    return torch.cat(
        [s, s / torch.clamp(n, min=1.0), _empty_to_zero(mx, "amax"), _empty_to_zero(mn, "amin")],
        dim=-1,
    )


def combine_partials(group, raws, F: int):
    """Every rank's raw pna partials ``[..., N, 4F]`` combined along
    ``graph`` by the group's plain all-reduce (sum and count summed, max and
    min folded, in rank order), then finalized: ``(aggs, counts)``, one
    finalized float32 aggregate and one combined ``[..., N, 1]`` count per
    rank, each on its device and stream."""
    parts = [
        group.reduce_plain([x[..., lo:hi] for x in raws], op)
        for lo, hi, op in ((0, 2 * F, "sum"), (2 * F, 3 * F, "max"), (3 * F, 4 * F, "min"))
    ]
    aggs, counts = [], []
    for r, p in enumerate(zip(*parts)):
        with group.context(r):
            aggs.append(finalize_partials(torch.cat(p, dim=-1)))
            counts.append(p[0][..., F : F + 1])
    return aggs, counts


# -- edge-parallel aggregation over a rank group (the halo forward) ----------


def collective_aggregate(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    aggregation: str,
    mask: Optional[torch.Tensor],
    group,
    ring: bool = False,
    sums: Optional[FixedSum] = None,
) -> torch.Tensor:
    """Aggregation of one rank's edge shard over every rank's edges: local
    partials combined across the rank group (``parallel.group.RankGroup``),
    the JAX package's ``collective_aggregate`` (``core/segment_ops.py:
    226-349``).  Called from inside ``group.run``.  ``sums`` (the shard's
    receiver :class:`FixedSum`, ``parallel.sharding.shard_topology``) sums
    the local partials and counts in a fixed order, so a halo forward is the
    same bit for bit on every run; without it they add with ``index_add_``.

    Without ``ring`` the partials combine by the group's plain all-reduce
    (the counterpart of ``psum``/``pmax``/``pmin``): :func:`sharded_aggregate`.
    With ``ring`` every pna partial travels in ONE float32 payload ``[sum;
    count; max; min]`` (``[4N, F]``) through K6
    (``ops.ring.ring_all_reduce_segments``), unbatched ``[E, F]`` data only,
    as in JAX, and the result is cast back to the data's dtype.
    """
    if not ring:
        return sharded_aggregate(data, segment_ids, num_segments, aggregation, mask, group, sums=sums)
    group.check_ring("the ring all-reduce (K6)")
    if data.dim() != 2:
        raise ValueError("the ring's collective aggregation supports unbatched [E, F] data only")
    if aggregation not in ("sum", "mean", "max", "min", "pna"):
        raise ValueError(f"invalid collective aggregation {aggregation!r}")
    from hyper_graph_nets_tpu_torch.ops.ring import ring_all_reduce_segments

    n = num_segments
    if aggregation == "sum":
        total = group.exchange(
            _sum32(data, segment_ids, n, mask, sums),
            lambda xs: ring_all_reduce_segments(xs, [(0, n, "sum")], group),
        )
        return total.to(data.dtype)
    raw = pna_partials(data, segment_ids, n, mask, sums)  # [N, 4F]
    F = data.shape[-1]
    payload = torch.cat(raw.split(F, dim=-1), dim=0).contiguous()  # [4N, F]
    segments = [(0, n, "sum"), (n, 2 * n, "sum"), (2 * n, 3 * n, "max"), (3 * n, 4 * n, "min")]
    combined = group.exchange(payload, lambda xs: ring_all_reduce_segments(xs, segments, group))
    out = finalize_partials(torch.cat(combined.split(n, dim=0), dim=-1))
    return _pna_part(out, aggregation, F).to(data.dtype)


def _pna_part(out: torch.Tensor, aggregation: str, F: int) -> torch.Tensor:
    """The ``aggregation`` columns of a pna result (all of it for pna)."""
    parts = {"mean": 1, "max": 2, "min": 3}
    if aggregation in parts:
        k = parts[aggregation]
        return out[..., k * F : (k + 1) * F]
    return out[..., :F] if aggregation == "sum" else out


# -- an unfused edge set over edge shards, under autograd ----------------------

TIE_RULES = ("full", "split")


def used_on_this_stream(*tensors) -> None:
    """Mark CUDA tensors as read on the current stream (``record_stream``).
    A rank-group node's backward runs on one stream and reads what every
    rank's stream made in the forward (the shards' features, indices and
    aggregates); once the node is released, the caching allocator would
    hand that memory back to the rank's stream before this stream's kernels
    have read it, and a later kernel on the rank's stream could overwrite
    it."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))


def join_streams(devices) -> None:
    """The current stream of ``devices[0]`` (a sharded node's own, in its
    backward) after the current stream of every other CUDA device in
    ``devices`` (where the node ran its ranks' parts).  The autograd engine
    hands each of the node's gradients on by an event on the node's own
    stream, also a gradient that lies on another card: without the join a
    consumer there could read it before it is written (seen over several
    cards a process, where NCCL leaves the host far ahead of the cards)."""
    devs = list(dict.fromkeys(d for d in devices if d.type == "cuda"))
    if len(devs) > 1:
        own = torch.cuda.current_stream(devs[0])
        for d in devs[1:]:
            own.wait_stream(torch.cuda.current_stream(d))


def sum_cotangents(grads, like: torch.Tensor, row=None) -> torch.Tensor:
    """A sharded node's backward: its ranks' aggregate cotangents (None:
    none) summed in rank order, float32 on ``like``'s device (zeros of
    ``like``'s shape when none came): the transpose of handing every rank
    the all-reduced aggregate.  On a ``graph`` row that spans processes
    (``row``: the group and one of the row's ranks) every rank's of the row,
    gathered from the other processes (``RankGroup.cotangents``), in global
    rank order."""
    parts = [None if d is None else d.float().to(like.device) for d in grads]
    if row is not None:
        group, rank = row
        parts = [d.to(like.device) for d in group.cotangents(
            [torch.zeros_like(like, dtype=torch.float32) if d is None else d for d in parts], rank)]
    total = None
    for d in parts:
        if d is not None:
            total = d if total is None else total + d
    return torch.zeros_like(like, dtype=torch.float32) if total is None else total


class ShardedAggregate(torch.autograd.Function):
    """The pna aggregate of an edge set without a kernel plan over the edge
    shards of one ``data`` row of a rank group, as one autograd node over
    every shard (the unfused counterpart of
    ``ops.fused_block.ShardedFusedBlock``; the JAX package leaves it to
    GSPMD, which partitions one global program).

    The forward is computed before (each rank's local partials, combined by
    :func:`combine_partials`); this node takes each rank's edge features
    ``[..., E/G, F]`` and returns each rank's aggregate over every node row.
    Its backward sums the ranks' aggregate cotangents in rank order (the
    transpose of handing every rank the all-reduced aggregate), then routes
    the sum to each shard's valid edges (by ``[E]`` receivers, or per frame
    by ``[B, E]`` ones) against the global aggregate: the
    sum part in full, the mean part over the global count, and the max
    (min) part to every edge equal to the global max (min), by the set's tie
    rule: ``full`` sends the whole cotangent to every tied edge (the
    ``gather`` path's ``pna_gather``), ``split``
    divides it by the number of tied edges over every shard (autograd
    through an amax, the ``xla`` path's).  Being one node, its backward
    waits for no other rank (see ``ShardedFusedBlock``; on a row that spans
    processes it gathers the other processes' cotangents and tie counts,
    and takes and returns a token, as that node does).
    """

    @staticmethod
    def forward(ctx, spec, *xs):
        # spec: (per rank (receivers, mask, sums), tie rule, aggregates,
        # count, the row or None); xs: per rank edge features (then the
        # token on a row that spans processes)
        shards, ties, aggs, count, ctx.row = spec
        ctx.shards, ctx.ties, ctx.count = shards, ties, count
        ctx.save_for_backward(*xs[: len(shards)], aggs[0])
        return tuple(aggs) + ((torch.zeros(()),) if ctx.row else ())

    @staticmethod
    def backward(ctx, *grads):
        *xs, agg = ctx.saved_tensors
        grads = grads[: len(xs)]
        used_on_this_stream(*xs, agg, ctx.count, *grads, *(t for shard in ctx.shards for t in shard[:2]))
        count = ctx.count.to(agg.device)
        dagg = sum_cotangents(grads, agg, ctx.row)
        token = (torch.zeros(()),) if ctx.row else ()
        F = agg.shape[-1] // 4
        g_sum, g_mean, g_max, g_min = dagg.split(F, dim=-1)
        _, _, mx, mn = agg.split(F, dim=-1)
        node = g_sum + g_mean / count.clamp(min=1.0)
        if ctx.ties == "split":
            ties_max, ties_min = _tie_counts(xs, ctx.shards, mx, mn)
            if ctx.row is not None:  # and the other processes' shards' (exact counts: any order)
                group, rank = ctx.row
                ties_max, ties_min = (group.sum_processes(t, rank) for t in (ties_max, ties_min))
            g_max, g_min = g_max / ties_max.clamp(min=1.0), g_min / ties_min.clamp(min=1.0)
        out = [None]
        for x, (rcv, mask, _) in zip(xs, ctx.shards):
            take = lambda t: _receiver_rows(t.to(x.device), rcv)
            xf = x.float()
            ge = take(node)
            ge = ge + torch.where(xf == take(mx), take(g_max), 0.0)
            ge = ge + torch.where(xf == take(mn), take(g_min), 0.0)
            if mask is not None:
                ge = ge * (mask > 0)[..., None]
            out.append(ge.to(x.dtype))
        join_streams([agg.device] + [x.device for x in xs])
        return tuple(out) + token


def _receiver_rows(t: torch.Tensor, rcv: torch.Tensor) -> torch.Tensor:
    """Each edge's receiver row of ``t`` ``[..., N, F]``: by ``[E]``
    receivers, or per frame by ``[..., E]`` ones (a set that forms anew in
    every frame)."""
    if rcv.dim() == 1:
        return t.index_select(t.dim() - 2, rcv.long())
    return frame_rows(t, rcv.long())


def _tie_counts(xs, shards, mx, mn):
    """The number of valid edges over every shard equal to each receiver's
    global max and min, ``[..., N, F]`` each: each shard's counts (exact
    small integers, so their order does not matter), summed in rank
    order."""
    n = mx.shape[-2]
    total_max = total_min = 0.0
    for x, (rcv, mask, sums) in zip(xs, shards):
        take = lambda t: _receiver_rows(t.to(x.device), rcv)
        xf = x.float()
        for ext, which in ((mx, "max"), (mn, "min")):
            hits = _sum32((xf == take(ext)).float(), rcv, n, mask, sums).to(mx.device)
            if which == "max":
                total_max = total_max + hits
            else:
                total_min = total_min + hits
    return total_max, total_min


def sharded_aggregate(
    data: torch.Tensor,
    receivers: torch.Tensor,
    num_segments: int,
    aggregation: str,
    mask: Optional[torch.Tensor],
    group,
    sums: Optional[FixedSum] = None,
    ties: str = "split",
) -> torch.Tensor:
    """One rank's edge shard ``[..., E, F]`` of a set without a kernel plan,
    aggregated over every graph rank's edges (called inside ``group.run``):
    ``[..., num_segments, F']``, every node row.

    Each rank sums its local partials in the fixed order of ``sums`` (the
    shard's receiver :class:`FixedSum`, ``parallel.sharding.RankSums``;
    ``index_add_`` without one) and takes its local max and min, in float32;
    the partials meet in :func:`combine_partials` (the group's plain
    all-reduce along ``graph``).  Under autograd each ``data`` row's shards
    meet in one :class:`ShardedAggregate` node, whose backward routes the
    max and min cotangents to tied edges by ``ties`` (``full`` or
    ``split``).  Batched ``[B, E, F]`` data and ``[E, F]`` alike; a set that
    forms anew in every frame (plate's world edges) takes ``[B, E]``
    receivers and mask and its shard's :class:`FrameSum` as ``sums``, and
    its counts (the mean's and the ties') are per frame.  The result in the
    data's dtype."""
    if aggregation not in ("sum", "mean", "max", "min", "pna"):
        raise ValueError(f"invalid collective aggregation {aggregation!r}")
    if ties not in TIE_RULES:
        raise ValueError(f"ties must be one of {TIE_RULES}, got {ties!r}")
    grad = torch.is_grad_enabled() and data.requires_grad
    with torch.no_grad():
        raw = pna_partials(data, receivers, num_segments, mask, sums)
    entry = dict(data=data, shard=(receivers, mask, sums), raw=raw, grad=grad)
    out = group.exchange(entry, lambda entries: _sharded_combine(entries, group, ties))
    return _pna_part(out, aggregation, data.shape[-1]).to(data.dtype)


def _sharded_combine(entries, group, ties: str):
    """The rendezvous of :func:`sharded_aggregate`: every rank's partials
    combined, then one autograd node per ``data`` row."""
    F = entries[0]["data"].shape[-1]
    with torch.no_grad():
        aggs, counts = combine_partials(group, [x["raw"] for x in entries], F)
    if not entries[0]["grad"]:
        return aggs
    results: list = [None] * group.n
    for ranks in group.subgroups("graph"):
        row = (group, ranks[0]) if group.crosses(ranks[0]) else None
        spec = ([entries[r]["shard"] for r in ranks], ties, [aggs[r] for r in ranks], counts[ranks[0]], row)
        got = ShardedAggregate.apply(spec, *(entries[r]["data"] for r in ranks), *([group.token()] if row else []))
        if row:
            group.chain(got[-1])
        for r, out in zip(ranks, got):
            results[r] = out
    return results


# -- the gather path (agg_vjp: gather) ----------------------------------------


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, :]`` for an index tensor of any shape: ``[..., *idx.shape, F]``."""
    rows = x.index_select(x.dim() - 2, idx.reshape(-1).long())
    return rows.reshape(x.shape[:-2] + tuple(idx.shape) + (x.shape[-1],))


def gather_aggregate(
    data: torch.Tensor,
    gather_idx: torch.Tensor,
    gather_valid: torch.Tensor,
    aggregation: str,
) -> torch.Tensor:
    """Aggregation over a static ``[N, d_max]`` neighbour-edge matrix
    (``core.mesh.receivers_to_gather``), the JAX package's
    ``segment_ops.gather_aggregate``.  Empty rows give 0.

    Types follow the JAX function: sums and means are float32 (the float32
    ``gather_valid`` promotes them), max and min keep the data's dtype, and
    pna's concatenation is float32.  Autograd through max/min splits a
    cotangent among tied edges, as the VJP of ``jnp.max`` does.
    """
    g = _take_rows(data, gather_idx)  # [..., N, d, F]
    valid = gather_valid[..., None]
    total = (g * valid).sum(dim=-2)
    if aggregation == "sum":
        return total
    safe_deg = torch.clamp(gather_valid.sum(dim=-1), min=1.0)[..., None]
    if aggregation == "mean":
        return total / safe_deg
    mx = torch.where(valid > 0, g, _NEG_INF).amax(dim=-2)
    mx = torch.where(mx <= _NEG_INF / 2, 0.0, mx)
    if aggregation == "max":
        return mx
    mn = torch.where(valid > 0, g, _POS_INF).amin(dim=-2)
    mn = torch.where(mn >= _POS_INF / 2, 0.0, mn)
    if aggregation == "min":
        return mn
    if aggregation == "pna":
        return torch.cat([total, total / safe_deg, mx, mn], dim=-1)
    if aggregation == "std":
        return _std((g * g * valid).sum(dim=-2) / safe_deg, total / safe_deg)
    raise ValueError(f"invalid aggregation {aggregation!r}")


class PnaGather(torch.autograd.Function):
    """pna over the neighbour matrix with a gather-only backward (the JAX
    package's ``segment_ops.pna_gather``): each edge gathers its receiver's
    ``g_sum + g_mean / deg``, and the full ``g_max`` (``g_min``) when its
    value equals the saved max (min) exactly, so every tied edge gets all of
    it; the result is multiplied by the edge mask."""

    @staticmethod
    def forward(ctx, data, gather_idx, gather_valid, receivers, edge_mask):
        out = gather_aggregate(data, gather_idx, gather_valid, "pna")
        deg = torch.clamp(gather_valid.sum(dim=-1), min=1.0)
        ctx.save_for_backward(data, receivers, edge_mask, out, deg)
        return out

    @staticmethod
    def backward(ctx, g):
        data, receivers, edge_mask, out, deg = ctx.saved_tensors
        F = data.shape[-1]
        g_sum, g_mean, g_max, g_min = g.split(F, dim=-1)
        mx, mn = out[..., 2 * F : 3 * F], out[..., 3 * F :]
        take = lambda x: _take_rows(x, receivers)
        g_edge = take(g_sum) + take(g_mean * (1.0 / deg)[..., None])
        g_edge = g_edge + torch.where(data == take(mx), take(g_max), 0.0)
        g_edge = g_edge + torch.where(data == take(mn), take(g_min), 0.0)
        g_edge = g_edge * edge_mask[..., None]
        return g_edge.to(data.dtype), None, None, None, None


def pna_gather(
    data: torch.Tensor,
    gather_idx: torch.Tensor,
    gather_valid: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``gather_aggregate(..., 'pna')`` whose backward routes the node
    cotangent to edges by gathers along ``receivers`` (:class:`PnaGather`).
    ``edge_mask`` (``[..., E]``, None: all valid) zeroes padded edges'
    cotangents."""
    if edge_mask is None:
        edge_mask = torch.ones(data.shape[:-1], dtype=torch.float32, device=data.device)
    return PnaGather.apply(data, gather_idx, gather_valid, receivers, edge_mask)


class GatherRows(torch.autograd.Function):
    """``x[..., idx, :]`` whose backward sums each source row's cotangents
    through the static inverse incidence (``inv_idx``/``inv_valid``,
    ``receivers_to_gather(idx)``), by gathers: the JAX package's
    ``segment_ops.gather_rows``."""

    @staticmethod
    def forward(ctx, x, idx, inv_idx, inv_valid):
        ctx.save_for_backward(inv_idx, inv_valid)
        return _take_rows(x, idx)

    @staticmethod
    def backward(ctx, g):
        inv_idx, inv_valid = ctx.saved_tensors
        gg = _take_rows(g, inv_idx)  # [..., N, d, F]
        gx = (gg * inv_valid.to(g.dtype)[..., None]).sum(dim=-2)
        return gx, None, None, None


def gather_rows(x, idx, inv_idx, inv_valid) -> torch.Tensor:
    """Row gather with a gather-only backward (:class:`GatherRows`)."""
    return GatherRows.apply(x, idx, inv_idx, inv_valid)
