"""Receiver-sorted pna aggregation: forward (K4f) and backward (K4b).

Counterpart of ``hyper_graph_nets_tpu/ops/pallas/segment_pna.py``
(``pna_sorted`` over ``_fwd_kernel`` and ``_bwd_kernel``), the aggregation
of ``agg_vjp: sorted``.  For edges whose valid ones (mask > 0) are
non-decreasing in receiver, with masked edges anywhere (a padded tail, or
mesh edges the graph balancer removed):

    out = [sum | mean | max | min] of each receiver's valid edges

in float32 (sums and counts weighted by the mask, mean = sum / max(cnt, 1),
0 for a receiver without valid edges), rounded once to the data's dtype.
The backward is gather-only: a valid edge's cotangent is its receiver's
``g_sum + g_mean / max(deg, 1)`` (``deg`` counts the valid edges), plus the
full ``g_max`` (``g_min``) when its value equals the saved max (min) exactly,
so every tied edge gets all of it, times the mask; masked edges get 0.

The JAX package's kernel takes masked edges only at the tail: it moves a
masked edge's receiver past the node space, so an interior one breaks the
receiver order its CSR search needs (ROADMAP section 3).  Here the kernels
skip masked edges inside a receiver's range instead.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/segment_pna.cu``); on a CPU tensor it runs its plain PyTorch
version.  There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core import segment_ops

# The JAX package's dispatch gate (``nn/blocks.py:536``): it takes this path
# only while one batch row of float32 edge features fits this VMEM share.
MAX_EDGE_BLOCK_BYTES = 8 * 1024 * 1024
SOURCE = "segment_pna.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VEC = 4  # columns per lane and vector load; L must be a multiple


@dataclasses.dataclass(frozen=True)
class SortedPlan:
    """Receiver CSR of one edge set, built once per topology on the host.

    ``row_ptr[n]:row_ptr[n+1]`` holds every valid edge of receiver ``n`` and
    no valid edge of another; masked edges may lie inside a range (the
    kernels skip them).  The edges ``[span, num_edges)`` after the last
    valid one lie in no range.  A plan stays right for a later mask that
    only masks more edges, as the graph balancer's does.
    """

    row_ptr: torch.Tensor  # [N + 1] int32
    num_nodes: int
    num_edges: int
    span: int

    def to(self, device) -> "SortedPlan":
        return dataclasses.replace(self, row_ptr=self.row_ptr.to(device))


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def sorted_plan(receivers, num_nodes: int, mask=None) -> SortedPlan:
    """Host: the :class:`SortedPlan` of an edge set.

    Raises ``ValueError`` unless the valid edges (mask > 0) are
    non-decreasing in receiver and lie in ``[0, num_nodes)``; masked edges
    may sit anywhere and name any receiver.
    """
    rcv = _host(receivers).astype(np.int64)
    valid = np.ones(rcv.shape, bool) if mask is None else _host(mask) > 0
    pos = np.flatnonzero(valid)
    rv = rcv[pos]
    if rv.size and (rv.min() < 0 or rv.max() >= num_nodes):
        raise ValueError(f"receivers of valid edges must lie in [0, {num_nodes})")
    if np.any(np.diff(rv) < 0):
        raise ValueError(
            "receivers of valid edges must be non-decreasing (core.mesh."
            "cells_to_edges sorts them); the sorted pna kernel reads CSR ranges"
        )
    span = int(pos[-1]) + 1 if pos.size else 0
    # receiver n's range starts at its first valid edge (or, without one,
    # where the next receiver's starts) and ends at the span; the masked
    # edges before the first valid one go to receiver 0's range
    starts = np.append(pos, span)  # the position of the k-th valid edge
    row_ptr = starts[np.searchsorted(rv, np.arange(num_nodes + 1), side="left")]
    row_ptr[0] = 0
    return SortedPlan(
        row_ptr=torch.from_numpy(row_ptr.astype(np.int32)),
        num_nodes=int(num_nodes),
        num_edges=int(rcv.size),
        span=span,
    )


# -- plain versions ----------------------------------------------------------


def pna_sorted_reference(data, receivers, mask, num_nodes) -> torch.Tensor:
    """Plain K4f on ``[..., E, L]``: float32 sums of ``data * mask`` and
    counts of the mask in edge order, max and min over valid edges
    (mask > 0, wherever they lie), one rounding to ``data.dtype``
    (``segment_ops.aggregate(..., 'pna')``)."""
    return segment_ops.aggregate(data, receivers, num_nodes, "pna", mask)


def pna_sorted_bwd_reference(g, out, data, receivers, mask, num_nodes) -> torch.Tensor:
    """Plain K4b: the edge cotangent ``[..., E, L]`` in ``data.dtype`` from
    the output cotangent ``g`` and the saved output ``out`` (``[..., N, 4L]``),
    with the kernel's float32 steps: ``g1 = g_sum + g_mean * (1/max(deg, 1))``
    per node (two roundings; ``deg`` counts the valid edges), then per edge
    ``g1 + [d == max] g_max + [d == min] g_min``, times the mask; edges that
    are not valid get 0, wherever they lie."""
    L = data.shape[-1]
    valid = torch.ones_like(receivers, dtype=torch.bool) if mask is None else mask > 0
    rcv = torch.where(valid, receivers.long(), 0)
    deg = torch.bincount(rcv[valid], minlength=num_nodes).float()
    inv = 1.0 / torch.clamp(deg, min=1.0)
    gg = g.float()
    g1 = gg[..., :L] + gg[..., L : 2 * L] * inv[:, None]
    take = lambda x: x[..., rcv, :]
    d = data.float()
    o = out.float()
    ge = take(g1) + torch.where(d == take(o[..., 2 * L : 3 * L]), take(gg[..., 2 * L : 3 * L]), 0.0)
    ge = ge + torch.where(d == take(o[..., 3 * L :]), take(gg[..., 3 * L :]), 0.0)
    if mask is not None:
        ge = ge * mask.float()[:, None]
    return torch.where(valid[:, None], ge, 0.0).to(data.dtype)


# -- the kernels -------------------------------------------------------------

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "hgn_pna_sorted_fwd": [_ci] + [_vp] * 4 + [_ci] * 4 + [_vp],
    "hgn_pna_sorted_bwd": [_ci] + [_vp] * 6 + [_ci] * 5 + [_vp],
}
_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from hyper_graph_nets_tpu_torch.ops import build

        lib = build.load(build.source_path(SOURCE))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _ci
        lib.hgn_cuda_error_string.argtypes = [_ci]
        lib.hgn_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _check(cond: bool, what: str):
    if not cond:
        raise ValueError(f"pna_sorted: {what}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    if t is None:
        return None
    _check(t.data_ptr() % 16 == 0, "tensor data must be 16-byte aligned")
    return t.data_ptr()


def _raise_on(rc: int, lib: ctypes.CDLL, what: str):
    if rc != 0:
        msg = "unsupported dtype" if rc < 0 else lib.hgn_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed ({rc}): {msg}")


def _resolve_plan(plan, receivers, mask, num_nodes, device) -> SortedPlan:
    if plan is None:
        plan = sorted_plan(receivers, num_nodes, mask).to(device)
    return plan


def _validate(data, receivers, mask, num_nodes, plan):
    """Checks shared by the kernel wrappers; returns ``(B, E, L)``."""
    _check(data.device.type == "cuda", f"unsupported device {data.device}")
    _check(data.dim() == 3, f"data must be [B, E, L], got {tuple(data.shape)}")
    B, E, L = data.shape
    _check(data.dtype in _DTYPES, f"dtype {data.dtype} not supported")
    _check(L % VEC == 0, f"latent size {L} is not a multiple of {VEC}")
    _check(data.is_contiguous(), "data must be contiguous")
    _check(receivers.dtype == torch.int32 and receivers.shape == (E,), "receivers int32 [E]")
    if mask is not None:
        _check(mask.dtype == torch.float32 and mask.shape == (E,), "mask float32 [E]")
        _check(mask.device == data.device and mask.is_contiguous(), "mask on the data's device")
    _check(isinstance(plan, SortedPlan), "plan must be a SortedPlan")
    _check(plan.num_nodes == num_nodes and plan.num_edges == E, "plan does not match")
    _check(plan.row_ptr.device == data.device, "plan must be on the data's device")
    return B, E, L


def _k4f_launch(data, receivers, mask, num_nodes, plan) -> torch.Tensor:
    plan = _resolve_plan(plan, receivers, mask, num_nodes, data.device)
    B, E, L = _validate(data, receivers, mask, num_nodes, plan)
    lib = _lib()
    out = torch.empty((B, num_nodes, 4 * L), dtype=data.dtype, device=data.device)
    rc = lib.hgn_pna_sorted_fwd(
        _DTYPES[data.dtype], _ptr(data), _ptr(plan.row_ptr), _ptr(mask), _ptr(out),
        B, E, num_nodes, L, torch.cuda.current_stream(data.device).cuda_stream,
    )
    _raise_on(rc, lib, "pna_sorted")
    pna_sorted.launches += 1
    return out


def _forward(data, receivers, mask, num_nodes, plan) -> torch.Tensor:
    if data.device.type == "cpu":
        return pna_sorted_reference(data, receivers, mask, num_nodes)
    return _k4f_launch(data, receivers, mask, num_nodes, plan)


def pna_sorted_bwd(g, out, data, receivers, mask, num_nodes, plan=None) -> torch.Tensor:
    """K4b on ``[B, ...]`` inputs: see :func:`pna_sorted_bwd_reference`.  A
    CUDA tensor launches the kernel (counted on ``pna_sorted_bwd.launches``);
    a CPU tensor runs the plain version."""
    if data.device.type == "cpu":
        return pna_sorted_bwd_reference(g, out, data, receivers, mask, num_nodes)
    plan = _resolve_plan(plan, receivers, mask, num_nodes, data.device)
    B, E, L = _validate(data, receivers, mask, num_nodes, plan)
    for name, t in (("g", g), ("out", out)):
        _check(
            t.shape == (B, num_nodes, 4 * L) and t.dtype == data.dtype and t.is_contiguous()
            and t.device == data.device,
            f"{name} must be [B, N, 4L] in the data's dtype, contiguous",
        )
    lib = _lib()
    ge = torch.empty_like(data)
    rc = lib.hgn_pna_sorted_bwd(
        _DTYPES[data.dtype], _ptr(g), _ptr(out), _ptr(data), _ptr(plan.row_ptr), _ptr(mask),
        _ptr(ge), B, E, num_nodes, L, plan.span,
        torch.cuda.current_stream(data.device).cuda_stream,
    )
    _raise_on(rc, lib, "pna_sorted backward")
    pna_sorted_bwd.launches += 1
    return ge


class PnaSorted(torch.autograd.Function):
    """K4f forward, K4b backward, on ``[B, E, L]`` data.  Saves the data and
    the output: K4b compares each edge with the stored (rounded) max and
    min."""

    @staticmethod
    def forward(ctx, data, receivers, mask, num_nodes, plan):
        out = _forward(data, receivers, mask, num_nodes, plan)
        ctx.topology = (receivers, mask, num_nodes, plan)
        ctx.save_for_backward(data, out)
        return out

    @staticmethod
    def backward(ctx, g):
        data, out = ctx.saved_tensors
        g = g.to(data.dtype).contiguous()
        if g.data_ptr() % 16:  # a view into another tensor: the kernel's loads need alignment
            g = g.clone()
        ge = pna_sorted_bwd(g, out, data, *ctx.topology)
        return ge, None, None, None, None


def pna_sorted(
    data: torch.Tensor,
    receivers: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_nodes: int,
    plan: Optional[SortedPlan] = None,
) -> torch.Tensor:
    """pna ``[sum | mean | max | min]`` of receiver-sorted edges.

    ``data`` is ``[E, L]`` or ``[B, E, L]`` (float32 or bfloat16; the
    topology is shared by the batch); ``receivers`` ``[E]`` int32 with the
    valid edges non-decreasing (masked ones anywhere); ``mask``
    ``[E]`` float32 or None.  Returns ``[..., num_nodes, 4L]`` in the data's
    dtype.  ``plan`` is the edge set's :class:`SortedPlan` on the data's
    device (built from ``receivers`` and ``mask`` when omitted).  Under
    autograd the call goes through :class:`PnaSorted`.
    """
    if data.device.type == "cuda":  # one plan for the forward and the backward
        plan = _resolve_plan(plan, receivers, mask, num_nodes, data.device)
    squeeze = data.dim() == 2
    data3 = data[None] if squeeze else data
    if torch.is_grad_enabled() and data3.requires_grad:
        out = PnaSorted.apply(data3, receivers, mask, num_nodes, plan)
    else:
        out = _forward(data3, receivers, mask, num_nodes, plan)
    return out[0] if squeeze else out


# -- over the edge shards of a rank group ---------------------------------------


class ShardedPnaSorted(torch.autograd.Function):
    """The sorted pna of one ``data`` row of a rank group, whose ``graph``
    ranks each hold an edge shard, as one autograd node over every shard.
    The JAX package's sharded step runs its sorted kernel on the whole set
    (GSPMD gathers the kernel's operands); so does this node.

    The forward is computed before (:func:`_sorted_combine`: the shards
    joined in rank order, K4f once); the node takes each rank's edge
    features ``[B, E/G, L]`` and returns each rank's copy of the aggregate.
    Its backward sums the ranks' cotangents in rank order (the transpose of
    handing every rank a copy), runs K4b once on the joined edges and hands
    each rank its slice.  Being one node, its backward waits for no other
    rank (see ``ops.fused_block.ShardedFusedBlock``).  On a row that spans
    processes the join takes the other processes' shards (gathered), each
    process runs K4f and K4b on the whole row, the backward gathers the
    other processes' cotangents, and the node takes and returns a token,
    as ``ShardedFusedBlock`` does."""

    @staticmethod
    def forward(ctx, spec, *xs):
        # spec: (the joined edges, their receivers and mask, num_nodes, plan,
        # each rank's copy, each rank's graph coordinate and the row's
        # length, the row or None); xs: each rank's shard (then the token)
        joined, receivers, mask, num_nodes, plan, outs, slots, ctx.row = spec
        ctx.topology = (receivers, mask, num_nodes, plan)
        ctx.slots = slots
        ctx.devices = [x.device for x in xs[: len(outs)]]
        ctx.save_for_backward(joined, outs[0])
        return tuple(outs) + ((torch.zeros(()),) if ctx.row else ())

    @staticmethod
    def backward(ctx, *grads):
        joined, out = ctx.saved_tensors
        receivers, mask = ctx.topology[:2]
        grads = grads[: len(ctx.devices)]
        segment_ops.used_on_this_stream(joined, out, receivers, mask, *grads)
        dagg = segment_ops.sum_cotangents(grads, out, ctx.row)
        ge = pna_sorted_bwd(dagg.to(out.dtype).contiguous(), out, joined, *ctx.topology)
        ks, G = ctx.slots
        per = ge.shape[-2] // G
        return (None,) + tuple(ge[..., k * per : (k + 1) * per, :].to(dev) for k, dev in zip(ks, ctx.devices)) + (
            (torch.zeros(()),) if ctx.row else ())


def pna_sorted_sharded(
    data: torch.Tensor,
    receivers: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_nodes: int,
    plan: Optional[SortedPlan],
    group,
) -> torch.Tensor:
    """One rank's edge shard ``[..., E/G, L]`` of a receiver-sorted set,
    aggregated over every ``graph`` rank's shard (called inside
    ``group.run``): ``[..., num_nodes, 4L]`` in the data's dtype, the same
    on every rank of a ``data`` row.

    The shards of each ``data`` row, joined in rank order, are the set's
    edges as ``parallel.sharding.shard_topology`` lays them out (padding
    masked at the tail), and ``plan`` is their :class:`SortedPlan`; K4f runs
    once on them, and under autograd K4b once in the backward
    (:class:`ShardedPnaSorted`).  On the CPU the plain versions run."""
    squeeze = data.dim() == 2
    data3 = data[None] if squeeze else data
    grad = torch.is_grad_enabled() and data3.requires_grad
    entry = dict(data=data3, receivers=receivers, mask=mask, grad=grad)
    out = group.exchange(entry, lambda entries: _sorted_combine(entries, num_nodes, plan, group))
    return out[0] if squeeze else out


def _sorted_combine(entries, num_nodes: int, plan: Optional[SortedPlan], group):
    """The rendezvous of :func:`pna_sorted_sharded`: per ``data`` row, the
    shards joined on the first rank's device and stream (on a row that
    spans processes: rank 0's, with the other processes' shards gathered)
    once every rank's stream has made its shard, K4f there, a copy for each
    other rank on its own stream; under autograd one
    :class:`ShardedPnaSorted` node."""
    results: list = [None] * group.n
    for ranks in group.subgroups("graph"):
        cross = group.crosses(ranks[0])
        lead = 0 if cross else ranks[0]
        dev = group.device(lead)
        parts = [entries[r] for r in ranks]
        with torch.no_grad(), group.context(lead):
            if group.is_cuda:
                for r in ranks:
                    if r != lead:
                        group.stream(lead).wait_stream(group.stream(r))
                segment_ops.used_on_this_stream(*(x[k] for x in parts for k in ("data", "receivers", "mask")))

            def join(key, axis):
                pieces = [x[key].to(dev) for x in parts]
                return torch.cat(group.gather(pieces, ranks[0]) if cross else pieces, dim=axis)

            joined, rcv = join("data", -2), join("receivers", 0)
            mask = None if parts[0]["mask"] is None else join("mask", 0)
            row_plan = None if plan is None else plan.to(dev)
            out = _forward(joined, rcv, mask, num_nodes, row_plan)
        outs = []
        for r in ranks:
            if r == lead:
                outs.append(out)
                continue
            with torch.no_grad(), group.context(r):
                if group.is_cuda:
                    group.stream(r).wait_stream(group.stream(lead))
                    segment_ops.used_on_this_stream(out)
                outs.append(out.to(group.device(r), copy=True))
        if parts[0]["grad"]:
            row = (group, ranks[0]) if cross else None
            slots = ([group.axis_index(r, "graph") for r in ranks], group.shape["graph"])
            outs = ShardedPnaSorted.apply((joined, rcv, mask, num_nodes, row_plan, outs, slots, row),
                                          *(x["data"] for x in parts), *([group.token()] if row else []))
            if row:
                group.chain(outs[-1])
                outs = outs[:-1]
        for r, o in zip(ranks, outs):
            results[r] = o
    return results


# kernel launches since the count was last reset
pna_sorted.launches = 0  # K4f
pna_sorted_bwd.launches = 0  # K4b
