"""Fused edge block: forward (K1) and its backward (K2 remat, K3 stream).

Counterpart of ``hyper_graph_nets_tpu/ops/pallas/fused_block.py``
(``fused_edge_block`` over ``_fwd_kernel``, ``_bwd_kernel`` and
``_bwd_stream_kernel``).  For receiver-sorted edges:

    h   = ((e @ We + SP[snd]) + RP[rcv]) + b1
    e2  = e + LN(relu(relu(h) @ W2 + b2) @ W3 + b3)
    agg = [sum | mean | max | min] of e2 per receiver (float32, empty -> 0)

Under autograd :class:`FusedEdgeBlock` runs K1 forward and K2 (``bwd:
remat``, recomputes the forward chain) or K3 (``bwd: stream``, reads the
``a1, a2, mu, isg`` streams K1 saved) backward.  The max/min cotangent goes
in full to every edge whose ``e2`` equals the extremum exactly, as in the
JAX package (``tie_tol = 0``); autograd through the plain forward would
split it among tied edges instead.

:class:`HybridEdgeBlock` is the JAX package's hybrid (``fused_fwd: xla``,
``fused_edge_block_hybrid``): the unfused forward chain and the pna over
the neighbour matrix in plain PyTorch, as the JAX package computes them
outside any Pallas kernel, then K2 with a tie tolerance (``HYBRID_TIE_TOL``):
K2's recomputed ``e2`` differs from that forward's in the last ulps, so a
max/min cotangent goes to every edge within ``tie_tol * |m| + tie_tol`` of
the extremum ``m``.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/fused_block_fwd.cu``, ``csrc/fused_block_bwd.cu``); on a CPU tensor
it runs its plain PyTorch version, the same function with the same rounding
points.  There is no fallback from one to the other.

Weights follow the port's ``[out, in]`` layout: ``we``, ``w2``, ``w3`` are
``[L, L]``; ``b1``, ``b2``, ``b3``, ``lns``, ``lnb`` are ``[L]`` float32.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core import segment_ops
from hyper_graph_nets_tpu_torch.nn.mlp import dense

TILE = 64  # edges per kernel tile; must match csrc/fused_block_common.cuh
# receivers per work group at most: a group's pna runs a few rounds of K1's
# half warps however many of its receivers have no edges (an edge shard of
# the halo forward leaves most receivers empty)
GROUP_NODES = 64
WIDTHS = (32, 128)  # latent sizes the kernels are instantiated for
BWD_MODES = ("remat", "stream")
EDGE_WEIGHT_KEYS = ("we", "w2", "w3", "b1", "b2", "b3", "lns", "lnb")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FWD_SOURCE = "fused_block_fwd.cu"
BWD_SOURCE = "fused_block_bwd.cu"
LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Receiver (and sender) segments of one edge set, computed once per
    topology.

    ``row_ptr[n]:row_ptr[n+1]`` are the edges of receiver ``n``; ``groups``
    splits the receivers into runs of whole segments of at most ``TILE``
    edges and ``GROUP_NODES`` receivers (a receiver with more edges is a
    group of its own); a plan over a valid prefix (``plan_segments(...,
    num_valid=)``) adds receiver-less groups of the masked tail's edges.
    Each kernel work item is one (batch element, group).
    ``snd_perm[snd_ptr[n]:snd_ptr[n+1]]`` are the edges sent by node ``n``,
    in edge order: the backward kernels sum the sender cotangent over
    them.
    """

    row_ptr: torch.Tensor  # [N + 1] int32
    groups: torch.Tensor  # [G + 1] int32
    num_nodes: int
    num_edges: int
    snd_perm: Optional[torch.Tensor] = None  # [E] int32
    snd_ptr: Optional[torch.Tensor] = None  # [N + 1] int32
    # [G + 1] int32, row_ptr[groups] (then the masked tail's groups): the
    # groups' edge boundaries, which K1 reads ahead of its pipeline
    group_edges: Optional[torch.Tensor] = None
    # node-row bands of the compute-overlapped halo ring (K7, ops/
    # fused_overlap.py) for a rank's edge shard; 0: no overlap
    overlap_bands: int = 0
    # K7's work list for the shard (ops.fused_overlap.OverlapWork, built by
    # ops.fused_overlap.overlap_plan), or None
    overlap: Optional[object] = None
    # [N] float32: the valid in-degree of every receiver over the whole
    # edge set an edge shard belongs to (parallel.sharding.shard_topology);
    # the sharded backward divides the mean cotangent by it.  None: the
    # receivers of the call are the whole set.
    degree: Optional[torch.Tensor] = None

    @property
    def num_groups(self) -> int:
        return self.groups.shape[0] - 1

    def to(self, device) -> "SegmentPlan":
        move = lambda t: None if t is None else t.to(device)
        return dataclasses.replace(
            self,
            row_ptr=move(self.row_ptr),
            groups=move(self.groups),
            snd_perm=move(self.snd_perm),
            snd_ptr=move(self.snd_ptr),
            group_edges=move(self.group_edges),
            overlap=None if self.overlap is None else self.overlap.to(device),
            degree=move(self.degree),
        )


def _host_ids(ids, num_nodes: int, what: str) -> np.ndarray:
    a = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids, np.int64)
    if a.size and (a.min() < 0 or a.max() >= num_nodes):
        raise ValueError(f"{what} must lie in [0, {num_nodes})")
    return a


def plan_segments(
    receivers, num_nodes: int, tile: int = TILE, senders=None, num_valid: Optional[int] = None
) -> SegmentPlan:
    """Host: segment plan of a receiver-sorted edge set.

    Raises ``ValueError`` if receivers decrease anywhere or leave
    ``[0, num_nodes)``: the kernels own whole segments and need each
    receiver's edges to be contiguous.  With ``senders`` the plan also holds
    the sender order the backward kernels need.

    ``num_valid`` (the JAX package's band plans' ``num_valid``): only the
    first ``num_valid`` edges form segments and must be receiver-sorted;
    the rest are masked padding in any receiver order (a cluster-tier set's
    non-members, ``rmp.connector.build_static``).  They ride in work groups
    of at most ``tile`` edges and no receiver (``groups[g] == groups[g + 1]
    == num_nodes``), in which K1 writes ``e2`` and K2/K3 the edge streams,
    and no aggregate, ``drp`` or ``dsp`` row sees them.
    """
    rcv = _host_ids(receivers, num_nodes, "receivers")
    ev = rcv.size if num_valid is None else int(num_valid)
    if not 0 <= ev <= rcv.size:
        raise ValueError(f"num_valid {ev} outside [0, {rcv.size}]")
    if np.any(np.diff(rcv[:ev]) < 0):
        raise ValueError(
            "receivers must be non-decreasing (core.mesh.cells_to_edges "
            "sorts them); the fused kernel aggregates contiguous segments"
        )
    row_ptr = np.searchsorted(rcv[:ev], np.arange(num_nodes + 1), side="left")
    groups = [0]
    for n in range(num_nodes):
        start = groups[-1]
        if n > start and (row_ptr[n + 1] - row_ptr[start] > tile or n - start >= GROUP_NODES):
            groups.append(n)
    groups.append(num_nodes)
    group_edges = row_ptr[groups]
    if ev < rcv.size:  # the padding's receiver-less groups
        tail = np.append(np.arange(ev + tile, rcv.size, tile), rcv.size)
        groups += [num_nodes] * len(tail)
        group_edges = np.concatenate([group_edges, tail])
    groups = np.asarray(groups, np.int64)
    snd_perm = snd_ptr = None
    if senders is not None:
        snd = _host_ids(senders, num_nodes, "senders")
        if snd.shape != rcv.shape:
            raise ValueError("senders and receivers must have the same length")
        perm = np.argsort(snd, kind="stable")
        snd_perm = torch.from_numpy(perm.astype(np.int32))
        snd_ptr = torch.from_numpy(
            np.searchsorted(snd[perm], np.arange(num_nodes + 1), side="left").astype(np.int32)
        )
    return SegmentPlan(
        row_ptr=torch.from_numpy(row_ptr.astype(np.int32)),
        groups=torch.from_numpy(groups.astype(np.int32)),
        num_nodes=int(num_nodes),
        num_edges=int(rcv.size),
        snd_perm=snd_perm,
        snd_ptr=snd_ptr,
        group_edges=torch.from_numpy(group_edges.astype(np.int32)),
    )


# -- plain versions ----------------------------------------------------------
#
# float64 inputs run the same chain in float64 throughout, statistics and
# sums too: the float64 product of the chain that the float32 kernels' and
# plain versions' errors are measured against.


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the chain's accumulation type: float64 for float64, else
    float32."""
    return t if t.dtype == torch.float64 else t.float()


def _chain_weights(weights, dtype):
    """The weights as a float64 chain reads them (float64), else as given."""
    if dtype != torch.float64:
        return weights
    return {k: v.double() for k, v in weights.items()}


def _edge_mlp_reference(e, sp, rp, weights, senders, receivers):
    """``(a1, a2, z3)`` in ``e.dtype`` with the kernel's rounding points:
    every product accumulates in float32 and is rounded to ``e.dtype``; the
    first-layer sum runs left to right, each add rounded; bias adds run in
    ``e.dtype``."""
    cdt = e.dtype
    cd = None if cdt in (torch.float32, torch.float64) else cdt
    h = dense(e, weights["we"], cd) + sp[..., senders.long(), :]
    h = h + rp[..., receivers.long(), :]
    a1 = torch.relu(h + weights["b1"].to(cdt))
    a2 = torch.relu(dense(a1, weights["w2"], cd) + weights["b2"].to(cdt))
    return a1, a2, _z3_from_a2(a2, weights)


def _z3_from_a2(a2, weights):
    cdt = a2.dtype
    cd = None if cdt in (torch.float32, torch.float64) else cdt
    return dense(a2, weights["w3"], cd) + weights["b3"].to(cdt)


def _ln_stats(z3):
    """float32 LayerNorm mean and inverse sigma, ``[..., E, 1]``."""
    z = _wide(z3)
    mu = z.mean(dim=-1, keepdim=True)
    xc = z - mu
    return mu, torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + LN_EPS)


def _xhat_e2(e, z3, mu, isg, weights):
    xhat = (_wide(z3) - mu) * isg
    o = xhat * _wide(weights["lns"]) + _wide(weights["lnb"])
    return xhat, e + o.to(e.dtype)


def fused_edge_block_reference(
    e: torch.Tensor,
    sp: torch.Tensor,
    rp: torch.Tensor,
    weights: Dict[str, torch.Tensor],
    senders: torch.Tensor,
    receivers: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_nodes: int,
    save_streams: bool = False,
    raw: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch K1 with the kernel's rounding points: ``(e2, agg)``, and
    with ``save_streams`` also ``a1, a2`` (``e.dtype``) and the LayerNorm
    ``mu, isg`` (float32, ``[..., E]``).  With ``raw`` the aggregate is the
    unfinalized partials ``[sum | count | max | min]`` (-1e30 / +1e30 where
    a receiver has no valid edge), the JAX kernel's ``finalize=False``.

    LayerNorm statistics are float32; the aggregate sums the rounded ``e2``
    in float32 (float64 inputs: everything in float64).  Autograd through
    this function splits a max/min cotangent among tied edges
    (``scatter_reduce``); :class:`FusedEdgeBlock` gives each tied edge all
    of it, as the JAX package does.
    """
    weights = _chain_weights(weights, e.dtype)
    a1, a2, z3 = _edge_mlp_reference(e, sp, rp, weights, senders, receivers)
    mu, isg = _ln_stats(z3)
    _, e2 = _xhat_e2(e, z3, mu, isg, weights)
    if raw:
        agg = segment_ops.pna_partials(_wide(e2), receivers, num_nodes, mask)
    else:
        agg = segment_ops.aggregate(_wide(e2), receivers, num_nodes, "pna", mask)
    if save_streams:
        return e2, agg, a1, a2, mu[..., 0], isg[..., 0]
    return e2, agg


def ties(e2: torch.Tensor, m: torch.Tensor, tie_tol: float) -> torch.Tensor:
    """Where ``e2`` wins the extremum ``m`` (float32): equal, or within
    ``tie_tol * |m| + tie_tol`` of it (``_route_agg_cotangent``,
    ``fused_block.py:900-923``; K2's ``ties``, each operation rounded on its
    own).  ``tie_tol`` 0 is the exact compare."""
    return (e2 == m) | ((e2 - m).abs() <= tie_tol * m.abs() + tie_tol)


def _backward_reference(
    e, a1, a2, z3, mu, isg, weights, de2, drhs, senders, receivers, mask, num_nodes, e2,
    tie_tol=0.0,
):
    """The shared math of ``_bwd_kernel`` and ``_bwd_stream_kernel``
    (``_route_agg_cotangent``, ``_ln_mlp_backward``, the node sums and the
    column sums), written out step by step.  ``mu``/``isg`` are
    ``[..., E, 1]``; ``e2``, when given, is the forward's output, used for
    the tie compare in place of the value recomputed here (the two are
    equal bit for bit when the forward ran this same code); ``tie_tol``
    widens the compare (:func:`ties`)."""
    cdt = e.dtype
    cd = None if cdt in (torch.float32, torch.float64) else cdt
    L = e.shape[-1]
    xhat, e2_re = _xhat_e2(e, z3, mu, isg, weights)
    e2v = _wide(e2_re if e2 is None else e2)
    # the kernel reads drhs in the compute type; each edge its receiver's row
    got = _wide(drhs.to(cdt))[..., receivers.long(), :]
    g1, mx, gmx, mn, gmn = got.split(L, dim=-1)
    route = g1 + torch.where(ties(e2v, mx, tie_tol), gmx, 0.0)  # every tied edge: all of it
    route = route + torch.where(ties(e2v, mn, tie_tol), gmn, 0.0)
    valid = None if mask is None else (mask > 0)[:, None]
    if valid is not None:
        route = torch.where(valid, route, 0.0)
    do = _wide(de2) + route
    dxhat = do * _wide(weights["lns"])
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dz3 = ((dxhat - m1 - xhat * m2) * isg).to(cdt)
    # backward products: dense(x, w.T) = x @ w for an [out, in] weight
    dz2 = torch.where(a2 > 0, dense(dz3, weights["w3"].T, cd), 0.0)
    dh = torch.where(a1 > 0, dense(dz2, weights["w2"].T, cd), 0.0)
    de = (do + _wide(dh) @ _wide(weights["we"].to(cdt))).to(cdt)
    dh32 = _wide(dh) if valid is None else torch.where(valid, _wide(dh), 0.0)
    node_shape = e.shape[:-2] + (num_nodes, L)
    nd = len(node_shape) - 2
    dsp = dh32.new_zeros(node_shape).index_add_(nd, senders.long(), dh32)
    drp = dh32.new_zeros(node_shape).index_add_(nd, receivers.long(), dh32)
    cols = lambda x: _wide(x).reshape(-1, L).sum(dim=0)
    dpar = torch.stack([cols(dh), cols(dz2), cols(dz3), cols(do * xhat), cols(do)])
    return de, dh, dz2, dz3, dsp, drp, dpar


def fused_edge_block_bwd_reference(
    e, sp, rp, weights, de2, drhs, senders, receivers, mask, num_nodes, forward=None, tie_tol=0.0
):
    """Plain K2: recompute the forward chain as K1 does, then the backward.

    ``de2`` is the ``e2`` cotangent in ``e.dtype``; ``drhs`` is float32
    ``[..., N, 5L]``: ``[g_sum + g_mean/deg | max | g_max | min | g_min]``.
    Returns ``(de, dh, dz2, dz3, a1, a2, dsp, drp, dpar)``: edge streams in
    ``e.dtype``, ``dsp``/``drp`` float32 ``[..., N, L]`` over valid edges,
    ``dpar`` float32 ``[5, L]`` (column sums of dh, dz2, dz3, do*xhat, do).

    ``forward = (e2, a1, a2)`` of a forward run that made ``drhs``'s extrema
    replaces the recomputed values in the relu masks and the tie compare
    (``z3`` and the statistics are still recomputed): a kernel is held
    against this plain version on the kernel forward's values, because a
    product summed in another order may move an ``h`` within one rounding
    of 0 to the other side, or break a tie.

    ``tie_tol`` widens the tie compare (:func:`ties`; the hybrid's).
    float64 inputs (``e``, ``sp``, ``rp``, ``de2``; ``drhs`` and ``forward``
    are widened) run the chain in float64."""
    weights = _chain_weights(weights, e.dtype)
    if forward is None:
        a1, a2, z3 = _edge_mlp_reference(e, sp, rp, weights, senders, receivers)
        e2 = None
    else:
        if e.dtype == torch.float64:
            forward = tuple(t.double() for t in forward)
        e2, a1, a2 = forward
        z3 = _z3_from_a2(a2, weights)
    mu, isg = _ln_stats(z3)
    de, dh, dz2, dz3, dsp, drp, dpar = _backward_reference(
        e, a1, a2, z3, mu, isg, weights, de2, drhs, senders, receivers, mask,
        num_nodes, e2, tie_tol,
    )
    return de, dh, dz2, dz3, a1, a2, dsp, drp, dpar


def fused_edge_block_bwd_stream_reference(
    e, a1, a2, mu, isg, weights, de2, drhs, senders, receivers, mask, num_nodes,
    e2=None,
):
    """Plain K3: ``z3 = a2 @ W3 + b3`` from the saved ``a2``, the saved
    ``mu``/``isg`` (float32 ``[..., E]``), then K2's backward.  Returns
    ``(de, dh, dz2, dz3, dsp, drp, dpar)``; ``e2``, when given, is the
    forward's output for the tie compare (see
    :func:`fused_edge_block_bwd_reference`)."""
    weights = _chain_weights(weights, e.dtype)
    return _backward_reference(
        e, a1, a2, _z3_from_a2(a2, weights), mu[..., None], isg[..., None], weights, de2, drhs,
        senders, receivers, mask, num_nodes, e2,
    )


# -- the kernels -------------------------------------------------------------

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    FWD_SOURCE: {"hgn_fused_block_fwd": [_ci, _ci] + [_vp] * 23 + [_ci] * 5 + [_vp]},
    BWD_SOURCE: {
        "hgn_fused_block_bwd": [_ci, _ci, _ci] + [_vp] * 34 + [_ci] * 4 + [ctypes.c_float, _vp],
        "hgn_fused_block_bwd_ctas": [_ci, _ci, _ci],
    },
}
_libs: Dict[tuple, ctypes.CDLL] = {}


def _lib(source: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The built library of ``source`` with its C signatures, loaded at
    first launch.  ``defines`` name a probe build (``HGN_FWD_PHASES`` for
    K1, ``HGN_BWD_PHASES`` for K2/K3), a library of its own that the main
    path never loads."""
    key = (source, tuple(defines))
    if key not in _libs:
        from hyper_graph_nets_tpu_torch.ops import build

        lib = build.load(build.source_path(source), defines)
        for name, argtypes in _SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _ci
        lib.hgn_cuda_error_string.argtypes = [_ci]
        lib.hgn_cuda_error_string.restype = ctypes.c_char_p
        _libs[key] = lib
    return _libs[key]


def _check(cond: bool, what: str):
    if not cond:
        raise ValueError(f"fused_edge_block: {what}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    if t is None:
        return None
    _check(t.data_ptr() % 16 == 0, "tensor data must be 16-byte aligned")
    return t.data_ptr()


def _raise_on(rc: int, lib: ctypes.CDLL, what: str):
    if rc != 0:
        msg = "unsupported dtype/width" if rc < 0 else lib.hgn_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed ({rc}): {msg}")


def _validate(e, node_parts, senders, receivers, mask, num_nodes, plan):
    """Checks shared by the kernel wrappers; returns ``(B, E, L)``."""
    _check(e.device.type == "cuda", f"unsupported device {e.device}")
    _check(e.dim() == 3, f"e must be [B, E, L], got {tuple(e.shape)}")
    B, E, L = e.shape
    _check(e.dtype in _DTYPES, f"dtype {e.dtype} not supported")
    _check(L in WIDTHS, f"latent size {L} not in {WIDTHS}")
    for name, t in node_parts.items():
        _check(t.shape == (B, num_nodes, L), f"{name} shape {tuple(t.shape)}")
        _check(t.dtype == e.dtype, f"{name} dtype {t.dtype} != {e.dtype}")
    tensors = [e, *node_parts.values(), senders, receivers] + ([mask] if mask is not None else [])
    for t in tensors:
        _check(t.device == e.device, "all tensors must be on one device")
        _check(t.is_contiguous(), "tensors must be contiguous")
    _check(senders.dtype == torch.int32 and senders.shape == (E,), "senders int32 [E]")
    _check(receivers.dtype == torch.int32 and receivers.shape == (E,), "receivers int32 [E]")
    if mask is not None:
        _check(mask.dtype == torch.float32 and mask.shape == (E,), "mask float32 [E]")
    _check(plan.num_nodes == num_nodes and plan.num_edges == E, "plan does not match")
    _check(plan.row_ptr.device == e.device, "plan must be on the tensors' device")
    return B, E, L


def _kernel_weights(weights, dtype, L, device):
    """Weights in the compute type and float32 vectors, contiguous."""
    w = {k: weights[k].detach().to(dtype).contiguous() for k in ("we", "w2", "w3")}
    p = {
        k: weights[k].detach().to(torch.float32).contiguous()
        for k in ("b1", "b2", "b3", "lns", "lnb")
    }
    for k, t in w.items():
        _check(t.shape == (L, L) and t.device == device, f"{k} must be [L, L] on device")
    for k, t in p.items():
        _check(t.shape == (L,) and t.device == device, f"{k} must be [L] on device")
    return w, p


def _resolve_plan(plan, senders, receivers, num_nodes, device) -> SegmentPlan:
    if plan is None:
        plan = plan_segments(receivers, num_nodes, senders=senders).to(device)
    return plan


def _k1_launch(e, sp, rp, weights, senders, receivers, mask, num_nodes, plan, save_streams, raw, lib=None):
    """One launch of K1 on the current stream.  ``lib``: another build of
    the source (the phase probe), else the main path's."""
    plan = _resolve_plan(plan, senders, receivers, num_nodes, e.device)
    B, E, L = _validate(e, {"sp": sp, "rp": rp}, senders, receivers, mask, num_nodes, plan)
    w, p = _kernel_weights(weights, e.dtype, L, e.device)
    lib = lib or _lib(FWD_SOURCE)
    e2 = torch.empty_like(e)
    agg = torch.empty((B, num_nodes, 4 * L), dtype=torch.float32, device=e.device)
    streams = ()
    if save_streams:
        stats = lambda: torch.empty((B, E), dtype=torch.float32, device=e.device)
        streams = (torch.empty_like(e), torch.empty_like(e), stats(), stats())
    a1, a2, mu, isg = streams or (None,) * 4
    rc = lib.hgn_fused_block_fwd(
        _DTYPES[e.dtype], L,
        _ptr(e), _ptr(sp), _ptr(rp), _ptr(w["we"]), _ptr(w["w2"]), _ptr(w["w3"]),
        _ptr(p["b1"]), _ptr(p["b2"]), _ptr(p["b3"]), _ptr(p["lns"]), _ptr(p["lnb"]),
        _ptr(senders), _ptr(receivers), _ptr(mask), _ptr(plan.row_ptr), _ptr(plan.groups),
        _ptr(plan.group_edges), _ptr(e2), _ptr(agg), _ptr(a1), _ptr(a2), _ptr(mu), _ptr(isg),
        B, E, num_nodes, plan.num_groups, int(raw),
        torch.cuda.current_stream(e.device).cuda_stream,
    )
    _raise_on(rc, lib, "fused_edge_block")
    fused_edge_block.launches += 1
    return (e2, agg) + streams


def _bwd_launch(
    stream_mode, e, sp, rp, streams, weights, de2, drhs, senders, receivers, mask,
    num_nodes, plan, lib=None, tie_tol=0.0,
):
    """One launch of K2 (``stream_mode`` 0) or K3 (1): the main kernel, the
    sender sums and the column-sum reduction, on the current stream.
    ``lib``: another build of the source (the phase probe), else the main
    path's; ``tie_tol``: the tie compare's tolerance (0: exact)."""
    plan = _resolve_plan(plan, senders, receivers, num_nodes, e.device)
    nodes = {} if stream_mode else {"sp": sp, "rp": rp}
    B, E, L = _validate(e, nodes, senders, receivers, mask, num_nodes, plan)
    _check(
        plan.snd_perm is not None and plan.snd_ptr.device == e.device,
        "the backward needs the plan's sender order: plan_segments(..., senders=...)",
    )
    _check(plan.group_edges is not None, "the plan must hold group_edges (plan_segments)")
    _check(de2.shape == e.shape and de2.dtype == e.dtype and de2.is_contiguous(), "de2")
    _check(
        drhs.shape == (B, num_nodes, 5 * L) and drhs.dtype == torch.float32
        and drhs.is_contiguous(),
        "drhs must be float32 [B, N, 5L]",
    )
    a1_in = a2_in = mu_in = isg_in = None
    if stream_mode:
        a1_in, a2_in, mu_in, isg_in = streams
        for t in (a1_in, a2_in):
            _check(t.shape == e.shape and t.dtype == e.dtype and t.is_contiguous(), "a1/a2")
        for t in (mu_in, isg_in):
            _check(t.shape == (B, E) and t.dtype == torch.float32 and t.is_contiguous(), "mu/isg")
    w, p = _kernel_weights(weights, e.dtype, L, e.device)
    lib = lib or _lib(BWD_SOURCE)
    dt = _DTYPES[e.dtype]
    ctas = lib.hgn_fused_block_bwd_ctas(dt, L, stream_mode)
    if ctas <= 0:
        _raise_on(-ctas if ctas < 0 else -1, lib, "fused_edge_block backward")
    new = lambda: torch.empty_like(e)
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=e.device)
    de, dh, dz2, dz3 = new(), new(), new(), new()
    a1_out, a2_out = (None, None) if stream_mode else (new(), new())
    dsp, drp, dpar = f32(B, num_nodes, L), f32(B, num_nodes, L), f32(5, L)
    part = f32(ctas, 5 * L)
    rc = lib.hgn_fused_block_bwd(
        dt, L, stream_mode,
        _ptr(e), _ptr(sp if not stream_mode else None), _ptr(rp if not stream_mode else None),
        _ptr(a1_in), _ptr(a2_in), _ptr(mu_in), _ptr(isg_in),
        _ptr(w["we"]), _ptr(w["w2"]), _ptr(w["w3"]),
        _ptr(p["b1"]), _ptr(p["b2"]), _ptr(p["b3"]), _ptr(p["lns"]), _ptr(p["lnb"]),
        _ptr(de2), _ptr(drhs),
        _ptr(senders), _ptr(receivers), _ptr(mask), _ptr(plan.row_ptr), _ptr(plan.group_edges),
        _ptr(plan.snd_perm), _ptr(plan.snd_ptr),
        _ptr(de), _ptr(dh), _ptr(dz2), _ptr(dz3), _ptr(a1_out), _ptr(a2_out),
        _ptr(dsp), _ptr(drp), _ptr(dpar), _ptr(part),
        B, E, num_nodes, plan.num_groups, float(tie_tol),
        torch.cuda.current_stream(e.device).cuda_stream,
    )
    _raise_on(rc, lib, "fused_edge_block backward")
    if stream_mode:
        return de, dh, dz2, dz3, dsp, drp, dpar
    return de, dh, dz2, dz3, a1_out, a2_out, dsp, drp, dpar


def fused_edge_block_bwd(
    e, sp, rp, weights, de2, drhs, senders, receivers, mask, num_nodes, plan=None, tie_tol=0.0
):
    """K2, the remat backward, on ``[B, E, L]`` inputs: see
    :func:`fused_edge_block_bwd_reference` for the arguments and results.
    A CUDA tensor launches the kernel (counted on ``launches``, and on
    ``tie_launches`` too with ``tie_tol`` above 0); a CPU tensor runs the
    plain version."""
    if e.device.type == "cpu":
        return fused_edge_block_bwd_reference(
            e, sp, rp, weights, de2, drhs, senders, receivers, mask, num_nodes, tie_tol=tie_tol
        )
    with torch.cuda.device(e.device):
        outs = _bwd_launch(
            0, e, sp, rp, None, weights, de2, drhs, senders, receivers, mask, num_nodes, plan,
            tie_tol=tie_tol,
        )
    fused_edge_block_bwd.launches += 1
    fused_edge_block_bwd.tie_launches += int(tie_tol > 0)
    return outs


def fused_edge_block_bwd_stream(
    e, a1, a2, mu, isg, weights, de2, drhs, senders, receivers, mask, num_nodes, plan=None
):
    """K3, the stream backward, on ``[B, E, L]`` inputs: see
    :func:`fused_edge_block_bwd_stream_reference`.  A CUDA tensor launches
    the kernel; a CPU tensor runs the plain version."""
    if e.device.type == "cpu":
        return fused_edge_block_bwd_stream_reference(
            e, a1, a2, mu, isg, weights, de2, drhs, senders, receivers, mask, num_nodes
        )
    with torch.cuda.device(e.device):
        outs = _bwd_launch(
            1, e, None, None, (a1, a2, mu, isg), weights, de2, drhs, senders, receivers,
            mask, num_nodes, plan,
        )
    fused_edge_block_bwd_stream.launches += 1
    return outs


# kernel launches since the count was last reset (tie_launches: K2's with
# a tie tolerance, the hybrid's; each is in launches too)
fused_edge_block_bwd.launches = 0
fused_edge_block_bwd.tie_launches = 0
fused_edge_block_bwd_stream.launches = 0


# -- the autograd function ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Edges:
    """The non-differentiable inputs of one fused call."""

    senders: torch.Tensor
    receivers: torch.Tensor
    mask: Optional[torch.Tensor]
    num_nodes: int
    plan: Optional[SegmentPlan]
    bwd: str
    tie_tol: float = 0.0  # K2's tie compare (the hybrid's HYBRID_TIE_TOL)

    @property
    def topology(self):
        return self.senders, self.receivers, self.mask, self.num_nodes


def fused_edge_block_fwd(
    e, sp, rp, weights, senders, receivers, mask, num_nodes, plan=None, save_streams=False,
    raw=False,
):
    """K1 on ``[B, E, L]`` inputs: ``(e2, agg)``, and with ``save_streams``
    also ``a1, a2, mu, isg`` (see :func:`fused_edge_block_reference`); with
    ``raw`` the aggregate is the unfinalized partials.  A CUDA tensor
    launches the kernel (counted on ``fused_edge_block.launches``); a CPU
    tensor runs the plain version."""
    if e.device.type == "cpu":
        return fused_edge_block_reference(
            e, sp, rp, weights, senders, receivers, mask, num_nodes, save_streams=save_streams,
            raw=raw,
        )
    with torch.cuda.device(e.device):  # the kernels' launch state is per device
        return _k1_launch(
            e, sp, rp, weights, senders, receivers, mask, num_nodes, plan, save_streams, raw
        )


def agg_cotangent_rhs(agg, dagg, receivers, mask, num_nodes, degree=None) -> torch.Tensor:
    """``drhs = [g_sum + g_mean/deg | max | g_max | min | g_min]``, float32
    ``[..., N, 5L]``, from the finalized aggregate and its cotangent
    (``_bwd_core``, ``fused_block.py:1556-1569``).  ``deg`` is ``degree``
    when given (an edge shard's: the valid in-degree over every shard, the
    count the forward's mean divided by), else each receiver's valid edges
    among ``receivers``.  The JAX package's sharded backward counts the
    shard's own edges (``_plan_degrees`` of the shard's plan), which is not
    the forward's count: the port takes the global one."""
    L = agg.shape[-1] // 4
    if degree is None:
        counts = torch.ones(receivers.shape, device=agg.device) if mask is None else (mask > 0).float()
        deg = torch.zeros(num_nodes, device=agg.device).index_add_(0, receivers.long(), counts)
    else:
        deg = degree.to(device=agg.device, dtype=torch.float32)
    d = dagg.float()
    g1 = d[..., :L] + d[..., L : 2 * L] * (1.0 / deg.clamp(min=1.0))[:, None]
    parts = [g1, agg[..., 2 * L : 3 * L], d[..., 2 * L : 3 * L], agg[..., 3 * L :], d[..., 3 * L :]]
    return torch.cat(parts, dim=-1).contiguous()


class FusedEdgeBlock(torch.autograd.Function):
    """K1 forward; K2 (``remat``) or K3 (``stream``) backward.

    Differentiable inputs: ``e, sp, rp`` (``[B, E, L]``, ``[B, N, L]``) and
    the eight edge weights.  The forward saves what ``_fused_fwd`` saves:
    the inputs, the weights, the finalized ``agg`` and, with ``stream``,
    K1's ``a1, a2, mu, isg``.  The backward builds ``drhs``, runs K2 or K3,
    and takes the weight gradients as float32 products over the streams
    (``e^T dh``, ``a1^T dz2``, ``a2^T dz3``), as the JAX package leaves them
    to XLA.
    """

    @staticmethod
    def forward(ctx, e, sp, rp, we, w2, w3, b1, b2, b3, lns, lnb, edges: _Edges):
        weights = dict(zip(EDGE_WEIGHT_KEYS, (we, w2, w3, b1, b2, b3, lns, lnb)))
        outs = fused_edge_block_fwd(
            e, sp, rp, weights, *edges.topology, edges.plan, save_streams=edges.bwd == "stream"
        )
        ctx.edges = edges
        ctx.save_for_backward(e, sp, rp, we, w2, w3, b1, b2, b3, lns, lnb, outs[1], *outs[2:])
        return outs[0], outs[1]

    @staticmethod
    def backward(ctx, de2, dagg):
        e, sp, rp, *rest = ctx.saved_tensors
        return (*_edge_block_grads(e, sp, rp, rest[:8], rest[8], de2, dagg, ctx.edges, rest[9:]), None)


def _edge_block_grads(e, sp, rp, w_in, agg, de2, dagg, edges: _Edges, streams=(), degree=None):
    """``(de, dsp, drp, *dweights)`` of one fused call: ``drhs`` from the
    finalized ``agg`` and its cotangent, K2 (or K3 on K1's ``streams``), and
    the weight gradients as float32 products over the streams (``e^T dh``,
    ``a1^T dz2``, ``a2^T dz3``), as the JAX package leaves them to XLA."""
    weights = dict(zip(EDGE_WEIGHT_KEYS, w_in))
    L = e.shape[-1]
    de2 = torch.zeros_like(e) if de2 is None else de2
    de2 = torch.where(torch.isnan(de2), 0.0, de2).to(e.dtype).contiguous()
    drhs = agg_cotangent_rhs(agg, dagg, edges.receivers, edges.mask, edges.num_nodes, degree)
    if streams:
        a1, a2 = streams[0], streams[1]
        de, dh, dz2, dz3, dsp, drp, dpar = fused_edge_block_bwd_stream(
            e, *streams, weights, de2, drhs, *edges.topology, plan=edges.plan
        )
    else:
        de, dh, dz2, dz3, a1, a2, dsp, drp, dpar = fused_edge_block_bwd(
            e, sp, rp, weights, de2, drhs, *edges.topology, plan=edges.plan, tie_tol=edges.tie_tol
        )
    flat = lambda x: x.reshape(-1, L).float()
    dw = [flat(dh).T @ flat(e), flat(dz2).T @ flat(a1), flat(dz3).T @ flat(a2)]
    dw += list(dpar)
    dw = [g.to(w.dtype) for g, w in zip(dw, w_in)]
    return (de, dsp.to(sp.dtype), drp.to(rp.dtype), *dw)


def fused_edge_block(
    e: torch.Tensor,
    sp: torch.Tensor,
    rp: torch.Tensor,
    weights: Dict[str, torch.Tensor],
    senders: torch.Tensor,
    receivers: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_nodes: int,
    plan: Optional[SegmentPlan] = None,
    bwd: str = "remat",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused edge update + pna aggregate; returns ``(e2, agg)``.

    ``e`` is ``[E, L]`` or ``[B, E, L]`` (float32 or bfloat16); ``sp``/``rp``
    are ``[N, L]`` or ``[B, N, L]`` of the same dtype; ``agg`` is float32
    ``[..., N, 4L]``.  ``plan`` is the edge set's :class:`SegmentPlan` on the
    tensors' device (built from the indices when omitted).  When anything
    requires grad, the call goes through :class:`FusedEdgeBlock` and ``bwd``
    picks its backward (``'remat'``: K2, ``'stream'``: K3); otherwise it is
    one K1 launch that saves nothing.
    """
    if bwd not in BWD_MODES:
        raise ValueError(f"fused_bwd must be 'remat' or 'stream', got {bwd!r}")
    if e.device.type == "cuda":  # one plan for the forward and the backward
        plan = _resolve_plan(plan, senders, receivers, num_nodes, e.device)
    edges = _Edges(senders, receivers, mask, num_nodes, plan, bwd)
    squeeze = e.dim() == 2
    e3, sp3, rp3 = (e[None], sp[None], rp[None]) if squeeze else (e, sp, rp)
    wts = [weights[k] for k in EDGE_WEIGHT_KEYS]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (e3, sp3, rp3, *wts)):
        e2, agg = FusedEdgeBlock.apply(e3, sp3, rp3, *wts, edges)
    else:
        e2, agg = fused_edge_block_fwd(e3, sp3, rp3, weights, *edges.topology, plan)
    if squeeze:
        e2, agg = e2[0], agg[0]
    return e2, agg


fused_edge_block.launches = 0  # K1 launches since the count was last reset


# -- the hybrid: an unfused forward, then K2 with a tie tolerance ---------------

# K2's tie tolerance after the hybrid's forward (_hybrid_bwd, fused_block.py:
# 1680): the forward's e2 and K2's recompute differ by reassociation in
# float32 (about 1e-6 relative) and by up to one bf16 rounding (2**-8)
HYBRID_TIE_TOL = {torch.bfloat16: 2.0**-8, torch.float32: 1e-5}


def hybrid_forward(e, sp, rp, weights, senders, receivers, gather_idx, gather_valid):
    """The hybrid's forward (``_xla_fwd_math``, ``fused_block.py:1628-1650``)
    in plain PyTorch: the unfused chain with K1's rounding points (the
    factored first layer, relu, the second and third products, LayerNorm
    with float32 statistics, the residual), then the pna over the neighbour
    matrix (``core.segment_ops.gather_aggregate``): ``(e2, agg)``, ``agg``
    float32 over ``gather_idx``'s rows."""
    _, _, z3 = _edge_mlp_reference(e, sp, rp, weights, senders, receivers)
    mu, isg = _ln_stats(z3)
    _, e2 = _xhat_e2(e, z3, mu, isg, weights)
    return e2, segment_ops.gather_aggregate(e2, gather_idx, gather_valid, "pna").float()


def _rows_to(agg: torch.Tensor, rows: int) -> torch.Tensor:
    """``agg`` cut, or padded with zero rows, to ``rows`` node rows."""
    have = agg.shape[-2]
    if have >= rows:
        return agg[..., :rows, :]
    return torch.cat([agg, agg.new_zeros(agg.shape[:-2] + (rows - have, agg.shape[-1]))], dim=-2)


class HybridEdgeBlock(torch.autograd.Function):
    """The hybrid's autograd node (``_hybrid_vjp``): :func:`hybrid_forward`,
    then K2 with ``edges.tie_tol``.

    The forward saves what ``_hybrid_fwd`` saves: the inputs, the weights,
    ``agg`` over the plan's rows (cut, or padded with zero rows as
    ``_hybrid_bwd`` pads it) and the plan (in ``edges``).  K2 needs no other
    padding: the port's plan covers the set's own edges and rows.  The
    backward is :class:`FusedEdgeBlock`'s remat one: ``drhs`` from the
    saved ``agg``, K2, the float32 weight-gradient products."""

    @staticmethod
    def forward(ctx, e, sp, rp, we, w2, w3, b1, b2, b3, lns, lnb, edges: _Edges, gather_idx, gather_valid):
        weights = dict(zip(EDGE_WEIGHT_KEYS, (we, w2, w3, b1, b2, b3, lns, lnb)))
        e2, agg = hybrid_forward(e, sp, rp, weights, edges.senders, edges.receivers, gather_idx, gather_valid)
        agg = _rows_to(agg, edges.num_nodes)
        ctx.edges = edges
        ctx.save_for_backward(e, sp, rp, we, w2, w3, b1, b2, b3, lns, lnb, agg)
        return e2, agg

    @staticmethod
    def backward(ctx, de2, dagg):
        e, sp, rp, *rest = ctx.saved_tensors
        return (*_edge_block_grads(e, sp, rp, rest[:8], rest[8], de2, dagg, ctx.edges), None, None, None)


def fused_edge_block_hybrid(
    e: torch.Tensor,
    sp: torch.Tensor,
    rp: torch.Tensor,
    weights: Dict[str, torch.Tensor],
    senders: torch.Tensor,
    receivers: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_nodes: int,
    gather_idx: torch.Tensor,
    gather_valid: torch.Tensor,
    plan: Optional[SegmentPlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``fused_edge_block_hybrid``: ``(e2, agg)`` as
    :func:`fused_edge_block` returns them, from an unfused forward
    (:func:`hybrid_forward`, no kernel) and, under autograd, K2 with the
    dtype's ``HYBRID_TIE_TOL`` in :class:`HybridEdgeBlock`.
    ``gather_idx``/``gather_valid`` are the set's ``[N, d]`` neighbour
    matrix (the forward's aggregate), ``plan`` K2's (built from the indices
    when omitted, on the card)."""
    if e.device.type == "cuda":
        plan = _resolve_plan(plan, senders, receivers, num_nodes, e.device)
    squeeze = e.dim() == 2
    e3, sp3, rp3 = (e[None], sp[None], rp[None]) if squeeze else (e, sp, rp)
    wts = [weights[k] for k in EDGE_WEIGHT_KEYS]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (e3, sp3, rp3, *wts)):
        edges = _Edges(senders, receivers, mask, num_nodes, plan, "remat", HYBRID_TIE_TOL[e.dtype])
        e2, agg = HybridEdgeBlock.apply(e3, sp3, rp3, *wts, edges, gather_idx, gather_valid)
    else:
        e2, agg = hybrid_forward(e3, sp3, rp3, weights, senders, receivers, gather_idx, gather_valid)
        agg = _rows_to(agg, num_nodes)
    if squeeze:
        e2, agg = e2[0], agg[0]
    return e2, agg


# -- the edge-sharded block (halo forward and sharded training step) ----------


class ShardedFusedBlock(torch.autograd.Function):
    """The fused block over the edge shards of one ``data`` row of a rank
    group, as one autograd node over every shard (the JAX package's
    ``_spmd_vjp``, whose custom VJP sits at the global level around its
    ``shard_map``).

    The forward is computed before (K1 raw on each shard and the all-reduce,
    or K7); this node takes each rank's ``e, sp, rp`` and eight weights and
    returns each rank's ``(e2, agg)``.  Its backward sums the ranks'
    aggregate cotangents in rank order (the transpose of handing every rank
    the all-reduced aggregate), then runs K2 on each shard against the
    global aggregate, with the mean cotangent divided by the global degree,
    and returns each shard's ``de`` and its partial ``dsp``, ``drp`` and
    weight gradients: a rank's node rows and weights are its own copy, and
    the partials of every copy add up to the gradient.

    Being one node, its backward waits for no other rank: the autograd
    engine runs it when every rank's cotangent is in, on whichever thread it
    runs the device's nodes (one per card, shared by every rank there), so
    no collective ever waits inside the engine.

    In a pod whose ``graph`` row spans processes (``row``: the group and
    one of the row's ranks) each process's node holds its own shards of the
    row, and its backward gathers the other processes' aggregate cotangents
    (``RankGroup.cotangents``) and sums every rank's in global rank order
    before K2: a collective inside the engine, which every process reaches
    in one order, since each such node takes the previous one's token as
    its last input and returns the next token as its last output
    (``RankGroup.token``/``chain``).
    """

    @staticmethod
    def forward(ctx, spec, *flat):
        # flat: per rank e, sp, rp, the 8 weights (then the token on a row
        # that spans processes); spec: (per rank (edges, degree, e2, agg),
        # the forward's results, and the row or None)
        shards, ctx.row = spec
        ctx.spec = [(edges, degree) for edges, degree, _, _ in shards]
        outs = [t for _, _, e2, agg in shards for t in (e2, agg)]
        ctx.save_for_backward(*flat[: 11 * len(shards)], *outs[1::2])
        return tuple(outs) + ((torch.zeros(()),) if ctx.row else ())

    @staticmethod
    def backward(ctx, *grads):
        n = len(ctx.spec)
        saved = ctx.saved_tensors
        segment_ops.used_on_this_stream(*saved, *grads[: 2 * n], *(
            t for edges, _ in ctx.spec for t in (edges.senders, edges.receivers, edges.mask)))
        inputs, aggs = saved[: 11 * n], saved[11 * n :]
        home = aggs[0]
        dagg = segment_ops.sum_cotangents([grads[2 * g + 1] for g in range(n)], home, ctx.row)
        out = [None]
        for g, (edges, degree) in enumerate(ctx.spec):
            e, sp, rp, *w_in = inputs[11 * g : 11 * g + 11]
            with torch.cuda.device(e.device) if e.is_cuda else contextlib.nullcontext():
                out += _edge_block_grads(
                    e, sp, rp, w_in, aggs[g], grads[2 * g], dagg.to(e.device), edges, degree=degree
                )
        segment_ops.join_streams([home.device] + [inputs[11 * g].device for g in range(n)])
        return tuple(out) + ((torch.zeros(()),) if ctx.row else ())


def fused_edge_block_spmd(
    e: torch.Tensor,
    sp: torch.Tensor,
    rp: torch.Tensor,
    weights: Dict[str, torch.Tensor],
    senders: torch.Tensor,
    receivers: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_nodes: int,
    plan: Optional[SegmentPlan],
    group,
    overlap: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's edge shard of the fused block over a rank group (called
    inside ``group.run``; the JAX package's ``fused_edge_block_spmd``,
    ``fused_block.py:1942-2124``, and, without autograd, its
    ``fused_edge_block_collective``): ``(e2 [..., E, L], agg [..., N, 4L]
    float32)`` for ``e`` of ``[E, L]`` or ``[B, E, L]``.

    Forward: K1 unfinalized on the shard, then the group's plain all-reduce
    along ``graph`` and the finalize; or, with ``overlap`` and a plan that
    carries overlap bands, K7, which rings along ``graph`` while later
    groups compute (one launch for every rank).  Under autograd every
    ``data`` row's shards meet in one :class:`ShardedFusedBlock` node, whose
    backward runs K2 on each shard at the global degree (``plan.degree``; a
    plan without one divides by the shard's own, the JAX package's
    behaviour).  The backward is remat (K2) whatever ``fused_bwd`` says, as
    in the JAX package."""
    weights = {k: weights[k] for k in EDGE_WEIGHT_KEYS}
    squeeze = e.dim() == 2
    if squeeze:
        e, sp, rp = e[None], sp[None], rp[None]
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (e, sp, rp, *weights.values()))
    bands = plan.overlap_bands if overlap and plan is not None else None
    entry = dict(e=e, sp=sp, rp=rp, weights=weights, senders=senders, receivers=receivers, mask=mask,
                 plan=plan, grad=grad, bands=bands)
    if not bands:
        with torch.no_grad():
            entry["out"] = fused_edge_block_fwd(
                e, sp, rp, weights, senders, receivers, mask, num_nodes, plan, raw=True
            )
    e2, agg = group.exchange(entry, lambda entries: _spmd_combine(entries, num_nodes, group))
    return (e2[0], agg[0]) if squeeze else (e2, agg)


def _spmd_combine(entries, num_nodes: int, group):
    """The rendezvous of :func:`fused_edge_block_spmd`: every rank's forward
    finished, then one autograd node per ``data`` row."""
    with torch.no_grad():
        if entries[0]["bands"]:
            from hyper_graph_nets_tpu_torch.ops.fused_overlap import fused_edge_block_overlap

            shards = [{k: x[k] for k in ("e", "sp", "rp", "weights", "senders", "receivers", "mask", "plan")}
                      for x in entries]
            outs = fused_edge_block_overlap(shards, num_nodes, group, entries[0]["bands"])
        else:
            L = entries[0]["e"].shape[-1]
            e2s = [x["out"][0] for x in entries]
            outs = list(zip(e2s, segment_ops.combine_partials(group, [x["out"][1] for x in entries], L)[0]))
    if not entries[0]["grad"]:
        return outs
    results: list = [None] * group.n
    for ranks in group.subgroups("graph"):
        spec, flat = [], []
        for r in ranks:
            x = entries[r]
            edges = _Edges(x["senders"], x["receivers"], x["mask"], num_nodes, x["plan"], "remat")
            spec.append((edges, None if x["plan"] is None else x["plan"].degree, *outs[r]))
            flat += [x["e"], x["sp"], x["rp"], *x["weights"].values()]
        row = (group, ranks[0]) if group.crosses(ranks[0]) else None
        got = ShardedFusedBlock.apply((spec, row), *flat, *([group.token()] if row else []))
        if row:
            group.chain(got[-1])
        for i, r in enumerate(ranks):
            results[r] = (got[2 * i], got[2 * i + 1])
    return results
