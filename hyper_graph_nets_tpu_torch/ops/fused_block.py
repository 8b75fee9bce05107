"""Fused edge block (K1): gather -> edge MLP -> LayerNorm -> residual -> pna.

Counterpart of ``hyper_graph_nets_tpu/ops/pallas/fused_block.py``
(``fused_edge_block`` over ``_fwd_kernel``).  For receiver-sorted edges:

    h   = ((e @ We + SP[snd]) + RP[rcv]) + b1
    e2  = e + LN(relu(relu(h) @ W2 + b2) @ W3 + b3)
    agg = [sum | mean | max | min] of e2 per receiver (float32, empty -> 0)

On a CUDA tensor :func:`fused_edge_block` launches the hand-written kernel in
``csrc/fused_block_fwd.cu``; on a CPU tensor it runs
:func:`fused_edge_block_reference`, the same function in plain PyTorch with
the same rounding points.  There is no fallback from one to the other.

Weights follow the port's ``[out, in]`` layout: ``we``, ``w2``, ``w3`` are
``[L, L]``; ``b1``, ``b2``, ``b3``, ``lns``, ``lnb`` are ``[L]`` float32.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core import segment_ops
from hyper_graph_nets_tpu_torch.nn.mlp import dense, layer_norm

TILE = 64  # edges per kernel tile; must match csrc/fused_block_fwd.cu
WIDTHS = (32, 128)  # latent sizes the kernel is instantiated for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SOURCE = "fused_block_fwd.cu"


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """Receiver segments of one edge set, computed once per topology.

    ``row_ptr[n]:row_ptr[n+1]`` are the edges of receiver ``n``; ``groups``
    splits the receivers into runs of whole segments of at most ``TILE``
    edges (a receiver with more edges is a group of its own).  Each kernel
    work item is one (batch element, group).
    """

    row_ptr: torch.Tensor  # [N + 1] int32
    groups: torch.Tensor  # [G + 1] int32
    num_nodes: int
    num_edges: int

    @property
    def num_groups(self) -> int:
        return self.groups.shape[0] - 1

    def to(self, device) -> "SegmentPlan":
        return dataclasses.replace(
            self, row_ptr=self.row_ptr.to(device), groups=self.groups.to(device)
        )


def plan_segments(receivers, num_nodes: int, tile: int = TILE) -> SegmentPlan:
    """Host: segment plan of a receiver-sorted edge set.

    Raises ``ValueError`` if receivers decrease anywhere or leave
    ``[0, num_nodes)``: the kernel owns whole segments and needs each
    receiver's edges to be contiguous.
    """
    rcv = np.asarray(
        receivers.cpu() if isinstance(receivers, torch.Tensor) else receivers,
        np.int64,
    )
    if rcv.size and (rcv.min() < 0 or rcv.max() >= num_nodes):
        raise ValueError(f"receivers must lie in [0, {num_nodes})")
    if np.any(np.diff(rcv) < 0):
        raise ValueError(
            "receivers must be non-decreasing (core.mesh.cells_to_edges "
            "sorts them); the fused kernel aggregates contiguous segments"
        )
    row_ptr = np.searchsorted(rcv, np.arange(num_nodes + 1), side="left")
    groups = [0]
    for n in range(num_nodes):
        start = groups[-1]
        if n > start and row_ptr[n + 1] - row_ptr[start] > tile:
            groups.append(n)
    groups.append(num_nodes)
    return SegmentPlan(
        row_ptr=torch.from_numpy(row_ptr.astype(np.int32)),
        groups=torch.from_numpy(np.asarray(groups, np.int32)),
        num_nodes=int(num_nodes),
        num_edges=int(rcv.size),
    )


def fused_edge_block_reference(
    e: torch.Tensor,
    sp: torch.Tensor,
    rp: torch.Tensor,
    weights: Dict[str, torch.Tensor],
    senders: torch.Tensor,
    receivers: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_nodes: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1 with the kernel's rounding points.

    Every product accumulates in float32 and is rounded to ``e.dtype``; the
    first-layer sum runs left to right in ``e.dtype``, each add rounded;
    bias adds run in ``e.dtype``; LayerNorm statistics are float32; the
    aggregate sums the rounded ``e2`` in float32.
    """
    cdt = e.dtype
    cd = None if cdt == torch.float32 else cdt
    snd, rcv = senders.long(), receivers.long()
    h = dense(e, weights["we"], cd) + sp[..., snd, :]
    h = h + rp[..., rcv, :]
    h = h + weights["b1"].to(cdt)
    z2 = dense(torch.relu(h), weights["w2"], cd) + weights["b2"].to(cdt)
    z3 = dense(torch.relu(z2), weights["w3"], cd) + weights["b3"].to(cdt)
    e2 = e + layer_norm(z3, weights["lns"], weights["lnb"])
    agg = segment_ops.aggregate(e2.float(), receivers, num_nodes, "pna", mask)
    return e2, agg


class _Kernel:
    """The built library and its C signature, loaded at first launch."""

    def __init__(self):
        from hyper_graph_nets_tpu_torch.ops import build

        lib = build.load(build.source_path(SOURCE))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hgn_fused_block_fwd.argtypes = [ci, ci] + [vp] * 18 + [ci] * 4 + [vp]
        lib.hgn_fused_block_fwd.restype = ci
        lib.hgn_cuda_error_string.argtypes = [ci]
        lib.hgn_cuda_error_string.restype = ctypes.c_char_p
        self.lib = lib


_kernel: Optional[_Kernel] = None


def _check(cond: bool, what: str):
    if not cond:
        raise ValueError(f"fused_edge_block: {what}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    if t is None:
        return None
    _check(t.data_ptr() % 16 == 0, "tensor data must be 16-byte aligned")
    return t.data_ptr()


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused edge update + pna aggregate; returns ``(e2, agg)``.

    ``e`` is ``[E, L]`` or ``[B, E, L]`` (float32 or bfloat16); ``sp``/``rp``
    are ``[N, L]`` or ``[B, N, L]`` of the same dtype; ``agg`` is float32
    ``[..., N, 4L]``.  ``plan`` is the edge set's :class:`SegmentPlan` on the
    tensors' device (built from ``receivers`` when omitted).
    """
    if e.device.type == "cpu":
        return fused_edge_block_reference(
            e, sp, rp, weights, senders, receivers, mask, num_nodes
        )
    _check(e.device.type == "cuda", f"unsupported device {e.device}")
    squeeze = e.dim() == 2
    e3, sp3, rp3 = (e[None], sp[None], rp[None]) if squeeze else (e, sp, rp)
    _check(e3.dim() == 3, f"e must be [E, L] or [B, E, L], got {tuple(e.shape)}")
    B, E, L = e3.shape
    _check(e3.dtype in _DTYPES, f"dtype {e3.dtype} not supported")
    _check(L in WIDTHS, f"latent size {L} not in {WIDTHS}")
    for name, t in (("sp", sp3), ("rp", rp3)):
        _check(t.shape == (B, num_nodes, L), f"{name} shape {tuple(t.shape)}")
        _check(t.dtype == e3.dtype, f"{name} dtype {t.dtype} != {e3.dtype}")
    tensors = [e3, sp3, rp3, senders, receivers] + ([mask] if mask is not None else [])
    for t in tensors:
        _check(t.device == e3.device, "all tensors must be on one device")
        _check(t.is_contiguous(), "tensors must be contiguous")
    _check(senders.dtype == torch.int32 and senders.shape == (E,), "senders int32 [E]")
    _check(receivers.dtype == torch.int32 and receivers.shape == (E,), "receivers int32 [E]")
    if mask is not None:
        _check(mask.dtype == torch.float32 and mask.shape == (E,), "mask float32 [E]")
    if plan is None:
        plan = plan_segments(receivers, num_nodes).to(e3.device)
    _check(plan.num_nodes == num_nodes and plan.num_edges == E, "plan does not match")
    _check(plan.row_ptr.device == e3.device, "plan must be on the tensors' device")
    w = {k: weights[k].to(e3.dtype).contiguous() for k in ("we", "w2", "w3")}
    p = {
        k: weights[k].to(torch.float32).contiguous()
        for k in ("b1", "b2", "b3", "lns", "lnb")
    }
    for k, t in w.items():
        _check(t.shape == (L, L) and t.device == e3.device, f"{k} must be [L, L] on device")
    for k, t in p.items():
        _check(t.shape == (L,) and t.device == e3.device, f"{k} must be [L] on device")

    global _kernel
    if _kernel is None:
        _kernel = _Kernel()
    e2 = torch.empty_like(e3)
    agg = torch.empty((B, num_nodes, 4 * L), dtype=torch.float32, device=e3.device)
    rc = _kernel.lib.hgn_fused_block_fwd(
        _DTYPES[e3.dtype], L,
        _ptr(e3), _ptr(sp3), _ptr(rp3), _ptr(w["we"]), _ptr(w["w2"]), _ptr(w["w3"]),
        _ptr(p["b1"]), _ptr(p["b2"]), _ptr(p["b3"]), _ptr(p["lns"]), _ptr(p["lnb"]),
        _ptr(senders), _ptr(receivers), _ptr(mask), _ptr(plan.row_ptr), _ptr(plan.groups),
        _ptr(e2), _ptr(agg),
        B, E, num_nodes, plan.num_groups,
        torch.cuda.current_stream(e3.device).cuda_stream,
    )
    if rc != 0:
        msg = "unsupported dtype/width" if rc < 0 else _kernel.lib.hgn_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_edge_block kernel launch failed ({rc}): {msg}")
    fused_edge_block.launches += 1
    if squeeze:
        e2, agg = e2[0], agg[0]
    return e2, agg


fused_edge_block.launches = 0  # kernel launches since the count was last reset
