"""Fused edge block with a compute-overlapped banded ring (K7).

Counterpart of ``hyper_graph_nets_tpu/ops/pallas/fused_overlap.py``
(``fused_edge_block_collective_overlap`` over ``_overlap_kernel``).  Each
rank of a ``parallel.group.RankGroup`` holds one edge shard of a frame; one
kernel per rank computes the shard's ``e2`` (K1's) and its raw pna
partials, and combines the partials over the ranks band by band while later
receiver groups still compute; the result is finalized:
``agg = [sum | mean | max | min]`` float32 ``[N, 4L]``, 0 where no rank has
a valid edge.

The node rows split into ``plan.overlap_bands`` bands, each split again so
that about half of a rank's CTAs ring (``ring_ctas``, ``band_rows``); with
the chunk round-robin edge layout (:func:`chunk_roundrobin_permutation`,
used by ``parallel.sharding.shard_topology``) every rank's shard spans all
rows in receiver order, so early bands finish first.  The kernel keeps a
counter of finished groups per band on the card, so it needs no host-built
schedule (the JAX package's ``build_overlap_schedule``).

On CUDA tensors :func:`fused_edge_block_overlap` launches K7
(``csrc/fused_overlap.cu``) once per rank on the rank's stream, all before
any host synchronization (``fused_edge_block_overlap.launches``, one per
rank).  On CPU tensors it runs the plain version: K1's plain version in raw
mode per rank, K6's plain version over the columns ``[0, 2L)`` sum,
``[2L, 3L)`` max, ``[3L, 4L)`` min, then the finalize.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hyper_graph_nets_tpu_torch.core import segment_ops
from hyper_graph_nets_tpu_torch.ops import fused_block as fb
from hyper_graph_nets_tpu_torch.ops import ring
from hyper_graph_nets_tpu_torch.parallel.group import MAX_BANDS

SOURCE = "fused_overlap.cu"

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = [_ci, _ci] + [_vp] * 18 + [_ci] * 5 + [_vp] * 6 + [_ci, _ci, ctypes.c_ulonglong, _vp, _ci, _vp]
_libs: Dict[str, ctypes.CDLL] = {}


def _lib() -> ctypes.CDLL:
    if SOURCE not in _libs:
        from hyper_graph_nets_tpu_torch.ops import build

        lib = build.load(build.source_path(SOURCE))
        lib.hgn_fused_overlap.argtypes = _SIGNATURE
        lib.hgn_fused_overlap.restype = _ci
        lib.hgn_cuda_error_string.argtypes = [_ci]
        lib.hgn_cuda_error_string.restype = ctypes.c_char_p
        _libs[SOURCE] = lib
    return _libs[SOURCE]


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


def fused_edge_block_overlap_reference(shards: Sequence[dict], num_nodes: int):
    """Plain K7 over every rank's shard: ``[(e2, agg), ...]``.  A shard is
    the keyword arguments of one rank: ``e [E, L]``, ``sp``, ``rp``
    ``[N, L]``, ``weights``, ``senders``, ``receivers``, ``mask``."""
    raws, e2s = [], []
    for x in shards:
        e2, raw = fb.fused_edge_block_reference(
            x["e"], x["sp"], x["rp"], x["weights"], x["senders"], x["receivers"], x["mask"],
            num_nodes, raw=True,
        )
        e2s.append(e2)
        raws.append(raw)
    L = shards[0]["e"].shape[-1]
    # the column segments of [N, 4L] are the row segments of its transpose
    folded = ring.ring_all_reduce_segments_reference([r.T.contiguous() for r in raws], _column_segments(L))
    return [(e2, segment_ops.finalize_partials(f.T)) for e2, f in zip(e2s, folded)]


def fused_edge_block_overlap(shards: Sequence[dict], num_nodes: int, group, bands: int):
    """K7 over every rank's shard (the list of the ranks' keyword arguments,
    see :func:`fused_edge_block_overlap_reference`; ``plan`` also, on the
    card), each ready on its rank's stream: ``[(e2, agg), ...]``, each on
    its rank's stream."""
    if len(shards) != group.n:
        raise ValueError(f"{len(shards)} shards for a group of {group.n}")
    if shards[0]["e"].device.type == "cpu":
        return fused_edge_block_overlap_reference(shards, num_nodes)
    lib = _lib()
    L = shards[0]["e"].shape[-1]
    grid = min(group.ctas_per_rank(r) for r in range(group.n))
    nb = ring_ctas(bands, grid)
    rb = band_rows(num_nodes, nb)
    state = group.ring_state("k7", num_nodes * 4 * L)
    err = ring.device_error_word(group)
    prepared, outs = [], []
    for r, x in enumerate(shards):  # checks and outputs first: no allocation between the launches
        e = x["e"]
        dev = group.device(r)
        fb._check(e.dim() == 2 and e.device == dev, f"rank {r}: e must be [E, L] on {dev}")
        with torch.cuda.device(dev), torch.cuda.stream(group.stream(r)):
            plan = fb._resolve_plan(x.get("plan"), x["senders"], x["receivers"], num_nodes, dev)
            E = e.shape[0]
            fb._validate(
                e[None], {"sp": x["sp"][None], "rp": x["rp"][None]}, x["senders"], x["receivers"],
                x["mask"], num_nodes, plan,
            )
            w, p = fb._kernel_weights(x["weights"], e.dtype, L, dev)
            prepared.append((plan, E, w, p))
            outs.append((torch.empty_like(e), torch.empty((num_nodes, 4 * L), dtype=torch.float32, device=dev)))
    epoch = group.next_epoch()
    for r, x in enumerate(shards):
        plan, E, w, p = prepared[r]
        e2, agg = outs[r]
        slots, flags, counters = state[r]
        left, right = state[group.left(r)], state[group.right(r)]
        grid_r = min(grid, nb + plan.num_groups)
        with torch.cuda.device(group.device(r)):
            rc = lib.hgn_fused_overlap(
                fb._DTYPES[x["e"].dtype], L,
                fb._ptr(x["e"]), fb._ptr(x["sp"]), fb._ptr(x["rp"]),
                fb._ptr(w["we"]), fb._ptr(w["w2"]), fb._ptr(w["w3"]),
                fb._ptr(p["b1"]), fb._ptr(p["b2"]), fb._ptr(p["b3"]), fb._ptr(p["lns"]), fb._ptr(p["lnb"]),
                fb._ptr(x["senders"]), fb._ptr(x["receivers"]), fb._ptr(x["mask"]),
                fb._ptr(plan.row_ptr), fb._ptr(plan.groups), fb._ptr(e2), fb._ptr(agg),
                E, num_nodes, plan.num_groups, nb, rb,
                flags.data_ptr(), left[1].data_ptr(), right[1].data_ptr(),
                slots.data_ptr(), right[0].data_ptr(), counters.data_ptr(),
                group.n, r, epoch, err, grid_r, group.stream(r).cuda_stream,
            )
        ring.raise_on(rc, lib, "fused_edge_block_overlap")
        fused_edge_block_overlap.launches += 1
    return outs


fused_edge_block_overlap.launches = 0  # K7 launches (one per rank) since the last reset


def fused_edge_block_collective_overlap(
    e: torch.Tensor,
    sp: torch.Tensor,
    rp: torch.Tensor,
    weights: Dict[str, torch.Tensor],
    senders: torch.Tensor,
    receivers: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_nodes: int,
    plan: fb.SegmentPlan,
    group,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's shard (called inside ``group.run``): ``(e2 [E, L], agg
    [N, 4L] float32)`` through K7, with ``plan.overlap_bands`` bands.  The
    drop-in for ``ops.fused_block.fused_edge_block_collective`` when the
    plan carries bands; forward only, as in the JAX package."""
    shard = dict(e=e, sp=sp, rp=rp, weights=weights, senders=senders, receivers=receivers,
                 mask=mask, plan=plan)
    return group.exchange(
        shard, lambda shards: fused_edge_block_overlap(shards, num_nodes, group, plan.overlap_bands)
    )
