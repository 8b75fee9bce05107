"""Host-side mesh topology utilities (numpy).

Counterpart of ``hyper_graph_nets_tpu/core/mesh.py``.  Edges are returned
sorted by receiver, so every receiver owns one contiguous edge range — the
layout the fused edge-block kernel (``ops/fused_block.py``) and the sorted
pna kernel (``ops/segment_pna.py``) aggregate over without atomics.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional, Tuple

import numpy as np


class MeshEdges(NamedTuple):
    senders: np.ndarray  # [E] int32, two-way (both directions)
    receivers: np.ndarray  # [E] int32, non-decreasing
    unique_senders: np.ndarray  # [E/2] one-way (max endpoint)
    unique_receivers: np.ndarray  # [E/2] (min endpoint)


def cells_to_edges(cells: np.ndarray, deform: bool = False) -> MeshEdges:
    """Unique bidirectional edges of triangle (or quad) cells.

    Perimeter segments are canonicalized to (max, min), deduplicated, and
    both directions emitted, then sorted by (receiver, sender).
    """
    cells = np.asarray(cells)
    if cells.ndim != 2:
        raise ValueError(f"cells must be [C, 3|4], got {cells.shape}")
    if deform or cells.shape[1] == 4:
        segs = np.concatenate(
            [cells[:, 0:2], cells[:, 1:3], cells[:, 2:4], cells[:, [3, 0]]], axis=0
        )
    else:
        segs = np.concatenate(
            [cells[:, 0:2], cells[:, 1:3], cells[:, [2, 0]]], axis=0
        )
    lo = segs.min(axis=1)
    hi = segs.max(axis=1)
    packed = np.unique(np.stack([hi, lo], axis=1), axis=0)
    uniq_snd = packed[:, 0].astype(np.int32)
    uniq_rcv = packed[:, 1].astype(np.int32)

    senders = np.concatenate([uniq_snd, uniq_rcv])
    receivers = np.concatenate([uniq_rcv, uniq_snd])
    order = np.lexsort((senders, receivers))
    return MeshEdges(
        senders=senders[order].astype(np.int32),
        receivers=receivers[order].astype(np.int32),
        unique_senders=uniq_snd,
        unique_receivers=uniq_rcv,
    )


def receivers_to_gather(
    receivers: np.ndarray,
    num_nodes: int,
    mask: Optional[np.ndarray] = None,
    min_degree: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dense ``[N, d_max]`` edge-index matrix of a static topology.

    Row ``n`` lists, in edge order, the valid edges whose receiver is ``n``,
    padded with edge 0 at valid 0.0; ``d_max`` is the largest degree (at
    least 1, and at least ``min_degree``).  Passing senders gives the
    sender-side inverse incidence.  Feeds ``segment_ops.gather_aggregate``,
    ``pna_gather`` and ``gather_rows``.
    """
    receivers = np.asarray(receivers)
    valid_edges = np.ones(len(receivers), bool) if mask is None else np.asarray(mask) > 0
    counts = np.bincount(receivers[valid_edges], minlength=num_nodes)
    d_max = max(int(counts.max(initial=0)), 1)
    if min_degree is not None:
        d_max = max(d_max, min_degree)
    idx = np.zeros((num_nodes, d_max), np.int32)
    valid = np.zeros((num_nodes, d_max), np.float32)
    cursor = np.zeros(num_nodes, np.int32)
    for e in np.nonzero(valid_edges)[0]:
        r = receivers[e]
        idx[r, cursor[r]] = e
        valid[r, cursor[r]] = 1.0
        cursor[r] += 1
    return idx, valid


def mesh_fingerprint(cells, num_nodes: int) -> tuple:
    """Content digest of a mesh's connectivity, for host-side caches.

    Hashes all cell bytes and the shape, so two meshes with equal node and
    edge counts never share a cached topology.
    """
    cells = np.ascontiguousarray(cells)
    h = hashlib.blake2b(cells.tobytes(), digest_size=12)
    h.update(repr(cells.shape).encode())
    return (h.hexdigest(), int(num_nodes))
