"""Host-side mesh topology utilities (numpy).

Counterpart of ``hyper_graph_nets_tpu/core/mesh.py``.  Edges are returned
sorted by receiver, so every receiver owns one contiguous edge range — the
layout the fused edge-block kernel (``ops/fused_block.py``) aggregates over
without atomics.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple

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


def mesh_fingerprint(cells, num_nodes: int) -> tuple:
    """Content digest of a mesh's connectivity, for host-side caches.

    Hashes all cell bytes and the shape, so two meshes with equal node and
    edge counts never share a cached topology.
    """
    cells = np.ascontiguousarray(cells)
    h = hashlib.blake2b(cells.tobytes(), digest_size=12)
    h.update(repr(cells.shape).encode())
    return (h.hexdigest(), int(num_nodes))
