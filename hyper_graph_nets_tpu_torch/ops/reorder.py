"""Host-side mesh relabelling (reverse Cuthill-McKee) and the band criterion.

Counterpart of ``hyper_graph_nets_tpu/ops/reorder.py`` and of the JAX fused
kernel's band criterion (``check_banded``/``plan_dims`` in
``hyper_graph_nets_tpu/ops/pallas/fused_block.py``).  The port's kernels
need no banded numbering, but the simulator relabels exactly the meshes the
JAX simulator relabels (``training/simulator.py``), with the same
permutation, so both packages' rollouts and GIFs match node for node.  So
the criterion here is a numpy copy of the JAX one, TPU window sizes
included: it decides the relabel, and which cluster-tier sets
``rmp.fused_tiers`` fuses (``rmp.remote_message_passing``), nothing else.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np


def rcm_order(senders: np.ndarray, receivers: np.ndarray, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation of the edge list (scipy's):
    ``perm[new_id] = old_id``; apply with ``nodes[perm]`` and relabel
    indices with :func:`inverse_perm`."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    snd = np.asarray(senders, np.int64)
    rcv = np.asarray(receivers, np.int64)
    data = np.ones(len(snd), np.int8)
    adj = coo_matrix((data, (snd, rcv)), shape=(num_nodes, num_nodes)).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=False))
    return perm.astype(np.int64)


def inverse_perm(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return inv


def bandwidth(senders: np.ndarray, receivers: np.ndarray) -> int:
    """Max |sender - receiver| over the edge list (numbering bandwidth)."""
    if len(senders) == 0:
        return 0
    return int(np.max(np.abs(np.asarray(senders, np.int64) - np.asarray(receivers, np.int64))))


def reorder_trajectory(
    trajectory: Dict[str, np.ndarray], perm: np.ndarray, node_axis: int = 1
) -> Dict[str, np.ndarray]:
    """Apply a node permutation to a trajectory dict: node-indexed arrays
    (``[T, N, ...]``) are gathered along ``node_axis``, ``cells`` entries
    relabelled, anything else passed through."""
    inv = inverse_perm(perm)
    n = len(perm)
    out = {}
    for key, val in trajectory.items():
        if key == "cells":
            out[key] = inv[np.asarray(val, np.int64)].astype(val.dtype)
        elif val.ndim > node_axis and val.shape[node_axis] == n:
            out[key] = np.take(val, perm, axis=node_axis)
        else:
            out[key] = val
    return out


# -- the JAX fused kernel's band criterion ------------------------------------


def default_chunk() -> int:
    """The JAX package's band-plan edge chunk: 512 when
    ``LIBTPU_INIT_ARGS`` raises the TPU's scoped-memory limit to 32 MiB or
    more, else 256.  Read here only so the relabel decision is the JAX
    package's in the same environment."""
    m = re.search(r"xla_tpu_scoped_vmem_limit_kib=(\d+)", os.environ.get("LIBTPU_INIT_ARGS", ""))
    return 512 if m and int(m.group(1)) >= 32768 else 256


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _sb_candidates(chunk: int) -> Tuple[int, ...]:
    return tuple(sb for sb in (1, 2, 4, 8) if chunk % sb == 0 and (chunk // sb) % 128 == 0)


def _chunk_windows(snd, rcv, ev, chunk):
    """Per-chunk (index, slice, sender start, receiver start, sender width,
    receiver width) of a receiver-sorted edge list; skips padding chunks."""
    E = snd.shape[0]
    for c in range(max(_round_up(E, chunk) // chunk, 1)):
        sl = slice(c * chunk, min((c + 1) * chunk, ev))
        if sl.start >= ev:
            continue
        cs, cr = snd[sl], rcv[sl]
        ws = (int(cs.min()) // 16) * 16
        rl = (int(cr.min()) // 8) * 8
        w_need = _round_up(int(cs.max()) - ws + 1, 128)
        wr_need = _round_up(int(cr.max()) - rl + 1, 128)
        yield c, sl, ws, rl, w_need, wr_need


def _sender_W(snd, rcv, ev, chunk: int, sb: int) -> int:
    ts = chunk // sb
    return max((w for *_, w, _ in _chunk_windows(snd, rcv, ev, ts)), default=128)


def _best_sb(snd, rcv, ev, chunk: int) -> int:
    best_sb, best_w = 1, None
    for sb in _sb_candidates(chunk):
        w = _sender_W(snd, rcv, ev, chunk, sb)
        if best_w is None or w < best_w:
            best_sb, best_w = sb, w
    return best_sb


def window_dims(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_valid: Optional[int] = None,
    chunk: Optional[int] = None,
    sb: Optional[int] = None,
) -> Optional[Tuple[int, int]]:
    """``(W, WR)``: the widest sender and receiver windows of the JAX band
    plan (``plan_dims``; ``sb`` sender subwindows a chunk, by default the
    narrowest choice), or None when the receivers are unsorted."""
    d = plan_dims(senders, receivers, num_valid=num_valid, chunk=chunk, sb=sb)
    return None if d is None else (d["W"], d["WR"])


def check_banded(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_valid: Optional[int] = None,
    chunk: Optional[int] = None,
    max_window: int = 2048,
) -> bool:
    """The JAX package's ``check_banded``: whether its fused kernel takes
    this numbering without a relabel."""
    d = window_dims(senders, receivers, num_valid=num_valid, chunk=chunk)
    return d is not None and d[0] <= max_window and d[1] <= max_window


def plan_dims(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_valid: Optional[int] = None,
    chunk: Optional[int] = None,
    sb: Optional[int] = None,
) -> Optional[dict]:
    """The JAX package's ``plan_dims``: the static dims of its band plan,
    ``{"chunk", "sb", "W", "WR", "steps", "nr"}`` (scan steps over the
    longest receiver run in a chunk, and the node rows the windows reach),
    or None when the receivers are unsorted.  TPU grid sizes: read only to
    make the bucket's band decision (``data.bucketing.bucket_plan_dims``)
    the JAX package's."""
    snd = np.asarray(senders, np.int64)
    rcv = np.asarray(receivers, np.int64)
    ev = snd.shape[0] if num_valid is None else int(num_valid)
    if ev and np.any(np.diff(rcv[:ev]) < 0):
        return None
    chunk = default_chunk() if chunk is None else chunk
    sb = _best_sb(snd, rcv, ev, chunk) if sb is None else sb
    W = _sender_W(snd, rcv, ev, chunk, sb)
    WR, seg_max, ws_max, rl_max = 128, 1, 0, 0
    for _, sl, _, rl, _, wr_need in _chunk_windows(snd, rcv, ev, chunk):
        WR = max(WR, wr_need)
        rl_max = max(rl_max, rl)
        runs = np.diff(np.flatnonzero(np.r_[True, np.diff(rcv[sl]) != 0, True]))
        seg_max = max(seg_max, int(runs.max()))
    for _, _, ws, _, _, _ in _chunk_windows(snd, rcv, ev, chunk // sb):
        ws_max = max(ws_max, ws)
    steps = 0
    while (1 << steps) < min(seg_max, chunk):
        steps += 1
    return {"chunk": chunk, "sb": sb, "W": W, "WR": WR, "steps": steps, "nr": max(ws_max + W, rl_max + WR)}


def upgrade_512_ok(senders, receivers, num_nodes: int, num_valid: Optional[int] = None,
                   latent_size: int = 128, pb: int = 1) -> bool:
    """The JAX package's ``models.base.upgrade_512_ok``: whether its band
    plans take 512-edge chunks without a raised TPU scoped-memory limit."""
    if latent_size > 128 or pb > 1:
        return False
    d = plan_dims(senders, receivers, num_valid=num_valid, chunk=512)
    return d is not None and d["W"] <= 128 and d["WR"] <= 128 and max(d["nr"], num_nodes) <= 2048
