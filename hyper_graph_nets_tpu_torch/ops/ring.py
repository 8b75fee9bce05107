"""Ring all-reduce with per-row-segment combine (K6) over a rank group.

Counterpart of ``hyper_graph_nets_tpu/ops/pallas/ring.py``
(``ring_all_reduce_segments``, ``ring_psum``).  Each rank of a
``parallel.group.RankGroup`` holds a float32 partial ``x_r`` of one shape
``[R, C]``; ``segments`` are ``(lo, hi, op)`` row ranges with op in sum,
max, min; rows outside every segment keep ``x_r``.  The ranks combine
along the group's ``graph`` axis: on a 2-D group each sub-ring of the ranks
that share a ``data`` coordinate rings on its own, all of them in one
launch (the JAX package's ``mesh_axes``).  Rank r's result folds ``x_r,
x_{r-1}, ..., x_{r-n+1}`` (its sub-ring's ranks, n of them) in that order,
the JAX ring's order on that device, so results may differ between ranks in
the last place of a float32 sum, and the kernel equals its plain version
bit for bit.

On CUDA tensors :func:`ring_all_reduce_segments` checks and allocates
everything first, then launches K6 (``csrc/ring.cu``) on every rank by one
C call, each rank's kernel on its card and stream (counted on
``ring_all_reduce_segments.launches``, one per rank); each ``x_r`` must be
ready on rank r's stream, and each result is, on the same stream.  On CPU
tensors it runs the plain version, :func:`ring_all_reduce_segments_reference`,
the same hops in Python.
"""
from __future__ import annotations

import ctypes
import weakref
from typing import Dict, List, Sequence, Tuple

import torch

SOURCE = "ring.cu"
OPS = {"sum": 0, "max": 1, "min": 2}
MAX_SEGMENTS = 8
_COMBINE = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}

_vp, _ci, _cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong


class RingRank(ctypes.Structure):
    """One rank's entry of ``hgn_ring_all_reduce_group`` (``csrc/ring.cu``)."""

    _fields_ = [("x", _vp), ("out", _vp), ("flags_mine", _vp), ("flags_left", _vp), ("flags_right", _vp),
                ("slot_mine", _vp), ("slot_right", _vp), ("device", _ci), ("stream", _vp)]


_SIGNATURES = {
    "hgn_ring_all_reduce_group": [_ci, _ci, _vp, _ci, _ci, _cu, _ci, _vp, _cu, _vp, _ci],
    "hgn_enable_peer_access": [_ci, _ci],
    "hgn_host_device_pointer": [_vp, ctypes.POINTER(ctypes.c_void_p)],
    "hgn_cuda_error_string": [_ci],
}
_libs: Dict[tuple, ctypes.CDLL] = {}
# the define of the ring CTAs' phase probe (a library of its own, never the
# main path's): kernel_times.py --ring-phases
RING_PHASES = ("HGN_RING_PHASES",)


def _lib(source: str = SOURCE, defines: Tuple[str, ...] = (), signatures=None) -> ctypes.CDLL:
    """The built library of ``source`` (with ``defines``: a probe build)
    with its C signatures, loaded at first launch."""
    key = (source, tuple(defines))
    if key not in _libs:
        from hyper_graph_nets_tpu_torch.ops import build

        lib = build.load(build.source_path(source), defines)
        for name, argtypes in (signatures or _SIGNATURES).items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _ci
        lib.hgn_cuda_error_string.restype = ctypes.c_char_p
        lib.hgn_ring_phases.argtypes = [_vp, _ci]
        lib.hgn_ring_phases.restype = _ci
        lib.hgn_ring_phase_names.argtypes = []
        lib.hgn_ring_phase_names.restype = ctypes.c_char_p
        _libs[key] = lib
    return _libs[key]


def read_phases(lib: ctypes.CDLL) -> Tuple[Dict[str, int], int, int, int]:
    """The probe build's counts since the last read (and clears them):
    ``({phase: cycles summed over the ring CTAs}, ring CTAs, K7's compute
    teams' cycles, their work items)``."""
    names = lib.hgn_ring_phase_names().decode().split(",")
    buf = (ctypes.c_ulonglong * 32)()
    n = lib.hgn_ring_phases(buf, len(buf))
    if n < 0:
        raise RuntimeError(f"the ring phase probe returned {n}: not a probe build?")
    vals = list(buf)
    return dict(zip(names, vals[:n])), vals[n], vals[n + 1], vals[n + 2]


def raise_on(rc: int, lib: ctypes.CDLL, what: str) -> None:
    if rc != 0:
        msg = "unsupported arguments" if rc < 0 else lib.hgn_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed ({rc}): {msg}")


def enable_peer_access(dev: torch.device, peer: torch.device) -> None:
    """Let ``dev`` write into ``peer``'s memory; raises if it cannot."""
    lib = _lib()
    rc = lib.hgn_enable_peer_access(dev.index, peer.index)
    if rc < 0:
        raise RuntimeError(f"{dev} cannot access {peer}'s memory: a rank group needs peer access")
    raise_on(rc, lib, "enable peer access")


def device_error_word(group) -> int:
    """The device address of the group's page-locked error word."""
    lib = _lib()
    host = group.error_word()
    out = ctypes.c_void_p()
    raise_on(lib.hgn_host_device_pointer(host.data_ptr(), ctypes.byref(out)), lib, "host pointer")
    return out.value


def rank_state(group, state) -> List[dict]:
    """Per rank, in rank order, what a group launch takes besides its
    payload: its own flag row, slots and band counters, its left
    neighbour's flag row, its right neighbour's flag row and slots (the
    neighbours along ``graph``), its device ordinal and stream handle (-1
    and 0 on the CPU)."""
    rows = []
    for r in range(group.n):
        slots, flags, counters = state[r]
        left, right = state[group.left(r)], state[group.right(r)]
        dev, stream = group.device(r), group.stream(r)
        rows.append(dict(
            flags_mine=flags.data_ptr(), flags_left=left[1].data_ptr(), flags_right=right[1].data_ptr(),
            slot_mine=slots.data_ptr(), slot_right=right[0].data_ptr(), counters=counters.data_ptr(),
            device=-1 if dev.index is None else dev.index, stream=0 if stream is None else stream.cuda_stream,
        ))
    return rows


def struct_array(cls, rows: Sequence[dict]):
    """A ctypes array of ``cls``, entry r's fields filled from ``rows[r]``
    (the fields a row does not name stay 0)."""
    arr = (cls * len(rows))()
    for entry, row in zip(arr, rows):
        for name, _ in cls._fields_:
            if name in row:
                setattr(entry, name, row[name])
    return arr


_TABLES = weakref.WeakKeyDictionary()  # group -> {struct: (ring state, array)}


def rank_table(group, state, cls):
    """The group launch's array of ``cls`` with every rank's own and
    neighbour state filled in (:func:`rank_state`), built once per group,
    ring state and struct and kept (the host's launch path sets only the
    per-call fields)."""
    tables = _TABLES.setdefault(group, {})
    kept = tables.get(cls)
    if kept is None or kept[0] is not state:
        kept = tables[cls] = (state, struct_array(cls, rank_state(group, state)))
    return kept[1]


def check_segments(segments: Sequence[Tuple[int, int, str]], rows: int) -> None:
    if len(segments) > MAX_SEGMENTS:
        raise ValueError(f"at most {MAX_SEGMENTS} segments, got {len(segments)}")
    for lo, hi, op in segments:
        if op not in OPS:
            raise ValueError(f"unknown combine op {op!r}")
        if not 0 <= lo <= hi <= rows:
            raise ValueError(f"segment ({lo}, {hi}) outside rows [0, {rows})")


def ring_all_reduce_segments_reference(
    xs: Sequence[torch.Tensor], segments: Sequence[Tuple[int, int, str]], group=None
) -> List[torch.Tensor]:
    """Plain K6: for each rank r, ``out = x_r`` and at hop s = 1 .. n-1 each
    segment folds ``x_{r-s}`` into ``out`` with its op (``r-s``: the s-th
    rank before r on its sub-ring along ``graph`` of ``group``; without a
    group, one ring over ``xs``)."""
    if group is not None:
        group.check_ring("the ring all-reduce (K6)")
    rings = [list(range(len(xs)))] if group is None else group.subgroups("graph")
    outs: List[torch.Tensor] = [None] * len(xs)
    for ranks in rings:
        n = len(ranks)
        for i, r in enumerate(ranks):
            out = xs[r].clone()
            for s in range(1, n):
                x = xs[ranks[(i - s) % n]].to(out.device)
                for lo, hi, op in segments:
                    out[lo:hi] = _COMBINE[op](out[lo:hi], x[lo:hi])
            outs[r] = out
    return outs


def ring_all_reduce_segments(
    xs: Sequence[torch.Tensor], segments: Sequence[Tuple[int, int, str]], group, lib=None
) -> List[torch.Tensor]:
    """All-reduce the ranks' float32 ``[R, C]`` partials ``xs`` (one per
    rank of the group, on its device) with per-row-segment ops along
    ``graph``; returns one result per rank.  CPU tensors run the plain
    version; CUDA tensors launch K6 (``lib``: a probe build of it).  On a
    ``graph`` row that spans processes it raises (ROADMAP entry 7.4c)."""
    group.check_ring("the ring all-reduce (K6)")
    if len(xs) != group.n:
        raise ValueError(f"{len(xs)} partials for a group of {group.n}")
    R, C = xs[0].shape
    check_segments(segments, R)
    for r, x in enumerate(xs):
        if x.dtype != torch.float32 or x.shape != (R, C):
            raise ValueError(f"rank {r}: the payload must be float32 [{R}, {C}], got {x.dtype} {tuple(x.shape)}")
        if x.device != group.device(r) or not x.is_contiguous():
            raise ValueError(f"rank {r}: the payload must be contiguous on {group.device(r)}")
    if xs[0].device.type == "cpu":
        return ring_all_reduce_segments_reference(xs, segments, group)
    lib = lib or _lib()
    P = -(-R * C // 4) * 4  # floats per payload: the kernel moves float4s
    state = group.ring_state("k6", P)
    err = device_error_word(group)
    seg = (ctypes.c_int * (3 * max(len(segments), 1)))(
        *[v for lo, hi, op in segments for v in (lo, hi, OPS[op])]
    )
    grid = max(1, min(P // 4, min(group.ctas_per_rank(r) for r in range(group.n))))
    ranks, outs, alive = rank_table(group, state, RingRank), [], []
    for r, x in enumerate(xs):  # every copy and output first: nothing between the launches
        with torch.cuda.device(group.device(r)), torch.cuda.stream(group.stream(r)):
            if P == R * C and x.data_ptr() % 16 == 0:
                out = torch.empty_like(x)
            else:  # an odd payload, padded into an aligned buffer
                x = torch.cat([x.reshape(-1), x.new_zeros(P - R * C)])
                alive.append(x)  # until the launch
                out = torch.empty(P, dtype=torch.float32, device=x.device)
        ranks[r].x, ranks[r].out = x.data_ptr(), out.data_ptr()
        outs.append(out[: R * C].view(R, C) if out.dim() == 1 else out)
    rc = lib.hgn_ring_all_reduce_group(
        group.n, group.shape["graph"], ranks, R, C, P, len(segments), seg, group.next_epoch(), err, grid
    )
    raise_on(rc, lib, "ring_all_reduce_segments")
    ring_all_reduce_segments.launches += group.n
    return outs


ring_all_reduce_segments.launches = 0  # K6 launches (one per rank) since the last reset


def ring_psum(xs: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Plain ring all-reduce-sum of 2-D partials."""
    return ring_all_reduce_segments(xs, [(0, xs[0].shape[0], "sum")], group)
