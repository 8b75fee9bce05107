"""Ring all-reduce with per-row-segment combine (K6) over a rank group.

Counterpart of ``hyper_graph_nets_tpu/ops/pallas/ring.py``
(``ring_all_reduce_segments``, ``ring_psum``).  Each rank of a
``parallel.group.RankGroup`` holds a float32 partial ``x_r`` of one shape
``[R, C]``; ``segments`` are ``(lo, hi, op)`` row ranges with op in sum,
max, min; rows outside every segment keep ``x_r``.  Rank r's result folds
``x_r, x_{r-1}, ..., x_{r-n+1}`` in that order, the JAX ring's order on
that device, so results may differ between ranks in the last place of a
float32 sum, and the kernel equals its plain version bit for bit.

On CUDA tensors :func:`ring_all_reduce_segments` launches K6
(``csrc/ring.cu``) once per rank on the rank's stream, every launch before
any host synchronization (counted on ``ring_all_reduce_segments.launches``,
one per rank); each ``x_r`` must be ready on rank r's stream, and each
result is, on the same stream.  On CPU tensors it runs the plain version,
:func:`ring_all_reduce_segments_reference`, the same hops in Python.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

SOURCE = "ring.cu"
OPS = {"sum": 0, "max": 1, "min": 2}
MAX_SEGMENTS = 8
_COMBINE = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}

_vp, _ci = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "hgn_ring_all_reduce": [_vp, _vp, _ci, _ci, _ci, _vp] + [_vp] * 5
    + [_ci, _ci, ctypes.c_ulonglong, _vp, _ci, _vp],
    "hgn_enable_peer_access": [_ci, _ci],
    "hgn_host_device_pointer": [_vp, ctypes.POINTER(ctypes.c_void_p)],
    "hgn_cuda_error_string": [_ci],
}
_libs: Dict[str, ctypes.CDLL] = {}


def _lib() -> ctypes.CDLL:
    if SOURCE not in _libs:
        from hyper_graph_nets_tpu_torch.ops import build

        lib = build.load(build.source_path(SOURCE))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _ci
        lib.hgn_cuda_error_string.restype = ctypes.c_char_p
        _libs[SOURCE] = lib
    return _libs[SOURCE]


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


def check_segments(segments: Sequence[Tuple[int, int, str]], rows: int) -> None:
    if len(segments) > MAX_SEGMENTS:
        raise ValueError(f"at most {MAX_SEGMENTS} segments, got {len(segments)}")
    for lo, hi, op in segments:
        if op not in OPS:
            raise ValueError(f"unknown combine op {op!r}")
        if not 0 <= lo <= hi <= rows:
            raise ValueError(f"segment ({lo}, {hi}) outside rows [0, {rows})")


def ring_all_reduce_segments_reference(
    xs: Sequence[torch.Tensor], segments: Sequence[Tuple[int, int, str]]
) -> List[torch.Tensor]:
    """Plain K6: for each rank r, ``out = x_r`` and at hop s = 1 .. n-1 each
    segment folds ``x_{r-s}`` into ``out`` with its op."""
    n = len(xs)
    outs = []
    for r in range(n):
        out = xs[r].clone()
        for s in range(1, n):
            x = xs[(r - s) % n].to(out.device)
            for lo, hi, op in segments:
                out[lo:hi] = _COMBINE[op](out[lo:hi], x[lo:hi])
        outs.append(out)
    return outs


def ring_all_reduce_segments(
    xs: Sequence[torch.Tensor], segments: Sequence[Tuple[int, int, str]], group
) -> List[torch.Tensor]:
    """All-reduce the ranks' float32 ``[R, C]`` partials ``xs`` (one per
    rank, on its device) with per-row-segment ops; returns one result per
    rank.  CPU tensors run the plain version; CUDA tensors launch K6."""
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
        return ring_all_reduce_segments_reference(xs, segments)
    lib = _lib()
    state = group.ring_state("k6", R * C)
    err = device_error_word(group)
    seg = (ctypes.c_int * (3 * max(len(segments), 1)))(
        *[v for lo, hi, op in segments for v in (lo, hi, OPS[op])]
    )
    grid = max(1, min(R, min(group.ctas_per_rank(r) for r in range(group.n))))
    outs = []
    for r in range(group.n):  # every output first: no allocation between the launches
        with torch.cuda.device(group.device(r)), torch.cuda.stream(group.stream(r)):
            outs.append(torch.empty_like(xs[r]))
    epoch = group.next_epoch()
    for r in range(group.n):
        left, right = group.left(r), group.right(r)
        slots, flags, _ = state[r]
        with torch.cuda.device(group.device(r)):
            rc = lib.hgn_ring_all_reduce(
                xs[r].data_ptr(), outs[r].data_ptr(), R, C, len(segments), seg,
                flags.data_ptr(), state[left][1].data_ptr(), state[right][1].data_ptr(),
                slots.data_ptr(), state[right][0].data_ptr(),
                group.n, r, epoch, err, grid, group.stream(r).cuda_stream,
            )
        raise_on(rc, lib, "ring_all_reduce_segments")
        ring_all_reduce_segments.launches += 1
    return outs


ring_all_reduce_segments.launches = 0  # K6 launches (one per rank) since the last reset


def ring_psum(xs: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Plain ring all-reduce-sum of 2-D partials."""
    return ring_all_reduce_segments(xs, [(0, xs[0].shape[0], "sum")], group)
