"""(max, x) semiring product for the balanced-Forman curvature (K5).

Counterpart of ``hyper_graph_nets_tpu/ops/pallas/maxprod.py`` (``maxprod``
over ``_maxprod_kernel``).  For float32 ``x [N, K]`` and ``y [K, M]``, both
non-negative:

    out[i, j] = max(0, max_k x[i, k] * y[k, j])

Every product is one rounded multiply and max does not depend on order, so
the kernel, its plain version and the JAX package's ``maxprod`` agree bit
for bit.

On a CUDA tensor :func:`maxprod` launches the hand-written kernel
(``csrc/maxprod.cu``); on a CPU tensor it runs :func:`maxprod_reference`.
There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

SOURCE = "maxprod.cu"
_lib_handle: Optional[ctypes.CDLL] = None


def maxprod_reference(x: torch.Tensor, y: torch.Tensor, block: int = 8) -> torch.Tensor:
    """Plain K5: over blocks of ``block`` rows, the ``amax`` of the
    broadcast products ``[block, K, M]`` over K, then a clamp at 0 (the JAX
    package's ``maxprod_reference``)."""
    x, y = x.to(torch.float32), y.to(torch.float32)
    rows = [
        (x[i : i + block, :, None] * y[None]).amax(dim=1) for i in range(0, x.shape[0], block)
    ]
    return torch.clamp(torch.cat(rows), min=0.0)


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from hyper_graph_nets_tpu_torch.ops import build

        lib = build.load(build.source_path(SOURCE))
        _vp, _ci = ctypes.c_void_p, ctypes.c_int
        lib.hgn_maxprod.argtypes = [_vp, _vp, _vp, _ci, _ci, _ci, _vp]
        lib.hgn_maxprod.restype = _ci
        lib.hgn_cuda_error_string.argtypes = [_ci]
        lib.hgn_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _check(cond: bool, what: str):
    if not cond:
        raise ValueError(f"maxprod: {what}")


def maxprod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``out[i, j] = max(0, max_k x[i, k] * y[k, j])``, float32 ``[N, M]``.

    ``x`` ``[N, K]`` and ``y`` ``[K, M]`` are non-negative float32 (the
    curvature's adjacency and common-neighbour counts).  A CUDA tensor
    launches K5 (counted on ``maxprod.launches``); a CPU tensor runs the
    plain version.
    """
    _check(x.dim() == 2 and y.dim() == 2 and x.shape[1] == y.shape[0],
           f"shapes {tuple(x.shape)} x {tuple(y.shape)}")
    if x.device.type == "cpu" and y.device.type == "cpu":
        return maxprod_reference(x, y)
    _check(x.device.type == "cuda" and y.device == x.device, f"devices {x.device}, {y.device}")
    _check(x.dtype == torch.float32 and y.dtype == torch.float32, "x and y must be float32")
    x, y = x.contiguous(), y.contiguous()
    N, K = x.shape
    M = y.shape[1]
    out = torch.empty((N, M), dtype=torch.float32, device=x.device)
    lib = _lib()
    rc = lib.hgn_maxprod(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), N, K, M,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"maxprod kernel launch failed ({rc}): {lib.hgn_cuda_error_string(rc).decode()}")
    maxprod.launches += 1
    return out


maxprod.launches = 0  # K5 launches since the count was last reset
