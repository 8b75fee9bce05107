"""Masked segment aggregation over the edge axis (plain PyTorch).

Counterpart of ``hyper_graph_nets_tpu/core/segment_ops.py``.  ``data`` is
``[..., E, F]`` and ``segment_ids`` ``[E]``; the result is ``[..., N, F]``.
Masked edges contribute nothing, and empty segments give 0 for every
operation (``segment_ops.py:9-11`` of the JAX package).  Reductions run in
float32 and the result is cast back to the data's dtype.  These serve
``node_dynamic`` and the unfused (``agg_vjp: xla | gather``) path; the fused
path aggregates inside its kernel (``ops/fused_block.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30
_POS_INF = 1e30


def _out_shape(data: torch.Tensor, num_segments: int) -> tuple:
    return data.shape[:-2] + (num_segments, data.shape[-1])


def _valid(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if mask is None else (mask > 0)[..., None]


def _sum32(data, ids, num_segments, mask):
    d = data.to(torch.float32)
    if mask is not None:
        d = d * mask[..., None].to(torch.float32)
    out = d.new_zeros(_out_shape(d, num_segments))
    return out.index_add_(out.dim() - 2, ids.long(), d)


def _count32(data, ids, num_segments, mask):
    ones = torch.ones(data.shape[-2], dtype=torch.float32, device=data.device)
    if mask is not None:
        ones = ones * mask.to(torch.float32)
    counts = ones.new_zeros(ones.shape[:-1] + (num_segments,))
    counts.index_add_(counts.dim() - 1, ids.long(), ones)
    return counts[..., None]


def _extremum32(data, ids, num_segments, mask, reduce: str):
    fill = _NEG_INF if reduce == "amax" else _POS_INF
    d = data.to(torch.float32)
    valid = _valid(mask)
    if valid is not None:
        d = torch.where(valid, d, torch.full_like(d, fill))
    out = torch.full(_out_shape(d, num_segments), fill, device=d.device)
    index = ids.long().view(*([1] * (d.dim() - 2)), -1, 1).expand_as(d)
    out.scatter_reduce_(d.dim() - 2, index, d, reduce, include_self=True)
    empty = out <= _NEG_INF / 2 if reduce == "amax" else out >= _POS_INF / 2
    return torch.where(empty, torch.zeros_like(out), out)


def segment_sum(data, segment_ids, num_segments, mask=None):
    return _sum32(data, segment_ids, num_segments, mask).to(data.dtype)


def segment_mean(data, segment_ids, num_segments, mask=None):
    total = _sum32(data, segment_ids, num_segments, mask)
    counts = _count32(data, segment_ids, num_segments, mask)
    return (total / torch.clamp(counts, min=1.0)).to(data.dtype)


def segment_max(data, segment_ids, num_segments, mask=None):
    return _extremum32(data, segment_ids, num_segments, mask, "amax").to(data.dtype)


def segment_min(data, segment_ids, num_segments, mask=None):
    return _extremum32(data, segment_ids, num_segments, mask, "amin").to(data.dtype)


_OPS = {
    "sum": segment_sum,
    "mean": segment_mean,
    "max": segment_max,
    "min": segment_min,
}


def aggregate(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    aggregation: str,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Aggregate edge features to receiver nodes.

    ``aggregation='pna'`` concatenates ``[sum | mean | max | min]``; any
    other name selects the single segment op.
    """
    if aggregation == "pna":
        total = _sum32(data, segment_ids, num_segments, mask)
        counts = _count32(data, segment_ids, num_segments, mask)
        parts = [
            total,
            total / torch.clamp(counts, min=1.0),
            _extremum32(data, segment_ids, num_segments, mask, "amax"),
            _extremum32(data, segment_ids, num_segments, mask, "amin"),
        ]
        return torch.cat(parts, dim=-1).to(data.dtype)
    if aggregation not in _OPS:
        raise ValueError(f"invalid segment operation {aggregation!r}")
    return _OPS[aggregation](data, segment_ids, num_segments, mask)
