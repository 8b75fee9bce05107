"""Online feature normalizer as immutable state.

Counterpart of ``hyper_graph_nets_tpu/core/normalizer.py``: accumulates
count / sum / sum of squares for up to ``max_accumulations`` calls and
standardizes with ``(x - mean) / max(std, eps)``.  Every function returns a
new state and never updates one in place: the model's ``make_graph``
accumulates ``node_dynamic`` on every call, and serving discards that state,
exactly as the JAX package does.

Under the sharded train step each data rank sees its own frames only; there
the statistics of a batch are those of the global batch, as the JAX
package's one GSPMD program computes them: inside :func:`reduce_partials`
(per thread: a rank's) every accumulation hands its partial count, sums and
sums of squares to the given all-reduce before it folds them in.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Optional

import torch

_REDUCE = threading.local()


@contextlib.contextmanager
def reduce_partials(fn: Callable[[torch.Tensor], torch.Tensor]):
    """Within the block, in this thread, :func:`accumulate` passes the
    batch's ``[count, sum..., sum of squares...]`` through ``fn`` (the
    sharded step's all-reduce over the ``data`` ranks) before folding it."""
    prev = getattr(_REDUCE, "fn", None)
    _REDUCE.fn = fn
    try:
        yield
    finally:
        _REDUCE.fn = prev


@dataclasses.dataclass(frozen=True)
class NormalizerState:
    acc_count: torch.Tensor  # scalar f32: accumulated rows
    num_accumulations: torch.Tensor  # scalar f32: accumulate() calls
    acc_sum: torch.Tensor  # [F] f32
    acc_sum_squared: torch.Tensor  # [F] f32
    max_accumulations: float = 10**6
    std_epsilon: float = 1e-8

    def to(self, device) -> "NormalizerState":
        return dataclasses.replace(
            self,
            acc_count=self.acc_count.to(device),
            num_accumulations=self.num_accumulations.to(device),
            acc_sum=self.acc_sum.to(device),
            acc_sum_squared=self.acc_sum_squared.to(device),
        )


def init(
    size: int,
    max_accumulations: float = 10**6,
    std_epsilon: float = 1e-8,
    device="cpu",
) -> NormalizerState:
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return NormalizerState(
        acc_count=zeros(),
        num_accumulations=zeros(),
        acc_sum=zeros(size),
        acc_sum_squared=zeros(size),
        max_accumulations=max_accumulations,
        std_epsilon=std_epsilon,
    )


def mean(state: NormalizerState) -> torch.Tensor:
    return state.acc_sum / torch.clamp(state.acc_count, min=1.0)


def std_with_epsilon(state: NormalizerState) -> torch.Tensor:
    safe_count = torch.clamp(state.acc_count, min=1.0)
    var = torch.abs(state.acc_sum_squared / safe_count - mean(state) ** 2)
    return torch.clamp(torch.sqrt(var), min=state.std_epsilon)


def accumulate(
    state: NormalizerState, data: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> NormalizerState:
    """Fold a batch of rows into new running statistics.

    All but the last axis of ``data`` are rows; ``mask`` (matching the
    leading shape) excludes padded rows.
    """
    flat = data.reshape(-1, data.shape[-1]).to(torch.float32)
    if mask is not None:
        m = mask.reshape(-1, 1).to(torch.float32)
        flat = flat * m
        count = m.sum()
    else:
        count = torch.tensor(float(flat.shape[0]), device=flat.device)
    total, squares = flat.sum(dim=0), (flat * flat).sum(dim=0)
    reduce = getattr(_REDUCE, "fn", None)
    if reduce is not None:
        F = flat.shape[-1]
        packed = reduce(torch.cat([count.reshape(1), total, squares]))
        count, total, squares = packed[0], packed[1 : 1 + F], packed[1 + F :]
    # the accumulation cap gates every field, as in the JAX package
    do = (state.num_accumulations < state.max_accumulations).to(torch.float32)
    return dataclasses.replace(
        state,
        acc_count=state.acc_count + do * count,
        num_accumulations=state.num_accumulations + do,
        acc_sum=state.acc_sum + do * total,
        acc_sum_squared=state.acc_sum_squared + do * squares,
    )


def normalize(
    state: NormalizerState,
    data: torch.Tensor,
    accumulate_stats: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, NormalizerState]:
    """Standardize ``data``; optionally accumulate statistics first."""
    if accumulate_stats:
        state = accumulate(state, data, mask)
    return (data - mean(state)) / std_with_epsilon(state), state


def inverse(state: NormalizerState, data: torch.Tensor) -> torch.Tensor:
    """De-normalize network outputs."""
    return data * std_with_epsilon(state) + mean(state)
