"""MLP building block.

Counterpart of ``hyper_graph_nets_tpu/nn/mlp.py``.  Weights are held in the
``nn.Linear`` layout ``[out, in]`` (``convert.py`` transposes the JAX
package's ``[in, out]``).  Initialization draws ``U(-1/sqrt(fan_in),
1/sqrt(fan_in))`` for each weight and then its bias from an explicit
``torch.Generator``, the JAX package's distribution (``mlp.py:37-45``).

Numerics follow ``_dense`` / ``_layer_norm`` of the JAX package: with a
compute dtype the matmul inputs are cast to it, products accumulate in
float32 and the output is rounded once to the compute dtype; the bias add
runs in the compute dtype; LayerNorm statistics are float32 with eps 1e-5
and the result is cast back to the input dtype.

An MLP built with ``wscales`` holds int8 codes in ``weights`` (the int8
inference form, ``nn/quant.py``): each layer is then ``dense_int8(x) + b``,
the bias cast to the compute dtype and the sum promoted as PyTorch (and the
JAX package) promote it, so under bf16 a float32 product plus a bf16 bias
is float32, as in ``mlp_apply_tail``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from hyper_graph_nets_tpu_torch.nn import quant


def dense(x: torch.Tensor, w: torch.Tensor, compute_dtype: Optional[torch.dtype]):
    """``x @ w.T`` for an ``[out, in]`` weight, rounding once to ``compute_dtype``.

    On the card a bf16 GEMM accumulates in float32 and rounds once (the
    port's entry points turn reduced-precision reduction off).  The CPU's
    bf16 GEMM does not round once, so there the product runs in float32 on
    the bf16-rounded inputs and is rounded afterwards.
    """
    if compute_dtype is None:
        return x @ w.T
    xc, wc = x.to(compute_dtype), w.to(compute_dtype)
    if xc.is_cuda:
        return xc @ wc.T
    return (xc.float() @ wc.float().T).to(compute_dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    x32 = (x32 - mu) * torch.rsqrt(var + eps)
    return (x32 * scale + bias).to(x.dtype)


class MLP(nn.Module):
    """Dense layers with ReLU between them and an optional final LayerNorm."""

    def __init__(
        self,
        weights: Sequence[torch.Tensor],
        biases: Sequence[torch.Tensor],
        ln_scale: Optional[torch.Tensor] = None,
        ln_bias: Optional[torch.Tensor] = None,
        wscales: Optional[Sequence[torch.Tensor]] = None,
    ):
        super().__init__()
        # int8 codes carry no gradient
        grad = wscales is None
        self.weights = nn.ParameterList([nn.Parameter(w, requires_grad=grad) for w in weights])
        self.wscales = None if grad else nn.ParameterList(
            [nn.Parameter(s, requires_grad=False) for s in wscales]
        )
        self.biases = nn.ParameterList([nn.Parameter(b) for b in biases])
        self.layer_norm = ln_scale is not None
        if self.layer_norm:
            self.ln_scale = nn.Parameter(ln_scale)
            self.ln_bias = nn.Parameter(ln_bias)

    @classmethod
    def init(
        cls,
        generator: torch.Generator,
        in_dim: int,
        widths: Sequence[int],
        layer_norm: bool = True,
    ) -> "MLP":
        """Random init on the CPU from ``generator`` (``widths`` follows the
        ``[latent]*num_layers + [out]`` convention)."""
        weights, biases = [], []
        dim = in_dim
        for width in widths:
            bound = 1.0 / math.sqrt(max(dim, 1))
            weights.append(
                torch.empty(width, dim).uniform_(-bound, bound, generator=generator)
            )
            biases.append(
                torch.empty(width).uniform_(-bound, bound, generator=generator)
            )
            dim = width
        ln = (torch.ones(widths[-1]), torch.zeros(widths[-1])) if layer_norm else (None, None)
        return cls(weights, biases, *ln)

    @property
    def num_layers(self) -> int:
        return len(self.weights)

    @property
    def quantized(self) -> bool:
        return self.wscales is not None

    def forward(
        self,
        x: torch.Tensor,
        compute_dtype: Optional[torch.dtype] = None,
        from_layer: int = 0,
    ) -> torch.Tensor:
        """Apply layers ``[from_layer:]`` (+ LayerNorm).

        With ``from_layer > 0``, ``x`` is the pre-activation output of layer
        ``from_layer - 1`` (the factored first layer of the edge update).
        """
        n = self.num_layers
        if from_layer > 0 and from_layer < n:
            x = torch.relu(x)
        for i in range(from_layer, n):
            b = self.biases[i]
            if compute_dtype is not None:
                b = b.to(compute_dtype)
            if self.quantized:
                x = quant.dense_int8(x, self.weights[i], self.wscales[i]) + b
            else:
                x = dense(x, self.weights[i], compute_dtype) + b
            if i < n - 1:
                x = torch.relu(x)
        if self.layer_norm:
            x = layer_norm(x, self.ln_scale, self.ln_bias)
        return x
