"""Int8 (W8A8) inference: per-channel int8 weights, per-row int8 activations.

Counterpart of ``hyper_graph_nets_tpu/nn/quant.py``.  Training stays float;
for inference every MLP weight is quantized once to per-output-channel
symmetric int8 and every activation dynamically per row, so each dense
layer is an int8 x int8 -> int32 product (``torch._int_mm``) with a float32
epilogue.  Biases, LayerNorm and the normalizers stay float32.

``quantize_network`` returns a new network whose MLPs carry int8 codes and
scales (``nn.mlp.MLP`` with ``wscales``); ``MLP.forward`` and the factored
edge update (``nn/blocks.py``) dispatch on them, so the models serve either
numerics unchanged (``SystemModel.inference_state``).  A quantized edge
model never takes the fused kernels (``blocks._fused_mlp_shape_ok``), as in
the JAX package.

The arithmetic is the JAX package's forward as XLA compiles it, so that the
two agree bit for bit on the same inputs:

- weight scale ``amax / 127`` and codes ``round(w / scale)``, true divisions
  (``quantize_weight`` runs eagerly there);
- activation scale ``amax * float32(1/127)``: inside the jitted forward XLA
  folds ``max|x| / 127.0`` into that multiply; codes ``round(x / ax)``, a
  true division;
- epilogue ``(y * ax) * wscale`` in float32, left to right, then the input's
  dtype.

Rounding is half to even and codes are clipped to +-127 on both sides.  The
int32 accumulation is exact, so the card and the CPU give the same bits.
On the card ``torch._int_mm`` wants more than 16 rows and an inner and
output width that are multiples of 8: the operands are zero-padded to that
on every device (exact in int32); a shape it still refuses raises.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F

# float32(1/127): the constant XLA's folded division multiplies by
INV_127 = float(np.float32(1.0 / 127.0))
# torch._int_mm's shape rules on the card
MIN_ROWS = 17
WIDTH_MULTIPLE = 8


def quantize_weight(w: torch.Tensor):
    """``(codes int8 [..., out, in], scale float32 [..., out])`` of an
    ``[..., out, in]`` weight, ``w ~= codes * scale[..., None]``; an
    all-zero channel gets scale 1."""
    w = w.detach().to(torch.float32)
    amax = w.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.round(w / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return codes, scale


def _padded(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``x_q @ w_q.T`` in int32 for int8 ``x_q [M, K]`` and ``w_q [N, K]``.

    The operands are zero-padded to ``torch._int_mm``'s rules on the card
    (on the CPU too, where padding costs nothing that shows) and its second
    operand is column-major (``w_q`` rows contiguous); each call counts one
    in ``int8_matmul.calls``."""
    M, K = x_q.shape
    N = w_q.shape[0]
    Mp, Kp, Np = max(M, MIN_ROWS), _round_up(K, WIDTH_MULTIPLE), _round_up(N, WIDTH_MULTIPLE)
    a = _padded(x_q, Mp, Kp) if (Mp, Kp) != (M, K) else x_q.contiguous()
    b = _padded(w_q, Np, Kp) if (Np, Kp) != (N, K) else w_q.contiguous()
    int8_matmul.calls += 1
    y = torch._int_mm(a, b.t())
    return y if (Mp, Np) == (M, N) else y[:M, :N]


int8_matmul.calls = 0


def dense_int8(x: torch.Tensor, w_q: torch.Tensor, wscale: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` for int8 codes ``w_q [out, in]`` and their channel scales:
    ``x`` quantized per row, the product in int32, ``(y * ax) * wscale`` in
    float32, returned in ``x``'s dtype."""
    x32 = x.to(torch.float32)
    ax = x32.abs().amax(dim=-1, keepdim=True) * INV_127
    ax = torch.where(ax > 0, ax, torch.ones_like(ax))
    x_q = torch.round(x32 / ax).clamp(-127, 127).to(torch.int8)
    y = int8_matmul(x_q.reshape(-1, x.shape[-1]), w_q)
    y = y.reshape(*x.shape[:-1], w_q.shape[0])
    return ((y.to(torch.float32) * ax) * wscale).to(x.dtype)


def quantize_mlp(mlp):
    """A new MLP with ``mlp``'s weights as int8 codes and scales and copies
    of its biases and LayerNorm (float32); a copy of an int8 MLP."""
    from hyper_graph_nets_tpu_torch.nn.mlp import MLP

    if mlp.quantized:
        return copy.deepcopy(mlp)
    codes, scales = zip(*(quantize_weight(w) for w in mlp.weights))
    copy_ = lambda t: t.detach().clone()
    ln = (copy_(mlp.ln_scale), copy_(mlp.ln_bias)) if mlp.layer_norm else (None, None)
    return MLP(list(codes), [copy_(b) for b in mlp.biases], *ln, wscales=list(scales))


def quantize_network(net: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``net`` with every MLP quantized (``quantize_mlp``); ``net``
    is left as it was."""
    from hyper_graph_nets_tpu_torch.nn.mlp import MLP

    # deepcopy takes a module found in the memo as its own copy
    memo = {id(m): quantize_mlp(m) for m in net.modules() if isinstance(m, MLP)}
    return copy.deepcopy(net, memo)
