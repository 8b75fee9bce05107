"""Device selection and numerics for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a missing
card raises instead of silently running on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def configure_numerics() -> None:
    """Full-precision float32 products and single-rounding bf16 products on
    the card: the JAX package's f32 path uses ``Precision.HIGHEST`` and its
    bf16 products accumulate in float32 (``nn/mlp.py:56-65``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                "passes device='cpu'"
            )
        configure_numerics()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
