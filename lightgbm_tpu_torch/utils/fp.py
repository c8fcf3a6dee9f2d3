"""float32 arithmetic in the JAX package's rounding."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

Operand = Union[torch.Tensor, float]


def f32(v: float) -> float:
    """``v`` rounded to float32, kept a Python number: a constant operand
    needs no host-to-device copy, which on the card would sync."""
    return float(np.float32(v))


def _double(v: Operand) -> Operand:
    return v.double() if isinstance(v, torch.Tensor) else v


def fma(a: torch.Tensor, b: Operand, c: Operand) -> torch.Tensor:
    """float32 ``a * b + c`` as one fused multiply-add, as XLA's CPU
    backend contracts a product feeding a sum: the product of two float32
    values is exact in float64, and the sum is rounded to float32 from
    there. Each step is a correctly rounded IEEE operation, so the card
    and the CPU give the same bits. ``b`` and ``c`` may be Python numbers
    already rounded to float32 (``f32``)."""
    return (a.double() * _double(b) + _double(c)).float()
