"""Plain PyTorch version of the xmk1 LeakyReLU kernel (mirrors repro's
leakyrelu_ref)."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import is_integer


def leakyrelu_ref(x: torch.Tensor, *, negative_slope: float = 0.01) -> torch.Tensor:
    neg = negative_slope * x.float()
    if is_integer(x.dtype):
        neg = torch.round(neg)          # half to even, as jnp.round
    return torch.where(x >= 0, x, neg.to(x.dtype))
