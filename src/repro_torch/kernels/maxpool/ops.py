"""Public xmk2 MaxPool: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.maxpool.kernel import maxpool_cuda
from repro_torch.kernels.maxpool.ref import maxpool_ref


def maxpool(x: torch.Tensor, *, win: int = 2,
            stride: Optional[int] = None) -> torch.Tensor:
    """Max pooling over x (H, W) with a square window."""
    fn = maxpool_cuda if x.is_cuda else maxpool_ref
    return fn(x, win=win, stride=stride)
