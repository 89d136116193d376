"""Public xmk1 LeakyReLU: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.leakyrelu.kernel import leakyrelu_cuda
from repro_torch.kernels.leakyrelu.ref import leakyrelu_ref


def leakyrelu(x: torch.Tensor, *, negative_slope: float = 0.01) -> torch.Tensor:
    fn = leakyrelu_cuda if x.is_cuda else leakyrelu_ref
    return fn(x, negative_slope=negative_slope)
