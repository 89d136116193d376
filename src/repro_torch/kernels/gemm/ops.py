"""Public xmk0 GeMM: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors. No padding: the kernel masks ragged M, N and K itself."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.gemm.kernel import gemm_cuda
from repro_torch.kernels.gemm.ref import gemm_ref


def gemm(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
         *, alpha: float = 1.0, beta: float = 0.0,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """D = alpha * (A @ B) + beta * C, shapes (m, k) x (k, n) [+ (m, n)]."""
    fn = gemm_cuda if a.is_cuda else gemm_ref
    return fn(a, b, c, alpha=alpha, beta=beta, out_dtype=out_dtype)
