"""Plain PyTorch version of the xmk0 GeMM kernel (mirrors repro's gemm_ref)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import acc_dtype, is_integer


def gemm_ref(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
             *, alpha: float = 1.0, beta: float = 0.0,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    acc = acc_dtype(torch.promote_types(a.dtype, b.dtype))
    if out_dtype is None:
        out_dtype = acc if acc == torch.int32 else a.dtype
    if acc == torch.int32:
        # CUDA has no integer matmul; f64 holds these int32 sums exactly
        out = (a.double() @ b.double()).to(torch.int32)
    else:
        out = a.float() @ b.float()
    scaled = alpha != 1.0 or c is not None
    if alpha != 1.0:
        out = alpha * out.float()
    if c is not None:
        out = out.float() + beta * c.float()
    if is_integer(out_dtype) and scaled:
        out = torch.round(out)          # half to even, as jnp.round
    return out.to(out_dtype)
