"""Public flash attention: the CUDA kernel for CUDA tensors, the blocked
online-softmax plain version (the same algorithm) for CPU tensors."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_chunked_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None,
                    block_k: int = 256) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) → (B, Hq, Sq, D)."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              kv_len=kv_len)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, **kw)
    return attention_chunked_ref(q, k, v, chunk=block_k, **kw)
