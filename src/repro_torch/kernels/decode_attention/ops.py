"""Public decode attention: head grouping, then the CUDA kernel for CUDA
tensors or the plain version for CPU tensors."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.kernel import (decode_attention_cuda,
                                                         mla_decode_attention_cuda)
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      mla_decode_attention_ref)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, softcap: Optional[float] = None,
                     scale: Optional[float] = None,
                     window: Optional[int] = None, return_lse: bool = False):
    """One-token GQA decode over a KV cache.

    q: (B, Hq, D); k, v: (B, Hkv, S, D); lengths: (B,) → (B, Hq, D); with
    ``return_lse`` that output in f32, unrounded, and the rows' log-sum-exp
    (B, Hq) f32 (−inf for a row with no valid key, whose output is 0).
    """
    b, hq, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"decode_attention: {hq} query heads on {hkv} KV heads")
    qg = q.reshape(b, hkv, hq // hkv, d)
    fn = decode_attention_cuda if q.is_cuda else decode_attention_ref
    out = fn(qg, k, v, lengths, softcap=softcap, scale=scale, window=window,
             return_lse=return_lse)
    if return_lse:
        return out[0].reshape(b, hq, d), out[1].reshape(b, hq)
    return out.reshape(b, hq, d)


def mla_decode_attention(q: torch.Tensor, c: torch.Tensor, kr: torch.Tensor,
                         lengths: torch.Tensor, *, scale: float,
                         return_lse: bool = False):
    """MLA's absorbed decode over the latent cache as the model holds it.

    q: (B, H, r + rope); c: (B, S, r); kr: (B, S, rope); lengths: (B,) →
    (B, H, r), exactly ``decode_attention(q, cat(c, kr)[:, None],
    pad(c, rope)[:, None], lengths)[..., :r]``; with ``return_lse`` that
    output in f32, unrounded, and the rows' log-sum-exp (B, H) f32.
    """
    fn = mla_decode_attention_cuda if q.is_cuda else mla_decode_attention_ref
    return fn(q, c, kr, lengths, scale=scale, return_lse=return_lse)
