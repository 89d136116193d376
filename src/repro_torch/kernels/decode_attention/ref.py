"""Plain PyTorch version of decode attention (mirrors repro's
decode_attention_ref)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import NEG_INF


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None,
                         window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hkv, G, D); k, v: (B, Hkv, S, D); lengths: (B,) → (B, Hkv, G, D)."""
    d = q.shape[-1]
    s_len = k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    cols = torch.arange(s_len, device=q.device)[None, None, None, :]
    ln = lengths.to(torch.int32)[:, None, None, None]
    mask = cols < ln
    if window is not None:
        mask = mask & (cols >= torch.clamp(ln - window, min=0))
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    return out.to(q.dtype)
