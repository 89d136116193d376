"""Plain PyTorch version of decode attention (mirrors repro's
decode_attention_ref)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import NEG_INF

GMAX, DMAX = 40, 288   # MLA's absorbed decode: 40 query heads, D = 256 + 32


def check_shape(g: int, d: int, itemsize: int) -> None:
    """The shapes the kernel takes, checked here and by the C side alike:
    1 <= G <= 40 query heads a KV head, D up to 288 with rows of a
    multiple of 16 bytes."""
    if not 1 <= g <= GMAX or not 0 < d <= DMAX or d * itemsize % 16:
        raise ValueError(
            f"decode_attention: G={g} (1 to {GMAX}) and D={d} (up to {DMAX}, "
            f"rows of a multiple of 16 bytes, here {d * itemsize}) are what "
            "the kernel takes")


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None,
                         window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hkv, G, D); k, v: (B, Hkv, S, D); lengths: (B,) → (B, Hkv, G, D)."""
    g, d = q.shape[-2], q.shape[-1]
    check_shape(g, d, q.element_size())
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
