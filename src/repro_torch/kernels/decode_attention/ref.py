"""Plain PyTorch version of decode attention (mirrors repro's
decode_attention_ref)."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

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
                         window: Optional[int] = None,
                         return_lse: bool = False):
    """q: (B, Hkv, G, D); k, v: (B, Hkv, S, D); lengths: (B,) → (B, Hkv, G, D).

    ``return_lse``: (out in f32, unrounded; the rows' natural log-sum-exp
    of the scaled (and capped) scores over their valid keys, (B, Hkv, G)
    f32); a row with no valid key (a length at most 0, or a window that
    starts past S) has out 0 and lse −inf."""
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
    if return_lse:
        return _with_lse(s, mask, v)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    return out.to(q.dtype)


def _with_lse(s, mask, v):
    """(out f32, lse) of the masked scores ``s``: exp(s − max) summed over
    the valid keys; out 0 and lse −inf where a row has none."""
    mask = mask.expand_as(s)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    some = l > 0
    out = torch.einsum("bhgs,bhsd->bhgd", p, v.float()) / torch.where(
        some, l, torch.ones_like(l))
    lse = torch.where(some, m + torch.log(l), torch.full_like(l, -math.inf))
    return out, lse[..., 0]


def mla_decode_attention_ref(q: torch.Tensor, c: torch.Tensor, kr: torch.Tensor,
                             lengths: torch.Tensor, *, scale: float,
                             return_lse: bool = False):
    """MLA's absorbed decode, plain: q (B, G, r + rope) over the keys
    cat(c, kr) and the values pad(c) (c (B, S, r), kr (B, S, rope), one
    latent head), cast to q's dtype, through ``decode_attention_ref``, the
    first r columns → (B, G, r); with ``return_lse`` (that output f32 and
    the rows' lse (B, G))."""
    out = decode_attention_ref(q[:, None], *mla_keys_values(c, kr, q.dtype),
                               lengths, scale=scale, return_lse=return_lse)
    return mla_columns(out, c.shape[2], return_lse)


def mla_keys_values(c: torch.Tensor, kr: torch.Tensor, dtype):
    """The latent cache as one KV head of decode attention, copied: keys
    cat(c, kr) and values c zero-padded to r + rope, (B, 1, S, r + rope)
    in ``dtype``."""
    keys = torch.cat([c, kr], dim=-1)[:, None].to(dtype)
    vals = F.pad(c, (0, kr.shape[2]))[:, None].to(dtype)
    return keys, vals


def mla_columns(out, r: int, return_lse: bool):
    """Decode attention's (B, 1, G, r + rope) output over ``mla_keys_values``
    (and its (B, 1, G) lse) → the first r columns (B, G, r) (and (B, G))."""
    if return_lse:
        return out[0][:, 0, :, :r], out[1][:, 0]
    return out[:, 0, :, :r]
