"""Plain PyTorch versions of flash attention (mirror repro's oracles).

``attention_ref`` — naive O(S²)-memory attention.
``attention_chunked_ref`` — blocked online softmax over KV chunks: the flash
algorithm itself, and the engine's ``ref`` attention.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.common import NEG_INF


def _mask(sq: int, sk: int, k_offset: int, kv_len: int, causal: bool,
          window: Optional[int], device) -> torch.Tensor:
    rows = torch.arange(sq, device=device)[:, None]
    cols = k_offset + torch.arange(sk, device=device)[None, :]
    m = cols < kv_len
    if causal:
        m = m & (cols <= rows)
    if window is not None:
        m = m & (cols > rows - window)
    return m


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D)."""
    _, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if kv_len is None:
        kv_len = skv
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    m = _mask(sq, skv, 0, kv_len, causal, window, q.device)
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def attention_chunked_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None,
                          kv_len: Optional[int] = None,
                          chunk: int = 1024) -> torch.Tensor:
    """Blocked online-softmax attention; memory O(Sq · chunk)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if kv_len is None:
        kv_len = skv
    chunk = min(chunk, skv)
    # GQA without materialising the head repeat: q viewed as
    # (B, Hkv, group, Sq, D) against the un-broadcast (B, Hkv, chunk, D)
    qf = (q.float() * scale).reshape(b, hkv, group, sq, d)
    acc = torch.zeros((b, hkv, group, sq, d), dtype=torch.float32,
                      device=q.device)
    m_prev = torch.full((b, hkv, group, sq, 1), NEG_INF, dtype=torch.float32,
                        device=q.device)
    l_prev = torch.zeros_like(m_prev)
    for k0 in range(0, skv, chunk):
        kb = k[:, :, k0:k0 + chunk].float()
        vb = v[:, :, k0:k0 + chunk].float()
        n = kb.shape[2]
        if n < chunk:              # the reference zero-pads the last chunk
            kb = torch.nn.functional.pad(kb, (0, 0, 0, chunk - n))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, chunk - n))
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        msk = _mask(sq, chunk, k0, kv_len, causal, window, q.device)
        s = torch.where(msk, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m_prev - m_new)
        l_prev = alpha * l_prev + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        m_prev = m_new
    out = acc / torch.clamp(l_prev, min=1e-30)
    return out.reshape(b, hq, sq, d).to(q.dtype)
