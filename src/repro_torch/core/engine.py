"""ArcaneEngine — software decode of the xmnmc ISA at dispatch time.

Counterpart of repro.core.engine. Every model-level matrix operation is
encoded as an xmnmc instruction word (bit-exact with the reference encoder),
logged when ``record=True``, and dispatched to one kernel invocation.

backend: "cuda" — the hand-written CUDA kernels (CUDA tensors only; a CPU
                  tensor raises),
         "ref"  — plain PyTorch on any device, mirroring the reference
                  engine's ref path (gemm accumulates in f32 and casts
                  without rounding; attention is the blocked online-softmax
                  oracle; leakyrelu of an integer tensor returns the
                  unrounded f32 product, as the reference's does),
         "auto" — per call: the kernel for CUDA tensors, plain PyTorch for
                  CPU tensors (for leakyrelu the kernel's plain version,
                  which rounds as the kernel does).

Width suffixes are extended to float dtypes: .w ↦ f32/i32, .h ↦ bf16/i16,
.b ↦ i8.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.encoding import ElemWidth, encode_xmk, fx_encode
from repro_torch.kernels.common import is_integer
from repro_torch.kernels.convlayer.kernel import conv_layer_cuda
from repro_torch.kernels.convlayer.ref import conv_layer_ref
from repro_torch.kernels.decode_attention.kernel import (decode_attention_cuda,
                                                         mla_decode_attention_cuda)
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      mla_decode_attention_ref)
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_chunked_ref
from repro_torch.kernels.gemm.kernel import gemm_cuda
from repro_torch.kernels.leakyrelu.kernel import leakyrelu_cuda
from repro_torch.kernels.leakyrelu.ref import leakyrelu_ref
from repro_torch.kernels.maxpool.kernel import maxpool_cuda
from repro_torch.kernels.maxpool.ref import maxpool_ref


def _width_of(dtype: torch.dtype) -> ElemWidth:
    if dtype.itemsize >= 4:
        return ElemWidth.W
    if dtype.itemsize == 2:
        return ElemWidth.H
    return ElemWidth.B


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    word: int            # encoded xmnmc instruction
    mnemonic: str
    shapes: tuple
    flops: int


class ArcaneEngine:
    """Dispatch facade used by every model layer."""

    def __init__(self, backend: str = "auto", *, attn_block_k: int = 256,
                 record: bool = False):
        if backend not in ("cuda", "ref", "auto"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.attn_block_k = attn_block_k
        self.record = record
        self.trace: list[TraceEntry] = []

    def _kernel(self, t: torch.Tensor) -> bool:
        """Whether this call goes to the CUDA kernel."""
        if self.backend == "ref":
            return False
        if self.backend == "cuda" and not t.is_cuda:
            raise ValueError("ArcaneEngine('cuda') was given a CPU tensor")
        return t.is_cuda

    # ------------------------------------------------------------- recording
    def _log(self, func5: int, dtype, shapes, flops: int, **kw) -> None:
        if not self.record:
            return
        off = encode_xmk(func5, _width_of(dtype), md=0, **kw)
        self.trace.append(TraceEntry(
            word=off.word, mnemonic=off.instr.mnemonic,
            shapes=tuple(tuple(int(d) for d in s) for s in shapes),
            flops=int(flops)))

    # ------------------------------------------------------------------ ops
    def gemm(self, x: torch.Tensor, w: torch.Tensor,
             c: Optional[torch.Tensor] = None, *, alpha: float = 1.0,
             beta: float = 1.0, out_dtype=None) -> torch.Tensor:
        """xmk0 over arbitrary leading dims: (..., k) @ (k, n) [+ beta*c]."""
        lead = x.shape[:-1]
        k = x.shape[-1]
        n = w.shape[-1]
        m = 1
        for s in lead:
            m *= s
        self._log(0, x.dtype, (x.shape, w.shape), 2 * m * k * n,
                  alpha=fx_encode(min(max(alpha, -127), 127)),
                  beta=fx_encode(min(max(beta, -127), 127)))
        x2 = x.reshape(m, k)
        c2 = c.reshape(m, n) if c is not None else None
        if self._kernel(x):
            out = gemm_cuda(x2, w, c2, alpha=alpha, beta=beta,
                            out_dtype=out_dtype or x.dtype)
        else:
            out = x2.float() @ w.float()
            if alpha != 1.0:
                out = alpha * out
            if c2 is not None:
                out = out + beta * c2.float()
            out = out.to(out_dtype or x.dtype)
        return out.reshape(*lead, n)

    def leakyrelu(self, x: torch.Tensor, *,
                  negative_slope: float = 0.01) -> torch.Tensor:
        """xmk1 on a contiguous tensor of any shape."""
        self._log(1, x.dtype, (x.shape,), x.numel())
        if self.backend != "ref":
            fn = leakyrelu_cuda if self._kernel(x) else leakyrelu_ref
            return fn(x, negative_slope=negative_slope)
        # jnp.where(x >= 0, x, slope * x): the Python slope takes a float
        # x's dtype and makes an integer x f32, unrounded
        if is_integer(x.dtype):
            neg = negative_slope * x.float()
        else:
            neg = x * torch.tensor(negative_slope, dtype=x.dtype)
        return torch.where(x >= 0, x, neg)

    def maxpool(self, x: torch.Tensor, *, win: int = 2,
                stride: Optional[int] = None) -> torch.Tensor:
        """xmk2 over one (H, W) map."""
        self._log(2, x.dtype, (x.shape,), x.numel())
        fn = maxpool_cuda if self._kernel(x) else maxpool_ref
        return fn(x, win=win, stride=stride)

    def conv_layer(self, x: torch.Tensor, f: torch.Tensor, *,
                   negative_slope: float = 0.0) -> torch.Tensor:
        """xmk4: x (C, H, W), f (F, C, KH, KW) → (F, H', W'), in x's dtype."""
        cch, h, w = x.shape
        nf, _, kh, kw = f.shape
        self._log(4, x.dtype, (x.shape, f.shape),
                  2 * nf * cch * (h - kh + 1) * (w - kw + 1) * kh * kw)
        fn = conv_layer_cuda if self._kernel(x) else conv_layer_ref
        return fn(x, f, negative_slope=negative_slope)

    def attention(self, q, k, v, *, causal=True, window=None, softcap=None,
                  scale=None, kv_len=None) -> torch.Tensor:
        b, hq, sq, d = q.shape
        skv = k.shape[2]
        self._log(5, q.dtype, (q.shape, k.shape), 4 * b * hq * sq * skv * d)
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                  kv_len=kv_len)
        if self._kernel(q):
            return flash_attention_cuda(q, k, v, **kw)
        return attention_chunked_ref(q, k, v, chunk=self.attn_block_k, **kw)

    def decode_attention(self, q, k, v, lengths, *, softcap=None, scale=None,
                         window=None, return_lse=False):
        """→ (B, Hq, D); with ``return_lse`` that output in f32,
        unrounded, and the rows' log-sum-exp (B, Hq) f32, from the same
        launch (a cache sharded by sequence merges its ranks' slices with
        them and rounds once)."""
        b, hq, d = q.shape
        hkv, s = k.shape[1], k.shape[2]
        self._log(6, q.dtype, (q.shape, k.shape), 4 * b * hq * s * d)
        qg = q.reshape(b, hkv, hq // hkv, d)
        fn = decode_attention_cuda if self._kernel(q) else decode_attention_ref
        out = fn(qg, k, v, lengths, softcap=softcap, scale=scale,
                 window=window, return_lse=return_lse)
        if return_lse:
            return out[0].reshape(b, hq, d), out[1].reshape(b, hq)
        return out.reshape(b, hq, d)

    def mla_decode_attention(self, q, c, kr, lengths, *, scale, return_lse=False):
        """MLA's absorbed decode over the latent cache: q (B, H, r + rope),
        c (B, S, r), kr (B, S, rope) → (B, H, r) (with ``return_lse`` f32
        and the (B, H) lse), the function ``decode_attention`` computes over
        cat(c, kr) and pad(c), its first r columns; logged as that call. On
        the card no copy of the cache is made where the mla variant takes
        the operands."""
        b, hq, d = q.shape
        self._log(6, q.dtype, (q.shape, (b, 1, c.shape[1], d)),
                  4 * b * hq * c.shape[1] * d)
        fn = mla_decode_attention_cuda if self._kernel(q) else mla_decode_attention_ref
        return fn(q, c, kr, lengths, scale=scale, return_lse=return_lse)


_DEFAULT: Optional[ArcaneEngine] = None


def default_engine() -> ArcaneEngine:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = ArcaneEngine()
    return _DEFAULT


def set_default_engine(engine: ArcaneEngine) -> None:
    global _DEFAULT
    _DEFAULT = engine
