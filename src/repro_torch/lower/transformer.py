"""Lower transformer workloads onto the simulator as GEMM-dominated tapes.

Two scenarios, shapes taken from the ``repro_torch.configs`` registry (scaled to
cache-feasible dimensions — the modeled LLC is hundreds of KiB, not GiB):

* **decode step** — one token through ``layers`` transformer blocks with a
  resident KV cache: QKV projection, scores against the cached keys,
  a leakyrelu nonlinearity standing in for softmax (the kernel library is
  the paper's Table I — integer NMC has no exp), attention-weighted value
  gather, output projection, and the two MLP projections; residual adds run
  through GeMM's β-accumulate path against a shared identity matrix, so the
  whole step is xmr/xmk instructions only.
* **MoE expert burst** — ``experts`` independent ``W1 → leakyrelu → W2``
  expert MLPs over a token block: back-to-back GEMM chains with no
  cross-expert dependencies, the regime where the pipelined scheduler's
  VPU-level parallelism shows.

Every GEMM is emitted through the shared strip-miner, so oversized weight
matrices become column strips re-reading the activation row — the
cross-instruction reuse pattern ``PipelinedRuntime(reuse=True)`` detects.

Own copy of repro.lower.transformer; shapes come from the port's
config registry (:mod:`repro_torch.configs`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.encoding import ElemWidth
from repro_torch.core.program import (KernelProgram, ProgramBuilder,
                                      ProgramError)
from repro_torch.lower._strip import DEFAULT_VLEN, DEFAULT_VREGS, emit_gemm


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """Scaled shapes of one decode step (see :func:`decode_step_from_config`
    for deriving these from a ``repro_torch.configs`` architecture)."""

    name: str = "decode"
    d: int = 32               # model dim (scaled)
    ff: int = 96              # MLP hidden dim (scaled)
    kv: int = 32              # resident KV-cache length
    layers: int = 1
    vocab: int = 0            # >0: final logits projection (scaled vocab)
    width: ElemWidth = ElemWidth.B
    alpha: float = 0.125      # leakyrelu slope (softmax/silu stand-in)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """Scaled shapes of an MoE expert burst."""

    name: str = "moe"
    d: int = 32
    ff: int = 96
    tokens: int = 4           # token block routed to each expert
    experts: int = 2          # experts fired back to back (config: top_k)
    width: ElemWidth = ElemWidth.B
    alpha: float = 0.125
    seed: int = 0


def lower_decode_step(spec: DecodeSpec, *,
                      vregs_per_vpu: int = DEFAULT_VREGS,
                      vlen_bytes: int = DEFAULT_VLEN) -> KernelProgram:
    """One-token decode step as a validated, strip-mined tape."""
    if spec.d < 2 or spec.ff < 2 or spec.kv < 2 or spec.layers < 1:
        raise ProgramError(f"{spec.name}: degenerate decode shapes {spec}")
    b = ProgramBuilder(spec.name, spec.width)
    kw = dict(vregs=vregs_per_vpu, vlen=vlen_bytes)
    sfx = spec.width.suffix

    x = b.buffer("x0", 1, spec.d, init="random", seed=spec.seed, lo=-4, hi=4)
    ident = b.data("ident", np.eye(spec.d, dtype=np.int64))
    for l in range(spec.layers):
        wq = b.buffer(f"wq{l}", spec.d, spec.d, init="random",
                      seed=spec.seed + 10 * l + 1, lo=-3, hi=3)
        kt = b.buffer(f"kt{l}", spec.d, spec.kv, init="random",
                      seed=spec.seed + 10 * l + 2, lo=-3, hi=3)
        v = b.buffer(f"v{l}", spec.kv, spec.d, init="random",
                     seed=spec.seed + 10 * l + 3, lo=-3, hi=3)
        wo = b.buffer(f"wo{l}", spec.d, spec.d, init="random",
                      seed=spec.seed + 10 * l + 4, lo=-3, hi=3)
        w1 = b.buffer(f"w1_{l}", spec.d, spec.ff, init="random",
                      seed=spec.seed + 10 * l + 5, lo=-3, hi=3)
        w2 = b.buffer(f"w2_{l}", spec.ff, spec.d, init="random",
                      seed=spec.seed + 10 * l + 6, lo=-3, hi=3)

        q = b.buffer(f"q{l}", 1, spec.d)
        emit_gemm(b, b.full(x), b.full(wq), b.full(q), **kw,
                  comment=f"_gemm_{sfx}(m3, m0, m1, m2)  // q{l} = x @ Wq")
        scores = b.buffer(f"scores{l}", 1, spec.kv)
        emit_gemm(b, b.full(q), b.full(kt), b.full(scores), alpha=0.5, **kw,
                  comment=f"_gemm_{sfx}(m3, m0, m1, m2)  "
                          f"// scores{l} = 0.5 * q @ K^T (resident KV)")
        probs = b.buffer(f"probs{l}", 1, spec.kv)
        b.op("leakyrelu", [b.full(scores)], b.full(probs), alpha=spec.alpha,
             comment=f"_leakyrelu(m3, m0)  // probs{l} (softmax stand-in)")
        ctx = b.buffer(f"ctx{l}", 1, spec.d)
        emit_gemm(b, b.full(probs), b.full(v), b.full(ctx), **kw,
                  comment=f"_gemm_{sfx}(m3, m0, m1, m2)  // ctx{l} = p @ V")
        attn = b.buffer(f"attn{l}", 1, spec.d)
        emit_gemm(b, b.full(ctx), b.full(wo), b.full(attn), **kw,
                  comment=f"_gemm_{sfx}(m3, m0, m1, m2)  // attn{l} = ctx @ Wo")
        xa = b.buffer(f"xa{l}", 1, spec.d)
        emit_gemm(b, b.full(attn), b.full(ident), b.full(xa),
                  c=b.full(x), beta=1.0, **kw,
                  comment=f"_gemm_{sfx}(m3, m0, m1, m2)  "
                          f"// xa{l} = attn @ I + {x}  (residual via beta)")

        h1 = b.buffer(f"h1_{l}", 1, spec.ff)
        emit_gemm(b, b.full(xa), b.full(w1), b.full(h1), **kw,
                  comment=f"_gemm_{sfx}(m3, m0, m1, m2)  // h1_{l} = xa @ W1")
        act = b.buffer(f"act{l}", 1, spec.ff)
        b.op("leakyrelu", [b.full(h1)], b.full(act), alpha=spec.alpha,
             comment=f"_leakyrelu(m3, m0)  // act{l}")
        h2 = b.buffer(f"h2_{l}", 1, spec.d)
        emit_gemm(b, b.full(act), b.full(w2), b.full(h2), **kw,
                  comment=f"_gemm_{sfx}(m3, m0, m1, m2)  // h2_{l} = act @ W2")
        xn = b.buffer(f"x{l + 1}", 1, spec.d)
        emit_gemm(b, b.full(h2), b.full(ident), b.full(xn),
                  c=b.full(xa), beta=1.0, **kw,
                  comment=f"_gemm_{sfx}(m3, m0, m1, m2)  "
                          f"// x{l + 1} = h2 @ I + xa{l}  (residual via beta)")
        x = xn
    if spec.vocab > 0:
        wv = b.buffer("w_vocab", spec.d, spec.vocab, init="random",
                      seed=spec.seed + 7, lo=-3, hi=3)
        logits = b.buffer("logits", 1, spec.vocab)
        emit_gemm(b, b.full(x), b.full(wv), b.full(logits), **kw,
                  comment=f"_gemm_{sfx}(m3, m0, m1, m2)  "
                          f"// logits = {x} @ W_vocab")
    return b.build()


def lower_moe_burst(spec: MoESpec, *, vregs_per_vpu: int = DEFAULT_VREGS,
                    vlen_bytes: int = DEFAULT_VLEN) -> KernelProgram:
    """An MoE expert burst: ``experts`` independent expert MLPs over one
    routed token block, each a ``gemm → leakyrelu → gemm`` chain."""
    if spec.experts < 1 or spec.tokens < 1 or spec.d < 2 or spec.ff < 2:
        raise ProgramError(f"{spec.name}: degenerate MoE shapes {spec}")
    b = ProgramBuilder(spec.name, spec.width)
    kw = dict(vregs=vregs_per_vpu, vlen=vlen_bytes)
    sfx = spec.width.suffix
    x = b.buffer("tokens", spec.tokens, spec.d, init="random",
                 seed=spec.seed, lo=-4, hi=4)
    for e in range(spec.experts):
        w1 = b.buffer(f"e{e}_w1", spec.d, spec.ff, init="random",
                      seed=spec.seed + 10 * e + 1, lo=-3, hi=3)
        w2 = b.buffer(f"e{e}_w2", spec.ff, spec.d, init="random",
                      seed=spec.seed + 10 * e + 2, lo=-3, hi=3)
        h = b.buffer(f"e{e}_h", spec.tokens, spec.ff)
        emit_gemm(b, b.full(x), b.full(w1), b.full(h), **kw,
                  comment=f"_gemm_{sfx}(m3, m0, m1, m2)  "
                          f"// expert {e}: h = tokens @ W1")
        a = b.buffer(f"e{e}_act", spec.tokens, spec.ff)
        b.op("leakyrelu", [b.full(h)], b.full(a), alpha=spec.alpha,
             comment=f"_leakyrelu(m3, m0)  // expert {e} activation")
        y = b.buffer(f"e{e}_out", spec.tokens, spec.d)
        emit_gemm(b, b.full(a), b.full(w2), b.full(y), **kw,
                  comment=f"_gemm_{sfx}(m3, m0, m1, m2)  "
                          f"// expert {e}: out = act @ W2")
    return b.build()


# ------------------------------------------------------ configs/* frontend
def _scaled(dim: int, scale: int, floor: int = 8) -> int:
    """Scale a model dimension down to a cache-feasible multiple of 4."""
    return max(floor, (dim // scale) // 4 * 4)


def decode_step_from_config(arch: str, *, scale: int = 64, kv: int = 32,
                            layers: int = 1, vocab_scale: int = 1024,
                            width: ElemWidth = ElemWidth.B, seed: int = 0,
                            **lower_kw) -> tuple[KernelProgram, DecodeSpec]:
    """Lower a decode step with shapes from the ``repro_torch.configs`` registry,
    divided by ``scale`` (the paper's machine is a microcontroller-class LLC;
    full LLM dims would need thousands of strips to no modeling benefit).
    Returns ``(program, spec)``; ``spec`` records the scaled shapes."""
    # deferred: keeps repro_torch.lower light
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    spec = DecodeSpec(
        name=f"decode-{arch}", d=_scaled(cfg.d_model, scale),
        ff=_scaled(cfg.d_ff, scale), kv=kv,
        layers=min(layers, cfg.n_layers),
        vocab=_scaled(cfg.vocab, vocab_scale, floor=16),
        width=width, seed=seed)
    return lower_decode_step(spec, **lower_kw), spec


def moe_burst_from_config(arch: str, *, scale: int = 64, tokens: int = 4,
                          experts: int = 0, width: ElemWidth = ElemWidth.B,
                          seed: int = 0, **lower_kw
                          ) -> tuple[KernelProgram, MoESpec]:
    """Lower an expert burst for an MoE architecture from the registry
    (``experts`` defaults to the config's ``top_k`` — the experts a token
    actually fires). Raises :class:`ProgramError` for non-MoE archs."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if cfg.moe is None:
        raise ProgramError(f"{arch} has no MoE block to lower")
    spec = MoESpec(
        name=f"moe-{arch}", d=_scaled(cfg.d_model, scale),
        ff=_scaled(cfg.d_ff, scale), tokens=tokens,
        experts=experts or cfg.moe.top_k, width=width, seed=seed)
    return lower_moe_burst(spec, **lower_kw), spec
