"""Strip-mining helpers shared by the lowering frontends.

The C-RT macro-kernel splits any operand larger than one VPU's vector
register file into column strips (strided ``xmr`` bindings over the same
buffer); these helpers compute the strip widths against the register-file
budget and emit strip-mined GEMMs through a :class:`ProgramBuilder`.

Own copy of repro.lower._strip.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.encoding import ElemWidth
from repro_torch.core.program import ProgramBuilder, View

#: The simulator's default VPU geometry (64 vregs x 1 KiB — see
#: ``benchmarks/fig4_speedup.arcane_cycles``); lowerings take overrides.
DEFAULT_VREGS = 64
DEFAULT_VLEN = 1024


def lines(nbytes: int, vlen_bytes: int) -> int:
    """Vector registers consumed by a packed operand of ``nbytes``."""
    return (nbytes + vlen_bytes - 1) // vlen_bytes


def col_strips(out_cols: int, fits: Callable[[int], bool]
               ) -> list[tuple[int, int]]:
    """Split ``out_cols`` destination columns into ``(c0, c1)`` strips: the
    widest power-of-two-halved strip whose operand set ``fits`` the register
    budget (1-column strips always ship — the runtime will reject a program
    that cannot fit even those, which is a genuine capacity error)."""
    sw = out_cols
    while sw > 1 and not fits(sw):
        sw = max(1, sw // 2)
    return [(c0, min(c0 + sw, out_cols)) for c0 in range(0, out_cols, sw)]


def emit_gemm(b: ProgramBuilder, a: View, w: View, dst: View, *,
              c: Optional[View] = None, alpha: float = 1.0, beta: float = 0.0,
              vregs: int = DEFAULT_VREGS, vlen: int = DEFAULT_VLEN,
              comment: str = "") -> None:
    """Emit ``dst = alpha * (a @ w) + beta * c`` as column strips of the
    destination (each strip re-reads the full ``a`` — the cross-instruction
    reuse regime the pipelined scheduler's ``reuse`` knob accelerates).

    ``c`` defaults to the destination strip itself (the Listing-1 idiom for
    β = 0, where the accumulator operand is numerically unused)."""
    eb = b.width.nbytes
    m, k = a.rows, a.cols
    n = w.cols
    assert w.rows == k and dst.shape == (m, n), (a.shape, w.shape, dst.shape)

    def fits(sw: int) -> bool:
        need = lines(m * k * eb, vlen) + lines(k * sw * eb, vlen) \
            + 2 * lines(m * sw * eb, vlen)      # accumulator + destination
        return need <= vregs - 2

    strips = col_strips(n, fits)
    for j, (c0, c1) in enumerate(strips):
        scols = c1 - c0
        dstrip = View(buf=dst.buf, rows=m, cols=scols,
                      row0=dst.row0, col0=dst.col0 + c0)
        wstrip = View(buf=w.buf, rows=k, cols=scols,
                      row0=w.row0, col0=w.col0 + c0)
        cstrip = dstrip if c is None else View(
            buf=c.buf, rows=m, cols=scols, row0=c.row0, col0=c.col0 + c0)
        note = comment or f"_gemm(m3, m0, m1, m2)  // {dst.buf}"
        if len(strips) > 1:
            note += f" cols [{c0}:{c1})"
        b.op("gemm", [a, wstrip, cstrip], dstrip, comment=note,
             alpha=alpha, beta=beta)
