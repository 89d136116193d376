"""Lower the paper's CNN onto the simulator as a strip-mined KernelProgram.

The front layer is the paper's Listing-1 workload: a fused 3-channel conv
layer (``xmk4`` = conv + 2x2 maxpool + ReLU) over a channel-stacked
``(3H, W)`` image, issued as column strips sized to the VPU register file —
input strips are strided ``xmr`` bindings (stride = image width), exactly
the decomposition ``benchmarks/fig4_speedup.tiled_conv_layer`` used to
hand-roll. Deeper stages are unfused ``conv2d → leakyrelu → maxpool`` chains
on the single-channel feature map, each stage strip-mined independently; an
optional GEMM classifier head closes the network. Any depth, batch size, and
element width (the paper's "worst-case 32-bit workload" is ``ElemWidth.W``).

Buffer naming (per batch image ``i``): ``x{i}`` input, ``f0`` fused-layer
filter, ``l0_out{i}`` its output, then per extra stage ``d``:
``f{d}`` filter, ``l{d}_conv{i}`` / ``l{d}_act{i}`` / ``l{d}_pool{i}``;
``head`` weights and ``logits{i}`` when ``classes > 0``.

Own copy of repro.lower.cnn.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.encoding import ElemWidth
from repro_torch.core.program import (KernelProgram, ProgramBuilder,
                                      ProgramError, View)
from repro_torch.lower._strip import (DEFAULT_VLEN, DEFAULT_VREGS, col_strips,
                                      emit_gemm, lines)


@dataclasses.dataclass(frozen=True)
class CNNSpec:
    """Shape of the lowered CNN (defaults: the paper's 32x32 Listing-1 run)."""

    name: str = "cnn"
    h: int = 32               # input spatial height (image is (3h, w))
    w: int = 32
    k: int = 3                # fused-layer filter size (filter is (3k, k))
    width: ElemWidth = ElemWidth.W
    depth: int = 0            # extra conv2d -> leakyrelu -> maxpool stages
    k2: int = 3               # filter size of the extra stages
    alpha: float = 0.25       # leakyrelu slope in the unfused stages
    classes: int = 0          # >0: GEMM classifier head over pooled features
    batch: int = 1
    seed: int = 0


def lower_cnn(spec: CNNSpec, *, vregs_per_vpu: int = DEFAULT_VREGS,
              vlen_bytes: int = DEFAULT_VLEN) -> KernelProgram:
    """Lower ``spec`` into a validated, strip-mined :class:`KernelProgram`."""
    eb = spec.width.nbytes
    sfx = spec.width.suffix
    b = ProgramBuilder(spec.name, spec.width)

    f0 = b.buffer("f0", 3 * spec.k, spec.k, init="random",
                  seed=spec.seed + 1, lo=-4, hi=4)
    head = None
    if spec.classes > 0:
        pass  # head shape depends on the final feature map; declared below

    for i in range(spec.batch):
        x = b.buffer(f"x{i}", 3 * spec.h, spec.w, init="random",
                     seed=spec.seed + 10 + i)
        cur = _fused_layer(b, spec, i, x, f0, vregs_per_vpu, vlen_bytes)
        for d in range(1, spec.depth + 1):
            cur = _unfused_stage(b, spec, i, d, cur, vregs_per_vpu,
                                 vlen_bytes, eb, sfx)
        if spec.classes > 0:
            feat = b.full(cur)
            if head is None:
                head = b.buffer("head", feat.cols, spec.classes,
                                init="random", seed=spec.seed + 2, lo=-3, hi=3)
            logits = b.buffer(f"logits{i}", feat.rows, spec.classes)
            emit_gemm(b, feat, b.full(head), b.full(logits),
                      alpha=1.0, beta=0.0,
                      vregs=vregs_per_vpu, vlen=vlen_bytes,
                      comment=f"_gemm_{sfx}(m3, m0, m1, m2)  "
                              f"// logits{i} = {cur} @ head")
    return b.build()


def _fused_layer(b: ProgramBuilder, spec: CNNSpec, i: int, x: str, f0: str,
                 vregs: int, vlen: int) -> str:
    """The Listing-1 fused conv layer, column-strip-mined to the register
    file (same budget arithmetic as the C-RT macro-kernel: 2 slack registers
    + the filter's lines are reserved, input strips span ``2*sw + k - 1``
    image columns per ``sw`` output columns)."""
    h, w, k, eb = spec.h, spec.w, spec.k, spec.width.nbytes
    cm, cn = h - k + 1, w - k + 1
    if cm < 2 or cn < 2:
        raise ProgramError(f"{spec.name}: {h}x{w} conv output smaller than "
                           f"the fused 2x2 pool window")
    om, on = cm // 2, cn // 2
    out = b.buffer(f"l0_out{i}", om, on)
    budget = vregs - 2 - lines(3 * k * k * eb, vlen)

    def fits(sw: int) -> bool:
        win = 2 * sw + k - 1
        return lines(3 * h * win * eb, vlen) + lines(om * sw * eb, vlen) \
            <= budget

    sfx = spec.width.suffix
    for c0, c1 in col_strips(on, fits):
        scols = c1 - c0
        win = 2 * scols + k - 1
        b.op("conv_layer",
             [View(buf=x, rows=3 * h, cols=win, col0=2 * c0), b.full(f0)],
             View(buf=out, rows=om, cols=scols, col0=c0),
             comment=f"_conv_layer_{sfx}(m3, m0, m1)  "
                     f"// {out}[:, {c0}:{c1}) from {x}[:, {2*c0}:{2*c0+win})")
    return out


def _unfused_stage(b: ProgramBuilder, spec: CNNSpec, i: int, d: int,
                   cur: str, vregs: int, vlen: int, eb: int, sfx: str) -> str:
    """One conv2d → leakyrelu → maxpool stage on the single-channel feature
    map, every step strip-mined over destination columns."""
    src = b.full(cur)
    cr, cc = src.rows, src.cols
    k2 = spec.k2
    if cr < k2 + 1 or cc < k2 + 1:
        raise ProgramError(f"{spec.name}: stage {d} input {cr}x{cc} too "
                           f"small for a {k2}x{k2} conv + 2x2 pool")
    fname = f"f{d}"
    if i == 0:
        b.buffer(fname, k2, k2, init="random", seed=spec.seed + 100 + d,
                 lo=-3, hi=3)

    # conv2d: out strip of sw cols reads an (sw + k2 - 1)-col input strip
    vr, vc = cr - k2 + 1, cc - k2 + 1
    conv = b.buffer(f"l{d}_conv{i}", vr, vc)
    cbudget = vregs - 2 - lines(k2 * k2 * eb, vlen)

    def conv_fits(sw: int) -> bool:
        return lines(cr * (sw + k2 - 1) * eb, vlen) \
            + lines(vr * sw * eb, vlen) <= cbudget

    for c0, c1 in col_strips(vc, conv_fits):
        scols = c1 - c0
        b.op("conv2d",
             [View(buf=cur, rows=cr, cols=scols + k2 - 1, col0=c0),
              b.full(fname)],
             View(buf=conv, rows=vr, cols=scols, col0=c0),
             comment=f"_conv2d(m3, m0, m1)  // {conv}[:, {c0}:{c1})")

    # leakyrelu: elementwise, same-shape strips
    act = b.buffer(f"l{d}_act{i}", vr, vc)

    def ew_fits(sw: int) -> bool:
        return 2 * lines(vr * sw * eb, vlen) <= vregs - 2

    for c0, c1 in col_strips(vc, ew_fits):
        scols = c1 - c0
        b.op("leakyrelu",
             [View(buf=conv, rows=vr, cols=scols, col0=c0)],
             View(buf=act, rows=vr, cols=scols, col0=c0),
             comment=f"_leakyrelu(m3, m0)  // {act}[:, {c0}:{c1})",
             alpha=spec.alpha)

    # maxpool 2x2 stride 2: out strip of sw cols reads 2*sw input cols
    pm, pn = (vr - 2) // 2 + 1, (vc - 2) // 2 + 1
    pool = b.buffer(f"l{d}_pool{i}", pm, pn)

    def pool_fits(sw: int) -> bool:
        return lines(vr * 2 * sw * eb, vlen) + lines(pm * sw * eb, vlen) \
            <= vregs - 2

    for c0, c1 in col_strips(pn, pool_fits):
        scols = c1 - c0
        b.op("maxpool",
             [View(buf=act, rows=vr, cols=2 * scols, col0=2 * c0)],
             View(buf=pool, rows=pm, cols=scols, col0=c0),
             comment=f"_maxpool(m3, m0, 2, 2)  // {pool}[:, {c0}:{c1})",
             stride=2, win_size=2)
    return pool
