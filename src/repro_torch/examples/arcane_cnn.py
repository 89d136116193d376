"""Paper Listing 1 — the xmnmc programming model, end to end (counterpart of
examples/arcane_cnn.py).

A 3-channel convolutional layer executed as THREE matrix reservations and ONE
complex instruction, exactly like the paper's C listing:

    // Reservation
    _xmr_w(m0, A, 1, rowsA, colsA);
    _xmr_w(m1, F, 1, rowsF, colsF);
    _xmr_w(m2, R, 1, rowsR, colsR);
    // Matrix Kernel
    _conv_layer_w(m2, m0, m1);

The program is built through the kernel IR (``repro_torch.core.program``) —
``issue_program`` emits precisely those four instructions — and runs the
port's simulator stack (CV-X-IF bridge → software decode → hazard check →
VPU dispatch → 2D-DMA allocation → fused compute → deferred write-back) with
its memory and cache lines on the device, prints the phase split (Fig. 3)
and the modeled speedup vs a scalar-CPU execution (Fig. 4), then holds the
result against the plain ``conv_layer`` on the same A and F and, on the
card, against the ``convlayer.cu`` kernel through ``ArcaneEngine("cuda")``::

    PYTHONPATH=src python -m repro_torch.examples.arcane_cnn             # card
    PYTHONPATH=src python -m repro_torch.examples.arcane_cnn --device cpu
    PYTHONPATH=src python -m repro_torch.examples.arcane_cnn --width b
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import (ArcaneCoprocessor, ElemWidth, ProgramBuilder,
                              ProgramRun, issue_program, place_program)
from repro_torch.core.engine import ArcaneEngine
from repro_torch.core.isa import _convlayer_preamble
from repro_torch.kernels.convlayer.ref import conv_layer_ref

#: The example's LLC: 4 VPUs of 64 vector registers of 1 KiB, 8 lanes each.
GEOMETRY = dict(n_vpus=4, vregs_per_vpu=64, vlen_bytes=1024, lanes=8)


def build_listing1(h: int = 64, w: int = 64, k: int = 3,
                   width: ElemWidth = ElemWidth.W):
    """Listing 1 as a KernelProgram: one fused conv-layer instruction over
    the whole image (it fits the register file at 64x64)."""
    b = ProgramBuilder("listing1", width)
    b.buffer("A", 3 * h, w, init="random", seed=0, lo=-8, hi=8)
    b.buffer("F", 3 * k, k, init="random", seed=1, lo=-4, hi=4)
    b.buffer("R", (h - k + 1) // 2, (w - k + 1) // 2)
    b.op("conv_layer", [b.full("A"), b.full("F")], b.full("R"),
         comment="_conv_layer_w(m3, m0, m1)   // Listing 1 Matrix Kernel")
    return b.build()


def run_listing1(prog, device) -> dict:
    """Place, issue (3x xmr + 1x xmk4) and gather R on a fresh coprocessor
    on ``device``: R, the phase stats (placement left out) and the run."""
    cop = ArcaneCoprocessor(device=device, **GEOMETRY)
    addrs = place_program(cop, prog)      # host stores (coherent), untimed
    cop.rt.stats.reset()
    issue_program(cop, prog, addrs)       # ---- Listing 1: 3x xmr + 1x xmk4
    run = ProgramRun(prog=prog, cop=cop, addrs=addrs)
    return {"R": run.gather("R"), "stats": cop.rt.stats, "run": run}


def scalar_cycles(h: int, w: int, k: int) -> int:
    """CV32E40X-class scalar baseline: ~3 cycles/MAC inner loop + ld/op/st
    per elementwise op (the model the Fig. 4 benchmark sweeps)."""
    _, cost = _convlayer_preamble([(3 * h, w), (3 * k, k)], {}, ElemWidth.W)
    return 3 * cost.macs + 3 * cost.elementwise


def layer_inputs(prog, h: int, w: int, k: int, device):
    """A (3, H, W) and F (1, 3, K, K) of the program, as the conv layer's
    kernel takes them."""
    A = prog.buffer("A").materialize(prog.width)
    F = prog.buffer("F").materialize(prog.width)
    return A.reshape(3, h, w).to(device), F.reshape(1, 3, k, k).to(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--width", default="w", choices=("w", "h", "b"),
                    help="element width: 32, 16 or 8 bits (default w)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    H = W = 64
    K = 3
    width = ElemWidth.from_suffix(args.width)
    prog = build_listing1(H, W, K, width)
    res = run_listing1(prog, device)
    R = res["R"]

    x, f = layer_inputs(prog, H, W, K, device)
    plain = conv_layer_ref(x, f)[0]
    if not torch.equal(R, plain):
        raise SystemExit("simulator disagrees with the plain conv_layer")
    legs = "simulator == plain conv_layer"
    if device.type == "cuda":
        kernel = ArcaneEngine("cuda").conv_layer(x, f)[0]
        if not torch.equal(kernel, plain):
            raise SystemExit("the convlayer.cu kernel disagrees with the plain "
                             "conv_layer")
        legs = "simulator == convlayer.cu kernel == plain conv_layer"

    stats = res["stats"]
    print(f"conv layer {H}x{W} 3ch int{8 * width.nbytes} on 8-lane ARCANE "
          f"({device.type})")
    print(f"  result {tuple(R.shape)}, checksum "
          f"{int(R.to(torch.int64).sum())}")
    print(f"  kernels run: {stats.kernels_run}, cycles: {stats.total_cycles}")
    print("  phase split: " + "  ".join(
        f"{k}={v:.1%}" for k, v in stats.shares().items()))
    print(f"  modeled speedup vs scalar RV32IMC: "
          f"{scalar_cycles(H, W, K) / stats.total_cycles:.1f}x")
    print(f"  {legs} ✓")


if __name__ == "__main__":
    main()
