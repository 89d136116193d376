"""Pipelined C-RT demo: a batched CNN front-end scheduled two ways
(counterpart of examples/pipelined_cnn.py).

Builds ONE xmnmc program through the shared kernel IR — a batch of four
3-channel conv layers followed by a GEMM classifier head over the pooled
features — and runs the identical tape through

  1. the serial C-RT (``CacheRuntime``): decode → allocate → compute →
     write-back, one kernel at a time, and
  2. the event-driven pipelined C-RT (``repro_torch.sim.PipelinedRuntime``):
     DMA-in of the next image overlaps compute of the previous one on another
     VPU, deferred write-backs drain on idle DMA ports.

Both runtimes keep their memory and cache lines on ``--device`` (the card
unless the caller asks for the CPU). The kernel outputs are bit-identical
(the two schedulers share the same phase steps) and both match the
sequential plain oracle (``repro_torch.core.reference_images``); only the
modeled cycles differ. On the card each image's feature map is also held
against the ``convlayer.cu`` kernel through ``ArcaneEngine("cuda")``. The
pipelined run exports a Chrome ``trace_event`` JSON — load it at
https://ui.perfetto.dev (or ``chrome://tracing``) and look at one row per
modeled resource: the eCPU, the cache lock, and each VPU's datapath and DMA
port.

Usage::

    PYTHONPATH=src python -m repro_torch.examples.pipelined_cnn            # card
    PYTHONPATH=src python -m repro_torch.examples.pipelined_cnn --device cpu \\
        [--config arcane-8vpu|path.yaml] [--trace out.json] [--batch N]
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import (ArcaneCoprocessor, ElemWidth, ProgramBuilder,
                              reference_images, run_program)
from repro_torch.sim import load_config


def build_program(*, batch=4, h=32, w=32, k=3, classes=10):
    """The batched conv + classifier tape. Per image: one fused conv layer
    (independent kernels, free to spread across VPUs) then a dependent GEMM
    head consuming the deferred feature map."""
    b = ProgramBuilder("pipelined-cnn", ElemWidth.W)
    om, on = (h - k + 1) // 2, (w - k + 1) // 2
    b.buffer("filt", 3 * k, k, init="random", seed=1, lo=-4, hi=4)
    b.buffer("head", on, classes, init="random", seed=2, lo=-3, hi=3)
    for i in range(batch):
        b.buffer(f"img{i}", 3 * h, w, init="random", seed=10 + i, lo=-8, hi=8)
        b.buffer(f"feat{i}", om, on)
        b.buffer(f"out{i}", om, classes)
        b.op("conv_layer", [b.full(f"img{i}"), b.full("filt")],
             b.full(f"feat{i}"),
             comment=f"_conv_layer_w(m3, m0, m1)  "
                     f"// feat{i} = convlayer(img{i})")
        # dst doubles as the beta=0 accumulator (the Listing-1 GEMM idiom)
        b.op("gemm", [b.full(f"feat{i}"), b.full("head"), b.full(f"out{i}")],
             b.full(f"out{i}"), alpha=1.0, beta=0.0,
             comment=f"_gemm_w(m3, m0, m1, m2)  // out{i} = feat{i} @ head")
    return b.build()


def conv_inputs(prog, image: str, filt: str, device):
    """The (3, H, W) image and (1, 3, K, K) filter of one of ``prog``'s conv
    layers, as the conv layer's kernel takes them."""
    x = prog.buffer(image).materialize(prog.width)
    f = prog.buffer(filt).materialize(prog.width)
    return (x.reshape(3, x.shape[0] // 3, x.shape[1]).to(device),
            f.reshape(1, 3, f.shape[0] // 3, f.shape[1]).to(device))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--config", default="arcane-default",
                   help="builtin config name or YAML path (default: "
                        "arcane-default; try arcane-8vpu)")
    p.add_argument("--trace", default="out/pipelined_cnn_trace.json",
                   help="Chrome trace_event JSON output path "
                        "(default: the gitignored out/ directory)")
    p.add_argument("--batch", type=int, default=4)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config(args.config)
    print(f"config: {cfg.description or args.config} "
          f"({cfg.n_vpus} VPUs x {cfg.lanes} lanes, "
          f"{cfg.llc_bytes // 1024} KiB LLC)")

    prog = build_program(batch=args.batch)

    cop_s = ArcaneCoprocessor(
        runtime=cfg.make_runtime("serial", device=device))
    run_s = run_program(cop_s, prog)
    out_s = [run_s.gather(f"out{i}") for i in range(args.batch)]
    serial_cycles = cop_s.rt.stats.total_cycles

    cop_p = ArcaneCoprocessor(
        runtime=cfg.make_runtime("pipelined", device=device))
    run_p = run_program(cop_p, prog)
    out_p = [run_p.gather(f"out{i}") for i in range(args.batch)]
    rep = cop_p.rt.report()

    identical = all(torch.equal(a, b) for a, b in zip(out_s, out_p))
    assert identical, "schedulers disagree — bit-identical contract broken"
    ref = reference_images(prog, device=device)
    assert all(torch.equal(out_p[i], ref[f"out{i}"])
               for i in range(args.batch)), "schedulers disagree with oracle"
    legs = "serial == pipelined == plain oracle"
    if device.type == "cuda":
        from repro_torch.core.engine import ArcaneEngine
        engine = ArcaneEngine("cuda")
        for i in range(args.batch):
            x, f = conv_inputs(prog, f"img{i}", "filt", device)
            if not torch.equal(engine.conv_layer(x, f)[0],
                               run_p.gather(f"feat{i}")):
                raise SystemExit(f"feat{i}: the convlayer.cu kernel "
                                 f"disagrees with the simulator")
        legs += " (feature maps == convlayer.cu)"

    print(f"kernels run: {rep.kernels_run}  (batch of {args.batch}: "
          f"conv layer + GEMM head each)")
    print(f"serial C-RT total:      {serial_cycles:>9} cycles")
    print(f"pipelined makespan:     {rep.makespan:>9} cycles")
    print(f"concurrency speedup:    {rep.concurrency_speedup:>9.2f}x")
    busiest = sorted(((v, k) for k, v in rep.utilization.items()),
                     reverse=True)[:4]
    print("busiest resources: " + "  ".join(
        f"{name}={util:.0%}" for util, name in busiest))

    # Where did the cycles go? Per-kernel stall attribution (every latency
    # cycle binned into one wait cause; busy + stalls == latency) and the
    # critical path that explains the makespan end to end.
    mrep = cop_p.rt.metrics_report()
    if not mrep["enabled"]:
        print("(metrics disabled by this config — no stall/critical-path "
              "breakdown)")
    else:
        assert mrep["conservation_ok"], "stall-cycle conservation violated"
        print("\nper-kernel stall breakdown (cycles):")
        for name, agg in sorted(mrep["kernels"].items()):
            stalls = "  ".join(f"{b}={c}"
                               for b, c in agg["stalls"].items() if c)
            print(f"  {name:<12} x{agg['count']}  busy={agg['busy']}  "
                  f"latency={agg['latency']}  {stalls}")
        cp = mrep["critical_path"]
        assert cp["covers_makespan"] and cp["total"] == rep.makespan
        print(f"\ncritical path ({cp['cp_cycles']} busy + {cp['idle_cycles']} "
              f"idle = {cp['total']} cycles, the whole makespan):")
        for res, d in list(cp["by_resource"].items())[:3]:
            print(f"  {res:<16} {d['cycles']:>8} cycles  "
                  f"({d['fraction']:.0%} of makespan)")
        print("top-3 critical-path segments:")
        for seg in cp["top_segments"][:3]:
            print(f"  [{seg['start']:>7}, {seg['end']:>7})  "
                  f"{seg['resource']:<16} {seg['phase']:<10} {seg['name']}  "
                  f"({seg['cycles']} cycles)")

    path = cop_p.rt.tracer.dump(args.trace)
    print(f"\n{legs} ✓   chrome trace -> {path}")
    print("(the trace now carries counter tracks — AT free slots, per-VPU "
          "occupancy — and flow arrows from DMA tiles to the compute pieces "
          "they gate)")


if __name__ == "__main__":
    main()
