"""The paper's CNN layer on one device: one fused xmk4 conv layer against the
same work op by op (counterpart of the kernel leg of
``examples/arcane_cnn.py`` and of ``benchmarks/run.py: _fused_vs_unfused``).

Usage (on a machine with an NVIDIA H100; the kernels build at first use)::

    PYTHONPATH=src python -m repro_torch.launch.cnn --size 256 --k 3 --dtype int8

- fused leg: one ``ArcaneEngine.conv_layer`` (the conv_layer kernel);
- unfused leg: a plain-PyTorch shifted-MAC convolution in the accumulator
  dtype (baseline code outside any kernel, as the jnp loop of
  ``_fused_vs_unfused``), then ``engine.maxpool`` on each of the F maps,
  one ``engine.leakyrelu`` on the stack, then the cast to the input dtype.

The legs must agree exactly for integers, and within ``FLOAT_TOL`` for
floats (the convolution sums in another order). Each leg's time is the
median of ``--reps`` runs (CUDA events on the card, the host clock on the
CPU). ``--device cpu`` runs the kernels' plain versions on the CPU. The
inputs are drawn on the device from ``--seed``: x (3, size, width) and f
(filters, 3, k, k), integers in [-8, 8) and [-4, 4), floats normal.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch import resolve_device
from repro_torch.core.engine import ArcaneEngine
from repro_torch.kernels.common import acc_dtype, is_integer
from repro_torch.kernels.convlayer.kernel import conv_layer_cuda
from repro_torch.kernels.leakyrelu.kernel import leakyrelu_cuda
from repro_torch.kernels.maxpool.kernel import maxpool_cuda

DTYPES = {"int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
          "float32": torch.float32, "bfloat16": torch.bfloat16}
WRAPPERS = (conv_layer_cuda, maxpool_cuda, leakyrelu_cuda)
# (atol, rtol) of max |fused - unfused| <= atol + rtol * max |unfused|: f32
# sums of C*K*K terms in two orders; bf16 adds one bf16 ulp of the output.
FLOAT_TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (1e-5, 2.0**-7)}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256, help="H (and W) of x")
    ap.add_argument("--width", type=int, default=None,
                    help="W of x, if it differs from H")
    ap.add_argument("--k", type=int, default=3, help="filter height = width")
    ap.add_argument("--filters", type=int, default=1)
    ap.add_argument("--dtype", default="int8", choices=sorted(DTYPES))
    ap.add_argument("--slope", type=float, default=0.0,
                    help="LeakyReLU slope (0.0: the paper's ReLU)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="auto", choices=("auto", "cuda"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def make_inputs(args: argparse.Namespace, device: torch.device):
    dt = DTYPES[args.dtype]
    gen = torch.Generator(device=device).manual_seed(args.seed)
    xs = (3, args.size, args.width or args.size)
    fs = (args.filters, 3, args.k, args.k)
    if is_integer(dt):
        x = torch.randint(-8, 8, xs, generator=gen, device=device, dtype=dt)
        f = torch.randint(-4, 4, fs, generator=gen, device=device, dtype=dt)
    else:
        x = torch.randn(xs, generator=gen, device=device).to(dt)
        f = torch.randn(fs, generator=gen, device=device).to(dt)
    return x, f


def conv_plain(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Valid convolution as shifted MACs in the accumulator dtype (int32
    wraps), plain PyTorch: (C, H, W) * (F, C, KH, KW) → (F, H', W')."""
    acc = acc_dtype(x.dtype)
    cch, h, w = x.shape
    nf, _, kh, kw = f.shape
    ch, cw = h - kh + 1, w - kw + 1
    xl, fl = x.to(acc), f.to(acc)
    y = torch.zeros((nf, ch, cw), dtype=acc, device=x.device)
    for c in range(cch):
        for di in range(kh):
            for dj in range(kw):
                y += fl[:, c, di, dj, None, None] * xl[c, di:di + ch, dj:dj + cw]
    return y


def fused(engine: ArcaneEngine, x, f, slope: float) -> torch.Tensor:
    return engine.conv_layer(x, f, negative_slope=slope)


def unfused(engine: ArcaneEngine, x, f, slope: float) -> torch.Tensor:
    y = conv_plain(x, f)
    pooled = torch.stack([engine.maxpool(y[i]) for i in range(y.shape[0])])
    return engine.leakyrelu(pooled, negative_slope=slope).to(x.dtype)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def agree(out: torch.Tensor, ref: torch.Tensor) -> bool:
    """Exact for integers; within FLOAT_TOL for floats (NaN where NaN)."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        return False
    if is_integer(out.dtype):
        return bool(torch.equal(out, ref))
    atol, rtol = FLOAT_TOL[out.dtype]
    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(out), nan):
        return False
    a, b = out[~nan].double(), ref[~nan].double()
    if a.numel() == 0:
        return True
    return float((a - b).abs().max()) <= atol + rtol * float(b.abs().max())


def launches() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}


def time_ms(fn, device: torch.device, reps: int, warmup: int = 2) -> float:
    """Median time of one call: CUDA events on the card, else the host clock."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(args: argparse.Namespace) -> dict:
    """Both legs once (checked, launches counted), then timed. Raises if the
    legs disagree."""
    device = resolve_device(args.device)
    engine = ArcaneEngine(args.backend)
    x, f = make_inputs(args, device)
    before = launches()
    a = fused(engine, x, f, args.slope)
    b = unfused(engine, x, f, args.slope)
    counts = {k: v - before[k] for k, v in launches().items()}
    if not agree(a, b):
        raise AssertionError(f"cnn: fused and unfused legs disagree, max "
                             f"|diff| {max_err(a, b)}")
    warmup = 2
    fused_ms = time_ms(lambda: fused(engine, x, f, args.slope), device,
                       args.reps, warmup)
    unfused_ms = time_ms(lambda: unfused(engine, x, f, args.slope), device,
                         args.reps, warmup)
    return {"x": x, "f": f, "fused": a, "unfused": b,
            "max_abs_diff": max_err(a, b), "launches": counts,
            "passes": 1 + warmup + args.reps,
            "fused_ms": fused_ms, "unfused_ms": unfused_ms,
            "unfused_over_fused": unfused_ms / fused_ms,
            "clock": "cuda_events" if device.type == "cuda" else "host",
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")}


def main(argv=None) -> dict:
    args = parse_args(argv)
    out = run(args)
    print(f"cnn: 3x{args.size}x{args.width or args.size} {args.dtype} k={args.k} "
          f"F={args.filters} slope={args.slope} on {out['device']}: "
          f"fused == unfused (max |diff| {out['max_abs_diff']}); fused "
          f"{out['fused_ms']:.4f} ms, unfused {out['unfused_ms']:.4f} ms "
          f"({out['clock']}, median of {args.reps}), unfused/fused "
          f"{out['unfused_over_fused']:.2f}; launches {out['launches']}")
    return out


if __name__ == "__main__":
    main()
