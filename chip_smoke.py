#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --cnn-kernels-only --json PATH   # phases 1-2, CNN kernels

Phases:
  1. device: needs ``torch.cuda.is_available()``; prints the card's name and
     power limit (nvidia-smi) and builds the six CUDA kernels from
     ``src/repro_torch/csrc`` with nvcc (one process per source, in
     parallel).
  2. kernels: the time of an empty kernel between the timer's events (the
     floor of every time below), then each kernel against its plain
     PyTorch version on the card:
     gemm and the attention kernels in bf16 and f32 at the full-width
     shapes of gemma2-9b (plus stablelm-3b and qwen2.5-32b shapes, and
     decode attention over a long qwen2.5 cache: B=8, S=8192, every row
     full, bf16; granite-moe-1b's decode attention and its tied unembed,
     table.T at the odd N = 49155; rwkv6-1.6b's decay LoRA (N or K = 64)
     and unembed (N = 65536); jamba's Mamba x_proj (N = 544) and dt_proj
     (A a view of x_proj's output, rows 544 apart) at full width, and
     jamba-smoke's (N = 12; A rows of 24 bytes); int8 also beside
     torch._int_mm; MLA's absorbed decode attention at
     minicpm3-4b's G = 40, D = 288 and minicpm3-smoke's G = 4, D = 24, each
     row naming decode_variant's pick, narrow or wide; internvl2-1b's
     unembed (table.T at the odd N = 151655), its q and k with biases,
     its prompt's causal attention over 256 + 512 rows at G = 7 and its
     decode attention; whisper-large-v3's classic MLP with biases at M = 4
     and 1500, its cross k over 1500 frames, its encoder's bidirectional
     attention over 1500 frames, its cross-attention in a prompt (Sq = 4
     and 224 over 1500 keys, non-causal) and in a step (B = 4 over the
     1500-row cross cache)), the
     bf16 prefill GEMM also at ragged M = 16, 100, 513 and flash attention
     also at a ragged S = 100; each row names the variant the wrapper picks
     (gemm: gemv / wgmma / wmma / fma; flash: mma / simt), and a bf16 row
     on a tensor-core variant also holds the earlier design (wmma, simt)
     to the plain version on the same inputs, at the same tolerance, and
     times it; gemma2's unembed (table.T) also at M = 512, where a
     sequence's logits take wmma;
     conv_layer, maxpool and leakyrelu in int8, int16, int32, f32 and bf16
     at the paper's Fig. 4 shapes (3x256x256, k 3/5/7), ragged edges, and a
     first CNN layer's width (3x226x226, 64 filters; in bf16 and int8 also
     1 to 32 filters); each conv row names the variant conv_variant picks
     (mma / simt), and a bf16 or int8 row also holds the other variant to
     the plain version and times it; maxpool also on the CNN leg's 224x224
     f32 maps and on maps of 1 to 67 MB (8192x8192 int8, 4096x4096 f32 and
     bf16, 4095x4093 bf16 with 3x3 windows at stride 2, 4096x4096 bf16 at
     3x3 stride 1), held bit for bit (integer views), each row naming
     maxpool_plan's variant (vector / band / scalar) and also holding and
     timing every other variant that takes the map. Per case: max
     |kernel - plain| beside its
     tolerance, the kernel's time (CUDA events, median, L2 flushed before
     each launch), the least time the card could take (bytes at 3.35 TB/s
     or operations at the dtype's peak, whichever is larger), the plain
     version's time, and one PyTorch library call's time where one computes
     the same function (never called by the port); a `timer:` line gives
     the share of the memory rate copies of 42 to 128 MiB moved reach under
     the same timer. The decode-step
     kernels (decode attention, the split-K GEMV at M <= 8) also run twice
     on the same inputs and must give the same bits; each row prints its
     bytes over its time as a share of the 3.35 TB/s memory rate. Decode
     attention is held per output row to one bf16 ulp of the row's largest
     value (f32: 1e-5 of it), and on the long cache the same check must
     reject two planted faults: the last quarter of the keys (the last
     split) dropped, and the score scale 10% off. Then a `host:` line per
     CNN wrapper: its host us a call (least of 5 medians of 200 calls, the
     card kept busy), split into checks, allocation, stream lookup, the
     ctypes call and the rest, beside PyTorch's own empty launch.
  3. serve: gemma2-9b, granite-moe-1b-a400m, minicpm3-4b and rwkv6-1.6b
     in turn, each at full width (bf16, random weights drawn on the card
     from seed 0), then jamba-smoke, through the port's launcher, each
     freed before the next: 4 slots, max_len 1024 (jamba-smoke 128), 6
     requests of 16 new tokens and 16-512 prompt tokens (rwkv6 from
     {16, 32, ..., 512}, jamba-smoke from {4, 9, 16, 32, 48, 64}: the
     lengths the recurrent scans' chunks take). The kernels' launch counts
     are zeroed just before each run and read just after, and must be
     exactly (``expected_launches``): per prompt and per decode step each
     layer's engine GEMMs by its kind (``layer_gemms``: gemma2 7 a layer,
     granite 4 (its MoE FFN runs no engine GEMM), minicpm3 7 a step and 10
     a prompt (mla_prefill projects twice, as the reference does), rwkv6
     10, jamba-smoke's Mamba layers 4 a step and 5 a prompt (in_proj again
     for the conv state), its attention layer 4, dense FFNs 3, MoE 0) plus
     the unembed, each on gemm_variant's pick for its shapes (every
     full-width prompt projection on wgmma, every decode GEMM on gemv;
     jamba-smoke's x_proj and dt_proj on wmma past 8 rows); one flash
     launch per attention layer and prompt, one decode attention launch
     per attention layer and step (none for rwkv6), on flash_variant's and
     decode_variant's picks. Then one request's prefill logits and first
     decode-step logits through ArcaneEngine("cuda") are held against
     ArcaneEngine("ref") on the card (uncapped models also on an f32 copy
     of the weights); rwkv6's bf16 ones against the library engine
     (cuBLAS's bf16 GEMM in the kernels' place; its entry in SERVE_MODELS
     says why), where the same check must reject three planted GEMM faults
     (GEMM_FAULTS), and every GEMM of its prefill and first step also runs
     on the model's own activations through the kernel, cuBLAS and the
     plain version (``gemm_on_activations``: bits that differ, ulps, the
     direction of the kernel's rounding). torch.profiler runs over one
     512-token prefill and over a few decode steps, each window opened by
     64 primer kernels, and must see a device event for every launch of
     the serving kernels in it: device busy time, idle share, time by
     kernel; for rwkv6 also the share of a 512-token prefill's host clock
     that the plain wkv recurrence takes. Then one Mamba block of
     jamba-1.5-large-398b at full width (d 8192, d_inner 16384; random
     bf16 weights): a prefill of 4 x 512 tokens and 8 decode steps through
     ArcaneEngine("cuda"), ("ref") and the planted faults' engines;
     outputs and conv and SSM states within limits set between the sound
     kernels' reading and the faults', every fault outside them; GEMM
     launches exact by variant (8 wgmma, 56 gemv).
  3b. serve_embeds: internvl2-1b and whisper-large-v3 at full width (bf16,
     random weights drawn on the card from seed 0), each freed before the
     next, through LM.prefill and LM.decode_step (the port's ServeSession,
     as the reference's, takes token prompts only): four sequences, each
     prefilled on its own into its slot's view of one 4-slot cache, then 16
     decode steps for all four at their own positions (EMBED_MODELS:
     internvl2 behind 256 vision embeddings, text prompts of 16, 64, 200
     and 512 tokens, max_len 1024; whisper over 1500 audio frames, text
     prompts of 4, 16, 64 and 224, max_len 448; the stub frontends'
     embeddings standard normal from the same seed). Launch counts exact
     per kernel and variant (``expected_launches``: the vision prefix in
     every prompt's M; whisper's encoder layers, the decoder's cross k and
     v over the frames in a prompt and q and o in a step, one flash launch
     for each encoder layer and two for each decoder layer a prompt, two
     decode attention launches for each decoder layer a step); decode-step
     and prefill ms (host clock; whisper's encoder alone beside them);
     cuda vs ref logits in bf16 and on an f32 copy, as phase 3; the
     profiler over the longest prompt's prefill and three decode steps;
     peak memory; the weights' elements beside ``param_count()``.
  4. cnn: the paper's CNN layer through ``repro_torch.launch.cnn`` (3x256x256
     int8 with k 3 and 7, int32 with k 3; 3x226x226 bf16 with 64 filters):
     the fused leg (one conv_layer launch) against the unfused leg (plain
     conv, F maxpool launches, one leakyrelu launch) and against the plain
     conv_layer on the card, with each leg's time and their ratio. The
     counts are zeroed before the phase and must come out exactly as
     counted, conv_layer's and maxpool's per variant too (every launch on
     conv_variant's and maxpool_plan's pick: mma for the bf16 64-filter
     run, simt for int32; vector for the 224x224 f32 maps, scalar for the
     254x254 and 250x250 int32 ones). Then
     torch.profiler over each leg of the Listing 1 run and of the 64-filter
     run: the card's busy time per pass and its idle share, in a window
     that opens with 64 primer kernels and is padded by 50 ms on both sides;
     the profiler must see a device event for every launch of the port's
     CNN kernels in it or the run fails. This phase runs before phase 3:
     after the five serving runs' profiles a window lost the device
     records of its first 13 launches (on the H100, torch 2.11).
  4b. sim (after phase 4): the port's serial simulator
     (``repro_torch.core``: bridge → C-RT → cache/VPUs) with its main
     memory and cache lines as tensors on the card (checked: no
     fallback): Listing 1 at 64x64, k 3 (``examples/arcane_cnn.py``'s
     program and geometry, 4 VPUs of 64 vregs of 1 KiB, 8 lanes) in
     widths w, h and b, and one seeded program of 40 kernels
     (``mixed_program``: gemm with a beta-accumulate, leakyrelu,
     maxpool, conv2d, conv_layer; strided views, aliased destinations)
     on 4 VPUs, each run once warm, then timed from the issue to the
     flushed images on the host, and the same runs on the host CPU in
     this process. Each card run's flushed images must equal the CPU
     run's byte for byte and its PhaseStats cycle fields the CPU run's
     (the CPU tests hold the CPU path to the JAX package's simulator).
     Listing 1's R must equal ArcaneEngine("cuda").conv_layer on the same
     A and F (convlayer.cu; conv_layer_cuda's launches are zeroed before
     the phase and must come out exactly one a width, on conv_variant's
     pick, every other kernel none) and the plain conv_layer; a
     disagreement fails with its place and both values. Two planted
     faults the image check must reject: one byte of the card's flushed
     image flipped, and a leakyrelu body that scales in float32 on int32
     inputs near 2^30 (``leaky_f32_library``, beside the sound body's run,
     which must pass). ``sim:`` lines: cycles, phase shares, modeled
     speedup, wall seconds and kernels a second on the card and on the
     host CPU, with the card's name and power limit.
  4c. sim_pipelined (after phase 4b): the port's pipelined simulator
     (``repro_torch.sim``: the event-driven C-RT over the serial runtime's
     steps), every runtime built by ``SimConfig.make_runtime(...,
     device=)`` with memory and lines on the card (checked: no fallback),
     each run once warm, then timed from the issue to the flushed images on
     the host, beside the same run on the host CPU in this process (images
     byte for byte; PhaseStats, PipelineReport and every resource's
     intervals equal): (1) the paper's Fig. 4 anchors, ``lower_cnn`` of a
     3x256x256 int8 image with k 3 and 7 (9 strips) on arcane-8vpu and
     arcane-default through both schedulers, each run's ``l0_out0`` against
     ArcaneEngine("cuda").conv_layer on the program's x0 and f0
     (convlayer.cu) and the plain conv_layer (``first_diff`` on a
     mismatch); serial cycles, makespan, concurrency speedup and the
     modeled speedup over the scalar core; (2) ``examples/pipelined_cnn``'s
     program (batch 4) on both configs: serial == pipelined ==
     ``reference_images`` on the card, each ``feat{i}`` against
     conv_layer_cuda and the plain conv_layer, the Chrome trace dumped under
     build/chip_smoke equal to the CPU run's, no resource's intervals
     overlapping; (3) ``ServingDriver`` on arcane-default with
     serving-poisson's values (``SERVING_POISSON``) on both schedulers, the
     run's dict equal to the CPU's; TTFT and latency p50/p99 in cycles,
     kernels run, wall seconds and kernels a second. conv_layer_cuda's
     launches are zeroed before the phase and must come out exactly
     (``pipe_conv_launches``: 4 in (1), 8 in (2)) on conv_variant's pick,
     every other kernel none. Two planted faults must be rejected: a
     flipped byte of a card image in (1), one request's TTFT one cycle
     later in (3)'s dict. The arcane-8vpu event loops of (1) run once more
     under ``torch.cuda.set_sync_debug_mode("warn")``: the synchronising
     calls made from the port's code are counted (a reading, not a gate)
     and every reported call is printed with where it was made.
  5. train (after phase 3b): granite-moe-1b-a400m at full width (bf16
     params, an f32 master, seed 0, ArcaneEngine("ref") under autograd:
     the kernels have no backward), through ``repro_torch.launch.train``:
     (a) 6 steps of 8 x 512 tokens in 2 microbatches at lr 3e-4 and a
     checkpoint: each step's loss, grad norm, lr and ms, tokens/s over
     steps 2-6, peak memory, the model FLOPs' shares of the bf16 and f32
     peaks; fails on a value that is not finite, a last loss not below the
     first or a missing checkpoint; (b) the first step's loss, grad norm
     and grads leaf by leaf (each block leaf layer by layer) against the
     same step on an f32 copy of the weights, and its microbatch sum
     against the f64 sum of the very microbatch grads it summed, within
     GRAD_LIMITS (each part's gain by the limit of its kind), which must
     reject the six planted TRAIN_FAULTS (the aux loss left out; one
     layer's grads, the embedding's grad, one layer's ln1 grad x1.01; one
     layer's router grad x1.03; the microbatch sum in bf16), and the same
     step with the embedding's index sums in f32 (its repeated tokens'
     rows within the gain limit of the rest); then torch.profiler over one
     step, its device time by the op that launched it, forward and
     backward (``labelled_train_ops``); (c) at 4 layers, 4 steps straight
     through against 2 steps stopped by SIGTERM (a checkpoint at the step
     boundary), then a resumed run of 2 more: each step on the stream's
     batch of its step and the losses within RESUME_RTOL; (d) that
     checkpoint restored into a fresh LM (bit for bit the trained params)
     and served through ArcaneEngine("cuda"): 4 requests of 16 new
     tokens, launch counts exact, cuda vs ref logits under phase 3's
     limits.
  5b. multi-device (after phase 5): the multi-device layer on a world of
     one NCCL rank (a FileStore under build/; no fallback: a failed NCCL
     init fails the run) and its (1, 1) mesh, granite-moe-1b-a400m at full
     width as phase 5: (a) 2 steps of the sharded train step (params
     under param_pspecs, AdamW state under zero_pspecs, grad_shardings=)
     against 2 plain steps from the same weights, loss, grad norm and
     every param leaf bit for bit, each step's ms; (b) 6 steps of
     make_compressed_dp_step with compress=True and False: ms, the
     all-reduce's share, step 1's quantization readings per leaf (mean +
     residual within one f32 ulp of the scale of the f32 grad, |residual|
     within half a level and 2^-16) with two planted payload faults the
     check must reject, the last losses within the reference's 0.25;
     (c) pipeline_forward with one stage against the stage; (d) the
     compressed run's params saved, restored with shardings= and served
     through the kernels (counts exact, logits as phase 3); peak memory.
  6. result: a JSON line of the kernels (with each one's launches per
     variant, conv_layer's phase 4b and 4c launches included, and, for the
     serving kernels, per model, phase 3b's models
     and phases 5's and 5b's served models included; gemm's also in the Mamba
     block's run; ``more_cases``:
     decode attention's MLA, whisper and internvl2 rows, flash's whisper
     and internvl2 rows, gemm's granite unembed, rwkv6, jamba, int8,
     internvl2 and whisper rows), then the device line, last. A
     ``phase:`` line after each phase gives its seconds.

Any failure exits non-zero before the last line. Details go to
build/chip_smoke/chip_smoke.json (or --json), the nvcc report to
build/chip_smoke/chip_smoke_build.txt. ``--cnn-kernels-only`` runs phases
1-2 for the three CNN kernels (with the host: lines) and prints no result
line; it also runs against an earlier tree's wrappers (without variants),
to time two trees' kernels in one call. ``--decode-host [ARCH]`` only
times the serving decode step's host clock (``decode_host:`` line;
gemma2-9b unless an arch id is named), to compare two trees in turns, and
prints no result line.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK = {"bfloat16": 989e12,          # dense tensor-core bf16
        "float32": 67e12,            # f32 outside the tensor cores (no TF32)
        "int8": 1979e12,             # dense tensor-core int8
        "int16": 33.5e12,            # int32 CUDA cores: 64 lanes an SM beside
        "int32": 33.5e12}            # 128 f32 lanes, half the f32 rate
FLUSH_BYTES = 128 * 2**20            # > the 50 MB L2
SPIN_CYCLES = 10_000_000             # about 5 ms at the H100's clock


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


# ------------------------------------------------------------------ timing
class Timer:
    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int = 10, warmup: int = 2) -> float:
        """Median device time of one call (CUDA events), with a cold L2 each
        time. A spin kernel queued ahead keeps the card busy while the host
        enqueues the call, so the host's Python time is not counted."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def copy_calibration(torch, timer) -> dict:
    """Device-to-device copies of 21, 42 and 64 MiB (twice that moved) under
    the timer: the share of the memory rate a plain copy of about a large
    maxpool row's bytes reaches, beside which that row's mem_rate_share
    reads (the flush leaves dirty lines in L2 that the timed call writes
    back, which costs a smaller copy a larger share)."""
    out = {}
    for mib in (21, 42, 64):
        x = torch.ones(mib * 2**18, dtype=torch.float32, device="cuda")
        y = torch.empty_like(x)
        ms = timer.ms(lambda: y.copy_(x))
        out[f"{2 * mib}MiB"] = {"ms": ms, "mem_rate_share":
                                2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3 / ms}
        del x, y
    print("timer: a copy moving " + ", ".join(
        f"{k} takes {v['ms']:.4f} ms (share {v['mem_rate_share']:.3f})"
        for k, v in out.items()), flush=True)
    return out


def bound_ms(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / PEAK[dtype_name] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------- phase 2
def gemm_cases(torch):
    """(name, dtype, M, K, N, kind): kind 'w' weight, 't' table.T, 'bias',
    'a<R>' a weight with A the first K columns of an (M, R) tensor."""
    g2 = [("q", 3584, 4096), ("kv", 3584, 2048), ("gate_up", 3584, 14336),
          ("o", 4096, 3584), ("down", 14336, 3584)]
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        for m in (1, 4, 512):
            for name, k, n in g2:
                cases.append((f"gemma2 {name}", dt, m, k, n, "w"))
        for m in (1, 4):
            cases.append(("gemma2 unembed", dt, m, 3584, 256000, "t"))
            # granite-moe-1b's tied unembed: the first odd N on the served
            # path (f32 output rows of 196,620 bytes)
            cases.append(("granite unembed", dt, m, 1024, 49155, "t"))
        for m in (1, 4, 512):
            cases.append(("stablelm up", dt, m, 2560, 6912, "w"))
            cases.append(("qwen2.5 k+bias", dt, m, 5120, 1024, "bias"))
    # LM.forward's unembed of a whole sequence: table.T at M > 8 takes wmma
    cases.append(("gemma2 unembed", torch.bfloat16, 512, 3584, 256000, "t"))
    for m in (16, 100, 513):      # ragged prompt lengths: TMA zero-fills the edges
        for name, k, n in g2:
            if name in ("q", "gate_up"):
                cases.append((f"gemma2 {name}", torch.bfloat16, m, k, n, "w"))
    for m in (4, 512):
        cases.append(("int8", torch.int8, m, 1024, 1024, "w"))
    # the recurrent families' shapes: rwkv6-1.6b's decay LoRA (N or K one
    # 64-wide tile) and its unembed; jamba's Mamba at full width (x_proj,
    # and dt_proj reading the first 512 columns of x_proj's output in
    # place, rows 544 apart) at the block's M = 4 and 4 x 512; jamba-smoke's
    # x_proj (N = 12) and dt_proj (K = 4, rows 12 apart: 24 bytes, no
    # 16-byte rows), decode and prompt
    for m in (4, 512):
        cases.append(("rwkv6 wA", torch.bfloat16, m, 2048, 64, "w"))
        cases.append(("rwkv6 wB", torch.bfloat16, m, 64, 2048, "w"))
    for m in (1, 4):
        cases.append(("rwkv6 unembed", torch.bfloat16, m, 2048, 65536, "t"))
    for m in (4, 2048):
        cases.append(("jamba x_proj", torch.bfloat16, m, 16384, 544, "w"))
        cases.append(("jamba dt_proj", torch.bfloat16, m, 512, 16384, "a544"))
    for m in (4, 16, 64):
        cases.append(("jamba-smoke x_proj", torch.bfloat16, m, 128, 12, "w"))
        cases.append(("jamba-smoke dt_proj", torch.bfloat16, m, 4, 128, "a12"))
    # inputs other than tokens: internvl2-1b's tied unembed (table.T at the
    # odd N = 151655: f32 output rows of 606,620 bytes) and its q and k
    # projections with their biases (a broadcast C); whisper-large-v3's
    # classic MLP with biases and its cross-attention's k over the 1500
    # encoder frames of a 30 s window
    for m in (1, 4):
        cases.append(("internvl2 unembed", torch.bfloat16, m, 896, 151655, "t"))
    for m in (4, 512):
        cases.append(("internvl2 q+bias", torch.bfloat16, m, 896, 896, "bias"))
        cases.append(("internvl2 k+bias", torch.bfloat16, m, 896, 128, "bias"))
    for m in (4, 1500):
        cases.append(("whisper up+bias", torch.bfloat16, m, 1280, 5120, "bias"))
        cases.append(("whisper down+bias", torch.bfloat16, m, 5120, 1280, "bias"))
    cases.append(("whisper cross k", torch.bfloat16, 1500, 1280, 1280, "w"))
    return cases


def check_close(err: float, ref_absmax: float, atol: float, rtol: float) -> bool:
    return err <= atol + rtol * ref_absmax


GEMM_BF16_TOL = (1e-3, 1.6e-2)        # atol, rtol: two bf16 ulps of the result


def run_gemm(torch, timer, gen, rows):
    from repro_torch.kernels.gemm.kernel import _gemm, gemm_cuda, gemm_variant
    from repro_torch.kernels.gemm.ref import gemm_ref
    for name, dt, m, k, n, kind in gemm_cases(torch):
        if dt == torch.int8:
            a = torch.randint(-8, 8, (m, k), device="cuda", dtype=torch.int8, generator=gen)
            b = torch.randint(-8, 8, (k, n), device="cuda", dtype=torch.int8, generator=gen)
        else:
            width = int(kind[1:]) if kind.startswith("a") else k
            a = torch.randn((m, width), device="cuda", generator=gen).to(dt)[:, :k]
            if kind == "t":
                b = (torch.randn((n, k), device="cuda", generator=gen) / math.sqrt(k)).to(dt).T
            else:
                b = (torch.randn((k, n), device="cuda", generator=gen) / math.sqrt(k)).to(dt)
        c = None
        if kind == "bias":
            c = torch.randn((n,), device="cuda", generator=gen).to(dt).expand(m, n)
        out_dtype = torch.float32 if kind == "t" else None
        kw = dict(alpha=1.0, beta=1.0 if c is not None else 0.0, out_dtype=out_dtype)
        out = gemm_cuda(a, b, c, **kw)
        ref = gemm_ref(a, b, c, **kw)
        variant = gemm_variant(a, b)
        # where wgmma runs, the earlier WMMA kernel is held on the same inputs
        earlier = _gemm(a, b, c, kw["alpha"], kw["beta"], out_dtype, "wmma") \
            if variant == "wgmma" else None
        # the split-K GEMV adds its splits in a fixed order: same bits again
        same = torch.equal(out, gemm_cuda(a, b, c, **kw)) if variant == "gemv" else None
        torch.cuda.synchronize()
        err = float((out.double() - ref.double()).abs().max())
        earlier_err = None if earlier is None else \
            float((earlier.double() - ref.double()).abs().max())
        del earlier
        absmax = float(ref.double().abs().max())
        if dt == torch.int8:
            atol, rtol = 0.0, 0.0
        elif out.dtype == torch.bfloat16:
            atol, rtol = GEMM_BF16_TOL
        else:
            atol, rtol = 2e-3, 1e-5        # f32 sums of K terms in another order
        ok = check_close(err, absmax, atol, rtol) and same is not False and (
            earlier_err is None or check_close(earlier_err, absmax, atol, rtol))
        ms = timer.ms(lambda: gemm_cuda(a, b, c, **kw))
        wmma = None if earlier_err is None else timer.ms(
            lambda: _gemm(a, b, c, kw["alpha"], kw["beta"], out_dtype, "wmma"))
        plain = timer.ms(lambda: gemm_ref(a, b, c, **kw), reps=5)
        lib = None
        if dt != torch.int8:
            if c is not None:
                lib = timer.ms(lambda: torch.addmm(c, a, b))
            else:
                lib = timer.ms(lambda: torch.matmul(a, b))
        elif m > 16 and k % 8 == 0 and n % 8 == 0:
            # int8 x int8 -> int32, the function at alpha 1, beta 0
            if not torch.equal(torch._int_mm(a, b), out):
                ok = False
            lib = timer.ms(lambda: torch._int_mm(a, b))
        isz = a.element_size()
        nbytes = (m * k + k * n) * isz + out.numel() * out.element_size() \
            + (n * c.element_size() if c is not None else 0)
        bms, by = bound_ms(nbytes, 2.0 * m * k * n, str(dt).split(".")[-1])
        rows.append(dict(kernel="gemm", case=f"{name} M={m} K={k} N={n}",
                         dtype=str(dt).split(".")[-1], variant=variant,
                         max_abs_err=err, ref_absmax=absmax, atol=atol,
                         rtol=rtol, ok=ok, deterministic=same, ms=ms,
                         earlier_ms=wmma, earlier_max_abs_err=earlier_err,
                         plain_ms=plain, library_ms=lib, bound_ms=bms,
                         bound_by=by, bytes=nbytes))


def sdpa(q, k, v, **kw):
    """F.scaled_dot_product_attention with GQA, the yardstick call."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


# decode attention, per output row (b, h, g): |out - ref| <= atol + rtol *
# max|ref| over the row's D values. Kernel and plain version sum in f32 in
# another order and round once to the output's dtype, so in bf16 they may
# land one ulp apart, at most 2^-7 of the row's largest value; in f32 the
# orders differ by about 1e-6 of it. Every element is also held to the
# former absolute limit (2e-2 bf16, 2e-4 f32).
DECODE_TOL = {"bfloat16": (1e-5, 2.0 ** -7, 2e-2), "float32": (1e-5, 1e-5, 2e-4)}


def row_limit_ratio(out, ref, atol: float, rtol: float) -> float:
    """The largest ratio over the output rows (the last axis) of
    max |out - ref| to atol + rtol * max |ref|: at most 1 where they agree."""
    o, r = out.double(), ref.double()
    return float(((o - r).abs().amax(-1) / (atol + rtol * r.abs().amax(-1))).max())


# decode attention's cases: (name, B, Hq, Hkv, D, S, softcap, window,
# lengths, scale, faults); RING the serving phase's lengths at max_len
# 1024; ``faults`` marks the case that also runs the planted faults
RING = [1024, 517, 100, 1]
MLA_SCALE = 1.0 / math.sqrt(96)  # minicpm3's qk head: 64 + 32
DECODE_CASES = [
    ("gemma2", 4, 16, 8, 256, 1024, 50.0, None, RING, None, False),
    ("gemma2", 4, 16, 8, 256, 1024, 50.0, 4096, RING, None, False),
    ("gemma2", 4, 16, 8, 256, 1024, 50.0, 300, RING, None, False),
    ("stablelm", 4, 32, 32, 80, 1024, None, None, RING, None, False),
    ("qwen2.5", 4, 40, 8, 128, 1024, None, None, RING, None, False),
    # a long cache, every row full: 268 MB of K and V in bf16
    ("qwen2.5", 8, 40, 8, 128, 8192, None, None, [8192] * 8, None, True),
    # granite-moe-1b: 16 query heads on 8 KV heads of 64
    ("granite", 4, 16, 8, 64, 1024, None, None, RING, None, False),
    # MLA's absorbed decode: one latent KV head for all query
    # heads, D = kv_lora_rank + rope (minicpm3-4b 256 + 32,
    # minicpm3-smoke 16 + 8), at the model's scale
    ("minicpm3 MLA", 4, 40, 1, 288, 1024, None, None, RING, MLA_SCALE, False),
    ("minicpm3-smoke MLA", 4, 4, 1, 24, 1024, None, None, RING,
     1.0 / math.sqrt(24), False),
    # whisper-large-v3's cross-attention in a decode step: the
    # cross cache of a 30 s window's 1500 frames, every row full
    ("whisper cross", 4, 20, 20, 64, 1500, None, None, [1500] * 4, None, False),
    # internvl2-1b: 14 query heads on 2 KV heads (G = 7), the
    # 256-row vision prefix in front of every sequence's text
    ("internvl2", 4, 14, 2, 64, 1024, None, None, [784, 472, 336, 288],
     None, False),
]


def run_decode(torch, timer, gen, rows):
    from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.decode_attention.kernel import decode_variant
    for dt in (torch.bfloat16, torch.float32):
        for name, b, hq, hkv, d, s, cap, win, lengths, scale, faulty in DECODE_CASES:
            if s > 1024 and dt != torch.bfloat16:
                continue            # the long caches run in bf16 only
            g = hq // hkv
            q = torch.randn((b, hkv, g, d), device="cuda", generator=gen).to(dt)
            k = torch.randn((b, hkv, s, d), device="cuda", generator=gen).to(dt)
            v = torch.randn((b, hkv, s, d), device="cuda", generator=gen).to(dt)
            ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            kw = dict(softcap=cap, window=win, scale=scale)
            out = decode_attention_cuda(q, k, v, ln, **kw)
            # the splits are merged in a fixed order: same bits again
            same = torch.equal(out, decode_attention_cuda(q, k, v, ln, **kw))
            ref = decode_attention_ref(q, k, v, ln, **kw)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            dt_name = str(dt).split(".")[-1]
            atol, rtol, abs_cap = DECODE_TOL[dt_name]
            ratio = row_limit_ratio(out, ref, atol, rtol)
            ok = ratio <= 1.0 and err <= abs_cap and same
            faults = None
            if faulty:
                # planted faults: what a kernel that dropped the last quarter
                # of the keys (the last of the 4 splits that decode_splits
                # gives this cache on 132 SMs), or scaled the scores 10% too
                # much, would return. The check above must reject both.
                lost = decode_attention_cuda(q, k, v, ln - s // 4, **kw)
                scaled = decode_attention_cuda(q, k, v, ln, **dict(kw, scale=1.1 / math.sqrt(d)))
                faults = {"last_quarter_dropped": row_limit_ratio(lost, ref, atol, rtol),
                          "scale_10pct_off": row_limit_ratio(scaled, ref, atol, rtol)}
                del lost, scaled
                ok = ok and min(faults.values()) > 1.0
            ms = timer.ms(lambda: decode_attention_cuda(q, k, v, ln, **kw))
            plain = timer.ms(lambda: decode_attention_ref(q, k, v, ln, **kw), reps=5)
            lib = None
            if cap is None and win is None:
                # one SDPA call over the same rows: a length mask, K and V
                # broadcast over the G query heads of a KV head
                qs = q.reshape(b, hq, 1, d)
                mask = (torch.arange(s, device="cuda")[None, :] < ln[:, None])[:, None, None, :]
                lib = timer.ms(lambda: sdpa(qs, k, v, attn_mask=mask, scale=scale))
            valid = sum(min(x, s) - (max(x - win, 0) if win else 0) for x in lengths)
            isz = q.element_size()
            nbytes = (2 * q.numel() + 2 * valid * hkv * d) * isz + b * 4
            bms, by = bound_ms(nbytes, 4.0 * valid * g * hkv * d, dt_name)
            rows.append(dict(kernel="decode_attention",
                             case=f"{name} B={b} Hq={hq} Hkv={hkv} D={d} S={s} "
                                  f"len={lengths} softcap={cap} window={win}",
                             dtype=dt_name, variant=decode_variant(g, d),
                             max_abs_err=err,
                             atol=atol, rtol=rtol, abs_cap=abs_cap, row_limit_ratio=ratio,
                             planted_fault_ratio=faults, ok=ok,
                             deterministic=same, ms=ms,
                             plain_ms=plain, library_ms=lib, bound_ms=bms,
                             bound_by=by, bytes=nbytes))


# flash attention's cases: (name, B, Hq, Hkv, D, Sq, Skv, causal, window,
# softcap)
FLASH_CASES = [
    ("gemma2", 1, 16, 8, 256, 512, 512, True, None, 50.0),
    ("gemma2", 1, 16, 8, 256, 4608, 4608, True, 4096, 50.0),
    ("stablelm", 1, 32, 32, 80, 512, 512, True, None, None),
    ("gemma2 Sq!=Skv", 1, 16, 8, 256, 256, 512, True, None, None),
    ("qwen2.5", 1, 40, 8, 128, 512, 512, True, None, None),
    ("stablelm", 1, 32, 32, 80, 100, 100, True, None, None),
    # whisper-large-v3's encoder over a 30 s window (bidirectional)
    # and its cross-attention in a prompt (the shortest and the
    # longest text prompt over the 1500 frames: non-causal, Sq !=
    # Skv); internvl2-1b's prompt: 256 vision rows + 512 text rows
    ("whisper encoder", 1, 20, 20, 64, 1500, 1500, False, None, None),
    ("whisper cross", 1, 20, 20, 64, 4, 1500, False, None, None),
    ("whisper cross", 1, 20, 20, 64, 224, 1500, False, None, None),
    ("internvl2 prefix", 1, 14, 2, 64, 768, 768, True, None, None),
]


def run_flash(torch, timer, gen, rows):
    from repro_torch.kernels.flash_attention.kernel import (_flash,
                                                            flash_attention_cuda,
                                                            flash_variant)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    for dt in (torch.bfloat16, torch.float32):
        for name, b, hq, hkv, d, sq, skv, causal, win, cap in FLASH_CASES:
            # transposed head views, as the model hands them over
            q = torch.randn((b, sq, hq, d), device="cuda", generator=gen).to(dt).transpose(1, 2)
            k = torch.randn((b, skv, hkv, d), device="cuda", generator=gen).to(dt).transpose(1, 2)
            v = torch.randn((b, skv, hkv, d), device="cuda", generator=gen).to(dt).transpose(1, 2)
            kw = dict(causal=causal, window=win, softcap=cap)
            out = flash_attention_cuda(q, k, v, **kw)
            ref = attention_ref(q, k, v, **kw)
            variant = flash_variant(q, k, v)
            # where mma runs, the earlier CUDA-core kernel is held on the
            # same inputs
            earlier = _flash(q, k, v, causal, win, cap, None, None, "simt") \
                if variant == "mma" else None
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            earlier_err = None if earlier is None else \
                float((earlier.float() - ref.float()).abs().max())
            del earlier
            # bf16: output rounding, plus on mma the rounding of P to bf16
            # before P V, at most 2^-9 max|v| (about 0.009 at these |v|)
            atol = 2e-2 if dt == torch.bfloat16 else 2e-4
            ok = err <= atol and (earlier_err is None or earlier_err <= atol)
            ms = timer.ms(lambda: flash_attention_cuda(q, k, v, **kw))
            simt = None if earlier_err is None else timer.ms(
                lambda: _flash(q, k, v, causal, win, cap, None, None, "simt"))
            plain = timer.ms(lambda: attention_ref(q, k, v, **kw), reps=3, warmup=1)
            lib = None
            if cap is None and win is None:
                lib = timer.ms(lambda: sdpa(q, k, v, is_causal=causal))
            rows_i = torch.arange(sq)[:, None]
            cols = torch.arange(skv)[None, :]
            vis = torch.ones((sq, skv), dtype=torch.bool)
            if causal:
                vis &= cols <= rows_i
            if win:
                vis &= cols > rows_i - win
            pairs = int(vis.sum())
            isz = q.element_size()
            nbytes = (2 * b * hq * sq * d + 2 * b * hkv * skv * d) * isz
            bms, by = bound_ms(nbytes, 4.0 * pairs * b * hq * d, str(dt).split(".")[-1])
            rows.append(dict(kernel="flash_attention",
                             case=f"{name} B={b} Hq={hq} Hkv={hkv} D={d} Sq={sq} "
                                  f"Skv={skv} causal={causal} window={win} softcap={cap}",
                             dtype=str(dt).split(".")[-1], variant=variant,
                             max_abs_err=err, atol=atol, rtol=0.0, ok=ok,
                             ms=ms, earlier_ms=simt, earlier_max_abs_err=earlier_err,
                             plain_ms=plain,
                             library_ms=lib, bound_ms=bms, bound_by=by,
                             bytes=nbytes))


# ---------------------------------------------------- phase 2: CNN kernels
CNN_DTYPES = ("int8", "int16", "int32", "float32", "bfloat16")


def cnn_tensor(torch, gen, shape, dt_name, lo=-8, hi=8):
    dt = getattr(torch, dt_name)
    if dt_name.startswith("int"):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=dt)
    return torch.randn(shape, generator=gen, device="cuda").to(dt)


def exact_err(out, ref) -> float:
    """max |out - ref| over the elements that are not NaN in both; inf where
    NaN in one only."""
    nan_o, nan_r = out.isnan(), ref.isnan()
    if out.shape != ref.shape or out.dtype != ref.dtype or not bool((nan_o == nan_r).all()):
        return math.inf
    d = (out.double() - ref.double()).abs()[~nan_r]
    return float(d.max()) if d.numel() else 0.0


def cnn_row(torch, timer, rows, kernel, case, dt_name, out, ref, atol, rtol,
            fn, plain, lib, nbytes, ops, reps=10):
    err = exact_err(out, ref)
    absmax = float(ref.double().nan_to_num(0.0).abs().max())
    ms = timer.ms(fn, reps=reps)
    plain_ms = timer.ms(plain, reps=5)
    lib_ms = timer.ms(lib, reps=reps) if lib is not None else None
    bms, by = bound_ms(nbytes, ops, dt_name)
    rows.append(dict(kernel=kernel, case=case, dtype=dt_name, max_abs_err=err,
                     ref_absmax=absmax, atol=atol, rtol=rtol,
                     ok=check_close(err, absmax, atol, rtol), ms=ms,
                     plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                     bound_by=by, bytes=nbytes))


def run_conv(torch, timer, gen, rows):
    """conv_layer against its plain version; each bf16 and int8 row also
    holds the variant the picker did not take to the plain version and
    times it (``other_*``), which is where ``MMA_MIN_FILTERS`` comes from.
    A wrapper without variants (an earlier tree's) is timed as it is."""
    import torch.nn.functional as F
    from repro_torch.kernels.convlayer import kernel as conv_kernel
    from repro_torch.kernels.convlayer.ref import conv_layer_ref
    from repro_torch.launch.cnn import FLOAT_TOL
    conv_layer_cuda = conv_kernel.conv_layer_cuda
    pick = getattr(conv_kernel, "conv_variant", None)
    cases = [((3, 256, 256), 1, k, dt, slope) for k in (3, 5, 7)
             for dt in CNN_DTYPES for slope in (0.0, 0.125)]
    cases += [((3, 255, 253), 2, 5, dt, 0.125) for dt in CNN_DTYPES]
    cases += [((3, 226, 226), 64, 3, dt, 0.125) for dt in CNN_DTYPES]
    # the filter count at which mma overtakes simt
    cases += [((3, 226, 226), nf, 3, dt, 0.125) for nf in (1, 2, 4, 8, 16, 32)
              for dt in ("int8", "bfloat16")]
    for (c, h, w), nf, k, dt, slope in cases:
        x = cnn_tensor(torch, gen, (c, h, w), dt)
        f = cnn_tensor(torch, gen, (nf, c, k, k), dt, -4, 4)
        out = conv_layer_cuda(x, f, negative_slope=slope)
        ref = conv_layer_ref(x, f, negative_slope=slope)
        variant = pick(x, f) if pick else None
        other = {"mma": "simt", "simt": "mma"}[variant] \
            if variant and dt in ("int8", "bfloat16") else None
        other_out = None if other is None else \
            conv_layer_cuda(x, f, negative_slope=slope, variant=other)
        torch.cuda.synchronize()
        atol, rtol = FLOAT_TOL.get(getattr(torch, dt), (0.0, 0.0))
        lib = None
        if not dt.startswith("int"):
            def lib(x=x, f=f, slope=slope):
                return F.leaky_relu(F.max_pool2d(F.conv2d(x[None], f), 2), slope)
        isz = x.element_size()
        cnn_row(torch, timer, rows, "conv_layer",
                f"{c}x{h}x{w} k={k} F={nf} slope={slope}", dt, out, ref, atol,
                rtol, lambda: conv_layer_cuda(x, f, negative_slope=slope),
                lambda: conv_layer_ref(x, f, negative_slope=slope), lib,
                (x.numel() + f.numel()) * isz + out.numel() * out.element_size(),
                2.0 * nf * c * (h - k + 1) * (w - k + 1) * k * k)
        if variant:
            rows[-1]["variant"] = variant
        if other:
            err = exact_err(other_out, ref)
            rows[-1].update(
                other_variant=other, other_max_abs_err=err,
                other_ms=timer.ms(lambda: conv_layer_cuda(x, f, negative_slope=slope,
                                                          variant=other)))
            rows[-1]["ok"] = rows[-1]["ok"] and check_close(
                err, rows[-1]["ref_absmax"], atol, rtol)


def run_maxpool(torch, timer, gen, rows):
    """maxpool against its plain version at the CNN path's maps (254 x 254
    int32 and 224 x 224 f32 accumulators), odd pitches with every window,
    NaN, maps of 1 to 16 MB, and large maps where the memory rate bounds it
    (84, 42 and 67 MB moved, fewer reps), all bit for bit. Each row names
    the variant maxpool_plan picks and also holds every other variant that
    takes the map to the plain version and times it (``<variant>_ms``). A
    wrapper without variants (an earlier tree's) is timed as it is."""
    import torch.nn.functional as F
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.maxpool import kernel as pool_kernel
    from repro_torch.kernels.maxpool.ref import maxpool_ref
    maxpool_cuda = pool_kernel.maxpool_cuda
    plan = getattr(pool_kernel, "maxpool_plan", None)
    cases = [((254, 254), 2, 2, dt) for dt in ("int8", "int32", "float32", "bfloat16")]
    cases += [((255, 253), win, st, dt) for win, st in ((3, 2), (3, 3), (4, 1))
              for dt in ("int8", "int32", "float32", "bfloat16")]
    cases += [((254, 254), 2, 2, "float32 NaN"), ((224, 224), 2, 2, "float32")]
    cases += [((1024, 1024), 2, 2, "float32"), ((2048, 2048), 2, 2, "float32"),
              ((2048, 2048), 2, 2, "int8"), ((4096, 4096), 2, 2, "int8")]
    cases += [((8192, 8192), 2, 2, "int8"), ((4096, 4096), 2, 2, "float32"),
              ((4096, 4096), 2, 2, "bfloat16"), ((4095, 4093), 3, 2, "bfloat16"),
              ((4096, 4096), 3, 1, "bfloat16")]
    for (h, w), win, st, dt in cases:
        name = dt.split()[0]
        x = cnn_tensor(torch, gen, (h, w), name, -100, 100)
        if dt.endswith("NaN"):
            idx = torch.randint(0, h * w, (500,), generator=gen, device="cuda")
            x.view(-1)[idx] = float("nan")
        out = maxpool_cuda(x, win=win, stride=st)
        ref = maxpool_ref(x, win=win, stride=st)
        isz, sms = x.element_size(), sm_count(x.device)
        variant = plan(h, w, win, st, isz, sms).variant if plan else None
        others = {}       # every other variant that takes the shape
        for v in (getattr(pool_kernel, "VARIANTS", {}) if plan else {}):
            try:
                if v != variant and plan(h, w, win, st, isz, sms, v):
                    others[v] = maxpool_cuda(x, win=win, stride=st, variant=v)
            except ValueError:
                pass
        torch.cuda.synchronize()
        lib = None
        if not name.startswith("int"):
            def lib(x=x, win=win, st=st):
                return F.max_pool2d(x[None, None], win, st)
        reps = 5 if h * w * isz > 2**24 else 10
        cnn_row(torch, timer, rows, "maxpool",
                f"{h}x{w} win={win} stride={st}" + (" NaN" if dt.endswith("NaN") else ""),
                name, out, ref, 0.0, 0.0,
                lambda: maxpool_cuda(x, win=win, stride=st),
                lambda: maxpool_ref(x, win=win, stride=st), lib,
                (x.numel() + out.numel()) * isz, float(out.numel() * win * win),
                reps=reps)
        # every output one of the input's elements, bit for bit (+-0 too)
        rows[-1]["same_bits"] = torch.equal(int_view(torch, out), int_view(torch, ref))
        rows[-1]["ok"] = rows[-1]["ok"] and rows[-1]["same_bits"]
        if variant:
            rows[-1]["variant"] = variant
        rows[-1]["others"] = []
        for v, o in others.items():
            same = torch.equal(int_view(torch, o), int_view(torch, ref))
            rows[-1]["others"].append(dict(
                variant=v, max_abs_err=exact_err(o, ref), same_bits=same,
                ms=timer.ms(lambda v=v: maxpool_cuda(x, win=win, stride=st, variant=v),
                            reps=reps)))
            rows[-1]["ok"] = rows[-1]["ok"] and same
        del x, out, ref, others


def int_view(torch, t):
    """t's raw bits as integers (floats of 4 and 2 bytes)."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()]) \
        if t.is_floating_point() else t


def run_leakyrelu(torch, timer, gen, rows):
    import torch.nn.functional as F
    from repro_torch.kernels.leakyrelu.kernel import leakyrelu_cuda
    from repro_torch.kernels.leakyrelu.ref import leakyrelu_ref
    for shape in ((1, 127, 127), (64, 112, 112)):
        for dt in CNN_DTYPES:
            for slope in (0.5, 0.01):
                x = cnn_tensor(torch, gen, shape, dt, -100, 100)
                out = leakyrelu_cuda(x, negative_slope=slope)
                ref = leakyrelu_ref(x, negative_slope=slope)
                torch.cuda.synchronize()
                lib = None
                if not dt.startswith("int"):
                    def lib(x=x, slope=slope):
                        return F.leaky_relu(x, slope)
                cnn_row(torch, timer, rows, "leakyrelu",
                        f"{shape} slope={slope}", dt, out, ref, 0.0, 0.0,
                        lambda: leakyrelu_cuda(x, negative_slope=slope),
                        lambda: leakyrelu_ref(x, negative_slope=slope), lib,
                        2 * x.numel() * x.element_size(), float(x.numel()))


# ------------------------------------------------- phase 2: host per call
HOST_CALLS, HOST_ROUNDS = 200, 5


class HostClock:
    """Host ns of the steps of a wrapper's calls: each wrapped function
    adds the time it takes to its step's count."""

    def __init__(self):
        self.ns: dict = {}

    def wrap(self, step: str, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kw)
            finally:
                self.ns[step] = self.ns.get(step, 0) + time.perf_counter_ns() - t0
        return timed


def host_calls_us(torch, fn, clock: HostClock | None = None) -> dict:
    """Host us of one call of fn: the median over HOST_CALLS back-to-back
    calls, with a spin kernel queued ahead so that no call waits on the
    card, the least of HOST_ROUNDS such medians (the host's clock is shared
    with other work); with a clock, each step's share of a call the same
    way."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(HOST_ROUNDS):
        torch.cuda._sleep(SPIN_CYCLES * 4)
        total, steps = [], []
        for _ in range(HOST_CALLS):
            if clock:
                clock.ns = {}
            t0 = time.perf_counter_ns()
            fn()
            total.append(time.perf_counter_ns() - t0)
            if clock:
                steps.append(dict(clock.ns))
        torch.cuda.synchronize()
        res = {"call_us": statistics.median(total) / 1e3}
        for step in sorted({k for d in steps for k in d}):
            res[f"{step}_us"] = statistics.median(d.get(step, 0) for d in steps) / 1e3
        rounds.append(res)
    return {k: min(r[k] for r in rounds) for k in rounds[0]}


# A step is what the functions of these names, where a wrapper's module has
# them, and PyTorch's allocators take; the rest of the call is "rest".
HOST_STEPS = {"check_cuda": "checks", "check_dtype": "checks",
              "check_kinds": "checks", "stream_ptr": "stream"}


def run_host(torch) -> dict:
    """The host cost of one call of each CNN wrapper at a shape of the cnn:
    runs, on this tree's wrappers: the whole call (unwrapped), then the same
    calls with each step wrapped by a HostClock: checks, output allocation
    (torch.empty, empty_like, Tensor.new_empty), stream lookup, the ctypes
    call (the launch included) and the rest (the whole call less the
    steps). ``floor`` is the host cost of launching an empty kernel
    through PyTorch."""
    from repro_torch.kernels.convlayer import kernel as conv_kernel
    from repro_torch.kernels.leakyrelu import kernel as relu_kernel
    from repro_torch.kernels.maxpool import kernel as pool_kernel
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = cnn_tensor(torch, gen, (3, 226, 226), "bfloat16")
    f = cnn_tensor(torch, gen, (64, 3, 3, 3), "bfloat16", -4, 4)
    y = cnn_tensor(torch, gen, (224, 224), "float32")
    z = cnn_tensor(torch, gen, (64, 112, 112), "float32")
    cases = [("conv_layer", "3x226x226 k=3 F=64 bfloat16", conv_kernel,
              lambda: conv_kernel.conv_layer_cuda(x, f, negative_slope=0.125)),
             ("maxpool", "224x224 win=2 float32", pool_kernel,
              lambda: pool_kernel.maxpool_cuda(y)),
             ("leakyrelu", "(64, 112, 112) float32", relu_kernel,
              lambda: relu_kernel.leakyrelu_cuda(z, negative_slope=0.125))]
    out = {"floor": host_calls_us(torch, lambda: torch.cuda._sleep(0))}
    print(f"host: floor (torch.cuda._sleep(0)): {json.dumps(out['floor'])}", flush=True)
    allocators = [(torch, "empty"), (torch, "empty_like"), (torch.Tensor, "new_empty")]
    for name, case, mod, call in cases:
        res = host_calls_us(torch, call)
        clock = HostClock()
        call()
        saved = [(mod, n, getattr(mod, n)) for n in (*HOST_STEPS, "_FN") if hasattr(mod, n)]
        saved += [(owner, n, getattr(owner, n)) for owner, n in allocators]
        try:
            for owner, n, fn in saved:
                step = "ctypes" if n == "_FN" else HOST_STEPS.get(n, "alloc")
                setattr(owner, n, clock.wrap(step, fn))
            steps = host_calls_us(torch, call, clock)
        finally:
            for owner, n, fn in saved:
                setattr(owner, n, fn)
        for k, v in steps.items():
            if k != "call_us":
                res[k] = v
        res["rest_us"] = res["call_us"] - sum(v for k, v in steps.items() if k != "call_us")
        res["case"] = case
        out[name] = res
        print(f"host: {name} {case}: " + " ".join(
            f"{k}={v:.2f}" for k, v in res.items() if k != "case")
            + f" (least of {HOST_ROUNDS} medians of {HOST_CALLS} calls, card busy)",
            flush=True)
    return out


# ---------------------------------------------------------------- phase 3
# The served models, in order: full width unless ``smoke``; 4 slots, 6
# requests of 16 new tokens; prompt lengths drawn from [16, 513), or from
# ``prompt_lens`` where the recurrent scans' chunk contract (rwkv6: 64;
# jamba-smoke: 16) refuses the others. Their launch counts come from
# ``layer_gemms`` and the attention layers of each model's pattern.
SERVE_MODELS = (
    dict(arch="gemma2-9b"), dict(arch="granite-moe-1b-a400m"),
    dict(arch="minicpm3-4b"),
    # rwkv6's bf16 logits are held to the library engine (``library_engine``):
    # this random-weight model carries a GEMM that sums K in another order
    # than the plain version past the limits against ref (the plain version
    # summing K in two halves, ``halves_engine``, lands as far from ref as
    # the kernels), while the kernels and cuBLAS sum in the same order (the
    # same bits in nearly every output: ``gemm_on_activations``; PERF.md)
    dict(arch="rwkv6-1.6b", prompt_lens=(16, 32, 64, 128, 256, 512),
         reference="library"),
    dict(arch="jamba-1.5-large-398b", smoke=True, max_len=128,
         prompt_lens=(4, 9, 16, 32, 48, 64)),
)
ATTN_KINDS = ("attn", "attn_local", "mla")


def layer_gemms(torch, cfg, spec, m: int, prompt: bool, batch: int = 1,
                cross_rows: int | None = None) -> list:
    """(A, B) of each engine GEMM of one layer at M = m rows, as meta
    tensors in the layouts the model hands the engine (A contiguous unless
    named; B a weight of a stacked parameter): attention's q, k, v, o
    (biases, internvl2's, ride along as C and change no pick); with
    ``cross_rows`` (an encoder-decoder's decoder layer) the
    cross-attention's k and v over the encoder's ``cross_rows`` rows and
    its q and o in a prompt, q and o in a step (its K and V are read from
    the cross cache);
    MLA's q_down, q_up, kv_down (twice in a prompt: mla_prefill projects
    for the cache and again in the forward, as the reference does) and o;
    Mamba's in_proj, x_proj, dt_proj (A the first dt_rank columns of
    x_proj's output, in place) and out_proj, and in a prompt in_proj again
    over the last d_conv - 1 tokens of each of the ``batch`` sequences
    (the conv state); RWKV's r, k, v, g, the decay LoRA's wA and wB, o and
    the channel mix's cm_k, cm_v, cm_r; then a dense FFN's gate, up, down
    (whisper's classic MLP: up, down). An encoder's layer is an ``attn``
    layer at M = its frames. An MoE FFN runs no engine GEMM (the f32 router and the expert products
    are PyTorch calls, as the reference's are plain jnp)."""
    from repro_torch.models.mlp import classic as classic_mlp

    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    def w(k, n):
        return meta(cfg.n_periods, k, n)[0]

    def act(k, rows=m):
        return meta(rows, k)

    d, ff = cfg.d_model, cfg.d_ff
    out = []
    if spec.kind in ("attn", "attn_local"):
        q, kv = (h * cfg.resolved_head_dim for h in (cfg.n_heads, cfg.n_kv_heads))
        out += [(act(d), w(d, q)), (act(d), w(d, kv)), (act(d), w(d, kv)),
                (act(q), w(q, d))]
        if cross_rows is not None:
            if prompt:
                out += [(act(d, cross_rows), w(d, kv))] * 2
            out += [(act(d), w(d, q)), (act(q), w(q, d))]
    elif spec.kind == "mla":
        ml = cfg.mla
        qk = ml.qk_nope_head_dim + ml.qk_rope_head_dim
        proj = [(act(d), w(d, ml.q_lora_rank)),
                (act(ml.q_lora_rank), w(ml.q_lora_rank, cfg.n_heads * qk)),
                (act(d), w(d, ml.kv_lora_rank + ml.qk_rope_head_dim))]
        vo = cfg.n_heads * ml.v_head_dim
        out += proj * (2 if prompt else 1) + [(act(vo), w(vo, d))]
    elif spec.kind == "mamba":
        mb = cfg.mamba
        di, dtr = mb.expand * d, mb.dt_rank or -(-d // 16)
        xn = dtr + 2 * mb.d_state
        out += [(act(d), w(d, 2 * di)), (act(di), w(di, xn)),
                (act(xn)[:, :dtr], w(dtr, di)), (act(di), w(di, d))]
        if prompt:
            out.append((act(d, batch * (mb.d_conv - 1)), w(d, 2 * di)))
    elif spec.kind == "rwkv":
        lora = cfg.rwkv.decay_lora
        return [(act(d), w(d, d))] * 4 + [
            (act(d), w(d, lora)), (act(lora), w(lora, d)), (act(d), w(d, d)),
            (act(d), w(d, ff)), (act(ff), w(ff, d)), (act(d), w(d, d))]
    if classic_mlp(cfg):
        out += [(act(d), w(d, ff)), (act(ff), w(ff, d))]
    elif not spec.moe:
        out += [(act(d), w(d, ff)), (act(d), w(d, ff)), (act(ff), w(ff, d))]
    return out


def attention_variants(torch, cfg) -> tuple[str, str]:
    """The flash variant of a prompt's attention layers (meta q, k, v in
    the model's layouts: q and k contiguous after the rotary embedding, v
    a view of its projection's heads; MLA's all contiguous) and the decode
    variant of a step's (MLA's absorbed decode: one latent head for all)."""
    from repro_torch.kernels.decode_attention.kernel import decode_variant
    from repro_torch.kernels.flash_attention.kernel import flash_variant

    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    s, h, hkv = 512, cfg.n_heads, cfg.n_kv_heads
    if cfg.mla is not None:
        ml = cfg.mla
        qk = ml.qk_nope_head_dim + ml.qk_rope_head_dim
        q = k = v = meta(1, h, s, qk)
        g, d = h, ml.kv_lora_rank + ml.qk_rope_head_dim
    else:
        hd = cfg.resolved_head_dim
        q, k = meta(1, h, s, hd), meta(1, hkv, s, hd)
        v = meta(1, s, hkv * hd).reshape(1, s, hkv, hd).transpose(1, 2)
        g, d = h // hkv, hd
    return flash_variant(q, k, v), decode_variant(g, d)


def expected_launches(torch, cfg, prompt_lens, n_steps: int, slots: int,
                      enc_len: int = 0) -> tuple[dict, dict]:
    """The launch counts of a serving run, and per variant: per prompt
    (batch 1, M = its length, behind the vision prefix where there is
    one) and per decode step (M = the slots) each layer's engine GEMMs
    (``layer_gemms``) on ``gemm_variant``'s pick, and the unembed of one
    row or of the slots (a GEMV); an encoder-decoder's prompt also runs
    the encoder's layers at M = ``enc_len`` and each decoder layer's
    cross-attention over them. Flash attention: one launch per attention
    layer and prompt (an encoder-decoder's: the encoder's, the decoder's
    self- and cross-attention); decode attention: one per attention layer
    and step (and one more over the cross cache); each on its variant's
    pick."""
    from repro_torch.kernels.gemm.kernel import gemm_variant
    from repro_torch.models.transformer import ENC_SPEC
    gemm = dict.fromkeys(("gemv", "wgmma", "wmma", "fma"), 0)
    table_t = torch.empty((cfg.vocab, cfg.d_model), dtype=torch.bfloat16,
                          device="meta").T
    cross = enc_len if cfg.enc_dec else None

    def add(m, prompt):
        for spec in cfg.pattern:
            for a, b in layer_gemms(torch, cfg, spec, m, prompt, cross_rows=cross):
                gemm[gemm_variant(a, b)] += cfg.n_periods
        if prompt and cfg.enc_dec:
            for a, b in layer_gemms(torch, cfg, ENC_SPEC, enc_len, True):
                gemm[gemm_variant(a, b)] += cfg.n_enc_layers
        rows = 1 if prompt else m
        gemm[gemm_variant(table_t.new_empty((rows, cfg.d_model)), table_t)] += 1

    for s in prompt_lens:
        add(cfg.vision_prefix + s, True)
    for _ in range(n_steps):
        add(slots, False)
    n_attn = cfg.n_periods * sum(spec.kind in ATTN_KINDS for spec in cfg.pattern)
    n_cross = cfg.n_layers if cfg.enc_dec else 0
    fv, dv = attention_variants(torch, cfg)
    counts = {"gemm_cuda": sum(gemm.values()),
              "flash_attention_cuda": (n_attn + n_cross + cfg.n_enc_layers)
              * len(prompt_lens),
              "decode_attention_cuda": (n_attn + n_cross) * n_steps}
    variants = {"gemm_cuda": gemm,
                "flash_attention_cuda": {"simt": 0, "mma": 0},
                "decode_attention_cuda": {"narrow": 0, "wide": 0}}
    variants["flash_attention_cuda"][fv] += counts["flash_attention_cuda"]
    variants["decode_attention_cuda"][dv] += counts["decode_attention_cuda"]
    return counts, variants


def logits_limits(cfg) -> tuple:
    """(max, mean) |cuda - ref| allowed on a request's bf16 logits, and the
    same as shares of the largest |ref| logit: gemma2's are soft-capped to
    [-30, 30], and the engines differ only in the order of f32 sums, so a
    bf16 activation that rounds the other way at one of the 42 layers moves
    them by a few hundredths on average (SERVE_ATOL, SERVE_MEAN_ATOL);
    uncapped logits are held to shares of their largest (SERVE_RTOL,
    SERVE_MEAN_RTOL)."""
    if cfg.final_softcap:
        return SERVE_ATOL, SERVE_MEAN_ATOL, None, None
    return None, None, SERVE_RTOL, SERVE_MEAN_RTOL


def library_engine(torch):
    """ArcaneEngine("ref") with each GEMM of a bf16 result through one
    PyTorch call in bf16 (cuBLAS: products summed in f32 on the tensor
    cores, one rounding), others as "ref": the library's bf16 GEMM as an
    engine, the yardstick of a model whose SERVE_MODELS entry names it.
    Used nowhere in the port."""
    from repro_torch.core.engine import ArcaneEngine

    class LibraryEngine(ArcaneEngine):
        def gemm(self, x, w, c=None, *, alpha=1.0, beta=1.0, out_dtype=None):
            if x.dtype != torch.bfloat16 or (out_dtype or x.dtype) != x.dtype:
                return super().gemm(x, w, c, alpha=alpha, beta=beta,
                                    out_dtype=out_dtype)
            lead, n = x.shape[:-1], w.shape[-1]
            x2 = x.reshape(-1, x.shape[-1])
            out = x2 @ w if c is None else torch.addmm(
                c.reshape(-1, n), x2, w, beta=beta, alpha=alpha)
            return out.reshape(*lead, n)

    return LibraryEngine("ref")


def halves_engine(torch):
    """ArcaneEngine("ref") whose GEMMs of a bf16 result sum K in two halves
    (the plain f32 product of each half, then their sum): the plain
    version in another order, to read how far a sound change of order
    moves a model's logits. Used nowhere in the port."""
    from repro_torch.core.engine import ArcaneEngine

    class HalvesEngine(ArcaneEngine):
        def gemm(self, x, w, c=None, *, alpha=1.0, beta=1.0, out_dtype=None):
            h = x.shape[-1] // 2
            if x.dtype != torch.bfloat16 or (out_dtype or x.dtype) != x.dtype \
                    or c is not None or alpha != 1.0 or h == 0:
                return super().gemm(x, w, c, alpha=alpha, beta=beta,
                                    out_dtype=out_dtype)
            xf, wf = x.float(), w.float()
            return (xf[..., :h] @ wf[:h] + xf[..., h:] @ wf[h:]).to(x.dtype)

    return HalvesEngine("ref")


# Planted GEMM faults, each a kernel with one bug, that the logits and the
# Mamba block checks must reject: the result 1% too large ("scale"), the
# last 64 rows of K left out ("k_tile": one K tile of the wgmma kernel
# dropped), the f32 sum cut to bf16 toward zero instead of to the nearest
# ("truncate").
GEMM_FAULTS = ("scale", "k_tile", "truncate")
FAULT_K_TILE = 64


def fault_engine(torch, fault: str, backend: str = "cuda"):
    """ArcaneEngine(backend) whose GEMMs of a bf16 result carry the planted
    ``fault``: the engine's own GEMM with an f32 result (on the card the
    kernel, same variant and same sums), the fault, then bf16."""
    from repro_torch.core.engine import ArcaneEngine
    if fault not in GEMM_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")

    class FaultEngine(ArcaneEngine):
        def gemm(self, x, w, c=None, *, alpha=1.0, beta=1.0, out_dtype=None):
            if x.dtype != torch.bfloat16 or (out_dtype or x.dtype) != x.dtype:
                return super().gemm(x, w, c, alpha=alpha, beta=beta,
                                    out_dtype=out_dtype)
            kw = dict(alpha=alpha, beta=beta, out_dtype=torch.float32)
            if fault == "k_tile":
                k = x.shape[-1] - FAULT_K_TILE
                if k <= 0:
                    out = x.new_zeros((*x.shape[:-1], w.shape[-1]), dtype=torch.float32)
                    return (out if c is None else out + beta * c.float()).to(x.dtype)
                x, w = x[..., :k], w[:k]
            out = super().gemm(x, w, c, **kw)
            if fault == "scale":
                out = out * 1.01
            elif fault == "truncate":
                out = (out.view(torch.int32) & -65536).view(torch.float32)
            return out.to(x.dtype)

    return FaultEngine(backend)


def engine_logits(torch, cfg, params, prompt, engines: dict, extra=None) -> dict:
    """Each engine's prefill logits of one prompt (with ``extra``, the
    stub frontends' embeddings of a batch of one) and its first decode
    step's (on the token the first engine's prefill picks, fed to every
    engine), in f32, on the card."""
    from repro_torch.models.transformer import LM
    dev = torch.device("cuda")
    extra = extra or {}
    batch = {"tokens": torch.as_tensor(prompt[None], device=dev), **extra}
    enc = extra["audio_embeds"].shape[1] if "audio_embeds" in extra else 0
    at = cfg.vision_prefix + len(prompt)
    pos = torch.tensor([at], dtype=torch.int32, device=dev)
    logits, nxt = {}, None
    for name, engine in engines.items():
        m = LM(cfg, engine, device=dev)
        cache = m.init_cache(1, at + 8, enc_len=enc)
        lg, cache = m.prefill(params, batch, cache)
        if nxt is None:
            nxt = torch.argmax(lg, -1).to(torch.int32)
        lg2, _ = m.decode_step(params, nxt, pos, cache, enc_len=enc)
        logits[name] = (lg.float(), lg2.float())
        del cache
    return logits


def logits_gap(cfg, a, b, limits=None) -> dict:
    """|a - b| (max and mean) of two engines' logits, the largest |b|,
    whether the argmax agrees and, with ``limits`` (``logits_limits``),
    the limits beside them (an absolute one, or a share of the largest
    |b|). Fails on logits ``a`` that are not finite or of the wrong shape."""
    if not bool(a.isfinite().all()) or tuple(a.shape) != (1, cfg.vocab):
        fail(f"serve: {cfg.name}: logits not finite or of shape {tuple(a.shape)}")
    d = (a - b).abs()
    absmax = float(b.abs().max())
    out = {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
           "ref_absmax": absmax,
           "argmax_equal": bool((a.argmax(-1) == b.argmax(-1)).all())}
    if limits is not None:
        max_atol, mean_atol, max_rtol, mean_rtol = limits
        out["max_limit"] = max_atol if max_atol else max_rtol * absmax
        out["mean_limit"] = mean_atol if mean_atol else mean_rtol * absmax
    return out


def within_limits(c: dict) -> bool:
    """A gap within its limits, max and mean."""
    return c["max_abs"] <= c["max_limit"] and c["mean_abs"] <= c["mean_limit"]


def engines_agree(torch, cfg, params, prompt, limits, reference: str = "ref",
                  extra=None) -> dict:
    """One prompt's prefill logits and its first decode step's through
    ArcaneEngine("cuda") against the ``reference`` engine on the same
    weights, on the card: ``ref`` (ArcaneEngine("ref"), every GEMM the
    plain f32 product) or ``library`` (``library_engine``). Against the
    library the gaps to ref of cuda, the library and ``halves_engine`` are
    kept beside, and each engine of GEMM_FAULTS is held to the library
    too: the check must reject every one, or the run fails."""
    from repro_torch.core.engine import ArcaneEngine
    engines = {"cuda": ArcaneEngine("cuda"), "ref": ArcaneEngine("ref")}
    if reference == "library":
        engines["library"] = library_engine(torch)
        engines["halves"] = halves_engine(torch)
        engines.update({f"fault {f}": fault_engine(torch, f) for f in GEMM_FAULTS})
    elif reference != "ref":
        raise ValueError(f"unknown reference engine {reference!r}")
    logits = engine_logits(torch, cfg, params, prompt, engines, extra)
    cmp = {}
    for i, what in enumerate(("prefill", "decode")):
        base = logits[reference][i]
        c = cmp[what] = {"against": reference,
                         **logits_gap(cfg, logits["cuda"][i], base, limits)}
        if reference == "ref":
            continue
        c["cuda_vs_ref"] = logits_gap(cfg, logits["cuda"][i], logits["ref"][i])
        c["library_vs_ref"] = logits_gap(cfg, base, logits["ref"][i])
        c["halves_vs_ref"] = logits_gap(cfg, logits["halves"][i], logits["ref"][i])
        c["faults"] = {f: logits_gap(cfg, logits[f"fault {f}"][i], base, limits)
                       for f in GEMM_FAULTS}
    for f in GEMM_FAULTS if reference != "ref" else ():
        if all(within_limits(cmp[w]["faults"][f]) for w in cmp):
            fail(f"serve: {cfg.name}: the logits check against the {reference} "
                 f"engine does not reject the planted GEMM fault {f!r}: "
                 f"{json.dumps({w: cmp[w]['faults'][f] for w in cmp})}")
    return cmp


def counted_run(torch, cfg, fn, expect):
    """``fn()`` with the serving kernels' launch and variant counts zeroed
    just before and read just after, held exactly to ``expect(fn())``:
    (counts, variants) as ``expected_launches`` gives them for what ran,
    and a note for the printed line. The run fails on any other count or
    variant, or when a kernel of the model's path (the GEMM; flash and
    decode attention where it has attention layers) was launched no time.
    Returns fn's result, the counts and the variants."""
    from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.gemm.kernel import gemm_cuda
    wrappers = (gemm_cuda, flash_attention_cuda, decode_attention_cuda)
    for w in wrappers:
        w.launches = 0
        w.variants = dict.fromkeys(w.variants, 0)
    out = fn()
    counts = {w.__name__: w.launches for w in wrappers}
    variants = {w.__name__: dict(w.variants) for w in wrappers}
    want, want_var, note = expect(out)
    name = cfg.name
    print(f"serve: {name} launches {counts} expected {want} {note}", flush=True)
    print(f"serve: {name} variants {variants} expected {want_var}", flush=True)
    path = [w.__name__ for w in wrappers]
    if not (cfg.enc_dec or any(spec.kind in ATTN_KINDS for spec in cfg.pattern)):
        path = ["gemm_cuda"]
    if counts != want or min(counts[k] for k in path) <= 0:
        fail(f"serve: {name}: the main path did not run through every kernel as counted")
    if variants != want_var:
        fail(f"serve: {name}: the main path did not run through the variants as counted")
    return out, counts, variants


def run_serve(torch, summary: dict, arch: str, smoke: bool = False,
              max_len: int = 1024, prompt_lens=None, reference: str = "ref") -> dict:
    """One model served through the port's launcher (full width unless
    ``smoke``): 4 slots, 6 requests of 16 new tokens, prompts of 16-512
    tokens or drawn from ``prompt_lens``, bf16 weights drawn on the card
    from seed 0; the launch counts zeroed just before and read just after.
    Then one request through ArcaneEngine("cuda") and ("ref") on the same
    weights, and the profiler over a prefill and a few decode steps."""
    from repro_torch.launch import serve as launcher
    from repro_torch.models.transformer import tree_leaves

    argv = ["--arch", arch, "--requests", "6", "--max-new", "16",
            "--slots", "4", "--max-len", str(max_len), "--seed", "0",
            "--backend", "cuda"]
    argv += ["--prompt-lens", *map(str, prompt_lens)] if prompt_lens else \
        ["--prompt-len", "16", "513"]
    args = launcher.parse_args(argv + (["--smoke"] if smoke else []))
    t0 = time.perf_counter()
    model, params = launcher.build(args)
    cfg = model.cfg
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    torch.cuda.reset_peak_memory_stats()

    name = cfg.name
    print(f"serve: {name} layers={cfg.n_layers} d={cfg.d_model} vocab={cfg.vocab} "
          f"params={n_params} init_s={init_s:.2f}", flush=True)
    per_step = expected_launches(torch, cfg, [], 1, args.slots)[0]["gemm_cuda"]
    per_prompt = expected_launches(torch, cfg, [16], 0, args.slots)[0]["gemm_cuda"]

    def expect(out):
        done = out["session"].finished
        if len(done) != args.requests or \
                any(len(r.out_tokens) != args.max_new for r in done):
            fail(f"serve: {name}: {len(done)}/{args.requests} requests finished, "
                 f"tokens {[len(r.out_tokens) for r in done]}")
        n_steps = out["session"].stats["decode_steps"]
        return (*expected_launches(torch, cfg, [len(r.prompt) for r in done],
                                   n_steps, args.slots),
                f"(prompts={len(done)} decode_steps={n_steps}; gemm a decode step "
                f"{per_step}, a prompt {per_prompt}, the unembed included)")

    out, counts, variants = counted_run(
        torch, cfg, lambda: launcher.serve(model, params, args), expect)
    sess = out["session"]
    st = sess.stats
    peak = torch.cuda.max_memory_allocated()
    done = sess.finished
    n_steps = st["decode_steps"]
    metrics = {
        "requests": len(done), "tokens": out["tokens"], "seconds": out["seconds"],
        "tokens_per_s": out["tokens"] / out["seconds"],
        "decode_steps": n_steps,
        "decode_step_ms": st["decode_s"] / n_steps * 1e3,
        "prefill_tokens": st["prefill_tokens"],
        "prefill_ms_per_token": st["prefill_s"] / st["prefill_tokens"] * 1e3,
        "max_memory_allocated": peak, "params": n_params, "init_s": init_s,
        "gemm_per_step": per_step, "gemm_per_prompt": per_prompt,
        "launches": counts, "variants": variants,
        "prompt_lens": [len(r.prompt) for r in sorted(done, key=lambda r: r.uid)],
    }
    print(f"serve: {name} " + " ".join(
        f"{k}={v}" for k, v in metrics.items()
        if k not in ("launches", "variants", "prompt_lens")), flush=True)

    req = min(done, key=lambda r: r.uid)
    metrics["greedy_agreement"] = check_logits(torch, summary, cfg, params,
                                               req.prompt, reference)
    if reference != "ref":
        metrics["gemm_on_activations"] = gemm_on_activations(
            torch, model, params, req.prompt, name)
    metrics["prefill_profile"] = profile_prefill(torch, model, params, name)
    if cfg.rwkv is not None:
        metrics["prefill_profile"]["wkv"] = wkv_share(torch, model, params, name)
    metrics["decode_profile"] = profile_decode(torch, sess, args.max_len, name)
    return metrics


def check_logits(torch, summary: dict, cfg, params, prompt, reference: str = "ref",
                 extra=None) -> dict:
    """One request through ArcaneEngine("cuda") and its reference engine on
    the same weights: the served bf16 ones, and for uncapped logits an f32
    copy too (against ref), each within its limits (the f32 copy's argmax
    equal too) or the run fails. Returns whether each argmax agrees."""
    name = cfg.name
    cmp = engines_agree(torch, cfg, params, prompt, logits_limits(cfg), reference,
                        extra)
    summary.setdefault("serve_vs_ref", {})[name] = cmp
    print(f"serve: {name} cuda vs {reference} logits {json.dumps(cmp)}", flush=True)
    if cfg.final_softcap is None:
        import dataclasses
        from repro_torch.models.transformer import tree_map
        cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
        params32 = tree_map(lambda x: x.float(), params)
        cmp32 = engines_agree(torch, cfg32, params32, prompt,
                              (None, None, SERVE_F32_RTOL, SERVE_F32_RTOL), extra=extra)
        del params32
        summary["serve_vs_ref"][name + " f32"] = cmp32
        print(f"serve: {name} cuda vs ref logits, f32 copy of the weights "
              f"{json.dumps(cmp32)}", flush=True)
        cmp = {**cmp, **{f"{k} f32": v for k, v in cmp32.items()}}
    for what, c in cmp.items():
        if not within_limits(c):
            fail(f"serve: {name}: {what} logits of cuda and {c['against']} "
                 f"disagree: {c}")
        if what.endswith("f32") and not c["argmax_equal"]:
            fail(f"serve: {name}: {what} greedy tokens of the two engines differ: {c}")
    return {k: v["argmax_equal"] for k, v in cmp.items()}


def wkv_share(torch, model, params, name: str, prompt_len: int = 512) -> dict:
    """The host clock of one 512-token prefill and the share of it that
    the plain wkv recurrence (``rwkv6._wkv_scan``, a layer's Python loop
    over the tokens, on the card) takes: each call is timed from a
    synchronize before it to one after it."""
    from repro_torch.models import rwkv6
    inner, spent = rwkv6._wkv_scan, []

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(0, model.cfg.vocab, (1, prompt_len)),
                             device=model.device)
    cache = model.init_cache(1, prompt_len + 8)
    rwkv6._wkv_scan = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        rwkv6._wkv_scan = inner
    out = {"prompt_len": prompt_len, "prefill_wall_ms": wall * 1e3,
           "wkv_ms": sum(spent) * 1e3, "wkv_calls": len(spent),
           "wkv_share": sum(spent) / wall}
    print(f"profile: {name} prefill wkv recurrence {json.dumps(out)}", flush=True)
    return out


def bf16_ulps(torch, a, b):
    """|a - b| in bf16 ulps, elementwise: the distance of the two values'
    bit patterns on the number line (+0 and -0 one apart)."""
    def ordinal(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF) - 1, bits)
    return (ordinal(a) - ordinal(b)).abs()


def gemm_on_activations(torch, model, params, prompt, name: str) -> dict:
    """Every engine GEMM of a bf16 result in one prefill of ``prompt`` and
    its first decode step through ArcaneEngine("ref"), each also through
    the kernel (gemm_cuda) and the library's bf16 GEMM on the same
    operands, by variant and shape (K, N): outputs compared, the share of
    the kernel's that differ from the plain version's and from the
    library's, their largest distance in bf16 ulps, the shares of the
    kernel's that lie nearer zero and farther from it than the plain
    version's, and the kernel's f32 sums against the plain version's (the
    same GEMM with an f32 result): sum((kernel - plain) * sign(plain)) /
    sum(|plain|), below 0 when they run nearer zero. Fails where the
    kernel's result misses the plain version's by more than phase 2's
    bf16 GEMM tolerance (GEMM_BF16_TOL)."""
    from repro_torch.core.engine import ArcaneEngine
    from repro_torch.kernels.gemm.kernel import gemm_cuda, gemm_variant
    atol, rtol = GEMM_BF16_TOL
    stats = {}

    class Probe(ArcaneEngine):
        def gemm(self, x, w, c=None, *, alpha=1.0, beta=1.0, out_dtype=None):
            ref = super().gemm(x, w, c, alpha=alpha, beta=beta, out_dtype=out_dtype)
            if ref.dtype != torch.bfloat16 or c is not None:
                return ref
            a2 = x.reshape(-1, x.shape[-1])
            r = ref.reshape(a2.shape[0], -1)
            kern = gemm_cuda(a2, w)
            lib = a2 @ w
            r32 = a2.float() @ w.float()
            k32 = gemm_cuda(a2, w, out_dtype=torch.float32)
            err = float((kern.float() - r.float()).abs().max())
            absmax = float(r.float().abs().max())
            key = f"{gemm_variant(a2, w)} K={w.shape[0]} N={w.shape[1]}"
            st = stats.setdefault(key, dict(
                calls=0, outputs=0, differ_plain=0, differ_library=0,
                max_ulps_plain=0, max_ulps_library=0, nearer_zero=0,
                farther=0, f32_signed=0.0, f32_abs=0.0, worst_err_over_tol=0.0))
            st["calls"] += 1
            st["outputs"] += r.numel()
            st["differ_plain"] += int((kern != r).sum())
            st["differ_library"] += int((kern != lib).sum())
            st["max_ulps_plain"] = max(st["max_ulps_plain"],
                                       int(bf16_ulps(torch, kern, r).max()))
            st["max_ulps_library"] = max(st["max_ulps_library"],
                                         int(bf16_ulps(torch, kern, lib).max()))
            st["nearer_zero"] += int((kern.float().abs() < r.float().abs()).sum())
            st["farther"] += int((kern.float().abs() > r.float().abs()).sum())
            st["f32_signed"] += float(((k32 - r32) * r32.sign()).sum())
            st["f32_abs"] += float(r32.abs().sum())
            st["worst_err_over_tol"] = max(st["worst_err_over_tol"],
                                           err / (atol + rtol * absmax))
            return ref

    from repro_torch.models.transformer import LM
    dev = torch.device("cuda")
    m = LM(model.cfg, Probe("ref"), device=dev)
    cache = m.init_cache(1, len(prompt) + 8)
    lg, cache = m.prefill(params, {"tokens": torch.as_tensor(prompt[None], device=dev)},
                          cache)
    m.decode_step(params, torch.argmax(lg, -1).to(torch.int32),
                  torch.tensor([len(prompt)], dtype=torch.int32, device=dev), cache)
    del cache
    out = {}
    for key, st in stats.items():
        n = st["outputs"]
        out[key] = {"calls": st["calls"], "outputs": n,
                    "share_differ_plain": st["differ_plain"] / n,
                    "share_differ_library": st["differ_library"] / n,
                    "max_ulps_plain": st["max_ulps_plain"],
                    "max_ulps_library": st["max_ulps_library"],
                    "share_nearer_zero": st["nearer_zero"] / n,
                    "share_farther": st["farther"] / n,
                    "f32_relative_bias": st["f32_signed"] / st["f32_abs"],
                    "worst_err_over_tol": st["worst_err_over_tol"]}
    print(f"serve: {name} gemm on the model's activations (prompt of "
          f"{len(prompt)}): {json.dumps(out)}", flush=True)
    bad = [k for k, v in out.items() if v["worst_err_over_tol"] > 1]
    if bad:
        fail(f"serve: {name}: gemm misses the plain version on the model's "
             f"activations at {bad}")
    return out


def run_serving(torch, summary: dict, specs, runner) -> dict:
    """Every model of ``specs`` (SERVE_MODELS through ``run_serve``,
    EMBED_MODELS through ``run_embed_serve``) in turn, each freed before
    the next; the kernels' launches summed over the runs."""
    import gc
    out = {"models": {}, "launches": {}, "variants": {}}
    for spec in specs:
        arch = spec["arch"] + (" --smoke" if spec.get("smoke") else "")
        m = out["models"][arch] = runner(torch, summary, **spec)
        for w, n in m["launches"].items():
            out["launches"][w] = out["launches"].get(w, 0) + n
        for w, vs in m["variants"].items():
            tot = out["variants"].setdefault(w, {})
            for v, n in vs.items():
                tot[v] = tot.get(v, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
        print(f"serve: {arch} freed; {torch.cuda.memory_allocated()} bytes "
              f"still allocated", flush=True)
    return out


# cuda vs ref on the card for the full-width Mamba block, as shares of the
# largest |ref| value of each tensor (the output of the prefill and of the
# decode steps, the conv and SSM states after them), max and mean, set
# between the sound kernels' largest reading and the planted faults'
# (GEMM_FAULTS), which the check must reject. On the H100 the kernels read
# at most 6.2e-3 and 1.5e-4 (the decode steps' output); "truncate", the
# least fault, at most 1.6e-2 (SSM state) and 8.5e-4 (decode output).
BLOCK_RTOL = 2.0 ** -6
BLOCK_MEAN_RTOL = 2.0 ** -11


def run_mamba_block(torch) -> dict:
    """One ``mamba`` block of jamba-1.5-large-398b at full width (d 8192,
    d_inner 16384, d_state 16, dt_rank 512; its pattern's position 0, a
    dense FFN of 24576), random bf16 weights drawn on the card from seed 0:
    a prefill of 4 sequences of 512 tokens, then 8 decode steps, through
    ArcaneEngine("cuda"), through ArcaneEngine("ref") and through each
    engine of GEMM_FAULTS on the same weights and inputs. Checks the
    outputs and the conv and SSM states (finite, shaped, cuda within
    BLOCK_RTOL / BLOCK_MEAN_RTOL of the largest |ref|, every planted fault
    outside them in some tensor), and cuda's GEMM launches, exactly and per
    variant (8 a prefill, 7 a step: ``layer_gemms``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import ArcaneEngine
    from repro_torch.kernels.gemm.kernel import gemm_cuda, gemm_variant
    from repro_torch.models import blocks
    from repro_torch.models.transformer import tree_leaves
    cfg = get_config("jamba-1.5-large-398b")
    spec = cfg.pattern[0]
    b, s, steps, dev = 4, 512, 8, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = blocks.block_init(gen, cfg, spec, dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    x = torch.randn((b, s, cfg.d_model), device=dev, generator=gen).to(torch.bfloat16)
    toks = torch.randn((steps, b, cfg.d_model), device=dev, generator=gen).to(torch.bfloat16)
    positions = torch.arange(s, device=dev)
    engines = {"cuda": ArcaneEngine("cuda"), "ref": ArcaneEngine("ref"),
               **{f"fault {f}": fault_engine(torch, f) for f in GEMM_FAULTS}}
    results, times = {}, {}
    for backend, engine in engines.items():
        cache = blocks.init_block_cache(cfg, spec, b, s + steps, torch.bfloat16, dev)
        if backend == "cuda":
            gemm_cuda.launches = 0
            gemm_cuda.variants = dict.fromkeys(gemm_cuda.variants, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = blocks.block_prefill(engine, params, cfg, spec, x, positions, cache)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs = [out[:, -1].float()]
        for i in range(steps):
            pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
            o, _ = blocks.block_decode(engine, params, cfg, spec, toks[i], pos, cache)
            outs.append(o.float())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if backend == "cuda":
            launches, variants = gemm_cuda.launches, dict(gemm_cuda.variants)
            times = {"prefill_ms": (t1 - t0) * 1e3,
                     "decode_step_ms": (t2 - t1) * 1e3 / steps}
        results[backend] = {"prefill": out.float(), "decode": torch.stack(outs[1:]),
                            "conv": cache["conv"].clone(), "ssm": cache["ssm"].clone()}
        del cache, out, outs
        torch.cuda.empty_cache()
    expect = dict.fromkeys(gemm_cuda.variants, 0)
    for m, prompt, n in ((b * s, True, 1), (b, False, steps)):
        for a, w in layer_gemms(torch, cfg, spec, m, prompt, batch=b):
            expect[gemm_variant(a, w)] += n
    shapes = {"prefill": (b, s, cfg.d_model), "decode": (steps, b, cfg.d_model),
              "conv": (b, cfg.mamba.d_conv - 1, 2 * cfg.d_model),
              "ssm": (b, 2 * cfg.d_model, cfg.mamba.d_state)}

    def gap(backend):
        cmp = {}
        for k, shape in shapes.items():
            a, r = results[backend][k], results["ref"][k]
            if tuple(a.shape) != shape or not bool(torch.isfinite(a).all()):
                fail(f"mamba block: {backend} {k} of shape {tuple(a.shape)} "
                     f"(expected {shape}) or not finite")
            d = (a - r).abs()
            absmax = float(r.abs().max())
            cmp[k] = {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
                      "ref_absmax": absmax, "max_share": float(d.max()) / absmax,
                      "mean_share": float(d.mean()) / absmax,
                      "max_limit": BLOCK_RTOL * absmax,
                      "mean_limit": BLOCK_MEAN_RTOL * absmax}
        return cmp

    cmp = gap("cuda")
    faults = {f: gap(f"fault {f}") for f in GEMM_FAULTS}
    out = {"params": n_params, "batch": b, "prompt_len": s, "steps": steps,
           "gemm_launches": launches, "gemm_variants": variants,
           "expected_variants": expect, "cuda_vs_ref": cmp,
           "faults_vs_ref": faults, **times}
    print(f"mamba block: jamba-1.5-large-398b position 0 (mamba, dense FFN) "
          f"d={cfg.d_model} params={n_params} B={b} S={s} steps={steps}: "
          f"{json.dumps(out)}", flush=True)
    if variants != expect or launches != sum(expect.values()):
        fail(f"mamba block: gemm launches {variants}, expected {expect}")
    for k, c in cmp.items():
        if not within_limits(c):
            fail(f"mamba block: {k} of the two engines disagree: {c}")
    for f, fc in faults.items():
        if all(within_limits(c) for c in fc.values()):
            fail(f"mamba block: the check does not reject the planted GEMM "
                 f"fault {f!r}: {json.dumps(fc)}")
    return out


# Phase 3b: the served models whose prompts are not tokens alone, at full
# width (bf16, random weights drawn on the card from seed 0), through
# LM.prefill and LM.decode_step (the port's ServeSession, as the
# reference's, takes token prompts only). Four sequences, one in each slot
# of one cache: internvl2-1b behind 256 vision embeddings (one 448 x 448
# image after InternVL2's pixel shuffle), a VLM answering a question about
# an image; whisper-large-v3 over the 1500 encoder frames of a 30 s audio
# window, with text prompts from the start-of-transcript sequence up to
# whisper's longest previous-text prompt (224), max_len its text context.
EMBED_MODELS = (
    dict(arch="internvl2-1b", text_lens=(16, 64, 200, 512), max_len=1024),
    dict(arch="whisper-large-v3", text_lens=(4, 16, 64, 224), max_len=448,
         enc_len=1500),
)
EMBED_STEPS = 16


def embed_inputs(torch, cfg, gen, enc_len: int = 0) -> dict:
    """The stub frontends' embeddings of one sequence, standard normal in
    the compute dtype (as tests/test_models.py: make_batch makes them),
    drawn from ``gen`` on its device: the vision prefix's rows, or the
    encoder's ``enc_len`` audio frames."""
    shapes = {}
    if cfg.vision_prefix:
        shapes["vision_embeds"] = (1, cfg.vision_prefix, cfg.d_model)
    if cfg.enc_dec:
        shapes["audio_embeds"] = (1, enc_len, cfg.d_model)
    return {k: torch.randn(v, generator=gen, device=gen.device).to(cfg.cdtype)
            for k, v in shapes.items()}


def serve_embeds(torch, model, params, prompts, extras, steps: int, max_len: int,
                 enc_len: int = 0) -> dict:
    """Each prompt (tokens with its ``extras`` embeddings) prefilled on its
    own into its slot's view of one batched cache, zeroed first (as the
    port's ServeSession admits a request), then ``steps`` greedy decode
    steps for every slot at its own position (past the vision prefix).
    Each prefill and step is timed on the host clock to the copy of its
    sampled tokens to the host, which waits for the device. Returns the
    times, the cache and the slots' last tokens and positions."""
    cfg, dev = model.cfg, model.device
    b = len(prompts)
    cache = model.init_cache(b, max_len, enc_len=enc_len)
    last = np.zeros(b, np.int32)
    pos = np.zeros(b, np.int32)
    prefill_ms, step_ms = [], []
    for slot, (prompt, extra) in enumerate(zip(prompts, extras)):
        t0 = time.perf_counter()
        view = tuple({k: v[:, slot:slot + 1] for k, v in c.items()} for c in cache)
        for c in view:
            for v in c.values():
                v.zero_()
        batch = {"tokens": torch.as_tensor(prompt[None], device=dev), **extra}
        logits, _ = model.prefill(params, batch, view)
        last[slot] = int(torch.argmax(logits, -1)[0])
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        pos[slot] = cfg.vision_prefix + len(prompt)

    def step():
        nonlocal last
        logits, _ = model.decode_step(params, torch.as_tensor(last, device=dev),
                                      torch.as_tensor(pos, device=dev), cache,
                                      enc_len=enc_len)
        last = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
        pos[:] += 1

    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return {"prefill_ms": prefill_ms, "decode_step_ms": step_ms, "cache": cache,
            "step": step}


def run_embed_serve(torch, summary: dict, arch: str, text_lens, max_len: int,
                    enc_len: int = 0) -> dict:
    """One model of EMBED_MODELS at full width: ``serve_embeds`` with the
    launch counts zeroed just before and read just after, held exactly to
    ``expected_launches``; then one request through ArcaneEngine("cuda")
    and ("ref") (``check_logits``: bf16 and an f32 copy of the weights),
    the encoder's host clock beside a prefill's (whisper), the profiler
    over the longest prompt's prefill and over three decode steps, peak
    memory, and the weights' elements beside the reference formula's
    ``param_count``."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import ArcaneEngine
    from repro_torch.models.transformer import LM, tree_leaves
    cfg = get_config(arch)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = LM(cfg, ArcaneEngine("cuda"), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init_params(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in text_lens]
    extras = [embed_inputs(torch, cfg, gen, enc_len) for _ in prompts]
    print(f"serve: {cfg.name} layers={cfg.n_layers} enc_layers={cfg.n_enc_layers} "
          f"d={cfg.d_model} vocab={cfg.vocab} params={n_params} "
          f"param_count()={cfg.param_count()} init_s={init_s:.2f}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    one_step = expected_launches(torch, cfg, [], 1, len(prompts), enc_len)
    one_prompt = {n: expected_launches(torch, cfg, [n], 0, 1, enc_len)[0]
                  for n in text_lens}
    run, counts, variants = counted_run(
        torch, cfg,
        lambda: serve_embeds(torch, model, params, prompts, extras, EMBED_STEPS,
                             max_len, enc_len),
        lambda _: (*expected_launches(torch, cfg, text_lens, EMBED_STEPS,
                                      len(prompts), enc_len),
                   f"(prompts={len(prompts)} decode_steps={EMBED_STEPS}; a decode "
                   f"step {one_step[0]} {one_step[1]}; a prompt by text length "
                   f"{one_prompt})"))
    peak = torch.cuda.max_memory_allocated()
    steps_ms = run["decode_step_ms"]
    metrics = {
        "prompt_lens": list(text_lens), "vision_prefix": cfg.vision_prefix,
        "enc_len": enc_len, "decode_steps": EMBED_STEPS,
        "decode_step_ms": statistics.median(steps_ms),
        "decode_step_ms_all": steps_ms,
        "tokens_per_s": len(prompts) * 1e3 / statistics.median(steps_ms),
        "prefill_ms": run["prefill_ms"],
        "max_memory_allocated": peak, "params": n_params,
        "param_count_formula": cfg.param_count(), "init_s": init_s,
        "launches": counts, "variants": variants,
        "launches_per_step": one_step[0], "launches_per_prompt": one_prompt,
    }
    if cfg.enc_dec:
        # the encoder alone, from a synchronize before it to one after it,
        # beside the whole prefill of the same sequence
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model._encoder(params, extras[-1])
        torch.cuda.synchronize()
        metrics["encoder_ms"] = (time.perf_counter() - t0) * 1e3
        metrics["encoder_share_of_prefill"] = metrics["encoder_ms"] / run["prefill_ms"][-1]
    print(f"serve: {cfg.name} " + " ".join(
        f"{k}={v}" for k, v in metrics.items()
        if k not in ("launches", "variants", "decode_step_ms_all")), flush=True)
    metrics["greedy_agreement"] = check_logits(torch, summary, cfg, params, prompts[0],
                                               "ref", extras[0])
    metrics["prefill_profile"] = profile_prefill(torch, model, params, cfg.name,
                                                 max(text_lens), extras[-1])
    metrics["decode_profile"] = profile_steps(torch, run["step"], 3, cfg.name)
    return metrics


def run_decode_host(torch, arch: str, steps: int = 30, warm: int = 3) -> dict:
    """The host clock of the serving path's batched decode step: ``arch``
    at full width (random weights from seed 0) through the port's launcher,
    4 slots live with 256-token prompts, each step timed from its call to
    the card's end; the median, least and most of ``steps`` steps after
    ``warm``."""
    from repro_torch.launch import serve as launcher
    from repro_torch.serving.engine import ServeSession
    args = launcher.parse_args(["--arch", arch, "--slots", "4", "--max-len",
                                "1024", "--seed", "0", "--backend", "cuda"])
    model, params = launcher.build(args)
    sess = ServeSession(model, params, max_slots=args.slots, max_len=args.max_len,
                        seed=args.seed)
    rng = np.random.default_rng(1)
    for _ in range(args.slots):
        sess.submit(rng.integers(0, model.cfg.vocab, 256),
                    max_new_tokens=warm + steps + 2)
    sess.step()                       # admits (prefills) every request
    for _ in range(warm):
        sess.step()
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        sess.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"median_ms": statistics.median(times), "min_ms": min(times),
           "max_ms": max(times), "steps": steps}
    print(f"decode_host: {model.cfg.name} {args.slots} slots: step_ms median="
          f"{out['median_ms']:.2f} min={out['min_ms']:.2f} max={out['max_ms']:.2f} "
          f"({steps} steps, host clock)", flush=True)
    return out


def profile_prefill(torch, model, params, name: str, prompt_len: int = 512,
                    extra=None) -> dict:
    """torch.profiler over one prefill of a 512-token prompt at batch 1, as
    the session admits a request (in a ``profile_window``; with ``extra``,
    the stub frontends' embeddings of one sequence, behind the vision
    prefix or with the encoder): the card's busy time, its idle share of
    the host clock, and device time by kernel: the wgmma GEMM, the other
    GEMM variants (the unembed's GEMV; jamba-smoke's wmma and GEMV), the
    mma flash attention, and the rest. Fails unless the profiler saw a
    device event for every launch of the serving kernels."""
    rng = np.random.default_rng(2)
    extra = extra or {}
    batch = {"tokens": torch.as_tensor(rng.integers(0, model.cfg.vocab, (1, prompt_len)),
                                       device=model.device), **extra}
    enc = extra["audio_embeds"].shape[1] if "audio_embeds" in extra else 0
    cache = model.init_cache(1, model.cfg.vision_prefix + prompt_len + 8, enc_len=enc)
    model.prefill(params, batch, cache)          # warm
    torch.cuda.synchronize()
    before = serve_launches()
    with profile_window(torch) as prof:
        t0 = time.perf_counter()
        model.prefill(params, batch, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del cache
    out = busy_share(prof, wall_ms, 1, "prefill", exclude=("spin_kernel",))
    groups = {"gemm_wgmma": 0.0, "gemm_other": 0.0, "flash_mma": 0.0, "rest": 0.0}
    for kname, ms in device_ms(prof, exclude=("spin_kernel",)).items():
        ids = set(IDENT.findall(kname))
        key = "gemm_wgmma" if "gemm_wgmma_kernel" in ids else \
            "gemm_other" if ids & set(SERVE_KERNEL_NAMES["gemm_cuda"]) else \
            "flash_mma" if "flash_mma_kernel" in ids else "rest"
        groups[key] += ms
    out.update(prompt_len=prompt_len, wall_ms_per_token=wall_ms / prompt_len,
               device_ms_by_kernel=groups,
               **serve_events_seen(prof, before, f"{name} prefill"))
    print(f"profile: {name} prefill {json.dumps(out)}", flush=True)
    return out


def profile_decode(torch, sess, max_len: int, name: str, steps: int = 3) -> dict:
    """torch.profiler over a few batched decode steps of the session (all 4
    slots live; in a ``profile_window``): the card's busy time, its idle
    share of the host clock, the kernels that take the most device time,
    and device time per step by kernel: the GEMV (gemv_n, gemv_t), decode
    attention (split and merge kernels) and the rest. Fails unless the
    profiler saw a device event for every launch of the serving kernels."""
    rng = np.random.default_rng(1)
    for _ in range(sess.max_slots):
        sess.submit(rng.integers(0, sess.model.cfg.vocab, max_len // 4),
                    max_new_tokens=steps + 2)
    sess.step()                       # admits (prefills) every request
    out = profile_steps(torch, sess.step, steps, name)
    sess.run_to_completion()
    return out


def profile_steps(torch, step, steps: int, name: str) -> dict:
    """torch.profiler over ``steps`` calls of ``step``, one batched decode
    step each (in a ``profile_window``); what ``profile_decode`` reads."""
    torch.cuda.synchronize()
    before = serve_launches()
    with profile_window(torch) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    seen = serve_events_seen(prof, before, f"{name} decode")
    out = busy_share(prof, wall_ms, steps, "step", exclude=("spin_kernel",))
    groups = {"gemv": 0.0, "decode_attention": 0.0, "rest": 0.0}
    for kname, ms in device_ms(prof, exclude=("spin_kernel",)).items():
        ids = set(IDENT.findall(kname))
        key = "gemv" if ids & {"gemv_n_kernel", "gemv_t_kernel"} else \
            "decode_attention" if ids & {"split_kernel", "split_wide_kernel",
                                         "merge_kernel"} else "rest"
        groups[key] += ms / steps
    out.update(device_ms_per_step_by_kernel=groups, **seen)
    print(f"profile: {name} decode {json.dumps(out)}", flush=True)
    return out


# the port's serving kernels by the names the profiler gives them: one
# device event of these for each launch of the wrapper (decode attention's
# merge kernel, which follows a split kernel, is left out)
SERVE_KERNEL_NAMES = {
    "gemm_cuda": ("gemm_fma_kernel", "gemm_wgmma_kernel", "gemm_wmma_bf16_kernel",
                  "gemv_n_kernel", "gemv_t_kernel"),
    "flash_attention_cuda": ("flash_kernel", "flash_mma_kernel"),
    "decode_attention_cuda": ("split_kernel", "split_wide_kernel"),
}
IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def serve_launches() -> dict:
    """The serving kernels' launch counts so far, by wrapper."""
    from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.gemm.kernel import gemm_cuda
    return {w.__name__: w.launches
            for w in (gemm_cuda, flash_attention_cuda, decode_attention_cuda)}


def serve_events_seen(prof, before: dict, what: str) -> dict:
    """The serving kernels' launches since ``before`` against the device
    events of those kernels the profile holds, by wrapper; fails where they
    differ, or where a window with launches read no device time."""
    from torch.autograd import DeviceType
    launched = {w: n - before[w] for w, n in serve_launches().items()}
    seen = dict.fromkeys(SERVE_KERNEL_NAMES, 0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ids = set(IDENT.findall(e.name))
        for w, names in SERVE_KERNEL_NAMES.items():
            if ids & set(names):
                seen[w] += 1
    out = {"kernel_launches": launched, "kernel_events": seen, **launch_record(prof)}
    if seen != launched or not device_ms(prof, exclude=("spin_kernel",)):
        fail(f"profile: {what}: the profiler saw {seen} device events of the "
             f"serving kernels for {launched} launches")
    return out


def device_ms(prof, exclude=()) -> dict:
    """Device time (ms) by kernel name, from the device's own events only:
    an aten op's row repeats the time of the kernels it launched. Kernels
    whose name holds a string of ``exclude`` are left out."""
    from torch.autograd import DeviceType
    dev = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0 and not any(x in evt.key for x in exclude):
            dev[evt.key] = dev.get(evt.key, 0.0) + us / 1e3
    return dev


def busy_share(prof, wall_ms: float, n: int, unit: str, exclude=()) -> dict:
    """The card's busy time per unit of work from a profile, its idle share
    of the host clock, and the kernels that take the most device time."""
    dev = device_ms(prof, exclude)
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    return {"steps" if unit == "step" else "passes": n,
            f"wall_ms_per_{unit}": wall_ms / n,
            f"device_busy_ms_per_{unit}": busy / n,
            "device_idle_share": (1 - busy / wall_ms) if busy else None,
            f"top_device_ms_per_{unit}": [(k[:60], v / n) for k, v in top]}


# ---------------------------------------------------------------- phase 5
# granite-moe-1b-a400m trained at full width through the port's launcher,
# the step held against an f32 copy, a resume, and the trained weights
# served through the kernels from their checkpoint.
TRAIN_ARCH = "granite-moe-1b-a400m"
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--batch", "8", "--seq", "512",
              "--microbatches", "2", "--lr", "3e-4", "--device", "cuda"]
TRAIN_STEPS = 6
RESUME_LAYERS = 4             # the resume's cut: 24 layers' state is ~21 GB of .npz
SERVE_TRAINED_LENS = (16, 64, 200, 512)
SERVE_TRAINED_MAX_LEN = 1024
# The step of the bf16 model against the same step on an f32 copy of its
# weights (same batch), part by part (``_parts``, ``grad_readings``), and
# its microbatch sum against the f64 sum of the same microbatch grads. Each
# limit sits between the sound step's reading on the H100 and the planted
# faults' (TRAIN_FAULTS), which the check must reject; the readings are the
# same in every run (a seeded path). Each part's gain is read against the
# limit of its kind, set from the sound step's readings of that kind
# (NVIDIA H100 80GB HBM3, largest |gain - 1| over the 24 layers):
#   "gain": every part but those below (sound: the experts' down 4.0e-3,
#     attention's q 3.5e-3, k 3.1e-3, the experts' gate 2.9e-3, up 2.8e-3,
#     ln1 1.6e-3, v and o 9e-4, the embedding's other rows 3.8e-4, the
#     final norm 1e-5);
#   "gain_router": the router and the MoE's input norm (ln2), whose grads
#     pass through the top-k choice (sound 9.0e-3 and 1.0e-2: a 1% fault
#     there is below what an f32 copy resolves, hence the router's x1.03);
#   "gain_repeated": the embedding rows of tokens the batch repeats
#     REPEATED times or more (sound 1.8e-2). Their bf16 grad sums a token's
#     positions in bf16 one by one (the index backward, as the reference's
#     scatter-add does) and those sums stall as they grow; the same step
#     with the index sums in f32 (``f32_index_sums``) reads 1.2e-4 there
#     and must read within "gain".
# The rest, sound: loss 1.4e-5, grad norm 5.1e-3 (1.5e-4 with the index
# sums in f32), the largest relative gap 0.044 (the experts' gate, layer
# 20), the microbatch sum 2.8e-8.
GRAD_LIMITS = {"loss_rel": 1e-3, "gnorm_rel": 2e-2, "gain": 5e-3,
               "gain_router": 1.5e-2, "gain_repeated": 5e-2, "rel": 0.1,
               "acc_rel": 1e-5}
REPEATED = 32
ROUTED = ("/ffn/router/w", "/ln2/scale")
# the planted faults: the aux loss left out of the loss; one layer's grads
# x1.01; the embedding's grad x1.01; one layer's ln1 grad x1.01; one
# layer's router grad x1.03; the microbatch sum done in bf16
TRAIN_FAULTS = ("no_aux", "layer_x1.01", "embed_x1.01", "ln1_x1.01",
                "router_x1.03", "bf16_sum")
FAULT_LAYER = 5
# The resumed run's losses against the straight run's, relative. On the
# H100 they read equal bit for bit (the index sums of this path's backward
# add in a fixed order there); an index sum by atomics would add in
# another order from run to run, so the limit asks for no bit equality.
# (Each step's batch is held apart against the stream's ``batch_at``.)
RESUME_RTOL = 1e-5


def train_flops(cfg, tokens: int) -> tuple[int, int]:
    """A step's model FLOPs, 6 × the params a token touches × tokens
    (attention's own products left out), and remat's second forward of
    the blocks (2 × their params a token touches × tokens) apart."""
    n = cfg.active_param_count()
    n_blocks = n - cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return 6 * n * tokens, 2 * n_blocks * tokens


def train_full_width(torch, ckpt_dir: Path) -> dict:
    """(a) TRAIN_STEPS steps of granite-moe-1b-a400m at full width through
    ``launch/train.run``, checkpointing into ``ckpt_dir`` (removed after):
    each step's loss, grad norm, lr and ms (host clock to the loss on the
    host), tokens/s over steps 2 on, peak memory, the model FLOPs' shares
    of the bf16 and f32 peaks; ``run_s`` includes the checkpoint's save.
    Fails on a value that is not finite, on a last loss not below the first
    or where the last step's checkpoint is missing."""
    import shutil
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    cfg = get_config(TRAIN_ARCH)
    argv = TRAIN_ARGV + ["--steps", str(TRAIN_STEPS), "--ckpt-dir", str(ckpt_dir)]
    args = launcher.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = launcher.run(argv)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    saved = CheckpointManager(str(ckpt_dir)).latest_step()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if saved != TRAIN_STEPS:
        fail(f"train: {cfg.name}: the run's checkpoint is at step {saved}")
    steps = res["steps"]
    for s in steps:
        print(f"train: {cfg.name} step {s['step']} loss {s['loss']:.6f} "
              f"grad_norm {s['grad_norm']:.6f} lr {s['lr']:.4e} ms {s['ms']:.1f}",
              flush=True)
    vals = [v for s in steps for v in (s["loss"], s["grad_norm"], s["lr"])]
    if len(steps) != TRAIN_STEPS or not all(math.isfinite(v) for v in vals):
        fail(f"train: {cfg.name}: {len(steps)} steps, values not all finite: {vals}")
    if steps[-1]["loss"] >= steps[0]["loss"]:
        fail(f"train: {cfg.name}: the loss did not fall: {res['history']}")
    tokens = args.batch * args.seq
    later = steps[1:]
    step_s = statistics.median(s["ms"] for s in later) / 1e3
    model_flops, remat_flops = train_flops(cfg, tokens)
    out = {"steps": steps, "run_s": run_s, "tokens_per_step": tokens,
           "tokens_per_s": tokens * len(later) / (sum(s["ms"] for s in later) / 1e3),
           "step_ms_median": step_s * 1e3, "max_memory_allocated": peak,
           "model_flops_per_step": model_flops, "remat_flops_per_step": remat_flops,
           "model_flops_share_bf16_peak": model_flops / step_s / PEAK["bfloat16"],
           "model_flops_share_f32_peak": model_flops / step_s / PEAK["float32"],
           "with_remat_share_f32_peak": (model_flops + remat_flops) / step_s
           / PEAK["float32"]}
    print(f"train: {cfg.name} " + " ".join(
        f"{k}={v}" for k, v in out.items() if k != "steps"), flush=True)
    return out


class _NoAux:
    """A model whose loss leaves the MoE aux loss out (a planted fault)."""

    def __init__(self, model):
        self.model, self.engine = model, model.engine

    def loss(self, params, batch):
        _, metrics = self.model.loss(params, batch)
        return metrics["ce"], metrics


def _walk(tree, path=""):
    """(path, leaf) of every leaf, the path's keys and indices joined by
    "/" (as the checkpoint's keys)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def _parts(grads, tokens) -> dict:
    """The gradient tree cut into the parts the check reads: each leaf
    outside the blocks whole, but the embedding table by rows: the rows of
    tokens that ``tokens`` holds fewer than REPEATED times (unseen ones
    included) and the rows of the others (``[repeated]``); each block leaf
    layer by layer (``blocks/0/ffn/router/w[5]``)."""
    parts = {}
    for path, leaf in _walk(grads):
        if path.startswith("blocks/"):
            for i in range(leaf.shape[0]):
                parts[f"{path}[{i}]"] = leaf[i]
        elif path == "embed/table":        # the table the tokens index
            rep = repeated_rows(tokens, leaf.shape[0])
            parts[f"{path}[rest]"] = leaf[~rep]
            parts[f"{path}[repeated]"] = leaf[rep]
        else:
            parts[path] = leaf
    return parts


def repeated_rows(tokens, n: int):
    """A mask of the ``n`` table rows: the tokens that ``tokens`` holds
    REPEATED times or more."""
    return tokens.reshape(-1).long().bincount(minlength=n) >= REPEATED


def gain_kind(part: str) -> str:
    """The GRAD_LIMITS key that holds a part's gain."""
    if part.endswith("[repeated]"):
        return "gain_repeated"
    if part.split("[")[0].endswith(ROUTED):
        return "gain_router"
    return "gain"


def grad_readings(torch, loss, grads, loss32, grads32, micro, tokens) -> dict:
    """One step's readings against the f32 copy's (``loss32``,
    ``grads32``): the loss's and the grad norm's relative gaps; for each
    part (``_parts``) the gain <g, g32> / <g32, g32> (``gain_by_part``: a
    scaled part reads its scale, noise averages out) and the relative gap
    |g - g32| / |g32| (``rel_by_part``); the largest |gain - 1| of each
    kind of part (``gain_kind``: ``gain``, ``gain_router``,
    ``gain_repeated``), the largest gap over every part (``rel``); and the
    microbatch sum against the f64 sum of the microbatch grads ``micro``
    that it summed (their mean), largest relative gap over leaves
    (``acc_rel``)."""
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.optim.adamw import global_norm
    f64 = torch.float64
    gn, gn32 = float(global_norm(grads)), float(global_norm(grads32))
    out = {"loss_rel": abs(float(loss) - float(loss32)) / abs(float(loss32)),
           "gnorm_rel": abs(gn - gn32) / gn32, "gain": 0.0, "gain_router": 0.0,
           "gain_repeated": 0.0, "rel": 0.0, "acc_rel": 0.0, "worst": {},
           "gain_by_part": {},
           "rel_by_part": {}}
    p32 = _parts(grads32, tokens)
    for name, g in _parts(grads, tokens).items():
        a, b = g.to(f64), p32[name].to(f64)
        nn = float(b.square().sum())
        if nn == 0:
            continue
        gain = float((a * b).sum()) / nn
        rel = math.sqrt(float((a - b).square().sum()) / nn)
        out["gain_by_part"][name], out["rel_by_part"][name] = gain, rel
        for k, v in ((gain_kind(name), abs(gain - 1)), ("rel", rel)):
            if v >= out[k]:
                out[k], out["worst"][k] = v, name
    for (path, g), *ms in zip(_walk(grads), *map(tree_leaves, micro)):
        ref = sum(m.to(f64) for m in ms) / len(ms)
        nn = float(ref.square().sum())
        if nn:
            v = math.sqrt(float((g.to(f64) - ref).square().sum()) / nn)
            if v >= out["acc_rel"]:
                out["acc_rel"], out["worst"]["acc_rel"] = v, path
    return out


def within_grad_limits(r: dict, limits: dict) -> bool:
    return all(r[k] <= lim for k, lim in limits.items())


def step_grads_and_micro(model, params, batch, microbatches: int):
    """``train/step.step_grads`` → (loss, grads, the grads of each
    microbatch that it summed), the last taken from its own calls of
    ``loss_and_grads``."""
    import repro_torch.train.step as step
    micro, real = [], step.loss_and_grads

    def spy(*a):
        out = real(*a)
        micro.append(out[2])
        return out

    step.loss_and_grads = spy
    try:
        loss, _, grads = step.step_grads(model, params, batch, microbatches)
    finally:
        step.loss_and_grads = real
    return loss, grads, micro


@contextlib.contextmanager
def index_sums_in_f32():
    """While the block runs, the model's embedding gathers from an f32
    widening of its table, so that the gather's backward sums a token's
    positions in f32 and rounds to the table's dtype once."""
    import repro_torch.models.transformer as transformer
    real = transformer.embed

    def embed(params, tokens, *, scale=False):
        table = params["table"]
        return real({"table": table.float()}, tokens, scale=scale).to(table.dtype)

    transformer.embed = embed
    try:
        yield
    finally:
        transformer.embed = real


def train_grad_check(torch, model, params, batch, microbatches: int = 2,
                     limits: dict | None = None) -> dict:
    """(b) A step's grads of the bf16 ``model`` against the same step on an
    f32 copy of its weights (same batch), with the readings of
    ``grad_readings`` for the sound step, for the same step with the
    embedding's index sums in f32 (``f32_index_sums``) and for each planted
    fault of TRAIN_FAULTS. With ``limits``: fails unless the sound step is
    within every one, the f32 index sums' repeated rows within "gain" too,
    and each fault outside at least one."""
    import dataclasses
    from repro_torch.core.engine import ArcaneEngine
    from repro_torch.models.transformer import LM, tree_map
    from repro_torch.train.step import step_grads
    cfg = model.cfg
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    model32 = LM(cfg32, ArcaneEngine("ref"), device=model.device)
    params32 = tree_map(lambda x: x.float(), params)
    t0 = time.perf_counter()
    loss32, _, grads32 = step_grads(model32, params32, batch, microbatches)
    del params32
    loss, grads, micro = step_grads_and_micro(model, params, batch, microbatches)
    tokens = batch["tokens"]
    readings = {"sound": grad_readings(torch, loss, grads, loss32, grads32, micro,
                                       tokens)}
    with index_sums_in_f32():
        r = step_grads_and_micro(model, params, batch, microbatches)
    readings["f32_index_sums"] = grad_readings(torch, r[0], r[1], loss32, grads32,
                                               r[2], tokens)
    del r
    layer = min(FAULT_LAYER, cfg.n_layers - 1)
    # the leaves each scaling fault picks, and its scale: a block leaf's
    # layer ``layer``, another leaf whole
    picks = {"layer_x1.01": (lambda p: p.startswith("blocks/"), 1.01),
             "embed_x1.01": (lambda p: p == "embed/table", 1.01),
             "ln1_x1.01": (lambda p: p.endswith("/ln1/scale"), 1.01),
             "router_x1.03": (lambda p: p.endswith("/router/w"), 1.03)}

    def scaled(g, pick, by):         # the picked leaves scaled, in f32
        out = []
        for path, x in _walk(g):
            if pick(path):
                x = x.float().clone()
                if path.startswith("blocks/"):
                    x[layer] *= by
                else:
                    x *= by
            out.append(x)
        it = iter(out)
        return tree_map(lambda _: next(it), g)

    # each fault where it would live in the code: no aux and the scalings
    # in the model's loss or gradients (the microbatches' own grads carry
    # them too), the bf16 sum in the step's sum over the microbatches
    for fault in TRAIN_FAULTS:
        if fault == "no_aux":
            fl, fg, fmicro = step_grads_and_micro(_NoAux(model), params, batch,
                                                  microbatches)
        elif fault in picks:
            pick, by = picks[fault]
            fl, fg = loss, scaled(grads, pick, by)
            fmicro = [scaled(m, pick, by) for m in micro]
        else:
            acc = tree_map(torch.zeros_like, micro[0])
            for m in micro:
                acc = tree_map(lambda a, g: a + g, acc, m)       # bf16 sums
            fl, fmicro = loss, micro
            fg = tree_map(lambda a: a.float() / microbatches, acc)
        readings[fault] = grad_readings(torch, fl, fg, loss32, grads32, fmicro,
                                        tokens)
        del fg, fmicro
    out = {"seconds": time.perf_counter() - t0, "readings": readings,
           "loss": float(loss), "loss32": float(loss32), "limits": limits,
           "repeated_tokens": int(repeated_rows(tokens, cfg.vocab).sum())}
    for k, r in readings.items():
        shown = {n: v for n, v in r.items() if not n.endswith("_by_part")}
        print(f"train: {cfg.name} grads {k} {json.dumps(shown)}", flush=True)
    if limits is not None:
        if not within_grad_limits(readings["sound"], limits):
            fail(f"train: {cfg.name}: the bf16 step and its f32 copy disagree: "
                 f"{readings['sound']} against {limits}")
        if not within_grad_limits(readings["f32_index_sums"],
                                  {**limits, "gain_repeated": limits["gain"]}):
            fail(f"train: {cfg.name}: with the index sums in f32 the step still "
                 f"disagrees with its f32 copy: {readings['f32_index_sums']}")
        for fault in TRAIN_FAULTS:
            if within_grad_limits(readings[fault], limits):
                fail(f"train: {cfg.name}: the step's check does not reject the "
                     f"planted fault {fault!r}: {readings[fault]}")
    return out


@contextlib.contextmanager
def watched_steps(launcher, stop_after: int | None = None):
    """While the block runs, each train step the launcher makes is wrapped:
    it records its batch's tokens (on the host) and the params it returns,
    and raises SIGTERM, the preemption path, once ``stop_after`` steps are
    done. Yields the record."""
    import signal
    from repro_torch.train.step import make_train_step
    seen = {"tokens": [], "params": None}

    def make(*a, **kw):
        step = make_train_step(*a, **kw)

        def watched(params, opt_state, batch):
            out = step(params, opt_state, batch)
            seen["tokens"].append(batch["tokens"].cpu().numpy())
            seen["params"] = out[0]
            if len(seen["tokens"]) == stop_after:
                signal.raise_signal(signal.SIGTERM)
            return out
        return watched

    launcher.make_train_step = make
    try:
        yield seen
    finally:
        launcher.make_train_step = make_train_step


def train_resume(torch, ckpt_dir: Path, rtol: float | None = None) -> dict:
    """(c) granite-moe-1b-a400m cut to RESUME_LAYERS layers
    (``launch/train.train`` on the cut config): 4 steps straight through
    against 2 steps stopped by SIGTERM (the preemption path: a checkpoint
    at the step boundary), then a new run that resumes from LATEST for 2
    more. Each step of both must take the stream's batch of its step
    (``batch_at``) and, with ``rtol``, the losses must agree within it.
    Returns the readings and the resumed run's trained params."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train as launcher
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=RESUME_LAYERS)
    args = launcher.parse_args(TRAIN_ARGV + ["--steps", "4"])
    with watched_steps(launcher) as seen_straight:
        straight = launcher.train(cfg, args)
    del seen_straight["params"]
    args = launcher.parse_args(TRAIN_ARGV + ["--steps", "4", "--ckpt-dir",
                                             str(ckpt_dir)])
    with watched_steps(launcher, stop_after=2) as seen_first:
        first = launcher.train(cfg, args)
    with watched_steps(launcher) as seen_second:
        second = launcher.train(cfg, args)
    resumed = first["steps"] + second["steps"]
    source = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch))
    batches_ok = all(
        len(seen) == 4 and all(np.array_equal(t, source.batch_at(i)["tokens"])
                               for i, t in enumerate(seen))
        for seen in (seen_straight["tokens"],
                     seen_first["tokens"] + seen_second["tokens"]))
    if [s["step"] for s in resumed] != [0, 1, 2, 3] or not batches_ok:
        fail(f"train: resume: a step took another batch than the stream's of "
             f"its step: {resumed} against {straight['steps']}")
    gaps = [abs(a["loss"] - b["loss"]) / abs(a["loss"])
            for a, b in zip(straight["steps"], resumed)]
    out = {"losses_straight": straight["history"],
           "losses_resumed": [s["loss"] for s in resumed], "loss_rel_gaps": gaps,
           "rtol": rtol}
    print(f"train: resume {json.dumps(out)}", flush=True)
    if rtol is not None and max(gaps) > rtol:
        fail(f"train: resume: the resumed run's losses leave {rtol}: {gaps}")
    return out, seen_second["params"]


def serve_prompts(torch, model, params, prompts, max_new: int, max_len: int):
    """The prompts served to completion by one ServeSession of 4 slots."""
    from repro_torch.serving.engine import ServeSession
    sess = ServeSession(model, params, max_slots=4, max_len=max_len)
    for p in prompts:
        sess.submit(p, max_new_tokens=max_new)
    sess.run_to_completion()
    return sess


def trained_prompts(cfg, lens) -> list:
    """Prompts of the given lengths from the synthetic stream the model was
    trained on (a step it never saw)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    toks = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=max(lens),
                                  global_batch=len(lens))).batch_at(10_000)["tokens"]
    return [toks[i, :n] for i, n in enumerate(lens)]


def serve_trained(torch, summary: dict, trained, ckpt_dir: Path) -> dict:
    """(d) The resumed run's last checkpoint restored into a fresh LM
    (``CheckpointManager.restore``; bit for bit the trained params), then
    served through ArcaneEngine("cuda"): 4 requests of 16 new tokens,
    launch counts exact (``counted_run``), cuda against ref logits under
    phase 3's limits (``check_logits``)."""
    import dataclasses
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.engine import ArcaneEngine
    from repro_torch.models.transformer import LM, tree_leaves, tree_map
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=RESUME_LAYERS)
    mgr = CheckpointManager(str(ckpt_dir))
    step = mgr.latest_step()
    like = {"params": tree_map(lambda t: torch.empty_like(t, device="meta"), trained)}
    params = mgr.restore(step, like, device="cuda")[0]["params"]
    same = all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(tree_leaves(params), tree_leaves(trained)))
    if not same:
        fail("train: the restored params differ from the trained ones")
    model = LM(cfg, ArcaneEngine("cuda"), device="cuda")
    prompts = trained_prompts(cfg, SERVE_TRAINED_LENS)

    def expect(sess):
        done = sess.finished
        if len(done) != len(prompts) or any(len(r.out_tokens) != 16 for r in done):
            fail(f"train: serve: {len(done)} requests finished")
        n = sess.stats["decode_steps"]
        return (*expected_launches(torch, cfg, [len(r.prompt) for r in done], n, 4),
                f"(restored step {step}: prompts={len(done)} decode_steps={n})")

    sess, counts, variants = counted_run(
        torch, cfg, lambda: serve_prompts(torch, model, params, prompts, 16,
                                          SERVE_TRAINED_MAX_LEN), expect)
    agree = check_logits(torch, summary, cfg, params, prompts[0])
    return {"restored_step": step, "restored_equal": same, "launches": counts,
            "variants": variants, "decode_steps": sess.stats["decode_steps"],
            "greedy_agreement": agree,
            "out_tokens": [r.out_tokens for r in sorted(sess.finished,
                                                        key=lambda r: r.uid)]}


TRAIN_LABELS = {"gemm": "engine GEMMs (projections, unembed)",
                "attention": "attention (the ref's chunked einsums)",
                "moe_experts": "MoE expert products", "moe_dispatch":
                "MoE dispatch and combine", "moe_router": "MoE router, top-k, aux",
                "optimizer": "AdamW update"}


@contextlib.contextmanager
def labelled_train_ops(torch, engine):
    """The engine's gemm and attention, the MoE's expert products,
    dispatch and combine, the MoE layer itself (its router, top-k and aux
    loss) and the optimizer's update, each under a ``train::<label>``
    record_function while the block runs (restored after), so that a
    profile can put each kernel under the op that launched it, in the
    forward pass or, through the autograd node's sequence number, in the
    backward pass."""
    import functools
    import repro_torch.models.blocks as blocks
    import repro_torch.models.moe as moe
    import repro_torch.train.step as step

    def wrap(label, fn):
        @functools.wraps(fn)
        def inner(*a, **kw):
            with torch.profiler.record_function(f"train::{label}"):
                return fn(*a, **kw)
        return inner

    patches = [(engine, "gemm", "gemm"), (engine, "attention", "attention"),
               (moe, "_expert_matmul", "moe_experts"),
               (moe, "_group_dispatch", "moe_dispatch"),
               (moe, "_group_combine", "moe_dispatch"), (blocks, "moe", "moe_router"),
               (step, "adamw_update", "optimizer")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, label in patches:
        setattr(obj, name, wrap(label, getattr(obj, name)))
    try:
        yield
    finally:
        for obj, name, fn in saved:
            if obj is engine:
                delattr(obj, name)          # the class's method again
            else:
                setattr(obj, name, fn)


def ms_by_label(prof, weight) -> dict:
    """``weight(event)`` (ms) of every CPU op of a profile, summed by the
    ``train::`` label of its nearest labelled ancestor; an op in the
    backward pass (under an autograd node, ``...Backward``) takes the label
    of the forward op whose sequence number the node carries. An op under
    no label counts as ``other``."""
    from torch.autograd import DeviceType
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    def label_of(e, fwd=None):
        while e is not None:
            if e.name.startswith("train::"):
                return e.name[len("train::"):]
            if fwd is not None and "Backward" in e.name and e.sequence_nr in fwd:
                return fwd[e.sequence_nr]
            e = e.cpu_parent
        return None

    fwd = {}
    for e in events:
        if e.sequence_nr >= 0 and "Backward" not in e.name:
            lab = label_of(e)
            if lab is not None:
                fwd.setdefault(e.sequence_nr, lab)
    out = dict.fromkeys([*TRAIN_LABELS, "other"], 0.0)
    for e in events:
        w = weight(e)
        if w:
            out[label_of(e, fwd) or "other"] += w
    return out


def profile_train_step(torch, model, params, batch, microbatches: int = 2) -> dict:
    """torch.profiler over one train step (the launcher's step function,
    after one step to warm it; in a ``profile_window``): the card's busy
    time and idle share, and device time by what launched it
    (``labelled_train_ops``, ``ms_by_label``)."""
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS)
    opt = adamw_init(opt_cfg, params)
    with labelled_train_ops(torch, model.engine):
        step = make_train_step(model, opt_cfg, microbatches=microbatches)
        params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        with profile_window(torch) as prof:
            t0 = time.perf_counter()
            step(params, opt, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    del opt
    # the labels' own device ranges (annotations spanning their kernels)
    # are left out with the primers
    skip = ("spin_kernel", "train::")
    out = busy_share(prof, wall_ms, 1, "step", exclude=skip)
    out["device_ms_by_op"] = ms_by_label(prof, lambda e: sum(
        k.duration for k in e.kernels if not any(x in k.name for x in skip)) / 1e3)
    print(f"profile: train step {json.dumps(out)}", flush=True)
    return out


def run_train(torch, summary: dict) -> dict:
    """Phase 5: (a) ``train_full_width``; (b) ``train_grad_check`` on seed
    0's weights and the launcher's first batch, then ``profile_train_step``
    on them; (c) ``train_resume``; (d) ``serve_trained``. Each part's state
    is freed before the next."""
    import gc
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.core.engine import ArcaneEngine
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.launch import train as launcher
    from repro_torch.models.transformer import LM
    ckpt = ROOT / "build" / "chip_smoke" / "train_ckpt"
    out = {}

    def free(what: str):
        gc.collect()
        torch.cuda.empty_cache()
        print(f"train: {what} done; {torch.cuda.memory_allocated()} bytes still "
              f"allocated", flush=True)

    shutil.rmtree(ckpt, ignore_errors=True)
    out["full_width"] = train_full_width(torch, ckpt)
    free("(a)")
    cfg = get_config(TRAIN_ARCH)
    args = launcher.parse_args(TRAIN_ARGV)
    model = LM(cfg, ArcaneEngine("ref"), device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    batch = to_device(SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                             global_batch=args.batch)).batch_at(0),
                      torch.device("cuda"))
    out["grad_check"] = train_grad_check(torch, model, params, batch,
                                         args.microbatches, GRAD_LIMITS)
    free("(b)")
    out["profile"] = profile_train_step(torch, model, params, batch, args.microbatches)
    del params
    free("the profile")
    out["resume"], trained = train_resume(torch, ckpt, RESUME_RTOL)
    free("(c)")
    out["serve"] = serve_trained(torch, summary, trained, ckpt)
    del trained
    shutil.rmtree(ckpt, ignore_errors=True)
    free("(d)")
    return out


# --------------------------------------------------------------- phase 5b
# The multi-device layer on one card: a world of one NCCL rank (the card
# has one GPU; the multi-rank checks are the CPU tests on gloo ranks), so
# every collective, DTensor redistribution and point-to-point call of the
# layer runs through NCCL. granite-moe-1b-a400m at full width, batch and
# sequence as phase 5.
MD_STEPS = 2                 # (a) the sharded step against the plain one
MD_COMPRESSED_STEPS = 6      # (b) compressed against uncompressed
MD_LOSS_GAP = 0.25           # (b) the reference's bound (tests/test_distributed.py:75)
# (b) each leaf of step 1: mean + residual against the f32 grad within one
# f32 ulp of the leaf's scale (exact in f32 but for the rounding of the
# sum), and |residual| within half a level plus the rounding of gf / scale
# and of q·scale (2^-16 of the scale covers both)
MD_RESIDUAL_SLACK = 2.0 ** -16
MD_FAULTS = ("payload_plus_one", "payload_plus_one_own_residual")
MD_PIPE = (64, 1024, 4)      # (c) rows, width, microbatches


def md_init(torch):
    """Joins a process group of one NCCL rank (a FileStore under build/);
    fails where NCCL does not initialise: no fallback."""
    import torch.distributed as dist
    store = ROOT / "build" / "chip_smoke" / "md_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                                rank=0, world_size=1)
        probe = torch.ones(4, device="cuda")
        dist.all_reduce(probe)
        torch.cuda.synchronize()
    except Exception as e:      # the phase needs NCCL
        fail(f"multi-device: NCCL did not initialise: {type(e).__name__}: {e}")
    print(f"multi-device: NCCL {torch.cuda.nccl.version()}, world 1, backend "
          f"{dist.get_backend()}", flush=True)


def md_timed(torch, step, *args) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def md_sharded_vs_plain(torch, model, opt_cfg, mesh, batches, microbatches) -> dict:
    """(a) MD_STEPS steps of the plain step (on plain tensors) and of the
    sharded step (params under ``param_pspecs``, the AdamW state under
    ``zero_pspecs`` on the (1, 1) mesh, ``grad_shardings=`` their ZeRO
    tree) from the same seed-0 weights on the same batches: the loss, the
    grad norm and every param leaf must carry the same bits."""
    from repro_torch.distributed.sharding import (distribute, param_pspecs,
                                                  to_shardings, zero_pspecs)
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import make_train_step

    def init():
        params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
        return params, adamw_init(opt_cfg, params)

    params, opt = init()
    step = make_train_step(model, opt_cfg, microbatches=microbatches)
    plain = []
    for b in batches:
        (params, opt, m), ms = md_timed(torch, step, params, opt, b)
        plain.append({"loss": m["loss"], "grad_norm": m["grad_norm"], "ms": ms})
    plain_params = tree_map(lambda t: t.cpu(), params)
    plain_peak = torch.cuda.max_memory_allocated()
    del params, opt
    gc_cuda(torch)
    params, opt = init()
    p_sh = to_shardings(param_pspecs(params, mesh), mesh)
    grad_sh = to_shardings(zero_pspecs(params, mesh), mesh)
    params = distribute(params, p_sh)
    opt = distribute(opt, to_shardings(zero_pspecs(opt, mesh), mesh))
    gc_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(model, opt_cfg, microbatches=microbatches,
                           grad_shardings=grad_sh)
    sharded = []
    for b in batches:
        (params, opt, m), ms = md_timed(torch, step, params, opt, b)
        sharded.append({"loss": m["loss"], "grad_norm": m["grad_norm"], "ms": ms,
                        "data_split": m["data_split"]})
    peak = torch.cuda.max_memory_allocated()
    same_metrics = all(torch.equal(a[k], b[k]) for a, b in zip(plain, sharded)
                       for k in ("loss", "grad_norm"))
    mine = tree_leaves(tree_map(lambda t: t.full_tensor(), params))
    same_params = all(a.dtype == b.dtype and torch.equal(a.cpu(), b)
                      for a, b in zip(mine, tree_leaves(plain_params)))
    leaf = params["blocks"][0]["ffn"]["gate"]
    out = {"losses": [float(r["loss"]) for r in sharded],
           "grad_norms": [float(r["grad_norm"]) for r in sharded],
           "plain_step_ms": [r["ms"] for r in plain],
           "sharded_step_ms": [r["ms"] for r in sharded],
           "data_split": [r["data_split"] for r in sharded],
           "same_bits_metrics": same_metrics, "same_bits_params": same_params,
           "leaves": len(mine), "expert_gate_placements": str(leaf.placements),
           "opt_expert_gate_placements":
               str(opt["master"]["blocks"][0]["ffn"]["gate"].placements),
           "plain_peak_bytes": plain_peak, "sharded_peak_bytes": peak}
    print(f"multi-device: (a) sharded vs plain step {json.dumps(out)}", flush=True)
    if not (same_metrics and same_params):
        fail(f"multi-device: (a) the sharded step's bits differ from the plain "
             f"step's: metrics {same_metrics}, params {same_params}")
    return out


def gc_cuda(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def quant_readings(torch, grads, err_in, means, residuals) -> dict:
    """Per leaf of a compressed all-reduce on one rank: the largest |mean +
    residual - (g + err)| in f32 ulps of the leaf's scale and the largest
    |residual| over the residual bound (scale × (1/2 + slack)); the worst of
    each over the leaves, and the same readings with each MD_FAULTS fault
    planted in the largest leaf (one element's payload a level up, with the
    sound residual; or with the residual of the faulty payload)."""
    from repro_torch.models.transformer import tree_leaves
    gs, ms, rs = tree_leaves(grads), tree_leaves(means), tree_leaves(residuals)
    es = tree_leaves(err_in) if err_in is not None else [None] * len(gs)

    def reading(g, e, m, r):
        gf = g.float() + (e if e is not None else 0.0)
        scale = torch.max(torch.abs(gf)) / 127.0 + 1e-30
        ulp = torch.nextafter(scale, torch.tensor(math.inf, device=scale.device)) - scale
        recon = float(torch.max(torch.abs(m + r - gf)) / ulp)
        bound = float(torch.max(torch.abs(r)) / (scale * (0.5 + MD_RESIDUAL_SLACK)))
        return recon, bound, gf, scale

    worst = {"recon_ulps": 0.0, "residual_over_bound": 0.0}
    big = max(range(len(gs)), key=lambda i: gs[i].numel())
    for i in range(len(gs)):
        recon, bound, gf, scale = reading(gs[i], es[i], ms[i], rs[i])
        worst["recon_ulps"] = max(worst["recon_ulps"], recon)
        worst["residual_over_bound"] = max(worst["residual_over_bound"], bound)
        if i != big:
            continue
        # a level up at an element whose residual is not above 0: its own
        # residual then lies a whole level or more from 0
        j = int(torch.argmin(rs[i].reshape(-1)))
        faults = {}
        m = ms[i].clone()
        m.view(-1)[j] += scale
        faults["payload_plus_one"] = reading(gs[i], es[i], m, rs[i])[:2]
        r = rs[i].clone()
        r.view(-1)[j] = gf.view(-1)[j] - m.view(-1)[j]
        faults["payload_plus_one_own_residual"] = reading(gs[i], es[i], m, r)[:2]
        del m, r
    worst["faults"] = {k: {"recon_ulps": v[0], "residual_over_bound": v[1]}
                       for k, v in faults.items()}
    return worst


def md_sound(r: dict) -> bool:
    return r["recon_ulps"] <= 1.0 and r["residual_over_bound"] <= 1.0


def md_compressed(torch, model, opt_cfg, group, batches) -> tuple:
    """(b) make_compressed_dp_step for MD_COMPRESSED_STEPS steps with
    compress=True and with compress=False from the same seed-0 weights:
    each step's ms and the share of it in the gradient all-reduce (host
    clock, the card synchronised around it); step 1's quantization
    readings (``quant_readings``) sound and every planted fault rejected;
    the last losses within MD_LOSS_GAP. Returns the readings and the
    compressed run's params."""
    import repro_torch.distributed.collectives as coll
    from repro_torch.distributed.collectives import (init_error_feedback,
                                                     make_compressed_dp_step)
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.optim.adamw import adamw_init
    runs = {}
    for compress in (True, False):
        params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
        opt = adamw_init(opt_cfg, params)
        err = init_error_feedback(params)
        name = "tree_compressed_psum" if compress else "tree_pmean"
        real = getattr(coll, name)
        seen = {"comm_ms": [], "readings": None}

        def watched(grads, group, err=None, real=real, seen=seen):
            first = seen["readings"] is None and compress
            if first and any(bool(e.any()) for e in tree_leaves(err)):
                fail("multi-device: (b) the first step's error feedback is not zero")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(grads, group, err) if compress else real(grads, group)
            torch.cuda.synchronize()
            seen["comm_ms"].append((time.perf_counter() - t0) * 1e3)
            if first:
                seen["readings"] = quant_readings(torch, grads, None, *out)
            return out

        setattr(coll, name, watched)
        torch.cuda.reset_peak_memory_stats()
        try:
            step = make_compressed_dp_step(model, opt_cfg, group, compress=compress)
            losses, ms = [], []
            for b in batches:
                (params, opt, err, m), t = md_timed(torch, step, params, opt, err, b)
                losses.append(float(m["loss"]))
                ms.append(t)
        finally:
            setattr(coll, name, real)
        runs[compress] = {"losses": losses, "step_ms": ms, "comm_ms": seen["comm_ms"],
                          "all_reduce_share": [c / t for c, t in zip(seen["comm_ms"], ms)],
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "readings": seen["readings"]}
        del opt, err
        if compress:
            trained = params
        del params
        gc_cuda(torch)
    out = {"compressed": runs[True], "uncompressed": runs[False],
           "last_loss_gap": abs(runs[True]["losses"][-1] - runs[False]["losses"][-1])}
    print(f"multi-device: (b) compressed DP {json.dumps(out)}", flush=True)
    rd = runs[True]["readings"]
    if not md_sound(rd):
        fail(f"multi-device: (b) step 1's quantization leaves its bound: {rd}")
    if any(md_sound(f) for f in rd["faults"].values()):
        fail(f"multi-device: (b) a planted fault passes the check: {rd['faults']}")
    if out["last_loss_gap"] >= MD_LOSS_GAP or not all(
            math.isfinite(v) for r in runs.values() for v in r["losses"]):
        fail(f"multi-device: (b) compressed and uncompressed runs part: {out}")
    return out, trained


def md_pipeline(torch, group) -> dict:
    """(c) pipeline_forward with one stage (tanh(h @ w), f32) equals the
    stage applied to the whole batch."""
    from repro_torch.distributed.pipeline import pipeline_forward
    rows, width, micro = MD_PIPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(width, width, device="cuda", generator=gen) / math.sqrt(width)
    x = torch.randn(rows, width, device="cuda", generator=gen)
    fn = lambda p, h: torch.tanh(h @ p)  # noqa: E731
    out = pipeline_forward(fn, w, x, group=group, n_micro=micro)
    err = float((out - fn(w, x)).abs().max())
    res = {"shape": list(out.shape), "max_abs_err": err, "atol": 1e-5}
    print(f"multi-device: (c) pipeline {json.dumps(res)}", flush=True)
    if err > 1e-5:
        fail(f"multi-device: (c) the one-stage pipeline leaves stage_fn(x): {res}")
    return res


def md_checkpoint_serve(torch, summary: dict, cfg, mesh, trained) -> dict:
    """(d) (b)'s compressed run's params saved (CheckpointManager: the
    rank gathers, rank 0 writes), restored with ``shardings=`` onto the
    (1, 1) mesh under ``param_pspecs`` (bit for bit the saved params), then
    served through ArcaneEngine("cuda") as phase 5 (d) serves: 4 requests
    of 16 new tokens, launch and variant counts exact, cuda vs ref logits
    under phase 3's limits."""
    import shutil
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.engine import ArcaneEngine
    from repro_torch.distributed.sharding import param_pspecs, to_shardings
    from repro_torch.models.transformer import LM, tree_leaves, tree_map
    ckpt = ROOT / "build" / "chip_smoke" / "md_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt))
    t0 = time.perf_counter()
    mgr.save(MD_COMPRESSED_STEPS, {"params": trained})
    save_s = time.perf_counter() - t0
    like = {"params": tree_map(lambda t: torch.empty_like(t, device="meta"), trained)}
    shard = {"params": to_shardings(param_pspecs(trained, mesh), mesh)}
    t0 = time.perf_counter()
    restored = mgr.restore(mgr.latest_step(), like, shardings=shard)[0]["params"]
    restore_s = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    same = all(type(r).__name__ == "DTensor" and r.dtype == t.dtype
               and torch.equal(r.full_tensor(), t)
               for r, t in zip(tree_leaves(restored), tree_leaves(trained)))
    if not same:
        fail("multi-device: (d) the restored params differ from the saved ones")
    params = tree_map(lambda t: t.full_tensor(), restored)
    del restored
    model = LM(cfg, ArcaneEngine("cuda"), device="cuda")
    prompts = trained_prompts(cfg, SERVE_TRAINED_LENS)

    def expect(sess):
        done = sess.finished
        if len(done) != len(prompts) or any(len(r.out_tokens) != 16 for r in done):
            fail(f"multi-device: (d) {len(done)} requests finished")
        n = sess.stats["decode_steps"]
        return (*expected_launches(torch, cfg, [len(r.prompt) for r in done], n, 4),
                f"(restored across the mesh: prompts={len(done)} decode_steps={n})")

    sess, counts, variants = counted_run(
        torch, cfg, lambda: serve_prompts(torch, model, params, prompts, 16,
                                          SERVE_TRAINED_MAX_LEN), expect)
    agree = check_logits(torch, summary, cfg, params, prompts[0])
    out = {"save_s": save_s, "restore_s": restore_s, "restored_equal": same,
           "launches": counts, "variants": variants,
           "decode_steps": sess.stats["decode_steps"], "greedy_agreement": agree}
    print(f"multi-device: (d) checkpoint and serve {json.dumps(out)}", flush=True)
    return out


def run_multi_device(torch, summary: dict) -> dict:
    """Phase 5b: on a world of one NCCL rank and its (1, 1) mesh,
    ``md_sharded_vs_plain`` (a), ``md_compressed`` (b), ``md_pipeline``
    (c) and ``md_checkpoint_serve`` (d); the phase's peak memory. The
    process group is destroyed at the end."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.engine import ArcaneEngine
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import LM
    from repro_torch.optim.adamw import AdamWConfig
    md_init(torch)
    try:
        gc_cuda(torch)
        torch.cuda.reset_peak_memory_stats()
        mesh = make_host_mesh(model_axis=1)
        group = mesh.get_group("data")
        cfg = get_config(TRAIN_ARCH)
        args = launcher.parse_args(TRAIN_ARGV)
        model = LM(cfg, ArcaneEngine("ref"), device="cuda")
        opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=MD_COMPRESSED_STEPS)
        source = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch))
        batches = [to_device(source.batch_at(i), torch.device("cuda"))
                   for i in range(MD_COMPRESSED_STEPS)]
        out = {"mesh": str(mesh)}
        out["sharded"] = md_sharded_vs_plain(torch, model, opt_cfg, mesh,
                                             batches[:MD_STEPS], args.microbatches)
        gc_cuda(torch)
        out["compressed"], trained = md_compressed(torch, model, opt_cfg, group,
                                                   batches)
        out["pipeline"] = md_pipeline(torch, group)
        out["serve"] = md_checkpoint_serve(torch, summary, cfg, mesh, trained)
        del trained
        # each part resets the peak for its own reading: the phase's is the
        # largest of theirs and of what ran since the last reset
        out["peak_bytes"] = max(
            torch.cuda.max_memory_allocated(), out["sharded"]["plain_peak_bytes"],
            out["sharded"]["sharded_peak_bytes"],
            *(out["compressed"][k]["peak_bytes"] for k in ("compressed", "uncompressed")))
        print(f"multi-device: peak {out['peak_bytes'] / 1e9:.2f} GB", flush=True)
    finally:
        dist.destroy_process_group()
    gc_cuda(torch)
    return out


# ---------------------------------------------------------------- phase 4
CNN_RUNS = [
    ["--size", "256", "--k", "3", "--dtype", "int8"],     # Listing 1, ReLU
    ["--size", "256", "--k", "7", "--dtype", "int8", "--slope", "0.125"],
    ["--size", "256", "--k", "3", "--dtype", "int32"],    # the 32-bit worst case
    ["--size", "226", "--k", "3", "--filters", "64", "--dtype", "bfloat16",
     "--slope", "0.125"],
]


# the conv_layer variant each CNN run must take, where the run fixes it
CNN_VARIANT = {"int32": "simt", "bfloat16 64": "mma"}


def run_cnn(torch) -> dict:
    """The CNN path through the launcher: per run, exactly 1 conv_layer, F
    maxpool and 1 leakyrelu launch per pass of the two legs, every
    conv_layer launch on the variant ``conv_variant`` picks (and on mma for
    the bf16 64-filter run, on simt for int32) and every maxpool launch on
    the one ``maxpool_plan`` picks for the run's maps (vector for the bf16
    run's 224 x 224 f32 maps, scalar for the 254 x 254 and 250 x 250
    int32 ones), fused == unfused, and fused == the plain conv_layer on the
    card."""
    from repro_torch.kernels.convlayer.kernel import conv_layer_cuda, conv_variant
    from repro_torch.kernels.convlayer.ref import conv_layer_ref
    from repro_torch.kernels.common import acc_dtype, sm_count
    from repro_torch.kernels.maxpool.kernel import maxpool_cuda, maxpool_plan
    from repro_torch.launch import cnn

    for w in cnn.WRAPPERS:
        w.launches = 0
    conv_layer_cuda.variants = dict.fromkeys(conv_layer_cuda.variants, 0)
    maxpool_cuda.variants = dict.fromkeys(maxpool_cuda.variants, 0)
    expect_total = {w.__name__: 0 for w in cnn.WRAPPERS}
    expect_variants = dict.fromkeys(conv_layer_cuda.variants, 0)
    # the op-by-op leg pools the F accumulator maps y[i] (16-byte aligned)
    expect_pool = dict.fromkeys(maxpool_cuda.variants, 0)
    runs = []
    for argv in CNN_RUNS:
        args = cnn.parse_args(argv + ["--backend", "cuda", "--seed", "0"])
        before = dict(conv_layer_cuda.variants)
        try:
            out = cnn.run(args)
        except AssertionError as e:
            fail(str(e))
        variants = {k: v - before[k] for k, v in conv_layer_cuda.variants.items()}
        variant = conv_variant(out["x"], out["f"])
        fixed = CNN_VARIANT.get(args.dtype) or CNN_VARIANT.get(f"{args.dtype} {args.filters}")
        if fixed and variant != fixed:
            fail(f"cnn: {' '.join(argv)}: conv_variant picks {variant}, not {fixed}")
        expect = {"conv_layer_cuda": 1, "maxpool_cuda": args.filters,
                  "leakyrelu_cuda": 1}
        for k, v in expect.items():
            expect_total[k] += v * out["passes"]
        expect_variants[variant] += out["passes"]
        side = args.size - args.k + 1
        pool = maxpool_plan(side, side, 2, 2, acc_dtype(out["x"].dtype).itemsize,
                            sm_count(out["x"].device)).variant
        expect_pool[pool] += args.filters * out["passes"]
        ref = conv_layer_ref(out["x"], out["f"], negative_slope=args.slope)
        fused = out["fused"]
        shape = (args.filters, (args.size - args.k + 1) // 2,
                 (args.size - args.k + 1) // 2)
        rec = {"case": " ".join(argv), "shape": list(fused.shape),
               "launches_per_pass": out["launches"], "passes": out["passes"],
               "conv_variant": variant, "conv_variants": variants,
               "max_abs_diff_unfused": out["max_abs_diff"],
               "max_abs_diff_plain": cnn.max_err(fused, ref),
               "fused_ms": out["fused_ms"], "unfused_ms": out["unfused_ms"],
               "unfused_over_fused": out["unfused_over_fused"]}
        runs.append(rec)
        print(f"cnn: {rec['case']}: fused {rec['fused_ms']:.4f} ms, unfused "
              f"{rec['unfused_ms']:.4f} ms, unfused/fused "
              f"{rec['unfused_over_fused']:.2f}; |fused-unfused| "
              f"{rec['max_abs_diff_unfused']}, |fused-plain| "
              f"{rec['max_abs_diff_plain']}; launches/pass {out['launches']}; "
              f"conv_layer variants {variants}", flush=True)
        if out["launches"] != expect:
            fail(f"cnn: {rec['case']}: launches {out['launches']}, expected {expect}")
        if variants != {k: (out["passes"] if k == variant else 0) for k in variants}:
            fail(f"cnn: {rec['case']}: conv_layer variants {variants}, expected "
                 f"{out['passes']} on {variant}")
        if tuple(fused.shape) != shape or fused.dtype != out["x"].dtype \
                or not bool(torch.isfinite(fused.float()).all()):
            fail(f"cnn: {rec['case']}: output {tuple(fused.shape)} "
                 f"{fused.dtype}, expected {shape}, finite")
        if not cnn.agree(fused, ref):
            fail(f"cnn: {rec['case']}: fused disagrees with the plain conv_layer")
    counts = cnn.launches()
    variants = {"conv_layer_cuda": dict(conv_layer_cuda.variants),
                "maxpool_cuda": dict(maxpool_cuda.variants)}
    print(f"cnn: launches {counts} expected {expect_total}; variants {variants} "
          f"expected conv_layer {expect_variants}, maxpool {expect_pool}", flush=True)
    if counts != expect_total or min(counts.values()) <= 0:
        fail("cnn: the CNN path did not run through every kernel as counted")
    if variants["conv_layer_cuda"] != expect_variants:
        fail("cnn: the CNN path did not run through the conv_layer variants as counted")
    if variants["maxpool_cuda"] != expect_pool:
        fail("cnn: the CNN path did not run through the maxpool variants as counted")
    profiles = {" ".join(CNN_RUNS[i]): profile_cnn(torch, CNN_RUNS[i]) for i in (0, 3)}
    return {"runs": runs, "launches": counts, "variants": variants,
            "profile": profiles}


# the port's CNN kernels by the names the profiler gives them
CNN_KERNEL_NAMES = ("conv_mma_kernel", "conv_simt_kernel", "maxpool_vector_kernel",
                    "maxpool_scalar_kernel", "maxpool_band_kernel", "leakyrelu_kernel")
PROFILE_PAD_S = 0.05
# empty kernels that open a measured window: late in a run the profiler
# drops the device records of a session's first kernels (up to 16 in
# chip_smoke's runs on the H100, torch 2.11)
PRIMER_LAUNCHES = 64


@contextlib.contextmanager
def profile_window(torch, primed: bool = True):
    """torch.profiler (CPU and CUDA) over a measured window: primed, it
    opens with PRIMER_LAUNCHES primers, empty kernels (``spin_kernel``,
    left out of the busy time), and stays open PROFILE_PAD_S before and
    after the window's work."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if primed:
            time.sleep(PROFILE_PAD_S)
            for _ in range(PRIMER_LAUNCHES):
                torch.cuda._sleep(0)
        yield prof
        if primed:
            time.sleep(PROFILE_PAD_S)


def launch_record(prof) -> dict:
    """A profile's kernel launch calls against the device events it holds:
    the positions (in launch order) of the launches it holds no kernel for,
    and the least time from a launch call to its kernel's start (us; below
    0 the device's clock reads early against the host's)."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    dev = {e.correlation_id(): e for e in events if e.device_type() == DeviceType.CUDA}
    calls = sorted((e for e in events if e.device_type() == DeviceType.CPU
                    and "LaunchKernel" in e.name()), key=lambda e: e.start_ns())
    lags = [(dev[c.correlation_id()].start_ns() - c.start_ns()) / 1e3
            for c in calls if c.correlation_id() in dev]
    return {"launch_calls": len(calls),
            "missing_at": [i for i, c in enumerate(calls) if c.correlation_id() not in dev],
            "launch_to_kernel_us_min": min(lags) if lags else None}


def profile_cnn(torch, argv, passes: int = 10) -> dict:
    """torch.profiler over a few passes of each leg of one CNN run (after
    the counted runs): the card's busy time per pass and its idle share.
    Late in a run the profiler drops the device records of the first
    kernels launched in a session, so each measured window is a primed
    ``profile_window``; one bare window per leg (no primer, no pad)
    records what is lost without. Each window counts the device events of
    the port's CNN kernels against their launches in it (the wrappers'
    counts); the run fails if the measured window misses one or reads no
    device time."""
    from torch.autograd import DeviceType
    from repro_torch.core.engine import ArcaneEngine
    from repro_torch.launch import cnn
    args = cnn.parse_args(argv)
    x, f = cnn.make_inputs(args, torch.device("cuda"))
    engine = ArcaneEngine("cuda")
    out = {}
    for leg in (cnn.fused, cnn.unfused):
        leg(engine, x, f, args.slope)
        torch.cuda.synchronize()
        for primed in (False, True):
            before = sum(cnn.launches().values())
            with profile_window(torch, primed) as prof:
                t0 = time.perf_counter()
                for _ in range(passes):
                    leg(engine, x, f, args.slope)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            launched = sum(cnn.launches().values()) - before
            seen = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                       and any(n in e.name for n in CNN_KERNEL_NAMES))
            res = busy_share(prof, wall_ms, passes, "pass", exclude=("spin_kernel",))
            res.update(kernel_launches=launched, kernel_events=seen, **launch_record(prof))
            if not primed:
                bare = {k: res[k] for k in ("kernel_launches", "kernel_events",
                                            "device_busy_ms_per_pass", "missing_at",
                                            "launch_to_kernel_us_min")}
        res["bare"] = bare
        out[leg.__name__] = res
        print(f"profile: cnn {' '.join(argv)} {leg.__name__}: {json.dumps(res)}",
              flush=True)
        if seen != launched or (launched and not res["device_busy_ms_per_pass"]):
            fail(f"profile: cnn {' '.join(argv)} {leg.__name__}: the profiler saw "
                 f"{seen} of {launched} kernel launches "
                 f"({res['device_busy_ms_per_pass']} ms busy a pass)")
    return out


# --------------------------------------------------------------- phase 4b
# The port's serial simulator (repro_torch.core) with its memory and cache
# lines on the card: Listing 1 at 64 x 64 (the example's geometry) in the
# three widths, and one seeded mixed program of SIM_MIXED_OPS kernels on 4
# VPUs, each against the same program on the host CPU in this process.
SIM_WIDTHS = ("w", "h", "b")
SIM_MIXED_SEED = 0
SIM_MIXED_OPS = 40
SIM_MIXED_RT = {"n_vpus": 4, "vregs_per_vpu": 32, "vlen_bytes": 512,
                "queue_capacity": 16}
SIM_KERNELS = ("leakyrelu", "maxpool", "gemm", "conv2d", "conv_layer")
# the PhaseStats fields a run must reproduce exactly (the *_s fields are
# host wall time)
SIM_STAT_FIELDS = ("preamble_cycles", "allocation_cycles", "compute_cycles",
                   "writeback_cycles", "fault_cycles", "reuse_hits",
                   "reused_dma_cycles", "kernels_run")


def mixed_program(seed: int, n_ops: int, builder, widths):
    """A seeded program of ``n_ops`` kernels drawn from the whole library
    (gemm with a beta-accumulate, leakyrelu, maxpool, conv2d, conv_layer)
    over strided views of seeded buffers, with sources that read earlier
    results and destinations that alias earlier buffers. ``builder`` is a
    ProgramBuilder class and ``widths`` its ElemWidth: the port's here, the
    reference's in the CPU tests, which hold both to the same dict."""
    rng = np.random.default_rng(seed)
    width = (widths.B, widths.H, widths.W)[int(rng.integers(3))]
    b = builder(f"mixed{seed}", width)
    pool: list = []                          # (name, rows, cols)

    def fresh(rows, cols, placed):
        name = f"b{len(pool)}"
        if placed:
            b.buffer(name, rows, cols, init="random",
                     seed=seed * 4096 + len(pool), lo=-9, hi=9)
        else:
            b.buffer(name, rows, cols)
        pool.append((name, rows, cols))
        return name

    def inside(rows, cols, p):
        fits = [q for q in pool if q[1] >= rows and q[2] >= cols]
        if not fits or rng.random() >= p:
            return None
        name, br, bc = fits[int(rng.integers(len(fits)))]
        return (name, int(rng.integers(br - rows + 1)),
                int(rng.integers(bc - cols + 1)), rows, cols)

    def src(rows, cols):
        v = inside(rows, cols, 0.5)
        if v is None:                        # a fresh, sometimes padded one
            pr, pc = int(rng.integers(3)), int(rng.integers(3))
            v = (fresh(rows + pr, cols + pc, True), int(rng.integers(pr + 1)),
                 int(rng.integers(pc + 1)), rows, cols)
        return v

    def dst(rows, cols):
        return inside(rows, cols, 0.35) or (fresh(rows, cols, False), 0, 0,
                                            rows, cols)

    for _ in range(n_ops):
        kind = SIM_KERNELS[int(rng.integers(len(SIM_KERNELS)))]
        if kind == "leakyrelu":
            r, c = int(rng.integers(3, 11)), int(rng.integers(3, 11))
            b.op(kind, [src(r, c)], dst(r, c),
                 alpha=float(rng.integers(-8, 9)) / 4)
        elif kind == "maxpool":
            r, c = int(rng.integers(4, 11)), int(rng.integers(4, 11))
            win = int(rng.integers(2, min(r, c, 3) + 1))
            stride = int(rng.integers(1, win + 1))
            b.op(kind, [src(r, c)],
                 dst((r - win) // stride + 1, (c - win) // stride + 1),
                 stride=stride, win_size=win)
        elif kind == "gemm":
            m, k, n = (int(rng.integers(2, 9)) for _ in range(3))
            b.op(kind, [src(m, k), src(k, n), src(m, n)], dst(m, n),
                 alpha=float(rng.integers(1, 5)) / 2,
                 beta=float(rng.integers(-2, 3)) / 2)
        elif kind == "conv2d":
            r, c = int(rng.integers(5, 11)), int(rng.integers(5, 11))
            km, kn = int(rng.integers(2, 4)), int(rng.integers(2, 4))
            b.op(kind, [src(r, c), src(km, kn)],
                 dst(r - km + 1, c - kn + 1))
        else:
            h, w = int(rng.integers(6, 10)), int(rng.integers(6, 11))
            kk = int(rng.integers(2, 4))
            b.op(kind, [src(3 * h, w), src(3 * kk, kk)],
                 dst((h - kk + 1) // 2, (w - kk + 1) // 2))
    return b.build()


def leaky_f32_library():
    """A planted fault: the kernel library with a leakyrelu body that scales
    in float32 (the reference scales in float64; on int32 inputs near 2^30
    float32 drops their low bits)."""
    import torch
    from repro_torch.core.encoding import fx_decode
    from repro_torch.core.isa import (KernelDef, _leakyrelu_dataflow,
                                      _leakyrelu_preamble, _wrap,
                                      default_library)

    def body(sources, params, width):
        x = sources[0].to(torch.int64)
        neg = torch.round(x.to(torch.float32) * fx_decode(params.get("alpha", 0)))
        return _wrap(torch.where(x >= 0, x.to(torch.float64), neg.to(torch.float64)),
                     width)

    lib = default_library()
    lib.register(KernelDef(1, "leakyrelu", 1, _leakyrelu_preamble, body,
                           dataflow=_leakyrelu_dataflow), allow_override=True)
    return lib


def leaky_near_2_30(builder, widths):
    """The program the float32 fault shows on: a 16 x 16 int32 map within
    2^12 of +-2^30 through leakyrelu at alpha 0.3 (Q8.8 77/256)."""
    rng = np.random.default_rng(7)
    x = rng.integers(2**30 - 2**12, 2**30 + 2**12, (16, 16))
    x *= rng.choice((-1, 1), (16, 16))
    b = builder("leaky_near_2_30", widths.W)
    b.data("X", x)
    b.buffer("Y", 16, 16)
    b.op("leakyrelu", [b.full("X")], b.full("Y"), alpha=0.3)
    return b.build()


def on_device(torch, rt, device: str) -> bool:
    """A runtime's memory and cache lines both on ``device``'s type."""
    return {rt.memory.data.device.type, rt.cache.data.device.type} == \
        {torch.device(device).type}


def sim_run(torch, prog, device: str, rt: dict, library=None) -> dict:
    """``prog`` through the port's serial simulator on ``device``: its
    flushed images (brought to the host: the run's one read of the device),
    its cycle fields, and the host seconds from the issue to the images on
    the host. On the card the memory and the cache lines must be there."""
    from repro_torch.core import ArcaneCoprocessor, run_program
    cop = ArcaneCoprocessor(device=device, library=library, **rt)
    if not on_device(torch, cop.rt, device):
        fail(f"sim: {prog.name}: memory and lines not on {device}")
    t0 = time.perf_counter()
    run = run_program(cop, prog)
    images = {k: v.cpu() for k, v in run.flushed_images().items()}
    wall = time.perf_counter() - t0
    return {"images": images, "wall_s": wall,
            "total_cycles": cop.rt.stats.total_cycles,
            "stats": {f: getattr(cop.rt.stats, f) for f in SIM_STAT_FIELDS}}


def sim_listing1(torch, width: str, device: str) -> dict:
    """Listing 1 as the port's example runs it (stats from the issue on),
    timed from the issue to R and the flushed images on the host."""
    from repro_torch.core import ElemWidth
    from repro_torch.examples import arcane_cnn
    prog = arcane_cnn.build_listing1(64, 64, 3, ElemWidth.from_suffix(width))
    t0 = time.perf_counter()
    res = arcane_cnn.run_listing1(prog, device)
    R = res["R"].cpu()
    images = {k: v.cpu() for k, v in res["run"].flushed_images().items()}
    wall = time.perf_counter() - t0
    st = res["stats"]
    return {"prog": prog, "R": R, "images": images, "wall_s": wall,
            "stats": {f: getattr(st, f) for f in SIM_STAT_FIELDS},
            "total_cycles": st.total_cycles, "shares": st.shares(),
            "speedup": arcane_cnn.scalar_cycles(64, 64, 3) / st.total_cycles}


def images_equal(torch, a: dict, b: dict) -> bool:
    """Two runs' flushed images, byte for byte."""
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def first_diff(torch, a, b) -> dict:
    """Where two integer maps first differ, and both values there."""
    idx = (a != b).nonzero()
    if not len(idx):
        return {}
    i, j = (int(v) for v in idx[0])
    return {"at": [i, j], "values": [int(a[i, j]), int(b[i, j])],
            "n_differ": int(len(idx))}


def run_sim(torch, smi_line: str) -> dict:
    """Phase 4b: the port's serial simulator on the card against the same
    programs on the host CPU (images byte for byte, cycle fields equal),
    Listing 1's R against the convlayer.cu kernel and the plain conv_layer
    (the phase's only kernel launches, counted exactly), and two planted
    faults the image check must reject."""
    from repro_torch.core import ElemWidth, ProgramBuilder
    from repro_torch.core.engine import ArcaneEngine
    from repro_torch.examples import arcane_cnn
    from repro_torch.kernels.convlayer.kernel import conv_layer_cuda, conv_variant
    from repro_torch.kernels.convlayer.ref import conv_layer_ref
    from repro_torch.launch import cnn
    from repro_torch.kernels.gemm.kernel import gemm_cuda
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
    wrappers = (*cnn.WRAPPERS, gemm_cuda, flash_attention_cuda, decode_attention_cuda)
    out: dict = {"listing1": {}}
    for w in wrappers:
        w.launches = 0
    conv_layer_cuda.variants = dict.fromkeys(conv_layer_cuda.variants, 0)
    expect_variants = dict.fromkeys(conv_layer_cuda.variants, 0)
    engine = ArcaneEngine("cuda")
    images_w = {}
    for width in SIM_WIDTHS:
        # each timed run follows a warm one (first-call allocations)
        cpu = [sim_listing1(torch, width, "cpu") for _ in range(2)][-1]
        card = [sim_listing1(torch, width, "cuda") for _ in range(2)][-1]
        if width == "w":
            images_w = {"card": card["images"], "cpu": cpu["images"]}
        prog = card["prog"]
        x, f = arcane_cnn.layer_inputs(prog, 64, 64, 3, "cuda")
        kernel = engine.conv_layer(x, f)[0]
        expect_variants[conv_variant(x, f)] += 1
        plain = conv_layer_ref(x, f)[0]
        wide = conv_layer_ref(x.to(torch.int32), f.to(torch.int32))[0]
        R = card["R"]
        rec = {"total_cycles": card["total_cycles"], "kernels_run": card["stats"]["kernels_run"],
               "shares": card["shares"], "speedup": card["speedup"],
               "card_wall_s": card["wall_s"], "cpu_wall_s": cpu["wall_s"],
               "card_kernels_per_s": card["stats"]["kernels_run"] / card["wall_s"],
               "cpu_kernels_per_s": cpu["stats"]["kernels_run"] / cpu["wall_s"],
               "images_equal_cpu": images_equal(torch, card["images"], cpu["images"]),
               "stats_equal_cpu": card["stats"] == cpu["stats"]
               and card["total_cycles"] == cpu["total_cycles"],
               "R_equals_kernel": torch.equal(R, kernel.cpu()),
               "kernel_equals_plain": torch.equal(kernel, plain),
               "pooled_max_int32": int(wide.max()),
               "wraps": int(wide.max()) > torch.iinfo(R.dtype).max}
        out["listing1"][width] = rec
        print(f"sim: listing1 64x64 k=3 int{8 * R.element_size()}: cycles "
              f"{rec['total_cycles']}, shares " + " ".join(
                  f"{k}={v:.4f}" for k, v in rec["shares"].items())
              + f", modeled speedup {rec['speedup']:.4f}x; card {rec['card_wall_s']:.6f} s "
              f"({rec['card_kernels_per_s']:.1f} kernels/s), host CPU {rec['cpu_wall_s']:.6f} s "
              f"({rec['cpu_kernels_per_s']:.1f} kernels/s) [{smi_line}]; images == CPU "
              f"{rec['images_equal_cpu']}, stats == CPU {rec['stats_equal_cpu']}, R == "
              f"conv_layer_cuda {rec['R_equals_kernel']}, kernel == plain "
              f"{rec['kernel_equals_plain']}; pooled max in int32 {rec['pooled_max_int32']}"
              f" (wraps {rec['wraps']})", flush=True)
        if not (rec["R_equals_kernel"] and rec["kernel_equals_plain"]):
            fail(f"sim: listing1 {width}: R {first_diff(torch, R, kernel.cpu())} "
                 f"kernel vs plain {first_diff(torch, kernel, plain)} on A, F of seeds 0, 1")
        if not (rec["images_equal_cpu"] and rec["stats_equal_cpu"]):
            fail(f"sim: listing1 {width}: the card's run differs from the CPU's")
    counts = {w.__name__: w.launches for w in wrappers}
    variants = {"conv_layer_cuda": dict(conv_layer_cuda.variants)}
    expect = {w.__name__: (len(SIM_WIDTHS) if w is conv_layer_cuda else 0) for w in wrappers}
    print(f"sim: launches {counts} expected {expect}; conv_layer variants "
          f"{variants['conv_layer_cuda']} expected {expect_variants}", flush=True)
    if counts != expect or variants["conv_layer_cuda"] != expect_variants:
        fail("sim: the phase did not launch the kernels as counted")
    out.update(launches=counts, variants=variants)

    prog = mixed_program(SIM_MIXED_SEED, SIM_MIXED_OPS, ProgramBuilder, ElemWidth)
    cpu = [sim_run(torch, prog, "cpu", SIM_MIXED_RT) for _ in range(2)][-1]
    card = [sim_run(torch, prog, "cuda", SIM_MIXED_RT) for _ in range(2)][-1]
    kinds = {k: sum(op.kernel == k for op in prog.ops) for k in SIM_KERNELS}
    rec = {"ops": len(prog.ops), "kernels": kinds, "width": prog.width.suffix,
           "buffers": len(prog.buffers), "stats": card["stats"],
           "card_wall_s": card["wall_s"], "cpu_wall_s": cpu["wall_s"],
           "card_kernels_per_s": card["stats"]["kernels_run"] / card["wall_s"],
           "cpu_kernels_per_s": cpu["stats"]["kernels_run"] / cpu["wall_s"],
           "images_equal_cpu": images_equal(torch, card["images"], cpu["images"]),
           "stats_equal_cpu": card["stats"] == cpu["stats"]
           and card["total_cycles"] == cpu["total_cycles"]}
    out["mixed"] = rec
    rec["total_cycles"] = card["total_cycles"]
    print(f"sim: mixed seed {SIM_MIXED_SEED}, {rec['ops']} ops {kinds} .{rec['width']} "
          f"on 4 VPUs: cycles {rec['total_cycles']}, kernels {card['stats']['kernels_run']}; card "
          f"{rec['card_wall_s']:.6f} s ({rec['card_kernels_per_s']:.1f} kernels/s), host CPU "
          f"{rec['cpu_wall_s']:.6f} s ({rec['cpu_kernels_per_s']:.1f} kernels/s) "
          f"[{smi_line}]; images == CPU {rec['images_equal_cpu']}, stats == CPU "
          f"{rec['stats_equal_cpu']}", flush=True)
    if not (rec["images_equal_cpu"] and rec["stats_equal_cpu"]):
        fail("sim: the mixed program's card run differs from the CPU's")

    # planted faults: the image check must reject both
    flipped = {k: v.clone() for k, v in images_w["card"].items()}
    flipped["R"].view(torch.uint8).reshape(-1)[5].bitwise_xor_(1 << 3)
    leaky = leaky_near_2_30(ProgramBuilder, ElemWidth)
    sound_cpu = sim_run(torch, leaky, "cpu", SIM_MIXED_RT)
    sound_card = sim_run(torch, leaky, "cuda", SIM_MIXED_RT)
    f32_card = sim_run(torch, leaky, "cuda", SIM_MIXED_RT, library=leaky_f32_library())
    faults = {"flipped_byte_rejected": not images_equal(torch, flipped,
                                                        images_w["cpu"]),
              "leaky_sound_equal": images_equal(torch, sound_card["images"],
                                                sound_cpu["images"]),
              "leaky_f32_rejected": not images_equal(torch, f32_card["images"],
                                                     sound_cpu["images"]),
              "leaky_f32_diff": first_diff(torch, f32_card["images"]["Y"],
                                           sound_cpu["images"]["Y"])}
    out["faults"] = faults
    print(f"sim: planted faults: {json.dumps(faults)}", flush=True)
    if not (faults["flipped_byte_rejected"] and faults["leaky_sound_equal"]
            and faults["leaky_f32_rejected"]):
        fail("sim: a planted fault passed the image check (or the sound leakyrelu failed it)")
    return out


# --------------------------------------------------------------- phase 4c
# The port's pipelined simulator (repro_torch.sim: the event-driven C-RT
# over the serial runtime's data plane), every run built through
# SimConfig.make_runtime(..., device=) with memory and lines on the card and
# held against the same run on the host CPU in this process: (1) the
# paper's Fig. 4 anchors, lower_cnn at 256 x 256 int8 with k 3 and 7, on
# both builtin configs and both schedulers; (2) the pipelined example's
# program; (3) the serving driver on serving-poisson's values.
PIPE_CONFIGS = ("arcane-8vpu", "arcane-default")
PIPE_SCHEDULERS = ("serial", "pipelined")
PIPE_CNN_HW = 256
PIPE_CNN_KS = (3, 7)
PIPE_EXAMPLE_BATCH = 4
# serving-poisson of dse/scenarios.py:100-130 (ServingScenario's defaults),
# written here: dse/ is not ported
SERVING_POISSON = {"n_requests": 8, "mean_gap": 20_000, "seed": 0,
                   "kv_max": 24, "slots": 4, "prompt_range": (3, 8),
                   "new_range": (2, 5)}
PIPE_SERVE_CONFIG = "arcane-default"
# the PipelineReport fields a card run must reproduce (sim_seconds,
# events_processed and alias_queries profile the simulator itself)
PIPE_REPORT_FIELDS = ("makespan", "serial_cycles", "kernels_run",
                      "resource_busy", "reuse_hits")


def pipe_cnn_program(k: int, cfg):
    """lower_cnn's Fig. 4 anchor: one 3 x 256 x 256 int8 image through the
    fused conv layer, strip-mined to ``cfg``'s register file."""
    from repro_torch.core import ElemWidth
    from repro_torch.lower import CNNSpec, lower_cnn
    return lower_cnn(CNNSpec(name=f"fig4-b{k}-{PIPE_CNN_HW}", h=PIPE_CNN_HW,
                             w=PIPE_CNN_HW, k=k, width=ElemWidth.B),
                     vregs_per_vpu=cfg.vregs_per_vpu, vlen_bytes=cfg.vlen_bytes)


def pipe_conv_launches(cnn_progs, example_progs) -> int:
    """conv_layer_cuda's launches in phase 4c: one whole-image conv for
    each fused layer of (1) (its strips write one output buffer) and one
    for each conv_layer op of (2) (each writes a whole feature map)."""
    fused = sum(len({op.dst.buf for op in p.ops if op.kernel == "conv_layer"})
                for p in cnn_progs)
    per_op = sum(op.kernel == "conv_layer" for p in example_progs for op in p.ops)
    return fused + per_op


def pipe_fields(rt) -> dict:
    """A run's cycle fields: PhaseStats' and, pipelined, the report's and
    every resource's intervals."""
    out = {"stats": {f: getattr(rt.stats, f) for f in SIM_STAT_FIELDS},
           "total_cycles": rt.stats.total_cycles}
    if hasattr(rt, "report"):
        rep = rt.report()
        out["report"] = {f: getattr(rep, f) for f in PIPE_REPORT_FIELDS}
        out["intervals"] = {r.name: [(iv.start, iv.end) for iv in r.intervals]
                            for r in rt._all_resources()}
    return out


def pipe_run(torch, prog, cfg, scheduler: str, device: str) -> dict:
    """``prog`` on a runtime of ``cfg`` on ``device``: the flushed images on
    the host, the cycle fields and the host seconds from the issue to the
    images on the host."""
    from repro_torch.core import run_program
    rt = cfg.make_runtime(scheduler, device=device)
    if not on_device(torch, rt, device):
        fail(f"sim: {prog.name} {scheduler}: memory and lines not on {device}")
    t0 = time.perf_counter()
    run = run_program(rt, prog)
    images = {k: v.cpu() for k, v in run.flushed_images().items()}
    wall = time.perf_counter() - t0
    return {"images": images, "wall_s": wall, "rt": rt, **pipe_fields(rt)}


def warm_then_timed(fn):
    """Each timed run follows a warm one (first-call allocations)."""
    fn()
    return fn()


def same_cycles(a: dict, b: dict) -> bool:
    return all(a.get(k) == b.get(k) for k in ("stats", "total_cycles", "report",
                                              "intervals"))


def intervals_disjoint(fields: dict) -> bool:
    """No resource's booked intervals overlap."""
    for ivs in fields.get("intervals", {}).values():
        ivs = sorted(ivs)
        if any(a[1] > b[0] for a, b in zip(ivs, ivs[1:])):
            return False
    return True


def serving_requests():
    from repro_torch.sim import poisson_arrivals
    s = SERVING_POISSON
    return poisson_arrivals(s["n_requests"], s["mean_gap"],
                            prompt_range=s["prompt_range"],
                            new_range=s["new_range"], seed=s["seed"])


def serve_run(torch, cfg, scheduler: str, device: str) -> dict:
    """ServingDriver over serving-poisson's requests on a runtime of ``cfg``
    on ``device`` (as dse/runner.py builds it: the strip-miner on the
    config's register file): the run's dict and its host seconds."""
    from repro_torch.sim import ServingConfig, ServingDriver
    s = SERVING_POISSON
    rt = cfg.make_runtime(scheduler, device=device)
    if not on_device(torch, rt, device):
        fail(f"sim: serving {scheduler}: memory and lines not on {device}")
    t0 = time.perf_counter()
    drv = ServingDriver(rt, ServingConfig(kv_max=s["kv_max"], slots=s["slots"],
                                          vregs=cfg.vregs_per_vpu,
                                          vlen=cfg.vlen_bytes))
    result = drv.run(serving_requests())
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"result": result, "wall_s": wall,
            "kernels_run": rt.stats.kernels_run}


def latency_percentiles(result: dict) -> dict:
    """Arrival to last token of each finished request, p50 and p99."""
    from repro_torch.sim.metrics import _exact_percentile
    lat = [r["finished"] - r["arrived"] for r in result["per_request"]
           if r["finished"] is not None]
    return {"latency_p50": _exact_percentile(lat, 50),
            "latency_p99": _exact_percentile(lat, 99)}


def moved_ttft(result: dict) -> dict:
    """A planted fault: the first finished request's TTFT one cycle later."""
    out = json.loads(json.dumps(result))
    req = next(r for r in out["per_request"] if r["ttft"] is not None)
    req["ttft"] += 1
    req["first_token"] += 1
    return out


def flipped_image(torch, images: dict, name: str) -> dict:
    """A planted fault: one byte of one image flipped."""
    out = {k: v.clone() for k, v in images.items()}
    out[name].view(torch.uint8).reshape(-1)[7].bitwise_xor_(1 << 2)
    return out


def count_syncs(torch, fn) -> tuple[int, dict]:
    """``fn`` under torch.cuda.set_sync_debug_mode("warn"): the number of
    synchronising calls made from the port's code, and every reported call
    by the place that made it (the innermost frame of the port's code, then
    the frame that warned; "?" where no frame of the port's code is on the
    stack: on the H100 the first switch to "warn" in a process reports one
    such call itself)."""
    import traceback
    import warnings
    where: dict = {}

    def seen(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if "repro_torch" in f.filename]
        key = (f"{Path(ours[-1].filename).name}:{ours[-1].lineno} "
               f"{ours[-1].name}" if ours else "?") + \
            f" <- {Path(filename).name}:{lineno}"
        where[key] = where.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(n for k, n in where.items() if not k.startswith("?")), where


def pipe_event_loop(torch, prog, cfg, device: str) -> None:
    """The pipelined event loop alone: placement first, then the issue to
    the drained queue, just before the flush."""
    from repro_torch.core import ArcaneCoprocessor, issue_program, place_program
    cop = ArcaneCoprocessor(runtime=cfg.make_runtime("pipelined", device=device))
    addrs = place_program(cop, prog)
    torch.cuda.synchronize()
    return lambda: (issue_program(cop, prog, addrs), cop.barrier())


def run_sim_pipelined(torch, smi_line: str) -> dict:
    """Phase 4c: the port's pipelined simulator on the card against the
    same runs on the host CPU (images byte for byte, cycle fields equal),
    each fused layer and feature map against the convlayer.cu kernel and
    the plain conv_layer (the phase's only launches, counted exactly), the
    serving driver's dict, two planted faults, and the synchronising calls
    of the event loop."""
    from repro_torch.core import reference_images
    from repro_torch.core.engine import ArcaneEngine
    from repro_torch.examples import arcane_cnn, pipelined_cnn
    from repro_torch.kernels.convlayer.kernel import conv_layer_cuda, conv_variant
    from repro_torch.kernels.convlayer.ref import conv_layer_ref
    from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.gemm.kernel import gemm_cuda
    from repro_torch.launch import cnn
    from repro_torch.sim import load_config
    wrappers = (*cnn.WRAPPERS, gemm_cuda, flash_attention_cuda, decode_attention_cuda)
    for w in wrappers:
        w.launches = 0
    conv_layer_cuda.variants = dict.fromkeys(conv_layer_cuda.variants, 0)
    expect_variants = dict.fromkeys(conv_layer_cuda.variants, 0)
    engine = ArcaneEngine("cuda")
    out: dict = {"cnn": [], "example": [], "serving": {}}
    cfgs = {name: load_config(name) for name in PIPE_CONFIGS}
    cnn_progs, example_progs, flip_checked = [], [], None

    # (1) the paper's Fig. 4 anchors
    for k in PIPE_CNN_KS:
        for cname, cfg in cfgs.items():
            prog = pipe_cnn_program(k, cfg)
            cnn_progs.append(prog)
            x, f = pipelined_cnn.conv_inputs(prog, "x0", "f0", "cuda")
            kernel = engine.conv_layer(x, f)[0].cpu()
            expect_variants[conv_variant(x, f)] += 1
            plain = conv_layer_ref(x, f)[0].cpu()
            for sched in PIPE_SCHEDULERS:
                cpu = warm_then_timed(lambda: pipe_run(torch, prog, cfg, sched, "cpu"))
                card = warm_then_timed(lambda: pipe_run(torch, prog, cfg, sched, "cuda"))
                got = card["images"]["l0_out0"]
                rec = {"k": k, "config": cname, "scheduler": sched,
                       "strips": len(prog.ops), "serial_cycles": card["total_cycles"],
                       "kernels_run": card["stats"]["kernels_run"],
                       "card_wall_s": card["wall_s"], "cpu_wall_s": cpu["wall_s"],
                       "images_equal_cpu": images_equal(torch, card["images"], cpu["images"]),
                       "cycles_equal_cpu": same_cycles(card, cpu),
                       "out_equals_kernel": torch.equal(got, kernel),
                       "kernel_equals_plain": torch.equal(kernel, plain),
                       "intervals_disjoint": intervals_disjoint(card)}
                if sched == "pipelined":
                    rec["makespan"] = card["report"]["makespan"]
                    rec["concurrency_speedup"] = \
                        card["report"]["serial_cycles"] / card["report"]["makespan"]
                cycles_ = rec.get("makespan", rec["serial_cycles"])
                rec["scalar_speedup"] = arcane_cnn.scalar_cycles(
                    PIPE_CNN_HW, PIPE_CNN_HW, k) / cycles_
                out["cnn"].append(rec)
                extra = (f"pipelined makespan {rec['makespan']}, concurrency speedup "
                         f"{rec['concurrency_speedup']:.4f}x, " if sched == "pipelined"
                         else "")
                total = "serial cycles" if sched == "serial" else "sum of phases"
                print(f"sim: pipelined phase fig4 {PIPE_CNN_HW}x{PIPE_CNN_HW} int8 k={k} "
                      f"{cname} {sched}: {rec['strips']} strips, {total} "
                      f"{rec['serial_cycles']}, {extra}modeled speedup over the scalar "
                      f"core {rec['scalar_speedup']:.4f}x; card {rec['card_wall_s']:.6f} s, "
                      f"host CPU {rec['cpu_wall_s']:.6f} s [{smi_line}]; images == CPU "
                      f"{rec['images_equal_cpu']}, cycles == CPU {rec['cycles_equal_cpu']}, "
                      f"l0_out0 == conv_layer_cuda {rec['out_equals_kernel']}, kernel == "
                      f"plain {rec['kernel_equals_plain']}", flush=True)
                if not (rec["out_equals_kernel"] and rec["kernel_equals_plain"]):
                    fail(f"sim: fig4 k={k} {cname} {sched}: l0_out0 "
                         f"{first_diff(torch, got, kernel)} kernel vs plain "
                         f"{first_diff(torch, kernel, plain)}")
                if not (rec["images_equal_cpu"] and rec["cycles_equal_cpu"]
                        and rec["intervals_disjoint"]):
                    fail(f"sim: fig4 k={k} {cname} {sched}: the card's run differs "
                         f"from the CPU's")
                if flip_checked is None and sched == "pipelined":
                    flip_checked = not images_equal(
                        torch, flipped_image(torch, card["images"], "l0_out0"),
                        cpu["images"])

    # (2) the pipelined example's program
    for cname, cfg in cfgs.items():
        prog = pipelined_cnn.build_program(batch=PIPE_EXAMPLE_BATCH)
        example_progs.append(prog)
        runs = {}
        for sched in PIPE_SCHEDULERS:
            runs[sched] = {dev: warm_then_timed(lambda: pipe_run(torch, prog, cfg, sched, dev))
                           for dev in ("cpu", "cuda")}
        ref = {k: v.cpu() for k, v in reference_images(prog, device="cuda").items()}
        card_p, cpu_p = runs["pipelined"]["cuda"], runs["pipelined"]["cpu"]
        traces = []
        for dev, run in (("cuda", card_p), ("cpu", cpu_p)):
            path = ROOT / "build" / "chip_smoke" / f"pipelined_cnn_{cname}_{dev}_trace.json"
            run["rt"].tracer.dump(str(path))
            traces.append(json.loads(path.read_text()))
        feats = []
        for i in range(PIPE_EXAMPLE_BATCH):
            x, f = pipelined_cnn.conv_inputs(prog, f"img{i}", "filt", "cuda")
            kernel = engine.conv_layer(x, f)[0].cpu()
            expect_variants[conv_variant(x, f)] += 1
            feats.append(torch.equal(card_p["images"][f"feat{i}"], kernel)
                         and torch.equal(kernel, conv_layer_ref(x, f)[0].cpu()))
        rep = card_p["report"]
        rec = {"config": cname, "kernels_run": rep["kernels_run"],
               "serial_cycles": runs["serial"]["cuda"]["total_cycles"],
               "makespan": rep["makespan"],
               "concurrency_speedup": rep["serial_cycles"] / rep["makespan"],
               "card_wall_s": {s: runs[s]["cuda"]["wall_s"] for s in PIPE_SCHEDULERS},
               "cpu_wall_s": {s: runs[s]["cpu"]["wall_s"] for s in PIPE_SCHEDULERS},
               "serial_equals_pipelined": images_equal(
                   torch, runs["serial"]["cuda"]["images"], card_p["images"]),
               "equals_reference_images": images_equal(torch, card_p["images"], ref),
               "images_equal_cpu": all(images_equal(torch, runs[s]["cuda"]["images"],
                                                    runs[s]["cpu"]["images"])
                                       for s in PIPE_SCHEDULERS),
               "cycles_equal_cpu": all(same_cycles(runs[s]["cuda"], runs[s]["cpu"])
                                       for s in PIPE_SCHEDULERS),
               "feats_equal_kernel": feats, "trace_equal_cpu": traces[0] == traces[1],
               "trace_events": len(traces[0]["traceEvents"]),
               "intervals_disjoint": intervals_disjoint(card_p)}
        out["example"].append(rec)
        print(f"sim: pipelined phase example batch {PIPE_EXAMPLE_BATCH} {cname}: kernels "
              f"{rec['kernels_run']}, serial cycles {rec['serial_cycles']}, makespan "
              f"{rec['makespan']}, concurrency speedup {rec['concurrency_speedup']:.4f}x; "
              f"card s {rec['card_wall_s']}, host CPU s {rec['cpu_wall_s']} [{smi_line}]; "
              f"serial == pipelined {rec['serial_equals_pipelined']}, == reference_images "
              f"{rec['equals_reference_images']}, images == CPU {rec['images_equal_cpu']}, "
              f"cycles == CPU {rec['cycles_equal_cpu']}, feat == conv_layer_cuda {feats}, "
              f"trace == CPU {rec['trace_equal_cpu']} ({rec['trace_events']} events), "
              f"intervals disjoint {rec['intervals_disjoint']}", flush=True)
        if not (rec["serial_equals_pipelined"] and rec["equals_reference_images"]
                and rec["images_equal_cpu"] and rec["cycles_equal_cpu"] and all(feats)
                and rec["trace_equal_cpu"] and rec["intervals_disjoint"]):
            fail(f"sim: the example's program on {cname} failed a check")

    # (3) serving
    cfg = cfgs[PIPE_SERVE_CONFIG]
    for sched in PIPE_SCHEDULERS:
        cpu = warm_then_timed(lambda: serve_run(torch, cfg, sched, "cpu"))
        card = warm_then_timed(lambda: serve_run(torch, cfg, sched, "cuda"))
        res = card["result"]
        rec = {"equal_cpu": res == cpu["result"], "kernels_run": card["kernels_run"],
               "finished": res["finished"], "ttft_p50": res["ttft_p50"],
               "ttft_p99": res["ttft_p99"], **latency_percentiles(res),
               "queue_wait_p99": res["queue_wait_p99"],
               "card_wall_s": card["wall_s"], "cpu_wall_s": cpu["wall_s"],
               "card_kernels_per_s": card["kernels_run"] / card["wall_s"],
               "cpu_kernels_per_s": cpu["kernels_run"] / cpu["wall_s"],
               "moved_ttft_rejected": moved_ttft(res) != cpu["result"]}
        out["serving"][sched] = rec
        print(f"sim: pipelined phase serving-poisson {PIPE_SERVE_CONFIG} {sched}: "
              f"{rec['finished']} requests, TTFT p50 {rec['ttft_p50']} p99 "
              f"{rec['ttft_p99']} cycles, latency p50 {rec['latency_p50']} p99 "
              f"{rec['latency_p99']} cycles, kernels {rec['kernels_run']}; card "
              f"{rec['card_wall_s']:.6f} s ({rec['card_kernels_per_s']:.1f} kernels/s), "
              f"host CPU {rec['cpu_wall_s']:.6f} s ({rec['cpu_kernels_per_s']:.1f} "
              f"kernels/s) [{smi_line}]; dict == CPU {rec['equal_cpu']}", flush=True)
        if not rec["equal_cpu"]:
            fail(f"sim: serving {sched}: the card's dict differs from the CPU's")

    # (4) launches, (5) planted faults, (6) synchronising calls
    counts = {w.__name__: w.launches for w in wrappers}
    variants = {"conv_layer_cuda": dict(conv_layer_cuda.variants)}
    n_conv = pipe_conv_launches(cnn_progs, example_progs)
    expect = {w.__name__: (n_conv if w is conv_layer_cuda else 0) for w in wrappers}
    faults = {"flipped_byte_rejected": bool(flip_checked),
              "moved_ttft_rejected": all(r["moved_ttft_rejected"]
                                         for r in out["serving"].values())}
    syncs = {}
    for k in PIPE_CNN_KS:
        prog = pipe_cnn_program(k, cfgs["arcane-8vpu"])
        syncs[k] = count_syncs(torch, pipe_event_loop(torch, prog, cfgs["arcane-8vpu"],
                                                      "cuda"))
    n_sync = sum(n for n, _ in syncs.values())
    where: dict = {}
    for _, w in syncs.values():
        for key, n in w.items():
            where[key] = where.get(key, 0) + n
    out.update(launches=counts, variants=variants, faults=faults,
               sync_calls=n_sync, sync_where=where)
    print(f"sim: pipelined phase launches {counts} expected {expect}; conv_layer "
          f"variants {variants['conv_layer_cuda']} expected {expect_variants}; planted "
          f"faults {json.dumps(faults)}; synchronising calls from the port's code in "
          f"the arcane-8vpu event loops (k {list(PIPE_CNN_KS)}): {n_sync}, all reported: "
          f"{json.dumps(where)} [{smi_line}]",
          flush=True)
    if counts != expect or variants["conv_layer_cuda"] != expect_variants:
        fail("sim: the pipelined phase did not launch the kernels as counted")
    if not all(faults.values()):
        fail("sim: a planted fault passed the pipelined phase's checks")
    return out


# gemma2-9b's logits are soft-capped to [-30, 30]. The engines differ only
# in the order of f32 sums; a bf16 activation that rounds the other way at
# one of the 42 layers moves logits by a few hundredths on average.
SERVE_ATOL = 1.0
SERVE_MEAN_ATOL = 0.1
# Uncapped logits (granite-moe-1b, minicpm3-4b), as shares of the largest
# |ref| logit: on average one bf16 ulp of it (2^-7), at most 2^-4. In an
# MoE model a router input that rounds the other way can flip a token's
# k-th expert at a near tie, which moves that token's output by more than
# a rounding. The f32 copy of the weights has no such ties to speak of:
# there both engines agree to 1e-3 of the largest logit and on the argmax.
SERVE_RTOL = 2.0 ** -4
SERVE_MEAN_RTOL = 2.0 ** -7
SERVE_F32_RTOL = 1e-3

# name: (source, TPU kernel, wrapper, phase of its launches, representative
# case, its dtype)
KERNELS = {
    "gemm": ("src/repro_torch/csrc/gemm.cu",
             "src/repro/kernels/gemm/kernel.py:97", "gemm_cuda", "serve",
             "gemma2 gate_up M=512 K=3584 N=14336", "bfloat16"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:100",
                         "decode_attention_cuda", "serve", "gemma2 B=4",
                         "bfloat16"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:131",
                        "flash_attention_cuda", "serve",
                        "gemma2 B=1 Hq=16 Hkv=8 D=256 Sq=512", "bfloat16"),
    "conv_layer": ("src/repro_torch/csrc/convlayer.cu",
                   "src/repro/kernels/convlayer/kernel.py:99",
                   "conv_layer_cuda", "cnn", "3x226x226 k=3 F=64 slope=0.125",
                   "bfloat16"),
    "maxpool": ("src/repro_torch/csrc/maxpool.cu",
                "src/repro/kernels/maxpool/kernel.py:54", "maxpool_cuda",
                "cnn", "224x224 win=2 stride=2", "float32"),
    "leakyrelu": ("src/repro_torch/csrc/leakyrelu.cu",
                  "src/repro/kernels/leakyrelu/kernel.py:37",
                  "leakyrelu_cuda", "cnn", "(64, 112, 112) slope=0.5", "float32"),
}


# the rows of a kernel that the kernels line also carries (bf16)
MORE_CASES = {"decode_attention": ("minicpm3", "whisper", "internvl2"),
              "flash_attention": ("whisper", "internvl2"),
              "gemm": ("granite unembed", "rwkv6", "jamba", "int8", "internvl2",
                       "whisper")}


class PhaseClock:
    """The host seconds of each phase: ``lap`` prints the time since the
    last lap (or since the clock was made) and keeps it in the summary."""

    def __init__(self, summary: dict):
        self.summary, self.t = summary, time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        secs, self.t = now - self.t, now
        self.summary.setdefault("phase_s", {})[name] = secs
        print(f"phase: {name} {secs:.1f}s", flush=True)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description="Chip smoke of the PyTorch/CUDA port.")
    ap.add_argument("--cnn-kernels-only", action="store_true",
                    help="phases 1-2 for conv_layer, maxpool and leakyrelu only "
                         "(to time two trees' kernels in one call); no result line")
    ap.add_argument("--decode-host", nargs="?", const="gemma2-9b", default=None,
                    metavar="ARCH",
                    help="only the serving decode step's host clock of ARCH "
                         "(default gemma2-9b; to time two trees in turns); no "
                         "result line")
    ap.add_argument("--json", default=None,
                    help="where the details go (default build/chip_smoke/chip_smoke.json)")
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs the card")
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        fail(f"the port is not importable from {ROOT / 'src'}: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False      # plain f32 is true f32
    torch.backends.cudnn.allow_tf32 = False
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    out_json = Path(opts.json) if opts.json else out_dir / "chip_smoke.json"

    # ---- phase 1: device
    summary: dict = {}
    clock = PhaseClock(summary)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(smi_line, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"python={sys.version.split()[0]}", flush=True)
    names = ("convlayer", "maxpool", "leakyrelu") if opts.cnn_kernels_only else \
        ("gemm", "decode_attention", "flash_attention") if opts.decode_host else _build.SOURCES
    build_s = _build.build_all(names)
    print(f"build: {', '.join(names)} in {build_s:.1f}s "
          f"(nvcc, sm_90a, parallel)", flush=True)
    (out_dir / "chip_smoke_build.txt").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in _build.BUILD_LOG.items()))
    summary.update(nvidia_smi=smi_line, device=torch.cuda.get_device_name(0),
                   torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s)
    clock.lap("device")

    if opts.decode_host:
        summary["decode_host"] = run_decode_host(torch, opts.decode_host)
        out_json.write_text(json.dumps(summary, indent=1))
        return

    # ---- phase 2: kernels vs plain versions
    rows: list[dict] = []
    failures: list[str] = []
    timer = Timer(torch)
    summary["launch_floor_ms"] = timer.ms(lambda: torch.cuda._sleep(0))
    print(f"timer: an empty kernel takes {summary['launch_floor_ms']:.4f} ms "
          f"between the events", flush=True)
    summary["copy_calibration"] = copy_calibration(torch, timer)
    gen = torch.Generator(device="cuda").manual_seed(0)
    phase2 = (run_gemm, run_decode, run_flash, run_conv, run_maxpool, run_leakyrelu)
    for run in phase2[3:] if opts.cnn_kernels_only else phase2:
        run(torch, timer, gen, rows)
    del timer
    torch.cuda.empty_cache()
    for r in rows:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        var = f" variant={r['variant']}" if "variant" in r else ""
        earlier = "" if r.get("earlier_ms") is None else \
            f" earlier_ms={r['earlier_ms']:.4f} earlier_max_abs_err={r['earlier_max_abs_err']:.3e}"
        other = "" if r.get("other_ms") is None else \
            (f" other_variant={r['other_variant']} other_ms={r['other_ms']:.4f} "
             f"other_max_abs_err={r['other_max_abs_err']:.3e}")
        for o in r.get("others", ()):
            other += (f" {o['variant']}_ms={o['ms']:.4f} {o['variant']}_same_bits="
                      f"{o['same_bits']}")
        det = "" if r.get("deterministic") is None else \
            f" same_bits_twice={r['deterministic']}"
        if "same_bits" in r:
            det += f" same_bits={r['same_bits']}"
        tol = f"atol={r['atol']} rtol={r['rtol']}"
        if "row_limit_ratio" in r:
            tol += (f" per row, abs<={r['abs_cap']}; worst err/limit "
                    f"{r['row_limit_ratio']:.3f}")
        if r.get("planted_fault_ratio"):
            tol += "; planted faults err/limit " + ", ".join(
                f"{k} {v:.1f}" for k, v in r["planted_fault_ratio"].items())
        # bytes moved (each input read once, each output written once) over
        # the kernel's time, as a share of the 3.35 TB/s memory rate
        r["mem_rate_share"] = r["bytes"] / HBM_BYTES_PER_S * 1e3 / r["ms"]
        print(f"{r['kernel']} [{r['dtype']}] {r['case']}:{var} max_abs_err={r['max_abs_err']:.3e} "
              f"({tol}) {'ok' if r['ok'] else 'FAIL'}{det} "
              f"ms={r['ms']:.4f}{earlier}{other} bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
              f"mem_rate_share={r['mem_rate_share']:.3f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={lib}", flush=True)
    summary["cases"] = rows
    summary["host"] = run_host(torch)
    out_json.write_text(json.dumps(summary, indent=1))
    bad = [r for r in rows if not r["ok"]]
    if bad:      # reported after the serving phase has run too
        failures.append(f"{len(bad)} kernel case(s) disagree with the plain version")
    if opts.cnn_kernels_only:
        if failures:
            fail("; ".join(failures))
        print(f"chip_smoke: {len(rows)} CNN kernel cases agree; details in {out_json}",
              flush=True)
        return

    # ---- phase 4 (first: its profiles must see every launch): the CNN layer path
    clock.lap("kernels")
    summary["cnn"] = run_cnn(torch)
    clock.lap("cnn")
    out_json.write_text(json.dumps(summary, indent=1))

    # ---- phase 4b: the simulator's serial stack on the card
    summary["sim"] = run_sim(torch, smi_line)
    clock.lap("sim")
    out_json.write_text(json.dumps(summary, indent=1))

    # ---- phase 4c: the pipelined simulator, its lowerings and serving driver
    summary["sim_pipelined"] = run_sim_pipelined(torch, smi_line)
    clock.lap("sim_pipelined")
    out_json.write_text(json.dumps(summary, indent=1))

    # ---- phase 3: serving, and the full-width Mamba block
    summary["serve"] = run_serving(torch, summary, SERVE_MODELS, run_serve)
    out_json.write_text(json.dumps(summary, indent=1))
    summary["mamba_block"] = run_mamba_block(torch)
    clock.lap("serve")
    out_json.write_text(json.dumps(summary, indent=1))

    # ---- phase 3b: serving the models whose prompts carry embeddings
    summary["serve_embeds"] = run_serving(torch, summary, EMBED_MODELS,
                                          run_embed_serve)
    clock.lap("serve_embeds")
    out_json.write_text(json.dumps(summary, indent=1))

    # ---- phase 5: training, and the trained weights served from their checkpoint
    summary["train"] = run_train(torch, summary)
    clock.lap("train")
    out_json.write_text(json.dumps(summary, indent=1))

    # ---- phase 5b: the multi-device layer on a world of one NCCL rank
    summary["multi_device"] = run_multi_device(torch, summary)
    clock.lap("multi_device")
    out_json.write_text(json.dumps(summary, indent=1))

    if failures:
        fail("; ".join(failures))

    # ---- phase 6: result
    kernels = []
    for name, (src, replaces, wrapper, phase, rep, rep_dt) in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        pick = next((r for r in mine if r["case"].startswith(rep) and r["dtype"] == rep_dt),
                    mine[0] if mine else None)
        runs = [summary[phase]] + ([summary["serve_embeds"], summary["train"]["serve"],
                                    summary["multi_device"]["serve"]]
                                   if phase == "serve" else
                                   [summary["sim"], summary["sim_pipelined"]])
        variants = {}
        for run in runs:
            for v, n in run.get("variants", {}).get(wrapper, {}).items():
                variants[v] = variants.get(v, 0) + n
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(run["launches"][wrapper] for run in runs),
            "variants": variants or None,
            "case": f"{pick['case']} {pick['dtype']}" if pick else None,
            **{k: (pick[k] if pick else None) for k in keys},
        }
        if phase == "serve":     # launches by served model
            entry["launches_by_model"] = {
                a: m["launches"][wrapper] for run in runs
                for a, m in run.get("models", {}).items()}
            entry["launches_by_model"]["trained granite (phase 5)"] = \
                summary["train"]["serve"]["launches"][wrapper]
            entry["launches_by_model"]["restored granite (phase 5b)"] = \
                summary["multi_device"]["serve"]["launches"][wrapper]
        if name == "gemm":       # and by the full-width Mamba block's run
            entry["launches_mamba_block"] = summary["mamba_block"]["gemm_launches"]
        more = [r for r in mine if r["dtype"] in ("bfloat16", "int8")
                and r["case"].startswith(MORE_CASES.get(name, ()))]
        if more:                 # this slice's own rows of the kernel
            entry["more_cases"] = [{"case": f"{r['case']} {r['dtype']}",
                                    "variant": r.get("variant"),
                                    **{k: r[k] for k in keys}} for r in more]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
