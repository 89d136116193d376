"""Serving launcher: batched continuous decoding on one device
(counterpart of repro.launch.serve).

Usage (on a machine with an NVIDIA H100; the kernels build at first use)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --requests 6 --max-new 16 --max-len 1024 --prompt-len 16 512

``--arch`` is an id of ``SERVED``: stablelm-3b, gemma2-9b, qwen2.5-32b,
granite-moe-1b-a400m, llama4-scout-17b-a16e (at 203 GB in bf16, only
``--smoke`` fits one card), minicpm3-4b, rwkv6-1.6b and
jamba-1.5-large-398b (about 800 GB in bf16: only ``--smoke``). The
session takes token prompts only, as the reference's does: internvl2-1b
and whisper-large-v3 (a vision prefix, an encoder) are refused with a
``ValueError`` and run through ``LM.prefill`` and ``LM.decode_step``.
``--device cpu --backend ref`` runs the plain PyTorch path on the CPU,
``--smoke`` the arch's reduced config. The weights are random, drawn on the
device from ``--seed``.

The recurrent archs keep the reference's prompt-length contract: a prompt
longer than the scan's chunk (rwkv6 64, jamba's Mamba 128; 16 in both
smoke configs) must be a multiple of it, and a jamba prompt must hold at
least 3 tokens (its conv state). A prompt that breaks it raises
``ValueError`` when it is submitted; ``--prompt-lens`` draws the lengths
from a list instead of a range, e.g.::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --smoke --device cpu --prompt-lens 4 9 16 32
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.models.transformer import LM
from repro_torch.serving.engine import (ServeSession, check_token_prompts,
                                        takes_token_prompts)

# the archs the session serves: those whose prompts are tokens alone
SERVED = tuple(a for a in ARCHS if takes_token_prompts(get_config(a)))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    # any id of ARCHS parses, so that build() refuses the others with the
    # session's own ValueError, which says how to run them
    ap.add_argument("--arch", default="gemma2-9b", choices=ARCHS,
                    help="one of " + ", ".join(SERVED) + " (the others' "
                    "prompts need embeddings: LM.prefill, LM.decode_step)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(4, 24),
                    metavar=("MIN", "MAX"),
                    help="prompt lengths are drawn from [MIN, MAX)")
    ap.add_argument("--prompt-lens", type=int, nargs="+", default=None,
                    metavar="N", help="prompt lengths are drawn from these "
                    "(in place of --prompt-len)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="auto", choices=("auto", "cuda", "ref"))
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """(model, params) for the arguments, weights drawn on the device."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    check_token_prompts(cfg)        # before the weights are drawn
    device = resolve_device(args.device)
    model = LM(cfg, ArcaneEngine(backend=args.backend), device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return model, model.init_params(gen)


def serve(model: LM, params, args: argparse.Namespace) -> dict:
    """Serve ``args.requests`` random prompts to completion."""
    sess = ServeSession(model, params, max_slots=args.slots,
                        max_len=args.max_len, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    lo, hi = args.prompt_len
    for _ in range(args.requests):
        plen = int(rng.choice(args.prompt_lens) if args.prompt_lens
                   else rng.integers(lo, hi))
        sess.submit(rng.integers(0, model.cfg.vocab, plen),
                    max_new_tokens=args.max_new)
    t0 = time.perf_counter()
    done = sess.run_to_completion()
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out_tokens) for r in done)
    return {"requests": len(done), "submitted": args.requests,
            "tokens": tokens, "seconds": dt, "session": sess}


def run(argv=None) -> dict:
    args = parse_args(argv)
    model, params = build(args)
    out = serve(model, params, args)
    print(f"served {out['requests']} requests, {out['tokens']} tokens in "
          f"{out['seconds']:.2f}s ({out['tokens'] / out['seconds']:.1f} tok/s) "
          f"on {model.device}")
    return out


if __name__ == "__main__":
    run()
