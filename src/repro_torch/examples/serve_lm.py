"""Serving demo: continuous-batching decode over the cache-resident kernels
(counterpart of examples/serve_lm.py).

Eight requests with ragged prompt lengths share four slots; requests are
admitted as slots free up (continuous batching). Per-request output and the
aggregate tokens/s are reported. On the card the default engine runs the
CUDA kernels::

    PYTHONPATH=src python -m repro_torch.examples.serve_lm            # card
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.models.transformer import LM
from repro_torch.serving.engine import ServeSession


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config("qwen2.5-32b")
    model = LM(cfg, ArcaneEngine(backend="auto"), device=device)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    sess = ServeSession(model, params, max_slots=4, max_len=192)

    rng = np.random.default_rng(7)
    reqs = []
    for i in range(8):
        plen = int(rng.integers(4, 32))
        reqs.append(sess.submit(rng.integers(0, cfg.vocab, plen),
                                max_new_tokens=16,
                                temperature=0.0 if i % 2 else 0.8))
    t0 = time.perf_counter()
    steps = 0
    while sess.pending or any(s is not None for s in sess.slots):
        sess.step()
        steps += 1
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in reqs)
    print(f"served {len(reqs)} ragged requests in {steps} engine steps, "
          f"{dt:.2f}s → {total / dt:.1f} tok/s aggregate on {device}")
    for r in reqs[:3]:
        print(f"  req{r.uid}: prompt[{len(r.prompt)}] → {r.out_tokens[:8]}…")
    return reqs


if __name__ == "__main__":
    main()
