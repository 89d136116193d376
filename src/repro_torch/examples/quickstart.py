"""Quickstart: train a small LM for a few steps and sample from it
(counterpart of examples/quickstart.py).

Shows the public API surface: config registry → LM → train step → serving
session. The step trains on ArcaneEngine("ref") (the kernels have no
backward); the session serves the trained weights through the default
engine, which on the card runs the CUDA kernels::

    PYTHONPATH=src python -m repro_torch.examples.quickstart            # card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import ArcaneEngine
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
from repro_torch.models.transformer import LM, tree_leaves
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.serving.engine import ServeSession
from repro_torch.train.step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config("gemma2-9b")      # any of the 10 archs trains
    model = LM(cfg, ArcaneEngine(backend="ref"), device=device)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    print(f"arch={cfg.name} params={sum(x.numel() for x in tree_leaves(params)):,}")

    opt_cfg = AdamWConfig(lr=3e-3, total_steps=40, warmup_steps=4)
    opt = adamw_init(opt_cfg, params)
    step = make_train_step(model, opt_cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8))
    for i in range(40):
        params, opt, m = step(params, opt, to_device(data.batch_at(i), device))
        if i % 10 == 0 or i == 39:
            print(f"step {i:3d}  loss {float(m['loss']):.4f}  "
                  f"lr {float(m['lr']):.2e}")

    server = LM(cfg, ArcaneEngine(backend="auto"), device=device)
    sess = ServeSession(server, params, max_slots=2, max_len=128)
    prompt = np.asarray(data.batch_at(0)["tokens"][0, :8], np.int32)
    req = sess.submit(prompt, max_new_tokens=12)
    sess.run_to_completion()
    print("prompt :", prompt.tolist())
    print("sampled:", req.out_tokens)
    return req.out_tokens


if __name__ == "__main__":
    main()
