"""Training launcher: mesh setup, sharded state, a fault-tolerant loop
(counterpart of repro.launch.train).

  * **checkpoint/restart**: CheckpointManager (atomic, async); resume is
    automatic from <ckpt_dir>/LATEST, and the data pipeline regenerates the
    exact stream from the step counter alone.
  * **preemption handling**: SIGTERM/SIGINT trigger a synchronous save at
    the next step boundary before exit.
  * **step watchdog**: a step that takes more than ``--watchdog-factor`` ×
    the trailing median is logged as a straggler and counted.

The step runs on ``ArcaneEngine("ref")`` (``--backend``): the CUDA kernels
have no backward (``train/step.py`` refuses any other engine). Train on the
card::

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m --steps 50 --batch 8 --seq 512

or on the CPU at the reduced config::

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 20

A multi-process launch (one process a rank, ``torchrun``-style environment:
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, and
``LOCAL_RANK`` for the card) runs on a mesh: ``(world // --model-axis,
--model-axis)`` over ``("data", "model")``, or with ``--production-mesh``
the reference's (16, 16) (256 ranks). NCCL on the card, gloo with
``--device cpu``. The params are DTensors under ``param_pspecs``, the
optimizer state under ``zero_pspecs``; the step (``train/step.py``'s
``sharded_step``) splits the batch over the data axis and computes
tensor-parallel over the model axis (each rank its heads, FFN columns,
experts and vocab shard: ``distributed/tensor_parallel.py``). Every rank
reads the same global batch;
only rank 0 prints the step lines and writes checkpoints. On the CPU::

    RANK=0 WORLD_SIZE=4 MASTER_ADDR=localhost MASTER_PORT=29511 \
        PYTHONPATH=src python -m repro_torch.launch.train --smoke \
        --device cpu --model-axis 2 --steps 4 &   # and RANK=1, 2, 3

A mesh that needs more than one process, in one process, raises
``ValueError``; a single process with ``--model-axis 1`` runs on one device
with no process group. ``train(cfg, args)`` runs the loop on a config of
the caller's (a cut depth, say).
"""
from __future__ import annotations

import argparse
import os
import signal
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import ArcaneEngine
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.distributed.sharding import (distribute, param_pspecs,
                                              to_shardings, zero_pspecs)
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.transformer import LM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step


class Preemption:
    """SIGTERM/SIGINT set ``flag`` while the run lasts; ``close`` puts the
    earlier handlers back."""

    def __init__(self):
        self.flag = False
        self._saved = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._saved[sig] = signal.signal(sig, self._handler)
            except ValueError:
                pass  # not main thread

    def _handler(self, signum, frame):
        self.flag = True

    def close(self):
        for sig, handler in self._saved.items():
            signal.signal(sig, handler)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1,
                    help="the mesh's model axis (a multi-process launch)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--watchdog-factor", type=float, default=5.0)
    ap.add_argument("--backend", default="ref",
                    help="the engine; a train step takes only 'ref'")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) mesh: a launch of 256 processes")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda); 'cpu' for the plain path")
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """Train ``--arch`` (its smoke config with ``--smoke``); see ``train``."""
    args = parse_args(argv)
    return train(get_smoke_config(args.arch) if args.smoke
                 else get_config(args.arch), args)


def train(cfg: ModelConfig, args: argparse.Namespace) -> dict:
    """Train ``cfg`` as ``args`` say; → {"history": each step's loss,
    "stragglers", "final_loss", "steps": each step's loss, grad_norm, lr
    and ms}."""
    device = resolve_device(args.device)
    distributed = init_distributed(args, device)
    try:
        return _train(cfg, args, device, distributed)
    finally:
        if distributed:
            dist.destroy_process_group()


def init_distributed(args: argparse.Namespace, device: torch.device) -> bool:
    """Joins the process group of a multi-process launch (``WORLD_SIZE`` >
    1 in the environment): NCCL on the card (``LOCAL_RANK``'s), gloo on
    the CPU. → whether it did. A mesh of more than one rank in a single
    process raises ``ValueError``."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        if args.model_axis > 1 or args.production_mesh:
            raise ValueError(
                "--model-axis > 1 and --production-mesh need a mesh of more "
                "than one rank: launch one process a rank with RANK, "
                "WORLD_SIZE, MASTER_ADDR and MASTER_PORT set (torchrun does)")
        return False
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return True


def _train(cfg: ModelConfig, args: argparse.Namespace, device: torch.device,
           distributed: bool) -> dict:
    model = LM(cfg, ArcaneEngine(backend=args.backend), device=device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                          total_steps=args.steps)
    source = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch))
    params, opt_state = init_train_state(
        model, opt_cfg, torch.Generator(device=device).manual_seed(0))
    restore_to = {"device": device}
    grad_sh = None
    if distributed:
        mesh = (make_production_mesh() if args.production_mesh
                else make_host_mesh(args.model_axis))
        p_sh = to_shardings(param_pspecs(params, mesh), mesh)
        o_sh = to_shardings(zero_pspecs(opt_state, mesh), mesh)
        grad_sh = to_shardings(zero_pspecs(params, mesh), mesh)
        params, opt_state = distribute(params, p_sh), distribute(opt_state, o_sh)
        restore_to = {"shardings": {"params": p_sh, "opt": o_sh}}
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches,
                              grad_shardings=grad_sh)
    log = print if not distributed or dist.get_rank() == 0 else \
        (lambda *a, **kw: None)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        state, _ = ckpt.restore(start_step, {"params": params, "opt": opt_state},
                                **restore_to)
        params, opt_state = state["params"], state["opt"]
        log(f"[resume] from step {start_step}")

    preempt = Preemption()
    durations: list[float] = []
    stragglers = 0
    history, steps = [], []
    it = Prefetcher(source, start_step=start_step, device=device)
    try:
        for step in range(start_step, args.steps):
            batch = next(it)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])           # waits for the device
            dt = time.perf_counter() - t0
            durations.append(dt)
            if len(durations) > 8:
                med = statistics.median(durations[-32:])
                if dt > args.watchdog_factor * med:
                    stragglers += 1
                    log(f"[watchdog] step {step}: {dt:.2f}s vs median "
                          f"{med:.2f}s — straggler/hang suspected")
            history.append(loss)
            steps.append({"step": step, "loss": loss,
                          "grad_norm": float(metrics["grad_norm"]),
                          "lr": float(metrics["lr"]), "ms": dt * 1e3})
            if step % 10 == 0 or step == args.steps - 1:
                log(f"step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} {dt:.2f}s")
            stop = preempt.flag
            if distributed:     # a signal to one rank stops them all
                flag = torch.tensor(int(stop), device=device)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                stop = bool(flag)
            if ckpt is not None and ((step + 1) % args.ckpt_every == 0
                                     or stop or step == args.steps - 1):
                ckpt.save(step + 1, {"params": params, "opt": opt_state},
                          extra={"loss": loss}, blocking=stop)
            if stop:
                log(f"[preempt] checkpoint at step {step + 1}, exiting")
                break
    finally:
        preempt.close()
        it.close()
        if ckpt is not None:
            ckpt.wait()
    return {"history": history, "stragglers": stragglers,
            "final_loss": history[-1] if history else None, "steps": steps}


if __name__ == "__main__":
    run()
