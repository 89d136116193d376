"""Pipeline parallelism: GPipe-style microbatch pipeline over a process
group (counterpart of repro.distributed.pipeline).

Rank ``s`` of the group owns stage ``s``'s parameters; activations flow
stage→stage+1 each tick by point-to-point sends
(``dist.batch_isend_irecv``, the reference's ``ppermute``); with M
microbatches and S stages the schedule runs M+S-1 ticks at bubble fraction
(S-1)/(M+S-1). As in the reference every stage computes at every tick, and
the last stage's output is sent to every rank at the end.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

PyTree = Any


def pipeline_forward(stage_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
                     stage_params: PyTree, x: torch.Tensor, *, group=None,
                     n_micro: int) -> torch.Tensor:
    """Run ``y = stage_{S-1}(... stage_0(x))`` as a microbatch pipeline;
    every rank of ``group`` calls this.

    stage_params: this rank's stage (rank ``s`` of the group runs stage
    ``s``). x: (batch, ...) with batch % n_micro == 0, the same on every
    rank (stage 0 reads it). ``stage_fn`` keeps the activation's shape.
    Returns the last stage's output on every rank.
    """
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    if x.shape[0] % n_micro:
        raise ValueError(f"a batch of {x.shape[0]} does not split into "
                         f"{n_micro} microbatches")
    micro = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
    peer = (lambda s: dist.get_global_rank(group, s)) if group is not None \
        else (lambda s: s)
    buf = torch.zeros_like(micro[0])     # stage 0 receives nothing: zeros
    out = torch.zeros_like(micro)
    for t in range(n_micro + n_stages - 1):
        # stage 0 injects microbatch t (if in range); others use received
        x_in = micro[min(max(t, 0), n_micro - 1)] if stage == 0 else buf
        y = stage_fn(stage_params, x_in)
        # pass activations down the pipe
        ops = []
        if stage < n_stages - 1:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), peer(stage + 1),
                                  group))
        if stage > 0:
            buf = torch.empty_like(micro[0])
            ops.append(dist.P2POp(dist.irecv, buf, peer(stage - 1), group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        # last stage collects microbatch t-(S-1)
        if stage == n_stages - 1 and t >= n_stages - 1:
            out[t - (n_stages - 1)] = y
    # the result, from the last stage to all
    dist.broadcast(out, peer(n_stages - 1), group=group)
    return out.reshape(x.shape)
