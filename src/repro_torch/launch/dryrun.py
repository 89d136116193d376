"""Production-mesh dry-run: trace every (arch × shape × mesh) cell in one
process, with no card and no weights (counterpart of repro.launch.dryrun).

One process joins torch's fake process group (``"fake"``: it stands in for
every rank of a world and moves no data) as rank 0 of 256 ranks, the
(data, model) = (16, 16) mesh of ``make_production_mesh()``, or of 512,
the (pod, data, model) = (2, 16, 16) mesh of ``multi_pod=True``. Each cell's
step then runs once under ``FakeTensorMode`` (tensors with shapes, dtypes
and devices but no data), on the rank's local shards laid out as the
sharding rules lay them:

* **train** cells run ``train/step.py: make_train_step`` on DTensor params
  (``param_pspecs``, ZeRO-3 for ``FSDP_ARCHS``) and AdamW state
  (``zero_pspecs``), which is ``sharded_step``: the params gathered over
  the data axes with their ``model`` shards kept, the model run
  tensor-parallel over ``model`` (head-parallel attention, or attention on
  the rules' column blocks where the q heads are not whole GQA groups a
  rank, column/row FFN, expert-parallel MoE, vocab-parallel embedding,
  unembedding and
  loss: ``distributed/tensor_parallel.py``), the batch split over the data
  axes, the grads reduce-scattered to the ZeRO shards, the global norm
  all-reduced.
* **prefill** and **decode** cells run ``train/step.py: serve_on_mesh``,
  the serve steps laid over the mesh the same way: the params' ``model``
  shards kept, the cache laid out by ``cache_pspecs`` and computed on where
  it is (a head-parallel layer's heads, a sequence slice of every kv head
  (a layer by heads or on column blocks)
  or of MLA's latents (``--ring-local-cache``: of a ring's slots), whose
  decode merges the ranks' partial softmaxes, a recurrent mixer's heads or
  channels), the batch split over the axes that shard the cache's rows
  (an MoE layer whose dispatch groups do not fall into whole groups a
  rank shares its expert ids and capacity rows over them,
  ``models/moe.py``).

The leaves a rank gathers over ``model`` to compute whole (an MLA whose
heads do not divide the axis, a mixer whose leaves the rules do not split
on its heads or channels, and the caches such layers read) are listed in
the record, ``gathered_over_model`` (path: why). An attention whose q
heads are not whole GQA groups a rank gathers none: it runs on column
blocks, its activations gathered.

Three counters watch the step, all over executed ops:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``, per rank (the
  products: matmuls, batched matmuls, convolutions, attention: a rank's
  share of the tensor-parallel products).
* ``bytes_accessed``: the operand and result bytes of every op executed on
  the rank's local tensors, views and collectives left out. These are
  **unfused** eager bytes (``bytes_accessed_kind`` says so): XLA's figure
  is post-fusion, so the two are not comparable.
* ``collective_bytes``: the bytes of the tensors each collective returns,
  by op, over the collectives the step issues: DTensor's redistributions
  (the gathers over the data axes, reduce-scatters), the model axis'
  collectives inside the model and the plain ``dist.all_reduce`` of the
  norm and the metrics. ``collective_calls`` counts them by
  ``CommDebugMode`` (checked against the census's own count).

``memory.peak_bytes`` is ``torch.distributed._tools.mem_tracker.MemTracker``'s
peak over the step with the rank's arguments counted from the start;
``memory.argument_bytes`` is the exact sum of the rank's local argument
bytes (its shards of the params, the optimizer state or the cache, and the
batch, which every rank of the port's steps receives whole). What a trace
cannot know is written as ``null``: ``memory.output_bytes``,
``memory.temp_bytes`` and ``memory.alias_bytes`` (XLA's buffer
assignment; eager PyTorch has none). ``seconds`` is the trace's host time
(the reference's ``seconds_to_compile``).

Not carried over from the reference: ``extrapolate``, ``LM(unroll=)`` and
the HLO regexes, nor the ``--no-roofline`` flag that ran them. XLA's
``cost_analysis`` counts a scan body once, so the reference compiled one and
two periods and extrapolated; a counter over executed ops sees every layer
of the port's Python loop, so the record is already whole-depth
(``tests/test_torch_dryrun.py`` holds the FLOPs linear in depth).

The cells trace on ``ArcaneEngine("ref")``, as the reference lowers on its
ref backend. The ``cuda`` backend's kernels are ctypes launches on raw
device pointers: a fake tensor has none, and ``FlopCounterMode`` cannot see
a ctypes launch; ``--backend cuda`` raises.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b \\
        --shape decode_32k --mesh single --out results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Optional, Union

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, get_config, grid
from repro_torch.core.engine import ArcaneEngine
from repro_torch.distributed.sharding import (P, batch_axes, cache_pspecs,
                                              map_with_path, param_pspecs,
                                              placements, set_activation_mesh,
                                              to_shardings, zero_pspecs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import FSDP_ARCHS, input_specs, opt_config_for
from repro_torch.models.transformer import LM, tree_leaves, tree_map
from repro_torch.train.step import make_train_step, serve_on_mesh, tp_view

PyTree = Any

# the collectives of the census, by op packet, under the reference's names
COLLECTIVES = {
    **{f"{ns}.{op}": name for ns in ("_c10d_functional", "c10d_functional")
       for op, name in (("all_gather_into_tensor", "all-gather"),
                        ("all_gather_into_tensor_coalesced", "all-gather"),
                        ("all_reduce", "all-reduce"),
                        ("all_reduce_", "all-reduce"),
                        ("all_reduce_coalesced", "all-reduce"),
                        ("reduce_scatter_tensor", "reduce-scatter"),
                        ("reduce_scatter_tensor_coalesced", "reduce-scatter"),
                        ("all_to_all_single", "all-to-all"),
                        ("broadcast", "broadcast"))},
    "c10d.allreduce_": "all-reduce", "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather", "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all", "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "broadcast", "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(t) for t in tree.values())
    return 0


class OpCensus(TorchDispatchMode):
    """Over the ops executed on local tensors (a DTensor op is let through
    to DTensor, whose local ops come back here): the operand and result
    bytes of every op that is neither a view nor a collective, and the
    bytes each collective returns and its calls, by op. An op that returns
    no tensor moves no bytes."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.collective_bytes: dict[str, int] = {}
        self.collective_calls: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = getattr(func, "_overloadpacket", None)
        name = COLLECTIVES.get(str(packet))
        if name is not None:
            self.collective_bytes[name] = (self.collective_bytes.get(name, 0)
                                           + _tensor_bytes(out))
            self.collective_calls[name] = self.collective_calls.get(name, 0) + 1
        elif not getattr(func, "is_view", False):
            written = _tensor_bytes(out)
            if written:          # metadata queries (prim.device) move nothing
                self.bytes_accessed += (_tensor_bytes(args)
                                        + _tensor_bytes(kwargs) + written)
        return out


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """The default process group as torch's fake one: ``world_size`` ranks
    stood in for by this process as ``rank``; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the fake "
                           "world needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- local shards
@dataclasses.dataclass(frozen=True)
class LocalShard:
    """A leaf's layout on this rank: the whole leaf (meta), its placements
    and the shape of this rank's shard (the rules shard only dims that
    divide)."""
    meta: torch.Tensor
    placements: tuple
    shape: tuple

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.meta.element_size()


def _layout(tree: PyTree, pspecs: PyTree, mesh) -> PyTree:
    """A ``LocalShard`` per leaf of ``tree`` under ``pspecs`` (computed
    outside the fake mode)."""
    flat: dict = {}
    map_with_path(lambda ps, s: flat.__setitem__(ps, s), pspecs)

    def shard(ps, t):
        pl = placements(flat[ps], mesh)
        local = list(t.shape)
        for p, n in zip(pl, mesh.shape):
            if p.is_shard():
                if local[p.dim] % n:
                    raise ValueError(f"{ps}: dim {p.dim} of {tuple(t.shape)} "
                                     f"does not split over {n} ranks")
                local[p.dim] //= n
        return LocalShard(t, pl, tuple(local))

    return map_with_path(shard, tree)


def _fake_dtensors(layout: PyTree, mesh) -> PyTree:
    """Fake local shards wrapped as DTensors (inside the fake mode)."""
    from torch.distributed.tensor import DTensor

    def make(leaf: LocalShard):
        shard = torch.empty(leaf.shape, dtype=leaf.meta.dtype,
                            device=mesh.device_type)
        return DTensor.from_local(shard, mesh, leaf.placements,
                                  run_check=False, shape=leaf.meta.shape,
                                  stride=leaf.meta.stride())

    return tree_map(make, layout)


# ------------------------------------------------------------ one cell
def trace_cell(arch: str, shape_name: Union[str, ShapeConfig], mesh, *,
               backend: str = "ref", constrain_acts: bool = False,
               cfg_overrides: Optional[dict] = None,
               microbatches: int = 1) -> dict:
    """Trace one cell on ``mesh`` (a mesh of the fake world) under
    ``FakeTensorMode``; returns its record (module docstring).
    ``shape_name`` is a key of ``SHAPES`` or a ``ShapeConfig`` of the
    caller's; ``microbatches`` splits a train cell's step as the train
    launcher's flag does."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode
    if backend != "ref":
        raise ValueError(
            f"the dry-run traces on ArcaneEngine('ref'), not {backend!r}: the "
            f"CUDA kernels are ctypes launches on raw device pointers, which "
            f"fake tensors do not have, and FlopCounterMode cannot see them")
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    model = LM(cfg, ArcaneEngine("ref"), device=mesh.device_type)
    specs = input_specs(arch, shape, model)
    fsdp = arch in FSDP_ARCHS
    t0 = time.perf_counter()

    p_lay = _layout(specs["params"], param_pspecs(specs["params"], mesh,
                                                  fsdp=fsdp), mesh)
    if shape.kind == "train":        # the AdamW state, ZeRO-sharded
        zero = zero_pspecs(specs["params"], mesh)
        s_lay = _layout(specs["opt_state"], {"master": zero, "m": zero,
                                             "v": zero, "step": P()}, mesh)
    else:
        s_lay = _layout(specs["cache"], cache_pspecs(specs["cache"], mesh), mesh)
    argument_bytes = sum(leaf.nbytes for leaf in tree_leaves((p_lay, s_lay))) \
        + _tensor_bytes(specs["batch"])
    bax = batch_axes(mesh)
    if len(bax) > 1:
        # the steps' group over the batch axes, flattened here: a mesh is
        # built from real rank numbers, which the fake mode does not have
        mesh[bax]._flatten()

    census, mem = OpCensus(), MemTracker()
    set_activation_mesh(mesh if constrain_acts else None)
    try:
        with FakeTensorMode():
            params, state = _fake_dtensors(p_lay, mesh), _fake_dtensors(s_lay, mesh)
            batch = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                                   device=mesh.device_type),
                             specs["batch"])
            mem.track_external(*(t.to_local() for t in tree_leaves((params, state))),
                               *tree_leaves(batch))
            with FlopCounterMode(display=False) as flops, \
                    CommDebugMode() as comm, mem, census:
                if shape.kind == "train":
                    g_sh = (to_shardings(zero_pspecs(specs["params"], mesh), mesh)
                            if constrain_acts else None)
                    step = make_train_step(model, opt_config_for(arch),
                                           microbatches=microbatches,
                                           grad_shardings=g_sh)
                    step(params, state, batch)
                else:
                    serve_on_mesh(model, "prefill" if shape.kind == "prefill"
                                  else "decode", params, state, batch, mesh,
                                  enc_len=shape.seq_len if cfg.enc_dec else 0)
            plan = tp_view(model, params, mesh,
                           None if shape.kind == "train" else state)[0].tp
    finally:
        set_activation_mesh(None)

    calls: dict[str, int] = {}
    for packet, n in comm.get_comm_counts().items():
        name = COLLECTIVES.get(str(packet))
        if name is None:
            raise RuntimeError(f"CommDebugMode counted {packet}, which the "
                               f"census does not know")
        calls[name] = calls.get(name, 0) + n
    if calls != census.collective_calls:
        raise RuntimeError(f"the census counted {census.collective_calls} "
                           f"collectives, CommDebugMode {calls}")
    peak = max((snap["Total"] for snap in
                mem.get_tracker_snapshot("peak").values()), default=0)
    return {
        "arch": arch,
        "shape": shape.name,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "n_devices": int(math.prod(mesh.shape)),
        "backend": backend,
        "seconds": time.perf_counter() - t0,
        "flops": float(flops.get_total_flops()),
        "bytes_accessed": float(census.bytes_accessed),
        "bytes_accessed_kind": "unfused: eager operand + result bytes",
        "collective_bytes": dict(sorted(census.collective_bytes.items())),
        "collective_calls": dict(sorted(calls.items())),
        "memory": {
            "argument_bytes": int(argument_bytes),
            "output_bytes": None,
            "temp_bytes": None,
            "peak_bytes": int(peak),
            "alias_bytes": None,
        },
        "gathered_over_model": dict(plan.gathered),
        "model": {
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
        },
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch x shape) cell")
    ap.add_argument("--backend", default="ref",
                    help="engine backend to trace on (ref only: the cuda "
                         "kernels cannot run on fake tensors)")
    ap.add_argument("--constrain-acts", action="store_true",
                    help="apply activation sharding constraints")
    ap.add_argument("--ring-local-cache", action="store_true",
                    help="window-sized ring KV cache for local layers")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in ARCHS:
            for sh in grid(arch):
                cells.append((arch, sh.name))
    elif args.arch and args.shape:
        cells.append((args.arch, args.shape))
    else:
        ap.error("--arch and --shape, or --all")

    meshes = [(m, multi) for m, multi in (("single", False), ("multi", True))
              if args.mesh in (m, "both")]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for mesh_name, multi in meshes:
        with fake_world(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi)
            for arch, shape_name in cells:
                tag = f"{arch}__{shape_name}__{mesh_name}"
                out_path = os.path.join(args.out, tag + ".json")
                if os.path.exists(out_path):
                    print(f"[skip] {tag}")
                    continue
                try:
                    ov = ({"ring_local_cache": True}
                          if args.ring_local_cache else None)
                    rec = trace_cell(arch, shape_name, mesh,
                                     backend=args.backend,
                                     constrain_acts=args.constrain_acts,
                                     cfg_overrides=ov)
                except Exception as e:
                    failures += 1
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
                    traceback.print_exc()
                    continue
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
                mem = rec["memory"]
                print(f"[ok]   {tag}: trace={rec['seconds']:.1f}s "
                      f"flops={rec['flops']:.3e} "
                      f"peak/dev={mem['peak_bytes'] / 2**30:.2f}GiB "
                      f"args/dev={mem['argument_bytes'] / 2**30:.2f}GiB "
                      f"coll/dev="
                      f"{sum(rec['collective_bytes'].values()) / 2**20:.1f}MiB")
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
