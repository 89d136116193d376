"""Device meshes over the ranks of an initialised process group
(counterpart of repro.launch.mesh).

Both factories are functions: importing this module touches no process
group. The mesh's device type follows the group's backend: NCCL meshes
are on the card, gloo meshes on the CPU (a CPU mesh is what the caller
asks for by initialising gloo); "fake", torch's testing process group that
lets one process stand in for every rank of a world and moves no data,
builds CPU meshes.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DEVICE_OF_BACKEND = {"nccl": "cuda", "gloo": "cpu", "fake": "cpu"}


def mesh_device_type() -> str:
    backend = dist.get_backend()
    if backend not in DEVICE_OF_BACKEND:
        raise ValueError(f"no mesh device for process-group backend "
                         f"{backend!r}; use one of {sorted(DEVICE_OF_BACKEND)}")
    return DEVICE_OF_BACKEND[backend]


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(data, model) = (16, 16), or (pod, data, model) = (2, 16, 16): a
    world of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1) -> DeviceMesh:
    """(data, model) = (world // model_axis, model_axis) over every rank of
    the default process group (tests, examples, the launcher)."""
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"a model axis of {model_axis} does not divide a "
                         f"world of {n} ranks")
    return init_device_mesh(mesh_device_type(), (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
