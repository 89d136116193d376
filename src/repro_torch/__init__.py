"""repro_torch — the ARCANE production stack on PyTorch and CUDA (Hopper).

A second package beside ``repro`` (the JAX/Pallas reference). It mirrors the
reference's layout module for module and imports nothing of it: what it needs
of ``repro``'s jax-free modules (configs, instruction encoding) it keeps as
its own copy. Matrix operations go through ``core.engine.ArcaneEngine``,
which dispatches hand-written CUDA C++ kernels (``csrc/*.cu``, compiled with
``nvcc`` for ``sm_90a`` at first use) on CUDA tensors and plain PyTorch on
CPU tensors.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
