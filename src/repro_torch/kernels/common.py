"""Shared helpers for the kernel suite (counterpart of repro.kernels.common)."""
from __future__ import annotations

import torch


def is_integer(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex \
        and dtype != torch.bool


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator type: int32 for integer datapaths, f32 otherwise."""
    return torch.int32 if is_integer(dtype) else torch.float32


# dtype codes of the CNN-path kernels (csrc/elem.cuh elem::Code)
ELEM_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.int32: 3, torch.int16: 4}

NEG_INF = float(-1e30)   # mask value that survives bf16 rounding

# launches a CNN wrapper keeps (checks passed and parameters made, by key)
# before its cache starts again
LAUNCH_KEYS = 1024


class LaunchCache(dict):
    """A wrapper's launches by key: what the key decides (its checks passed,
    the launch's parameters made) is worked out once. A call looks its key
    up with ``get`` and, on a miss, ``make``s it."""

    def make(self, key, build, *args):
        """build(*args), kept under key (the cache starts again once it
        holds LAUNCH_KEYS); build raises where the key's checks fail."""
        if len(self) >= LAUNCH_KEYS:
            self.clear()
        launch = self[key] = build(*args)
        return launch


def check_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on the same CUDA device."""
    index = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{what}: the kernel takes CUDA tensors on one "
                             f"device, got {t.device} (and {tensors[0].device})")


def check_dtype(what: str, t: torch.Tensor, allowed) -> None:
    if t.dtype not in allowed:
        raise ValueError(f"{what}: dtype {t.dtype} not in {sorted(map(str, allowed))}")


def stream_ptr(t: torch.Tensor) -> int:
    """The raw pointer of the current stream of CUDA tensor t's device, the
    same as ``torch.cuda.current_stream(t.device).cuda_stream`` without a
    Stream object per call."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def ceil_div(x: int, y: int) -> int:
    return -(-x // y)


_SMS: dict = {}


def sm_count(device: torch.device) -> int:
    """The card's SM count (read once per device): the split plans size
    their grids by it."""
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = \
            torch.cuda.get_device_properties(device).multi_processor_count
    return n


def strides_of(t: torch.Tensor) -> tuple:
    """t.stride() with the stride of every size-1 dimension set to 0: it is
    never stepped, and PyTorch leaves it arbitrary."""
    return tuple(0 if n == 1 else s for s, n in zip(t.stride(), t.shape))


def aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0
