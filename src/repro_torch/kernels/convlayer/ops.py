"""Public xmk4 fused conv layer: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.convlayer.kernel import conv_layer_cuda
from repro_torch.kernels.convlayer.ref import conv_layer_ref


def conv_layer(x: torch.Tensor, f: torch.Tensor, *,
               negative_slope: float = 0.0, out_dtype=None) -> torch.Tensor:
    """Fused conv(valid)+maxpool(2×2/2)+LeakyReLU — the xmk4 instruction.

    x: (C, H, W); f: (F, C, KH, KW) → (F, (H-KH+1)//2, (W-KW+1)//2).
    """
    fn = conv_layer_cuda if x.is_cuda else conv_layer_ref
    return fn(x, f, negative_slope=negative_slope, out_dtype=out_dtype)
