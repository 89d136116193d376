"""Hand-written Hopper kernels of the main path, one package each.

Each package: kernel.py (the CUDA C++ kernel's ctypes wrapper, with its
``launches`` count), ref.py (the plain PyTorch version), ops.py (the public
function: the kernel for CUDA tensors, the plain version for CPU tensors).
The sources are ``repro_torch/csrc/*.cu``.
"""
from repro_torch.kernels.gemm.ops import gemm
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.convlayer.ops import conv_layer
from repro_torch.kernels.maxpool.ops import maxpool
from repro_torch.kernels.leakyrelu.ops import leakyrelu

__all__ = ["gemm", "flash_attention", "decode_attention", "conv_layer",
           "maxpool", "leakyrelu"]
