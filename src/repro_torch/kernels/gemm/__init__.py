from repro_torch.kernels.gemm.ops import gemm  # noqa: F401
