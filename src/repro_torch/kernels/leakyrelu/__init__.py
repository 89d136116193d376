from repro_torch.kernels.leakyrelu.ops import leakyrelu  # noqa: F401
