from repro_torch.kernels.maxpool.ops import maxpool  # noqa: F401
