from repro_torch.kernels.convlayer.ops import conv_layer  # noqa: F401
